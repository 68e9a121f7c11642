// Runs the device code of csrc/bsw_extend.cu (built with -DBSW),
// csrc/phmm_forward.cu (-DPHMM), csrc/abea_fill.cu (-DABEA_FILL),
// csrc/abea_walk.cu (-DABEA_WALK), csrc/bsw_stripped.cu (-DBSW_STRIPPED),
// csrc/chain_micro.cu (-DCHAIN_MICRO), csrc/occ_gather.cu (-DOCC_GATHER) or
// csrc/chain_dp.cu (the text before
// the source's first "}  // namespace", included as KERNEL_PART) on the CPU
// under cuda_runtime.h's warp emulation.  Reads the batch from a binary
// file written by tests/test_torch_kernel_emulation.py and writes the
// kernel's outputs.
//
//   run_kernels <in> <out>

#include "cuda_runtime.h"

#include <fstream>
#include <string>
#include <tuple>

#include KERNEL_PART
namespace {
alignas(16) int32_t smem[1 << 16];  // the kernel's extern __shared__ block
}

template <class T>
std::vector<T> read(std::ifstream& f, size_t n) {
  std::vector<T> v(n);
  f.read(reinterpret_cast<char*>(v.data()), static_cast<std::streamsize>(n * sizeof(T)));
  return v;
}

template <class T>
void write(std::ofstream& o, const std::vector<T>& v) {
  o.write(reinterpret_cast<const char*>(v.data()), static_cast<std::streamsize>(v.size() * sizeof(T)));
}

#if defined(ABEA_FILL) || defined(ABEA_WALK)
// head: reads, events, k-mers, band rows; then (walk only) the fill's trace
// [rows, 100] u8, bll_e [rows] and seed [reads]; then the flat batch (ev,
// gm, stdv, lstdv, ev_off, k_off, band_off, ne, nk, lp) and the order.  One
// warp a read, as block `b` of 32 threads.
int abea_main(std::ifstream& f, const char* out_path) {
  const auto head = read<int64_t>(f, 4);
  const int b = static_cast<int>(head[0]);
  const size_t ne_all = static_cast<size_t>(head[1]), nk_all = static_cast<size_t>(head[2]);
  const size_t rows = static_cast<size_t>(head[3]), nb = static_cast<size_t>(b);
#ifdef ABEA_WALK
  const auto trace = read<uint8_t>(f, rows * 100);
  const auto bll_e = read<int32_t>(f, rows);
  const auto seed = read<int32_t>(f, nb);
#endif
  const auto ev = read<float>(f, ne_all);
  const auto gm = read<float>(f, nk_all);
  const auto sd = read<float>(f, nk_all);
  const auto ls = read<float>(f, nk_all);
  const auto ev_off = read<int64_t>(f, nb);
  const auto k_off = read<int64_t>(f, nb);
  const auto band_off = read<int64_t>(f, nb);
  const auto ne = read<int32_t>(f, nb);
  const auto nk = read<int32_t>(f, nb);
  const auto lp = read<double>(f, 4 * nb);
  const auto order = read<int32_t>(f, nb);
  std::ofstream o(out_path, std::ios::binary);
#ifdef ABEA_FILL
  std::vector<uint8_t> trace(rows * 100, 0xee);
  std::vector<int32_t> bll_e(rows, -777), seed(nb, -777);
  std::vector<float> last_val(rows, -777.0f);
  for (int w = 0; w < b; ++w) {
    emu_run_warp(w, 32, 0, [&] {
      abea_fill_kernel(ev.data(), gm.data(), sd.data(), ls.data(), ev_off.data(), k_off.data(),
                       band_off.data(), ne.data(), nk.data(), lp.data(), order.data(),
                       trace.data(), bll_e.data(), last_val.data(), seed.data());
    });
  }
  write(o, trace);
  write(o, bll_e);
  write(o, last_val);
  write(o, seed);
#else
  std::vector<int32_t> pairs(2 * rows, 0), n(nb, -777), max_gap(nb, -777);
  std::vector<double> sum_em(nb, -777.0);
  for (int w = 0; w < b; ++w) {
    emu_run_warp(w, 32, 0, [&] {
      abea_walk_kernel(trace.data(), bll_e.data(), seed.data(), ev.data(), gm.data(), sd.data(),
                       ls.data(), ev_off.data(), k_off.data(), band_off.data(), ne.data(),
                       nk.data(), order.data(), pairs.data(), n.data(), max_gap.data(),
                       sum_em.data());
    });
    if (!emu_pipeline_idle()) {
      std::fprintf(stderr, "a lane ended with copies not waited for\n");
      return 1;
    }
  }
  write(o, pairs);
  write(o, n);
  write(o, max_gap);
  write(o, sum_em);
#endif
  return 0;
}
#endif

#ifdef BSW
// csrc/bsw_extend.cu's launch: the register instance with_instance picks
// for q_max <= 512 (its e_ins < 0 variant when e_ins < 0), a warp at a
// time; above 512 the long-query kernel, a block of one warp a pair with
// its rows in `smem`, or (scratch_warps > 0) a grid of that many warps
// with their rows in a scratch vector, striding over the pairs.
void run_bsw(const int8_t* codes, const int64_t* q_off, const int32_t* q_len, const int64_t* t_off,
             const int32_t* t_len, const int32_t* h0, int32_t* out, int batch, int q_max,
             int scratch_warps, Params p) {
  if (q_max > 512) {
    const int stride = long_stride(q_max);
    const size_t region = 2 * static_cast<size_t>(stride);
    std::vector<int32_t> scratch(scratch_warps > 0 ? region * scratch_warps : 0);
    if (scratch.empty() && region > sizeof(smem) / sizeof(int32_t)) {
      std::fprintf(stderr, "q_max %d: the rows pass the emulated shared memory\n", q_max);
      std::exit(1);
    }
    const int grid = scratch_warps > 0 ? min(scratch_warps, batch) : batch;
    gridDim.x = static_cast<unsigned>(grid);
    for (int w = 0; w < grid; ++w) {
      emu_run_warp(w, 32, 0, [&] {
        bsw_extend_long_kernel<kChunkK>(codes, q_off, q_len, t_off, t_len, h0, out, batch, p,
                                        stride, scratch.empty() ? nullptr : scratch.data());
      });
    }
    return;
  }
  with_instance(q_max, [&](auto edge, auto lanes) {
    constexpr int E = decltype(edge)::value, L = decltype(lanes)::value;
    constexpr int G = 32 / L;
    const int warps = (batch + G - 1) / G;
    for (int w = 0; w < warps; ++w) {
      emu_run_warp(w, 32, 0, [&] {
        if (p.e_ins < 0) {
          bsw_extend_kernel<E / L, L, true>(codes, q_off, q_len, t_off, t_len, h0, out, batch, p);
        } else {
          bsw_extend_kernel<E / L, L, false>(codes, q_off, q_len, t_off, t_len, h0, out, batch, p);
        }
      });
    }
    return 0;
  });
}
#endif

#ifdef BSW_STRIPPED
// head: qe_pad, tp, batch, the 6 params; then q_codes, h_init, e_init
// [qe_pad, batch], target [tp, batch]; out [2, qe_pad, batch].  The
// instance csrc/bsw_stripped.cu's with_instance picks for qe_pad, a warp at
// a time.
std::vector<int32_t> stripped_main(std::ifstream& f) {
  const auto head = read<int64_t>(f, 9);
  const int qe_pad = static_cast<int>(head[0]), tp = static_cast<int>(head[1]);
  const int batch = static_cast<int>(head[2]);
  Params p{};
  int* fields = &p.o_del;
  for (int k = 0; k < 6; ++k) fields[k] = static_cast<int>(head[3 + k]);
  const size_t cells = static_cast<size_t>(qe_pad) * batch;
  const auto q = read<int32_t>(f, cells);
  const auto h = read<int32_t>(f, cells);
  const auto e = read<int32_t>(f, cells);
  const auto t = read<int32_t>(f, static_cast<size_t>(tp) * batch);
  std::vector<int32_t> out(2 * cells, -777);
  if (qe_pad > 520) {  // the long-column kernel: a warp a pair
    for (int w = 0; w < batch; ++w) {
      emu_run_warp(w, 32, 0, [&] {
        bsw_stripped_long_kernel<kChunkK>(q.data(), t.data(), h.data(), e.data(), out.data(),
                                          qe_pad, tp, batch, p);
      });
    }
    return out;
  }
  with_instance(qe_pad, [&](auto edge, auto lanes) {
    constexpr int L = decltype(lanes)::value;
    constexpr int G = 32 / L;
    const int warps = (batch + G - 1) / G;
    for (int w = 0; w < warps; ++w) {
      emu_run_warp(w, 32, 0, [&] {
        bsw_stripped_kernel<(decltype(edge)::value + L - 1) / L, L>(
            q.data(), t.data(), h.data(), e.data(), out.data(), qe_pad, tp, batch, p);
      });
    }
  });
  return out;
}
#endif

#ifdef CHAIN_MICRO
// head: batch, n_pad, w, max_dist, bw; then x_lo, qi, qspan [batch, n_pad],
// m_fp, gap0 [batch]; out [batch, n_pad].  The instance csrc/chain_micro.cu's
// launch picks for w, a call (a block of one warp) at a time.
template <int NB>
void run_micro(const int32_t* x, const int32_t* q, const int32_t* s, const int32_t* m,
               const int32_t* g, int32_t* out, int batch, int n_pad, Params p) {
  for (int b = 0; b < batch; ++b) {
    emu_run_warp(b, 32, 0, [&] { chain_micro_kernel<NB>(x, q, s, m, g, out, n_pad, p); });
  }
}

std::vector<int32_t> micro_main(std::ifstream& f) {
  const auto head = read<int64_t>(f, 5);
  const int batch = static_cast<int>(head[0]), n_pad = static_cast<int>(head[1]);
  const int w = static_cast<int>(head[2]);
  const Params p{w, static_cast<int>(head[3]), static_cast<int>(head[4])};
  const size_t n = static_cast<size_t>(batch) * n_pad;
  const auto x = read<int32_t>(f, n);
  const auto q = read<int32_t>(f, n);
  const auto s = read<int32_t>(f, n);
  const auto m = read<int32_t>(f, batch);
  const auto g = read<int32_t>(f, batch);
  std::vector<int32_t> out(n, -777);
  const auto args = std::make_tuple(x.data(), q.data(), s.data(), m.data(), g.data(), out.data(),
                                    batch, n_pad, p);
  switch (min((w + 31) / 32, kBanks)) {
    case 1: std::apply(run_micro<1>, args); break;
    case 2: std::apply(run_micro<2>, args); break;
    case 3: std::apply(run_micro<3>, args); break;
    case 4: std::apply(run_micro<4>, args); break;
    case 5: std::apply(run_micro<5>, args); break;
    case 6: std::apply(run_micro<6>, args); break;
    case 7: std::apply(run_micro<7>, args); break;
    default: std::apply(run_micro<8>, args); break;
  }
  return out;
}
#endif

#ifdef OCC_GATHER
// head: tile (0/1), depth, grid, n, rows; then the table int64 [rows, 8]
// and idx int32 [n]; out: 8 or 64 int64.  The kernel at that depth (any of
// tools/gather_lanes.py's sweep), grid blocks of kThreads, a warp at a time.
template <bool kTile, int D>
void run_layout(int grid, const ulonglong2* t, const int32_t* idx, int64_t n, int64_t rows,
                unsigned long long* out) {
  gridDim.x = static_cast<unsigned>(grid);
  for (int b = 0; b < grid; ++b) {
    for (int w = 0; w < kWarps; ++w) {
      emu_run_warp(b, kThreads, 32 * w, [&] {
        if constexpr (kTile) occ_gather_tile_kernel<D>(t, idx, n, rows, out);
        else occ_gather_row_kernel<D>(t, idx, n, rows, out);
      });
    }
  }
}

template <bool kTile>
void run_depth(int depth, int grid, const ulonglong2* t, const int32_t* idx, int64_t n,
               int64_t rows, unsigned long long* out) {
  switch (depth) {
    case 1: run_layout<kTile, 1>(grid, t, idx, n, rows, out); break;
    case 2: run_layout<kTile, 2>(grid, t, idx, n, rows, out); break;
    case 4: run_layout<kTile, 4>(grid, t, idx, n, rows, out); break;
    case 8: run_layout<kTile, 8>(grid, t, idx, n, rows, out); break;
    case 16: run_layout<kTile, 16>(grid, t, idx, n, rows, out); break;
    default: std::fprintf(stderr, "depth %d\n", depth); std::exit(1);
  }
}

std::vector<int32_t> occ_main(std::ifstream& f) {
  const auto head = read<int64_t>(f, 5);
  const bool tile = head[0] != 0;
  const int depth = static_cast<int>(head[1]), grid = static_cast<int>(head[2]);
  const int64_t n = head[3], rows = head[4];
  const auto table = read<uint64_t>(f, static_cast<size_t>(rows) * 8);
  const auto idx = read<int32_t>(f, static_cast<size_t>(n));
  std::vector<unsigned long long> out(tile ? 64 : 8, 0);
  const auto* t = reinterpret_cast<const ulonglong2*>(table.data());
  if (tile) run_depth<true>(depth, grid, t, idx.data(), n, rows, out.data());
  else run_depth<false>(depth, grid, t, idx.data(), n, rows, out.data());
  std::vector<int32_t> bits(2 * out.size());
  std::memcpy(bits.data(), out.data(), out.size() * sizeof(uint64_t));
  return bits;
}
#endif

#ifdef PHMM
// one warp at a time, as block w of 32 threads: the groups of the warp
// take the first slices of the shared carry
template <class T, int L, int S>
void run_phmm(const Batch& in, const Tables<T>& tab, T* carry, T* out) {
  constexpr int G = 32 / L;
  const int warps = (in.batch + G - 1) / G;
  for (int w = 0; w < warps; ++w) {
    emu_run_warp(w, 32, 0, [&] { phmm_forward_kernel<T, L, S>(in, tab, carry, out); });
  }
}

// the instance csrc/phmm_forward.cu's launch picks for rp
template <class T>
void run_phmm_rp(const Batch& in, const Tables<T>& tab, T* carry, T* out) {
  const int rows = in.rp - 1;
  constexpr bool f = sizeof(T) == 4;
  if (rows <= 64) {
    if constexpr (f) run_phmm<T, PHMM_F32_LANES_64, PHMM_F32_ROWS_64>(in, tab, carry, out);
    else run_phmm<T, PHMM_F64_LANES_64, PHMM_F64_ROWS_64>(in, tab, carry, out);
  } else if (rows <= 128) {
    if constexpr (f) run_phmm<T, PHMM_F32_LANES_128, PHMM_F32_ROWS_128>(in, tab, carry, out);
    else run_phmm<T, PHMM_F64_LANES_128, PHMM_F64_ROWS_128>(in, tab, carry, out);
  } else if (rows <= 256) {
    if constexpr (f) run_phmm<T, PHMM_F32_LANES_256, PHMM_F32_ROWS_256>(in, tab, carry, out);
    else run_phmm<T, PHMM_F64_LANES_256, PHMM_F64_ROWS_256>(in, tab, carry, out);
  } else {
    if constexpr (f) run_phmm<T, PHMM_F32_LANES_512, PHMM_F32_ROWS_512>(in, tab, carry, out);
    else run_phmm<T, PHMM_F64_LANES_512, PHMM_F64_ROWS_512>(in, tab, carry, out);
  }
}

// head: batch, rp, hp, global carry (0/1), table entries (ph2pr, m2m);
// then the int8 planes, the lengths and the tables of T
template <class T>
std::vector<T> phmm_main(std::ifstream& f, const std::vector<int64_t>& head) {
  const int batch = static_cast<int>(head[0]), rp = static_cast<int>(head[1]);
  const int hp = static_cast<int>(head[2]);
  const size_t nb = static_cast<size_t>(batch);
  std::vector<int8_t> planes[6];
  for (int p = 0; p < 5; ++p) planes[p] = read<int8_t>(f, nb * rp);  // rs_row q i d c
  planes[5] = read<int8_t>(f, nb * hp);
  const auto rslen = read<int32_t>(f, nb);
  const auto haplen = read<int32_t>(f, nb);
  const auto init_y = read<T>(f, static_cast<size_t>(hp) + 1);
  const auto ph2pr = read<T>(f, static_cast<size_t>(head[4]));
  const auto one_m = read<T>(f, static_cast<size_t>(head[4]));
  const auto div3 = read<T>(f, static_cast<size_t>(head[4]));
  const auto m2m = read<T>(f, static_cast<size_t>(head[5]));
  const Batch in{planes[0].data(), planes[1].data(), planes[2].data(), planes[3].data(),
                 planes[4].data(), planes[5].data(), rslen.data(), haplen.data(), batch, rp, hp};
  const Tables<T> tab{init_y.data(), ph2pr.data(), one_m.data(), div3.data(), m2m.data()};
  std::vector<T> carry(head[3] ? 3 * nb * hp : 0, T(-7));
  std::vector<T> out(nb, T(-777));
  run_phmm_rp<T>(in, tab, head[3] ? carry.data() : nullptr, out.data());
  return out;
}
#endif

int main(int argc, char** argv) {
  std::ifstream f(argv[1], std::ios::binary);
  std::vector<int32_t> out;
#if defined(ABEA_FILL) || defined(ABEA_WALK)
  return abea_main(f, argv[2]);
#elif defined(BSW_STRIPPED)
  out = stripped_main(f);
#elif defined(OCC_GATHER)
  out = occ_main(f);
#elif defined(CHAIN_MICRO)
  out = micro_main(f);
#elif defined(PHMM)
  {
    const auto head = read<int64_t>(f, 7);  // f64, then phmm_main's head
    const std::vector<int64_t> rest(head.begin() + 1, head.end());
    std::ofstream po(argv[2], std::ios::binary);
    if (head[0]) {
      const auto res = phmm_main<double>(f, rest);
      po.write(reinterpret_cast<const char*>(res.data()),
               static_cast<std::streamsize>(res.size() * sizeof(double)));
    } else {
      const auto res = phmm_main<float>(f, rest);
      po.write(reinterpret_cast<const char*>(res.data()),
               static_cast<std::streamsize>(res.size() * sizeof(float)));
    }
    return 0;
  }
#elif defined(BSW)
  const auto head = read<int64_t>(f, 14);  // batch, codes, q_max, scratch warps, the 10 params
  const int batch = static_cast<int>(head[0]);
  const int q_max = static_cast<int>(head[2]);
  Params p{};
  int* fields = &p.o_del;
  for (int k = 0; k < 10; ++k) fields[k] = static_cast<int>(head[4 + k]);
  const auto codes = read<int8_t>(f, static_cast<size_t>(head[1]));
  const auto q_off = read<int64_t>(f, batch);
  const auto q_len = read<int32_t>(f, batch);
  const auto t_off = read<int64_t>(f, batch);
  const auto t_len = read<int32_t>(f, batch);
  const auto h0 = read<int32_t>(f, batch);
  out.assign(6 * static_cast<size_t>(batch), -777);
  run_bsw(codes.data(), q_off.data(), q_len.data(), t_off.data(), t_len.data(), h0.data(),
          out.data(), batch, q_max, static_cast<int>(head[3]), p);
#else
  const auto head = read<int64_t>(f, 5);  // anchors, calls, max_dist_x, max_dist_y, bw
  const int64_t n_total = head[0];
  const int calls = static_cast<int>(head[1]);
  const int bw = static_cast<int>(head[4]);
  const auto x = read<int32_t>(f, n_total);
  const auto q = read<int32_t>(f, n_total);
  const auto span = read<int32_t>(f, n_total);
  const auto st = read<int32_t>(f, n_total);
  const auto off = read<int64_t>(f, calls);
  const auto n = read<int32_t>(f, calls);
  const auto gap = read<int32_t>(f, static_cast<size_t>(calls) * (bw + 1));
  const auto order = read<int32_t>(f, calls);
  out.assign(3 * static_cast<size_t>(n_total), -777);
  for (int b = 0; b < calls; ++b) {
    emu_run_warp(b, 32, 0, [&] {
      chain_dp_kernel(x.data(), q.data(), span.data(), st.data(), off.data(), n.data(), gap.data(),
                      order.data(), out.data(), n_total, static_cast<int>(head[2]),
                      static_cast<int>(head[3]), bw);
    });
  }
#endif
  std::ofstream o(argv[2], std::ios::binary);
  o.write(reinterpret_cast<const char*>(out.data()),
          static_cast<std::streamsize>(out.size() * sizeof(int32_t)));
  return 0;
}
