// Runs the device code of csrc/bsw_extend.cu (built with -DBSW) or
// csrc/chain_dp.cu (the text before the source's first "}  // namespace",
// included as KERNEL_PART) on the CPU under cuda_runtime.h's warp
// emulation.  Reads the batch from a binary file written by
// tests/test_torch_kernel_emulation.py and writes the kernel's `out`.
//
//   run_kernels <in> <out>

#include "cuda_runtime.h"

#include <fstream>
#include <string>
#include <tuple>

#include KERNEL_PART
namespace {
int32_t smem[1 << 16];  // chain_dp's extern __shared__ block
}

template <class T>
std::vector<T> read(std::ifstream& f, size_t n) {
  std::vector<T> v(n);
  f.read(reinterpret_cast<char*>(v.data()), static_cast<std::streamsize>(n * sizeof(T)));
  return v;
}

#ifdef BSW
template <int E, int L>
void run_bsw(const int8_t* codes, const int64_t* q_off, const int32_t* q_len, const int64_t* t_off,
             const int32_t* t_len, const int32_t* h0, int32_t* out, int batch, Params p) {
  constexpr int G = 32 / L;
  const int warps = (batch + G - 1) / G;
  for (int w = 0; w < warps; ++w) {
    emu_run_warp(w, 32, 0, [&] {
      bsw_extend_kernel<E / L, L>(codes, q_off, q_len, t_off, t_len, h0, out, batch, p);
    });
  }
}
#endif

int main(int argc, char** argv) {
  std::ifstream f(argv[1], std::ios::binary);
  std::vector<int32_t> out;
#ifdef BSW
  const auto head = read<int64_t>(f, 13);  // batch, codes, q_max, the 10 params
  const int batch = static_cast<int>(head[0]);
  const int q_max = static_cast<int>(head[2]);
  Params p{};
  int* fields = &p.o_del;
  for (int k = 0; k < 10; ++k) fields[k] = static_cast<int>(head[3 + k]);
  const auto codes = read<int8_t>(f, static_cast<size_t>(head[1]));
  const auto q_off = read<int64_t>(f, batch);
  const auto q_len = read<int32_t>(f, batch);
  const auto t_off = read<int64_t>(f, batch);
  const auto t_len = read<int32_t>(f, batch);
  const auto h0 = read<int32_t>(f, batch);
  out.assign(6 * static_cast<size_t>(batch), -777);
  const auto args = std::make_tuple(codes.data(), q_off.data(), q_len.data(), t_off.data(),
                                    t_len.data(), h0.data(), out.data(), batch, p);
  if (q_max <= 32) std::apply(run_bsw<32, BSW_LANES_32>, args);
  else if (q_max <= 64) std::apply(run_bsw<64, BSW_LANES_64>, args);
  else if (q_max <= 128) std::apply(run_bsw<128, BSW_LANES_128>, args);
  else if (q_max <= 256) std::apply(run_bsw<256, BSW_LANES_256>, args);
  else std::apply(run_bsw<512, BSW_LANES_512>, args);
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
