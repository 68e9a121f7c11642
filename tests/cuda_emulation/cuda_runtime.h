// CPU emulation of the CUDA features that the port's warp kernels
// (csrc/*.cu) use, so that their device code compiles with g++ and runs on
// the CPU in tests/test_torch_kernel_emulation.py (cuda_pipeline.h and
// math_constants.h beside this file stand in for the toolkit's).
//
// A warp is 32 lanes run as fibers (ucontext) on one thread: a lane runs
// until its next warp primitive (shuffle, vote, reduction, __syncwarp) and
// posts its value; once all 32 have posted, each is resumed in turn with
// the primitive's result.  A lane that returns while its warp-mates wait
// at a primitive (a divergent primitive with a full mask, undefined on the
// card) aborts the run, as does any mask other than the full one.  Shared
// memory is the harness's own array; warps run one at a time.

#pragma once

#include <ucontext.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __shared__

typedef void* cudaStream_t;
typedef int cudaError_t;

struct alignas(8) int2 {
  int x, y;
};
inline int2 make_int2(int x, int y) { return int2{x, y}; }
struct alignas(16) ulonglong2 {
  unsigned long long x, y;
};
template <class T>
inline T __ldg(const T* p) {  // the read-only load: a plain read here
  return *p;
}

struct EmuDim {
  unsigned x = 0;
};
inline EmuDim blockIdx, blockDim, gridDim, emu_thread[32];  // gridDim: the harness sets it

struct EmuWarp {
  ucontext_t sched, lane[32];
  std::vector<char> stack[32];
  int state[32];  // kReady, kWaiting, kDone
  uint64_t slot[32], posted[32];
  int cur = 0;
  const std::function<void()>* fn = nullptr;
};
constexpr int kReady = 0, kWaiting = 1, kDone = 2;
inline EmuWarp emu_warp;
#define threadIdx (emu_thread[emu_warp.cur])

inline int emu_lane() { return emu_warp.cur; }

inline void emu_full(unsigned mask) {
  if (mask != 0xffffffffu) {
    std::fprintf(stderr, "warp primitive with a partial mask\n");
    std::abort();
  }
}

template <class T>
inline uint64_t emu_bits(T v) {
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  return u;
}

template <class T>
inline T emu_value(uint64_t u) {
  T v;
  std::memcpy(&v, &u, sizeof(T));
  return v;
}

// every lane posts a value and yields; fn reads what all 32 posted
template <class R, class F>
inline R emu_exchange(unsigned mask, uint64_t mine, F fn) {
  emu_full(mask);
  EmuWarp& w = emu_warp;
  const int me = w.cur;
  w.slot[me] = mine;
  w.state[me] = kWaiting;
  swapcontext(&w.lane[me], &w.sched);
  return fn(w.posted);
}

template <class T>
inline T __shfl_sync(unsigned mask, T v, int src, int width = 32) {
  const int lane = emu_lane();
  const int from = (lane & ~(width - 1)) + (src & (width - 1));
  return emu_exchange<T>(mask, emu_bits(v), [&](uint64_t* s) { return emu_value<T>(s[from]); });
}

template <class T>
inline T __shfl_up_sync(unsigned mask, T v, unsigned d, int width = 32) {
  const int lane = emu_lane();
  const int from = (lane & (width - 1)) >= static_cast<int>(d) ? lane - static_cast<int>(d) : lane;
  return emu_exchange<T>(mask, emu_bits(v), [&](uint64_t* s) { return emu_value<T>(s[from]); });
}

template <class T>
inline T __shfl_down_sync(unsigned mask, T v, unsigned d, int width = 32) {
  const int lane = emu_lane();
  const int from = (lane & (width - 1)) + static_cast<int>(d) < width ? lane + static_cast<int>(d) : lane;
  return emu_exchange<T>(mask, emu_bits(v), [&](uint64_t* s) { return emu_value<T>(s[from]); });
}

template <class T>
inline T __shfl_xor_sync(unsigned mask, T v, int d, int width = 32) {
  const int lane = emu_lane();
  int from = lane ^ d;
  if ((from & ~(width - 1)) != (lane & ~(width - 1))) from = lane;
  return emu_exchange<T>(mask, emu_bits(v), [&](uint64_t* s) { return emu_value<T>(s[from]); });
}

inline unsigned __ballot_sync(unsigned mask, int p) {
  return emu_exchange<unsigned>(mask, p ? 1 : 0, [](uint64_t* s) {
    unsigned r = 0;
    for (int i = 0; i < 32; ++i) r |= (s[i] ? 1u : 0u) << i;
    return r;
  });
}

inline int __any_sync(unsigned mask, int p) { return __ballot_sync(mask, p) != 0; }
inline int __all_sync(unsigned mask, int p) { return __ballot_sync(mask, p) == 0xffffffffu; }

inline int __reduce_max_sync(unsigned mask, int v) {
  return emu_exchange<int>(mask, emu_bits(v), [](uint64_t* s) {
    int r = INT_MIN;
    for (int i = 0; i < 32; ++i) r = max(r, emu_value<int>(s[i]));
    return r;
  });
}

inline int __reduce_min_sync(unsigned mask, int v) {
  return emu_exchange<int>(mask, emu_bits(v), [](uint64_t* s) {
    int r = INT_MAX;
    for (int i = 0; i < 32; ++i) r = min(r, emu_value<int>(s[i]));
    return r;
  });
}

inline unsigned __reduce_or_sync(unsigned mask, unsigned v) {
  return emu_exchange<unsigned>(mask, v, [](uint64_t* s) {
    unsigned r = 0;
    for (int i = 0; i < 32; ++i) r |= static_cast<unsigned>(s[i]);
    return r;
  });
}

inline void __syncwarp(unsigned mask = 0xffffffffu) {
  emu_exchange<int>(mask, 0, [](uint64_t*) { return 0; });
}

inline int __vimax_s32_relu(int a, int b) { return max(max(a, b), 0); }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __clz(unsigned v) { return v ? __builtin_clz(v) : 32; }
inline int __ffs(unsigned v) { return __builtin_ffs(static_cast<int>(v)); }
inline unsigned atomicOr(unsigned* a, unsigned v) { return __atomic_fetch_or(a, v, __ATOMIC_SEQ_CST); }
inline unsigned long long atomicXor(unsigned long long* a, unsigned long long v) {
  return __atomic_fetch_xor(a, v, __ATOMIC_SEQ_CST);
}
[[noreturn]] inline void __trap() {
  std::fprintf(stderr, "__trap\n");
  std::abort();
}
// the round-to-nearest forms: separate roundings as long as the build does
// not contract a*b+c (g++ -ffp-contract=off)
inline double __ddiv_rn(double a, double b) { return a / b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __double2float_rn(double a) { return static_cast<float>(a); }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }

inline void emu_lane_main() {
  (*emu_warp.fn)();
  emu_warp.state[emu_warp.cur] = kDone;
}

// Run `fn` as warp `first_thread / 32` of block `block` (of `threads`).
inline void emu_run_warp(unsigned block, unsigned threads, unsigned first_thread,
                         const std::function<void()>& fn) {
  EmuWarp& w = emu_warp;
  blockIdx.x = block;
  blockDim.x = threads;
  w.fn = &fn;
  for (int l = 0; l < 32; ++l) {
    emu_thread[l].x = first_thread + l;
    w.stack[l].resize(1 << 18);
    getcontext(&w.lane[l]);
    w.lane[l].uc_stack.ss_sp = w.stack[l].data();
    w.lane[l].uc_stack.ss_size = w.stack[l].size();
    w.lane[l].uc_link = &w.sched;
    makecontext(&w.lane[l], emu_lane_main, 0);
    w.state[l] = kReady;
  }
  for (;;) {
    for (int l = 0; l < 32; ++l) {
      if (w.state[l] != kReady) continue;
      w.cur = l;
      swapcontext(&w.sched, &w.lane[l]);
    }
    int done = 0;
    for (int l = 0; l < 32; ++l) done += w.state[l] == kDone;
    if (done == 32) return;
    if (done) {
      std::fprintf(stderr, "a lane returned while its warp waits at a primitive\n");
      std::abort();
    }
    std::memcpy(w.posted, w.slot, sizeof(w.slot));
    for (int l = 0; l < 32; ++l) w.state[l] = kReady;
  }
}
