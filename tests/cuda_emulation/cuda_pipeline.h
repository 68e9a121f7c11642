// CPU stand-in for the CUDA toolkit's cuda_pipeline.h under the warp
// emulation of cuda_runtime.h: the pipeline primitives (cp.async) that
// csrc/abea_walk.cu uses, with the card's rules.
//
// A lane's copies are queued, not made: __pipeline_commit closes the
// lane's open copies into a group, and __pipeline_wait_prior(n) makes the
// lane's oldest groups' copies until n groups are left, which is the
// latest the card may make them.  So a read of shared memory that comes
// before its copy's wait, or before the __syncwarp that follows another
// lane's wait, reads what was there before: the kernel's output differs.
// A size other than 4, 8 or 16, a misaligned address or a zfill past the
// size aborts; so does a lane that ends with copies not waited for
// (emu_pipeline_idle).

#pragma once

#include "cuda_runtime.h"

#include <cstddef>
#include <cstdint>

struct EmuCopy {
  void* dst;
  const void* src;
  size_t n, zfill;
};
inline std::vector<EmuCopy> emu_open[32];
inline std::vector<std::vector<EmuCopy>> emu_groups[32];

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size_and_align,
                                    size_t zfill = 0) {
  const bool size_ok = size_and_align == 4 || size_and_align == 8 || size_and_align == 16;
  if (!size_ok || zfill > size_and_align ||
      reinterpret_cast<uintptr_t>(dst) % size_and_align ||
      reinterpret_cast<uintptr_t>(src) % size_and_align) {
    std::fprintf(stderr, "__pipeline_memcpy_async: size %zu, zfill %zu, misaligned or wrong\n",
                 size_and_align, zfill);
    std::abort();
  }
  emu_open[emu_lane()].push_back({dst, src, size_and_align, zfill});
}

inline void __pipeline_commit() {
  const int lane = emu_lane();
  emu_groups[lane].push_back(std::move(emu_open[lane]));
  emu_open[lane].clear();
}

inline void __pipeline_wait_prior(size_t n) {
  auto& groups = emu_groups[emu_lane()];
  while (groups.size() > n) {
    for (const EmuCopy& c : groups.front()) {
      std::memcpy(c.dst, c.src, c.n - c.zfill);
      std::memset(static_cast<char*>(c.dst) + (c.n - c.zfill), 0, c.zfill);
    }
    groups.erase(groups.begin());
  }
}

// true when no lane has a copy queued: checked after each warp
inline bool emu_pipeline_idle() {
  for (int l = 0; l < 32; ++l)
    if (!emu_open[l].empty() || !emu_groups[l].empty()) return false;
  return true;
}
