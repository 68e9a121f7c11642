// CPU stand-in for the CUDA toolkit's math_constants.h: the constants the
// port's kernels use (tests/cuda_emulation/cuda_runtime.h).

#pragma once

#include <limits>

#define CUDART_INF_F (std::numeric_limits<float>::infinity())
