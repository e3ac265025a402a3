// Launch helpers shared by the port's hand-written kernels.  Each .cu file
// in this directory builds into its own shared library with a plain C
// interface (repro_torch/kernels/_cuda.py), so nothing here includes
// PyTorch's headers.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int kThreads = 256;

// Blocks for n work items of one thread each.  Kernels loop with a grid
// stride, so the grid is capped at 32 blocks per SM of an H100 (132 SMs)
// and a launch never exceeds the grid limit, however large n is.
inline unsigned int grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;
  return static_cast<unsigned int>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace repro

// Every library exports <prefix>_error_string so that its Python wrapper
// can name the CUDA error a launch returned.
#define REPRO_DEFINE_ERROR_STRING(prefix)                          \
  extern "C" const char* prefix##_error_string(int code) {         \
    return cudaGetErrorString(static_cast<cudaError_t>(code));    \
  }
