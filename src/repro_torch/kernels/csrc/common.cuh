// Launch helpers shared by the port's hand-written kernels.  Each .cu file
// in this directory builds into its own shared library with a plain C
// interface (repro_torch/kernels/_cuda.py), so nothing here includes
// PyTorch's headers.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

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

// Blocks for `tiles` batch tiles of one block each, walked with a grid
// stride (capped as grid_for).
inline unsigned int grid_for_tiles(long long tiles) {
  const long long cap = 132LL * 32;
  return static_cast<unsigned int>(tiles < cap ? (tiles > 0 ? tiles : 1) : cap);
}

// Shared-memory barriers (mbarrier) that asynchronous copies complete on.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.  A
// phase still open after 2³⁴ cycles (seconds) means a lost transfer: trap,
// so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// One TMA bulk copy of `bytes` (a multiple of 16, 16-byte aligned ends)
// from global memory into this block's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Dynamic shared memory above the default 48 KB must be opted into per
// kernel (up to 227 KB a block on an H100).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// In-tile key dedup, the counterpart of repro/kernels/ring_scatter.py::
// tile_dedup, in two steps over one tile of n rows in shared memory.
//
// tile_dedup_leaders: lead[r] is the first row of the tile whose id equals
// ids[r] (r itself for a first occurrence), or -1 where ids[r] is padding
// (< 0) or out of range (>= S).  Call from every thread of the block;
// synchronise before reading lead.
__device__ inline void tile_dedup_leaders(const int* ids, int* lead, int n,
                                          long long S) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const int id = ids[r];
    int l = -1;
    if (id >= 0 && id < S) {
      l = r;
      for (int q = 0; q < r; ++q) {
        if (ids[q] == id) {
          l = q;
          break;
        }
      }
    }
    lead[r] = l;
  }
}

// tile_dedup_scatter: view[ids[r], c] += Σ of vals[q, c] over the rows q
// whose leader is r, for every first occurrence r and column c.  Each
// duplicate row adds into its leader's row of `vals` (the tile in shared
// memory, updated in place) with a shared-memory atomic; then each leader
// issues one global atomic add per column, so a tile costs one atomic per
// (distinct id, column) in device memory.  Both atomics add in no fixed
// order: exact for integer-valued payloads, as the reference's 0/1 matmul.
// Call from every thread of the block, after tile_dedup_leaders and a
// barrier.
__device__ inline void tile_dedup_scatter(float* view, int d, const int* ids,
                                          const int* lead, float* vals, int n) {
  for (int e = threadIdx.x; e < n * d; e += blockDim.x) {
    const int r = e / d;
    const int l = lead[r];
    if (l >= 0 && l != r) atomicAdd(vals + l * d + (e - r * d), vals[e]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n * d; e += blockDim.x) {
    const int r = e / d;
    if (lead[r] == r) {
      atomicAdd(view + static_cast<long long>(ids[r]) * d + (e - r * d), vals[e]);
    }
  }
}

}  // namespace repro

// Every library exports <prefix>_error_string so that its Python wrapper
// can name the CUDA error a launch returned.
#define REPRO_DEFINE_ERROR_STRING(prefix)                          \
  extern "C" const char* prefix##_error_string(int code) {         \
    return cudaGetErrorString(static_cast<cudaError_t>(code));    \
  }
