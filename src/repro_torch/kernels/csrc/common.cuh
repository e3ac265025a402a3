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

// ⊎ of one payload row into one view row, with Hopper's vector reductions
// (atomicAdd on float4, red.global.add.v4.f32, sm_90).  The row splits into
// reduction groups of at most four columns: group 0 is the `head`, the
// columns before the row's first 16-byte boundary (where the row starts
// depends on its id when d is not a multiple of 4); groups 1 .. vectors are
// the whole float4s after it; group vectors + 1 is the tail.  A warp's lane
// takes groups lane, lane + 32, ...
struct RowSplit {
  int head;     // columns before the first 16-byte boundary (< 4)
  int vectors;  // float4s after it
  int d;

  __device__ __forceinline__ int groups() const { return vectors + 2; }
  __device__ __forceinline__ int start(int g) const { return g == 0 ? 0 : head + 4 * (g - 1); }
  __device__ __forceinline__ int width(int g) const {
    return g == 0 ? head : (g <= vectors ? 4 : d - head - 4 * vectors);
  }
};

__device__ __forceinline__ RowSplit row_split(const float* row, int d) {
  const int to_boundary =
      static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) >> 2);
  const int head = to_boundary < d ? to_boundary : d;
  return RowSplit{head, (d - head) >> 2, d};
}

// row[start(g) + t] += x[t] for the width(g) columns of group g: one vector
// reduction for a float4 group, scalar ones for the head and the tail.
__device__ __forceinline__ void reduce_group(float* row, const RowSplit& s, int g,
                                             const float (&x)[4]) {
  const int c0 = s.start(g);
  if (g >= 1 && g <= s.vectors) {
    atomicAdd(reinterpret_cast<float4*>(row + c0), make_float4(x[0], x[1], x[2], x[3]));
    return;
  }
  const int n = s.width(g);
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    if (t < n) atomicAdd(row + c0 + t, x[t]);
  }
}

// In-tile key dedup, the counterpart of repro/kernels/ring_scatter.py::
// tile_dedup.  A tile's rows sit on the lanes of one warp (row r on lane r,
// or a warp's row index r); `key` is the row's id where it is in range and
// -1 - lane otherwise (padding and rows past the batch drop, and each such
// key is its lane's alone).  The group of a row is the mask of the tile's
// rows with its key (__match_any_sync); its leader, the group's lowest row.
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ int dedup_key(int id, long long S, bool live, int lane) {
  return live && id >= 0 && id < S ? id : -1 - lane;
}

// The mask of the tile's rows whose key is `id` (one row's in-range id, so
// >= 0): one vote.  A warp that takes one row (d >= 2) needs only its row's
// group, and a vote's result arrives long before __match_any_sync's
// (gather_mul_scatter.cu, tools/kernel_variants.py).
__device__ __forceinline__ unsigned row_group(int key, int id) {
  return __ballot_sync(kFullMask, key == id);
}

// The group's sum at its leader lane: x of the leader, then each other
// member's x in ascending lane order, each add rounded to nearest (the
// order of tests/_dedup_order.py); at any other lane of a group a partial
// sum, not used.  Call from the whole warp.
__device__ __forceinline__ float warp_group_sum(float x, unsigned group, int lane) {
  if (!__any_sync(kFullMask, __popc(group) > 1)) return x;
  float s = x;
  for (int src = 0; src < 32; ++src) {
    const float y = __shfl_sync(kFullMask, x, src);
    if (src > lane && ((group >> src) & 1u)) s = __fadd_rn(s, y);
  }
  return s;
}

// x rounded to TF32 (10 mantissa bits, nearest, ties away), as a float32
// bit pattern with the low 13 bits clear.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + (about 2⁻²² |x|): hi = rna(x), lo = rna(x − hi).  The float32
// flash kernels take each product as three TF32 terms, a_hi·b_hi + a_hi·b_lo
// + a_lo·b_hi (tests/test_torch_flash_tf32.py).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// The high halves of two float32 bit patterns as a bf16 pair (lo, hi): the
// two values truncated to bf16.  The bf16 flash kernels split P into three
// such terms, which sum to it exactly (tests/test_torch_flash_wgmma.py).
__device__ __forceinline__ uint32_t bf16x2_high(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7632);
}

// One row of a dedup group as add_group_rows reads it: its first column
// and the factor it is scaled by (unused where unscaled).
struct GroupRow {
  const float* row;
  float scale;
};

// x[t] = x[t] + row_of(r)[c0 + t] for each tile row r of `rows_mask`, in
// ascending row order, t < n, each add rounded to nearest (__fadd_rn); with
// kScaled each term is __fmul_rn(row[c0 + t], scale) first.  Up to eight
// rows' loads are issued before their adds.  The tile-dedup kernels'
// leader adds its group's other rows with it (tests/_dedup_order.py).
template <bool kScaled, typename RowOf>
__device__ __forceinline__ void add_group_rows(unsigned rows_mask, int c0, int n,
                                               float (&x)[4], RowOf row_of) {
  for (unsigned rest = rows_mask; rest;) {
    float y[8][4];
    float f[8];
    int k = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool has = rest != 0;
      GroupRow g{nullptr, 1.0f};
      if (has) g = row_of(__ffs(rest) - 1);
      f[j] = g.scale;
#pragma unroll
      for (int t = 0; t < 4; ++t) y[j][t] = has && t < n ? __ldg(g.row + c0 + t) : 0.0f;
      k += has;
      rest &= rest - 1;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (j < k) x[t] = __fadd_rn(x[t], kScaled ? __fmul_rn(y[j][t], f[j]) : y[j][t]);
      }
    }
  }
}

// Keeps v alive without a memory operation (the variants that cut a part
// out, so that the compiler keeps the rest).
__device__ __forceinline__ void keep(float v) { asm volatile("" ::"f"(v)); }

}  // namespace repro

// Every library exports <prefix>_error_string so that its Python wrapper
// can name the CUDA error a launch returned.
#define REPRO_DEFINE_ERROR_STRING(prefix)                          \
  extern "C" const char* prefix##_error_string(int code) {         \
    return cudaGetErrorString(static_cast<cudaError_t>(code));    \
  }
