// Matrix-vector product on Hopper, in two layouts of one row-major matrix
// A [rows, cols]:
//   rows layout:  y[r] = Σ_j A[r, j] x[j]        (y = A x)
//   cols layout:  y[j] = Σ_r x[r] A[r, j]        (y = xᵀ A = Aᵀ x)
//
// Replaces: src/repro/kernels/rank1_chain.py::matvec (Pallas body
// _matvec_kernel), the two matvecs of the rank-1 chain delta
// (ops.rank1_chain_update: u2 = A1 u and v2 = vᵀ A3, the latter written
// matvec(A3.T, v) in the reference).  The TPU kernel accumulates
// [bm, bk] x [bk, 1] MXU dots over a sequential k grid axis.  On Hopper a
// matvec does 2 flops per 4-byte element of A, far below the card's ratio
// of operations to bytes, so it is bound by bytes: A is read once, in
// row-major order, whatever the layout.  The cols layout exists so that
// Aᵀ x never needs Aᵀ in memory: at n = 8192 a transposed copy would move
// 512 MB, more than the whole chain delta.  Float32 products and sums on
// the CUDA cores (__fmul_rn, __fadd_rn: no contraction), no tensor cores:
// TF32 would round the inputs.
//
// The rows layout takes a TMA kernel where A and x are 16-byte aligned and
// cols % 4 == 0 (the wrapper chooses): one launch of at most one block per
// SM.  A ring of kStages stages of 32 KB in shared memory is fed by
// one-dimensional bulk copies (cp.async.bulk) completing on mbarriers;
// thread 0 refills a stage as soon as the block has read it, so three to
// four stages (96-128 KB an SM) are in flight while one is read.  Reading a
// stage must cost little beside its copy (tools/kernel_variants.py times
// the kernel with its reads cut out), so a block keeps its place in its
// list of stages with a cursor advanced by additions (RowsCursor).  The
// rows are cut into runs of R = kStageFloats / (widest chunk) rows, one
// stage each; block b takes runs b, b + B, ....  x sits in shared memory,
// loaded once by a bulk copy, or, where cols > kXMax, one chunk of at most
// kXMax floats at a time (the chunks split the float4s of a row evenly;
// the block walks its runs once per chunk and adds each chunk's dot into
// y).  Warps take a stage's rows: with R >= 8 a warp a row in turn, else
// S = 8 / R warps a row, warp segment g reading the row's float4s
// 32·(g + S·i) + lane.  Each lane adds x·a in four component sums,
// (x + y) + (z + w), a butterfly over the warp, then the segments in
// order: one write of y a row (a chunk).  x is read as float4 from shared
// memory, conflict-free.
//
// SIMT kernels take the rest.  Rows (unaligned A or x, cols % 4 != 0): one
// warp a row.  Cols, every cols layout: block (strip of 32 columns, split
// z) has its warps sum the split's rows in turn, warp w rows lo + w,
// lo + w + 8, ..., adds the warps' sums in order into its partial, and the
// last split of a strip to arrive (a ticket counter a strip) adds the
// splits in order into y: one launch.  The last to arrive resets the
// counter, which has its own buffer per stream, zeroed once.  A TMA-fed
// cols kernel (register accumulators over strips of 1024 columns) was
// measured slower than this one at n = 1024 and 8192 and was dropped.
// All are deterministic: fixed order, no atomics on values; the rows TMA
// and the cols kernels round each product and sum once, so their order is
// emulated exactly on the CPU (tests/_matvec_order.py).
#include <cstdint>

#include "common.cuh"

// Variants: 0 in the library; tools/kernel_variants.py builds the source
// with REPRO_VARIANT = 1 (kNoReads: the TMA kernel leaves its stages
// unread, so the ring of bulk copies alone is timed).
#ifndef REPRO_VARIANT
#define REPRO_VARIANT 0
#endif

namespace {

constexpr int kVariant = REPRO_VARIANT;
constexpr int kNoReads = 1;

constexpr int kThreadsMV = 256;
constexpr int kWarps = kThreadsMV / 32;
constexpr int kStages = 4;                         // stages of the ring
constexpr int kStageFloats = 8192;                 // 32 KB a stage
constexpr int kXMax = kStageFloats;                // floats of x held at once

// Shared memory of the TMA kernel (bytes): x, the ring, the segment sums of
// two stages and the barriers.
constexpr size_t kRowsSmem = sizeof(float) * (kXMax + 2 * kWarps + kStages * kStageFloats) +
                             8 * (kStages + 1);

// Thread 0 counts this block on `ticket` (after every thread's partial
// stores and a barrier) and returns to every thread whether the block was
// the last of `expected`; the last one resets the counter.
__device__ __forceinline__ bool last_to_arrive(unsigned int* ticket, unsigned int expected,
                                               int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int t;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;\n" : "=r"(t) : "l"(ticket) : "memory");
    const int last = t == expected - 1;
    if (last) atomicExch(ticket, 0u);  // every other block has counted
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag != 0;
  __syncthreads();  // the flag is read before the next ticket writes it
  return last;
}

// ----------------------------------------------------------------------------
// TMA kernels
// ----------------------------------------------------------------------------

// Where a TMA block is in its list of stages.  Producer (thread 0, kStages
// ahead) and consumers each keep one and advance it a stage at a time:
// the per-stage index arithmetic is additions, no 64-bit divisions, which
// every thread would pay between two stages.
//
// Rows: runs of R rows, block b taking runs b, b + B, ... (`mine` of them),
// chunk by chunk: run jj of chunk c is rows [r, r + count), columns
// [c0, c0 + w).
struct RowsCursor {
  int c;
  long long jj, c0, r;
  int w, count;
};

__device__ __forceinline__ void rows_chunk(RowsCursor& at, long long k4, int chunks) {
  at.c0 = 4 * (k4 * at.c / chunks);
  at.w = static_cast<int>(4 * (k4 * (at.c + 1) / chunks) - at.c0);
}

__device__ __forceinline__ void rows_place(RowsCursor& at, long long b, long long B,
                                           long long rows, int R) {
  at.r = (b + at.jj * B) * R;
  at.count = static_cast<int>(rows - at.r < R ? rows - at.r : R);
}

__device__ __forceinline__ void rows_next(RowsCursor& at, long long mine, long long b,
                                          long long B, long long rows, long long k4, int chunks,
                                          int R) {
  if (++at.jj == mine) {
    at.jj = 0;
    ++at.c;
    rows_chunk(at, k4, chunks);
  }
  rows_place(at, b, B, rows, R);
}

__global__ void __launch_bounds__(kThreadsMV, 1)
    matvec_rows_tma(const float* __restrict__ A, const float* __restrict__ x, long long rows,
                    long long cols, float* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* ring = xs + kXMax;
  float* red = ring + kStages * kStageFloats;  // 2 x kWarps segment sums
  uint64_t* bars = reinterpret_cast<uint64_t*>(red + 2 * kWarps);  // full[kStages], x
  const uint32_t xbar = repro::smem_u32(bars + kStages);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const long long b = blockIdx.x, B = gridDim.x;
  const long long k4 = cols / 4;
  const int chunks = static_cast<int>((cols + kXMax - 1) / kXMax);
  const int R = kStageFloats / static_cast<int>(4 * ((k4 + chunks - 1) / chunks));
  const long long mine = ((rows + R - 1) / R - b + B - 1) / B;  // runs of this block
  const long long pieces = mine * chunks;
  RowsCursor at = {0, 0, 0, 0, 0, 0};
  rows_chunk(at, k4, chunks);
  rows_place(at, b, B, rows, R);
  RowsCursor ahead = at;  // thread 0: the next stage to fetch

  auto load_x = [&](const RowsCursor& st) {
    repro::mbar_expect_tx(xbar, static_cast<uint32_t>(4 * st.w));
    repro::bulk_load(xs, x + st.c0, static_cast<uint32_t>(4 * st.w), xbar);
  };
  // thread 0: copy the stage `ahead` into ring slot `slot`, then advance
  auto fetch = [&](int slot) {
    const uint32_t bar = repro::smem_u32(bars + slot);
    float* dst = ring + slot * kStageFloats;
    const float* src = A + ahead.r * cols + ahead.c0;
    const int bytes = 4 * ahead.count * ahead.w;
    repro::mbar_expect_tx(bar, static_cast<uint32_t>(bytes));
    if (ahead.w == cols) {  // whole rows: contiguous
      repro::bulk_load(dst, src, static_cast<uint32_t>(bytes), bar);
    } else {
      for (int j = 0; j < ahead.count; ++j)
        repro::bulk_load(dst + j * ahead.w, src + j * cols, static_cast<uint32_t>(4 * ahead.w),
                         bar);
    }
    rows_next(ahead, mine, b, B, rows, k4, chunks, R);
  };

  if (tid == 0) {
    for (int s = 0; s <= kStages; ++s) repro::mbar_init(repro::smem_u32(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && pieces > 0) {
    load_x(at);
    for (int s = 0; s < kStages && s < pieces; ++s) fetch(s);
  }

  for (long long q = 0; q < pieces; ++q) {
    const int slot = static_cast<int>(q % kStages);
    if (at.jj == 0) repro::mbar_wait(xbar, at.c & 1);  // this chunk's x
    repro::mbar_wait(repro::smem_u32(bars + slot), static_cast<uint32_t>(q / kStages) & 1);
    const float4* x4 = reinterpret_cast<const float4*>(xs);
    const int nf4 = at.w / 4;
    const int S = at.count >= kWarps ? 1 : kWarps / at.count;  // warps a row
    const int seg = warp % S;
    float* rd = red + (q & 1) * kWarps;
    for (int j = warp / S; kVariant != kNoReads && j < at.count; j += kWarps / S) {
      const float4* a4 = reinterpret_cast<const float4*>(ring + slot * kStageFloats + j * at.w);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int f = 32 * seg + lane; f < nf4; f += 32 * S) {
        const float4 a = a4[f], xv = x4[f];
        acc.x = __fadd_rn(acc.x, __fmul_rn(a.x, xv.x));
        acc.y = __fadd_rn(acc.y, __fmul_rn(a.y, xv.y));
        acc.z = __fadd_rn(acc.z, __fmul_rn(a.z, xv.z));
        acc.w = __fadd_rn(acc.w, __fmul_rn(a.w, xv.w));
      }
      float v = __fadd_rn(__fadd_rn(acc.x, acc.y), __fadd_rn(acc.z, acc.w));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == 0) {
        if (S == 1) {
          float* out = y + at.r + j;
          *out = at.c == 0 ? v : __fadd_rn(*out, v);
        } else {
          rd[j * S + seg] = v;
        }
      }
    }
    __syncthreads();  // the slot is read, the segment sums written
    if (tid == 0) {
      if (q + kStages < pieces) fetch(slot);
      if (at.jj == mine - 1 && at.c + 1 < chunks) {  // x is read: the next chunk's
        RowsCursor next = at;
        ++next.c;
        rows_chunk(next, k4, chunks);
        load_x(next);
      }
    }
    if (S > 1 && tid < at.count) {
      float v = rd[tid * S];
      for (int g = 1; g < S; ++g) v = __fadd_rn(v, rd[tid * S + g]);
      float* out = y + at.r + tid;
      *out = at.c == 0 ? v : __fadd_rn(*out, v);
    }
    rows_next(at, mine, b, B, rows, k4, chunks, R);
  }
}

// ----------------------------------------------------------------------------
// SIMT kernels: unaligned A or x, or cols % 4 != 0
// ----------------------------------------------------------------------------
__global__ void matvec_rows_simt(const float* __restrict__ A, const float* __restrict__ x,
                                 long long rows, long long cols, float* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long r = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
       r < rows; r += warps) {
    const float* a = A + r * cols;
    float acc = 0.0f;
#pragma unroll 4
    for (long long j = lane; j < cols; j += 32) acc += __ldg(a + j) * __ldg(x + j);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) y[r] = acc;
  }
}

__global__ void matvec_cols_simt(const float* __restrict__ A, const float* __restrict__ x,
                                 long long rows, long long cols, long long chunk,
                                 unsigned int* __restrict__ counters, float* __restrict__ ws,
                                 float* __restrict__ y) {
  __shared__ float part[kWarps][32];
  __shared__ int flag;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long j = blockIdx.x * 32LL + lane;
  const long long lo = blockIdx.y * chunk;
  const long long hi = lo + chunk < rows ? lo + chunk : rows;
  float acc = 0.0f;
  if (j < cols) {
#pragma unroll 8
    for (long long r = lo + warp; r < hi; r += kWarps)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(x + r), __ldg(A + r * cols + j)));
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (threadIdx.x < 32 && j < cols) {
    float sum = part[0][lane];
#pragma unroll
    for (int v = 1; v < kWarps; ++v) sum = __fadd_rn(sum, part[v][lane]);
    ws[blockIdx.y * cols + j] = sum;
  }
  // the last split of this strip adds the splits in order
  if (!last_to_arrive(counters + blockIdx.x, gridDim.y, &flag)) return;
  if (threadIdx.x < 32 && j < cols) {
    float sum = __ldcg(ws + j);
    for (unsigned int z = 1; z < gridDim.y; ++z) sum = __fadd_rn(sum, __ldcg(ws + z * cols + j));
    y[j] = sum;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

}  // namespace

// y = A x (transposed == 0: x [cols], y [rows]) or xᵀ A (transposed != 0:
// x [rows], y [cols]) for a row-major A [rows, cols].  In the rows layout
// tma != 0 takes the TMA kernel, which needs A and x 16-byte aligned,
// cols % 4 == 0, rows, cols > 0 and a grid of `blocks` (at most one block an
// SM, at most one a run of rows); tma == 0 the SIMT one.  The cols layout
// (tma == 0) cuts the rows into `blocks` splits of `chunk` rows
// (blocks·chunk >= rows) and needs `counters`, ceil(cols / 32) ticket
// counters, zero before the call and zero again after, and `partials`,
// blocks·cols floats.
extern "C" int repro_matvec(const float* A, const float* x, long long rows, long long cols,
                            int transposed, int tma, int blocks, long long chunk,
                            unsigned int* counters, float* partials, float* y,
                            cudaStream_t stream) {
  if (rows < 0 || cols < 0 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (transposed ? cols == 0 : rows == 0) return static_cast<int>(cudaGetLastError());
  if (transposed) {
    if (tma || blocks > 65535 || chunk * blocks < rows)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned int>((cols + 31) / 32), blocks);
    matvec_cols_simt<<<grid, kThreadsMV, 0, stream>>>(A, x, rows, cols, chunk, counters,
                                                       partials, y);
    return static_cast<int>(cudaGetLastError());
  }
  if (!tma) {
    matvec_rows_simt<<<repro::grid_for(rows * 32), repro::kThreads, 0, stream>>>(A, x, rows,
                                                                                 cols, y);
    return static_cast<int>(cudaGetLastError());
  }
  static bool smem_ok = false;
  if (cols == 0 || cols % 4 || !aligned16(A) || !aligned16(x))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long k4 = cols / 4, chunks = (cols + kXMax - 1) / kXMax;
  const long long R = kStageFloats / (4 * ((k4 + chunks - 1) / chunks));
  if (blocks > (rows + R - 1) / R) return static_cast<int>(cudaErrorInvalidValue);
  if (!smem_ok) {
    const cudaError_t err = repro::allow_smem(matvec_rows_tma, kRowsSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_ok = true;
  }
  matvec_rows_tma<<<blocks, kThreadsMV, kRowsSmem, stream>>>(A, x, rows, cols, y);
  return static_cast<int>(cudaGetLastError());
}

REPRO_DEFINE_ERROR_STRING(repro_matvec)
