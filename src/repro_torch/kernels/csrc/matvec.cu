// Matrix-vector product on Hopper, in two layouts of one row-major matrix
// A [rows, cols]:
//   rows variant:  y[r] = Σ_j A[r, j] x[j]        (y = A x)
//   cols variant:  y[j] = Σ_r x[r] A[r, j]        (y = xᵀ A = Aᵀ x)
//
// Replaces: src/repro/kernels/rank1_chain.py::matvec (Pallas body
// _matvec_kernel), the two matvecs of the rank-1 chain delta
// (ops.rank1_chain_update: u2 = A1 u and v2 = vᵀ A3, the latter written
// matvec(A3.T, v) in the reference).  The TPU kernel accumulates
// [bm, bk] x [bk, 1] MXU dots over a sequential k grid axis.  On Hopper a
// matvec does 2 flops per 4-byte element of A, far below the card's ratio
// of operations to bytes, so it is bound by bytes: the design reads A once,
// in row-major order, with 16-byte loads where the layout allows.  The cols
// variant exists so that Aᵀ x never needs Aᵀ in memory: at n = 8192 a
// transposed copy would move 512 MB, more than the whole chain delta.
//
// rows: one warp per row (grid stride), each lane a strided share of the
// row's columns, then a shuffle reduction.  cols: block (strip, z) covers a
// strip of 32·W columns (W = 4 with float4 loads, else 1) and the z-th chunk
// of rows; its 8 warps take the chunk's rows in turn, add per column in
// registers, and reduce through shared memory in warp order into a
// workspace slice; a second kernel sums the slices in chunk order.  Both
// are deterministic (no atomics).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = repro::kThreads / 32;

template <bool kVec>
__global__ void matvec_rows_kernel(const float* __restrict__ A,
                                   const float* __restrict__ x, long long rows,
                                   long long cols, float* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long r = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
       r < rows; r += warps) {
    const float* a = A + r * cols;
    float acc = 0.0f;
    if constexpr (kVec) {
      const float4* a4 = reinterpret_cast<const float4*>(a);
      const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll 4
      for (long long q = lane; q < cols / 4; q += 32) {
        const float4 av = __ldg(a4 + q), xv = __ldg(x4 + q);
        acc += av.x * xv.x;
        acc += av.y * xv.y;
        acc += av.z * xv.z;
        acc += av.w * xv.w;
      }
    } else {
#pragma unroll 4
      for (long long j = lane; j < cols; j += 32) acc += __ldg(a + j) * __ldg(x + j);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) y[r] = acc;
  }
}

template <int W>
__global__ void matvec_cols_kernel(const float* __restrict__ A,
                                   const float* __restrict__ x, long long rows,
                                   long long cols, long long chunk,
                                   float* __restrict__ ws) {
  __shared__ float part[kWarps][32 * W];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long j0 = blockIdx.x * (32LL * W) + lane * W;
  const long long lo = blockIdx.y * chunk;
  const long long hi = lo + chunk < rows ? lo + chunk : rows;
  float acc[W] = {};
  // W = 4 only when cols % 4 == 0: a thread's four columns are all in range
  // or all past the end
  if (j0 < cols) {
    for (long long r = lo + warp; r < hi; r += kWarps) {
      const float xr = __ldg(x + r);
      if constexpr (W == 4) {
        const float4 av = __ldg(reinterpret_cast<const float4*>(A + r * cols + j0));
        acc[0] += xr * av.x;
        acc[1] += xr * av.y;
        acc[2] += xr * av.z;
        acc[3] += xr * av.w;
      } else {
        acc[0] += xr * __ldg(A + r * cols + j0);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < W; ++q) part[warp][lane * W + q] = acc[q];
  __syncthreads();
  for (int t = threadIdx.x; t < 32 * W; t += blockDim.x) {
    const long long j = blockIdx.x * (32LL * W) + t;
    if (j >= cols) continue;
    float sum = 0.0f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) sum += part[v][t];
    ws[blockIdx.y * cols + j] = sum;
  }
}

__global__ void matvec_sum_slices_kernel(const float* __restrict__ ws, long long n,
                                         int splits, float* __restrict__ y) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float acc = 0.0f;
    for (int z = 0; z < splits; ++z) acc += ws[z * n + e];
    y[e] = acc;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

}  // namespace

// transposed == 0: y [rows] = A x, x [cols].  transposed != 0: y [cols] =
// xᵀ A, x [rows], with the rows cut into `splits` chunks of `chunk` rows
// (splits · chunk >= rows) and ws holding splits · cols floats of scratch
// (unused by the rows variant).  A is row-major [rows, cols].
extern "C" int repro_matvec(const float* A, const float* x, long long rows,
                            long long cols, int transposed, int splits,
                            long long chunk, float* ws, float* y,
                            cudaStream_t stream) {
  if (!transposed) {
    if (rows > 0) {
      const unsigned int grid = repro::grid_for(rows * 32);
      if (cols % 4 == 0 && aligned16(A) && aligned16(x)) {
        matvec_rows_kernel<true><<<grid, repro::kThreads, 0, stream>>>(A, x, rows, cols, y);
      } else {
        matvec_rows_kernel<false><<<grid, repro::kThreads, 0, stream>>>(A, x, rows, cols, y);
      }
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (splits < 1 || splits > 65535 || chunk * splits < rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cols > 0) {
    const bool vec = cols % 4 == 0 && aligned16(A);
    const long long width = vec ? 128 : 32;
    const dim3 grid(static_cast<unsigned int>((cols + width - 1) / width), splits);
    if (vec) {
      matvec_cols_kernel<4><<<grid, repro::kThreads, 0, stream>>>(A, x, rows, cols, chunk, ws);
    } else {
      matvec_cols_kernel<1><<<grid, repro::kThreads, 0, stream>>>(A, x, rows, cols, chunk, ws);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    matvec_sum_slices_kernel<<<repro::grid_for(cols), repro::kThreads, 0, stream>>>(
        ws, cols, splits, y);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_DEFINE_ERROR_STRING(repro_matvec)
