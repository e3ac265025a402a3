// Weighted sufficient statistics of a tuple batch on Hopper:
//   c = Σ_b w[b],  s[i] = Σ_b w[b]·x[b, i],  Q[i, j] = Σ_b (x[b, i]·w[b])·x[b, j]
// for x [B, m] and w [B] float32 (paper §7.2, the hot loop of cofactor
// maintenance).
//
// Replaces: src/repro/kernels/cofactor_update.py::cofactor_update (Pallas
// body _kernel).  The TPU kernel walks a (m/bm, m/bm, B/bk) grid in order,
// with the batch innermost, and accumulates into the revisited output block
// on the MXU; c and s ride along in the j == 0 column of blocks.  Blocks on
// Hopper run in parallel and in no order, so the batch axis is split
// instead: block (ti, tj, z) computes the 64 x 64 tile (ti, tj) of Q over
// the z-th chunk of rows, and writes it to its own slice of a workspace
// (blocks with tj == 0 add the chunk's s, block (0, 0, z) its c).  A second
// kernel sums the slices in a fixed order, so a call is deterministic.
//
// Bound: operations at the widths the statistics use (2·B·m² flops against
// 4·B·(m + 1) bytes read; m = 130 needs 8.9 GFLOP per 262,144 rows), bytes
// only for narrow m.  Design: a shared-memory float32 product (no tensor
// cores: TF32 would round the inputs).  Each step stages 32 rows of the two
// 64-column strips, the i strip already scaled by w, while the next step's
// rows are loaded into registers.  The block's 256 threads form four groups
// of 64, one per 32 x 32 quadrant of the tile, each thread accumulating a
// 4 x 4 block in registers from float4 reads of shared memory; a quadrant
// that lies wholly past m skips its products (whole warps), so m = 130 does
// the work of 160 columns, not 192.  The staging threads add s and c from
// the values they load.  No atomics.
#include "common.cuh"

namespace {

constexpr int kTile = 64;   // Q tile edge
constexpr int kQuad = 32;   // quadrant edge: one group of 64 threads
constexpr int kStep = 32;   // batch rows staged per step
constexpr int kRowsPerPass = repro::kThreads / kTile;  // rows one pass stages
constexpr int kLoads = kStep / kRowsPerPass;            // rows a thread stages

__global__ void __launch_bounds__(repro::kThreads, 4)
cofactor_partial_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        long long B, int m, long long chunk,
                        float* __restrict__ ws) {
  __shared__ __align__(16) float xw[kStep][kTile];  // x[:, i strip] · w
  __shared__ __align__(16) float xj[kStep][kTile];  // x[:, j strip]
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kTile, j0 = blockIdx.y * kTile;
  const long long lo = blockIdx.z * chunk;
  const long long hi = lo + chunk < B ? lo + chunk : B;
  const bool with_s = blockIdx.y == 0, with_c = with_s && blockIdx.x == 0;
  // staging: this thread loads column `col` of rows r0 + rbase + 4k
  const int col = tid % kTile, rbase = tid / kTile;
  const bool in_i = i0 + col < m, in_j = j0 + col < m;
  // compute: quadrant (gi, gj) of the tile, 4 x 4 outputs at (ty, tx)
  const int group = tid / 64, t = tid % 64;
  const int qi = (group / 2) * kQuad, qj = (group % 2) * kQuad;
  const int ty = t / 8, tx = t % 8;
  const bool active = i0 + qi < m && j0 + qj < m;
  float acc[4][4] = {};
  float ra[kLoads], rb[kLoads];
  float s_acc = 0.0f, c_acc = 0.0f;
  auto load = [&](long long r0) {
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const long long row = r0 + rbase + k * kRowsPerPass;
      float a = 0.0f, b = 0.0f;
      if (row < hi) {
        const float wr = __ldg(w + row);
        if (in_i) a = __fmul_rn(__ldg(x + row * m + i0 + col), wr);
        if (in_j) b = __ldg(x + row * m + j0 + col);
        if (with_c && col == 0) c_acc += wr;
      }
      if (with_s) s_acc += a;
      ra[k] = a;
      rb[k] = b;
    }
  };
  if (lo < hi) load(lo);
  for (long long r0 = lo; r0 < hi; r0 += kStep) {
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      xw[rbase + k * kRowsPerPass][col] = ra[k];
      xj[rbase + k * kRowsPerPass][col] = rb[k];
    }
    __syncthreads();
    if (r0 + kStep < hi) load(r0 + kStep);  // in flight during the products
    if (active) {
#pragma unroll 8
      for (int kk = 0; kk < kStep; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&xw[kk][qi + ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&xj[kk][qj + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int p = 0; p < 4; ++p) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] += av[p] * bv[q];
        }
      }
    }
    __syncthreads();
  }
  const long long stride = static_cast<long long>(m) * m + m + 1;
  float* out = ws + blockIdx.z * stride;
  if (active) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int i = i0 + qi + ty * 4 + p;
      if (i >= m) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + qj + tx * 4 + q;
        if (j < m) out[static_cast<long long>(i) * m + j] = acc[p][q];
      }
    }
  }
  // s and c: each column's kRowsPerPass partial sums, added in row order
  if (with_s) {
    xw[rbase][col] = s_acc;
    if (with_c && col == 0) xj[0][rbase] = c_acc;
    __syncthreads();
    if (tid < kTile && i0 + tid < m) {
      float sum = 0.0f;
#pragma unroll
      for (int r = 0; r < kRowsPerPass; ++r) sum += xw[r][tid];
      out[static_cast<long long>(m) * m + i0 + tid] = sum;
    }
    if (with_c && tid == 0) {
      float sum = 0.0f;
#pragma unroll
      for (int r = 0; r < kRowsPerPass; ++r) sum += xj[0][r];
      out[stride - 1] = sum;
    }
  }
}

// Sum of the per-chunk slices in chunk order: [Q (m·m) | s (m) | c].
__global__ void cofactor_reduce_kernel(const float* __restrict__ ws, int m,
                                       int splits, float* __restrict__ c,
                                       float* __restrict__ s,
                                       float* __restrict__ Q) {
  const long long mm = static_cast<long long>(m) * m;
  const long long stride = mm + m + 1;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < stride; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float acc = 0.0f;
    for (int z = 0; z < splits; ++z) acc += ws[z * stride + e];
    if (e < mm) {
      Q[e] = acc;
    } else if (e < mm + m) {
      s[e - mm] = acc;
    } else {
      c[0] = acc;
    }
  }
}

}  // namespace

// c [1], s [m], Q [m, m] of x [B, m] and w [B]; the batch is cut into
// `splits` chunks of `chunk` rows (splits · chunk >= B), and ws holds
// splits · (m·m + m + 1) floats of scratch.
extern "C" int repro_cofactor_update(const float* x, const float* w, long long B,
                                     int m, int splits, long long chunk, float* ws,
                                     float* c, float* s, float* Q,
                                     cudaStream_t stream) {
  if (splits < 1 || splits > 65535 || chunk * splits < B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = m > 0 ? (m + kTile - 1) / kTile : 1;
  const dim3 grid(tiles, tiles, splits);
  cofactor_partial_kernel<<<grid, repro::kThreads, 0, stream>>>(x, w, B, m, chunk, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long stride = static_cast<long long>(m) * m + m + 1;
  cofactor_reduce_kernel<<<repro::grid_for(stride), repro::kThreads, 0, stream>>>(
      ws, m, splits, c, s, Q);
  return static_cast<int>(cudaGetLastError());
}

REPRO_DEFINE_ERROR_STRING(repro_cofactor_update)
