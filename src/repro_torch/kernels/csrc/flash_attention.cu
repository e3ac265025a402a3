// Causal flash attention on Hopper: o = softmax(q kᵀ / √D, causal) v for
// q, o [B, H, T, D] and k, v [B, Hkv, Tk, D], float32 or bfloat16.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (Pallas
// body _kernel), the prefill attention of every layer of the dense GQA
// models.  It computes what that kernel computes: scores scaled by 1/√D and
// masked at -1e30, a running max and denominator in float32 (an online
// softmax over K/V tiles), the probabilities kept in float32 for the PV
// product, the denominator floored at 1e-30, and one rounding of the output
// to q's dtype.  GQA is by index (q-head h reads kv-head h / (H / Hkv)),
// where the reference repeats K and V in memory.
//
// Bound: operations.  At the LM path's shape (B 4, H 32, T 1024, D 64) the
// causal half is 2·B·H·T²·D = 17.2 GFLOP against 42 MB of q, k, v and o.
// Design (a simple first kernel, no tensor cores): one block of 256 threads
// per (b·H + h, tile of 64 query rows), heaviest causal tiles first.  The
// q tile stays in shared memory; K/V tiles of 64 keys are staged there as
// float32 (rows padded to D + 1 floats, so column reads do not conflict).
// Each thread owns a 4 × 4 micro-tile of the 64 × 64 scores (rows ty + 16i,
// keys tx + 16j) and, for the PV product, the same 4 rows × D/16 output
// columns, accumulated in registers.  Row max and sum reduce over the 16
// threads of a row with shuffles.  K/V tiles wholly above the diagonal are
// not visited; keys past the diagonal or past Tk are masked, so any T works.
// expf, not __expf; no fast-math.  Making it fast (wgmma on bf16, TMA,
// warp specialisation) is later work.
#include <cuda_bf16.h>

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;     // query rows of a block
constexpr int kBlockK = 64;     // keys of a staged K/V tile
constexpr int kThreadsFA = 256; // 16 x 16: a 4 x 4 micro-tile of scores each
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Shared-memory layout (floats) for head dim D.
template <int D>
struct Layout {
  static constexpr int kPitch = D + 1;                 // q and k rows
  static constexpr int kQ = kBlockQ * kPitch;
  static constexpr int kK = kBlockK * kPitch;
  static constexpr int kV = kBlockK * D;
  static constexpr int kPPitch = kBlockK + 1;          // probability rows
  static constexpr int kP = kBlockQ * kPPitch;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kK + kV + kP);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreadsFA)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
                           int Tq, int Tk, float scale, int causal) {
  using L = Layout<D>;
  constexpr int P = L::kPitch;
  constexpr int PP = L::kPPitch;
  constexpr int DJ = (D + 15) / 16;  // output columns of a thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + L::kQ;
  float* Vs = Ks + L::kK;
  float* Ps = Vs + L::kV;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const long long kvh = static_cast<long long>(b) * Hkv + h / (H / Hkv);
  const int q0 = qt * kBlockQ;
  const T* qb = q + (static_cast<long long>(bh) * Tq + q0) * D;
  const T* kb = k + kvh * Tk * D;
  const T* vb = v + kvh * Tk * D;

  for (int e = threadIdx.x; e < kBlockQ * D; e += kThreadsFA) {
    const int r = e / D;
    Qs[r * P + (e - r * D)] = q0 + r < Tq ? to_float(qb[e]) : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + kBlockQ, Tq) - 1;
  int n_tiles = (Tk + kBlockK - 1) / kBlockK;
  if (causal) n_tiles = min(n_tiles, q_last / kBlockK + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = threadIdx.x; e < kBlockK * D; e += kThreadsFA) {
      const int r = e / D;
      const int c = e - r * D;
      const bool in = k0 + r < Tk;
      const long long g = static_cast<long long>(k0) * D + e;
      Ks[r * P + c] = in ? to_float(kb[g]) : 0.f;
      Vs[r * D + c] = in ? to_float(vb[g]) : 0.f;
    }
    __syncthreads();

    // scores of the micro-tile: s[i][j] = q[ty + 16i] · k[tx + 16j]
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * P + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * P + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    // online softmax, one row at a time over the row's 16 threads
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        s[i][j] *= scale;
        if (kpos >= Tk || (causal && kpos > qpos)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off, 16);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc[i][j] += Σ_c p[ty + 16i][c] · v[c][tx + 16j]
#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float vv = Vs[c * D + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (static_cast<long long>(bh) * Tq + r) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(orow + d, acc[i][j] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int Hkv, int Tq, int Tk, int causal, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  const size_t bytes = Layout<D>::kBytes;
  const cudaError_t err = repro::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  // the reference's 1.0 / (D ** 0.5), a double rounded to float
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const dim3 grid((Tq + kBlockQ - 1) / kBlockQ, B * H);
  kernel<<<grid, kThreadsFA, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hkv, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const void* q, const void* k, const void* v, void* o, int B,
                       int H, int Hkv, int Tq, int Tk, int D, int causal,
                       cudaStream_t stream) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, o, B, H, Hkv, Tq, Tk, causal, stream);
    case 16: return launch<T, 16>(q, k, v, o, B, H, Hkv, Tq, Tk, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, Hkv, Tq, Tk, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, Hkv, Tq, Tk, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Hkv, Tq, Tk, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// o [B, H, Tq, D] = attention of q [B, H, Tq, D] over k, v [B, Hkv, Tk, D]
// (all contiguous, one dtype: 0 float32, 1 bfloat16); causal: query i sees
// keys 0..i (Tq == Tk).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, int B, int H, int Hkv, int Tq, int Tk,
                                     int D, int dtype, int causal, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Tq <= 0 || Tk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_dim<float>(q, k, v, o, B, H, Hkv, Tq, Tk, D, causal, stream);
  } else if (dtype == 1) {
    err = launch_dim<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Tq, Tk, D, causal, stream);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

REPRO_DEFINE_ERROR_STRING(repro_flash_attention)
