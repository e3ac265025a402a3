// The gradient of causal (or full, or prefix-LM) flash attention on Hopper: dQ, dK and dV
// of o = softmax(q kᵀ / √D) v for q [B, H, T, D], k [B, Hkv, Tk, D], v
// [B, Hkv, Tk, Dv] and o, dO [B, H, T, Dv], float32 or bfloat16, (D, Dv) ∈
// {(8, 8), (16, 16), (32, 32), (64, 64), (128, 128), (16, 8)}: (16, 8) is
// deepseek-v3-671b's reduced MLA (q and k of nope + rope columns, v of its
// own width).
//
// Replaces: no Pallas kernel.  The reference trains by jax.grad through
// flash_attention_jnp (src/repro/models/attention.py:76), and the Pallas
// forward (src/repro/kernels/flash_attention.py) has no custom_vjp.  On the
// card the forward is a hand kernel (flash_attention_wgmma.cu,
// flash_attention_tf32.cu, flash_attention.cu), which autograd cannot
// differentiate, so repro_torch.kernels.flash_attention.FlashAttentionFn
// takes this kernel as its backward.  It computes what the forward
// computes, differentiated: scores scaled by 1/√D (the reference's double
// rounded to float) and masked at -1e30, P in float32 (never rounded to
// the input dtype, as the Pallas kernel keeps it for PV), the denominator
// floored at 1e-30.  GQA is by index: q-head h reads kv-head h / G
// (G = H / Hkv), and dK, dV sum over the G query heads of their group.
//
// FlashAttention-2's backward, recomputing P from q, k and the row
// logsumexp L (the forward kernels do not write L):
//   Δ = rowsum(dO ∘ O) over Dv, P = exp(S − L), dV = Pᵀ dO,
//   dS = P ∘ (dO Vᵀ − Δ), dQ = dS K / √D, dK = dSᵀ Q / √D.
// Two kernels, launched in order on the caller's stream by one C entry:
// - flash_bwd_dq_kernel, a block per (b·H + h, tile of 64 query rows):
//   Δ of its rows from O and dO; pass 1 over the key tiles recomputes the
//   row maximum and sum (L, base 2); pass 2 recomputes P, forms dS in
//   shared memory and accumulates dQ in registers.  It writes L and Δ
//   (float32 scratch the wrapper allocates) for the second kernel.
// - flash_bwd_dkdv_kernel, a block per (b·Hkv + kvh, tile of 64 keys): K
//   and V stay in shared memory; it walks the G query heads of the group
//   and their query tiles (causal: only those at or below the keys),
//   recomputes P from L, and accumulates dK and dV in registers.
// Every output element is one thread's sum in a fixed order: no atomics,
// so two calls on the same inputs are bitwise equal (a resumed training
// run depends on it).
//
// Arithmetic: SIMT float32 FMAs (CUDA cores), inputs converted to float32
// as they are staged; 256 threads a block, each a 4 × 4 micro-tile of a
// 64 × 64 score tile (rows ty + 16i, columns tx + 16j, so the 16 threads of
// a row read 16 consecutive padded rows of K: distinct banks) and the same
// rows' output columns tx + 16j.  Tiles are staged in shared memory as
// float32 rows padded to D + 1 floats (dO and V to Dv + 1); the score tile
// to 65.
//
// Bound.  A causal backward is five T×T×D products over the causal half
// (S, dP, dV, dQ, dK): 5·B·H·T²·D flops; at llama3.2-1b's microbatch (B 4,
// H 32, T 1024, D 64) 43 GFLOP, 0.043 ms at the H100's dense bf16
// tensor-core rate (data sheet).  This kernel does eight (S three times, dP
// twice) on the CUDA cores, whose float32 rate is 67 TFLOP/s: about 1 ms
// at that rate, so it is bounded by its choice of units.  Moving the
// products to mma.sync / wgmma and writing L from the forward are later
// work (ROADMAP Queue 2).
#include <cuda_bf16.h>

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kTile = 64;      // query rows of a dq block, keys of a dkdv block
constexpr int kThreadsBwd = 256;
constexpr int kSPitch = kTile + 1;  // score-tile rows (floats)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// A staged tile of 64 rows of D columns (q and k: D, dO and v: Dv)
template <int D>
struct Rows {
  static constexpr int kPitch = D + 1;            // floats a staged row
  static constexpr int kRowTile = kTile * kPitch;  // one staged tile
  static constexpr int kDJ = (D + 15) / 16;        // output columns a thread
};

template <int D, int DV>
struct Bwd {
  static constexpr int kScore = kTile * kSPitch;
  static constexpr int kTiles = 2 * (Rows<D>::kRowTile + Rows<DV>::kRowTile);
  // dq: Q, dO, K, V and dS; dkdv: K, V, Q, dO, P/dS and L, Δ of 64 rows
  static constexpr size_t kDqBytes = sizeof(float) * (kTiles + kScore);
  static constexpr size_t kDkvBytes = sizeof(float) * (kTiles + kScore + 2 * kTile);
};

// rows [row0, row0 + 64) of a [rows, D] matrix into a padded float tile;
// rows at or past `rows` are zero
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0, int rows) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreadsBwd) {
    const int r = e / D;
    const int c = e - r * D;
    dst[r * Rows<D>::kPitch + c] =
        row0 + r < rows ? to_float(src[static_cast<long long>(row0) * D + e]) : 0.f;
  }
}

// s[i][j] = a[ty + 16i] · b[tx + 16j] over D, for padded float tiles a, b
template <int D>
__device__ __forceinline__ void micro_dot(const float* a, const float* b, int ty, int tx,
                                          float s[4][4]) {
  constexpr int P = Rows<D>::kPitch;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * P + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * P + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

// acc[i][j] += Σ_r w[r][ty + 16i] · m[r][tx + 16j] over the 64 rows of the
// score tile w (pitch 65) and the padded float tile m
template <int D>
__device__ __forceinline__ void micro_tn(const float* w, const float* m, int ty, int tx,
                                         float acc[4][Rows<D>::kDJ]) {
  constexpr int P = Rows<D>::kPitch;
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = w[r * kSPitch + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < Rows<D>::kDJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        const float y = m[r * P + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(x[i], y, acc[i][j]);
      }
    }
  }
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreadsBwd)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout, T* __restrict__ dq,
                        float* __restrict__ lse2, float* __restrict__ delta, int H, int Hkv,
                        int Tq, int Tk, float scale, int causal, int prefix) {
  constexpr int P = Rows<D>::kPitch;
  constexpr int PV = Rows<DV>::kPitch;
  constexpr int DJ = Rows<D>::kDJ;
  constexpr int DJV = Rows<DV>::kDJ;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + Rows<D>::kRowTile;
  float* Ks = dOs + Rows<DV>::kRowTile;
  float* Vs = Ks + Rows<D>::kRowTile;
  float* Ss = Vs + Rows<DV>::kRowTile;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const long long kvh = static_cast<long long>(b) * Hkv + h / (H / Hkv);
  const int q0 = qt * kTile;
  const long long row_base = static_cast<long long>(bh) * Tq;
  const T* kb = k + kvh * Tk * D;
  const T* vb = v + kvh * Tk * DV;
  const float c2 = scale * kLog2e;  // scores to base-2 exponents

  stage<T, D>(Qs, q + row_base * D, q0, Tq);
  stage<T, DV>(dOs, dout + row_base * DV, q0, Tq);
  __syncthreads();

  // Δ of the thread's rows: the 16 threads of a row each sum columns
  // tx + 16j, then reduce over the row in a fixed order
  float dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    float part = 0.f;
    if (q0 + r < Tq) {
      const T* orow = o + (row_base + q0 + r) * DV;
#pragma unroll
      for (int j = 0; j < DJV; ++j) {
        const int d = tx + 16 * j;
        if (d < DV) part = fmaf(dOs[r * PV + d], to_float(orow[d]), part);
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off, 16);
    dl[i] = part;
  }

  // row r sees keys 0..max(r, prefix − 1) (causal; prefix 0: none)
  const int q_last = max(min(q0 + kTile, Tq) - 1, prefix - 1);
  int n_tiles = (Tk + kTile - 1) / kTile;
  if (causal) n_tiles = min(n_tiles, q_last / kTile + 1);

  // pass 1: the row maximum and sum of exp2 over every key tile
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's readers are done
    stage<T, D>(Ks, kb, k0, Tk);
    __syncthreads();
    float s[4][4];
    micro_dot<D>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        s[i][j] = (kpos >= Tk || (causal && kpos > max(qpos, prefix - 1))) ? kNegInf
                                                                           : s[i][j] * c2;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += exp2f(s[i][j] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off, 16);
      l[i] = l[i] * exp2f(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }
  float lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lrow[i] = m[i] + log2f(fmaxf(l[i], 1e-30f));
    const int r = q0 + ty + 16 * i;
    if (tx == 0 && r < Tq) {
      lse2[row_base + r] = lrow[i];
      delta[row_base + r] = dl[i];
    }
  }

  // pass 2: P, dS and dQ
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's readers are done
    stage<T, D>(Ks, kb, k0, Tk);
    stage<T, DV>(Vs, vb, k0, Tk);
    __syncthreads();
    float s[4][4], dp[4][4];
    micro_dot<D>(Qs, Ks, ty, tx, s);
    micro_dot<DV>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool in = qpos < Tq && kpos < Tk && !(causal && kpos > max(qpos, prefix - 1));
        const float p = in ? exp2f(s[i][j] * c2 - lrow[i]) : 0.f;
        Ss[(ty + 16 * i) * kSPitch + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    }
    __syncthreads();
    // acc[i][j] += Σ_c dS[ty + 16i][c] · k[c][tx + 16j]
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = Ss[(ty + 16 * i) * kSPitch + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float y = Ks[c * P + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(x[i], y, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Tq) continue;
    T* row = dq + (row_base + r) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(row + d, acc[i][j] * scale);
    }
  }
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreadsBwd)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse2, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv, int Tq,
                          int Tk, float scale, int causal, int prefix) {
  constexpr int DJ = Rows<D>::kDJ;
  constexpr int DJV = Rows<DV>::kDJ;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + Rows<D>::kRowTile;
  float* Qs = Vs + Rows<DV>::kRowTile;
  float* dOs = Qs + Rows<D>::kRowTile;
  float* Ps = dOs + Rows<DV>::kRowTile;
  float* Ls = Ps + Bwd<D, DV>::kScore;
  float* Ds = Ls + kTile;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int kt = blockIdx.x;  // causal: the first key tiles see the most queries
  const int bkv = blockIdx.y;
  const int b = bkv / Hkv;
  const int kvh = bkv - b * Hkv;
  const int G = H / Hkv;
  const int k0 = kt * kTile;
  const long long kv_base = static_cast<long long>(bkv) * Tk;
  const float c2 = scale * kLog2e;

  stage<T, D>(Ks, k + kv_base * D, k0, Tk);
  stage<T, DV>(Vs, v + kv_base * DV, k0, Tk);

  float dka[4][DJ], dva[4][DJV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) dka[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < DJV; ++j) dva[i][j] = 0.f;
  }

  const int nq = (Tq + kTile - 1) / kTile;
  // causal: query i sees keys 0..i, so tiles of rows below k0 see none of
  // these keys (the tiles are 64 rows and 64 keys, aligned at 0); with a
  // prefix, rows below it see the keys below it, so a tile of such keys
  // takes every query tile
  const int qt0 = causal && k0 >= prefix ? kt : 0;
  for (int g = 0; g < G; ++g) {
    const long long row_base = (static_cast<long long>(b) * H + kvh * G + g) * Tq;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous tile's readers are done
      stage<T, D>(Qs, q + row_base * D, q0, Tq);
      stage<T, DV>(dOs, dout + row_base * DV, q0, Tq);
      if (threadIdx.x < kTile) {
        const int r = q0 + threadIdx.x;
        Ls[threadIdx.x] = r < Tq ? lse2[row_base + r] : 0.f;
        Ds[threadIdx.x] = r < Tq ? delta[row_base + r] : 0.f;
      }
      __syncthreads();
      // query rows ty + 16i against keys tx + 16j
      float s[4][4], dp[4][4];
      micro_dot<D>(Qs, Ks, ty, tx, s);
      micro_dot<DV>(dOs, Vs, ty, tx, dp);
      float ds[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = ty + 16 * i;
        const int qpos = q0 + rr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kpos = k0 + tx + 16 * j;
          const bool in = qpos < Tq && kpos < Tk && !(causal && kpos > max(qpos, prefix - 1));
          const float p = in ? exp2f(s[i][j] * c2 - Ls[rr]) : 0.f;
          Ps[rr * kSPitch + tx + 16 * j] = p;
          ds[i][j] = p * (dp[i][j] - Ds[rr]);
        }
      }
      __syncthreads();
      micro_tn<DV>(Ps, dOs, ty, tx, dva);  // dV[c] += Σ_r P[r][c] dO[r]
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * kSPitch + tx + 16 * j] = ds[i][j];
      __syncthreads();
      micro_tn<D>(Ps, Qs, ty, tx, dka);  // dK[c] += Σ_r dS[r][c] q[r]
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= Tk) continue;
    T* krow = dk + (kv_base + c) * D;
    T* vrow = dv + (kv_base + c) * DV;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(krow + d, dka[i][j] * scale);
    }
#pragma unroll
    for (int j = 0; j < DJV; ++j) {
      const int d = tx + 16 * j;
      if (d < DV) store(vrow + d, dva[i][j]);
    }
  }
}

template <typename T, int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, void* dq, void* dk, void* dv, float* lse2,
                   float* delta, int B, int H, int Hkv, int Tq, int Tk, int causal,
                   int prefix, cudaStream_t stream) {
  using L = Bwd<D, DV>;
  auto dq_kernel = flash_bwd_dq_kernel<T, D, DV>;
  auto dkv_kernel = flash_bwd_dkdv_kernel<T, D, DV>;
  cudaError_t err = repro::allow_smem(dq_kernel, L::kDqBytes);
  if (err == cudaSuccess) err = repro::allow_smem(dkv_kernel, L::kDkvBytes);
  if (err != cudaSuccess) return err;
  // the reference's 1.0 / (D ** 0.5), a double rounded to float
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const dim3 grid_q((Tq + kTile - 1) / kTile, B * H);
  dq_kernel<<<grid_q, kThreadsBwd, L::kDqBytes, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, static_cast<T*>(dq), lse2, delta, H, Hkv,
      Tq, Tk, scale, causal, prefix);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k((Tk + kTile - 1) / kTile, B * Hkv);
  dkv_kernel<<<grid_k, kThreadsBwd, L::kDkvBytes, stream>>>(
      qt, kt, vt, dot, lse2, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv, Tq,
      Tk, scale, causal, prefix);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, void* dq, void* dk, void* dv, float* lse2,
                       float* delta, int B, int H, int Hkv, int Tq, int Tk, int D,
                       int Dv, int causal, int prefix, cudaStream_t stream) {
#define REPRO_BWD_CASE(DIM, DIMV)                                                    \
  if (D == DIM && Dv == DIMV)                                                        \
    return launch<T, DIM, DIMV>(q, k, v, o, dout, dq, dk, dv, lse2, delta, B, H, Hkv, \
                                Tq, Tk, causal, prefix, stream);
  REPRO_BWD_CASE(8, 8)
  REPRO_BWD_CASE(16, 16)
  REPRO_BWD_CASE(32, 32)
  REPRO_BWD_CASE(64, 64)
  REPRO_BWD_CASE(128, 128)
  REPRO_BWD_CASE(16, 8)
#undef REPRO_BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype 0: float32, 1: bfloat16; (D, Dv) a pair above; causal with prefix
// P > 0 (Tq == Tk): row r sees keys 0..max(r, P − 1), the prefix-LM mask.
// lse2 and delta are float32 [B, H, Tq]
// scratch (the row logsumexp in base 2, and Δ), written by the first kernel
// and read by the second.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, void* dq, void* dk,
                                         void* dv, void* lse2, void* delta, int B, int H,
                                         int Hkv, int Tq, int Tk, int D, int Dv,
                                         int dtype, int causal, int prefix,
                                         cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Tq <= 0 || Tk <= 0 ||
      (causal && Tq != Tk) || prefix < 0 || prefix > Tq || (prefix > 0 && !causal))
    return static_cast<int>(cudaErrorInvalidValue);
  float* l = static_cast<float*>(lse2);
  float* dl = static_cast<float*>(delta);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_dim<float>(q, k, v, o, dout, dq, dk, dv, l, dl, B, H, Hkv, Tq, Tk, D, Dv,
                            causal, prefix, stream);
  } else if (dtype == 1) {
    err = launch_dim<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, l, dl, B, H, Hkv, Tq, Tk,
                                    D, Dv, causal, prefix, stream);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

REPRO_DEFINE_ERROR_STRING(repro_flash_attention_bwd)
