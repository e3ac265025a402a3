// Causal flash attention on Hopper at small head dims: o = softmax(q kᵀ /
// √D, causal) v for q [B, H, T, D], k [B, Hkv, Tk, D], v [B, Hkv, Tk, Dv]
// and o [B, H, T, Dv], float32 or bfloat16, optionally under a prefix-LM
// mask (prefix P: row r sees keys 0..max(r, P − 1), the reduced
// paligemma-3b's 16 patch positions; tiles are visited up to max(last row,
// P − 1) and masked past max(first row, P − 1)).  Two kernels in one library:
// - flash_attention_mma_kernel, the one the wrapper takes at (D, Dv) ∈
//   {(8, 8), (16, 16), (32, 32), (16, 8)}: warp-level tensor cores
//   (mma.sync), each product sized by its own head dim (QKᵀ by D, PV and O
//   by Dv);
// - flash_attention_kernel, the first (SIMT) port, compiled for D = Dv ∈
//   {8, 16, 32, 64, 128} and launched only on request (chip_smoke.py times
//   it beside every other variant).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (Pallas
// body _kernel) at the head dims no full-size config of the port has
// (those take flash_attention_wgmma.cu and flash_attention_tf32.cu): the
// reduced configs, e.g. path D's reduced llama at head dim 16 and the
// reduced deepseek's MLA at (16, 8) (q and k of 8 + 8 columns, v of 8).  Both
// kernels compute what the Pallas kernel computes: scores scaled by 1/√D
// and masked at -1e30, a running max and denominator in float32 (an online
// softmax over K/V tiles), the probabilities kept in float32 for the PV
// product, the denominator floored at 1e-30, and one rounding of the output
// to q's dtype.  GQA is by index (q-head h reads kv-head h / (H / Hkv)),
// where the reference repeats K and V in memory.
//
// Bound.  At (B 4, H 32, Hkv 8, T 1024, D 32), causal: 8.6 GFLOP, 8.7 µs
// at an H100 SXM's bf16 tensor-core rate (data sheet); as three TF32
// products 52 µs; and 67 M exponentials, 16 µs at the MUFU rate (16 a
// clock an SM, 132 SMs at 1980 MHz).  At path D's
// reduced leg (2, 4, 2, 64, 16) the launch and one round trip are the time.
//
// The mma kernel.  mma.sync takes its fragments from registers: at K = 8–32
// a 64-row wgmma buys little, and would need swizzle modes and
// descriptors no other kernel of the port uses.  Shapes: bf16 QKᵀ
// m16n8k16 (m16n8k8 at D = 8) and PV m16n8k16; float32 every product
// m16n8k8 TF32.  A block is warps of 16 query rows, heaviest causal tiles
// first; the warp's Q fragments stay in registers for the whole block.
// Every K/V tile is read from L2 once a block: float32 takes 8 warps (128
// rows), so that the tile's bytes and its split (below) serve twice the
// rows; bf16 4 (64 rows), which ran faster than 8 there (at (4, 32, 8,
// 1024, 32) on an H100 80GB HBM3 at 700 W, tools/kernel_variants.py: the
// copies alone took 40 µs with 64-row blocks and 22 with 128, but the
// whole bf16 kernel 96 and 100).  A warp skips a tile wholly after its
// rows, and every tile when its rows are past Tq.  K/V tiles of 64 keys
// are staged with cp.async in 16-byte copies into a ring of three stages,
// so tiles t + 1 and t + 2 load while tile t computes, with one block
// barrier a tile (float32: two, around the split); Q (plain loads) and the
// first tiles arrive in one round trip.  Shared memory rows are padded (16
// bytes past rows wider than 16 bytes), so a warp's fragment loads and
// ldmatrix's row addresses hit distinct banks.
// - S = Q Kᵀ for the warp's 16 rows and the tile's 64 keys: 8 n-tiles of
//   8 keys, K's B fragments by 32-bit shared loads.
// - Online softmax in registers: a lane holds rows g and g + 8 (g = lane /
//   4), so row max and sum reduce over the quad with two shuffles; P =
//   exp2f(s·c − m·c), c = log₂e / √D (flash_attention_wgmma.cu).
//   Only a tile that crosses Tk or the diagonal is masked; tiles wholly
//   above the diagonal are not visited, so any T works.
// - PV: S's accumulator registers are P's A fragments.  bf16: the
//   accumulator's n-tiles 2s and 2s + 1 are k-step s's four registers as
//   they stand; V's B fragments come from ldmatrix.trans.  TF32: an
//   accumulator holds keys 2t and 2t + 1 (t = lane % 4), the fragment
//   positions t and t + 4, so V's fragments are read at keys 2t and
//   2t + 1: no shuffle, no shared-memory round trip for P.
// - bf16: P enters PV as three bf16 terms by truncation, which sum to the
//   float32 P exactly (two miss the per-element bf16 check,
//   tests/test_torch_flash_wgmma.py).  float32: both products take three
//   TF32 terms (a_hi·b_hi + a_hi·b_lo + a_lo·b_hi, repro::split_tf32):
//   Q once a block in registers, P in registers, K and V once a tile at
//   staging by the whole block (hi over the raw values, lo in a buffer
//   beside the ring), not by each warp for its fragments.
// - float32: each tile's PV goes into a fresh accumulator that one fmaf
//   adds to O (O·alpha + tile), as flash_attention_tf32.cu: the tensor
//   cores' float32 accumulation then runs over one tile's products.  bf16:
//   into O itself, scaled by alpha first, as flash_attention_wgmma.cu (its
//   output is rounded to bf16).
//
// The SIMT kernel (the first version): one block of 256 threads per
// (b·H + h, tile of 64 query rows); q and K/V tiles of 64 keys staged in
// shared memory as float32 (rows padded to D + 1 floats); each thread a 4 ×
// 4 micro-tile of scores and the same rows' output columns; expf.
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
                           int Tq, int Tk, float scale, int causal, int prefix) {
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

  // row r sees keys 0..max(r, prefix − 1) (causal; prefix 0: none)
  const int q_last = max(min(q0 + kBlockQ, Tq) - 1, prefix - 1);
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
        if (kpos >= Tk || (causal && kpos > max(qpos, prefix - 1))) s[i][j] = kNegInf;
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
                   int Hkv, int Tq, int Tk, int causal, int prefix, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  const size_t bytes = Layout<D>::kBytes;
  const cudaError_t err = repro::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  // the reference's 1.0 / (D ** 0.5), a double rounded to float
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const dim3 grid((Tq + kBlockQ - 1) / kBlockQ, B * H);
  kernel<<<grid, kThreadsFA, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hkv, Tq, Tk, scale, causal, prefix);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const void* q, const void* k, const void* v, void* o, int B,
                       int H, int Hkv, int Tq, int Tk, int D, int causal, int prefix,
                       cudaStream_t stream) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, o, B, H, Hkv, Tq, Tk, causal, prefix, stream);
    case 16: return launch<T, 16>(q, k, v, o, B, H, Hkv, Tq, Tk, causal, prefix, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, Hkv, Tq, Tk, causal, prefix, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, Hkv, Tq, Tk, causal, prefix, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Hkv, Tq, Tk, causal, prefix, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The tensor-core kernel, D ∈ {8, 16, 32}
// ---------------------------------------------------------------------------

// Variants: 0 in the library; tools/kernel_variants.py builds the source
// with REPRO_VARIANT set to one of the cuts below, to time what each part
// of the mma kernel costs.
#ifndef REPRO_VARIANT
#define REPRO_VARIANT 0
#endif

constexpr int kVariant = REPRO_VARIANT;
constexpr int kNoPV = 1;       // S and the softmax, no PV
constexpr int kNoSoftmax = 2;  // P = S: no max, no exponentials
constexpr int kNoCompute = 3;  // the tiles staged, nothing computed
constexpr int kOneTerm = 4;    // one term a product (hi·hi; P_1 alone)

constexpr int kMmaKeys = 64;   // keys of a staged K/V tile
constexpr int kMmaStages = 3;  // the ring of staged K/V tiles
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D, int DV>
struct MmaCfg {
  static constexpr bool kTF32 = sizeof(T) == 4;
  // warps of 16 query rows a block: float32 8 (each K/V tile, split once,
  // serves 128 rows), bf16 4 (measured faster than 8 at (4, 32, 8, 1024,
  // 32), tools/kernel_variants.py)
  static constexpr int kWarps = kTF32 ? 8 : 4;
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRowBytesK = D * static_cast<int>(sizeof(T));
  static constexpr int kRowBytesV = DV * static_cast<int>(sizeof(T));
  // shared-memory row pitch: 16-byte rows packed, wider rows padded by 16
  // bytes, so the 8 rows of a fragment load (or of an ldmatrix) fall in
  // distinct banks
  static constexpr int kPitchK = kRowBytesK == 16 ? 16 : kRowBytesK + 16;
  static constexpr int kPitchV = kRowBytesV == 16 ? 16 : kRowBytesV + 16;
  static constexpr int kTileBytesK = kMmaKeys * kPitchK;      // one K tile
  static constexpr int kTileBytesV = kMmaKeys * kPitchV;      // one V tile
  static constexpr int kStageBytes = kTileBytesK + kTileBytesV;  // K, then V
  // float32: the landed tile's TF32 lo terms (K, then V) beside its stage,
  // whose raw values the hi terms replace
  static constexpr int kLoBytes = kTF32 ? kStageBytes : 0;
  static constexpr int kBytes = kMmaStages * kStageBytes + kLoBytes;
  static constexpr int kChunksK = kRowBytesK / 16;      // 16-byte copies a K row
  static constexpr int kChunksV = kRowBytesV / 16;      // and a V row
  static constexpr int kQK = kTF32 || D == 8 ? 8 : 16;  // QKᵀ: k of an mma
  static constexpr int kQSteps = D / kQK;
  static constexpr int kARegs = kTF32 || kQK == 16 ? 4 : 2;  // Q's registers a k-step
  static constexpr int kNT = kMmaKeys / 8;               // n-tiles of S
  static constexpr int kND = DV / 8;                     // n-tiles of O
  static constexpr int kPK = kTF32 ? 8 : 16;             // PV: keys a k-step
  static constexpr int kTerms = kVariant == kOneTerm ? 1 : 3;
};

// d += a · b: m16n8k16, bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma_bf16_k16(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a · b: m16n8k8, bf16 operands (a[0], a[1]), float32 accumulators.
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], const uint32_t (&a)[4],
                                            uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// d += a · b: m16n8k8, TF32 operands, float32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Transposed 8 x 8 bf16 matrices from shared memory: lane i gives the row
// address of matrix i / 8 (row i % 8); register m of a lane holds matrix
// m's (row 2·(lane % 4), column lane / 4) and (row 2·(lane % 4) + 1, same
// column).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// 16 bytes from global to shared memory, asynchronously; src_bytes = 0
// fills the 16 bytes with zeros (and reads nothing).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Fragment layouts (lane = 4g + t): an m16n8 float32 accumulator holds
// (row g, columns 2t, 2t + 1) in registers 0, 1 and (row g + 8, the same
// columns) in 2, 3.  A of m16n8k16 (bf16 pairs): (g, 2t..), (g + 8, 2t..),
// (g, 2t + 8..), (g + 8, 2t + 8..); of m16n8k8 bf16 the first two.  A of
// m16n8k8 TF32: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).  B (k x 8,
// column n = g): bf16 k16 (2t, 2t + 1) and (2t + 8, 2t + 9); bf16 k8 (2t,
// 2t + 1); TF32 t and t + 4.
template <typename T, int D, int DV>
__global__ void __launch_bounds__(MmaCfg<T, D, DV>::kThreads, 2)
    flash_attention_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
                               int Tq, int Tk, float scale_log2, int causal, int prefix) {
  // scale_log2 = log₂e / √D: P = exp2(s·scale_log2 − m·scale_log2)
  using C = MmaCfg<T, D, DV>;
  extern __shared__ __align__(128) unsigned char smem_mma[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const long long kvh = static_cast<long long>(b) * Hkv + h / (H / Hkv);
  const int q0 = qt * C::kRows;
  const int w0 = q0 + 16 * warp;  // the warp's first row
  const int r0 = w0 + g;          // this lane's rows: r0 and r0 + 8
  const char* kb = reinterpret_cast<const char*>(k + kvh * Tk * D);
  const char* vb = reinterpret_cast<const char*>(v + kvh * Tk * DV);
  const uint32_t sbase = repro::smem_u32(smem_mma);

  // row r sees keys 0..max(r, prefix − 1) (causal; prefix 0: none)
  const int q_last = max(min(q0 + C::kRows, Tq) - 1, prefix - 1);
  int n_tiles = (Tk + kMmaKeys - 1) / kMmaKeys;
  if (causal) n_tiles = min(n_tiles, q_last / kMmaKeys + 1);

  // keys k0 .. k0 + 63 of K and V into stage s, 16 bytes a copy; keys past
  // Tk are zero-filled (source size 0, the address kept in the head)
  auto stage = [&](int t, int s) {
    const int k0 = t * kMmaKeys;
    const uint32_t dst = sbase + s * C::kStageBytes;
    // D = Dv: a K and a V copy of the same row and chunk in one loop (two
    // loops, as below, cost the float32 instances registers: 104 bytes of
    // spills at D = 32 against 56, 8 at D = 16 against none)
    if constexpr (D == DV) {
      for (int c = threadIdx.x; c < kMmaKeys * C::kChunksK; c += C::kThreads) {
        const int r = c / C::kChunksK, j = c % C::kChunksK;
        const bool in = k0 + r < Tk;
        const long long off =
            (in ? static_cast<long long>(k0 + r) * C::kRowBytesK : 0) + 16 * j;
        cp_async16(dst + r * C::kPitchK + 16 * j, kb + off, in ? 16 : 0);
        cp_async16(dst + C::kTileBytesK + r * C::kPitchK + 16 * j, vb + off, in ? 16 : 0);
      }
      return;
    }
    for (int c = threadIdx.x; c < kMmaKeys * C::kChunksK; c += C::kThreads) {
      const int r = c / C::kChunksK, j = c % C::kChunksK;
      const bool in = k0 + r < Tk;
      const long long off = (in ? static_cast<long long>(k0 + r) * C::kRowBytesK : 0) + 16 * j;
      cp_async16(dst + r * C::kPitchK + 16 * j, kb + off, in ? 16 : 0);
    }
    for (int c = threadIdx.x; c < kMmaKeys * C::kChunksV; c += C::kThreads) {
      const int r = c / C::kChunksV, j = c % C::kChunksV;
      const bool in = k0 + r < Tk;
      const long long off = (in ? static_cast<long long>(k0 + r) * C::kRowBytesV : 0) + 16 * j;
      cp_async16(dst + C::kTileBytesK + r * C::kPitchV + 16 * j, vb + off, in ? 16 : 0);
    }
  };
  // the ring's first tiles (a group each, empty past the last tile, so
  // that the wait below counts groups alike)
#pragma unroll
  for (int t = 0; t < kMmaStages - 1; ++t) {
    if (t < n_tiles) stage(t, t);
    cp_async_commit();
  }

  // Q's A fragments, loaded while the first tile lands (rows past Tq are
  // zeros): TF32 hi and lo, or bf16 pairs
  uint32_t qa[C::kQSteps][4] = {}, ql[C::kQSteps][4] = {};
#pragma unroll
  for (int j = 0; j < C::kARegs; ++j) {
    const int row = r0 + 8 * (j & 1);
    if (row >= Tq) continue;
    const T* qrow = q + (static_cast<long long>(bh) * Tq + row) * D;
#pragma unroll
    for (int s = 0; s < C::kQSteps; ++s) {
      if constexpr (C::kTF32) {
        repro::split_tf32(qrow[8 * s + t4 + 4 * (j >> 1)], qa[s][j], ql[s][j]);
      } else {
        qa[s][j] = *reinterpret_cast<const uint32_t*>(qrow + 16 * s + 2 * t4 + 8 * (j >> 1));
      }
    }
  }

  float acc[C::kND][4] = {};
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share of each row's sum

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kMmaStages;
    cp_async_wait<kMmaStages - 2>();  // this thread's copies of tile t landed
    // every thread's copies of tile t are visible, and every warp is done
    // with tile t - 1, whose stage is refilled next
    __syncthreads();
    if (t + kMmaStages - 1 < n_tiles) stage(t + kMmaStages - 1, (t + kMmaStages - 1) % kMmaStages);
    cp_async_commit();
    unsigned char* ks = smem_mma + s * C::kStageBytes;  // K rows, then V rows
    const unsigned char* klo = smem_mma + kMmaStages * C::kStageBytes;
    if constexpr (C::kTF32) {
      // split the landed tile once for every warp: hi in place, lo beside;
      // the K rows (chunks of kChunksK), then the V rows (kChunksV), which
      // at D = Dv are one run of 2·kMmaKeys rows of one pitch
      auto split16 = [&](int off) {
        const float4 x = *reinterpret_cast<const float4*>(ks + off);
        uint4 hi, lo;
        repro::split_tf32(x.x, hi.x, lo.x);
        repro::split_tf32(x.y, hi.y, lo.y);
        repro::split_tf32(x.z, hi.z, lo.z);
        repro::split_tf32(x.w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(ks + off) = hi;
        *reinterpret_cast<uint4*>(smem_mma + kMmaStages * C::kStageBytes + off) = lo;
      };
      constexpr int kKRows = D == DV ? 2 * kMmaKeys : kMmaKeys;
      for (int c = threadIdx.x; c < kKRows * C::kChunksK; c += C::kThreads)
        split16((c / C::kChunksK) * C::kPitchK + 16 * (c % C::kChunksK));
      if constexpr (D != DV) {
        for (int c = threadIdx.x; c < kMmaKeys * C::kChunksV; c += C::kThreads)
          split16(C::kTileBytesK + (c / C::kChunksV) * C::kPitchV + 16 * (c % C::kChunksV));
      }
      __syncthreads();
    }
    const int k0 = t * kMmaKeys;
    // a warp whose rows are all past Tq, or all before the tile's first key
    // (causal), has nothing to add from it
    if (kVariant == kNoCompute || w0 >= Tq || (causal && k0 > max(w0 + 15, prefix - 1))) {
      if (kVariant == kNoCompute) l[0] = l[1] = 1.f;
      continue;
    }
    const uint32_t sv = sbase + s * C::kStageBytes + C::kTileBytesK;

    // S = Q Kᵀ: n-tile nt holds keys k0 + 8nt + 2t4 (+1), rows r0 (+8)
    float sc[C::kNT][4];
#pragma unroll
    for (int nt = 0; nt < C::kNT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = 0.f;
      const unsigned char* krow = ks + (8 * nt + g) * C::kPitchK;
      if constexpr (C::kTF32) {
        const uint32_t* kr = reinterpret_cast<const uint32_t*>(krow);
        const uint32_t* kq = reinterpret_cast<const uint32_t*>(klo + (krow - ks));
        uint32_t kh[C::kQSteps][2], kl[C::kQSteps][2];
#pragma unroll
        for (int q8 = 0; q8 < C::kQSteps; ++q8) {
          kh[q8][0] = kr[8 * q8 + t4], kh[q8][1] = kr[8 * q8 + t4 + 4];
          kl[q8][0] = kq[8 * q8 + t4], kl[q8][1] = kq[8 * q8 + t4 + 4];
        }
        if (C::kTerms == 3) {  // the two small terms first
#pragma unroll
          for (int q8 = 0; q8 < C::kQSteps; ++q8) {
            mma_tf32(sc[nt], ql[q8], kh[q8]);
            mma_tf32(sc[nt], qa[q8], kl[q8]);
          }
        }
#pragma unroll
        for (int q8 = 0; q8 < C::kQSteps; ++q8) mma_tf32(sc[nt], qa[q8], kh[q8]);
      } else {
        const uint32_t* kr = reinterpret_cast<const uint32_t*>(krow);
#pragma unroll
        for (int q16 = 0; q16 < C::kQSteps; ++q16) {
          if constexpr (C::kQK == 16) {
            mma_bf16_k16(sc[nt], qa[q16], kr[8 * q16 + t4], kr[8 * q16 + 4 + t4]);
          } else {
            mma_bf16_k8(sc[nt], qa[q16], kr[t4]);
          }
        }
      }
    }

    // online softmax over the tile; masked scores are -1e30
    if (k0 + kMmaKeys > Tk || (causal && k0 + kMmaKeys - 1 > max(w0, prefix - 1))) {
#pragma unroll
      for (int nt = 0; nt < C::kNT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + 8 * nt + 2 * t4 + (i & 1);
          if (key >= Tk || (causal && key > max(r0 + 8 * (i >> 1), prefix - 1)))
            sc[nt][i] = kNegInf;
        }
      }
    }
    float alpha[2] = {1.f, 1.f};
    if (kVariant == kNoSoftmax) {
#pragma unroll
      for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) l[i >> 1] += sc[nt][i];
    } else {
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], sc[nt][i]);
      float mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f((m[r] - mx[r]) * scale_log2);
        m[r] = mx[r];
        mc[r] = mx[r] * scale_log2;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int nt = 0; nt < C::kNT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[nt][i] = exp2f(fmaf(sc[nt][i], scale_log2, -mc[i >> 1]));
          l[i >> 1] += sc[nt][i];
        }
      }
    }

    // float32: this tile's P V into a fresh accumulator, then O = O·alpha +
    // P V; bf16: O = O·alpha, then O += P V
    float pv[C::kND][4] = {};
    if constexpr (!C::kTF32) {
#pragma unroll
      for (int nd = 0; nd < C::kND; ++nd)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nd][i] *= alpha[i >> 1];
    }
#pragma unroll
    for (int kk = 0; kk < (kVariant == kNoPV ? 0 : kMmaKeys / C::kPK); ++kk) {
      float(&out)[C::kND][4] = C::kTF32 ? pv : acc;
      if constexpr (C::kTF32) {
        // k-step kk is S's n-tile kk: registers 0, 2, 1, 3 are the fragment
        // (positions t4, t4 + 4 hold keys 2t4, 2t4 + 1), so V's B
        // fragment is read at keys 2t4 and 2t4 + 1
        const float pa[4] = {sc[kk][0], sc[kk][2], sc[kk][1], sc[kk][3]};
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) repro::split_tf32(pa[j], ph[j], pl[j]);
        const int v0 = C::kTileBytesK + (8 * kk + 2 * t4) * C::kPitchV;  // V row 2t4
        const uint32_t* vr0 = reinterpret_cast<const uint32_t*>(ks + v0);
        const uint32_t* vr1 = reinterpret_cast<const uint32_t*>(ks + v0 + C::kPitchV);
        const uint32_t* vq0 = reinterpret_cast<const uint32_t*>(klo + v0);
        const uint32_t* vq1 = reinterpret_cast<const uint32_t*>(klo + v0 + C::kPitchV);
#pragma unroll
        for (int nd = 0; nd < C::kND; ++nd) {
          const uint32_t vh[2] = {vr0[8 * nd + g], vr1[8 * nd + g]};
          const uint32_t vl[2] = {vq0[8 * nd + g], vq1[8 * nd + g]};
          if (C::kTerms == 3) {
            mma_tf32(out[nd], pl, vh);
            mma_tf32(out[nd], ph, vl);
          }
          mma_tf32(out[nd], ph, vh);
        }
      } else {
        // k-step kk (16 keys) is S's n-tiles 2kk and 2kk + 1 as they stand,
        // P in three bf16 terms by truncation (each difference exact)
        float x[4][2] = {{sc[2 * kk][0], sc[2 * kk][1]},
                         {sc[2 * kk][2], sc[2 * kk][3]},
                         {sc[2 * kk + 1][0], sc[2 * kk + 1][1]},
                         {sc[2 * kk + 1][2], sc[2 * kk + 1][3]}};
        uint32_t pt[3][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const uint32_t b0 = __float_as_uint(x[j][0]), b1 = __float_as_uint(x[j][1]);
            pt[a][j] = repro::bf16x2_high(b0, b1);
            x[j][0] -= __uint_as_float(b0 & 0xffff0000u);
            x[j][1] -= __uint_as_float(b1 & 0xffff0000u);
          }
        }
        // V's B fragments: matrix m of the ldmatrix is keys 16kk + 8(m & 1)
        // .. + 7 of n-tile nd + (m >> 1)
        const int mrow = 16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7);
#pragma unroll
        for (int nd = 0; nd < C::kND; nd += 2) {
          uint32_t vf[4];
          if constexpr (C::kND == 1) {
            ldmatrix_x2_trans(vf, sv + mrow * C::kPitchV);
          } else {
            ldmatrix_x4_trans(vf, sv + mrow * C::kPitchV + 16 * (nd + (lane >> 4)));
          }
#pragma unroll
          for (int a = 0; a < C::kTerms; ++a) mma_bf16_k16(out[nd], pt[a], vf[0], vf[1]);
          if constexpr (C::kND > 1) {
#pragma unroll
            for (int a = 0; a < C::kTerms; ++a) mma_bf16_k16(out[nd + 1], pt[a], vf[2], vf[3]);
          }
        }
      }
    }
    if constexpr (C::kTF32) {
#pragma unroll
      for (int nd = 0; nd < C::kND; ++nd)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nd][i] = fmaf(acc[nd][i], alpha[i >> 1], pv[nd][i]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= Tq) continue;
    T* orow = o + (static_cast<long long>(bh) * Tq + row) * DV;
#pragma unroll
    for (int nd = 0; nd < C::kND; ++nd)
      store2(orow + 8 * nd + 2 * t4, acc[nd][2 * r] / l[r], acc[nd][2 * r + 1] / l[r]);
  }
}

template <typename T, int D, int DV>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B, int H,
                       int Hkv, int Tq, int Tk, int causal, int prefix, cudaStream_t stream) {
  using C = MmaCfg<T, D, DV>;
  // the reference's 1.0 / (D ** 0.5), a double rounded to float
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  auto kernel = flash_attention_mma_kernel<T, D, DV>;
  const size_t bytes = C::kBytes;
  const cudaError_t err = repro::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + C::kRows - 1) / C::kRows, B * H);
  kernel<<<grid, C::kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hkv, Tq, Tk, scale * kLog2e, causal, prefix);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mma_dim(const void* q, const void* k, const void* v, void* o, int B,
                           int H, int Hkv, int Tq, int Tk, int D, int Dv, int causal,
                           int prefix, cudaStream_t stream) {
  if (D == 16 && Dv == 8)  // the reduced MLA
    return launch_mma<T, 16, 8>(q, k, v, o, B, H, Hkv, Tq, Tk, causal, prefix, stream);
  if (Dv != D) return cudaErrorInvalidValue;
  switch (D) {
    case 8: return launch_mma<T, 8, 8>(q, k, v, o, B, H, Hkv, Tq, Tk, causal, prefix, stream);
    case 16: return launch_mma<T, 16, 16>(q, k, v, o, B, H, Hkv, Tq, Tk, causal, prefix, stream);
    case 32: return launch_mma<T, 32, 32>(q, k, v, o, B, H, Hkv, Tq, Tk, causal, prefix, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// o [B, H, Tq, Dv] = attention of q [B, H, Tq, D] over k [B, Hkv, Tk, D]
// and v [B, Hkv, Tk, Dv] (all contiguous, one dtype: 0 float32, 1 bfloat16;
// k and v 16-byte aligned for the mma kernel's copies); causal: query i
// sees keys 0..i (Tq == Tk), and with prefix P > 0 (causal only) keys
// 0..max(i, P − 1), the prefix-LM mask.  simt = 0 takes the mma kernel ((D, Dv) ∈
// {(8, 8), (16, 16), (32, 32), (16, 8)}), 1 the SIMT kernel (D = Dv ∈ {8,
// 16, 32, 64, 128}).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, int B, int H, int Hkv, int Tq, int Tk,
                                     int D, int Dv, int dtype, int causal, int prefix,
                                     int simt, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Tq <= 0 || Tk < 0 || simt < 0 ||
      simt > 1 || (simt && Dv != D) || prefix < 0 || prefix > Tq ||
      (prefix > 0 && (!causal || Tq != Tk)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0) {
    err = simt ? launch_dim<float>(q, k, v, o, B, H, Hkv, Tq, Tk, D, causal, prefix, stream)
               : launch_mma_dim<float>(q, k, v, o, B, H, Hkv, Tq, Tk, D, Dv, causal, prefix,
                                       stream);
  } else if (dtype == 1) {
    err = simt ? launch_dim<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Tq, Tk, D, causal, prefix,
                                           stream)
               : launch_mma_dim<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Tq, Tk, D, Dv, causal,
                                               prefix, stream);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

REPRO_DEFINE_ERROR_STRING(repro_flash_attention)
