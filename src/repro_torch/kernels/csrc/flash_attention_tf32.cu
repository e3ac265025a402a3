// Causal flash attention on Hopper's tensor cores in float32: o =
// softmax(q kᵀ / √D, causal) v for q [B, H, T, D], k [B, Hkv, Tk, D], v
// [B, Hkv, Tk, Dv] and o [B, H, T, Dv] in float32, (D, Dv) ∈ {(64, 64),
// (128, 128), (192, 128), (256, 256)}, optionally under paligemma-3b's
// prefix-LM mask.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (Pallas
// body _kernel) for float32 at the head dims of every full-size config the
// port builds (deepseek-v3-671b's MLA: q and k of 192 columns, v of 128):
// the path's float32 precision check.  bf16 at those pairs stays on
// flash_attention_wgmma.cu, every dtype at the reduced configs' head dims
// on flash_attention.cu.  It computes what the Pallas kernel computes: scores
// scaled by 1/√D and masked at -1e30, a running max and denominator in
// float32, probabilities in float32, the denominator floored at 1e-30 and
// one write of a float32 output.  GQA is by index (q-head h reads kv-head
// h / (H / Hkv)).
//
// Bound: operations.  At the LM path's prefill (B 4, H 32, T 1024, D 64)
// the causal half of QKᵀ and PV is 17.2 GFLOP: 0.256 ms at the 67 TFLOP/s
// float32 rate of the CUDA cores, 0.104 ms as three TF32 products at the
// tensor cores' 495 TFLOP/s.
//
// Float32 accuracy from TF32 tensor cores: each product a·b is taken as
// three TF32 terms, a_hi·b_hi + a_hi·b_lo + a_lo·b_hi, with x_hi =
// cvt.rna.tf32(x) and x_lo = cvt.rna.tf32(x − x_hi) (x − x_hi is exact), all
// into one float32 accumulator, the two small terms first.  hi + lo is x
// within 2⁻²² of |x|; the dropped a_lo·b_lo and the rounding of the lo
// terms leave about 2⁻²¹ of each product, where one TF32 term leaves 2⁻¹¹
// and misses the float32 gate (tests/test_torch_flash_tf32.py).
//
// Design.  One block per (b·H + h, pair of query tiles): the x-th heaviest
// causal tile and the x-th lightest, as flash_attention_wgmma.cu.  Warpgroup
// 0 is the producer: one thread keeps a ring of raw stages full by TMA
// (K and V tiles of kN keys, 3-D tensor maps (D, Tk, B·Hkv) zero-filled
// past a head's last key, 128-byte swizzled panels of 32 floats), and all
// its 128 threads split each landed tile into a ring of split slots:
// K_hi and K_lo in K's own (K-major) layout, float4 for float4, and Vᵀ_hi
// and Vᵀ_lo, V transposed to [D x kN], keys contiguous, because .tf32
// wgmma reads only K-major operands (there is no transpose bit for 32-bit
// types).  The consumers (kNC warpgroups of 64 query rows) overlap with the
// split of the next tile:
// - Q is loaded from global memory and split once per query tile: Q_hi
//   into register-A fragments (the tf32 A fragment of a k-step holds
//   columns t and t + 4, t = lane % 4, of rows g and g + 8, g = lane / 4),
//   Q_lo into shared memory in the swizzled K-major layout, an A operand
//   from there: its D / 2 registers a thread do not fit beside O, a tile's
//   P V and P.
// - S = Q Kᵀ: wgmma m64nNk8 (N = kN keys) over D / 8 k-steps, three terms.
// - Online softmax in registers as the bf16 kernel: rows on the 4 threads
//   of a quad, P = exp2(s·c − m·c), c = log₂e / √D (exp2f of the folded
//   argument: within about 4e-7 of expf(s/√D − m/√D), relative).
// - PV: P_hi and P_lo are register-A fragments straight from the S
//   accumulators.  The accumulator holds columns 2t and 2t + 1 of each
//   group of 8, the fragment wants t and t + 4, so the split pass writes
//   Vᵀ's keys permuted within each group of 8 (position j holds key 2j for
//   j < 4, key 2(j − 4) + 1 for j >= 4): position t is key 2t and position
//   t + 4 is key 2t + 1, the accumulator's own, and P needs no shuffle.
//   wgmma m64n64k8 over kN / 8 k-steps, three terms, 64 output columns at
//   a time, into a fresh accumulator a tile that one rounded fmaf adds to
//   O (O·alpha + tile).  The tensor cores' float32 accumulation does not
//   round to nearest, so its error grows with the additions into one
//   accumulator: over every key of a row (3·Tk / 8 of them) it nears the
//   1e-5 gate on long non-causal rows (tools/kernel_variants.py), over a
//   tile's 3·kN / 8 it stays small.
// Only tiles that cross the diagonal or Tk are masked; a tile wholly above
// a warpgroup's rows is not computed (the producer splits it for the
// other).  Rows past T load as zeros and are not stored, so any T works.
// K/V tiles of kN = 32 keys.  D = 64: two consumer warpgroups (setmaxnreg
// 56 / 224; ptxas allocates the consumers within the 168 registers of the
// 384-thread launch, where 64-key tiles spill).  D = 128: one consumer
// warpgroup (64 registers of Q_hi and 64 of O a thread leave no room for a
// second within 168).  Shared memory: raw stages, split slots and Q_lo,
// 176 KB at D = 64 (three and three) and 224 KB at D = 128 (two and two),
// one block an SM.  (192, 128), MLA: Q_hi in registers would be 96 a
// thread beside O's 64, a tile's P V and P, near the 255 a thread can
// have; so Q_hi, like Q_lo, is an A operand from shared memory (the S
// products are shared-memory wgmmas), and the consumer holds O, S, a
// tile's P V and P only.  Q_hi and Q_lo take 96 KB, a raw stage 40 KB
// (K 24, V 16) and a split slot 80 KB, so one of each fits (216 KB): the
// TMA of tile t + 1 overlaps the consumer's work on tile t, its split
// does not.  The split slots of K and Vᵀ are sized by D and Dv apart.
// (256, 256), paligemma-3b: Q_hi and Q_lo in shared memory as at (192,
// 128) (64 KB each), and K/V tiles of kN = 16 keys, one raw stage (32 KB)
// and one split slot (64 KB): 224 KB.  A row of Vᵀ is then 16 keys, half a
// 128-byte swizzled row, so Vᵀ rows d and d + 128 share one (kVtFold): the
// PV wgmma of output columns 64·h .. reads rows (64·h) % 128 from byte
// 64·(h / 2) of the row, in the same 128-byte swizzle as every operand.
// S is m64n16k8 (32 k-steps, three terms); the consumer holds O (128
// registers), S (8), a tile's P V (32) and P (16).
// The prefix-LM mask (prefix P > 0, causal, Tq == Tk): row r sees keys
// 0..max(r, P − 1).  A q tile visits the K/V tiles up to max(its last
// row, P − 1); a warpgroup skips a tile past max(its last row, P − 1) and
// masks one past max(its first row, P − 1) key by key.
// With a pointer for it (at D = Dv), a second instance of the kernel also
// writes each row's logsumexp in base 2, L = m·c + log₂(max(l, 1e-30)) with
// c = log₂e / √D, into float32 [B·H, T rounded up to 128] (the rows of its
// query tiles, past T too), so that the float32 backward need not compute
// it again (flash_attention_bwd_tf32.cu); without the pointer the first
// instance runs as before.
//
// The tensor maps are encoded on the host for each call through
// cuTensorMapEncodeTiled, found with cudaGetDriverEntryPoint, so the
// library links no libcuda.
#include <cuda.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

// Variants: 0 in the library; tools/kernel_variants.py builds the source
// with REPRO_VARIANT set to one of the cuts or changes below, to time what
// each part costs.
#ifndef REPRO_VARIANT
#define REPRO_VARIANT 0
#endif

namespace {

constexpr int kVariant = REPRO_VARIANT;
constexpr int kNoSplit = 1;         // the producer does not split the tiles
constexpr int kNoCompute = 2;       // consumers release each tile unread
constexpr int kNoPV = 3;            // S and the softmax, no PV
constexpr int kRing22 = 4;          // two raw stages and two split slots
constexpr int kOInTensorCores = 5;  // PV into one accumulator over a row's tiles

constexpr int kPanel = 32;       // float columns of one 128-byte swizzled panel
constexpr int kRowBytes = 128;   // bytes of one row of a panel
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D, int DV>
struct Cfg {
  static constexpr int kN = D == 256 ? 16 : 32;  // keys of a K/V tile
  static constexpr int kNC = D == 64 ? 2 : 1;    // consumer warpgroups
  static constexpr int kThreads = 128 * (1 + kNC);
  static constexpr int kBlockQ = 64 * kNC;       // query rows of a q tile
  static constexpr bool kQhiSmem = D >= 192;     // Q_hi from shared memory
  static constexpr int kTileK = kN * D * 4;      // bytes of one K tile
  static constexpr int kTileV = kN * DV * 4;     // bytes of one V or Vᵀ tile
  // Vᵀ [Dv x kN] in rows of 32 floats (one 128-byte swizzled row): at kN =
  // 16 row d % (Dv / 2) holds Vᵀ rows d and d + Dv / 2 side by side
  static constexpr int kVtFold = kPanel / kN;
  static constexpr int kVtRows = DV / kVtFold;
  // raw K/V stages (TMA) and split slots
  static constexpr int kRawStages = D == 64 && kVariant != kRing22 ? 3 : kQhiSmem ? 1 : 2;
  static constexpr int kSlots = kRawStages;
  static constexpr int kRawOff = 0;              // raw stage s: K, then V
  static constexpr int kRawBytes = kTileK + kTileV;
  static constexpr int kSplitOff = kRawStages * kRawBytes;  // slot s: K_hi K_lo Vᵀ_hi Vᵀ_lo
  static constexpr int kSlotBytes = 2 * (kTileK + kTileV);
  // Q_lo (and at D = 192 Q_hi) of each consumer's 64 rows (A operands from
  // shared memory)
  static constexpr int kQloOff = kSplitOff + kSlots * kSlotBytes;
  static constexpr int kQhiOff = kQloOff + kNC * 64 * D * 4;
  static constexpr int kBarOff = kQhiOff + (kQhiSmem ? kNC * 64 * D * 4 : 0);
  // barriers: raw_full, raw_empty, split_full, split_empty (2 each); then
  // slack to align the dynamic shared memory to 1024 bytes (the swizzle's
  // repeat)
  static constexpr size_t kBytes = kBarOff + 8 * 2 * (kRawStages + kSlots) + 1024;
  static_assert(kBytes <= 232448, "more shared memory than a block can have");
};

using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::smem_u32;

// One TMA box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled K-major operand (layout type 1):
// start address, leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers that an asynchronous wgmma reads or writes: the compiler
// may not move their uses across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][4]) {
#pragma unroll
  for (int a = 0; a < M; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[a][j])::"memory");
}

using repro::split_tf32;

// d[16] (+)= A[64 x 8] · B[8 x 32]: A tf32 in registers, B K-major in shared
// memory; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[32] (+)= A[64 x 8] · B[8 x 64]: A tf32 in registers, B K-major in shared
// memory; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[8] (+)= A[64 x 8] · B[8 x 16]: A and B tf32, K-major in shared memory;
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_ss_n16(float (&d)[8], uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[16] (+)= A[64 x 8] · B[8 x 32]: A and B tf32, K-major in shared memory;
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// S (+)= Q Kᵀ over one k-step, both operands from shared memory, for a
// K/V tile of N keys.
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                              int accumulate) {
  if constexpr (N == 16) {
    wgmma_tf32_ss_n16(d, da, db, accumulate);
  } else {
    wgmma_tf32_ss_n32(d, da, db, accumulate);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  if constexpr (N == 32) {
    wgmma_tf32_n32(d, a, db, accumulate);
  } else {
    wgmma_tf32_n64(d, a, db, accumulate);
  }
}

// Byte offset of element (row, col) of a tile stored as 128-byte swizzled
// panels of 32 float columns, `rows` rows a panel: the layout TMA writes
// and the wgmma descriptors read (16-byte chunk c of row r at c ^ (r % 8)).
__device__ __forceinline__ uint32_t swz(int row, int col, int rows) {
  return (col / kPanel) * rows * kRowBytes + row * kRowBytes +
         ((((col % kPanel) / 4) ^ (row & 7)) << 4) + (col & 3) * 4;
}

// K/V tiles that query tile qt (of kBlockQ rows) visits: all of them, or
// causally those up to the last key its last row sees (with a prefix of P
// rows, row r sees keys 0..max(r, P − 1)).
template <int D, int DV>
__device__ __forceinline__ int kv_tiles(int qt, int Tq, int Tk, int causal, int prefix) {
  using C = Cfg<D, DV>;
  const int n = (Tk + C::kN - 1) / C::kN;
  const int last = max(min((qt + 1) * C::kBlockQ, Tq) - 1, prefix - 1);
  return causal ? min(n, last / C::kN + 1) : n;
}

template <int D, int DV, bool kLse = false>
__global__ void __launch_bounds__(Cfg<D, DV>::kThreads, 1)
    flash_attention_tf32_kernel(const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap,
                                const float* __restrict__ q, float* __restrict__ o, int H,
                                int Hkv, int Tq, int Tk, float scale_log2, int causal,
                                int prefix, float* __restrict__ lse2, int Tpad) {
  // scale_log2 = log₂e / √D: P = exp2(s·scale_log2 − m·scale_log2)
  using C = Cfg<D, DV>;
  constexpr int kN = C::kN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + C::kBarOff;
  auto raw_full = [&](int s) { return bars + 8u * s; };
  auto raw_empty = [&](int s) { return bars + 8u * (C::kRawStages + s); };
  auto split_full = [&](int s) { return bars + 8u * (2 * C::kRawStages + s); };
  auto split_empty = [&](int s) { return bars + 8u * (2 * C::kRawStages + C::kSlots + s); };
  auto raw_k = [&](int s) { return base + C::kRawOff + s * C::kRawBytes; };
  auto split = [&](int s) { return base + C::kSplitOff + s * C::kSlotBytes; };

  const int n_qt = (Tq + C::kBlockQ - 1) / C::kBlockQ;
  const int qt_heavy = n_qt - 1 - blockIdx.x;
  const int qt_light = blockIdx.x;
  const int n_pass = qt_light < qt_heavy ? 2 : 1;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = b * Hkv + h / (H / Hkv);
  const int n0 = kv_tiles<D, DV>(qt_heavy, Tq, Tk, causal, prefix);
  const int n_total =
      n0 + (n_pass == 2 ? kv_tiles<D, DV>(qt_light, Tq, Tk, causal, prefix) : 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kRawStages; ++s) {
      mbar_init(raw_full(s), 1);
      mbar_init(raw_empty(s), 128);  // every producer thread, after its split
    }
    for (int s = 0; s < C::kSlots; ++s) {
      mbar_init(split_full(s), 128);
      mbar_init(split_empty(s), C::kNC * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: TMA of raw K/V tiles, then the split into hi/lo slots
    if constexpr (C::kNC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int p = threadIdx.x;
    const CUtensorMap* kp = &kmap;
    const CUtensorMap* vp = &vmap;
    // key tile of the it-th tile of the block (over both passes)
    auto key_tile = [&](int it) { return it < n0 ? it : it - n0; };
    auto issue = [&](int it) {
      const int s = it % C::kRawStages;
      mbar_wait(raw_empty(s), ((it / C::kRawStages) & 1) ^ 1);
      mbar_expect_tx(raw_full(s), C::kRawBytes);
      for (int pn = 0; pn < D / kPanel; ++pn)
        tma_load_3d(raw_k(s) + pn * kN * kRowBytes, kp, raw_full(s), pn * kPanel,
                    key_tile(it) * kN, kvh);
      for (int pn = 0; pn < DV / kPanel; ++pn)
        tma_load_3d(raw_k(s) + C::kTileK + pn * kN * kRowBytes, vp, raw_full(s),
                    pn * kPanel, key_tile(it) * kN, kvh);
    };
    if (p == 0) {
      for (int it = 0; it < C::kRawStages && it < n_total; ++it) issue(it);
    }
    for (int it = 0; it < n_total; ++it) {
      const int s = it % C::kRawStages, slot = it % C::kSlots;
      mbar_wait(raw_full(s), (it / C::kRawStages) & 1);
      mbar_wait(split_empty(slot), ((it / C::kSlots) & 1) ^ 1);
      const unsigned char* rk = smem_raw + (raw_k(s) - smem_u32(smem_raw));
      const unsigned char* rv = rk + C::kTileK;
      unsigned char* sp = smem_raw + (split(slot) - smem_u32(smem_raw));
      // K: hi and lo in K's own layout, a float4 at a time
      for (int e = p; kVariant != kNoSplit && e < C::kTileK / 16; e += 128) {
        const float4 v = reinterpret_cast<const float4*>(rk)[e];
        uint4 hi, lo;
        split_tf32(v.x, hi.x, lo.x);
        split_tf32(v.y, hi.y, lo.y);
        split_tf32(v.z, hi.z, lo.z);
        split_tf32(v.w, hi.w, lo.w);
        reinterpret_cast<uint4*>(sp)[e] = hi;
        reinterpret_cast<uint4*>(sp + C::kTileK)[e] = lo;
      }
      // Vᵀ [Dv x kN]: chunk (d, positions 4jq .. 4jq + 3) holds keys
      // 8g + (4jq % 8) / 4 + 2i (the permuted order); a warp takes 32
      // consecutive d of one chunk column, so neither its reads nor its
      // writes conflict
      for (int e = p; kVariant != kNoSplit && e < C::kTileV / 16; e += 128) {
        const int d = e % DV, jq = e / DV;
        const int key0 = 8 * (jq / 2) + (jq & 1);
        uint4 hi, lo;
        split_tf32(*reinterpret_cast<const float*>(rv + swz(key0, d, kN)), hi.x, lo.x);
        split_tf32(*reinterpret_cast<const float*>(rv + swz(key0 + 2, d, kN)), hi.y, lo.y);
        split_tf32(*reinterpret_cast<const float*>(rv + swz(key0 + 4, d, kN)), hi.z, lo.z);
        split_tf32(*reinterpret_cast<const float*>(rv + swz(key0 + 6, d, kN)), hi.w, lo.w);
        const uint32_t off = swz(d % C::kVtRows, kN * (d / C::kVtRows) + 4 * jq, C::kVtRows);
        *reinterpret_cast<uint4*>(sp + 2 * C::kTileK + off) = hi;
        *reinterpret_cast<uint4*>(sp + 2 * C::kTileK + C::kTileV + off) = lo;
      }
      // the split is written by the generic proxy and read by wgmma (the
      // async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(raw_empty(s));
      mbar_arrive(split_full(slot));
      if (p == 0 && it + C::kRawStages < n_total) issue(it + C::kRawStages);
    }
  } else {
    if constexpr (C::kNC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int cw = threadIdx.x / 128 - 1;  // consumer: query rows 64·cw ..
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int t4 = lane % 4;
    const int c2 = 2 * t4;  // first column of each 8-column group
    // Accumulator layout (m64nN, float32): element i of a thread lies in
    // row r0 + 8·((i >> 1) & 1), column 8·(i / 4) + c2 + (i & 1).
    float acc[DV / 2], sc[kN / 2], tile[32];
    uint32_t qh[C::kQhiSmem ? 1 : D / 8][4];  // Q_hi fragments (in registers)
    const uint32_t qlo = base + C::kQloOff + cw * 64 * D * 4;  // Q_lo [64 x D], swizzled
    const uint32_t qhi = base + C::kQhiOff + cw * 64 * D * 4;  // Q_hi there at D = 192
    int it = 0;  // tiles consumed so far, over both passes

    for (int pass = 0; pass < n_pass; ++pass) {
      const int qt = pass == 0 ? qt_heavy : qt_light;
      const int q0 = qt * C::kBlockQ + 64 * cw;  // this warpgroup's first row
      const int n_tiles = kv_tiles<D, DV>(qt, Tq, Tk, causal, prefix);
      // the last key this warpgroup's first and last rows see
      const int seen_lo = max(q0, prefix - 1), seen_hi = max(q0 + 63, prefix - 1);
      const int r0 = q0 + 16 * warp + lane / 4;  // rows r0 and r0 + 8
      // every wgmma of the last pass has read Q_lo (a barrier of this
      // warpgroup's 128 threads)
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
      // Q_hi and Q_lo fragments: k-step kk holds (r0, 8kk + t4),
      // (r0 + 8, 8kk + t4), (r0, 8kk + t4 + 4), (r0 + 8, 8kk + t4 + 4)
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = r0 + 8 * (j & 1);
          const int col = 8 * kk + t4 + 4 * (j >> 1);
          const float v =
              row < Tq ? __ldg(q + (static_cast<long long>(bh) * Tq + row) * D + col) : 0.f;
          uint32_t hi, lo;
          split_tf32(v, hi, lo);
          const uint32_t at = swz(row - q0, col, 64);
          *reinterpret_cast<uint32_t*>(smem_raw + (qlo - smem_u32(smem_raw)) + at) = lo;
          if constexpr (C::kQhiSmem) {
            *reinterpret_cast<uint32_t*>(smem_raw + (qhi - smem_u32(smem_raw)) + at) = hi;
          } else {
            qh[kk][j] = hi;
          }
        }
      }
      // Q_lo (Q_hi) is written by the generic proxy and read by wgmma
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
      if (kVariant == kOInTensorCores)
        for (int i = 0; i < 32; ++i) tile[i] = 0.f;
      float m[2] = {kNegInf, kNegInf};
      float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

      for (int t = 0; t < n_tiles; ++t, ++it) {
        const int slot = it % C::kSlots;
        const int k0 = t * kN;
        mbar_wait(split_full(slot), (it / C::kSlots) & 1);
        if (kVariant == kNoCompute || (causal && k0 > seen_hi)) {  // wholly above its rows
          mbar_arrive(split_empty(slot));
          continue;
        }
        const uint32_t khi = split(slot), klo = khi + C::kTileK;
        const uint32_t vhi = khi + 2 * C::kTileK, vlo = vhi + C::kTileV;

        // S = Q Kᵀ: D / 8 k-steps of 8 columns (32 bytes) along each panel,
        // Q_lo·K_hi and Q_hi·K_lo first, then Q_hi·K_hi
        fence_regs(sc);
        if constexpr (!C::kQhiSmem) fence_regs(qh);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          const uint32_t off = (kk / 4) * kN * kRowBytes + (kk % 4) * 32;
          const uint32_t qoff = (kk / 4) * 64 * kRowBytes + (kk % 4) * 32;
          wgmma_tf32_ss<kN>(sc, smem_desc(qlo + qoff), smem_desc(khi + off), kk > 0);
          if constexpr (C::kQhiSmem) {
            wgmma_tf32_ss<kN>(sc, smem_desc(qhi + qoff), smem_desc(klo + off), 1);
          } else {
            wgmma_tf32<kN>(sc, qh[kk], smem_desc(klo + off), 1);
          }
        }
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          const uint32_t off = (kk / 4) * kN * kRowBytes + (kk % 4) * 32;
          if constexpr (C::kQhiSmem) {
            wgmma_tf32_ss<kN>(sc, smem_desc(qhi + (kk / 4) * 64 * kRowBytes + (kk % 4) * 32),
                              smem_desc(khi + off), 1);
          } else {
            wgmma_tf32<kN>(sc, qh[kk], smem_desc(khi + off), 1);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // online softmax over the tile; masked scores are -1e30
        if (k0 + kN > Tk || (causal && k0 + kN - 1 > seen_lo)) {
#pragma unroll
          for (int i = 0; i < kN / 2; ++i) {
            const int key = k0 + 8 * (i / 4) + c2 + (i & 1);
            const int row = r0 + 8 * ((i >> 1) & 1);
            if (key >= Tk || (causal && key > max(row, prefix - 1))) sc[i] = kNegInf;
          }
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < kN / 2; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        float alpha[2], mc[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = exp2f((m[r] - mx[r]) * scale_log2);
          m[r] = mx[r];
          mc[r] = mx[r] * scale_log2;
          l[r] *= alpha[r];
        }

        // P_hi and P_lo, already in PV's register-A layout: k-step g takes
        // accumulator elements 4g, 4g + 2, 4g + 1, 4g + 3 (rows r0, r0 + 8
        // at Vᵀ positions t4 and t4 + 4, keys 2·t4 and 2·t4 + 1)
        uint32_t ph[kN / 8][4], pl[kN / 8][4];
#pragma unroll
        for (int g = 0; g < kN / 8; ++g) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = 4 * g + ((j & 1) << 1) + (j >> 1);
            const float pv = exp2f(fmaf(sc[i], scale_log2, -mc[(i >> 1) & 1]));
            l[(i >> 1) & 1] += pv;
            split_tf32(pv, ph[g][j], pl[g][j]);
          }
        }
        if (kVariant == kNoPV) {  // keep P: fold it into O
          for (int g = 0; g < kN / 8; ++g)
            for (int j = 0; j < 4; ++j) acc[0] += __uint_as_float(ph[g][j] ^ pl[g][j]);
        }

        // O = O·alpha + P V, 64 output columns at a time: the tile's P V
        // into a fresh accumulator over kN / 8 k-steps of 8 keys (P_lo·V_hi
        // and P_hi·V_lo first, then P_hi·V_hi), then one rounded fmaf into
        // O.  The tensor cores' float32 accumulation then runs over one
        // tile's 3·kN / 8 products, not over every key of the row.
#pragma unroll
        for (int half = 0; half < (kVariant == kNoPV ? 0 : DV / 64); ++half) {
          // Vᵀ rows 64·half .. (at kN = 16 folded: C::kVtRows)
          const uint32_t hoff = ((64 * half) % C::kVtRows) * kRowBytes +
                                kN * 4 * ((64 * half) / C::kVtRows);
          if (kVariant == kOInTensorCores)
            for (int i = 0; i < 32; ++i) tile[i] *= alpha[(i >> 1) & 1];
          fence_regs(tile);
          fence_regs(ph);
          fence_regs(pl);
          wgmma_fence();
#pragma unroll
          for (int g = 0; g < kN / 8; ++g) {
            const uint32_t off = hoff + (g / 4) * C::kVtRows * kRowBytes + (g % 4) * 32;
            wgmma_tf32<64>(tile, pl[g], smem_desc(vhi + off),
                           kVariant == kOInTensorCores || g > 0);
            wgmma_tf32<64>(tile, ph[g], smem_desc(vlo + off), 1);
          }
#pragma unroll
          for (int g = 0; g < kN / 8; ++g) {
            const uint32_t off = hoff + (g / 4) * C::kVtRows * kRowBytes + (g % 4) * 32;
            wgmma_tf32<64>(tile, ph[g], smem_desc(vhi + off), 1);
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(tile);
#pragma unroll
          for (int i = 0; i < 32; ++i)
            acc[32 * half + i] = kVariant == kOInTensorCores
                                     ? tile[i]
                                     : fmaf(acc[32 * half + i], alpha[(i >> 1) & 1], tile[i]);
        }
        mbar_arrive(split_empty(slot));
      }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = fmaxf(l[r], 1e-30f);
      }
      if constexpr (kLse) {  // every row of the tile: [B·H, Tpad]
        if (lane % 4 == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            lse2[static_cast<long long>(bh) * Tpad + r0 + 8 * r] =
                m[r] * scale_log2 + log2f(l[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row < Tq) {
          float* orow = o + (static_cast<long long>(bh) * Tq + row) * DV;
#pragma unroll
          for (int g = 0; g < DV / 8; ++g) {
            *reinterpret_cast<float2*>(orow + 8 * g + c2) =
                make_float2(acc[4 * g + 2 * r] / l[r], acc[4 * g + 2 * r + 1] / l[r]);
          }
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda (looked up at run time), or null.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The float32 tensor [n, rows, D] at ptr as a 3-D TMA map (D, rows, n) with
// 32 x box_rows boxes, 128-byte swizzle and zero fill past the edges.
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int D, int rows,
              int n, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 4,
                                 static_cast<cuuint64_t>(rows) * D * 4};
  const cuuint32_t box[3] = {kPanel, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int DV, bool kLse = false>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* lse2,
                   int B, int H, int Hkv, int Tq, int Tk, int causal, int prefix,
                   cudaStream_t stream) {
  using C = Cfg<D, DV>;
  auto kernel = flash_attention_tf32_kernel<D, DV, kLse>;
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = repro::allow_smem(kernel, C::kBytes);
    if (err != cudaSuccess) return err;
    allowed = true;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap kmap, vmap;
  if (!make_map(&kmap, encode, k, D, Tk, B * Hkv, C::kN) ||
      !make_map(&vmap, encode, v, DV, Tk, B * Hkv, C::kN))
    return cudaErrorInvalidValue;
  // the reference's 1.0 / (D ** 0.5), a double rounded to float, in log₂ units
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const dim3 grid(((Tq + C::kBlockQ - 1) / C::kBlockQ + 1) / 2, B * H);  // two q tiles a block
  // L's rows: Tq rounded up to 128, as the backward's scratch
  const int Tpad = (Tq + 127) / 128 * 128;
  kernel<<<grid, C::kThreads, C::kBytes, stream>>>(kmap, vmap, q, o, H, Hkv, Tq, Tk,
                                                   scale * kLog2e, causal, prefix, lse2, Tpad);
  return cudaGetLastError();
}

}  // namespace

// o [B, H, Tq, Dv] = attention of q [B, H, Tq, D] over k [B, Hkv, Tk, D]
// and v [B, Hkv, Tk, Dv], all contiguous float32 (k and v 16-byte aligned),
// (D, Dv) ∈ {(64, 64), (128, 128), (192, 128), (256, 256)}; causal: query i
// sees keys 0..i (Tq == Tk), and with prefix P > 0 (causal only) keys
// 0..max(i, P − 1), the prefix-LM mask.  With no keys (Tk == 0) the output
// is zero, as 0 / 1e-30.
// lse2, null or (at D = Dv with Tk > 0 only) float32 [B·H,
// Tq rounded up to 128], receives each row's logsumexp in base 2 (the rows
// of the query tiles, so every row the backward reads).
extern "C" int repro_flash_attention_tf32(const float* q, const float* k, const float* v,
                                          float* o, float* lse2, int B, int H, int Hkv,
                                          int Tq, int Tk, int D, int Dv, int causal,
                                          int prefix, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Tq <= 0 || Tk < 0 ||
      (lse2 != nullptr && (D != Dv || Tk == 0)) || prefix < 0 || prefix > Tq ||
      (prefix > 0 && (!causal || Tq != Tk)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Tk == 0) {
    cudaMemsetAsync(o, 0, static_cast<size_t>(B) * H * Tq * Dv * 4, stream);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err;
  if (D == 64 && Dv == 64 && lse2 != nullptr) {
    err = launch<64, 64, true>(q, k, v, o, lse2, B, H, Hkv, Tq, Tk, causal, prefix, stream);
  } else if (D == 64 && Dv == 64) {
    err = launch<64, 64>(q, k, v, o, nullptr, B, H, Hkv, Tq, Tk, causal, prefix, stream);
  } else if (D == 128 && Dv == 128 && lse2 != nullptr) {
    err = launch<128, 128, true>(q, k, v, o, lse2, B, H, Hkv, Tq, Tk, causal, prefix, stream);
  } else if (D == 128 && Dv == 128) {
    err = launch<128, 128>(q, k, v, o, nullptr, B, H, Hkv, Tq, Tk, causal, prefix, stream);
  } else if (D == 192 && Dv == 128) {
    err = launch<192, 128>(q, k, v, o, nullptr, B, H, Hkv, Tq, Tk, causal, prefix, stream);
  } else if (D == 256 && Dv == 256 && lse2 != nullptr) {
    err = launch<256, 256, true>(q, k, v, o, lse2, B, H, Hkv, Tq, Tk, causal, prefix, stream);
  } else if (D == 256 && Dv == 256) {
    err = launch<256, 256>(q, k, v, o, nullptr, B, H, Hkv, Tq, Tk, causal, prefix, stream);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

REPRO_DEFINE_ERROR_STRING(repro_flash_attention_tf32)
