// The gradient of causal (or full, or prefix-LM) flash attention on
// Hopper's TF32 tensor cores: dQ, dK and dV of o = softmax(q kᵀ / √D) v for
// q [B, H, T, D], k [B, Hkv, Tk, D], v [B, Hkv, Tk, Dv] and o, dO [B, H, T,
// Dv] in float32, (D, Dv) ∈ {(64, 64), (128, 128), (192, 128), (256, 256)}:
// (192, 128) is deepseek-v3-671b's MLA, (256, 256) paligemma-3b's.  The
// prefix-LM mask (prefix P > 0) enters as in flash_attention_bwd_wgmma.cu:
// the dq key walk to max(last row, P − 1), every query tile for a key tile
// below P.
//
// Replaces: no Pallas kernel.  The reference trains by jax.grad through
// flash_attention_jnp (src/repro/models/attention.py:76); the Pallas
// forward has no custom_vjp.  This is the float32 route of
// repro_torch.kernels.flash_attention.flash_attention_bwd at the head dims
// of every dense config the port trains, the backward of
// flash_attention_tf32.cu; bf16 at those pairs takes
// flash_attention_bwd_wgmma.cu, D ≤ 32 and (16, 8) flash_attention_bwd.cu's
// SIMT kernels.  It computes that SIMT
// file's function in float32: scores scaled by 1/√D (a double rounded to
// float) and masked at -1e30, the denominator floored at 1e-30, P and dS
// never rounded to a narrower type, GQA by index (dK and dV sum over the G
// query heads of their group), any T.  Its plain version is
// ref.flash_attention_bwd_ref.
//
// Float32 accuracy from TF32 tensor cores, as flash_attention_tf32.cu: each
// of the five products (S = Q Kᵀ, dP = dO Vᵀ, dV = Pᵀ dO, dQ = dS K,
// dK = dSᵀ Q) is taken as three TF32 terms, a_lo·b_hi + a_hi·b_lo first, then
// a_hi·b_hi, with x_hi = cvt.rna.tf32(x) and x_lo = cvt.rna.tf32(x − x_hi)
// for every operand, P and dS included (tests/test_torch_flash_bwd_tf32.py
// emulates the arithmetic; one term misses the 1e-5 gate).  The tensor
// cores' float32 accumulation does not round to nearest, so its error grows
// with the k-steps added into one accumulator: dQ sums over every key and
// dK, dV over every query of the G heads, so each tile's product goes into
// a fresh accumulator and one rounded add puts it into the float32 sum.
//
// Bound: operations.  Five T×T×D products of the causal half: at
// llama3.2-1b's microbatch (B 4, H 32, T 1024, D 64) 43 GFLOP, 0.0869 ms as
// one TF32 term at 495 TFLOP/s, 0.261 ms as three.  Given the forward's L
// (flash_attention_tf32.cu, the kLseIn instances, as autograd runs them)
// these kernels do seven (S and dP twice: once in each kernel), nine at
// D = 128 where both of a dkdv block's warpgroups compute Sᵀ and dPᵀ;
// without L one more, the dq kernel's pass for L.  At (192, 128) the
// causal half's five products (three at D, two at Dv) at deepseek-v3-671b's
// shape (B 1, H 128, T 1024) are 111.7 GFLOP: 0.226 ms as one TF32 term,
// 0.677 ms as three; the kernels do S four times (both dkdv parts) and dP
// twice.
//
// Design: flash_attention_bwd_wgmma.cu's two kernels, launched in order on
// the caller's stream by one C entry, with the TF32 forward's producer.
// .tf32 wgmma reads both operands K-major (there is no transpose bit for
// 32-bit types), so every product whose contracted index is a row of a
// loaded tile reads a transposed copy that the producer writes:
// - Warpgroup 0 is the producer.  One thread issues TMA loads of float32
//   tiles (3-D tensor maps (D, rows, B·heads), zero-filled past a head's last
//   row, 128-byte swizzled panels of 32 floats) straight into a slot of a
//   ring; when a tile lands, its 128 threads write the transposed copies
//   (hi and lo, [D rows x 32 positions], the rows of the tile contiguous)
//   from the raw tile, then split the tile in place into its hi copy and a
//   lo copy beside it.  The transposed copies permute the tile's rows within
//   each group of 8 (position j holds row 2j for j < 4, row 2(j − 4) + 1 for
//   j >= 4): an accumulator holds columns 2t and 2t + 1 of each group of 8
//   where a tf32 A fragment wants t and t + 4, so with that order the S
//   (or Sᵀ) accumulator's registers are the A fragments of dS (or Pᵀ and
//   dSᵀ), with no shuffle.
// - flash_bwd_dq_tf32_kernel, a block per (b·H + h, tile of kRows query
//   rows), heaviest causal tiles first.  Q and dO stay resident, split
//   once into hi and lo; K and V stream in tiles of 32 keys (16 at (192,
//   128), whose transposed copies are rows of 64 bytes: DqCfg).  Δ = rowsum(dO
//   ∘ O) from global memory while Q and dO land; pass 1 computes S over
//   the key tiles for the row maximum and sum, so L (base 2); pass 2
//   computes S and dP, then P = exp2(S·c − L) and dS = P ∘ (dP − Δ) in
//   registers, and dQ += dS K (Kᵀ the transposed copy), 64 output columns
//   at a time.  It writes L and Δ to float32 scratch [B·H, T rounded up to
//   128] (rows past T too: finite, and met only by zero rows of Q and dO).
//   At D = Dv, given the forward's L in that scratch (the kLseIn
//   instances; at (256, 256) too, from the TF32 forward's <256, 256, true>),
//   pass 1 and its K loads are left out and only Δ is written
//   (a row past T reads 0 for L: the forward writes the rows of its own
//   query tiles, which at D = 128 may stop short of the scratch's end).
// - flash_bwd_dkdv_tf32_kernel (D = Dv), a block per (b·Hkv + kvh, tile of
//   64 keys), the key tiles that see the most queries first.  K and V stay
//   resident,
//   split once; Q, dO and the tile's L and Δ (a bulk copy each) stream in
//   tiles of kQ queries for each of the G query heads of the group (causally
//   only the tiles at or below the keys).  It works transposed: Sᵀ = K Qᵀ and
//   dPᵀ = V dOᵀ, Pᵀ = exp2(Sᵀ·c − L) and dSᵀ = Pᵀ ∘ (dPᵀ − Δ), then
//   dV += Pᵀ dO and dK += dSᵀ Q against the transposed copies dOᵀ and Qᵀ.
// Shared memory (float32 hi/lo copies are four times bf16's bytes) and
// registers (a fresh tile accumulator beside each sum; ptxas fits a
// 384-thread block's consumers in 168 registers whatever setmaxnreg grants)
// set the shapes (DqCfg, DkvCfg; at (192, 128) the dq kernel's 16-key
// tiles and flash_bwd_dkdv_tf32_mla_kernel, whose blocks take dK or dV:
// MlaKvCfg).  At (192, 128) one slot is all that fits beside the resident
// copies (the dq kernel's second pass, the dK blocks), so the producer's
// copies, not the products, set the time; there: the dq kernel's first
// pass alternates two K buffers in the slot, the dV blocks have a layout
// of their own with two slots, a single slot is released in two phases
// (the split natural tiles once the products that read them are done, the
// transposed copies, made from the split tiles, once theirs are), and a
// producer thread loads all of its share of a tile before it stores any
// copy (split_tile, transpose_tile), so those loads are in flight together.
// (A second producer warpgroup and copies a chunk at a time measured no
// faster; a 384-thread block leaves each thread 168 registers, which the
// dq kernel's consumer, with dQ's 96, does not fit.)  Every output element
// is one warpgroup's sum in a fixed order, or two warpgroups' sums added
// once: no atomics, so two calls on the same inputs are bitwise equal.  A
// head's tiles on blockIdx.x (the kHeadMajorCut variant) measured slower
// at D 64 and 128, both kernels (tools/kernel_variants.py bwd_d64_d128,
// PERF.md).
//
// The tensor maps are encoded on the host for each call through
// cuTensorMapEncodeTiled, found with cudaGetDriverEntryPoint, so the
// library links no libcuda.
#include <cuda.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

// Variants: 0 in the library; tools/kernel_variants.py builds the source
// with REPRO_VARIANT set to one of the cuts below, to time what each part of
// the kernels costs (every instance; kDkOnly and kDvOnly at (192, 128)).
#ifndef REPRO_VARIANT
#define REPRO_VARIANT 0
#endif

namespace {

constexpr int kVariant = REPRO_VARIANT;
constexpr int kNoSplit = 1;     // the producer writes no copies (tiles as landed)
constexpr int kNoCompute = 2;   // consumers release each tile unread
constexpr int kDqPass1 = 3;     // the dq kernel's first pass alone
constexpr int kDkOnly = 4;      // the dkdv kernel's dK blocks alone
constexpr int kDvOnly = 5;      // the dkdv kernel's dV blocks alone
constexpr int kHeadMajorCut = 6;  // D 64/128: a head's tiles on blockIdx.x in both grids

constexpr int kPanel = 32;      // float columns of one 128-byte swizzled panel
constexpr int kRowBytes = 128;  // bytes of one row of a panel
constexpr int kPadRows = 128;   // the L/Δ scratch rounds T up to a multiple of this
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// dq: Q and dO resident as hi and lo copies; a ring of slots, each a K and
// a V tile of kN keys with K_lo, Kᵀ_hi, Kᵀ_lo and V_lo beside them.  D = 64:
// two consumer warpgroups of 64 rows and two slots; D = 128: one consumer
// warpgroup (the dQ sum takes 64 registers a thread) and one slot.  Either
// is 224 KB of the 227 a block may have.  (192, 128): one consumer
// warpgroup and one slot; Q_hi, Q_lo (48 KB each), dO_hi and dO_lo (32 KB
// each) take 160 KB, so a slot has 66 KB: tiles of 16 keys (K_hi, K_lo 12
// KB each, V_hi, V_lo 8 each), whose transposed copies are rows of 16
// positions, 64 bytes, in the 64-byte swizzle (12 KB each, where rows of
// 128 bytes half used would take 24): 64 KB a slot, 225 KB in all.  The
// first pass reads K_hi and K_lo alone (24 KB a tile), so there the slot
// holds two such buffers, each with barriers of its own (kBufs), and the
// producer splits one tile while the consumer takes the other.  In the
// second pass the slot is released in two phases: K and V (split in place,
// buffer 0's barriers) once S and dP are taken, so the next tile lands and
// is split while dS and dQ run; Kᵀ (copied from the split K, buffer 1's
// barriers) once dQ is taken, so it is written while S and dP run.
template <int D, int DV>
struct DqCfg {
  static constexpr int kNC = D == 64 ? 2 : 1;      // consumer warpgroups
  static constexpr int kThreads = 128 * (1 + kNC);
  static constexpr int kRows = 64 * kNC;           // query rows of a block
  static constexpr int kN = D == DV ? 32 : 16;     // keys of a K/V tile
  static constexpr int kTrRow = kN * 4;            // bytes of a transposed row
  static constexpr int kSlots = D == 64 ? 2 : 1;
  static constexpr int kBufs = D == DV ? kSlots : 2;  // barrier sets: slots, or pass 1's buffers
  static constexpr int kBigQ = kRows * D * 4;      // one resident Q copy
  static constexpr int kBigV = kRows * DV * 4;     // one resident dO copy
  static constexpr int kTile = kN * D * 4;         // one K or Kᵀ copy
  static constexpr int kTileV = kN * DV * 4;       // one V copy
  // a slot: K_hi (TMA lands K here), K_lo, Kᵀ_hi, Kᵀ_lo, V_hi (V lands), V_lo
  static constexpr int kKhi = 0, kKlo = kTile, kKThi = 2 * kTile, kKTlo = 3 * kTile;
  static constexpr int kVhi = 4 * kTile, kVlo = 4 * kTile + kTileV;
  static constexpr int kSlotBytes = 4 * kTile + 2 * kTileV;
  // after Q_hi, Q_lo, dO_hi, dO_lo
  static constexpr int kDoOff = 2 * kBigQ;
  static constexpr int kSlotOff = 2 * kBigQ + 2 * kBigV;
  static constexpr int kBarOff = kSlotOff + kSlots * kSlotBytes;
  // barriers: resident landed, resident split, then land, full and empty of
  // each slot (of each buffer); slack to align the dynamic shared memory to
  // 1024 bytes
  static constexpr size_t kBytes = kBarOff + 8 * (2 + 3 * kBufs) + 1024;
  static_assert(kBytes <= 232448, "more shared memory than a block can have");
};

// dkdv: K and V of 64 keys resident as hi and lo copies; a ring of slots,
// each a Q and a dO tile of kQ queries (natural hi and lo, transposed hi and
// lo) with the tile's L and Δ.  D = 64: the two consumer warpgroups take
// alternate query tiles, each a slot of its own, for all 64 keys and
// columns, and their sums are added once at the end (a warpgroup that held
// the dK and dV of 128 keys would not fit: 224 KB beside two slots).
// D = 128: dK and dV of 64 keys and 128 columns take 128 registers a
// thread, so both warpgroups take every tile, each the dK and dV of one
// 64-column half (Sᵀ and dPᵀ computed by both, as flash_attention_bwd_wgmma.cu
// does), with one slot of 16-query tiles whose transposed copies keep the
// 32-position rows of the 128-byte swizzle half used.
template <int D>
struct DkvCfg {
  static constexpr bool kSplit = D == 128;         // columns split, every tile by both
  static constexpr int kKeys = 64;
  static constexpr int kQ = D == 64 ? 32 : 16;     // queries of a tile
  static constexpr int kSlots = kSplit ? 1 : 2;
  static constexpr int kThreads = 384;
  static constexpr int kBig = kKeys * D * 4;       // one resident copy
  static constexpr int kNat = kQ * D * 4;          // one natural Q or dO copy
  static constexpr int kTr = D * kPanel * 4;       // one transposed copy
  // a slot: Q_hi (TMA lands Q here), Q_lo, dO_hi (dO lands), dO_lo, Qᵀ_hi,
  // Qᵀ_lo, dOᵀ_hi, dOᵀ_lo, then L and Δ of the tile's queries
  static constexpr int kQhi = 0, kQlo = kNat, kDOhi = 2 * kNat, kDOlo = 3 * kNat;
  static constexpr int kQThi = 4 * kNat, kQTlo = kQThi + kTr;
  static constexpr int kDOThi = kQThi + 2 * kTr, kDOTlo = kQThi + 3 * kTr;
  static constexpr int kStat = kQThi + 4 * kTr;
  static constexpr int kSlotBytes = (kStat + 2 * kQ * 4 + 1023) / 1024 * 1024;
  static constexpr int kSlotOff = 4 * kBig;        // after K_hi, K_lo, V_hi, V_lo
  static constexpr int kBarOff = kSlotOff + kSlots * kSlotBytes;
  static constexpr size_t kBytes = kBarOff + 8 * (2 + 3 * kSlots) + 1024;
  static constexpr int kEmptyCount = kSplit ? 256 : 128;  // consumers reading a slot
  static constexpr uint32_t kStageTx = 2 * kNat + 2 * kQ * 4;
};

// dkdv at MLA's (192, 128): K and V of 64 keys resident as hi and lo
// copies take 160 KB, so a block has 66 KB beside them, and a slot of
// 16-query tiles with both transposed copies needs 80 (Q and dO natural hi
// and lo 40, Qᵀ and dOᵀ hi and lo 40 in 64-byte rows).  So the work is cut
// in two parts, blockIdx.z, each with a layout of its own (kDk):
// - part 0 takes dK (Sᵀ, dPᵀ, dSᵀ, then dSᵀ Q against Qᵀ): K and V
//   resident, one slot of Q and dO hi and lo and Qᵀ (65 KB, 226 in all),
//   released in two phases: Q, dO, L and Δ (split in place) once dSᵀ is
//   made, so the next tile lands and is split while dK is taken; Qᵀ
//   (copied from the split Q; barriers tr_full, tr_empty) once dK is taken,
//   so it is written while Sᵀ and dPᵀ are;
// - part 1 takes dV (Sᵀ, Pᵀ, then Pᵀ dO against dOᵀ): K resident (96 KB),
//   V not loaded and dO not split (it lands raw and is only transposed), so
//   a slot is 49 KB and two fit (194 KB in all): the producer splits the
//   next tile while the consumer takes this one.
// Each block is a producer and one consumer warpgroup, which holds its
// part's sums whole (dK 96 registers a thread, dV 64) beside a tile's
// product (32), Sᵀ and dPᵀ (16) and a fragment pair (16): within the 255 a
// thread of a 256-thread block may have, where two consumer warpgroups
// would have 168.
template <int D, int DV, bool kDk>
struct MlaKvCfg {
  static constexpr int kThreads = 256;
  static constexpr int kKeys = 64;
  static constexpr int kQ = 16;                     // queries of a tile
  static constexpr int kTrRow = kQ * 4;             // bytes of a transposed row
  static constexpr int kBigK = kKeys * D * 4;       // one resident K copy
  static constexpr int kBigV = kDk ? kKeys * DV * 4 : 0;  // one resident V copy
  static constexpr int kNatQ = kQ * D * 4;          // one natural Q copy
  static constexpr int kNatDo = kQ * DV * 4;        // one natural dO copy
  static constexpr int kTr = (kDk ? D : DV) * kTrRow;  // one transposed copy, Qᵀ or dOᵀ
  static constexpr int kSlots = kDk ? 1 : 2;
  // resident: K_hi, K_lo (, V_hi, V_lo); a slot: Q_hi (TMA lands Q here),
  // Q_lo, dO_hi (dO lands; part 1 keeps it raw), (dO_lo,) Tᵀ_hi, Tᵀ_lo (Qᵀ
  // in part 0, dOᵀ in part 1), then L and Δ of the tile's queries
  static constexpr int kVhi = 2 * kBigK, kVlo = 2 * kBigK + kBigV;
  static constexpr int kQhi = 0, kQlo = kNatQ, kDOhi = 2 * kNatQ, kDOlo = 2 * kNatQ + kNatDo;
  static constexpr int kThi = 2 * kNatQ + (kDk ? 2 : 1) * kNatDo, kTlo = kThi + kTr;
  static constexpr int kStat = kThi + 2 * kTr;
  static constexpr int kSlotBytes = (kStat + 2 * kQ * 4 + 1023) / 1024 * 1024;
  static constexpr int kSlotOff = 2 * (kBigK + kBigV);
  static constexpr int kBarOff = kSlotOff + kSlots * kSlotBytes;
  // barriers: resident landed, resident split, then land, full and empty of
  // each slot, then tr_full and tr_empty (part 0); slack to align the
  // dynamic shared memory to 1024 bytes
  static constexpr size_t kBytes = kBarOff + 8 * (4 + 3 * kSlots) + 1024;
  static constexpr uint32_t kStageTx = kNatQ + kNatDo + 2 * kQ * 4;
  static_assert(kBytes <= 232448, "more shared memory than a block can have");
};

// A compile-time int, to hand a generic lambda its template argument
template <int N>
struct Int {
  static constexpr int value = N;
};

using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::smem_u32;
using repro::split_tf32;

// One TMA box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, 16-byte aligned ends) into
// shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled K-major operand (layout type 1):
// start address, leading (16) and stride (1024) byte offsets, in 16-byte
// units.  Adding n to it moves the start by 16n bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// The same for a 64-byte-swizzled K-major operand of 64-byte rows (layout
// type 2): stride 512 bytes, eight rows.
__device__ __forceinline__ uint64_t smem_desc64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

// A copy of x the compiler cannot see through: a descriptor made from it
// inside a loop is not hoisted out and held in registers.
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("mov.b64 %0, %0;\n" : "+l"(x));
  return x;
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

// Wait for all but the last N committed groups of wgmmas.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared memory written by the generic proxy, read next by wgmma or
// overwritten by TMA (the async proxy).
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of `count` threads (a multiple of 32) on named barrier `id`.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
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

// d[8] (+)= A[64 x 8] · B[8 x 16]: A and B tf32, K-major in shared memory;
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[16] (+)= A[64 x 8] · B[8 x 32]: A and B tf32, K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
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

// d[32] (+)= A[64 x 8] · B[8 x 64]: A tf32 in registers, B K-major in shared
// memory; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
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

// d[8] (+)= A[64 x 8] · B[8 x 16]: A tf32 in registers, B K-major in shared
// memory; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (N == 16) {
    wgmma_ss_n16(d, da, db, accumulate);
  } else {
    wgmma_ss_n32(d, da, db, accumulate);
  }
}

// s[N / 2] = A · Bᵀ over D in three TF32 terms (A_lo·B_hi and A_hi·B_lo over
// every k-step, then A_hi·B_hi): A the 64 rows at ahi / alo of a tile of
// ARows rows, B the N rows at bhi / blo of a tile of BRows rows, both
// K-major in D / 32 panels; k-step kk is 8 columns (32 bytes) along panel
// kk / 4.  Issued, not waited for.
template <int D, int N, int ARows, int BRows>
__device__ __forceinline__ void issue_scores(float (&s)[N / 2], uint32_t ahi, uint32_t alo,
                                             uint32_t bhi, uint32_t blo) {
  const uint64_t dah = opaque(smem_desc(ahi)), dal = opaque(smem_desc(alo));
  const uint64_t dbh = opaque(smem_desc(bhi)), dbl = opaque(smem_desc(blo));
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint32_t oa = ((kk / 4) * ARows * kRowBytes + (kk % 4) * 32) >> 4;
    const uint32_t ob = ((kk / 4) * BRows * kRowBytes + (kk % 4) * 32) >> 4;
    wgmma_ss<N>(s, dal + oa, dbh + ob, kk > 0);
    wgmma_ss<N>(s, dah + oa, dbl + ob, 1);
  }
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint32_t oa = ((kk / 4) * ARows * kRowBytes + (kk % 4) * 32) >> 4;
    const uint32_t ob = ((kk / 4) * BRows * kRowBytes + (kk % 4) * 32) >> 4;
    wgmma_ss<N>(s, dah + oa, dbh + ob, 1);
  }
}

// tile[32] = Σ_g A_g · B_g over KS k-steps of 8 in three TF32 terms (a_lo·B_hi
// and a_hi·B_lo, then a_hi·B_hi): A the register fragments ah / al, B the
// 64 rows at bhi / blo of a transposed copy (RowBytes a row, k-step g at
// byte 32g).  The first product overwrites tile.  Issued, not waited for.
template <int KS, int RowBytes = kRowBytes>
__device__ __forceinline__ void issue_frag(float (&tile)[32], const uint32_t (&ah)[KS][4],
                                           const uint32_t (&al)[KS][4], uint32_t bhi,
                                           uint32_t blo) {
  static_assert(RowBytes == kRowBytes || RowBytes == 64, "128- or 64-byte rows");
  const uint64_t dbh = opaque(RowBytes == kRowBytes ? smem_desc(bhi) : smem_desc64(bhi));
  const uint64_t dbl = opaque(RowBytes == kRowBytes ? smem_desc(blo) : smem_desc64(blo));
#pragma unroll
  for (int g = 0; g < KS; ++g) {
    wgmma_rs_n64(tile, al[g], dbh + 2 * g, g > 0);
    wgmma_rs_n64(tile, ah[g], dbl + 2 * g, 1);
  }
#pragma unroll
  for (int g = 0; g < KS; ++g) wgmma_rs_n64(tile, ah[g], dbh + 2 * g, 1);
}

// Byte offset of element (row, col) of a tile stored as 128-byte swizzled
// panels of 32 float columns, `rows` rows a panel: the layout TMA writes
// and the wgmma descriptors read (16-byte chunk c of row r at c ^ (r % 8)).
__device__ __forceinline__ uint32_t swz(int row, int col, int rows) {
  return (col / kPanel) * rows * kRowBytes + row * kRowBytes +
         ((((col % kPanel) / 4) ^ (row & 7)) << 4) + (col & 3) * 4;
}

// Split the `bytes` of float32 at x in place (x keeps hi = rna(x), lo gets
// rna(x − hi)); the producer's 128 threads, a float4 each at a time.
__device__ __forceinline__ void split_in_place(unsigned char* x, unsigned char* lo, int bytes,
                                               int p) {
  for (int e = p; e < bytes / 16; e += 128) {
    const float4 v = reinterpret_cast<const float4*>(x)[e];
    uint4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    reinterpret_cast<uint4*>(x)[e] = h;
    reinterpret_cast<uint4*>(lo)[e] = l;
  }
}

// The transposed copies (hi at thi, lo at tlo) of the raw tile at raw, N
// rows of D floats in D / 32 panels: row d of a copy (RowBytes bytes)
// holds the tile's column d, its position q the tile's row 8(q / 8) +
// 2(q % 4) + (q % 8) / 4 (positions past N are not written).  Chunk (d,
// positions 4jq .. 4jq + 3) takes rows r, r + 2, r + 4, r + 6 with r =
// 8(jq / 2) + jq % 2; a warp takes 32 consecutive d of one chunk column,
// so neither its reads nor its writes conflict.  Rows of 128 bytes (32
// positions) take swz's 128-byte swizzle; rows of 64 bytes (16 positions)
// the 64-byte swizzle, chunk c of row d at c ^ ((d / 2) % 4).
template <int D, int N, int RowBytes = kRowBytes>
__device__ __forceinline__ void transpose_split(const unsigned char* raw, unsigned char* thi,
                                                unsigned char* tlo, int p) {
  for (int e = p; e < D * N / 4; e += 128) {
    const int d = e % D, jq = e / D;
    const int r = 8 * (jq / 2) + (jq & 1);
    uint4 h, l;
    split_tf32(*reinterpret_cast<const float*>(raw + swz(r, d, N)), h.x, l.x);
    split_tf32(*reinterpret_cast<const float*>(raw + swz(r + 2, d, N)), h.y, l.y);
    split_tf32(*reinterpret_cast<const float*>(raw + swz(r + 4, d, N)), h.z, l.z);
    split_tf32(*reinterpret_cast<const float*>(raw + swz(r + 6, d, N)), h.w, l.w);
    const uint32_t off = RowBytes == kRowBytes
                             ? swz(d, 4 * jq, D)
                             : d * RowBytes + ((jq ^ ((d >> 1) & 3)) << 4);
    *reinterpret_cast<uint4*>(thi + off) = h;
    *reinterpret_cast<uint4*>(tlo + off) = l;
  }
}

// split_in_place over a tile of kBytes (a compile-time size, a whole number
// of float4s for each of the producer's 128 threads): every float4 of a
// thread is loaded before any is split and stored, so the loads are in
// flight together (the MLA kernels' per-tile copies).
template <int kBytes>
__device__ __forceinline__ void split_tile(unsigned char* x, unsigned char* lo, int p) {
  constexpr int kIt = kBytes / 16 / 128;
  static_assert(kBytes % (16 * 128) == 0, "a whole number of float4s a thread");
  float4 v[kIt];
#pragma unroll
  for (int i = 0; i < kIt; ++i) v[i] = reinterpret_cast<const float4*>(x)[p + i * 128];
#pragma unroll
  for (int i = 0; i < kIt; ++i) {
    uint4 h, l;
    split_tf32(v[i].x, h.x, l.x);
    split_tf32(v[i].y, h.y, l.y);
    split_tf32(v[i].z, h.z, l.z);
    split_tf32(v[i].w, h.w, l.w);
    reinterpret_cast<uint4*>(x)[p + i * 128] = h;
    reinterpret_cast<uint4*>(lo)[p + i * 128] = l;
  }
}

// transpose_split's copies (the same order, layout and values) by the
// producer's 128 threads, a whole number of chunks each, every element of a
// thread loaded before any copy is stored: from the raw tile at x (kSplit),
// or from a tile already split in place, hi at x and lo at xlo (the same
// values, as the split is elementwise).
template <int D, int N, int RowBytes, bool kSplit>
__device__ __forceinline__ void transpose_tile(const unsigned char* x, const unsigned char* xlo,
                                               unsigned char* thi, unsigned char* tlo, int p) {
  constexpr int kIt = D * N / 4 / 128;
  static_assert(D * N / 4 % 128 == 0, "a whole number of chunks a thread");
  static_assert(RowBytes == kRowBytes || RowBytes == 64, "128- or 64-byte rows");
  uint32_t h[kIt][4], l[kIt][4];
#pragma unroll
  for (int i = 0; i < kIt; ++i) {
    const int e = p + i * 128, d = e % D, jq = e / D;
    const int r = 8 * (jq / 2) + (jq & 1);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t a = swz(r + 2 * k, d, N);
      if constexpr (kSplit) {
        split_tf32(*reinterpret_cast<const float*>(x + a), h[i][k], l[i][k]);
      } else {
        h[i][k] = *reinterpret_cast<const uint32_t*>(x + a);
        l[i][k] = *reinterpret_cast<const uint32_t*>(xlo + a);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kIt; ++i) {
    const int e = p + i * 128, d = e % D, jq = e / D;
    const uint32_t off = RowBytes == kRowBytes
                             ? swz(d, 4 * jq, D)
                             : d * RowBytes + ((jq ^ ((d >> 1) & 3)) << 4);
    *reinterpret_cast<uint4*>(thi + off) = make_uint4(h[i][0], h[i][1], h[i][2], h[i][3]);
    *reinterpret_cast<uint4*>(tlo + off) = make_uint4(l[i][0], l[i][1], l[i][2], l[i][3]);
  }
}

// Accumulator layout (m64nN, float32): element i of a thread lies in row
// r0 + 8·((i >> 1) & 1) of its warpgroup's 64, with r0 = 16·warp + lane / 4,
// and column 8·(i / 4) + 2·(lane % 4) + (i & 1).  A tf32 A fragment of k-step
// g holds (r0, 8g + t), (r0 + 8, 8g + t), (r0, 8g + t + 4), (r0 + 8, 8g + t +
// 4), t = lane % 4: register j takes accumulator element 4g + 2(j & 1) +
// (j >> 1), whose column 8g + 2t + (j >> 1) the permuted transposed copies
// hold at position t + 4(j >> 1).
__device__ __forceinline__ constexpr int frag_elem(int g, int j) {
  return 4 * g + ((j & 1) << 1) + (j >> 1);
}

template <int D, int DV, bool kLseIn = false>
__global__ void __launch_bounds__(DqCfg<D, DV>::kThreads, 1)
    flash_bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap domap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const float* __restrict__ o, const float* __restrict__ dout,
                             float* __restrict__ dq, float* __restrict__ lse2,
                             float* __restrict__ delta, int H, int Hkv, int Tq, int Tk,
                             int Tpad, float scale, int causal, int prefix) {
  using C = DqCfg<D, DV>;
  constexpr int kN = C::kN;
  constexpr int kV = kVariant;
  constexpr int kPasses = kV == kDqPass1 ? 1 : 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* basep = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bars = base + C::kBarOff;
  const uint32_t res_land = bars, res_ready = bars + 8;
  auto land = [&](int s) { return bars + 16u + 8u * s; };
  auto full = [&](int s) { return bars + 16u + 8u * (C::kBufs + s); };
  auto empty = [&](int s) { return bars + 16u + 8u * (2 * C::kBufs + s); };
  auto slot = [&](int s) { return C::kSlotOff + s * C::kSlotBytes; };
  // at MLA's pair pass 1 alternates two buffers of K_hi and K_lo in the
  // slot, and pass 2 takes the slot whole with buffer 0's barriers
  constexpr bool kMla = D != DV;

  // heaviest causal tiles first
  const int qt = kV == kHeadMajorCut ? gridDim.x - 1 - blockIdx.x : gridDim.y - 1 - blockIdx.y;
  const int bh = kV == kHeadMajorCut ? blockIdx.y : blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = b * Hkv + h / (H / Hkv);
  const int q0 = qt * C::kRows;
  // the key tiles of the block: all, or causally those up to the last key
  // its last row sees (row r sees keys 0..max(r, prefix − 1))
  int n_kt = (Tk + kN - 1) / kN;
  if (causal) n_kt = min(n_kt, max(min(q0 + C::kRows, Tq) - 1, prefix - 1) / kN + 1);

  if (threadIdx.x == 0) {
    mbar_init(res_land, 1);
    mbar_init(res_ready, 128);
    for (int s = 0; s < C::kBufs; ++s) {
      mbar_init(land(s), 1);
      mbar_init(full(s), 128);              // every producer thread, after its split
      mbar_init(empty(s), 128 * C::kNC);    // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: Q and dO once, then K tiles for pass 1 and K/V tiles for
    // pass 2 through one ring, each split as it lands
    if constexpr (C::kNC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int p = threadIdx.x;
    if (p == 0) {
      mbar_expect_tx(res_land, C::kBigQ + C::kBigV);
      for (int pn = 0; pn < D / kPanel; ++pn) {  // Dv <= D: dO takes the first panels
        const uint32_t off = pn * C::kRows * kRowBytes;
        tma_load_3d(base + off, &qmap, res_land, pn * kPanel, q0, bh);
        if (pn < DV / kPanel)
          tma_load_3d(base + C::kDoOff + off, &domap, res_land, pn * kPanel, q0, bh);
      }
    }
    mbar_wait(res_land, 0);
    if (kV != kNoSplit) {
      split_in_place(basep, basep + C::kBigQ, C::kBigQ, p);
      split_in_place(basep + C::kDoOff, basep + C::kDoOff + C::kBigV, C::kBigV, p);
    }
    proxy_fence();
    mbar_arrive(res_ready);
    int it = 0;
    for (int pass = kLseIn ? 1 : 0; pass < kPasses; ++pass) {
      for (int t = 0; t < n_kt; ++t, ++it) {
        const int s = kMla ? (pass ? 0 : t & 1) : it % C::kSlots;
        const int use = kMla ? (pass ? (n_kt + 1) / 2 + t : t >> 1) : it / C::kSlots;
        const int at = kMla ? C::kSlotOff + s * 2 * C::kTile : slot(s);
        const uint32_t sa = base + at;
        unsigned char* sp = basep + at;
        mbar_wait(empty(s), (use & 1) ^ 1);
        if (p == 0) {
          mbar_expect_tx(land(s), C::kTile + pass * C::kTileV);
          for (int pn = 0; pn < D / kPanel; ++pn) {
            const uint32_t off = pn * kN * kRowBytes;
            tma_load_3d(sa + C::kKhi + off, &kmap, land(s), pn * kPanel, t * kN, kvh);
            if (pass && pn < DV / kPanel)
              tma_load_3d(sa + C::kVhi + off, &vmap, land(s), pn * kPanel, t * kN, kvh);
          }
        }
        mbar_wait(land(s), use & 1);
        if constexpr (kMla) {
          if (pass) {
            // phase A: K and V split in place; phase B: Kᵀ from them once
            // the consumer is past the tile before's dQ (and, at the first
            // tile, past pass 1's last use of buffer 1, which Kᵀ overlays)
            if (kV != kNoSplit) {
              split_tile<C::kTileV>(sp + C::kVhi, sp + C::kVlo, p);
              split_tile<C::kTile>(sp + C::kKhi, sp + C::kKlo, p);
            }
            proxy_fence();
            mbar_arrive(full(0));
            bar_sync(1, 128);  // every half of K is split
            mbar_wait(empty(1), ((n_kt / 2 + t) & 1) ^ 1);
            if (kV != kNoSplit)
              transpose_tile<D, kN, C::kTrRow, false>(sp + C::kKhi, sp + C::kKlo, sp + C::kKThi,
                                                      sp + C::kKTlo, p);
            proxy_fence();
            mbar_arrive(full(1));
            bar_sync(1, 128);  // every read of K is done before the next tile lands
            continue;
          }
        }
        if (pass && kV != kNoSplit) {
          transpose_split<D, kN, C::kTrRow>(sp + C::kKhi, sp + C::kKThi, sp + C::kKTlo, p);
          split_in_place(sp + C::kVhi, sp + C::kVlo, C::kTileV, p);
        }
        bar_sync(1, 128);  // every read of the raw K is done
        if (kV != kNoSplit) {
          if constexpr (kMla) {  // pass 1's K
            split_tile<C::kTile>(sp + C::kKhi, sp + C::kKlo, p);
          } else {
            split_in_place(sp + C::kKhi, sp + C::kKlo, C::kTile, p);
          }
        }
        proxy_fence();
        mbar_arrive(full(s));
      }
    }
  } else {
    if constexpr (C::kNC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int cw = threadIdx.x / 128 - 1;  // consumer: rows 64·cw .. of the block
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int c2 = 2 * (lane % 4);
    const int r0 = q0 + 64 * cw + 16 * warp + lane / 4;  // the thread's rows r0, r0 + 8
    const int wg_row0 = q0 + 64 * cw;
    const float c = scale * kLog2e;  // raw scores to base-2 exponents
    const uint32_t qhi = base + cw * 64 * kRowBytes, qlo = qhi + C::kBigQ;
    const uint32_t dohi = qhi + C::kDoOff, dolo = dohi + C::kBigV;

    // Δ of rows r0 and r0 + 8 from global memory while Q and dO land: this
    // thread's Dv / 4 columns of dO ∘ O, then the quad's sum
    float dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      float part = 0.f;
      if (row < Tq) {
        const long long at = (static_cast<long long>(bh) * Tq + row) * DV;
#pragma unroll
        for (int g = 0; g < DV / 8; ++g) {
          const float2 x = __ldg(reinterpret_cast<const float2*>(dout + at + 8 * g + c2));
          const float2 y = __ldg(reinterpret_cast<const float2*>(o + at + 8 * g + c2));
          part = fmaf(x.x, y.x, part);
          part = fmaf(x.y, y.y, part);
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      dl[r] = part;
    }
    mbar_wait(res_ready, 0);

    // masked scores of a key tile: keys past Tk, and causally past the
    // last key of the row (row r sees keys 0..max(r, prefix − 1))
    auto mask = [&](float (&sc)[kN / 2], int k0) {
      if (k0 + kN <= Tk && !(causal && k0 + kN - 1 > max(wg_row0, prefix - 1))) return;
      const int last[2] = {max(r0, prefix - 1), max(r0 + 8, prefix - 1)};
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        const int key = k0 + 8 * (i / 4) + c2 + (i & 1);
        if (key >= Tk || (causal && key > last[(i >> 1) & 1])) sc[i] = kNegInf;
      }
    };

    float sc[kN / 2], dp[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) sc[i] = dp[i] = 0.f;
    int it = 0;
    float lse[2];
    if constexpr (kLseIn) {  // L of rows r0, r0 + 8 from the forward (rows past T: 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long at = static_cast<long long>(bh) * Tpad + r0 + 8 * r;
        lse[r] = r0 + 8 * r < Tq ? lse2[at] : 0.f;
        if (lane % 4 == 0) delta[at] = dl[r];
      }
    } else {
      // pass 1: the row maximum (raw scores) and sum of exp2 over every key
      // tile; a tile wholly past the last key of the warpgroup's rows adds
      // nothing
      float m[2] = {kNegInf, kNegInf};
      float l[2] = {0.f, 0.f};  // this thread's share of each row's sum
      for (int t = 0; t < n_kt; ++t, ++it) {
        const int s = kMla ? t & 1 : it % C::kSlots;
        const int k0 = t * kN;
        mbar_wait(full(s), (kMla ? t >> 1 : it / C::kSlots) & 1);
        if (kV == kNoCompute || (causal && k0 > max(wg_row0 + 63, prefix - 1))) {
          mbar_arrive(empty(s));
          continue;
        }
        const uint32_t sa = base + (kMla ? C::kSlotOff + s * 2 * C::kTile : slot(s));
        fence_regs(sc);
        wgmma_fence();
        issue_scores<D, kN, C::kRows, kN>(sc, qhi, qlo, sa + C::kKhi, sa + C::kKlo);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        mbar_arrive(empty(s));
        mask(sc, k0);
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        float mc[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          l[r] *= exp2f((m[r] - mx[r]) * c);
          m[r] = mx[r];
          mc[r] = mx[r] * c;
        }
#pragma unroll
        for (int i = 0; i < kN / 2; ++i)
          l[(i >> 1) & 1] += exp2f(fmaf(sc[i], c, -mc[(i >> 1) & 1]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        lse[r] = m[r] * c + log2f(fmaxf(l[r], 1e-30f));
        if (lane % 4 == 0) {
          const long long at = static_cast<long long>(bh) * Tpad + r0 + 8 * r;
          lse2[at] = lse[r];
          delta[at] = dl[r];
        }
      }
    }

    // pass 2: S and dP, then P and dS in registers as the hi / lo A
    // fragments of dQ += dS K, each tile's product (64 columns at a time)
    // into a fresh accumulator added once to the sum
    float acc[D / 2], tile[32];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) tile[i] = 0.f;
    for (int t = 0; t < (kPasses == 2 ? n_kt : 0); ++t, ++it) {
      const int s = kMla ? 0 : it % C::kSlots;
      const int k0 = t * kN;
      const int ub = n_kt / 2 + t;  // MLA: the tile's use of buffer 1's barriers (Kᵀ)
      mbar_wait(full(s), (kMla ? (n_kt + 1) / 2 + t : it / C::kSlots) & 1);
      if (kV == kNoCompute || (causal && k0 > max(wg_row0 + 63, prefix - 1))) {
        mbar_arrive(empty(s));
        if (kMla) {
          mbar_wait(full(1), ub & 1);
          mbar_arrive(empty(1));
        }
        continue;
      }
      const uint32_t sa = base + slot(s);
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      issue_scores<D, kN, C::kRows, kN>(sc, qhi, qlo, sa + C::kKhi, sa + C::kKlo);
      issue_scores<DV, kN, C::kRows, kN>(dp, dohi, dolo, sa + C::kVhi, sa + C::kVlo);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);
      if (kMla) mbar_arrive(empty(0));  // K and V are read
      mask(sc, k0);
      uint32_t dsh[kN / 8][4], dsl[kN / 8][4];
#pragma unroll
      for (int g = 0; g < kN / 8; ++g) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = frag_elem(g, j);
          const int r = j & 1;  // (i >> 1) & 1
          const float pv = exp2f(fmaf(sc[i], c, -lse[r]));
          split_tf32(pv * (dp[i] - dl[r]), dsh[g][j], dsl[g][j]);
        }
      }
      if (kMla) mbar_wait(full(1), ub & 1);  // Kᵀ is written
#pragma unroll
      for (int half = 0; half < D / 64; ++half) {
        const uint32_t hoff = half * 64 * C::kTrRow;  // Kᵀ rows 64·half ..
        fence_regs(tile);
        fence_regs(dsh);
        fence_regs(dsl);
        wgmma_fence();
        issue_frag<kN / 8, C::kTrRow>(tile, dsh, dsl, sa + C::kKThi + hoff,
                                      sa + C::kKTlo + hoff);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(tile);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[32 * half + i] += tile[i];
      }
      mbar_arrive(empty(kMla ? 1 : s));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row < Tq) {
        float* out = dq + (static_cast<long long>(bh) * Tq + row) * D;
#pragma unroll
        for (int g = 0; g < D / 8; ++g)
          *reinterpret_cast<float2*>(out + 8 * g + c2) =
              make_float2(acc[4 * g + 2 * r] * scale, acc[4 * g + 2 * r + 1] * scale);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(DkvCfg<D>::kThreads, 1)
    flash_bwd_dkdv_tf32_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap domap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const float* __restrict__ lse2, const float* __restrict__ delta,
                               float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv,
                               int Tq, int Tk, int Tpad, float scale, int causal, int prefix) {
  using C = DkvCfg<D>;
  constexpr int kQ = C::kQ;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* basep = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bars = base + C::kBarOff;
  const uint32_t res_land = bars, res_ready = bars + 8;
  auto land = [&](int s) { return bars + 16u + 8u * s; };
  auto full = [&](int s) { return bars + 16u + 8u * (C::kSlots + s); };
  auto empty = [&](int s) { return bars + 16u + 8u * (2 * C::kSlots + s); };
  auto slot = [&](int s) { return C::kSlotOff + s * C::kSlotBytes; };

  // the first key tiles see the most queries: first
  const int kt = kVariant == kHeadMajorCut ? blockIdx.x : blockIdx.y;
  const int bkv = kVariant == kHeadMajorCut ? blockIdx.y : blockIdx.x;
  const int b = bkv / Hkv;
  const int kvh = bkv - b * Hkv;
  const int G = H / Hkv;
  const int k0 = kt * C::kKeys;
  const int nq = (Tq + kQ - 1) / kQ;
  // causal: query i sees keys 0..max(i, prefix − 1), so tiles of queries
  // below k0 see none of these keys when k0 >= prefix, and every query sees
  // key k0 when it is below the prefix (tiles aligned at 0, kKeys a
  // multiple of kQ)
  const int qt0 = causal && k0 >= prefix ? k0 / kQ : 0;
  const int per_head = nq - qt0;
  const int n_it = G * per_head;

  if (threadIdx.x == 0) {
    mbar_init(res_land, 1);
    mbar_init(res_ready, 128);
    for (int s = 0; s < C::kSlots; ++s) {
      mbar_init(land(s), 1);
      mbar_init(full(s), 128);
      mbar_init(empty(s), C::kEmptyCount);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: K and V once, then Q, dO, L and Δ of each query tile of each
    // query head of the group, each split as it lands
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int p = threadIdx.x;
    if (p == 0) {
      mbar_expect_tx(res_land, 2 * C::kBig);
      for (int pn = 0; pn < D / kPanel; ++pn) {
        const uint32_t off = pn * C::kKeys * kRowBytes;
        tma_load_3d(base + off, &kmap, res_land, pn * kPanel, k0, bkv);
        tma_load_3d(base + 2 * C::kBig + off, &vmap, res_land, pn * kPanel, k0, bkv);
      }
    }
    mbar_wait(res_land, 0);
    if (kVariant != kNoSplit) {
      split_in_place(basep, basep + C::kBig, C::kBig, p);
      split_in_place(basep + 2 * C::kBig, basep + 3 * C::kBig, C::kBig, p);
    }
    proxy_fence();
    mbar_arrive(res_ready);
    for (int it = 0; it < n_it; ++it) {
      const int g = it / per_head;
      const int q0 = (qt0 + it - g * per_head) * kQ;
      const int bh = b * H + kvh * G + g;
      const int s = it % C::kSlots, use = it / C::kSlots;
      const uint32_t sa = base + slot(s);
      unsigned char* sp = basep + slot(s);
      mbar_wait(empty(s), (use & 1) ^ 1);
      if (p == 0) {
        mbar_expect_tx(land(s), C::kStageTx);
        for (int pn = 0; pn < D / kPanel; ++pn) {
          const uint32_t off = pn * kQ * kRowBytes;
          tma_load_3d(sa + C::kQhi + off, &qmap, land(s), pn * kPanel, q0, bh);
          tma_load_3d(sa + C::kDOhi + off, &domap, land(s), pn * kPanel, q0, bh);
        }
        const long long at = static_cast<long long>(bh) * Tpad + q0;
        bulk_load(sa + C::kStat, lse2 + at, kQ * 4, land(s));
        bulk_load(sa + C::kStat + kQ * 4, delta + at, kQ * 4, land(s));
      }
      mbar_wait(land(s), use & 1);
      if (kVariant != kNoSplit) {
        transpose_split<D, kQ>(sp + C::kQhi, sp + C::kQThi, sp + C::kQTlo, p);
        transpose_split<D, kQ>(sp + C::kDOhi, sp + C::kDOThi, sp + C::kDOTlo, p);
      }
      bar_sync(1, 128);  // every read of the raw Q and dO is done
      if (kVariant != kNoSplit) {
        split_in_place(sp + C::kQhi, sp + C::kQlo, C::kNat, p);
        split_in_place(sp + C::kDOhi, sp + C::kDOlo, C::kNat, p);
      }
      proxy_fence();
      mbar_arrive(full(s));
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int cw = threadIdx.x / 128 - 1;
    const int wg_cols = C::kSplit ? 64 * cw : 0;  // the warpgroup's output columns
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int c2 = 2 * (lane % 4);
    const int key0 = k0 + 16 * warp + lane / 4;  // the thread's keys, and + 8
    const float c = scale * kLog2e;
    const uint32_t khi = base, klo = base + C::kBig;
    const uint32_t vhi = base + 2 * C::kBig, vlo = base + 3 * C::kBig;
    float dka[32], dva[32], st[kQ / 2], dpt[kQ / 2], tile[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] = dva[i] = tile[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kQ / 2; ++i) st[i] = dpt[i] = 0.f;
    mbar_wait(res_ready, 0);

    for (int it = 0; it < n_it; ++it) {
      if (!C::kSplit && (it & 1) != cw) continue;  // the other warpgroup's tile
      const int g = it / per_head;
      const int q0 = (qt0 + it - g * per_head) * kQ;
      const int s = it % C::kSlots;
      const uint32_t sa = base + slot(s);
      const float* ls = reinterpret_cast<const float*>(basep + slot(s) + C::kStat);
      const float* dls = ls + kQ;
      mbar_wait(full(s), (it / C::kSlots) & 1);
      if (kVariant == kNoCompute) {
        mbar_arrive(empty(s));
        continue;
      }
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
      issue_scores<D, kQ, C::kKeys, kQ>(st, khi, klo, sa + C::kQhi, sa + C::kQlo);    // Sᵀ
      issue_scores<D, kQ, C::kKeys, kQ>(dpt, vhi, vlo, sa + C::kDOhi, sa + C::kDOlo);  // dPᵀ
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // Pᵀ and dSᵀ in place: element i is key key0 + 8·((i >> 1) & 1)
      // against query q0 + 8·(i / 4) + c2 + (i & 1); causally a key past
      // the query's last key, max(query, prefix − 1), is 0
      const bool masked = causal && k0 + 63 > max(q0, prefix - 1);
#pragma unroll
      for (int i = 0; i < kQ / 2; ++i) {
        const int col = 8 * (i / 4) + c2 + (i & 1);
        float pv = exp2f(fmaf(st[i], c, -ls[col]));
        if (masked) {  // a key below the prefix is seen by every query
          const int key = key0 + 8 * ((i >> 1) & 1);
          if ((key >= prefix ? key : -1) > q0 + col) pv = 0.f;
        }
        dpt[i] = pv * (dpt[i] - dls[col]);
        st[i] = pv;
      }
      // dV += Pᵀ dO, then dK += dSᵀ Q, each tile's product into a fresh
      // accumulator added once to the sum
      {
        uint32_t ph[kQ / 8][4], pl[kQ / 8][4];
#pragma unroll
        for (int g2 = 0; g2 < kQ / 8; ++g2)
#pragma unroll
          for (int j = 0; j < 4; ++j) split_tf32(st[frag_elem(g2, j)], ph[g2][j], pl[g2][j]);
        fence_regs(tile);
        fence_regs(ph);
        fence_regs(pl);
        wgmma_fence();
        issue_frag<kQ / 8>(tile, ph, pl, sa + C::kDOThi + wg_cols * kRowBytes,
                           sa + C::kDOTlo + wg_cols * kRowBytes);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(tile);
#pragma unroll
        for (int i = 0; i < 32; ++i) dva[i] += tile[i];
      }
      {
        uint32_t dh[kQ / 8][4], dl[kQ / 8][4];
#pragma unroll
        for (int g2 = 0; g2 < kQ / 8; ++g2)
#pragma unroll
          for (int j = 0; j < 4; ++j) split_tf32(dpt[frag_elem(g2, j)], dh[g2][j], dl[g2][j]);
        fence_regs(tile);
        fence_regs(dh);
        fence_regs(dl);
        wgmma_fence();
        issue_frag<kQ / 8>(tile, dh, dl, sa + C::kQThi + wg_cols * kRowBytes,
                           sa + C::kQTlo + wg_cols * kRowBytes);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(tile);
#pragma unroll
        for (int i = 0; i < 32; ++i) dka[i] += tile[i];
      }
      mbar_arrive(empty(s));
    }

    if constexpr (!C::kSplit) {
      // the two warpgroups' sums (even and odd query tiles) added once:
      // warpgroup 0 finishes dK, warpgroup 1 dV, each reading the other's
      // through the first slot, free once both are past their last tile
      bar_sync(2, 256);
      float* xk = reinterpret_cast<float*>(basep + slot(0));
      float* xv = xk + 32 * 128;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (cw == 0) xv[i * 128 + tid] = dva[i];
        else xk[i * 128 + tid] = dka[i];
      }
      bar_sync(2, 256);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (cw == 0) dka[i] += xk[i * 128 + tid];
        else dva[i] += xv[i * 128 + tid];
      }
    }
    const bool put_k = C::kSplit || cw == 0, put_v = C::kSplit || cw == 1;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key < Tk) {
        const long long row = (static_cast<long long>(bkv) * Tk + key) * D + wg_cols;
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const long long at = row + 8 * g + c2;
          if (put_k)
            *reinterpret_cast<float2*>(dk + at) =
                make_float2(dka[4 * g + 2 * r] * scale, dka[4 * g + 2 * r + 1] * scale);
          if (put_v)
            *reinterpret_cast<float2*>(dv + at) = make_float2(dva[4 * g + 2 * r], dva[4 * g + 2 * r + 1]);
        }
      }
    }
  }
}

// The dkdv kernel at MLA's pairs (MlaKvCfg): a block per (b·Hkv + kvh, tile
// of 64 keys, part), the key tiles that see the most queries first; part 0
// writes dK, part 1 dV.  The products are the dkdv kernel's.
template <int D, int DV>
__global__ void __launch_bounds__(MlaKvCfg<D, DV, true>::kThreads, 1)
    flash_bwd_dkdv_tf32_mla_kernel(const __grid_constant__ CUtensorMap qmap,
                                   const __grid_constant__ CUtensorMap domap,
                                   const __grid_constant__ CUtensorMap kmap,
                                   const __grid_constant__ CUtensorMap vmap,
                                   const float* __restrict__ lse2,
                                   const float* __restrict__ delta, float* __restrict__ dk,
                                   float* __restrict__ dv, int H, int Hkv, int Tq, int Tk,
                                   int Tpad, float scale, int causal, int prefix) {
  if ((kVariant == kDkOnly && blockIdx.z == 1) || (kVariant == kDvOnly && blockIdx.z == 0))
    return;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* basep = smem_raw + (base - smem_u32(smem_raw));
  const int kt = blockIdx.y;  // the first key tiles see the most queries: first
  const int bkv = blockIdx.x;
  const int b = bkv / Hkv;
  const int kvh = bkv - b * Hkv;
  const int G = H / Hkv;

  auto run = [&](auto part_) {
    constexpr bool kDk = decltype(part_)::value == 0;
    using C = MlaKvCfg<D, DV, kDk>;
    constexpr int kQ = C::kQ;
    constexpr int NC = kDk ? D : DV;  // output columns of the part
    const uint32_t bars = base + C::kBarOff;
    const uint32_t res_land = bars, res_ready = bars + 8;
    auto land = [&](int s) { return bars + 16u + 8u * s; };
    auto full = [&](int s) { return bars + 16u + 8u * (C::kSlots + s); };
    auto empty = [&](int s) { return bars + 16u + 8u * (2 * C::kSlots + s); };
    auto slot = [&](int s) { return C::kSlotOff + s * C::kSlotBytes; };
    const uint32_t tr_full = bars + 16u + 24u * C::kSlots, tr_empty = tr_full + 8;
    const int k0 = kt * C::kKeys;
    const int nq = (Tq + kQ - 1) / kQ;
    // causal: every query tile where k0 is below the prefix, else those
    // at or below the keys (as the dkdv kernel's)
    const int qt0 = causal && k0 >= prefix ? k0 / kQ : 0;
    const int per_head = nq - qt0;
    const int n_it = G * per_head;

    if (threadIdx.x == 0) {
      mbar_init(res_land, 1);
      mbar_init(res_ready, 128);
      for (int s = 0; s < C::kSlots; ++s) {
        mbar_init(land(s), 1);
        mbar_init(full(s), 128);
        mbar_init(empty(s), 128);
      }
      mbar_init(tr_full, 128);
      mbar_init(tr_empty, 128);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x < 128) {
      // producer: K (and for dK V) once, then Q, dO, L and Δ of each query
      // tile of each query head of the group, each split as it lands
      const int p = threadIdx.x;
      if (p == 0) {
        mbar_expect_tx(res_land, C::kBigK + C::kBigV);
        for (int pn = 0; pn < D / kPanel; ++pn) {
          const uint32_t off = pn * C::kKeys * kRowBytes;
          tma_load_3d(base + off, &kmap, res_land, pn * kPanel, k0, bkv);
          if (kDk && pn < DV / kPanel)
            tma_load_3d(base + C::kVhi + off, &vmap, res_land, pn * kPanel, k0, bkv);
        }
      }
      mbar_wait(res_land, 0);
      if (kVariant != kNoSplit) {
        split_in_place(basep, basep + C::kBigK, C::kBigK, p);
        if (kDk) split_in_place(basep + C::kVhi, basep + C::kVlo, C::kBigV, p);
      }
      proxy_fence();
      mbar_arrive(res_ready);
      for (int it = 0; it < n_it; ++it) {
        const int g = it / per_head;
        const int q0 = (qt0 + it - g * per_head) * kQ;
        const int bh = b * H + kvh * G + g;
        const int s = it % C::kSlots, use = it / C::kSlots;
        const uint32_t sa = base + slot(s);
        unsigned char* sp = basep + slot(s);
        mbar_wait(empty(s), (use & 1) ^ 1);
        if (p == 0) {
          mbar_expect_tx(land(s), C::kStageTx);
          for (int pn = 0; pn < D / kPanel; ++pn) {
            const uint32_t off = pn * kQ * kRowBytes;
            tma_load_3d(sa + C::kQhi + off, &qmap, land(s), pn * kPanel, q0, bh);
            if (pn < DV / kPanel)
              tma_load_3d(sa + C::kDOhi + off, &domap, land(s), pn * kPanel, q0, bh);
          }
          const long long at = static_cast<long long>(bh) * Tpad + q0;
          bulk_load(sa + C::kStat, lse2 + at, kQ * 4, land(s));
          bulk_load(sa + C::kStat + kQ * 4, delta + at, kQ * 4, land(s));
        }
        mbar_wait(land(s), use & 1);
        if constexpr (kDk) {
          // phase A: Q and dO split in place; phase B: Qᵀ from the split Q
          // once the consumer is past the tile before's dK product
          if (kVariant != kNoSplit) {
            split_tile<C::kNatQ>(sp + C::kQhi, sp + C::kQlo, p);
            split_tile<C::kNatDo>(sp + C::kDOhi, sp + C::kDOlo, p);
          }
          proxy_fence();
          mbar_arrive(full(s));
          bar_sync(1, 128);  // every half of Q is split
          mbar_wait(tr_empty, (it & 1) ^ 1);
          if (kVariant != kNoSplit)
            transpose_tile<D, kQ, C::kTrRow, false>(sp + C::kQhi, sp + C::kQlo, sp + C::kThi,
                                                    sp + C::kTlo, p);
          proxy_fence();
          mbar_arrive(tr_full);
          bar_sync(1, 128);  // every read of Q is done before the next tile lands
        } else {
          if (kVariant != kNoSplit)
            transpose_tile<DV, kQ, C::kTrRow, true>(sp + C::kDOhi, nullptr, sp + C::kThi,
                                                    sp + C::kTlo, p);
          bar_sync(1, 128);  // every read of the raw dO is done
          if (kVariant != kNoSplit) split_tile<C::kNatQ>(sp + C::kQhi, sp + C::kQlo, p);
          proxy_fence();
          mbar_arrive(full(s));
        }
      }
    } else {
      const int tid = threadIdx.x - 128;
      const int warp = tid / 32;
      const int lane = tid % 32;
      const int c2 = 2 * (lane % 4);
      const int key0 = k0 + 16 * warp + lane / 4;  // the thread's keys, and + 8
      const float c = scale * kLog2e;
      const uint32_t khi = base, klo = base + C::kBigK;
      const uint32_t vhi = base + C::kVhi, vlo = base + C::kVlo;
      float acc[NC / 2], st[kQ / 2], dpt[kQ / 2], tile[32];
#pragma unroll
      for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) tile[i] = 0.f;
#pragma unroll
      for (int i = 0; i < kQ / 2; ++i) st[i] = dpt[i] = 0.f;
      mbar_wait(res_ready, 0);

      for (int it = 0; it < n_it; ++it) {
        const int g = it / per_head;
        const int q0 = (qt0 + it - g * per_head) * kQ;
        const int s = it % C::kSlots;
        const uint32_t sa = base + slot(s);
        const float* ls = reinterpret_cast<const float*>(basep + slot(s) + C::kStat);
        const float* dls = ls + kQ;
        mbar_wait(full(s), (it / C::kSlots) & 1);
        if (kVariant == kNoCompute) {
          mbar_arrive(empty(s));
          if (kDk) {
            mbar_wait(tr_full, it & 1);
            mbar_arrive(tr_empty);
          }
          continue;
        }
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
        issue_scores<D, kQ, C::kKeys, kQ>(st, khi, klo, sa + C::kQhi, sa + C::kQlo);  // Sᵀ
        if constexpr (kDk)
          issue_scores<DV, kQ, C::kKeys, kQ>(dpt, vhi, vlo, sa + C::kDOhi,
                                             sa + C::kDOlo);  // dPᵀ
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(st);
        fence_regs(dpt);

        // Pᵀ (part 1) or dSᵀ (part 0): element i is key key0 + 8·((i >> 1) &
        // 1) against query q0 + 8·(i / 4) + c2 + (i & 1); causally a key past
        // the query's last key, max(query, prefix − 1), is 0
        const bool masked = causal && k0 + 63 > max(q0, prefix - 1);
#pragma unroll
        for (int i = 0; i < kQ / 2; ++i) {
          const int col = 8 * (i / 4) + c2 + (i & 1);
          float pv = exp2f(fmaf(st[i], c, -ls[col]));
          if (masked) {  // a key below the prefix is seen by every query
            const int key = key0 + 8 * ((i >> 1) & 1);
            if ((key >= prefix ? key : -1) > q0 + col) pv = 0.f;
          }
          st[i] = kDk ? pv * (dpt[i] - dls[col]) : pv;
        }
        if (kDk) {  // Q, dO, L and Δ are read; Qᵀ is next
          mbar_arrive(empty(s));
          mbar_wait(tr_full, it & 1);
        }
        // dK += dSᵀ Q against Qᵀ, or dV += Pᵀ dO against dOᵀ, 64 columns at
        // a time, each tile's product into a fresh accumulator added once
        uint32_t ah[kQ / 8][4], al[kQ / 8][4];
#pragma unroll
        for (int g2 = 0; g2 < kQ / 8; ++g2)
#pragma unroll
          for (int j = 0; j < 4; ++j) split_tf32(st[frag_elem(g2, j)], ah[g2][j], al[g2][j]);
#pragma unroll
        for (int half = 0; half < NC / 64; ++half) {
          const uint32_t hoff = half * 64 * C::kTrRow;
          fence_regs(tile);
          fence_regs(ah);
          fence_regs(al);
          wgmma_fence();
          issue_frag<kQ / 8, C::kTrRow>(tile, ah, al, sa + C::kThi + hoff, sa + C::kTlo + hoff);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(tile);
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[32 * half + i] += tile[i];
        }
        mbar_arrive(kDk ? tr_empty : empty(s));
      }

      float* out = kDk ? dk : dv;
      const float mul = kDk ? scale : 1.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key < Tk) {
          const long long row = (static_cast<long long>(bkv) * Tk + key) * NC;
#pragma unroll
          for (int g = 0; g < NC / 8; ++g)
            *reinterpret_cast<float2*>(out + row + 8 * g + c2) =
                make_float2(acc[4 * g + 2 * r] * mul, acc[4 * g + 2 * r + 1] * mul);
        }
      }
    }
  };
  if (blockIdx.z == 0) {
    run(Int<0>{});
  } else {
    run(Int<1>{});
  }
}

// (256, 256), paligemma-3b.  Hi and lo copies of a 64-row operand at D 256
// take 128 KB, so neither kernel splits its resident operands: they stay
// as TMA lands them, and the score products take them as register-A
// fragments, loaded and split k-step by k-step (scores_ra); only the
// streamed tiles are split, by the producer, as at the other pairs.  A
// block is the producer warpgroup and one consumer (256 threads: 255
// registers a thread, no setmaxnreg), with one slot: the producer's copies
// do not overlap the consumer's products.  A consumer that held all 256
// columns of its sum (128 registers a thread) beside a product's tile, S,
// dP and the fragments spilled (ptxas: 255 registers and 560–688 bytes of
// spill stores), so each block takes 128 output columns (the half on
// blockIdx.z) and computes its scores whole: S and dP twice as often.
// - dq (Dq256), a block per (b·H + h, tile of 64 query rows, half): Q and
//   dO raw (64 rows, 64 KB each); a slot of 16 keys, K_hi (K lands here),
//   K_lo, V_hi (V lands), V_lo and Kᵀ_hi, Kᵀ_lo in rows of 16 positions (64
//   bytes, the 64-byte swizzle), 16 KB each: 224 KB.  The consumer holds
//   its half of dQ (64 registers), a quarter's product (32), S and dP (8
//   each) and two k-steps' fragments (16).
// - dkdv (Dkv256T), a block per (b·Hkv + kvh, tile of 64 keys, part):
//   parts 0 and 1 the halves of dK (Sᵀ, dPᵀ, dSᵀ, dK += dSᵀ Q against Qᵀ),
//   parts 2 and 3 those of dV (Sᵀ, Pᵀ, dV += Pᵀ dO against dOᵀ).  K raw and
//   (dK) V raw, 64 KB each; a slot of 16 queries, Q_hi (Q lands), Q_lo,
//   dO_hi (dO lands), dO_lo and Qᵀ (dK) or dOᵀ (dV) hi and lo in 64-byte
//   rows, 16 KB each, with the tile's L and Δ: 225 KB.
struct Dq256 {
  static constexpr int kD = 256;
  static constexpr int kThreads = 256;
  static constexpr int kRows = 64;                 // query rows of a block
  static constexpr int kN = 16;                    // keys of a K/V tile
  static constexpr int kTrRow = kN * 4;            // bytes of a transposed row
  static constexpr int kBig = kRows * kD * 4;      // raw Q or dO
  static constexpr int kTile = kN * kD * 4;        // one K, V or Kᵀ copy
  static constexpr int kDoOff = kBig;
  static constexpr int kSlotOff = 2 * kBig;
  static constexpr int kKhi = 0, kKlo = kTile, kVhi = 2 * kTile, kVlo = 3 * kTile;
  static constexpr int kKThi = 4 * kTile, kKTlo = 5 * kTile;
  static constexpr int kBarOff = kSlotOff + 6 * kTile;
  // barriers: resident, land, full, empty; slack to align to 1024 bytes
  static constexpr size_t kBytes = kBarOff + 8 * 4 + 1024;
  static_assert(kBytes <= 232448, "more shared memory than a block can have");
};

struct Dkv256T {
  static constexpr int kD = 256;
  static constexpr int kThreads = 256;
  static constexpr int kKeys = 64;                 // keys of a block
  static constexpr int kQ = 16;                    // queries of a tile
  static constexpr int kTrRow = kQ * 4;            // bytes of a transposed row
  static constexpr int kBig = kKeys * kD * 4;      // raw K or V
  static constexpr int kNat = kQ * kD * 4;         // one natural Q or dO copy
  static constexpr int kTr = kD * kTrRow;          // one transposed copy
  static constexpr int kQhi = 0, kQlo = kNat, kDOhi = 2 * kNat, kDOlo = 3 * kNat;
  static constexpr int kThi = 4 * kNat, kTlo = 4 * kNat + kTr;
  static constexpr int kStat = 4 * kNat + 2 * kTr;
  static constexpr int kSlotBytes = (kStat + 2 * kQ * 4 + 1023) / 1024 * 1024;
  static constexpr int kSlotOff = 2 * kBig;
  static constexpr int kBarOff = kSlotOff + kSlotBytes;
  static constexpr size_t kBytes = kBarOff + 8 * 4 + 1024;
  static constexpr uint32_t kStageTx = 2 * kNat + 2 * kQ * 4;
  static_assert(kBytes <= 232448, "more shared memory than a block can have");
};

__device__ __forceinline__ void fence_frag(uint32_t (&r)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[j])::"memory");
}

// One float32 of shared memory at addr.
__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// A copy of x the compiler cannot see through (as opaque, for addresses).
__device__ __forceinline__ uint32_t opaque32(uint32_t x) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
  return x;
}

// s[N / 2] = A · Bᵀ over D = 256 in three TF32 terms, as issue_scores
// orders them (A_lo·B_hi and A_hi·B_lo over every k-step, then A_hi·B_hi:
// the small terms enter the accumulator first): A rows rl and rl + 8 of a
// raw tile at shared address araw (ARows rows a panel, TMA's layout) as
// tf32 A fragments, split in registers (its hi made again for the second
// run); B the N rows at bhi / blo of a tile the producer split, K-major in
// 32-column panels.  Each k-step is a commit group, whose fragments are
// held until the group two steps on is issued (wait_group 1); a step's
// addresses and descriptors are made right before it (opaque), so none is
// held across the tile loop; all groups are waited for before it returns.
template <int N, int ARows>
__device__ __forceinline__ void scores_ra(float (&s)[N / 2], uint32_t araw, int rl, int t,
                                          uint32_t bhi, uint32_t blo) {
  static_assert(N == 16, "16-row B tiles");
  constexpr int kSteps = 256 / 8;
  const uint64_t dbh = opaque(smem_desc(bhi)), dbl = opaque(smem_desc(blo));
  // row rl, column t of the first panel; the swizzle's row term
  const uint32_t a0 = araw + rl * kRowBytes + t * 4;
  const int x = rl & 7;
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int step = 0; step < 2 * kSteps; ++step) {
    const int kk = step % kSteps;
    const bool cross = step < kSteps;  // the run of A_lo·B_hi and A_hi·B_lo
    const int b = step & 1;
    if (step >= 2) {  // the group of step − 2 read these
      wgmma_wait<1>();
      fence_frag(ah[b]);
      fence_frag(al[b]);
    }
    // column 8kk + t + 4(j >> 1) of row rl + 8(j & 1): 16-byte chunk
    // 2(kk % 4) + (j >> 1) of the row in panel kk / 4, swizzled
    const uint32_t ap = opaque32(a0 + (kk / 4) * ARows * kRowBytes);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = lds_f32(ap + 8 * kRowBytes * (j & 1) +
                              (((2 * (kk % 4) + (j >> 1)) ^ x) << 4));
      if (cross) {
        split_tf32(v, ah[b][j], al[b][j]);
      } else {
        ah[b][j] = repro::tf32_rna(v);
      }
    }
    fence_frag(ah[b]);
    fence_frag(al[b]);
    wgmma_fence();
    const uint32_t ob = ((kk / 4) * N * kRowBytes + (kk % 4) * 32) >> 4;
    if (cross) {
      wgmma_rs_n16(s, al[b], opaque(dbh + ob), step > 0);
      wgmma_rs_n16(s, ah[b], opaque(dbl + ob), 1);
    } else {
      wgmma_rs_n16(s, ah[b], opaque(dbh + ob), 1);
    }
    wgmma_commit();
  }
  wgmma_wait_all();
  fence_regs(ah);
  fence_regs(al);
  fence_regs(s);
}

// acc[64] += A · B over output columns 128·half .., 64 at a time: the A
// fragments ah / al of two k-steps (16 positions) against the transposed
// copy at thi / tlo (64-byte rows), each quarter's product into a fresh
// accumulator added once to the sum.
__device__ __forceinline__ void frag_d256(float (&acc)[64], float (&tile)[32],
                                          const uint32_t (&ah)[2][4], const uint32_t (&al)[2][4],
                                          uint32_t thi, uint32_t tlo, int half) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t hoff = (2 * half + h) * 64 * 64;  // rows 64·(2·half + h) .. of the copy
    fence_regs(tile);
    wgmma_fence();
    issue_frag<2, 64>(tile, ah, al, thi + hoff, tlo + hoff);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(tile);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[32 * h + i] += tile[i];
  }
}

template <bool kLseIn>
__global__ void __launch_bounds__(Dq256::kThreads, 1)
    flash_bwd_dq_tf32_d256_kernel(const __grid_constant__ CUtensorMap qmap,
                                  const __grid_constant__ CUtensorMap domap,
                                  const __grid_constant__ CUtensorMap kmap,
                                  const __grid_constant__ CUtensorMap vmap,
                                  const float* __restrict__ o, const float* __restrict__ dout,
                                  float* __restrict__ dq, float* __restrict__ lse2,
                                  float* __restrict__ delta, int H, int Hkv, int Tq, int Tk,
                                  int Tpad, float scale, int causal, int prefix) {
  using C = Dq256;
  constexpr int kN = C::kN;
  constexpr int kV = kVariant;
  constexpr int kPasses = kV == kDqPass1 ? 1 : 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* basep = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bars = base + C::kBarOff;
  const uint32_t resident = bars, land = bars + 8, full = bars + 16, empty = bars + 24;
  const uint32_t sa = base + C::kSlotOff;
  unsigned char* sp = basep + C::kSlotOff;

  // heaviest causal tiles first; dQ's columns 128·half ..
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x;
  const int half = blockIdx.z;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = b * Hkv + h / (H / Hkv);
  const int q0 = qt * C::kRows;
  // the key tiles of the block: all, or causally those up to the last key
  // its last row sees (row r sees keys 0..max(r, prefix − 1))
  int n_kt = (Tk + kN - 1) / kN;
  if (causal) n_kt = min(n_kt, max(min(q0 + C::kRows, Tq) - 1, prefix - 1) / kN + 1);

  if (threadIdx.x == 0) {
    mbar_init(resident, 1);
    mbar_init(land, 1);
    mbar_init(full, 128);   // every producer thread, after its split
    mbar_init(empty, 128);  // every consumer thread
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: Q and dO once (raw), then K tiles for pass 1 and K/V tiles
    // for pass 2 through the slot, each split as it lands
    const int p = threadIdx.x;
    if (p == 0) {
      mbar_expect_tx(resident, 2 * C::kBig);
      for (int pn = 0; pn < C::kD / kPanel; ++pn) {
        const uint32_t off = pn * C::kRows * kRowBytes;
        tma_load_3d(base + off, &qmap, resident, pn * kPanel, q0, bh);
        tma_load_3d(base + C::kDoOff + off, &domap, resident, pn * kPanel, q0, bh);
      }
    }
    int use = 0;
    for (int pass = kLseIn ? 1 : 0; pass < kPasses; ++pass) {
      for (int t = 0; t < n_kt; ++t, ++use) {
        mbar_wait(empty, (use & 1) ^ 1);
        if (p == 0) {
          mbar_expect_tx(land, C::kTile * (1 + pass));
          for (int pn = 0; pn < C::kD / kPanel; ++pn) {
            const uint32_t off = pn * kN * kRowBytes;
            tma_load_3d(sa + C::kKhi + off, &kmap, land, pn * kPanel, t * kN, kvh);
            if (pass) tma_load_3d(sa + C::kVhi + off, &vmap, land, pn * kPanel, t * kN, kvh);
          }
        }
        mbar_wait(land, use & 1);
        if (pass && kV != kNoSplit) {
          transpose_split<C::kD, kN, C::kTrRow>(sp + C::kKhi, sp + C::kKThi, sp + C::kKTlo, p);
          split_in_place(sp + C::kVhi, sp + C::kVlo, C::kTile, p);
        }
        bar_sync(1, 128);  // every read of the raw K is done
        if (kV != kNoSplit) split_in_place(sp + C::kKhi, sp + C::kKlo, C::kTile, p);
        proxy_fence();
        mbar_arrive(full);
      }
    }
    return;
  }
  const int tid = threadIdx.x - 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int c2 = 2 * (lane % 4);
  const int rl = 16 * warp + lane / 4;  // the thread's rows of the block, and + 8
  const int r0 = q0 + rl;
  const float c = scale * kLog2e;  // raw scores to base-2 exponents

  // Δ of rows r0 and r0 + 8 from global memory while Q and dO land
  float dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    float part = 0.f;
    if (row < Tq) {
      const long long at = (static_cast<long long>(bh) * Tq + row) * C::kD;
#pragma unroll 8
      for (int g = 0; g < C::kD / 8; ++g) {
        const float2 x = __ldg(reinterpret_cast<const float2*>(dout + at + 8 * g + c2));
        const float2 y = __ldg(reinterpret_cast<const float2*>(o + at + 8 * g + c2));
        part = fmaf(x.x, y.x, part);
        part = fmaf(x.y, y.y, part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    dl[r] = part;
  }

  // masked scores of a key tile: keys past Tk, and causally past the last
  // key of the row
  auto mask = [&](float (&sc)[kN / 2], int k0) {
    if (k0 + kN <= Tk && !(causal && k0 + kN - 1 > max(q0, prefix - 1))) return;
    const int last[2] = {max(r0, prefix - 1), max(r0 + 8, prefix - 1)};
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      const int key = k0 + 8 * (i / 4) + c2 + (i & 1);
      if (key >= Tk || (causal && key > last[(i >> 1) & 1])) sc[i] = kNegInf;
    }
  };

  float sc[kN / 2], dp[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) sc[i] = dp[i] = 0.f;
  fence_regs(sc);
  fence_regs(dp);
  mbar_wait(resident, 0);
  int use = 0;
  float lse[2];
  if constexpr (kLseIn) {  // L of rows r0, r0 + 8 from the forward (rows past T: 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long at = static_cast<long long>(bh) * Tpad + r0 + 8 * r;
      lse[r] = r0 + 8 * r < Tq ? lse2[at] : 0.f;
      if (lane % 4 == 0 && half == 0) delta[at] = dl[r];
    }
  } else {
    // pass 1: the row maximum (raw scores) and sum of exp2 over every key
    // tile (both halves; the first writes L and Δ)
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's share of each row's sum
    for (int t = 0; t < n_kt; ++t, ++use) {
      mbar_wait(full, use & 1);
      if (kV == kNoCompute) {
        mbar_arrive(empty);
        continue;
      }
      scores_ra<kN, C::kRows>(sc, base, rl, lane % 4, sa + C::kKhi, sa + C::kKlo);
      mbar_arrive(empty);
      mask(sc, t * kN);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        l[r] *= exp2f((m[r] - mx[r]) * c);
        m[r] = mx[r];
        mc[r] = mx[r] * c;
      }
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) l[(i >> 1) & 1] += exp2f(fmaf(sc[i], c, -mc[(i >> 1) & 1]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      lse[r] = m[r] * c + log2f(fmaxf(l[r], 1e-30f));
      if (lane % 4 == 0 && half == 0) {
        const long long at = static_cast<long long>(bh) * Tpad + r0 + 8 * r;
        lse2[at] = lse[r];
        delta[at] = dl[r];
      }
    }
  }

  // pass 2: S and dP, then P and dS in registers as the hi / lo A
  // fragments of the half's dQ += dS K against Kᵀ, 64 columns at a time
  float acc[C::kD / 4], tile[32];
#pragma unroll
  for (int i = 0; i < C::kD / 4; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) tile[i] = 0.f;
  fence_regs(acc);
  fence_regs(tile);
  for (int t = 0; t < (kPasses == 2 ? n_kt : 0); ++t, ++use) {
    mbar_wait(full, use & 1);
    if (kV == kNoCompute) {
      mbar_arrive(empty);
      continue;
    }
    scores_ra<kN, C::kRows>(sc, base, rl, lane % 4, sa + C::kKhi, sa + C::kKlo);
    scores_ra<kN, C::kRows>(dp, base + C::kDoOff, rl, lane % 4, sa + C::kVhi, sa + C::kVlo);
    mask(sc, t * kN);
    uint32_t dsh[kN / 8][4], dsl[kN / 8][4];
#pragma unroll
    for (int g = 0; g < kN / 8; ++g) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = frag_elem(g, j);
        const int r = j & 1;  // (i >> 1) & 1
        const float pv = exp2f(fmaf(sc[i], c, -lse[r]));
        split_tf32(pv * (dp[i] - dl[r]), dsh[g][j], dsl[g][j]);
      }
    }
    fence_regs(dsh);
    fence_regs(dsl);
    frag_d256(acc, tile, dsh, dsl, sa + C::kKThi, sa + C::kKTlo, half);
    fence_regs(dsh);
    fence_regs(dsl);
    mbar_arrive(empty);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row < Tq) {
      float* out = dq + (static_cast<long long>(bh) * Tq + row) * C::kD + 128 * half;
#pragma unroll
      for (int g = 0; g < C::kD / 16; ++g)
        *reinterpret_cast<float2*>(out + 8 * g + c2) =
            make_float2(acc[4 * g + 2 * r] * scale, acc[4 * g + 2 * r + 1] * scale);
    }
  }
}

template <bool kDk>
__device__ __forceinline__ void dkdv_tf32_d256_body(const CUtensorMap* qmap,
                                                    const CUtensorMap* domap,
                                                    const CUtensorMap* kmap,
                                                    const CUtensorMap* vmap,
                                                    const float* __restrict__ lse2,
                                                    const float* __restrict__ delta,
                                                    float* __restrict__ out, int half, int H,
                                                    int Hkv, int Tq, int Tk, int Tpad,
                                                    float scale, int causal, int prefix) {
  using C = Dkv256T;
  constexpr int kQ = C::kQ;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* basep = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bars = base + C::kBarOff;
  const uint32_t resident = bars, land = bars + 8, full = bars + 16, empty = bars + 24;
  const uint32_t sa = base + C::kSlotOff;
  unsigned char* sp = basep + C::kSlotOff;

  // the first key tiles see the most queries: first
  const int kt = blockIdx.y;
  const int bkv = blockIdx.x;
  const int b = bkv / Hkv;
  const int kvh = bkv - b * Hkv;
  const int G = H / Hkv;
  const int k0 = kt * C::kKeys;
  const int nq = (Tq + kQ - 1) / kQ;
  // as the dkdv kernel's: every query tile where k0 is below the prefix
  const int qt0 = causal && k0 >= prefix ? k0 / kQ : 0;
  const int per_head = nq - qt0;
  const int n_it = G * per_head;

  if (threadIdx.x == 0) {
    mbar_init(resident, 1);
    mbar_init(land, 1);
    mbar_init(full, 128);
    mbar_init(empty, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: K (and for dK V) once, raw; then Q, dO, L and Δ of each
    // query tile of each query head of the group, split as they land
    const int p = threadIdx.x;
    if (p == 0) {
      mbar_expect_tx(resident, kDk ? 2 * C::kBig : C::kBig);
      for (int pn = 0; pn < C::kD / kPanel; ++pn) {
        const uint32_t off = pn * C::kKeys * kRowBytes;
        tma_load_3d(base + off, kmap, resident, pn * kPanel, k0, bkv);
        if (kDk) tma_load_3d(base + C::kBig + off, vmap, resident, pn * kPanel, k0, bkv);
      }
    }
    for (int it = 0; it < n_it; ++it) {
      const int g = it / per_head;
      const int q0 = (qt0 + it - g * per_head) * kQ;
      const int bh = b * H + kvh * G + g;
      mbar_wait(empty, (it & 1) ^ 1);
      if (p == 0) {
        mbar_expect_tx(land, C::kStageTx);
        for (int pn = 0; pn < C::kD / kPanel; ++pn) {
          const uint32_t off = pn * kQ * kRowBytes;
          tma_load_3d(sa + C::kQhi + off, qmap, land, pn * kPanel, q0, bh);
          tma_load_3d(sa + C::kDOhi + off, domap, land, pn * kPanel, q0, bh);
        }
        const long long at = static_cast<long long>(bh) * Tpad + q0;
        bulk_load(sa + C::kStat, lse2 + at, kQ * 4, land);
        bulk_load(sa + C::kStat + kQ * 4, delta + at, kQ * 4, land);
      }
      mbar_wait(land, it & 1);
      if (kVariant != kNoSplit) {
        // dK: Qᵀ from the raw Q, then Q and dO split in place; dV: dOᵀ
        // from the raw dO, Q split
        transpose_split<C::kD, kQ, C::kTrRow>(sp + (kDk ? C::kQhi : C::kDOhi), sp + C::kThi,
                                              sp + C::kTlo, p);
        if (kDk) bar_sync(1, 128);  // every read of the raw Q is done
        split_in_place(sp + C::kQhi, sp + C::kQlo, C::kNat, p);
        if (kDk) split_in_place(sp + C::kDOhi, sp + C::kDOlo, C::kNat, p);
      }
      proxy_fence();
      mbar_arrive(full);
    }
    return;
  }
  const int tid = threadIdx.x - 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int c2 = 2 * (lane % 4);
  const int rl = 16 * warp + lane / 4;
  const int key0 = k0 + rl;  // the thread's keys, and + 8
  const float c = scale * kLog2e;
  float acc[C::kD / 4], st[kQ / 2], dpt[kQ / 2], tile[32];  // the half's columns
#pragma unroll
  for (int i = 0; i < C::kD / 4; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) tile[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kQ / 2; ++i) st[i] = dpt[i] = 0.f;
  fence_regs(acc);
  fence_regs(tile);
  fence_regs(st);
  fence_regs(dpt);
  mbar_wait(resident, 0);

  for (int it = 0; it < n_it; ++it) {
    const int g = it / per_head;
    const int q0 = (qt0 + it - g * per_head) * kQ;
    const float* ls = reinterpret_cast<const float*>(sp + C::kStat);
    const float* dls = ls + kQ;
    mbar_wait(full, it & 1);
    if (kVariant == kNoCompute) {
      mbar_arrive(empty);
      continue;
    }
    scores_ra<kQ, C::kKeys>(st, base, rl, lane % 4, sa + C::kQhi, sa + C::kQlo);  // Sᵀ = K Qᵀ
    if constexpr (kDk)
      scores_ra<kQ, C::kKeys>(dpt, base + C::kBig, rl, lane % 4, sa + C::kDOhi,
                              sa + C::kDOlo);  // dPᵀ = V dOᵀ

    // Pᵀ (dV) or dSᵀ (dK): element i is key key0 + 8·((i >> 1) & 1) against
    // query q0 + 8·(i / 4) + c2 + (i & 1); causally a key past the query's
    // last key, max(query, prefix − 1), is 0
    const bool masked = causal && k0 + C::kKeys - 1 > max(q0, prefix - 1);
#pragma unroll
    for (int i = 0; i < kQ / 2; ++i) {
      const int col = 8 * (i / 4) + c2 + (i & 1);
      float pv = exp2f(fmaf(st[i], c, -ls[col]));
      if (masked) {  // a key below the prefix is seen by every query
        const int key = key0 + 8 * ((i >> 1) & 1);
        if ((key >= prefix ? key : -1) > q0 + col) pv = 0.f;
      }
      st[i] = kDk ? pv * (dpt[i] - dls[col]) : pv;
    }
    // dK += dSᵀ Q against Qᵀ, or dV += Pᵀ dO against dOᵀ
    uint32_t ah[kQ / 8][4], al[kQ / 8][4];
#pragma unroll
    for (int g2 = 0; g2 < kQ / 8; ++g2)
#pragma unroll
      for (int j = 0; j < 4; ++j) split_tf32(st[frag_elem(g2, j)], ah[g2][j], al[g2][j]);
    fence_regs(ah);
    fence_regs(al);
    frag_d256(acc, tile, ah, al, sa + C::kThi, sa + C::kTlo, half);
    fence_regs(ah);
    fence_regs(al);
    mbar_arrive(empty);
  }

  const float mul = kDk ? scale : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key < Tk) {
      float* row = out + (static_cast<long long>(bkv) * Tk + key) * C::kD + 128 * half;
#pragma unroll
      for (int g = 0; g < C::kD / 16; ++g)
        *reinterpret_cast<float2*>(row + 8 * g + c2) =
            make_float2(acc[4 * g + 2 * r] * mul, acc[4 * g + 2 * r + 1] * mul);
    }
  }
}

// The dkdv kernel at (256, 256) (Dkv256T): parts 0 and 1 (blockIdx.z) write
// the halves of dK, parts 2 and 3 those of dV.
__global__ void __launch_bounds__(Dkv256T::kThreads, 1)
    flash_bwd_dkdv_tf32_d256_kernel(const __grid_constant__ CUtensorMap qmap,
                                    const __grid_constant__ CUtensorMap domap,
                                    const __grid_constant__ CUtensorMap kmap,
                                    const __grid_constant__ CUtensorMap vmap,
                                    const float* __restrict__ lse2,
                                    const float* __restrict__ delta, float* __restrict__ dk,
                                    float* __restrict__ dv, int H, int Hkv, int Tq, int Tk,
                                    int Tpad, float scale, int causal, int prefix) {
  const int half = blockIdx.z & 1;
  if (blockIdx.z < 2) {
    dkdv_tf32_d256_body<true>(&qmap, &domap, &kmap, &vmap, lse2, delta, dk, half, H, Hkv, Tq,
                              Tk, Tpad, scale, causal, prefix);
  } else {
    dkdv_tf32_d256_body<false>(&qmap, &domap, &kmap, &vmap, lse2, delta, dv, half, H, Hkv, Tq,
                               Tk, Tpad, scale, causal, prefix);
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

template <int D, int DV, bool kLseIn = false>
cudaError_t launch(const float* q, const float* k, const float* v, const float* o,
                   const float* dout, float* dq, float* dk, float* dv, float* lse2,
                   float* delta, int B, int H, int Hkv, int Tq, int Tk, int causal, int prefix,
                   cudaStream_t stream) {
  using Q = DqCfg<D, DV>;
  constexpr bool kMla = D != DV;
  // the dkdv kernel's shapes: DkvCfg's at D = Dv, MlaKvCfg's at MLA's pair
  using Mk = MlaKvCfg<D, DV, true>;
  using Mv = MlaKvCfg<D, DV, false>;
  constexpr int kKeys = kMla ? Mk::kKeys : DkvCfg<D>::kKeys;
  constexpr int kQ = kMla ? Mk::kQ : DkvCfg<D>::kQ;
  constexpr int kKvThreads = kMla ? Mk::kThreads : DkvCfg<D>::kThreads;
  // at MLA's pair the larger of the two parts' layouts
  constexpr size_t kKvBytes =
      kMla ? (Mk::kBytes > Mv::kBytes ? Mk::kBytes : Mv::kBytes) : DkvCfg<D>::kBytes;
  auto dq_kernel = flash_bwd_dq_tf32_kernel<D, DV, kLseIn>;
  auto dkv_kernel = [] {
    if constexpr (kMla) {
      return flash_bwd_dkdv_tf32_mla_kernel<D, DV>;
    } else {
      return flash_bwd_dkdv_tf32_kernel<D>;
    }
  }();
  cudaError_t err = repro::allow_smem(dq_kernel, Q::kBytes);
  if (err == cudaSuccess) err = repro::allow_smem(dkv_kernel, kKvBytes);
  if (err != cudaSuccess) return err;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // the dq kernel's maps: kRows-row Q and dO tiles, kN-row K and V tiles;
  // the dkdv kernel's: 64-row K and V tiles, kQ-row Q and dO tiles
  CUtensorMap q_m, do_m, k_n, v_n, q_n, do_n, k_m, v_m;
  if (!make_map(&q_m, encode, q, D, Tq, B * H, Q::kRows) ||
      !make_map(&do_m, encode, dout, DV, Tq, B * H, Q::kRows) ||
      !make_map(&k_n, encode, k, D, Tk, B * Hkv, Q::kN) ||
      !make_map(&v_n, encode, v, DV, Tk, B * Hkv, Q::kN) ||
      !make_map(&q_n, encode, q, D, Tq, B * H, kQ) ||
      !make_map(&do_n, encode, dout, DV, Tq, B * H, kQ) ||
      !make_map(&k_m, encode, k, D, Tk, B * Hkv, kKeys) ||
      !make_map(&v_m, encode, v, DV, Tk, B * Hkv, kKeys))
    return cudaErrorInvalidValue;
  // the reference's 1.0 / (D ** 0.5), a double rounded to float
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const int Tpad = (Tq + kPadRows - 1) / kPadRows * kPadRows;
  // every row of the scratch gets its L and Δ (blocks of kRows rows)
  const dim3 dq_grid = kVariant == kHeadMajorCut ? dim3(Tpad / Q::kRows, B * H)
                                                 : dim3(B * H, Tpad / Q::kRows);
  dq_kernel<<<dq_grid, Q::kThreads, Q::kBytes, stream>>>(
      q_m, do_m, k_n, v_n, o, dout, dq, lse2, delta, H, Hkv, Tq, Tk, Tpad, scale, causal,
      prefix);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // at MLA's pair a third grid dimension: part 0 writes dK, part 1 dV
  const int n_kb = (Tk + kKeys - 1) / kKeys;
  const dim3 dkv_grid = kVariant == kHeadMajorCut && !kMla ? dim3(n_kb, B * Hkv)
                                                           : dim3(B * Hkv, n_kb, kMla ? 2 : 1);
  dkv_kernel<<<dkv_grid, kKvThreads, kKvBytes, stream>>>(
      q_n, do_n, k_m, v_m, lse2, delta, dk, dv, H, Hkv, Tq, Tk, Tpad, scale, causal, prefix);
  return cudaGetLastError();
}

// (256, 256): Dq256's and Dkv256T's kernels, the dkdv grid by part
template <bool kLseIn>
cudaError_t launch_d256(const float* q, const float* k, const float* v, const float* o,
                        const float* dout, float* dq, float* dk, float* dv, float* lse2,
                        float* delta, int B, int H, int Hkv, int Tq, int Tk, int causal,
                        int prefix, cudaStream_t stream) {
  using Q = Dq256;
  using K = Dkv256T;
  auto dq_kernel = flash_bwd_dq_tf32_d256_kernel<kLseIn>;
  cudaError_t err = repro::allow_smem(dq_kernel, Q::kBytes);
  if (err == cudaSuccess) err = repro::allow_smem(flash_bwd_dkdv_tf32_d256_kernel, K::kBytes);
  if (err != cudaSuccess) return err;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap q_m, do_m, k_n, v_n, q_n, do_n, k_m, v_m;
  if (!make_map(&q_m, encode, q, Q::kD, Tq, B * H, Q::kRows) ||
      !make_map(&do_m, encode, dout, Q::kD, Tq, B * H, Q::kRows) ||
      !make_map(&k_n, encode, k, Q::kD, Tk, B * Hkv, Q::kN) ||
      !make_map(&v_n, encode, v, Q::kD, Tk, B * Hkv, Q::kN) ||
      !make_map(&q_n, encode, q, K::kD, Tq, B * H, K::kQ) ||
      !make_map(&do_n, encode, dout, K::kD, Tq, B * H, K::kQ) ||
      !make_map(&k_m, encode, k, K::kD, Tk, B * Hkv, K::kKeys) ||
      !make_map(&v_m, encode, v, K::kD, Tk, B * Hkv, K::kKeys))
    return cudaErrorInvalidValue;
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(Q::kD)));
  const int Tpad = (Tq + kPadRows - 1) / kPadRows * kPadRows;
  // every row of the scratch gets its L and Δ (blocks of 64 rows), each
  // block half of dQ's columns
  dq_kernel<<<dim3(B * H, Tpad / Q::kRows, 2), Q::kThreads, Q::kBytes, stream>>>(
      q_m, do_m, k_n, v_n, o, dout, dq, lse2, delta, H, Hkv, Tq, Tk, Tpad, scale, causal,
      prefix);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_kb = (Tk + K::kKeys - 1) / K::kKeys;
  flash_bwd_dkdv_tf32_d256_kernel<<<dim3(B * Hkv, n_kb, 4), K::kThreads, K::kBytes, stream>>>(
      q_n, do_n, k_m, v_m, lse2, delta, dk, dv, H, Hkv, Tq, Tk, Tpad, scale, causal, prefix);
  return cudaGetLastError();
}

}  // namespace

// dQ, dK, dV of float32 attention, (D, Dv) ∈ {(64, 64), (128, 128), (192,
// 128), (256, 256)}; every pointer 16-byte aligned, every tensor contiguous.
// lse2 and delta are float32 [B·H, Tpad] scratch, Tpad = Tq rounded up to
// 128 (the row logsumexp in base 2, and Δ), written by the first kernel and
// read by the second; with have_lse (at D = Dv only) lse2 holds the
// forward's L already (flash_attention_tf32.cu) and is only read.  Causal
// needs Tq == Tk; with prefix P > 0 (causal only) query i sees keys
// 0..max(i, P − 1), the prefix-LM mask.
extern "C" int repro_flash_attention_bwd_tf32(const void* q, const void* k, const void* v,
                                              const void* o, const void* dout, void* dq,
                                              void* dk, void* dv, void* lse2, void* delta,
                                              int B, int H, int Hkv, int Tq, int Tk, int D,
                                              int Dv, int causal, int prefix, int have_lse,
                                              cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Tq <= 0 || Tk <= 0 ||
      (causal && Tq != Tk) || (have_lse && D != Dv) || prefix < 0 || prefix > Tq ||
      (prefix > 0 && !causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fo = static_cast<const float*>(o);
  const float* fdo = static_cast<const float*>(dout);
  float* gq = static_cast<float*>(dq);
  float* gk = static_cast<float*>(dk);
  float* gv = static_cast<float*>(dv);
  float* l = static_cast<float*>(lse2);
  float* dl = static_cast<float*>(delta);
  cudaError_t err = cudaErrorInvalidValue;
  auto run = [&](auto fn) {
    err = fn(fq, fk, fv, fo, fdo, gq, gk, gv, l, dl, B, H, Hkv, Tq, Tk, causal, prefix, stream);
  };
  if (D == 64 && Dv == 64)
    have_lse ? run(launch<64, 64, true>) : run(launch<64, 64>);
  else if (D == 128 && Dv == 128)
    have_lse ? run(launch<128, 128, true>) : run(launch<128, 128>);
  else if (D == 192 && Dv == 128)
    run(launch<192, 128>);
  else if (D == 256 && Dv == 256)
    have_lse ? run(launch_d256<true>) : run(launch_d256<false>);
  return static_cast<int>(err);
}

REPRO_DEFINE_ERROR_STRING(repro_flash_attention_bwd_tf32)
