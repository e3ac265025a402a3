// The gradient of causal (or full, or prefix-LM) flash attention on Hopper's
// tensor cores: dQ, dK and dV of o = softmax(q kᵀ / √D) v for q [B, H, T,
// D], k [B, Hkv, Tk, D], v [B, Hkv, Tk, Dv] and o, dO [B, H, T, Dv] in
// bfloat16, (D, Dv) ∈ {(64, 64), (128, 128), (192, 128), (256, 256)}: (192,
// 128) is deepseek-v3-671b's MLA (q and k of 128 nope + 64 rope columns, v
// of 128), (256, 256) paligemma-3b's (with its prefix of 256 patches).
//
// Replaces: no Pallas kernel.  The reference trains by jax.grad through
// flash_attention_jnp (src/repro/models/attention.py:76); the Pallas
// forward has no custom_vjp.  This is the Hopper route of
// repro_torch.kernels.flash_attention.flash_attention_bwd for bf16 at the
// head dims of every full-size config the port trains; float32 takes
// flash_attention_bwd_tf32.cu, D ≤ 32 and (16, 8) flash_attention_bwd.cu's
// SIMT kernels.  It computes that file's
// function: scores scaled by 1/√D (a double rounded to float) and masked
// at -1e30, the denominator floored at 1e-30, GQA by index (dK and dV sum
// over the G query heads of their group), any T.
//
// Precision.  S, dP, the softmax, Δ and every accumulator are float32.  P
// enters dV = Pᵀ dO, and dS = P ∘ (dP − Δ) (formed from the float32 P)
// enters dQ = dS K and dK = dSᵀ Q, each rounded once to bf16, as SDPA's
// flash backward feeds them to the tensor cores.  Its plain version is
// ref.flash_attention_bwd_bf16_ref.  Both are held within 1e-2 of each
// output's largest magnitude of the float64 gradient, the plain version on
// the CPU (tests/test_torch_flash_bwd.py), the kernel on the card
// (chip_smoke.py E1, tests/test_torch_cuda.py), with no split of P or dS
// into several bf16 terms.
//
// Bound: operations.  Five T×T×D products of the causal half (S, dP, dV,
// dQ, dK): at llama3.2-1b's microbatch (B 4, H 32, T 1024, D 64) 43 GFLOP,
// 0.0435 ms at 989 TFLOP/s bf16; beside them two exp2 passes (P in each
// kernel), 67 M exponentials at that shape, about 0.032 ms at 16 a clock
// on each SM.  Given the forward's L (the kLseIn instances, as autograd
// runs them) these kernels do seven products at every pair: S and dP twice
// (once in each kernel), dV, dQ and dK; without L eight (the dq kernel's
// pass for L computes S again).  At D ≥ 128 the dkdv kernel splits its
// work by product, so neither of its warpgroups repeats one (DkvCfg).  At
// (192, 128) the five products of the causal half are three at D and two
// at Dv: at deepseek-v3-671b's microbatch (B 4, H 128, T 1024) 446.7
// GFLOP, 0.452 ms at 989 TFLOP/s.
//
// Design: FlashAttention-2's backward in two kernels, launched in order on
// the caller's stream by one C entry, laid out as flash_attention_wgmma.cu
// lays out the forward.  Each block is three warpgroups: warpgroup 0 is the
// producer (it gives its registers up with setmaxnreg; one thread issues
// the TMA loads into a ring of stages, each signalled by an mbarrier with
// its byte count, freed by the consumers through a second mbarrier), and
// warpgroups 1 and 2 each own 64 rows of the block's 128 (the dkdv kernel
// from D = 128: the same 64 keys, one product each).  Tiles are
// 3-D TMA tensors (D, rows, B·heads), so a tile past a head's last row is
// zero-filled, not read from the next head; shared memory is 128-byte
// swizzled in 64-column panels.  Every product is a wgmma with float32
// accumulators:
// - flash_bwd_dq_wgmma_kernel, a block per (b·H + h, tile of 128 query
//   rows), heaviest causal tiles first.  Q, dO and O stay resident; K and V
//   stream in tiles of 64 keys (32 at (192, 128), see DqCfg).  Δ =
//   rowsum(dO ∘ O) from shared memory; pass 1 computes S = Q Kᵀ (both
//   operands K-major) over the key tiles for the row maximum and sum, so L
//   (base 2); pass 2 computes S and dP = dO Vᵀ, then P = exp2(S·c − L) and
//   dS in registers, and dQ += dS K with dS as the register-A operand (the
//   accumulator layout of S is the A fragment layout) and K the MN-major B
//   operand (transpose bit).  It writes L and Δ to float32 scratch [B·H, T
//   rounded up to 128] (rows past T too: finite, and met only by zero rows
//   of Q and dO).  Given the forward's L in that scratch (the kLseIn
//   instances), pass 1 and its K loads are left out and only Δ is written.
// - flash_bwd_dkdv_wgmma_kernel, a block per (b·Hkv + kvh, tile of 128
//   keys; 64 at D ≥ 128, see DkvCfg), the key tiles that see the most
//   queries first.  K and V stay resident; Q, dO and the tile's L and Δ (a
//   bulk copy each) stream in tiles of 64 queries for each of the G query
//   heads of the group (causally only the tiles at or below the keys).
//   It works transposed: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, so Pᵀ = exp2(Sᵀ·c − L) and
//   dSᵀ = Pᵀ ∘ (dPᵀ − Δ) are already the A fragments of dV += Pᵀ dO and
//   dK += dSᵀ Q, with dO and Q the MN-major B operands.  At D = 64 P and dS
//   never touch shared memory; from D = 128 Pᵀ goes from the warpgroup
//   that computes Sᵀ and dV to the one that computes dPᵀ and dK through
//   shared memory (DkvCfg).
// At (192, 128) both grids put a head's tiles on blockIdx.x, so the blocks
// in flight share their K/V (dq) or Q/dO (dkdv) tiles through L2: with the
// head on blockIdx.x the 132 blocks in flight were 132 heads at one tile,
// and every tile came from HBM again (3 GB a kernel at (B 4, H 128, T
// 1024); measured with tools/kernel_variants.py mla, PERF.md).  At D 64/128
// the same order measured slower, both kernels, at (B 4, H 32, T 1024, D
// 64) and (4, 16, T 1024, 128): there a head's K/V and Q/dO already fit the
// L2 (the kHeadMajorCut variant; tools/kernel_variants.py bwd_d64_d128).
// Each warpgroup waits for its products before its softmax.  Issuing a
// tile's S and dP as two commit groups, with P made while dP ran and the
// tile before's dQ (or dV, dK) left in flight, measured slower at both
// pairs; holding the next tile's S and dP in a second set of registers
// spilled (ptxas holds a 384-thread block's code to about 168 registers);
// the two consumer warpgroups taking turns at issuing S and dP (named
// barriers) measured no faster (PERF.md).
// The prefix-LM mask (prefix P > 0, causal, Tq == Tk): row r sees keys
// 0..max(r, P − 1), as the SIMT kernels (flash_attention_bwd.cu).  A dq
// block walks the key tiles up to max(its last row, P − 1) and masks a tile
// past max(its first row, P − 1) key by key; a dkdv key tile that starts
// below P takes every query tile (its first key is seen by every query),
// one at or past P those at or below its keys.  The tile orders stay
// heaviest first: a q tile's work grows with its index, a key tile's falls.
// With P = 0 every instance computes what it did before the mask.
// (256, 256): a consumer's dQ (or dK, dV) of 256 columns is 128 registers
// a thread, so the dq kernel there is one consumer warpgroup over 64 rows
// (DqCfg) and the dkdv kernel one of its own by part (Dkv256): 256-thread
// blocks, each thread up to 255 registers, no setmaxnreg.
// Every output element is one warpgroup's accumulator in a fixed order: no
// atomics, so two calls on the same inputs are bitwise equal.
//
// The tensor maps are encoded on the host for each call through
// cuTensorMapEncodeTiled, found with cudaGetDriverEntryPoint, so the
// library links no libcuda.
#include <cuda.h>
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

// Variants: 0 in the library; tools/kernel_variants.py builds the source
// with REPRO_VARIANT set to one of the cuts below, to time what each part of
// the kernels costs (every instance; kNoExchange and kRegProbe only where
// the dkdv warpgroups split by product).
#ifndef REPRO_VARIANT
#define REPRO_VARIANT 0
#endif

namespace {

constexpr int kVariant = REPRO_VARIANT;
constexpr int kNoCompute = 1;   // consumers release each tile unread
constexpr int kDqPass1 = 2;     // the dq kernel's first pass alone
constexpr int kNoExchange = 3;  // dkdv: Pᵀ not handed over (B takes Pᵀ = 1)
constexpr int kNoSoftmax = 4;   // P = S: no max, no sum, no exponentials
constexpr int kRegProbe = 5;    // dkdv: warpgroup A does all of the work alone
constexpr int kHeadMajorCut = 6;  // D 64/128: a head's tiles on blockIdx.x too

constexpr int kPadRows = 128;    // the L/Δ scratch rounds T up to a multiple of this
constexpr int kBlockN = 64;      // keys of a dq K/V tile
constexpr int kPanel = 64;       // bf16 columns of one 128-byte swizzled panel
constexpr int kRowBytes = 128;   // bytes of one row of a panel
constexpr int kThreadsWG = 384;  // producer warpgroup + two consumer warpgroups
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// dq: Q, dO and O resident, a ring of K and V tiles of kN keys.  At (192,
// 128) the resident tiles take 112 KB (Q 48, dO and O 32 each) and a stage
// of 64 keys 40 KB (K 24, V 16), so three would pass the 227 KB a block may
// have; and a consumer's dQ of 192 columns (96 registers a thread) beside
// S, dP and dS of 64 keys (80): built so, with two stages, ptxas held the
// consumers to 165 registers and spilled (178 local stores), and the kernel
// ran 1.6 times as long.  So the K/V tiles there are 32 keys: S, dP and dS
// take 40 registers, a stage 20 KB, and five stages fit (212 KB).  At (256,
// 256) a consumer's dQ is 128 registers a thread and 128 resident rows of
// Q, dO and O would be 192 KB, so a block is the producer and one consumer
// warpgroup (256 threads: every thread may hold 255 registers, no
// setmaxnreg) over 64 query rows: Q, dO and O 32 KB each, K/V tiles of 32
// keys (32 KB a stage), four stages, 224 KB; the consumer holds dQ (128), S,
// dP (16 each) and dS (8).
template <int D, int DV>
struct DqCfg {
  static constexpr int kNC = D == 256 ? 1 : 2;          // consumer warpgroups
  static constexpr int kThreads = 128 * (1 + kNC);
  static constexpr int kRows = 64 * kNC;               // query rows of a block
  static constexpr int kN = D == DV && D != 256 ? kBlockN : 32;  // keys of a K/V tile
  static constexpr int kStages = D == 64 ? 4 : D == 128 ? 3 : D == 192 ? 5 : 4;
  static constexpr int kPanels = D / kPanel;
  static constexpr int kPanelsV = DV / kPanel;
  static constexpr int kBigQ = kRows * D * 2;          // the resident Q
  static constexpr int kBigV = kRows * DV * 2;         // the resident dO or O
  static constexpr int kTileK = kN * D * 2;            // one K tile
  static constexpr int kTileV = kN * DV * 2;           // one V tile
  static constexpr int kDoOff = kBigQ;
  static constexpr int kOOff = kBigQ + kBigV;
  static constexpr int kKOff = kBigQ + 2 * kBigV;
  static constexpr int kVOff = kKOff + kStages * kTileK;
  static constexpr int kBarOff = kVOff + kStages * kTileV;
  // barriers: full[kStages], empty[kStages], resident; then slack to align
  // the dynamic shared memory to 1024 bytes (the swizzle's repeat)
  static constexpr size_t kBytes = kBarOff + (2 * kStages + 1) * 8 + 1024;
  static_assert(kBytes <= 232448, "more shared memory than a block can have");
};

// dkdv: K and V resident, a ring of Q and dO tiles with their L and Δ.
// At D = 64 a block takes 128 keys, 64 for each consumer warpgroup, which
// computes Sᵀ, dPᵀ, dV and dK of its keys.  From D = 128 a warpgroup's dK
// and dV of 64 keys would take 128 registers a thread (a kernel that held
// them spilled and had its wgmmas serialized, ptxas -v), so a block takes 64
// keys and the warpgroups split the work by product, not by output column:
// A computes Sᵀ and Pᵀ and accumulates dV (Dv / 2 registers of sums), B
// computes dPᵀ and dSᵀ and accumulates dK (D / 2), so neither repeats a
// product.  Pᵀ goes from A to B in float32 (dSᵀ is formed from the float32
// P, as before) through two slots of shared memory, each with a written and
// a read mbarrier, so A may run a tile ahead of B.  The Q and dO tiles are 64
// queries.  At (192, 128): three stages (40.5 KB each), K and V (40 KB) and
// the slots (32 KB) take 194 KB; A holds 64 sums and 48 registers of Sᵀ and
// Pᵀ, B 96 sums and 48 of dPᵀ and dSᵀ.  At 128: four stages (32.5 KB each),
// K and V (32 KB) and the slots (32 KB), 194 KB.
template <int D, int DV>
struct DkvCfg {
  static constexpr bool kByProduct = D >= 128;        // the warpgroups split by product
  static constexpr int kStages = D == 192 ? 3 : 4;
  static constexpr int kPanels = D / kPanel;
  static constexpr int kPanelsV = DV / kPanel;
  static constexpr int kKeys = kByProduct ? 64 : 128;  // keys of a block
  static constexpr int kQ = kBlockN;                  // queries of a tile
  static constexpr int kBigK = kKeys * D * 2;         // the resident K
  static constexpr int kBigV = kKeys * DV * 2;        // the resident V
  static constexpr int kTileQ = kQ * D * 2;           // one Q tile
  static constexpr int kTileDo = kQ * DV * 2;         // one dO tile
  static constexpr int kStatBytes = 2 * kQ * 4;       // L, then Δ, of a tile
  static constexpr int kSlotBytes = kByProduct ? kKeys * kQ * 4 : 0;  // a Pᵀ slot, float32
  static constexpr int kVOff = kBigK;
  static constexpr int kQOff = kBigK + kBigV;
  static constexpr int kDoOff = kQOff + kStages * kTileQ;
  static constexpr int kLOff = kDoOff + kStages * kTileDo;
  static constexpr int kPOff = kLOff + kStages * kStatBytes;
  static constexpr int kBarOff = kPOff + 2 * kSlotBytes;
  // barriers: full[kStages], empty[kStages], resident, and split by
  // product pfull[2], pfree[2]
  static constexpr size_t kBytes = kBarOff + (2 * kStages + 1 + (kByProduct ? 4 : 0)) * 8 + 1024;
  static constexpr uint32_t kStageTx = kTileQ + kTileDo + kStatBytes;
  static_assert(kBytes <= 232448, "more shared memory than a block can have");
};

// Whether a grid puts a head's tiles on blockIdx.x: at (192, 128), and in
// the kHeadMajorCut variant
template <int D, int DV>
__host__ __device__ constexpr bool head_major() {
  return D != DV || kVariant == kHeadMajorCut;
}

// A compile-time int, to hand a generic lambda its template arguments
template <int N>
struct Int {
  static constexpr int value = N;
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

// wgmma descriptor of a 128-byte-swizzled operand (layout type 1): start
// address, leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
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

// Pin registers that an asynchronous wgmma reads or writes: the compiler
// may not move their uses across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d[32] (+)= A[64 x 16] · B[16 x 64], A and B K-major in shared memory;
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[16] (+)= A[64 x 16] · B[16 x 32], A and B K-major in shared memory;
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// s[N / 2] (+)= A[64 x 16] · B[16 x N], N ∈ {32, 64}: the score products
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (N == 64) {
    wgmma_ss_n64(d, da, db, accumulate);
  } else {
    wgmma_ss_n32(d, da, db, accumulate);
  }
}

// d[32] += A[64 x 16] · B[16 x 64], A in registers (bf16 pairs), B MN-major
// in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] += A[64 x 16] · B[16 x 128], A in registers (bf16 pairs), B MN-major
// in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[96] += A[64 x 16] · B[16 x 192], A in registers (bf16 pairs), B MN-major
// in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[128] += A[64 x 16] · B[16 x 256], A in registers (bf16 pairs), B MN-major
// in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc[N / 2] += A · B with B[16 x N] MN-major: the products into dQ, dK, dV
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&acc)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) {
    wgmma_rs_n64(acc, a, db);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(acc, a, db);
  } else if constexpr (N == 192) {
    wgmma_rs_n192(acc, a, db);
  } else {
    wgmma_rs_n256(acc, a, db);
  }
}

// A copy of x the compiler cannot see through: a descriptor made from it
// inside a loop is not hoisted out and held in registers.
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("mov.b64 %0, %0;\n" : "+l"(x));
  return x;
}

// s[N / 2] = A · Bᵀ over D for a 64-row A at sa (a tile of a_rows rows)
// and an N-row B at sb (a tile of b_rows rows), both K-major: D / 16 steps
// of 16 columns (32 bytes) along each panel, advancing the descriptors'
// address fields (16-byte units).  Issued, not waited for.
template <int D, int N = kBlockN>
__device__ __forceinline__ void issue_dot(float (&s)[N / 2], uint32_t sa, int a_rows,
                                          uint32_t sb, int b_rows) {
  const uint64_t da = opaque(smem_desc(sa, 16, 1024));
  const uint64_t db = opaque(smem_desc(sb, 16, 1024));
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss<N>(s, da + (((kk / 4) * a_rows * kRowBytes + off) >> 4),
                db + (((kk / 4) * b_rows * kRowBytes + off) >> 4), kk > 0);
  }
}

// acc[N / 2] += A · B for the A fragments a (64 rows, the K columns of a
// score tile in K / 16 k-steps) and B the N columns at sb of a K-row tile,
// MN-major: 16 rows (two 1024-byte swizzle atoms) a step, the leading byte
// offset stepping between its 64-column panels.  Issued, not waited for.
template <int N, int K = kBlockN>
__device__ __forceinline__ void issue_rs(float (&acc)[N / 2], const uint32_t (&a)[K / 16][4],
                                         uint32_t sb) {
  const uint64_t db = opaque(smem_desc(sb, K * kRowBytes, 1024));
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<N>(acc, a[kk], db + ((kk * 16 * kRowBytes) >> 4));
}

// The two floats as a bf16 pair (the first in the low half), each rounded
// to nearest even: one register of a wgmma A fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte offset of element (row, col) in a bf16 tile of `rows` rows, stored
// as 128-byte-swizzled 64-column panels (TMA's layout): the 16-byte chunk
// of a row is xor-ed with the row's index in its 1024-byte atom.
__device__ __forceinline__ uint32_t swz(int row, int col, int rows) {
  const int c = (col % kPanel) * 2;
  return (col / kPanel) * rows * kRowBytes + row * kRowBytes +
         ((((c >> 4) ^ (row & 7))) << 4) + (c & 15);
}

// Accumulator layout (m64nN, float32): element i of a thread lies in row
// r0 + 8·((i >> 1) & 1) of its warpgroup's 64, with r0 = 16·warp + lane / 4,
// and column 8·(i / 4) + 2·(lane % 4) + (i & 1).  Register j of k-step kk
// of an A fragment holds elements 8kk + 2j and 8kk + 2j + 1.

template <int D, int DV, bool kLseIn = false>
__global__ void __launch_bounds__(DqCfg<D, DV>::kThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap domap,
                              const __grid_constant__ CUtensorMap omap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              __nv_bfloat16* __restrict__ dq, float* __restrict__ lse2,
                              float* __restrict__ delta, int H, int Hkv, int Tq, int Tk,
                              int Tpad, float scale, int causal, int prefix) {
  using C = DqCfg<D, DV>;
  constexpr int kN = C::kN;
  constexpr int kRows = C::kRows;
  constexpr int kV = kVariant;
  constexpr int kPasses = kV == kDqPass1 ? 1 : 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned char* basep = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sq = base, sdo = base + C::kDoOff, so = base + C::kOOff;
  const uint32_t sk = base + C::kKOff, sv = base + C::kVOff;
  const uint32_t bars = base + C::kBarOff;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (C::kStages + s); };
  const uint32_t resident = bars + 8u * (2 * C::kStages);

  // heaviest causal tiles first; at (192, 128) the query tiles of one head
  // are in flight together (blockIdx.x), so its K and V tiles come from L2
  // after the first read
  constexpr bool kHeadMajor = head_major<D, DV>();
  const int qt = kHeadMajor ? gridDim.x - 1 - blockIdx.x : gridDim.y - 1 - blockIdx.y;
  const int bh = kHeadMajor ? blockIdx.y : blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = b * Hkv + h / (H / Hkv);
  const int q0 = qt * kRows;
  // the key tiles of the block: all, or causally those up to the last key
  // its last row sees (row r sees keys 0..max(r, prefix − 1))
  int n_kt = (Tk + kN - 1) / kN;
  if (causal) n_kt = min(n_kt, max(min(q0 + kRows, Tq) - 1, prefix - 1) / kN + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), C::kNC * 128);  // every consumer thread releases a stage
    }
    mbar_init(resident, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: Q, dO and O once, then K tiles for pass 1 (not when L is
    // given) and K/V tiles for pass 2 through one ring
    if constexpr (C::kNC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(resident, C::kBigQ + 2 * C::kBigV);
      for (int p = 0; p < C::kPanels; ++p) {  // Dv <= D: dO and O take the first panels
        const uint32_t off = p * kRows * kRowBytes;
        tma_load_3d(sq + off, &qmap, resident, p * kPanel, q0, bh);
        if (p < C::kPanelsV) {
          tma_load_3d(sdo + off, &domap, resident, p * kPanel, q0, bh);
          tma_load_3d(so + off, &omap, resident, p * kPanel, q0, bh);
        }
      }
      int it = 0;
      for (int pass = kLseIn ? 1 : 0; pass < kPasses; ++pass) {
        for (int t = 0; t < n_kt; ++t, ++it) {
          const int s = it % C::kStages;
          mbar_wait(empty(s), ((it / C::kStages) & 1) ^ 1);
          mbar_expect_tx(full(s), C::kTileK + pass * C::kTileV);
          for (int p = 0; p < C::kPanels; ++p) {
            const uint32_t off = p * kN * kRowBytes;
            tma_load_3d(sk + s * C::kTileK + off, &kmap, full(s), p * kPanel, t * kN, kvh);
            if (pass && p < C::kPanelsV)
              tma_load_3d(sv + s * C::kTileV + off, &vmap, full(s), p * kPanel, t * kN, kvh);
          }
        }
      }
    }
  } else {
    if constexpr (C::kNC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = threadIdx.x / 128 - 1;  // consumer: rows 64·cw .. of the block
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int c2 = 2 * (lane % 4);
    const int rl = 64 * cw + 16 * warp + lane / 4;  // the thread's rows rl, rl + 8
    const int r0 = q0 + rl;
    const int wg_row0 = q0 + 64 * cw;
    const float c = scale * kLog2e;  // raw scores to base-2 exponents
    const uint32_t sq_wg = sq + cw * 64 * kRowBytes;
    const uint32_t sdo_wg = sdo + cw * 64 * kRowBytes;
    mbar_wait(resident, 0);

    // Δ of rows rl and rl + 8: this thread's Dv / 4 columns of dO ∘ O, then
    // the quad's sum (two commutative adds: every lane gets the same value)
    float dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float part = 0.f;
#pragma unroll
      for (int g = 0; g < DV / 8; ++g) {
        const uint32_t off = swz(rl + 8 * r, 8 * g + c2, kRows);
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(basep + C::kDoOff + off));
        const float2 y = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(basep + C::kOOff + off));
        part = fmaf(x.x, y.x, part);
        part = fmaf(x.y, y.y, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      dl[r] = part;
    }

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

    float sc[kN / 2], dp[kN / 2];  // S and dP tiles: a tile's first product overwrites them
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) sc[i] = dp[i] = 0.f;
    int it = 0;
    float lse[2];
    if constexpr (kLseIn) {  // L of rows r0, r0 + 8 from the forward
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long at = static_cast<long long>(bh) * Tpad + r0 + 8 * r;
        lse[r] = lse2[at];
        if (lane % 4 == 0) delta[at] = dl[r];
      }
    } else {
      // pass 1: the row maximum (raw scores) and sum of exp2 over every key tile
      float m[2] = {kNegInf, kNegInf};
      float l[2] = {0.f, 0.f};  // this thread's share of each row's sum
      for (int t = 0; t < n_kt; ++t, ++it) {
        const int s = it % C::kStages;
        mbar_wait(full(s), (it / C::kStages) & 1);
        if (kV == kNoCompute) {
          mbar_arrive(empty(s));
          continue;
        }
        wgmma_fence();
        issue_dot<D, kN>(sc, sq_wg, kRows, sk + s * C::kTileK, kN);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        mbar_arrive(empty(s));
        if (kV == kNoSoftmax) continue;
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
        if (lane % 4 == 0) {
          const long long at = static_cast<long long>(bh) * Tpad + r0 + 8 * r;
          lse2[at] = lse[r];
          delta[at] = dl[r];
        }
      }
    }

    // pass 2: S and dP, then P and dS in registers, then dQ += dS K
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // pinned here at D 256: else ptxas may set them inside the first
    // product's wgmma pipeline stage and serialize the wgmmas (C7515)
    if constexpr (D == 256) fence_regs(acc);
    for (int t = 0; kPasses == 2 && t < n_kt; ++t, ++it) {
      const int s = it % C::kStages;
      const uint32_t sks = sk + s * C::kTileK;
      mbar_wait(full(s), (it / C::kStages) & 1);
      if (kV == kNoCompute) {
        mbar_arrive(empty(s));
        continue;
      }
      wgmma_fence();
      issue_dot<D, kN>(sc, sq_wg, kRows, sks, kN);
      issue_dot<DV, kN>(dp, sdo_wg, kRows, sv + s * C::kTileV, kN);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);
      mask(sc, t * kN);
      uint32_t ds[kN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 2 * j;
          const int r = j & 1;  // (i >> 1) & 1
          const float p0 = kV == kNoSoftmax ? sc[i] : exp2f(fmaf(sc[i], c, -lse[r]));
          const float p1 = kV == kNoSoftmax ? sc[i + 1] : exp2f(fmaf(sc[i + 1], c, -lse[r]));
          ds[kk][j] = pack_bf16(p0 * (dp[i] - dl[r]), p1 * (dp[i + 1] - dl[r]));
        }
      }
      fence_regs(acc);
      fence_regs(ds);
      wgmma_fence();
      issue_rs<D, kN>(acc, ds, sks);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(empty(s));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row < Tq) {
        __nv_bfloat16* out = dq + (static_cast<long long>(bh) * Tq + row) * D;
#pragma unroll
        for (int g = 0; g < D / 8; ++g)
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * g + c2) = __floats2bfloat162_rn(
              acc[4 * g + 2 * r] * scale, acc[4 * g + 2 * r + 1] * scale);
      }
    }
  }
}

// kPrefix: the instance that takes the prefix-LM mask; without it the
// kernel's code is what it was before the mask (with the mask in it, the D
// 64 instance took 10 % longer at P = 0, measured in turns on an H100)
template <int D, int DV, bool kPrefix = false>
__global__ void __launch_bounds__(kThreadsWG, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap domap,
                                const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap,
                                const float* __restrict__ lse2,
                                const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, int H, int Hkv, int Tq, int Tk,
                                int Tpad, float scale, int causal, int prefix) {
  using C = DkvCfg<D, DV>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned char* basep = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sk = base, sv = base + C::kVOff, sq = base + C::kQOff;
  const uint32_t sdo = base + C::kDoOff, sl = base + C::kLOff;
  const uint32_t bars = base + C::kBarOff;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (C::kStages + s); };
  const uint32_t resident = bars + 8u * (2 * C::kStages);
  // split by product: the Pᵀ slot j written (pfull) and read (pfree)
  auto pfull = [&](int j) { return bars + 8u * (2 * C::kStages + 1 + j); };
  auto pfree = [&](int j) { return bars + 8u * (2 * C::kStages + 3 + j); };

  // the first key tiles see the most queries: first; at (192, 128) the key
  // tiles of one head are in flight together (blockIdx.x), so its Q and dO
  // tiles come from L2 after the first read
  const int kt = head_major<D, DV>() ? blockIdx.x : blockIdx.y;
  const int bkv = head_major<D, DV>() ? blockIdx.y : blockIdx.x;
  const int b = bkv / Hkv;
  const int kvh = bkv - b * Hkv;
  const int G = H / Hkv;
  const int k0 = kt * C::kKeys;
  constexpr int kQ = C::kQ;
  const int nq = (Tq + kQ - 1) / kQ;
  // causal: query i sees keys 0..max(i, prefix − 1), so tiles of queries
  // below k0 see none of these keys when k0 >= prefix, and every query sees
  // key k0 when it is below the prefix (tiles aligned at 0, kKeys a
  // multiple of kQ)
  const int qt0 = causal && (!kPrefix || k0 >= prefix) ? k0 / kQ : 0;
  const int per_head = nq - qt0;
  const int n_it = G * per_head;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);
    }
    mbar_init(resident, 1);
    if constexpr (C::kByProduct) {
      for (int j = 0; j < 2; ++j) {
        mbar_init(pfull(j), 128);
        mbar_init(pfree(j), 128);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: K and V once, then Q, dO, L and Δ of each query tile of each
    // query head of the group
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(resident, C::kBigK + C::kBigV);
      for (int p = 0; p < C::kPanels; ++p) {  // Dv <= D: V takes the first panels
        const uint32_t off = p * C::kKeys * kRowBytes;
        tma_load_3d(sk + off, &kmap, resident, p * kPanel, k0, bkv);
        if (p < C::kPanelsV) tma_load_3d(sv + off, &vmap, resident, p * kPanel, k0, bkv);
      }
      for (int it = 0; it < n_it; ++it) {
        const int g = it / per_head;
        const int q0 = (qt0 + it - g * per_head) * kQ;
        const int bh = b * H + kvh * G + g;
        const int s = it % C::kStages;
        mbar_wait(empty(s), ((it / C::kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), C::kStageTx);
        for (int p = 0; p < C::kPanels; ++p) {
          const uint32_t off = p * kQ * kRowBytes;
          tma_load_3d(sq + s * C::kTileQ + off, &qmap, full(s), p * kPanel, q0, bh);
          if (p < C::kPanelsV)
            tma_load_3d(sdo + s * C::kTileDo + off, &domap, full(s), p * kPanel, q0, bh);
        }
        const long long at = static_cast<long long>(bh) * Tpad + q0;
        bulk_load(sl + s * C::kStatBytes, lse2 + at, kQ * 4, full(s));
        bulk_load(sl + s * C::kStatBytes + kQ * 4, delta + at, kQ * 4, full(s));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    if constexpr (!C::kByProduct) {
      // D = 64: warpgroup cw takes keys 64·cw .. of the block, all columns
      const int cw = threadIdx.x / 128 - 1;
      const int wg_keys = 64 * cw;  // the warpgroup's keys in the block
      const int tid = threadIdx.x % 128;
      const int warp = tid / 32;
      const int lane = tid % 32;
      const int c2 = 2 * (lane % 4);
      const int key0 = k0 + wg_keys + 16 * warp + lane / 4;  // the thread's keys, and + 8
      const int wg_key0 = k0 + wg_keys;
      const float c = scale * kLog2e;
      const uint32_t sk_wg = sk + wg_keys * kRowBytes;
      const uint32_t sv_wg = sv + wg_keys * kRowBytes;
      float dka[D / 2], dva[D / 2], st[kQ / 2], dpt[kQ / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
      for (int i = 0; i < kQ / 2; ++i) st[i] = dpt[i] = 0.f;
      mbar_wait(resident, 0);

      for (int it = 0; it < n_it; ++it) {
        const int g = it / per_head;
        const int q0 = (qt0 + it - g * per_head) * kQ;
        const int s = it % C::kStages;
        const uint32_t sqs = sq + s * C::kTileQ;
        const uint32_t sdos = sdo + s * C::kTileDo;
        const float* ls = reinterpret_cast<const float*>(basep + C::kLOff + s * C::kStatBytes);
        const float* dls = ls + kQ;
        mbar_wait(full(s), (it / C::kStages) & 1);
        if (kVariant == kNoCompute) {
          mbar_arrive(empty(s));
          continue;
        }
        wgmma_fence();
        issue_dot<D>(st, sk_wg, C::kKeys, sqs, kQ);   // Sᵀ = K Qᵀ
        issue_dot<D>(dpt, sv_wg, C::kKeys, sdos, kQ);  // dPᵀ = V dOᵀ
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(st);
        fence_regs(dpt);

        // Pᵀ and dSᵀ: element i is key key0 + 8·((i >> 1) & 1) against query
        // q0 + 8·(i / 4) + c2 + (i & 1); causally a key past the query's
        // last key, max(query, prefix − 1), is 0
        const bool masked = causal && wg_key0 + 63 > (kPrefix ? max(q0, prefix - 1) : q0);
        uint32_t pf[kQ / 16][4], dsf[kQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < kQ / 16; ++kk) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = 8 * kk + 2 * j;
            const int col = 8 * (i / 4) + c2;
            const float2 lv = *reinterpret_cast<const float2*>(ls + col);
            const float2 dv2 = *reinterpret_cast<const float2*>(dls + col);
            float p0 = kVariant == kNoSoftmax ? st[i] : exp2f(fmaf(st[i], c, -lv.x));
            float p1 = kVariant == kNoSoftmax ? st[i + 1] : exp2f(fmaf(st[i + 1], c, -lv.y));
            if (kVariant != kNoSoftmax && masked) {
              const int key = key0 + 8 * (j & 1);
              // a key below the prefix is seen by every query
              const int kc = !kPrefix || key >= prefix ? key : -1;
              if (kc > q0 + col) p0 = 0.f;
              if (kc > q0 + col + 1) p1 = 0.f;
            }
            pf[kk][j] = pack_bf16(p0, p1);
            dsf[kk][j] = pack_bf16(p0 * (dpt[i] - dv2.x), p1 * (dpt[i + 1] - dv2.y));
          }
        }
        fence_regs(dva);
        fence_regs(dka);
        fence_regs(pf);
        fence_regs(dsf);
        wgmma_fence();
        issue_rs<D>(dva, pf, sdos);  // dV += Pᵀ dO
        issue_rs<D>(dka, dsf, sqs);  // dK += dSᵀ Q
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dva);
        fence_regs(dka);
        mbar_arrive(empty(s));
      }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key < Tk) {
          const long long row = (static_cast<long long>(bkv) * Tk + key) * D;
#pragma unroll
          for (int g = 0; g < D / 8; ++g) {
            const long long at = row + 8 * g + c2;
            *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
                dka[4 * g + 2 * r] * scale, dka[4 * g + 2 * r + 1] * scale);
            *reinterpret_cast<__nv_bfloat162*>(dv + at) =
                __floats2bfloat162_rn(dva[4 * g + 2 * r], dva[4 * g + 2 * r + 1]);
          }
        }
      }
    } else {
      // From D = 128, split by product (DkvCfg): warpgroup A (cw 0) computes
      // Sᵀ, makes Pᵀ, hands it to B through a slot and accumulates dV over
      // all Dv columns; warpgroup B (cw 1) computes dPᵀ, takes Pᵀ from the
      // slot, forms dSᵀ and accumulates dK over all D columns.  Two slots, so
      // A may run a tile ahead of B.  (kRegProbe: A does all of it alone.)
      constexpr int kV = kVariant;
      constexpr bool kAll = kV == kRegProbe;
      constexpr int kVecs = C::kSlotBytes / 16;  // float4s of a slot
      const int cw = threadIdx.x / 128 - 1;
      const int tid = threadIdx.x % 128;
      const int warp = tid / 32;
      const int lane = tid % 32;
      const int c2 = 2 * (lane % 4);
      const int key0 = k0 + 16 * warp + lane / 4;  // the thread's keys, and + 8
      const float c = scale * kLog2e;
      float4* slots = reinterpret_cast<float4*>(smem_raw + (base - smem_u32(smem_raw)) + C::kPOff);
      mbar_wait(resident, 0);

      // the sums of N columns (a row of `out`) of the thread's two keys, times mul
      auto store = [&](auto n_, __nv_bfloat16* out, const auto& acc, float mul) {
        constexpr int N = decltype(n_)::value;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = key0 + 8 * r;
          if (key < Tk) {
            __nv_bfloat16* row = out + (static_cast<long long>(bkv) * Tk + key) * N;
#pragma unroll
            for (int g = 0; g < N / 8; ++g)
              *reinterpret_cast<__nv_bfloat162*>(row + 8 * g + c2) = __floats2bfloat162_rn(
                  acc[4 * g + 2 * r] * mul, acc[4 * g + 2 * r + 1] * mul);
          }
        }
      };

      // A tile's first product (Sᵀ for A, dPᵀ for B) into s_, issued as a
      // commit group of its own once the tile has landed
      auto first = [&](float (&s_)[kQ / 2], int it, bool b_side) {
        const int s = it % C::kStages;
        mbar_wait(full(s), (it / C::kStages) & 1);
        wgmma_fence();
        if (b_side) {
          issue_dot<DV, kQ>(s_, sv, C::kKeys, sdo + s * C::kTileDo, kQ);  // dPᵀ = V dOᵀ
        } else {
          issue_dot<D, kQ>(s_, sk, C::kKeys, sq + s * C::kTileQ, kQ);  // Sᵀ = K Qᵀ
        }
        wgmma_commit();
      };
      // begin: tile `it`'s first product, waited for; end: its second product
      // waited for, then the tile's stage released
      auto begin = [&](float (&cur)[kQ / 2], int it, bool b_side) {
        first(cur, it, b_side);
        wgmma_wait<0>();
        fence_regs(cur);
      };
      auto end = [&](int it) {
        wgmma_wait<0>();
        mbar_arrive(empty(it % C::kStages));
      };

      if (kV == kNoCompute || (kAll && cw == 1)) {
        for (int it = 0; it < n_it; ++it) {
          mbar_wait(full(it % C::kStages), (it / C::kStages) & 1);
          mbar_arrive(empty(it % C::kStages));
        }
      } else if (cw == 0) {
        float dva[DV / 2], st[kQ / 2], dka[kAll ? D / 2 : 2], dpt[kQ / 2];
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) dva[i] = 0.f;
#pragma unroll
        for (int i = 0; i < (kAll ? D / 2 : 2); ++i) dka[i] = 0.f;
#pragma unroll
        for (int i = 0; i < kQ / 2; ++i) st[i] = dpt[i] = 0.f;
        for (int it = 0; it < n_it; ++it) {
          const int g = it / per_head;
          const int q0 = (qt0 + it - g * per_head) * kQ;
          const int s = it % C::kStages;
          const uint32_t sqs = sq + s * C::kTileQ;
          const uint32_t sdos = sdo + s * C::kTileDo;
          const float* ls =
              reinterpret_cast<const float*>(basep + C::kLOff + s * C::kStatBytes);
          begin(st, it, false);
          if constexpr (kAll) {  // A also takes dPᵀ
            wgmma_fence();
            issue_dot<DV, kQ>(dpt, sv, C::kKeys, sdos, kQ);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dpt);
          }

          // Pᵀ, k-step by k-step: element i is key key0 + 8·((i >> 1) & 1)
          // against query q0 + 8·(i / 4) + c2 + (i & 1); causally a key past
          // the query's last key, max(query, prefix − 1), is 0.  Each step's
          // eight floats go to B's slot as two float4s, in B's own layout
          // (its thread tid holds the same elements of dPᵀ)
          constexpr bool kHand = !kAll && kV != kNoExchange;
          const bool masked = causal && k0 + 63 > (kPrefix ? max(q0, prefix - 1) : q0);
          const int slot = it & 1;
          if (kHand) mbar_wait(pfree(slot), ((it >> 1) & 1) ^ 1);
          uint32_t pf[kQ / 16][4], dsf[kQ / 16][4];
#pragma unroll
          for (int kk = 0; kk < kQ / 16; ++kk) {
            float p[8];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int i = 8 * kk + 2 * j;
              const int col = 8 * (i / 4) + c2;
              const float2 lv = *reinterpret_cast<const float2*>(ls + col);
              float p0 = kV == kNoSoftmax ? st[i] : exp2f(fmaf(st[i], c, -lv.x));
              float p1 = kV == kNoSoftmax ? st[i + 1] : exp2f(fmaf(st[i + 1], c, -lv.y));
              if (kV != kNoSoftmax && masked) {
                const int key = key0 + 8 * (j & 1);
                // a key below the prefix is seen by every query
                const int kc = !kPrefix || key >= prefix ? key : -1;
                if (kc > q0 + col) p0 = 0.f;
                if (kc > q0 + col + 1) p1 = 0.f;
              }
              p[2 * j] = p0;
              p[2 * j + 1] = p1;
              pf[kk][j] = pack_bf16(p0, p1);
              if constexpr (kAll) {  // dSᵀ = Pᵀ ∘ (dPᵀ − Δ)
                const float2 dv2 = *reinterpret_cast<const float2*>(ls + kQ + col);
                dsf[kk][j] = pack_bf16(p0 * (dpt[i] - dv2.x), p1 * (dpt[i + 1] - dv2.y));
              }
            }
            if (kHand) {
              slots[slot * kVecs + 2 * kk * 128 + tid] = make_float4(p[0], p[1], p[2], p[3]);
              slots[slot * kVecs + (2 * kk + 1) * 128 + tid] =
                  make_float4(p[4], p[5], p[6], p[7]);
            }
          }
          if (kHand) mbar_arrive(pfull(slot));
          fence_regs(dva);
          fence_regs(pf);
          if constexpr (kAll) {
            fence_regs(dka);
            fence_regs(dsf);
          }
          wgmma_fence();
          issue_rs<DV, kQ>(dva, pf, sdos);  // dV += Pᵀ dO
          if constexpr (kAll) issue_rs<D, kQ>(dka, dsf, sqs);
          wgmma_commit();
          end(it);
        }
        fence_regs(dva);
        if constexpr (kAll) fence_regs(dka);
        store(Int<DV>{}, dv, dva, 1.f);
        if constexpr (kAll) store(Int<D>{}, dk, dka, scale);
      } else {
        float dka[D / 2], dpt[kQ / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dka[i] = 0.f;
#pragma unroll
        for (int i = 0; i < kQ / 2; ++i) dpt[i] = 0.f;
        for (int it = 0; it < n_it; ++it) {
          const int s = it % C::kStages;
          const float* dls =
              reinterpret_cast<const float*>(basep + C::kLOff + s * C::kStatBytes) + kQ;
          begin(dpt, it, true);
          // dSᵀ = Pᵀ ∘ (dPᵀ − Δ), k-step by k-step from A's slot, as the A
          // fragments of dK += dSᵀ Q
          const int slot = it & 1;
          if (kV != kNoExchange) mbar_wait(pfull(slot), (it >> 1) & 1);
          uint32_t dsf[kQ / 16][4];
#pragma unroll
          for (int kk = 0; kk < kQ / 16; ++kk) {
            float4 x0 = make_float4(1.f, 1.f, 1.f, 1.f), x1 = x0;
            if (kV != kNoExchange) {
              x0 = slots[slot * kVecs + 2 * kk * 128 + tid];
              x1 = slots[slot * kVecs + (2 * kk + 1) * 128 + tid];
            }
            const float p[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int i = 8 * kk + 2 * j;
              const float2 dv2 = *reinterpret_cast<const float2*>(dls + 8 * (i / 4) + c2);
              dsf[kk][j] = pack_bf16(p[2 * j] * (dpt[i] - dv2.x),
                                     p[2 * j + 1] * (dpt[i + 1] - dv2.y));
            }
          }
          if (kV != kNoExchange) mbar_arrive(pfree(slot));
          fence_regs(dka);
          fence_regs(dsf);
          wgmma_fence();
          issue_rs<D, kQ>(dka, dsf, sq + s * C::kTileQ);  // dK += dSᵀ Q
          wgmma_commit();
          end(it);
        }
        fence_regs(dka);
        store(Int<D>{}, dk, dka, scale);
      }
    }
  }
}

// dkdv at (256, 256): a warpgroup's dK or dV of 64 keys is 128 registers a
// thread, so a block of 256 threads (the producer warpgroup and one
// consumer: every thread may hold 255 registers, no setmaxnreg) takes one
// of them, by part (blockIdx.z): part 0 dK (Sᵀ, dPᵀ, dSᵀ, then dK += dSᵀ
// Q), part 1 dV (Sᵀ, Pᵀ, then dV += Pᵀ dO).  K (and for dK V) of 64 keys
// stay resident, 32 KB each; Q, dO and the tile's L and Δ stream in tiles
// of 32 queries (32.25 KB a stage), four stages: 193 KB.  The consumer
// holds its sums (128), Sᵀ and dPᵀ (16 each) and the A fragments (8).
struct Dkv256 {
  static constexpr int kD = 256;
  static constexpr int kThreads = 256;
  static constexpr int kKeys = 64;                 // keys of a block
  static constexpr int kQ = 32;                    // queries of a tile
  static constexpr int kStages = 4;
  static constexpr int kPanels = kD / kPanel;
  static constexpr int kBig = kKeys * kD * 2;      // the resident K or V
  static constexpr int kTile = kQ * kD * 2;        // one Q or dO tile
  static constexpr int kStatBytes = 2 * kQ * 4;    // L, then Δ, of a tile
  static constexpr int kVOff = kBig;
  static constexpr int kQOff = 2 * kBig;
  static constexpr int kDoOff = kQOff + kStages * kTile;
  static constexpr int kLOff = kDoOff + kStages * kTile;
  static constexpr int kBarOff = kLOff + kStages * kStatBytes;
  // barriers: full[kStages], empty[kStages], resident
  static constexpr size_t kBytes = kBarOff + (2 * kStages + 1) * 8 + 1024;
  static constexpr uint32_t kStageTx = 2 * kTile + kStatBytes;
  static_assert(kBytes <= 232448, "more shared memory than a block can have");
};

template <bool kDk>
__device__ __forceinline__ void dkdv_d256_body(const CUtensorMap* qmap, const CUtensorMap* domap,
                                               const CUtensorMap* kmap, const CUtensorMap* vmap,
                                               const float* __restrict__ lse2,
                                               const float* __restrict__ delta,
                                               __nv_bfloat16* __restrict__ out, int H, int Hkv,
                                               int Tq, int Tk, int Tpad, float scale, int causal,
                                               int prefix) {
  using C = Dkv256;
  constexpr int kQ = C::kQ;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned char* basep = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sk = base, sv = base + C::kVOff, sq = base + C::kQOff;
  const uint32_t sdo = base + C::kDoOff, sl = base + C::kLOff;
  const uint32_t bars = base + C::kBarOff;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (C::kStages + s); };
  const uint32_t resident = bars + 8u * (2 * C::kStages);

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
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128);
    }
    mbar_init(resident, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: K (and for dK V) once, then Q, dO, L and Δ of each query
    // tile of each query head of the group
    if (threadIdx.x == 0) {
      mbar_expect_tx(resident, kDk ? 2 * C::kBig : C::kBig);
      for (int p = 0; p < C::kPanels; ++p) {
        const uint32_t off = p * C::kKeys * kRowBytes;
        tma_load_3d(sk + off, kmap, resident, p * kPanel, k0, bkv);
        if (kDk) tma_load_3d(sv + off, vmap, resident, p * kPanel, k0, bkv);
      }
      for (int it = 0; it < n_it; ++it) {
        const int g = it / per_head;
        const int q0 = (qt0 + it - g * per_head) * kQ;
        const int bh = b * H + kvh * G + g;
        const int s = it % C::kStages;
        mbar_wait(empty(s), ((it / C::kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), C::kStageTx);
        for (int p = 0; p < C::kPanels; ++p) {
          const uint32_t off = p * kQ * kRowBytes;
          tma_load_3d(sq + s * C::kTile + off, qmap, full(s), p * kPanel, q0, bh);
          tma_load_3d(sdo + s * C::kTile + off, domap, full(s), p * kPanel, q0, bh);
        }
        const long long at = static_cast<long long>(bh) * Tpad + q0;
        bulk_load(sl + s * C::kStatBytes, lse2 + at, kQ * 4, full(s));
        bulk_load(sl + s * C::kStatBytes + kQ * 4, delta + at, kQ * 4, full(s));
      }
    }
    return;
  }
  const int tid = threadIdx.x - 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int c2 = 2 * (lane % 4);
  const int key0 = k0 + 16 * warp + lane / 4;  // the thread's keys, and + 8
  const float c = scale * kLog2e;
  float acc[C::kD / 2], st[kQ / 2], dpt[kQ / 2];
#pragma unroll
  for (int i = 0; i < C::kD / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kQ / 2; ++i) st[i] = dpt[i] = 0.f;
  // pinned here: else ptxas may set them inside the first product's wgmma
  // pipeline stage and serialize the wgmmas (its note C7515)
  fence_regs(acc);
  fence_regs(st);
  fence_regs(dpt);
  mbar_wait(resident, 0);

  for (int it = 0; it < n_it; ++it) {
    const int g = it / per_head;
    const int q0 = (qt0 + it - g * per_head) * kQ;
    const int s = it % C::kStages;
    const uint32_t sqs = sq + s * C::kTile;
    const uint32_t sdos = sdo + s * C::kTile;
    const float* ls = reinterpret_cast<const float*>(basep + C::kLOff + s * C::kStatBytes);
    const float* dls = ls + kQ;
    mbar_wait(full(s), (it / C::kStages) & 1);
    wgmma_fence();
    issue_dot<C::kD, kQ>(st, sk, C::kKeys, sqs, kQ);                // Sᵀ = K Qᵀ
    if constexpr (kDk) issue_dot<C::kD, kQ>(dpt, sv, C::kKeys, sdos, kQ);  // dPᵀ = V dOᵀ
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // Pᵀ (dV) or dSᵀ = Pᵀ ∘ (dPᵀ − Δ) (dK) as the A fragments: element i is
    // key key0 + 8·((i >> 1) & 1) against query q0 + 8·(i / 4) + c2 + (i &
    // 1); causally a key past the query's last key, max(query, prefix −
    // 1), is 0
    const bool masked = causal && k0 + C::kKeys - 1 > max(q0, prefix - 1);
    uint32_t af[kQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * kk + 2 * j;
        const int col = 8 * (i / 4) + c2;
        const float2 lv = *reinterpret_cast<const float2*>(ls + col);
        float p0 = exp2f(fmaf(st[i], c, -lv.x));
        float p1 = exp2f(fmaf(st[i + 1], c, -lv.y));
        if (masked) {
          const int key = key0 + 8 * (j & 1);
          // a key below the prefix is seen by every query
          const int kc = key >= prefix ? key : -1;
          if (kc > q0 + col) p0 = 0.f;
          if (kc > q0 + col + 1) p1 = 0.f;
        }
        if constexpr (kDk) {
          const float2 dv2 = *reinterpret_cast<const float2*>(dls + col);
          af[kk][j] = pack_bf16(p0 * (dpt[i] - dv2.x), p1 * (dpt[i + 1] - dv2.y));
        } else {
          af[kk][j] = pack_bf16(p0, p1);
        }
      }
    }
    fence_regs(acc);
    fence_regs(af);
    wgmma_fence();
    issue_rs<C::kD, kQ>(acc, af, kDk ? sqs : sdos);  // dK += dSᵀ Q, or dV += Pᵀ dO
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty(s));
  }

  const float mul = kDk ? scale : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key < Tk) {
      __nv_bfloat16* row = out + (static_cast<long long>(bkv) * Tk + key) * C::kD;
#pragma unroll
      for (int g = 0; g < C::kD / 8; ++g)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * g + c2) =
            __floats2bfloat162_rn(acc[4 * g + 2 * r] * mul, acc[4 * g + 2 * r + 1] * mul);
    }
  }
}

// The dkdv kernel at (256, 256) (Dkv256): a block per (b·Hkv + kvh, tile of
// 64 keys, part), part 0 writing dK and part 1 dV.
__global__ void __launch_bounds__(Dkv256::kThreads, 1)
    flash_bwd_dkdv_d256_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap domap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const float* __restrict__ lse2, const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                               int H, int Hkv, int Tq, int Tk, int Tpad, float scale, int causal,
                               int prefix) {
  if (blockIdx.z == 0) {
    dkdv_d256_body<true>(&qmap, &domap, &kmap, &vmap, lse2, delta, dk, H, Hkv, Tq, Tk, Tpad,
                         scale, causal, prefix);
  } else {
    dkdv_d256_body<false>(&qmap, &domap, &kmap, &vmap, lse2, delta, dv, H, Hkv, Tq, Tk, Tpad,
                          scale, causal, prefix);
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

// The bf16 tensor [n, rows, D] at ptr as a 3-D TMA map (D, rows, n) with
// 64 x box_rows boxes, 128-byte swizzle and zero fill past the edges.
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int D, int rows,
              int n, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {kPanel, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int DV, bool kLseIn = false>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, void* dq, void* dk, void* dv, float* lse2,
                   float* delta, int B, int H, int Hkv, int Tq, int Tk, int causal, int prefix,
                   cudaStream_t stream) {
  using Q = DqCfg<D, DV>;
  // at (256, 256) the dkdv kernel of its own, by part (Dkv256)
  constexpr bool kD256 = D == 256;
  using K = std::conditional_t<kD256, Dkv256, DkvCfg<D, DV>>;
  constexpr int kKeys = K::kKeys;
  constexpr int kQ = K::kQ;
  constexpr int kKvThreads = kD256 ? Dkv256::kThreads : kThreadsWG;
  constexpr size_t kKvBytes = K::kBytes;
  auto dq_kernel = flash_bwd_dq_wgmma_kernel<D, DV, kLseIn>;
  auto dkv_kernel = [prefix] {
    if constexpr (kD256) {
      return flash_bwd_dkdv_d256_kernel;
    } else {
      return prefix > 0 ? flash_bwd_dkdv_wgmma_kernel<D, DV, true>
                        : flash_bwd_dkdv_wgmma_kernel<D, DV, false>;
    }
  }();
  cudaError_t err = repro::allow_smem(dq_kernel, Q::kBytes);
  if (err == cudaSuccess) err = repro::allow_smem(dkv_kernel, kKvBytes);
  if (err != cudaSuccess) return err;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // the dq kernel's maps: kRows-row Q, dO and O tiles, kN-row K and V tiles;
  // the dkdv kernel's: kKeys-row K and V tiles, kQ-row Q and dO tiles
  CUtensorMap q_m, do_m, o_m, k_n, v_n, q_n, do_n, k_m, v_m;
  if (!make_map(&q_m, encode, q, D, Tq, B * H, Q::kRows) ||
      !make_map(&do_m, encode, dout, DV, Tq, B * H, Q::kRows) ||
      !make_map(&o_m, encode, o, DV, Tq, B * H, Q::kRows) ||
      !make_map(&k_n, encode, k, D, Tk, B * Hkv, Q::kN) ||
      !make_map(&v_n, encode, v, DV, Tk, B * Hkv, Q::kN) ||
      !make_map(&q_n, encode, q, D, Tq, B * H, kQ) ||
      !make_map(&do_n, encode, dout, DV, Tq, B * H, kQ) ||
      !make_map(&k_m, encode, k, D, Tk, B * Hkv, kKeys) ||
      !make_map(&v_m, encode, v, DV, Tk, B * Hkv, kKeys))
    return cudaErrorInvalidValue;
  // the reference's 1.0 / (D ** 0.5), a double rounded to float
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  // every row of the scratch gets its L and Δ (blocks of kRows rows)
  const int Tpad = (Tq + kPadRows - 1) / kPadRows * kPadRows;
  const int n_qt = Tpad / Q::kRows;
  // (192, 128): a head's tiles on blockIdx.x (in flight together)
  constexpr bool kHeadMajor = head_major<D, DV>();
  const int n_kb = (Tk + kKeys - 1) / kKeys;
  const dim3 dq_grid = kHeadMajor ? dim3(n_qt, B * H) : dim3(B * H, n_qt);
  const dim3 dkv_grid = kD256 ? dim3(B * Hkv, n_kb, 2)
                        : kHeadMajor ? dim3(n_kb, B * Hkv) : dim3(B * Hkv, n_kb);
  dq_kernel<<<dq_grid, Q::kThreads, Q::kBytes, stream>>>(
      q_m, do_m, o_m, k_n, v_n, static_cast<__nv_bfloat16*>(dq), lse2, delta, H, Hkv, Tq,
      Tk, Tpad, scale, causal, prefix);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<dkv_grid, kKvThreads, kKvBytes, stream>>>(
      q_n, do_n, k_m, v_m, lse2, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Hkv, Tq, Tk, Tpad, scale, causal, prefix);
  return cudaGetLastError();
}

}  // namespace

// dQ, dK, dV of bf16 attention, (D, Dv) ∈ {(64, 64), (128, 128), (192,
// 128), (256, 256)}; every pointer 16-byte aligned, every tensor contiguous.
// lse2 and delta are float32 [B·H, Tpad], Tpad = Tq rounded up to 128 (the
// row logsumexp in base 2, and Δ), written by the first kernel and read by
// the second; with have_lse lse2 holds the forward's L already
// (flash_attention_wgmma.cu) and is only read.  Causal needs Tq == Tk; with
// prefix P > 0 (causal only) query i sees keys 0..max(i, P − 1), the
// prefix-LM mask.
extern "C" int repro_flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                               const void* o, const void* dout, void* dq,
                                               void* dk, void* dv, void* lse2, void* delta,
                                               int B, int H, int Hkv, int Tq, int Tk, int D,
                                               int Dv, int causal, int prefix, int have_lse,
                                               cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Tq <= 0 || Tk <= 0 ||
      (causal && Tq != Tk) || prefix < 0 || prefix > Tq || (prefix > 0 && !causal))
    return static_cast<int>(cudaErrorInvalidValue);
  float* l = static_cast<float*>(lse2);
  float* dl = static_cast<float*>(delta);
  cudaError_t err = cudaErrorInvalidValue;
  auto run = [&](auto fn) {
    err = fn(q, k, v, o, dout, dq, dk, dv, l, dl, B, H, Hkv, Tq, Tk, causal, prefix, stream);
  };
  if (D == 64 && Dv == 64)
    have_lse ? run(launch<64, 64, true>) : run(launch<64, 64>);
  else if (D == 128 && Dv == 128)
    have_lse ? run(launch<128, 128, true>) : run(launch<128, 128>);
  else if (D == 192 && Dv == 128)
    have_lse ? run(launch<192, 128, true>) : run(launch<192, 128>);
  else if (D == 256 && Dv == 256)
    have_lse ? run(launch<256, 256, true>) : run(launch<256, 256>);
  return static_cast<int>(err);
}

REPRO_DEFINE_ERROR_STRING(repro_flash_attention_bwd_wgmma)
