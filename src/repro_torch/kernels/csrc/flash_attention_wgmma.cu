// Causal flash attention on Hopper's tensor cores: o = softmax(q kᵀ / √D,
// causal) v for q [B, H, T, D], k [B, Hkv, Tk, D], v [B, Hkv, Tk, Dv] and
// o [B, H, T, Dv] in bfloat16, (D, Dv) ∈ {(64, 64), (128, 128), (192, 128),
// (256, 256)}, optionally under paligemma-3b's prefix-LM mask.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (Pallas
// body _kernel), the prefill attention of every layer of the GQA models
// and of deepseek-v3-671b's MLA (q and k of 128 + 64 columns, v of 128:
// the reference's flash_attention_jnp takes Dv ≠ D) and of paligemma-3b
// (head dim 256, a prefix of 256 patch positions), for bf16 at the head
// dims of every config the port builds.  float32 stays on
// flash_attention_tf32.cu, the reduced configs' head dims on
// flash_attention.cu.  It computes what the Pallas kernel computes: scores
// scaled by 1/√D and
// masked at -1e30, a running max and denominator in float32, the
// probabilities kept in float32 for the PV product (exactly, below), the
// denominator floored at 1e-30 and one rounding of the output to bf16.  GQA
// is by index (q-head h reads kv-head h / (H / Hkv)).
//
// Bound: operations.  At the LM path's prefill (B 4, H 32, T 1024, D 64)
// the causal half of QKᵀ and PV is 17.2 GFLOP, plus 17.2 GFLOP for PV's
// second and third terms (below), against 42 MB of q, k, v and o.
//
// Design.  One block of three warpgroups per (b·H + h, pair of tiles of 128
// query rows): the x-th heaviest causal tile and the x-th lightest, so every
// block does the same work and a block's start-up is paid once per pair.
// Warpgroup 0 is the producer: it gives its registers up (setmaxnreg) and
// one thread issues TMA loads, both Q tiles at once and K/V tiles of 128
// keys into a ring of stages that runs on from the first tile to the
// second, each stage signalled by an mbarrier with its byte count; the
// consumers free a stage through a second mbarrier.  Warpgroups 1 and 2
// each own 64 query rows.  (At (192, 128) the block is the two consumer
// warpgroups and one producer warp, 288 threads with no setmaxnreg: ptxas
// gives them the registers of 384 threads, 168, which that instance's
// consumers fit without spilling; below.)
// - S = Q Kᵀ with wgmma m64n128k16 from shared memory, both operands
//   K-major, float32 accumulators.  Products of bf16 are exact in float32,
//   so S is the Pallas kernel's float32 dot up to summation order.
// - Online softmax in registers: each row lies on the 4 threads of a quad
//   (the accumulator layout), so row max and sum take two shuffles.  The
//   running max is kept in raw scores and each probability is one FFMA
//   and exp2f: P = 2^(s·c − m·c) with c = log₂e / √D.
// - P stays float32: it is split in registers into three bf16 terms by
//   truncation, P_1 = P with the low 16 bits of its float32 cleared, P_2
//   the same of P − P_1 and P_3 = P − P_1 − P_2.  A float32 has 24
//   significant bits and each term takes 8 of them, so each difference is
//   exact and P_1 + P_2 + P_3 = P for P ≥ 2⁻¹⁰⁰ (below, bits under
//   float32's normal range, < 2⁻¹²⁶, are lost).  PV is three register-A wgmmas
//   (m64nDk16, V the MN-major operand, transpose bit set) into the same
//   float32 accumulator.  Two terms would leave up to 2⁻¹⁶·P (2⁻¹⁷·P
//   rounded), which on a row over few keys puts an output near zero
//   outside one bf16 rounding of the float64 result
//   (tests/test_torch_flash_wgmma.py).  The split triples PV's tensor-core
//   work (2× the kernel's flops).
// The accumulator layout of S is the register-A fragment layout of PV, so
// P never touches shared memory.  K/V are 3-D TMA tensors (D, Tk, B·Hkv):
// a tile past a head's last key is zero-filled, not read from the next
// head, and the keys past Tk and past the diagonal are masked in the last
// tile, the only one that has any; tiles wholly above the diagonal are not
// visited.  Rows past T load as zeros and are not stored, so any T works.
// (On the diagonal tile the first warpgroup's rows see none of the last 64
// keys; skipping that half by a branch around the wgmmas measured slower,
// as ptxas then serialises them.)
// Shared memory is 128-byte swizzled (TMA and wgmma descriptors agree),
// in 64-column panels (D / 64 of Q and K, Dv / 64 of V); 160 KB at D = 64
// (4 stages), 192 KB at D = 128 (2 stages), so one block holds an SM and
// setmaxnreg's pool is its own.  At (192, 128) a stage is 48 KB of K and
// 32 KB of V, and two Q tiles would be 96 KB: 256 KB with two stages, past
// the 227 KB a block can have.  There one Q tile stays resident (48 KB,
// 208 KB in all): the producer loads the second pass's Q once the
// consumers' last S product of the first pass has read the first
// (an mbarrier), and the 128-key tiles, the S wgmma (m64n128, D / 16 = 12
// k-steps) and the sizes of D = 128 stay as they are: P, PV and O are sized
// by Dv = 128.  At D 64/128 softmax and the tensor cores do not overlap
// within a warpgroup; the two consumer warpgroups overlap each other.  At
// (192, 128), whose S and three-term PV are the heaviest, the warpgroup
// makes P k-step by k-step (16 keys: the exponentials, the row sums, the
// three terms) and issues each step's three PV wgmmas as a commit group of
// its own, so the tensor cores take step kk while the terms of step kk + 1
// are made; the terms of two steps are held (24 registers, where the whole
// tile's 96 spilled), the third step waits for the first (wait_group 1);
// a third step's terms held measured no faster.
// With a pointer for it, the kernel also writes each row's logsumexp in
// base 2, L = m·c + log₂(max(l, 1e-30)) with c = log₂e / √D (the
// backward's definition), into float32 [B·H, T rounded up to 128], rows
// past T too (finite: their q rows load as zeros), so that the bf16
// backward need not compute it again (flash_attention_bwd_wgmma.cu); that
// is a second instance of the kernel at each pair, and without the pointer
// the first runs as before.
// Measured in turns on an H100 (tools/kernel_variants.py mla): 64-key tiles
// with both Q tiles resident and S(t) in flight during the softmax of t − 1
// were slower (m64n64 S wgmmas: twice the instructions a key), with or
// without the warpgroups taking turns on named barriers; so was S of the
// next tile issued behind this tile's PV.
//
// (256, 256), paligemma-3b, has a block of its own (D256, d256_body
// below): a consumer's O is 64 × 256 float32, 128 registers a thread, and
// two Q tiles of 128 rows with a stage of 128 keys would be 256 KB.
// The prefix-LM mask (prefix P > 0, causal, Tq == Tk): row r sees keys
// 0..max(r, P − 1), the reference's (k ≤ r) | (r < P & k < P).  A q tile
// visits the K/V tiles up to max(its last row, P − 1), and a tile past
// max(its first row, P − 1) is masked key by key; the heavy/light pairing
// of q tiles is unchanged (every tile is still some block's), only less
// even where a prefix makes the first tiles heavier.
//
// The tensor maps are encoded on the host for each call through
// cuTensorMapEncodeTiled, found with cudaGetDriverEntryPoint, so the
// library links no libcuda.
#include <cuda.h>
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

// Variants: 0 in the library; tools/kernel_variants.py builds the source
// with REPRO_VARIANT set to one of the cuts below, to time what each part of
// the (192, 128) and (256, 256) instances costs (the others ignore it).
#ifndef REPRO_VARIANT
#define REPRO_VARIANT 0
#endif

namespace {

constexpr int kVariant = REPRO_VARIANT;
constexpr int kNoPV = 1;        // S, the softmax and the split, no PV
constexpr int kOneTerm = 2;     // P as one bf16 term: no split
constexpr int kNoSoftmax = 3;   // P = S: no max, no exponentials
constexpr int kNoCompute = 4;   // the tiles staged, nothing computed
// (256, 256) only: the instance with L also writes clock64 stamps of block
// (0, 0)'s consumers past L's rows in lse2 (D256::kStampTiles tiles ×
// kStampPoints points a consumer, unsigned 64-bit), to time a tile's parts
constexpr int kStamps = 5;

constexpr int kBlockQ = 128;     // query rows of a block, 64 per consumer
constexpr int kPanel = 64;       // bf16 columns of one 128-byte swizzled panel
constexpr int kRowBytes = 128;   // bytes of one row of a panel
constexpr int kThreadsWG = 384;  // producer warpgroup + two consumer warpgroups
// (192, 128): the two consumer warpgroups (warps 0-7) and one producer warp
// (warp 8), no setmaxnreg
constexpr int kThreadsMla = 288;
constexpr int kTerms = 3;        // bf16 terms of P in the PV product
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// (D, Dv) ∈ {(64, 64), (128, 128), (192, 128)}; (256, 256) is D256's
template <int D, int DV>
struct Cfg {
  static constexpr int kBlockK = 128;  // keys of a K/V tile
  static constexpr int kThreads = D == 192 ? kThreadsMla : kThreadsWG;
  // P made and its PV wgmmas issued k-step by k-step (below)
  static constexpr bool kStepwise = D == 192;
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kPanels = D / kPanel;          // of Q and K
  static constexpr int kVPanels = DV / kPanel;        // of V
  static constexpr int kQTiles = D == 192 ? 1 : 2;    // resident Q tiles
  static constexpr int kQBytes = kBlockQ * D * 2;     // one Q tile
  static constexpr int kKBytes = kBlockK * D * 2;     // one K tile
  static constexpr int kVBytes = kBlockK * DV * 2;    // one V tile
  static constexpr int kKOff = kQTiles * kQBytes;     // after the Q tiles
  static constexpr int kVOff = kKOff + kStages * kKBytes;
  static constexpr int kBarOff = kVOff + kStages * kVBytes;
  // barriers: full[kStages], empty[kStages], q[2], q_free; then slack to
  // align the dynamic shared memory to 1024 bytes (the swizzle's repeat)
  static constexpr size_t kBytes = kBarOff + (2 * kStages + 3) * 8 + 1024;
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
template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N][4]) {
#pragma unroll
  for (int a = 0; a < M; ++a)
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[a][i][j])::"memory");
}
// The same for the fragments r[.][i] of one k-step.
template <int M, int N>
__device__ __forceinline__ void fence_step(uint32_t (&r)[M][N][4], int i) {
#pragma unroll
  for (int a = 0; a < M; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[a][i][j])::"memory");
}

// d[64] (+)= A[64 x 16] · B[16 x 128], A and B K-major in shared memory;
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
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

template <int DV>
__device__ __forceinline__ void wgmma_pv(float (&o)[DV / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DV == 64) {
    wgmma_rs_n64(o, a, db);
  } else {
    wgmma_rs_n128(o, a, db);
  }
}

using repro::bf16x2_high;

// K/V tiles of `block_k` keys that q tile qt visits: all of them, or
// causally those up to the last key its last row sees (with a prefix of P
// rows, row r sees keys 0..max(r, P − 1)).
__device__ __forceinline__ int kv_tiles(int qt, int Tq, int Tk, int causal, int prefix,
                                        int block_k) {
  const int n = (Tk + block_k - 1) / block_k;
  const int last = max(min((qt + 1) * kBlockQ, Tq) - 1, prefix - 1);
  return causal ? min(n, last / block_k + 1) : n;
}

// (at (256, 256) an explicit specialization below, whose block is D256's)
template <int D, int DV, bool kLse = false>
__global__ void __launch_bounds__(D == 192 ? kThreadsMla : kThreadsWG, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                                 const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap,
                                 __nv_bfloat16* __restrict__ o, int H, int Hkv, int Tq,
                                 int Tk, float scale_log2, int causal, int prefix,
                                 float* __restrict__ lse2) {
  // scale_log2 = log₂e / √D: P = exp2(s·scale_log2 − m·scale_log2)
  using C = Cfg<D, DV>;
  constexpr int kBlockK = C::kBlockK;
  // (192, 128) builds each k-step's terms just before its PV wgmmas
  // (below); the variants cut the (192, 128) instance only here
  constexpr bool kMla = D == 192;
  constexpr int kV = kMla ? kVariant : 0;
  constexpr int kT = kV == kOneTerm ? 1 : kTerms;  // bf16 terms of P
  constexpr bool kSoftmax = kV != kNoSoftmax;
  constexpr int kRing = 2;  // k-steps whose P terms are held
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + C::kKOff, sv = base + C::kVOff;
  const uint32_t bars = base + C::kBarOff;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (C::kStages + s); };
  auto qbar = [&](int pass) { return bars + 8u * (2 * C::kStages + pass); };
  const uint32_t q_free = bars + 8u * (2 * C::kStages + 2);  // one Q tile: read

  // The block's q tiles: the x-th heaviest and the x-th lightest, so that
  // causally every block visits n + 1 K/V tiles (n q tiles a head), and K/V
  // stream through one ring across both.
  const int n_qt = (Tq + kBlockQ - 1) / kBlockQ;
  const int qt_heavy = n_qt - 1 - blockIdx.x;
  const int qt_light = blockIdx.x;
  const int n_pass = qt_light < qt_heavy ? 2 : 1;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = b * Hkv + h / (H / Hkv);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);  // every consumer thread releases a stage
    }
    mbar_init(qbar(0), 1);
    mbar_init(qbar(1), 1);
    mbar_init(q_free, 2 * 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the producer: warpgroup 0, or at (192, 128) warp 8
  if (kMla ? threadIdx.x >= 256 : threadIdx.x < 128) {
    // producer: one thread loads the Q tiles (both at once where two are
    // resident, else the second once the first is read), then keeps the
    // K/V ring full
    if constexpr (!kMla) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == (kMla ? 256 : 0)) {
      auto load_q = [&](int pass) {
        const int q0 = (pass == 0 ? qt_heavy : qt_light) * kBlockQ;
        const uint32_t dst = sq + (pass % C::kQTiles) * C::kQBytes;
        mbar_expect_tx(qbar(pass), C::kQBytes);
        for (int p = 0; p < C::kPanels; ++p)
          tma_load_3d(dst + p * kBlockQ * kRowBytes, &qmap, qbar(pass), p * kPanel, q0, bh);
      };
      for (int pass = 0; pass < n_pass && pass < C::kQTiles; ++pass) load_q(pass);
      int it = 0;  // K/V tiles loaded so far, over both passes
      for (int pass = 0; pass < n_pass; ++pass) {
        if (pass > 0 && C::kQTiles == 1) {
          mbar_wait(q_free, 0);
          load_q(pass);
        }
        const int n_tiles =
            kv_tiles(pass == 0 ? qt_heavy : qt_light, Tq, Tk, causal, prefix, kBlockK);
        for (int t = 0; t < n_tiles; ++t, ++it) {
          const int s = it % C::kStages;
          mbar_wait(empty(s), ((it / C::kStages) & 1) ^ 1);
          mbar_expect_tx(full(s), C::kKBytes + C::kVBytes);
          for (int p = 0; p < C::kPanels; ++p)
            tma_load_3d(sk + s * C::kKBytes + p * kBlockK * kRowBytes, &kmap, full(s),
                        p * kPanel, t * kBlockK, kvh);
          for (int p = 0; p < C::kVPanels; ++p)
            tma_load_3d(sv + s * C::kVBytes + p * kBlockK * kRowBytes, &vmap, full(s),
                        p * kPanel, t * kBlockK, kvh);
        }
      }
    }
  } else {
    if constexpr (!kMla) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = threadIdx.x / 128 - (kMla ? 0 : 1);  // consumer: query rows 64·cw ..
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int c2 = 2 * (lane % 4);  // first column of each 8-column group
    // Accumulator layout (m64nN, float32): element i of a thread lies in
    // row r0 + 8·((i >> 1) & 1), column 8·(i / 4) + c2 + (i & 1).
    float acc[DV / 2], sc[kBlockK / 2];
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) sc[i] = 0.f;
    int it = 0;  // K/V tiles consumed so far, over both passes

    for (int pass = 0; pass < n_pass; ++pass) {
      const int q0 = (pass == 0 ? qt_heavy : qt_light) * kBlockQ;
      const int n_tiles = kv_tiles(q0 / kBlockQ, Tq, Tk, causal, prefix, kBlockK);
      const int r0 = q0 + 64 * cw + 16 * warp + lane / 4;  // rows r0 and r0 + 8
      const uint32_t sq_wg = sq + (pass % C::kQTiles) * C::kQBytes + cw * 64 * kRowBytes;
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
      float m[2] = {kNegInf, kNegInf};
      float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

      mbar_wait(qbar(pass), 0);
      for (int t = 0; t < n_tiles; ++t, ++it) {
        const int s = it % C::kStages;
        mbar_wait(full(s), (it / C::kStages) & 1);
        if (kV == kNoCompute) {
          if (C::kQTiles == 1 && n_pass == 2 && pass == 0 && t == n_tiles - 1)
            mbar_arrive(q_free);
          mbar_arrive(empty(s));
          continue;
        }

        // S = Q Kᵀ: D / 16 steps of 16 columns (32 bytes) along each panel
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          const uint64_t da =
              smem_desc(sq_wg + (kk / 4) * kBlockQ * kRowBytes + off, 16, 1024);
          const uint64_t db = smem_desc(
              sk + s * C::kKBytes + (kk / 4) * kBlockK * kRowBytes + off, 16, 1024);
          wgmma_ss_n128(sc, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        // one resident Q tile: the last S product of the first pass has
        // read it, so the producer may load the second pass's
        if (C::kQTiles == 1 && n_pass == 2 && pass == 0 && t == n_tiles - 1)
          mbar_arrive(q_free);

        // online softmax over the tile; masked scores are -1e30 (row r sees
        // keys up to max(r, prefix − 1)).  The last tile is the only one
        // with masked keys (the tiles up to it end before the first row's
        // own key or before key prefix − 1).
        const int k0 = t * kBlockK;
        if (t == n_tiles - 1) {
          const int last[2] = {max(r0, prefix - 1), max(r0 + 8, prefix - 1)};
#pragma unroll
          for (int i = 0; i < kBlockK / 2; ++i) {
            const int key = k0 + 8 * (i / 4) + c2 + (i & 1);
            if (key >= Tk || (causal && key > last[(i >> 1) & 1])) sc[i] = kNegInf;
          }
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; kSoftmax && i < kBlockK / 2; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        float alpha[2], mc[2];
#pragma unroll
        for (int r = 0; kSoftmax && r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = exp2f((m[r] - mx[r]) * scale_log2);
          m[r] = mx[r];
          mc[r] = mx[r] * scale_log2;
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; kSoftmax && i < DV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

        if constexpr (C::kStepwise) {
          // k-step by k-step: the step's probabilities, their sums and
          // terms, then its PV wgmmas, a commit group each, so the tensor
          // cores take step kk while the terms of step kk + 1 are made.  The
          // terms of kRing steps are held (pr[.][kk % kRing]): step kk waits
          // until step kk − kRing is done (wait_group kRing − 1) before it
          // overwrites them.
          uint32_t pr[kT][kRing][4];
          fence_regs(acc);
#pragma unroll
          for (int kk = 0; kk < kBlockK / 16; ++kk) {
            if (kk >= kRing) {
              wgmma_wait<kRing - 1>();
              fence_step(pr, kk % kRing);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int i = 8 * kk + 2 * j;
              float r0v = kSoftmax ? exp2f(fmaf(sc[i], scale_log2, -mc[j & 1])) : sc[i];
              float r1v = kSoftmax ? exp2f(fmaf(sc[i + 1], scale_log2, -mc[j & 1])) : sc[i + 1];
              l[j & 1] += r0v + r1v;
#pragma unroll
              for (int a = 0; a < kT; ++a) {
                const uint32_t b0 = __float_as_uint(r0v), b1 = __float_as_uint(r1v);
                pr[a][kk % kRing][j] = bf16x2_high(b0, b1);
                r0v -= __uint_as_float(b0 & 0xffff0000u);  // exact
                r1v -= __uint_as_float(b1 & 0xffff0000u);
              }
            }
            fence_step(pr, kk % kRing);
            wgmma_fence();
            const uint64_t db = smem_desc(sv + s * C::kVBytes + kk * 16 * kRowBytes,
                                          kBlockK * kRowBytes, 1024);
#pragma unroll
            for (int a = 0; a < (kV == kNoPV ? 0 : kT); ++a) wgmma_pv<DV>(acc, pr[a][kk % kRing], db);
            wgmma_commit();
          }
          wgmma_wait_all();
          fence_regs(acc);
          fence_regs(pr);
          mbar_arrive(empty(s));
          continue;
        }

        // P in three bf16 terms, already in PV's register-A fragment layout:
        // fragment j of k-step kk holds elements 8kk + 2j, 8kk + 2j + 1
        uint32_t pt[kTerms][kBlockK / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBlockK / 16; ++kk) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = 8 * kk + 2 * j;
            float r0v = exp2f(fmaf(sc[i], scale_log2, -mc[j & 1]));
            float r1v = exp2f(fmaf(sc[i + 1], scale_log2, -mc[j & 1]));
            l[j & 1] += r0v + r1v;
#pragma unroll
            for (int a = 0; a < kTerms; ++a) {
              const uint32_t b0 = __float_as_uint(r0v), b1 = __float_as_uint(r1v);
              pt[a][kk][j] = bf16x2_high(b0, b1);
              r0v -= __uint_as_float(b0 & 0xffff0000u);  // exact
              r1v -= __uint_as_float(b1 & 0xffff0000u);
            }
          }
        }

        // O += Σ P_a V: 16 keys (two 1024-byte swizzle atoms) a step; the
        // leading byte offset steps between the 64-column panels of V
        fence_regs(acc);
        fence_regs(pt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockK / 16; ++kk) {
          const uint64_t db = smem_desc(sv + s * C::kVBytes + kk * 16 * kRowBytes,
                                        kBlockK * kRowBytes, 1024);
#pragma unroll
          for (int a = 0; a < kTerms; ++a) wgmma_pv<DV>(acc, pt[a][kk], db);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        mbar_arrive(empty(s));
      }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = fmaxf(l[r], 1e-30f);
      }
      if constexpr (kLse) {  // every row of the tile: [B·H, n_qt · 128]
        if (lane % 4 == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            lse2[static_cast<long long>(bh) * n_qt * kBlockQ + r0 + 8 * r] =
                m[r] * scale_log2 + log2f(l[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row < Tq) {
          __nv_bfloat16* orow = o + (static_cast<long long>(bh) * Tq + row) * DV;
#pragma unroll
          for (int g = 0; g < DV / 8; ++g) {
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * g + c2) = __floats2bfloat162_rn(
                acc[4 * g + 2 * r] / l[r], acc[4 * g + 2 * r + 1] / l[r]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (256, 256): paligemma-3b's head dim, a block layout of its own
// ---------------------------------------------------------------------------
// A consumer warpgroup holds one unit's O (64 × 256 float32: 128 registers a
// thread), S of a 64-key tile (32) and the P terms of two k-steps (24).
// The block is a producer warpgroup and two consumer warpgroups, 384
// threads; the roles branch on a warpgroup index that a shuffle from lane 0
// makes warp-uniform, and setmaxnreg gives the producer 24 registers a
// thread and the consumers 240: 24·128 + 240·256 = 64,512, the 168 a thread
// that the launch gives 384 threads (setmaxnreg.inc takes only what a .dec
// of the same block gave up: 32 for the producer hung the consumers).
// - Units and grid.  A unit is 64 query rows of one q head.  The units of a
//   KV head are u = g·n + i over its G = H / Hkv q heads g and n = 2·⌈T /
//   128⌉ q tiles i (L's rows: a unit past T still writes L, and without L
//   its stores are skipped).  Block x of KV head y takes units x and G·n −
//   1 − x, a light one and a heavy one: causally their K/V tiles of 64 keys
//   add up to about n + 1, so the blocks do like work, and there are G·n / 2
//   of them a KV head (96 at paligemma-3b's prefill of 4 × 384, 128 at 1 ×
//   2048).
// - The two consumers.  Consumer h runs the heavy unit (nh tiles), consumer
//   l the light one (nl ≤ nh tiles); tiles 0..nl − 1 are both units', so one
//   load feeds both, and past them h runs on alone.  Each unit is computed
//   whole by one consumer, every row's products and sums in the order of
//   the 128-row layout before it, so o is the same with and without L.
// - Shared memory, six 32 KB buffers: the two units' Q, two K slots and two
//   V slots (192 KB).  Tile t takes K slot t % 2 and V slot t % 2; each
//   consumer frees a slot on a barrier of its own (one arrival a warp), and
//   the slot's next load waits for h, and for l where l read the tile.
//   Producer lane b serves slot b (K0, K1, V0, V1), so no K load waits on a
//   V slot.
// - A consumer issues S(t + 1) right behind the PV wgmmas of tile t, so
//   its tensor work runs on from PV(t) into S(t + 1); it stops only for
//   the softmax's head of tile t + 1 (the mask, the row max, O rescaled),
//   which the other consumer's wgmmas fill.  P is made k-step by k-step as
//   at (192, 128): the step's exponentials, row sums and three terms, then
//   its three m64n256k16 PV wgmmas as a commit group, the terms of two
//   steps held.
// What bounds it (clock stamps of the kStamps cut on an H100): a tile's
// tensor work (S once, PV three times) is 2,048 cycles; two consumers
// together took about 5,200 cycles for their two tiles, one alone about
// 2,850 a tile.  At 1 × 2048 the heavy unit runs 28 of its 32 tiles alone,
// so a block's time is mostly the heavy unit's.
struct D256 {
  static constexpr int kD = 256;
  static constexpr int kRows = 64;      // query rows of a unit
  static constexpr int kBlockK = 64;    // keys of a K/V tile
  static constexpr int kThreads = 384;  // producer warpgroup + two consumers
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
  static constexpr int kPanels = kD / kPanel;  // of Q, K and V
  static constexpr int kTile = kRows * kD * 2;  // bytes of a Q, K or V tile (all 64 rows)
  // buffers of a tile: Q_h, Q_l, K0, K1, V0, V1
  static constexpr int kKOff = 2 * kTile;
  static constexpr int kBarOff = kKOff + 4 * kTile;
  // barriers: q[2] (heavy, light), full[4] (K0, K1, V0, V1), empty[2][4]
  // (of h, of l); then slack to align the dynamic shared memory to 1024
  // bytes
  static constexpr int kBars = 2 + 4 + 2 * 4;
  static constexpr size_t kBytes = kBarOff + kBars * 8 + 1024;
  static_assert(kBytes <= 232448, "more shared memory than a block can have");
  // kStamps: tiles stamped a consumer (the last row: start, loop end,
  // end) and points a tile
  static constexpr int kStampTiles = 64;
  static constexpr int kStampPoints = 6;
};

// 64-row q tiles of a head: those of T rounded up to 128 (L's rows)
__host__ __device__ __forceinline__ int d256_q_tiles(int Tq) { return 2 * ((Tq + 127) / 128); }

// The launch's grid: a block a pair of units, G·n / 2 a KV head
__host__ __forceinline__ dim3 d256_grid(int B, int H, int Hkv, int Tq) {
  return dim3(H / Hkv * d256_q_tiles(Tq) / 2, B * Hkv);
}

// K/V tiles of 64 keys that q tile i (64 rows) visits: all of them, or
// causally those up to the last key its last row sees
__device__ __forceinline__ int d256_kv_tiles(int i, int Tq, int Tk, int causal, int prefix) {
  constexpr int kK = D256::kBlockK;
  const int n = (Tk + kK - 1) / kK;
  const int last = max(min((i + 1) * D256::kRows, Tq) - 1, prefix - 1);
  return causal ? min(n, last / kK + 1) : n;
}

// S = Q Kᵀ over one K tile of 64 keys (D / 16 k-steps), one commit group
// The descriptors are a base's, plus each step's start in 16-byte units
// (the address field, 14 bits, does not carry), made afresh each call so
// that no 64-bit base is held across the tile loop beside O.
__device__ __forceinline__ void d256_s(float (&sc)[32], uint32_t sq_wg, uint32_t sk_s) {
  asm volatile("" : "+r"(sq_wg), "+r"(sk_s));
  const uint64_t da0 = smem_desc(sq_wg, 16, 1024), db0 = smem_desc(sk_s, 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D256::kD / 16; ++kk) {
    // 64 rows of 128 bytes a panel of Q and of K, 32 bytes a step in it
    const uint64_t step = ((kk / 4) * D256::kRows * kRowBytes + (kk % 4) * 32) >> 4;
    wgmma_ss_n64(sc, da0 + step, db0 + step, kk > 0);
  }
  wgmma_commit();
}

template <bool kLse>
__device__ __forceinline__ void d256_body(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                          const CUtensorMap* vmap,
                                          __nv_bfloat16* __restrict__ o, int H, int Hkv,
                                          int Tq, int Tk, float scale_log2, int causal,
                                          int prefix, float* __restrict__ lse2) {
  using C = D256;
  constexpr int kK = C::kBlockK;
  constexpr int kT = kVariant == kOneTerm ? 1 : kTerms;  // bf16 terms of P
  constexpr bool kSoftmax = kVariant != kNoSoftmax;
  constexpr int kRing = 2;  // k-steps whose P terms are held
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, bars = base + C::kBarOff;
  // slot b: 0, 1 K slots; 2, 3 V slots; consumer c 0: h, 1: l
  auto slot = [&](int i) { return base + C::kKOff + i * C::kTile; };
  auto qbar = [&](int light) { return bars + 8u * light; };
  auto full = [&](int b) { return bars + 8u * (2 + b); };
  auto empty = [&](int c, int b) { return bars + 8u * (6 + 4 * c + b); };

  // the block's units (above): ua < ub
  const int n = d256_q_tiles(Tq);
  const int ua = blockIdx.x;
  const int ub = H / Hkv * n - 1 - blockIdx.x;
  const int bkv = blockIdx.y;                   // b·Hkv + KV head
  const int b = bkv / Hkv;
  const int head0 = b * H + (bkv - b * Hkv) * (H / Hkv);  // unit u's q head: head0 + u / n
  const int na = d256_kv_tiles(ua % n, Tq, Tk, causal, prefix);
  const int nb = d256_kv_tiles(ub % n, Tq, Tk, causal, prefix);
  const bool a_light = na <= nb;
  const int u_h = a_light ? ub : ua, u_l = a_light ? ua : ub;
  const int nh = max(na, nb), nl = min(na, nb);

  if (threadIdx.x == 0) {
    mbar_init(qbar(0), 1);
    mbar_init(qbar(1), 1);
    for (int i = 0; i < 4; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(0, i), 4);  // a warp each
      mbar_init(empty(1, i), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer: thread 0 loads both units' Q; then thread b serves slot b,
    // its x-th load tile 2x + b % 2, each load once the consumers of the
    // slot's last tile freed it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    if (threadIdx.x == 0) {
      for (int light = 0; light < 2; ++light) {
        const int u = light ? u_l : u_h;
        mbar_expect_tx(qbar(light), C::kTile);
        for (int p = 0; p < C::kPanels; ++p)
          tma_load_3d(sq + light * C::kTile + p * C::kRows * kRowBytes, qmap, qbar(light),
                      p * kPanel, (u % n) * C::kRows, head0 + u / n);
      }
    }
    const int bf = threadIdx.x;
    if (bf < 4) {
      for (int x = 0, t = bf & 1; t < nh; ++x, t += 2) {
        if (x > 0) {  // tile t − 2: h's, and l's where it is one of l's tiles
          mbar_wait(empty(0, bf), (x - 1) & 1);
          if (t - 2 < nl) mbar_wait(empty(1, bf), (x - 1) & 1);
        }
        mbar_expect_tx(full(bf), C::kTile);
        for (int p = 0; p < C::kPanels; ++p)
          tma_load_3d(slot(bf) + p * kK * kRowBytes, bf < 2 ? kmap : vmap, full(bf),
                      p * kPanel, t * kK, bkv);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
  const int w = wg - 1;  // 0: h, 1: l
  const bool light = w == 1;
  const int u = light ? u_l : u_h;
  const int nt = light ? nl : nh;
  // nt is never 0; but without a branch out right past setmaxnreg.inc
  // ptxas held this code to the launch's 168 registers and spilled
  if (nt == 0) return;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int c2 = 2 * (lane % 4);  // first column of each 8-column group
  const int bh = head0 + u / n;
  const int q0 = (u % n) * C::kRows;
  const int r0 = q0 + 16 * warp + lane / 4;  // rows r0 and r0 + 8
  const uint32_t sq_wg = sq + (light ? C::kTile : 0);
  // Accumulator layout (m64nN, float32): element i of a thread lies in
  // row r0 + 8·((i >> 1) & 1), column 8·(i / 4) + c2 + (i & 1).
  float acc[C::kD / 2], sc[kK / 2];
  uint32_t pr[kT][kRing][4];  // P's terms of kRing k-steps (below)
  // kStamps: block (0, 0)'s consumer thread 0 stamps its tiles past L's
  // B·H·n·64 rows
  unsigned long long* stamps =
      kVariant == kStamps && kLse && blockIdx.x == 0 && blockIdx.y == 0 && tid == 0
          ? reinterpret_cast<unsigned long long*>(
                lse2 + static_cast<long long>(gridDim.y / Hkv) * H * n * C::kRows) +
                w * C::kStampTiles * C::kStampPoints
          : nullptr;
  auto stamp = [&](int row, int point) {
    if (kVariant == kStamps && stamps != nullptr && row < C::kStampTiles)
      stamps[row * C::kStampPoints + point] = clock64();
  };
  auto release = [&](uint32_t bar) {
    if (lane == 0) mbar_arrive(bar);
  };
  stamp(C::kStampTiles - 1, 0);
#pragma unroll
  for (int i = 0; i < C::kD / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kK / 2; ++i) sc[i] = 0.f;
  // pinned here: else ptxas set them inside the first S's wgmma pipeline
  // stage and serialized the kernel's wgmmas (its note C7515)
  fence_regs(acc);
  fence_regs(sc);
  float m_r[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  mbar_wait(qbar(light), 0);
  if (kVariant == kNoCompute) {
    for (int t = 0; t < nt; ++t) {
      mbar_wait(full(t & 1), (t >> 1) & 1);
      release(empty(w, t & 1));
      mbar_wait(full(2 + (t & 1)), (t >> 1) & 1);
      release(empty(w, 2 + (t & 1)));
    }
  } else {
    mbar_wait(full(0), 0);
    d256_s(sc, sq_wg, slot(0));
    for (int t = 0; t < nt; ++t) {
      const int st = min(t, C::kStampTiles - 2);
      // S(t) and PV(t − 1) are done: K(t) and V(t − 1) are read
      stamp(st, 0);
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(acc);
      fence_regs(pr);
      stamp(st, 1);
      release(empty(w, t & 1));
      if (t > 0) release(empty(w, 2 + ((t - 1) & 1)));

      // online softmax over the tile; masked scores are -1e30 (row r sees
      // keys up to max(r, prefix − 1)): every tile past the first row's
      // last key, or past Tk, has some
      const int k0 = t * kK;
      if (k0 + kK > Tk || (causal && k0 + kK - 1 > max(q0, prefix - 1))) {
        const int last[2] = {max(r0, prefix - 1), max(r0 + 8, prefix - 1)};
#pragma unroll
        for (int i = 0; i < kK / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + c2 + (i & 1);
          if (key >= Tk || (causal && key > last[(i >> 1) & 1])) sc[i] = kNegInf;
        }
      }
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int i = 0; kSoftmax && i < kK / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2], mc[2];
#pragma unroll
      for (int r = 0; kSoftmax && r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f((m_r[r] - mx[r]) * scale_log2);
        m_r[r] = mx[r];
        mc[r] = mx[r] * scale_log2;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; kSoftmax && i < C::kD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      stamp(st, 2);

      // k-step by k-step: the step's probabilities, their sums and terms,
      // then its PV wgmmas, a commit group each; step kk waits until step
      // kk − kRing is done (wait_group kRing − 1) before it overwrites
      // its terms
      mbar_wait(full(2 + (t & 1)), (t >> 1) & 1);
      stamp(st, 3);
      const uint64_t dv = smem_desc(slot(2 + (t & 1)), kK * kRowBytes, 1024);
#pragma unroll
      for (int kk = 0; kk < kK / 16; ++kk) {
        if (kk >= kRing) {
          wgmma_wait<kRing - 1>();
          fence_step(pr, kk % kRing);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 2 * j;
          float r0v = kSoftmax ? exp2f(fmaf(sc[i], scale_log2, -mc[j & 1])) : sc[i];
          float r1v = kSoftmax ? exp2f(fmaf(sc[i + 1], scale_log2, -mc[j & 1])) : sc[i + 1];
          l[j & 1] += r0v + r1v;
#pragma unroll
          for (int a = 0; a < kT; ++a) {
            const uint32_t b0 = __float_as_uint(r0v), b1 = __float_as_uint(r1v);
            pr[a][kk % kRing][j] = bf16x2_high(b0, b1);
            r0v -= __uint_as_float(b0 & 0xffff0000u);  // exact
            r1v -= __uint_as_float(b1 & 0xffff0000u);
          }
        }
        fence_step(pr, kk % kRing);
        wgmma_fence();
        // O += Σ P_a V: 16 keys (two 1024-byte swizzle atoms, 2048 bytes:
        // 128 in the descriptor's address field) a step; the leading byte
        // offset steps between the 64-column panels of V
#pragma unroll
        for (int a = 0; a < (kVariant == kNoPV ? 0 : kT); ++a)
          wgmma_rs_n256(acc, pr[a][kk % kRing], dv + kk * 16 * kRowBytes / 16);
        wgmma_commit();
      }
      stamp(st, 4);
      // S(t + 1) behind PV(t): every score of tile t is read
      if (t + 1 < nt) {
        mbar_wait(full((t + 1) & 1), ((t + 1) >> 1) & 1);
        fence_regs(sc);
        d256_s(sc, sq_wg, slot((t + 1) & 1));
      }
      stamp(st, 5);
    }
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(pr);
    release(empty(w, 2 + ((nt - 1) & 1)));
  }
  stamp(C::kStampTiles - 1, 1);

#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the rows' sums, on every thread of the quad
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  if constexpr (kLse) {  // every row of the unit: [B·H, n · 64]
    if (lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        lse2[static_cast<long long>(bh) * n * C::kRows + r0 + 8 * r] =
            m_r[r] * scale_log2 + log2f(l[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row < Tq) {
      __nv_bfloat16* orow = o + (static_cast<long long>(bh) * Tq + row) * C::kD;
#pragma unroll
      for (int g = 0; g < C::kD / 8; ++g)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * g + c2) = __floats2bfloat162_rn(
            acc[4 * g + 2 * r] / l[r], acc[4 * g + 2 * r + 1] / l[r]);
    }
  }
  stamp(C::kStampTiles - 1, 2);
}

template <>
__global__ void __launch_bounds__(D256::kThreads, 1)
    flash_attention_wgmma_kernel<256, 256, false>(const __grid_constant__ CUtensorMap qmap,
                                                  const __grid_constant__ CUtensorMap kmap,
                                                  const __grid_constant__ CUtensorMap vmap,
                                                  __nv_bfloat16* __restrict__ o, int H, int Hkv,
                                                  int Tq, int Tk, float scale_log2, int causal,
                                                  int prefix, float* __restrict__ lse2) {
  d256_body<false>(&qmap, &kmap, &vmap, o, H, Hkv, Tq, Tk, scale_log2, causal, prefix, lse2);
}

template <>
__global__ void __launch_bounds__(D256::kThreads, 1)
    flash_attention_wgmma_kernel<256, 256, true>(const __grid_constant__ CUtensorMap qmap,
                                                 const __grid_constant__ CUtensorMap kmap,
                                                 const __grid_constant__ CUtensorMap vmap,
                                                 __nv_bfloat16* __restrict__ o, int H, int Hkv,
                                                 int Tq, int Tk, float scale_log2, int causal,
                                                 int prefix, float* __restrict__ lse2) {
  d256_body<true>(&qmap, &kmap, &vmap, o, H, Hkv, Tq, Tk, scale_log2, causal, prefix, lse2);
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

template <int D, int DV, bool kLse = false>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse2, int B,
                   int H, int Hkv, int Tq, int Tk, int causal, int prefix,
                   cudaStream_t stream) {
  using C = Cfg<D, DV>;
  auto kernel = flash_attention_wgmma_kernel<D, DV, kLse>;
  const size_t bytes = C::kBytes;
  cudaError_t err = repro::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(&qmap, encode, q, D, Tq, B * H, kBlockQ) ||
      !make_map(&kmap, encode, k, D, Tk, B * Hkv, C::kBlockK) ||
      !make_map(&vmap, encode, v, DV, Tk, B * Hkv, C::kBlockK))
    return cudaErrorInvalidValue;
  // the reference's 1.0 / (D ** 0.5), a double rounded to float, in log₂ units
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const dim3 grid(((Tq + kBlockQ - 1) / kBlockQ + 1) / 2, B * H);  // two q tiles a block
  kernel<<<grid, C::kThreads, bytes, stream>>>(qmap, kmap, vmap,
                                               static_cast<__nv_bfloat16*>(o), H, Hkv, Tq,
                                               Tk, scale * kLog2e, causal, prefix, lse2);
  return cudaGetLastError();
}

// (256, 256): D256's block, 64-row Q boxes, a block a pair of units
template <bool kLse>
cudaError_t launch_d256(const void* q, const void* k, const void* v, void* o, float* lse2,
                        int B, int H, int Hkv, int Tq, int Tk, int causal, int prefix,
                        cudaStream_t stream) {
  using C = D256;
  auto kernel = flash_attention_wgmma_kernel<256, 256, kLse>;
  cudaError_t err = repro::allow_smem(kernel, C::kBytes);
  if (err != cudaSuccess) return err;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(&qmap, encode, q, C::kD, Tq, B * H, C::kRows) ||
      !make_map(&kmap, encode, k, C::kD, Tk, B * Hkv, C::kBlockK) ||
      !make_map(&vmap, encode, v, C::kD, Tk, B * Hkv, C::kBlockK))
    return cudaErrorInvalidValue;
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(C::kD)));
  kernel<<<d256_grid(B, H, Hkv, Tq), C::kThreads, C::kBytes, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), H, Hkv, Tq, Tk, scale * kLog2e, causal,
      prefix, lse2);
  return cudaGetLastError();
}

}  // namespace

// o [B, H, Tq, Dv] = attention of q [B, H, Tq, D] over k [B, Hkv, Tk, D]
// and v [B, Hkv, Tk, Dv], all contiguous bfloat16, (D, Dv) ∈ {(64, 64),
// (128, 128), (192, 128), (256, 256)}; causal: query i sees keys 0..i (Tq ==
// Tk), and with prefix P > 0 (causal only) keys 0..max(i, P − 1), the
// prefix-LM mask.  With no keys (Tk == 0) the output is zero, as 0 / 1e-30.
// lse2, null or (with Tk > 0 only) float32 [B·H, Tq rounded up to 128],
// receives each row's logsumexp in base 2 (every row of the padded length).
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k, const void* v,
                                           void* o, void* lse2, int B, int H, int Hkv, int Tq,
                                           int Tk, int D, int Dv, int causal, int prefix,
                                           cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Tq <= 0 || Tk < 0 ||
      (lse2 != nullptr && Tk == 0) || prefix < 0 || prefix > Tq ||
      (prefix > 0 && (!causal || Tq != Tk)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Tk == 0) {
    cudaMemsetAsync(o, 0, static_cast<size_t>(B) * H * Tq * Dv * 2, stream);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err;
  if (D == 64 && Dv == 64 && lse2 != nullptr) {
    err = launch<64, 64, true>(q, k, v, o, static_cast<float*>(lse2), B, H, Hkv, Tq, Tk,
                               causal, prefix, stream);
  } else if (D == 64 && Dv == 64) {
    err = launch<64, 64>(q, k, v, o, nullptr, B, H, Hkv, Tq, Tk, causal, prefix, stream);
  } else if (D == 128 && Dv == 128 && lse2 != nullptr) {
    err = launch<128, 128, true>(q, k, v, o, static_cast<float*>(lse2), B, H, Hkv, Tq, Tk,
                                 causal, prefix, stream);
  } else if (D == 128 && Dv == 128) {
    err = launch<128, 128>(q, k, v, o, nullptr, B, H, Hkv, Tq, Tk, causal, prefix, stream);
  } else if (D == 192 && Dv == 128 && lse2 != nullptr) {
    err = launch<192, 128, true>(q, k, v, o, static_cast<float*>(lse2), B, H, Hkv, Tq, Tk,
                                 causal, prefix, stream);
  } else if (D == 192 && Dv == 128) {
    err = launch<192, 128>(q, k, v, o, nullptr, B, H, Hkv, Tq, Tk, causal, prefix, stream);
  } else if (D == 256 && Dv == 256 && lse2 != nullptr) {
    err = launch_d256<true>(q, k, v, o, static_cast<float*>(lse2), B, H, Hkv, Tq, Tk, causal,
                            prefix, stream);
  } else if (D == 256 && Dv == 256) {
    err = launch_d256<false>(q, k, v, o, nullptr, B, H, Hkv, Tq, Tk, causal, prefix, stream);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

REPRO_DEFINE_ERROR_STRING(repro_flash_attention_wgmma)
