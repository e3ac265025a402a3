// Segment sum of ring payload rows on Hopper: out[s, :] = Σ values[b, :]
// over the rows b whose segment id is s, in one launch with no sort.
//
// Replaces: src/repro/kernels/segment_ring_sum.py::segment_ring_sum (Pallas
// body _kernel), the inner kernel of the compact ⊎
// (src/repro/kernels/scatter_ops.py::_compact_scatter).  The TPU kernel
// contracts one-hot [B, S] blocks on the MXU; ids < 0 or >= S drop.
//
// Bound: bytes.  A call must read B·d·4 bytes of values and B·4 of ids and
// write S·d·4 bytes of sums; it does one add per value.  On the compact ⊎
// path S = B ≈ 1000, so the call is a few microseconds of work and the
// launches around it are the cost: the wrapper makes this one launch and
// allocates only the output (no sort, no offsets, no zero fill).
//
// Design: each block owns G consecutive segments, whose d-wide float32
// accumulators sit in its shared memory (at most 96 KB).  It streams all B
// ids in ascending row order, 2048 a pass (coalesced, from L2), finds the
// rows of its segments by warp ballot, lists them in row order in shared
// memory, and adds each listed row into its segment's accumulator.  Every
// (segment, column) accumulator has one owner thread, which adds its rows
// in ascending row order, so there are no atomics and the result is the
// same on every run (and the same as a stable sort's order).  Then the
// block writes its G·d sums once, zeros included.
//
// Where it stops paying: every block reads all B ids, so the id traffic is
// B·4·⌈S / G⌉ bytes against B·d·4 of values.  The wrapper-free launch wins
// while that is small, as at S = B = 1000 (G = 4, 250 blocks, 1 MB of ids
// from L2).  At S = B = 65,536 and d = 111, G is 221 by shared memory and
// the 297 blocks read 78 MB of ids and pass over 32 chunks each, serially
// within a block: there a sort-based sum, which reads the ids a few times,
// would move fewer bytes (PERF.md has both times).
#include "common.cuh"

namespace {

constexpr int kThreadsSeg = 512;
constexpr int kIdsPerThread = 4;
constexpr int kChunk = kThreadsSeg * kIdsPerThread;  // ids of one pass
constexpr int kWarpsSeg = kThreadsSeg / 32;
constexpr int kSubs = kIdsPerThread * kWarpsSeg;     // 32-id runs of a pass
constexpr size_t kAccBytes = 96 * 1024;              // accumulators of a block
constexpr long long kTargetBlocks = 2 * 132;         // two per SM of an H100
// the list and run starts, static shared memory beside the accumulators
constexpr size_t kStaticBytes = kChunk * (4 + 2) + (kSubs + 1) * 4;

__global__ void __launch_bounds__(kThreadsSeg)
    segment_ring_sum_kernel(const float* __restrict__ vals, const int* __restrict__ ids,
                            int B, long long S, int d, int G, float* __restrict__ out) {
  extern __shared__ float acc[];            // [G, d]
  __shared__ int rows[kChunk];              // listed rows of a pass, ascending
  __shared__ unsigned short segs[kChunk];   // their segments, relative to s0
  __shared__ int starts[kSubs + 1];         // list position of each 32-id run

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long s0 = static_cast<long long>(blockIdx.x) * G;
  const int g_n = static_cast<int>(S - s0 < G ? S - s0 : G);
  for (int e = tid; e < g_n * d; e += kThreadsSeg) acc[e] = 0.f;
  // owner of accumulator column c of the segments g with g % classes == cls
  const int classes = d >= kThreadsSeg ? 1 : kThreadsSeg / d;
  __syncthreads();

  for (int c0 = 0; c0 < B; c0 += kChunk) {
    int id[kIdsPerThread];
    unsigned int hit[kIdsPerThread];
#pragma unroll
    for (int j = 0; j < kIdsPerThread; ++j) {
      // run j·kWarpsSeg + warp holds rows c0 + 32 (j·kWarpsSeg + warp) + lane,
      // so runs in index order are rows in ascending order
      const int row = c0 + j * kThreadsSeg + tid;
      id[j] = row < B ? __ldg(ids + row) : -1;
      hit[j] = __ballot_sync(0xffffffffu, id[j] >= s0 && id[j] < s0 + g_n);
      if (lane == 0) starts[j * kWarpsSeg + warp] = __popc(hit[j]);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the kSubs run counts, two a lane
      const int a = starts[2 * lane], b = starts[2 * lane + 1];
      int incl = a + b;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += x;
      }
      starts[2 * lane] = incl - a - b;
      starts[2 * lane + 1] = incl - b;
      if (lane == 31) starts[kSubs] = incl;
    }
    __syncthreads();
    const int n = starts[kSubs];
#pragma unroll
    for (int j = 0; j < kIdsPerThread; ++j) {
      if (hit[j] >> lane & 1u) {
        const int pos = starts[j * kWarpsSeg + warp] + __popc(hit[j] & ((1u << lane) - 1u));
        rows[pos] = c0 + j * kThreadsSeg + tid;
        segs[pos] = static_cast<unsigned short>(id[j] - s0);
      }
    }
    __syncthreads();
    for (int p = tid; p < classes * d; p += kThreadsSeg) {
      const int c = p % d;
      const int cls = p / d;
      for (int e = 0; e < n; ++e) {
        const int g = segs[e];
        if (g % classes == cls) {
          acc[g * d + c] += __ldg(vals + static_cast<long long>(rows[e]) * d + c);
        }
      }
    }
    __syncthreads();  // the list and run starts are rewritten next pass
  }

  float* dst = out + s0 * d;
  for (int e = tid; e < g_n * d; e += kThreadsSeg) dst[e] = acc[e];
}

}  // namespace

// out [S, d] = segment sums of values [B, d] by ids [B] (int32); rows with
// an id < 0 or >= S drop.  Every element of out is written.
extern "C" int repro_segment_ring_sum(const float* vals, const int* ids, int B,
                                      long long S, int d, float* out,
                                      cudaStream_t stream) {
  if (B < 0 || S < 0 || d < 0 || static_cast<size_t>(d) * 4 > kAccBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0 || d == 0) return static_cast<int>(cudaGetLastError());
  long long cap = static_cast<long long>(kAccBytes / (static_cast<size_t>(d) * 4));
  if (cap > 65535) cap = 65535;  // segment offsets are 16-bit in the list
  long long G = (S + kTargetBlocks - 1) / kTargetBlocks;
  G = G < 1 ? 1 : (G > cap ? cap : G);
  const long long blocks = (S + G - 1) / G;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(G) * d * 4;
  if (bytes + kStaticBytes > 48 * 1024) {  // opt in above the default 48 KB
    const cudaError_t err = cudaFuncSetAttribute(
        segment_ring_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  segment_ring_sum_kernel<<<static_cast<unsigned int>(blocks), kThreadsSeg, bytes, stream>>>(
      vals, ids, B, S, d, static_cast<int>(G), out);
  return static_cast<int>(cudaGetLastError());
}

REPRO_DEFINE_ERROR_STRING(repro_segment_ring_sum)
