// ⊎ with in-tile key dedup on Hopper: view[ids[b], :] += vals[b, :], in
// place, where each tile of batch rows first sums its duplicate ids.
//
// Replaces: src/repro/kernels/ring_scatter.py::scatter_add_onehot with
// dedup=True (Pallas body _scatter_dedup_kernel, which calls tile_dedup),
// the reference's onehot_dedup ⊎ backend.  The TPU kernel collapses a
// tile's duplicate ids with a 0/1 matmul in VMEM before its one-hot
// contraction.  On Hopper the duplicates of a tile of T = tile_rows(d)
// consecutive rows (T <= 32, a power of two) are found among the lanes of
// one warp with __match_any_sync, so the dedup needs no shared memory, no
// block barrier and no scan.
//
// Design, d >= 2: a warp per batch row (grid stride), as scatter_add.  In
// one round trip the warp's lanes < T load the tile's T ids and every lane
// the columns of its first reduction group of the row (a window of seven
// that holds them whatever the view row's split, load_window); the
// row's group is the mask of the tile's rows with its id.  A warp whose row
// is not its group's lowest row, or whose id is padding (< 0 or >= S), is
// done.  The group's lowest row adds the group's other rows
// (repro::add_group_rows, common.cuh, shared with gather_mul_scatter.cu: up
// to eight rows' loads in flight a lane; a second round trip only where the
// tile repeats the id) column by column in ascending row order (__fadd_rn) and
// issues one reduction per group of the view row (repro::reduce_group,
// common.cuh: float4 reductions on its 16-byte aligned interior, scalar
// ones on the head and the tail), so a tile's distinct id costs one pass
// of reductions.  d = 1: a thread per row, a warp is a tile
// of 32 rows; the group's values are summed at its lowest lane by shuffles
// in ascending lane order and that lane issues one atomic add.  No
// division per element.
//
// Bound: bytes.  A call reads B·4 bytes of ids and B·d·4 bytes of values,
// and reads and writes back the touched view rows; one add per element.
// Within a tile the order of the adds is fixed (tests/_dedup_order.py);
// tiles meet in the reductions in no fixed order: exact for integer-valued
// payloads, otherwise within float32 rounding of any order.
#include "common.cuh"

// Variants: 0 in the library; tools/kernel_variants.py builds the source
// with REPRO_VARIANT set to one of the cuts below, to time what each part
// costs.
#ifndef REPRO_VARIANT
#define REPRO_VARIANT 0
#endif

namespace {

constexpr int kVariant = REPRO_VARIANT;
constexpr int kNoDedup = 1;       // every in-range row its own group
constexpr int kNoReductions = 2;  // no global atomics

__device__ __forceinline__ unsigned match(int key, int lane) {
  return kVariant == kNoDedup ? 1u << lane : __match_any_sync(repro::kFullMask, key);
}

// The columns of a lane's first reduction group (group lane, repro::
// RowSplit) whatever the row's head: a window w of the payload row's
// columns base .. base + 6 (base 0 for lane 0, else 4·(lane - 1)), loaded
// before the view row, and so its split, is known.
__device__ __forceinline__ void load_window(const float* __restrict__ row, int d, int lane,
                                            float (&w)[7]) {
  const int base = lane == 0 ? 0 : 4 * (lane - 1);
#pragma unroll
  for (int k = 0; k < 7; ++k) w[k] = base + k < d ? __ldg(row + base + k) : 0.0f;
}

// x[t] = the window's column start(g) + t of the first group g = lane.
__device__ __forceinline__ void from_window(const float (&w)[7], const repro::RowSplit& s,
                                            int lane, float (&x)[4]) {
  const int off = lane == 0 ? 0 : s.head;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    x[t] = off == 0 ? w[t] : (off == 1 ? w[t + 1] : (off == 2 ? w[t + 2] : w[t + 3]));
  }
}

// kRows: d >= 2, a warp a row; else d = 1, a thread a row.
template <bool kRows>
__global__ void scatter_dedup_kernel(float* __restrict__ view,
                                     const int* __restrict__ ids,
                                     const float* __restrict__ vals,
                                     long long S, int d, long long B, int tile_rows) {
  const int lane = threadIdx.x & 31;
  const long long thread = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  if (!kRows) {
    // a warp is a tile of 32 rows; the loop bound is the same for the warp
    for (long long b0 = thread - lane; b0 < B; b0 += threads) {
      const long long b = b0 + lane;
      const bool live = b < B;
      const int id = live ? __ldg(ids + b) : -1;
      const float x = live ? __ldg(vals + b) : 0.0f;
      const int key = repro::dedup_key(id, S, live, lane);
      const unsigned group = match(key, lane);
      const float s = repro::warp_group_sum(x, group, lane);
      if (key >= 0 && __ffs(group) - 1 == lane) {
        if (kVariant == kNoReductions) {
          repro::keep(s);
        } else {
          atomicAdd(view + id, s);
        }
      }
    }
    return;
  }
  const long long mask = ~static_cast<long long>(tile_rows - 1);
  for (long long b = thread >> 5; b < B; b += threads >> 5) {
    const long long r0 = b & mask;
    const int r = static_cast<int>(b - r0);
    const bool live = lane < tile_rows && r0 + lane < B;
    // one round trip: the tile's ids and this row's first columns
    const int key = repro::dedup_key(live ? __ldg(ids + r0 + lane) : -1, S, live, lane);
    const float* own = vals + b * d;
    float w[7];
    load_window(own, d, lane, w);
    const unsigned group = __shfl_sync(repro::kFullMask, match(key, lane), r);
    const int id = __shfl_sync(repro::kFullMask, key, r);
    if (id < 0 || __ffs(group) - 1 != r) continue;  // the same for the whole warp
    const unsigned others = group & (group - 1);     // the group's later rows
    const float* rows = vals + r0 * d;
    float* row = view + static_cast<long long>(id) * d;
    const repro::RowSplit split = repro::row_split(row, d);
    for (int g = lane; g < split.groups(); g += 32) {
      const int c0 = split.start(g), n = split.width(g);
      float x[4];
      if (g == lane) {
        from_window(w, split, lane, x);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) x[t] = t < n ? __ldg(own + c0 + t) : 0.0f;
      }
      if (others) {
        repro::add_group_rows<false>(others, c0, n, x, [&](int f) {
          return repro::GroupRow{rows + static_cast<long long>(f) * d, 1.0f};
        });
      }
      if (kVariant == kNoReductions) {
        for (int t = 0; t < 4; ++t) repro::keep(x[t]);
      } else {
        repro::reduce_group(row, split, g, x);
      }
    }
  }
}

}  // namespace

// view [S, d] += vals [B, d] at ids [B], duplicates summed per tile of
// tile_rows rows (32 at d = 1; a power of two up to 32 otherwise); all
// contiguous, on one device.
extern "C" int repro_scatter_dedup(float* view, const int* ids, const float* vals,
                                   long long S, int d, long long B, int tile_rows,
                                   cudaStream_t stream) {
  if (tile_rows < 1 || tile_rows > 32 || (tile_rows & (tile_rows - 1)) ||
      (d == 1 && tile_rows != 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B * static_cast<long long>(d) > 0) {
    if (d == 1) {
      scatter_dedup_kernel<false><<<repro::grid_for(B), repro::kThreads, 0, stream>>>(
          view, ids, vals, S, d, B, tile_rows);
    } else {
      scatter_dedup_kernel<true><<<repro::grid_for(32 * B), repro::kThreads, 0, stream>>>(
          view, ids, vals, S, d, B, tile_rows);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_DEFINE_ERROR_STRING(repro_scatter_dedup)
