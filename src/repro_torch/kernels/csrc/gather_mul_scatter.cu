// Fused sibling gather, scale and ⊎ on Hopper, with in-tile key dedup:
// view[out_ids[b], :] += scale[b] · src[in_ids[b], :], in place.
//
// Replaces: src/repro/kernels/ring_scatter.py::gather_mul_scatter (Pallas
// body _gms_kernel), reached from BatchedDelta.apply_to when a deferred
// sibling gather meets the final ⊎ of a scalar ring.  The TPU kernel
// gathers with a one-hot matmul against the whole source plane held in
// VMEM, so its dispatch only takes it while the source has at most
// MAX_FUSED_SRC = 4096 rows.  Here each row's source elements are read
// straight from device memory (L2 holds the hot rows), so the source is
// never staged whole and that guard does not apply: (S, Sg) = (96, 9216)
// launches this kernel too.
//
// Design: scatter_dedup.cu's tiles.  A tile is T = tile_rows(d) consecutive
// batch rows (T <= 32, a power of two), whose out ids sit on the lanes of
// one warp, so the tile's duplicate out ids are found with no shared
// memory, no block barrier and no division per element.
// - d = 1: a thread a row, a warp (a block) a tile of 32 rows.  Each lane
//   loads its row's out_id, in_id and scale in one round trip, then the
//   gathered element (the second), multiplies (__fmul_rn); its group (the
//   lanes with its out id) comes from __match_any_sync, and the group's
//   products are summed at its lowest lane by shuffles in ascending lane
//   order (repro::warp_group_sum), which issues one atomic add.
// - d >= 2: a warp a row.  The warp's lanes < T load the tile's out ids, in
//   ids and scales in one round trip.  A warp whose out id is padding is
//   done; every other warp issues its gathered row's first columns (the
//   second round trip), takes its row's group in one vote
//   (repro::row_group: the tile's rows with its id) and is done unless its
//   row leads the group.  A row alone in its group scales and reduces; a
//   leader of more reads the group's other rows (each member's gather row
//   and scale come from its lane by shuffles, so the whole warp takes each
//   round of 32 reduction groups), multiplies, adds the other rows'
//   products in ascending row order (repro::add_group_rows, common.cuh,
//   shared with scatter_dedup.cu) and issues one reduction per group of
//   the view row (repro::reduce_group: float4 reductions on its 16-byte
//   aligned interior).
// At d >= 2 __match_any_sync gives the same group, but its result arrives
// late: 0.3 µs more than the vote at (S 96, Sg 9216, d 111, B 1000) on an
// H100 80GB HBM3 at 700 W (tools/kernel_variants.py).  At d = 1, 32
// broadcasts of the tile's keys in its place ran 0.1 µs slower.
// Rows whose out_id is < 0 or >= S drop and join no group; in_ids clamp to
// [0, Sg - 1], as the reference's XLA path (jnp.take(..., mode="clip"))
// does, so a padding row that keeps a valid out_id must carry scale 0.
//
// Bound: bytes.  A call reads 3·B·4 bytes of ids and scales, the gathered
// source rows (at most B·d·4 bytes), and reads and writes back the touched
// view rows; one multiply and one add per element.  At the main path's
// B = 1000, d = 1 the bytes take nanoseconds and the launch and two
// dependent round trips take the time.  Within a tile the order of the adds
// is fixed (tests/_dedup_order.py::gather_mul_scatter_order); tiles meet in
// the reductions in no fixed order: exact for integer-valued payloads,
// otherwise within float32 rounding of any order.
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
constexpr int kNoGather = 3;      // no source loads (the scale alone)
constexpr int kMatchAny = 4;      // d >= 2: groups by __match_any_sync, not a vote

// d = 1: the lanes of the tile whose key is this lane's.
__device__ __forceinline__ unsigned lane_group(int key, int lane) {
  return kVariant == kNoDedup ? 1u << lane : __match_any_sync(repro::kFullMask, key);
}

// d >= 2: the rows of the tile whose key is row r's id (>= 0).
__device__ __forceinline__ unsigned row_group(int key, int id, int r) {
  if (kVariant == kNoDedup) return 1u << r;
  if (kVariant == kMatchAny) {
    return __shfl_sync(repro::kFullMask, __match_any_sync(repro::kFullMask, key), r);
  }
  return repro::row_group(key, id);
}

// in_id clamped into [0, Sg - 1]
__device__ __forceinline__ long long clamp_row(int id, long long Sg) {
  return id < 0 ? 0 : (id >= Sg ? Sg - 1 : id);
}

__device__ __forceinline__ float gathered(const float* p) {
  return kVariant == kNoGather ? 1.0f : __ldg(p);
}

// kRows: d >= 2, a warp a row; else d = 1, a thread a row.
template <bool kRows>
__global__ void gather_mul_scatter_kernel(float* __restrict__ view,
                                          const int* __restrict__ out_ids,
                                          const float* __restrict__ src,
                                          const int* __restrict__ in_ids,
                                          const float* __restrict__ scale,
                                          long long S, long long Sg, int d, long long B,
                                          int tile_rows) {
  const int lane = threadIdx.x & 31;
  const long long thread = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  if (!kRows) {
    // a warp is a tile of 32 rows; the loop bound is the same for the warp
    for (long long b0 = thread - lane; b0 < B; b0 += threads) {
      const long long b = b0 + lane;
      const bool live = b < B;
      // one round trip: the row's out id, in id and scale
      const int oid = live ? __ldg(out_ids + b) : -1;
      const int iid = live ? __ldg(in_ids + b) : 0;
      const float sc = live ? __ldg(scale + b) : 0.0f;
      const int key = repro::dedup_key(oid, S, live, lane);
      // the second: the gathered element (rows that drop read nothing)
      const float x = key >= 0 ? __fmul_rn(gathered(src + clamp_row(iid, Sg)), sc) : 0.0f;
      const unsigned group = lane_group(key, lane);
      const float s = repro::warp_group_sum(x, group, lane);
      if (key >= 0 && __ffs(group) - 1 == lane) {
        if (kVariant == kNoReductions) {
          repro::keep(s);
        } else {
          atomicAdd(view + oid, s);
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
    // one round trip: the tile's out ids, in ids and scales, a row a lane
    const int key =
        repro::dedup_key(live ? __ldg(out_ids + r0 + lane) : -1, S, live, lane);
    const int iid = live ? __ldg(in_ids + r0 + lane) : 0;
    const float sc = live ? __ldg(scale + r0 + lane) : 0.0f;
    const int id = __shfl_sync(repro::kFullMask, key, r);
    if (id < 0) continue;  // padding: the same for the whole warp
    const float own_scale = __shfl_sync(repro::kFullMask, sc, r);
    // each lane's clamped gather row (lane < T: its tile row's), for the group
    const long long lane_row = clamp_row(iid, Sg) * d;
    const float* own = src + __shfl_sync(repro::kFullMask, lane_row, r);
    float* row = view + static_cast<long long>(id) * d;
    const repro::RowSplit split = repro::row_split(row, d);
    // the second round trip, issued before the group's vote: the gathered
    // row's columns of this lane's first reduction group
    float first[4];
    {
      const bool active = lane < split.groups();
      const int c0 = active ? split.start(lane) : 0, n = active ? split.width(lane) : 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) first[t] = t < n ? gathered(own + c0 + t) : 0.0f;
    }
    const unsigned group = row_group(key, id, r);
    if (__ffs(group) - 1 != r) continue;          // the same for the whole warp
    const unsigned others = group & (group - 1);  // the group's later rows
    if (!others) {  // alone in its group, the common case: scale and reduce
      for (int g = lane; g < split.groups(); g += 32) {
        const int c0 = split.start(g), n = split.width(g);
        float x[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          x[t] = t < n ? __fmul_rn(g < 32 ? first[t] : gathered(own + c0 + t), own_scale) : 0.0f;
        }
        if (kVariant == kNoReductions) {
          for (int t = 0; t < 4; ++t) repro::keep(x[t]);
        } else {
          repro::reduce_group(row, split, g, x);
        }
      }
      continue;
    }
    // a group of more rows: rounds of 32 reduction groups, the whole warp in
    // each (the other rows' gather rows and scales come by shuffles)
    for (int g0 = 0; g0 < split.groups(); g0 += 32) {
      const int g = g0 + lane;
      const bool active = g < split.groups();
      const int c0 = active ? split.start(g) : 0, n = active ? split.width(g) : 0;
      float x[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        x[t] = t < n ? __fmul_rn(g0 == 0 ? first[t] : gathered(own + c0 + t), own_scale) : 0.0f;
      }
      repro::add_group_rows<true>(others, c0, n, x, [&](int f) {
        const long long row_f = __shfl_sync(repro::kFullMask, lane_row, f);
        return repro::GroupRow{kVariant == kNoGather ? own : src + row_f,
                               __shfl_sync(repro::kFullMask, sc, f)};
      });
      if (!active) continue;
      if (kVariant == kNoReductions) {
        for (int t = 0; t < 4; ++t) repro::keep(x[t]);
      } else {
        repro::reduce_group(row, split, g, x);
      }
    }
  }
}

}  // namespace

// view [S, d] += scale[b] · src [Sg, d] row in_ids[b], at out_ids[b],
// duplicate out ids summed per tile of tile_rows rows (32 at d = 1; a power
// of two up to 32 otherwise); all contiguous, on one device.
extern "C" int repro_gather_mul_scatter(float* view, const int* out_ids,
                                        const float* src, const int* in_ids,
                                        const float* scale, long long S,
                                        long long Sg, int d, long long B,
                                        int tile_rows, cudaStream_t stream) {
  if (tile_rows < 1 || tile_rows > 32 || (tile_rows & (tile_rows - 1)) ||
      (d == 1 && tile_rows != 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B * static_cast<long long>(d) > 0 && Sg > 0) {
    if (d == 1) {
      // blocks of one warp, a tile each, spread over the SMs: 0.09 µs faster
      // than blocks of eight at (S 96, Sg 9216, B 1000) on an H100 80GB HBM3
      // at 700 W (tools/kernel_variants.py)
      gather_mul_scatter_kernel<false><<<repro::grid_for_tiles((B + 31) / 32), 32, 0, stream>>>(
          view, out_ids, src, in_ids, scale, S, Sg, d, B, tile_rows);
    } else {
      gather_mul_scatter_kernel<true>
          <<<repro::grid_for(32 * B), repro::kThreads, 0, stream>>>(
              view, out_ids, src, in_ids, scale, S, Sg, d, B, tile_rows);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_DEFINE_ERROR_STRING(repro_gather_mul_scatter)
