// Weighted sufficient statistics of a tuple batch on Hopper:
//   c = Σ_b w[b],  s[i] = Σ_b w[b]·x[b, i],  Q[i, j] = Σ_b (x[b, i]·w[b])·x[b, j]
// for x [B, m] and w [B] float32 (paper §7.2, the hot loop of cofactor
// maintenance), in one launch.
//
// Replaces: src/repro/kernels/cofactor_update.py::cofactor_update (Pallas
// body _kernel).  The TPU kernel walks a (m/bm, m/bm, B/bk) grid in order,
// with the batch innermost, and accumulates into the revisited output block
// on the MXU; c and s ride along in the j == 0 column of blocks.  Blocks on
// Hopper run in parallel and in no order, so here the batch is split over a
// grid of blocks and the partial sums are added in a fixed order inside the
// same launch.
//
// Bound: bytes at narrow m (m/2 flops a byte read; path A's m = 32), float32
// operations at wide m (2·B·m² flops; m = 130).  No tensor cores: TF32 would
// round the inputs.  Design:
// * x is taken with one more column of ones, x' = [x | 1], so that one
//   (m+1) x (m+1) upper triangle holds Q (i <= j < m), s (column m) and c
//   (entry (m, m)), all from the same staged rows.  Threads map onto the
//   TI x TI tiles of that triangle (TI = 4 for m + 1 <= 40, else 8): each
//   thread keeps its tile in registers and adds (x[b, i]·w[b])·x[b, j] with
//   one rounding per product (the product x·w rounded first, as the plain
//   version).  A block holds `groups` copies of the tile set; group g takes
//   rows g, g + groups, ... of each stage.
// * Up to m = 191 a block holds every tile of the triangle (the narrow
//   kernels).  Each block owns one contiguous range of rows (a multiple of
//   four, so every stage starts 16-byte aligned).  A ring of kStages stages
//   in shared memory is fed by one-dimensional TMA (cp.async.bulk) of R
//   rows of x and R weights each, completing on an mbarrier; thread 0
//   refills a stage as soon as the block has laid it out, so three stages
//   are in flight while one is summed.  Each stage is laid out once into
//   two padded buffers, x' and x'·w, rows of np = nt·TI floats (the ones
//   and the zero padding written in), so that the products read whole
//   float4s with no branch; at TI = 8 the two float4s of a tile column are
//   swizzled apart, so that eight neighbouring tiles read eight distinct
//   banks.  The padded buffers are double-buffered: one barrier a stage.
// * From m = 192 on (the banded kernel) the tile columns are cut into bands
//   of kBand, and the grid's second dimension walks the pairs of bands
//   (bi <= bj) of the triangle, as the TPU grid walks its (i, j) blocks:
//   block (x, p) sums its rows for the kBand² tiles of pair p, one a
//   thread (those below the diagonal or past the last column idle).  Its
//   padded rows hold the two bands' columns only, laid out from global
//   memory (a band is a strided slice of x, which a bulk copy cannot
//   take), so shared memory does not grow with m.
// * Sums in fixed order, no atomics on the data: the groups of a block add
//   into group 0's registers in group order; the four blocks of a thread
//   block cluster add their block sums over distributed shared memory in
//   rank order and write one cluster partial to the partials buffer; of
//   each set of eight clusters of a pass, the last to finish (a ticket
//   counter a set) adds the set's partials in cluster order; the last set
//   to finish (one more counter) adds the set partials in set order, then
//   the at most three rows past the last multiple of four, and writes its
//   pass's entries of Q (mirrored: Q[j, i] from the sum for (i, j)), s and
//   c.  (With one set, its last cluster writes the result.)  The last to
//   arrive resets a counter, so the counters, which have a buffer of their
//   own, are zeroed only when it is allocated.  A ticket is two cluster
//   barriers around one atomic.  The same inputs give the same bits on
//   every call.  The code that runs once a call is kept short, as each SM
//   fetches it cold.
#include <cooperative_groups.h>

#include "common.cuh"

// Phase stamps: none in the library; tools/cofactor_phases.py defines
// REPRO_STAMP(k) to record when thread 0 of a block passes stamp k.
#ifndef REPRO_STAMP
#define REPRO_STAMP(k)
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 4;   // blocks of a cluster
constexpr int kStages = 4;    // stages of the shared-memory ring
constexpr int kSet = 8;       // clusters whose partials one of them adds
constexpr int kBand = 24;     // tile columns of a band (banded: kBand² threads)

// (i, j), i <= j < n, of the t-th pair of an n x n upper triangle, row by row.
__device__ __forceinline__ void upper_pair(int t, int n, int& i, int& j) {
  i = 0;
  while (t >= n - i) {
    t -= n - i;
    ++i;
  }
  j = i + t;
}

// Tile (ti, tj), ti <= tj < nt, of thread slot t of a narrow block: first
// the tiles with tj < nt - 1, row-major, then the nt tiles of the last tile
// column (those that hold column m and the padding) by ti.
__device__ __forceinline__ void tile_of(int t, int nt, int& ti, int& tj) {
  const int interior = (nt - 1) * nt / 2;
  if (t >= interior) {
    ti = t - interior;
    tj = nt - 1;
    return;
  }
  upper_pair(t, nt - 1, ti, tj);
}

// Tile of slot t of pass p; false where no tile of the triangle is there
// (a banded pass's slots below the diagonal or past the last column).
template <bool BAND>
__device__ __forceinline__ bool slot_tile(int p, int t, int nt, int& ti, int& tj) {
  if (!BAND) {
    tile_of(t, nt, ti, tj);
    return true;
  }
  int bi, bj;
  upper_pair(p, (nt + kBand - 1) / kBand, bi, bj);
  ti = bi * kBand + t / kBand;
  tj = bj * kBand + t % kBand;
  return ti <= tj && tj < nt;
}

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
}

// Σ of n float4s at p, p + stride, ... in that order (read through L2: other
// SMs wrote them).
__device__ __forceinline__ float4 sum4(const float4* p, int stride, int n) {
  float4 v = __ldcg(p);
#pragma unroll 8
  for (int c = 1; c < n; ++c) add4(v, __ldcg(p + static_cast<long long>(c) * stride));
  return v;
}

// After this cluster's stores: count the cluster on `ticket`, and return
// (to every thread of the cluster) whether it was the last of `expected`
// to arrive.  The last one resets the counter, so it is zero for the next
// call.  The cluster barrier (release, then acquire) and the release half
// of rank 0's atomic order the cluster's stores before its count; the
// acquire half and the barrier after it order every counted cluster's
// stores before the last cluster's reads.
__device__ __forceinline__ bool last_to_arrive(cg::cluster_group& cluster,
                                               unsigned int* ticket, int expected,
                                               int* flag) {
  cluster.sync();
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    unsigned int t;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;\n" : "=r"(t) : "l"(ticket) : "memory");
    const int last = t == static_cast<unsigned int>(expected - 1);
    if (last) atomicExch(ticket, 0u);  // every other cluster has counted
    // into every block's own flag, so that no block reads another's shared
    // memory after the barrier (and any block may then exit)
    for (int r = 0; r < kCluster; ++r) *cluster.map_shared_rank(flag, r) = last;
  }
  cluster.sync();
  return *flag != 0;
}

// Column c of the row x' = [x | 1] at xr: x[c] for c < m, 1 for c == m, 0
// past it (padding of the last tile, never written out).
__device__ __forceinline__ float col_of(const float* xr, long long c, int m) {
  return c < m ? xr[c] : (c == m ? 1.0f : 0.0f);
}

// Position of column c in a padded row.  At TI = 8 a tile column is two
// float4s (granules 2·tj and 2·tj + 1); granules 8–15 of each 16 swap
// neighbours, so tiles tj and tj + 4 fall on distinct banks.
template <int TI>
__device__ __forceinline__ int swz(int c) {
  return TI == 8 ? c ^ (((c >> 5) & 1) << 2) : c;
}

// Floats of one thread's tile in the block's tile buffer (padded so that
// neighbouring threads' float4 stores fall on distinct banks).
template <int TI>
__host__ __device__ constexpr int tile_stride() {
  return TI * TI + 4;
}

// Floats of a padded row: all of x' (nt tiles), or one band of it.
template <int TI, bool BAND>
__host__ __device__ inline int padded_row(int m) {
  return BAND ? kBand * TI : (m + TI) / TI * TI;
}

// Shared memory of one block (floats, then barriers and a flag).
template <int TI, bool BAND>
__host__ __device__ inline size_t smem_floats(int m, int R, int threads) {
  const size_t ring = BAND ? 0 : static_cast<size_t>(kStages) * R * (m + 1);
  const size_t stages = ring + 4 * static_cast<size_t>(R) * padded_row<TI, BAND>(m);
  const size_t tiles = static_cast<size_t>(threads) * tile_stride<TI>();
  return stages > tiles ? stages : tiles;
}

// One kernel for each (TI, most threads of a block): TI = 4 with 256
// threads, two blocks an SM (128 registers a thread); TI = 8 with 320
// threads (up to m = 191), so that a thread's 64 sums and 16 operands have
// registers to spare; the banded kernel, TI = 8 with kBand² = 576 threads.
template <int TI, int MAXT, bool BAND>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(MAXT, TI == 4 ? 2 : 1)
cofactor_update_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       long long B, int m, int groups, int R,
                       unsigned int* __restrict__ counters, float* __restrict__ partials,
                       float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = m + 1;                    // columns of x' = [x | 1]
  const int nt = (n + TI - 1) / TI;       // tile rows and columns
  const int np = padded_row<TI, BAND>(m);  // floats of a padded row
  const int pass = blockIdx.y;
  // tile slots of a pass, the threads of one group
  const int per_pass = BAND ? kBand * kBand : nt * (nt + 1) / 2;
  float* xs0 = reinterpret_cast<float*>(smem);       // ring: x rows
  float* ws0 = xs0 + kStages * R * m;                 // ring: weights
  float* pad0 = BAND ? xs0 : ws0 + kStages * R;       // 2 x (x', x'·w) padded
  float* tilebuf = xs0;  // after the rows: one tile a thread (over the ring)
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      xs0 + smem_floats<TI, BAND>(m, R, blockDim.x));
  int* last_flag = reinterpret_cast<int*>(bars + kStages);

  const int tid = threadIdx.x;
  REPRO_STAMP(0);
  const int g = tid / per_pass, t = tid % per_pass;
  int ti = 0, tj = 0;
  const bool active = g < groups && slot_tile<BAND>(pass, t, nt, ti, tj);
  // first columns of the padded rows: of x'·w (the a side) and of x' (b)
  int ca = 0, cb = 0;
  if (BAND) {
    int bi, bj;
    upper_pair(pass, (nt + kBand - 1) / kBand, bi, bj);
    ca = bi * kBand * TI;
    cb = bj * kBand * TI;
  }
  int offa[TI / 4], offb[TI / 4];  // the tile's float4s in a padded row
#pragma unroll
  for (int h = 0; h < TI / 4; ++h) {
    offa[h] = swz<TI>(BAND ? t / kBand * TI + 4 * h : ti * TI + 4 * h);
    offb[h] = swz<TI>(BAND ? t % kBand * TI + 4 * h : tj * TI + 4 * h);
  }
  // layout: this thread writes column lc of rows lr, lr + lstep, ...
  const int lstep = blockDim.x >= np ? blockDim.x / np : 1;
  const int lr = blockDim.x >= np ? (tid / np < lstep ? tid / np : R) : 0;  // R: none
  const int lc = blockDim.x >= np ? tid % np : tid;
  // or, where m % 4 == 0, float4 vc of rows vr, vr + vstep, ...
  const int ng = np / 4;
  const int vstep = blockDim.x >= ng ? blockDim.x / ng : 1;
  const int vr = blockDim.x >= ng ? (tid / ng < vstep ? tid / ng : R) : 0;
  const int vc = blockDim.x >= ng ? tid % ng : tid;

  // this block's rows [lo, hi): an equal share of the batch's whole quads
  const long long quads = B / 4;
  const long long lo = 4 * (quads * blockIdx.x / gridDim.x);
  const long long hi = 4 * (quads * (blockIdx.x + 1) / gridDim.x);
  const int nstages = static_cast<int>((hi - lo + R - 1) / R);

  auto fetch = [&](int s) {
    const long long r0 = lo + static_cast<long long>(s) * R;
    const long long rows = hi - r0 < R ? hi - r0 : R;
    const uint32_t xbytes = static_cast<uint32_t>(rows * m * 4);
    const uint32_t wbytes = static_cast<uint32_t>(rows * 4);
    const int slot = s % kStages;
    const uint32_t bar = repro::smem_u32(bars + slot);
    repro::mbar_expect_tx(bar, xbytes + wbytes);
    if (xbytes) repro::bulk_load(xs0 + slot * R * m, x + r0 * m, xbytes, bar);
    repro::bulk_load(ws0 + slot * R, w + r0, wbytes, bar);
  };
  if (!BAND) {
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s) repro::mbar_init(repro::smem_u32(bars + s), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  REPRO_STAMP(1);
  if (!BAND && tid == 0) {
    for (int s = 0; s < kStages && s < nstages; ++s) fetch(s);
  }

  float acc[TI][TI];
#pragma unroll
  for (int p = 0; p < TI; ++p) {
#pragma unroll
    for (int q = 0; q < TI; ++q) acc[p][q] = 0.0f;
  }
  for (int s = 0; s < nstages; ++s) {
    const long long left = hi - lo - static_cast<long long>(s) * R;
    const int rows = static_cast<int>(left < R ? left : R);
    float* xp = pad0 + (s & 1) * 2 * R * np;  // x' rows, then x'·w rows
    float* xwp = xp + R * np;
    if (BAND) {  // the two bands' columns, straight from global memory
      const long long r0 = lo + static_cast<long long>(s) * R;
      for (int e = tid; e < rows * np; e += blockDim.x) {
        const int r = e / np, c = e % np;
        const float* xr = x + (r0 + r) * m;
        const float va = col_of(xr, ca + c, m);
        const float vb = ca == cb ? va : col_of(xr, cb + c, m);
        xwp[r * np + swz<TI>(c)] = __fmul_rn(va, __ldg(w + r0 + r));
        xp[r * np + swz<TI>(c)] = vb;
      }
    } else {
      const int slot = s % kStages;
      repro::mbar_wait(repro::smem_u32(bars + slot), (s / kStages) & 1);
      const float* xs = xs0 + slot * R * m;
      const float* ws = ws0 + slot * R;
      if (m % 4 == 0) {  // rows of x are float4-aligned: a float4 at a time
        for (int r = vr; r < rows; r += vstep) {
          for (int c = 4 * vc; c < np; c += 4 * blockDim.x) {
            float4 v = make_float4(c == m ? 1.0f : 0.0f, 0.0f, 0.0f, 0.0f);
            if (c < m) v = *reinterpret_cast<const float4*>(xs + r * m + c);
            const float wr = ws[r];
            *reinterpret_cast<float4*>(xp + r * np + swz<TI>(c)) = v;
            *reinterpret_cast<float4*>(xwp + r * np + swz<TI>(c)) =
                make_float4(__fmul_rn(v.x, wr), __fmul_rn(v.y, wr), __fmul_rn(v.z, wr),
                            __fmul_rn(v.w, wr));
          }
        }
      } else {
        for (int r = lr; r < rows; r += lstep) {
          for (int c = lc; c < np; c += blockDim.x) {
            const float v = col_of(xs + r * m, c, m);
            xp[r * np + swz<TI>(c)] = v;
            xwp[r * np + swz<TI>(c)] = __fmul_rn(v, ws[r]);
          }
        }
      }
    }
    __syncthreads();  // laid out: the slot is free, the padded rows ready
    if (!BAND && tid == 0 && s + kStages < nstages) fetch(s + kStages);
    if (active) {
#pragma unroll 4
      for (int r = g; r < rows; r += groups) {
        float a[TI], b[TI];
#pragma unroll
        for (int h = 0; h < TI / 4; ++h) {
          const float4 av = *reinterpret_cast<const float4*>(xwp + r * np + offa[h]);
          const float4 bv = *reinterpret_cast<const float4*>(xp + r * np + offb[h]);
          a[4 * h] = av.x, a[4 * h + 1] = av.y, a[4 * h + 2] = av.z, a[4 * h + 3] = av.w;
          b[4 * h] = bv.x, b[4 * h + 1] = bv.y, b[4 * h + 2] = bv.z, b[4 * h + 3] = bv.w;
        }
#pragma unroll
        for (int p = 0; p < TI; ++p) {
#pragma unroll
          for (int q = 0; q < TI; ++q) acc[p][q] = __fmaf_rn(a[p], b[q], acc[p][q]);
        }
      }
    }
  }
  __syncthreads();  // every thread is done with the padded rows
  REPRO_STAMP(2);

  // the block's sum: groups 1.. store their tiles, group 0 adds them into
  // its registers in group order and stores the block's tiles
  float* mine = tilebuf + tid * tile_stride<TI>();
  if (active && g > 0) {
#pragma unroll
    for (int p = 0; p < TI; ++p) {
#pragma unroll
      for (int q = 0; q < TI; q += 4) {
        *reinterpret_cast<float4*>(mine + p * TI + q) =
            make_float4(acc[p][q], acc[p][q + 1], acc[p][q + 2], acc[p][q + 3]);
      }
    }
  }
  __syncthreads();
  if (active && g == 0) {
#pragma unroll 1
    for (int gg = 1; gg < groups; ++gg) {
      const float* other = tilebuf + (gg * per_pass + t) * tile_stride<TI>();
#pragma unroll
      for (int p = 0; p < TI; ++p) {
#pragma unroll
        for (int q = 0; q < TI; q += 4) {
          const float4 v = *reinterpret_cast<const float4*>(other + p * TI + q);
          acc[p][q] += v.x, acc[p][q + 1] += v.y, acc[p][q + 2] += v.z, acc[p][q + 3] += v.w;
        }
      }
    }
#pragma unroll
    for (int p = 0; p < TI; ++p) {
#pragma unroll
      for (int q = 0; q < TI; q += 4) {
        *reinterpret_cast<float4*>(mine + p * TI + q) =
            make_float4(acc[p][q], acc[p][q + 1], acc[p][q + 2], acc[p][q + 3]);
      }
    }
  }
  REPRO_STAMP(3);

  // the cluster's sum, blocks in rank order, into its partial (the block
  // tile layout, float4 at a time; an idle slot's floats are never read
  // out)
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  const int clusters = gridDim.x / kCluster;  // clusters of a pass
  const int cid = blockIdx.x / kCluster;
  const int sets = (clusters + kSet - 1) / kSet;
  const int set = cid / kSet;
  const int chunks = per_pass * tile_stride<TI>() / 4;  // float4s of a partial
  // counters of this pass: the sets', then each set's
  unsigned int* ticket = counters + static_cast<long long>(pass) * (1 + sets);
  // partials of this pass: the clusters', then (of two sets or more) the sets'
  const int parts = clusters + (sets > 1 ? sets : 0);
  float4* partial = reinterpret_cast<float4*>(partials) +
                    static_cast<long long>(pass) * parts * chunks;
  float4* set_partial = partial + static_cast<long long>(clusters) * chunks;
  const int cthreads = kCluster * blockDim.x;
  const int first = rank * blockDim.x + tid;
  for (int k = first; k < chunks; k += cthreads) {
    float4 v = reinterpret_cast<const float4*>(cluster.map_shared_rank(tilebuf, 0))[k];
#pragma unroll
    for (int r = 1; r < kCluster; ++r) {
      add4(v, reinterpret_cast<const float4*>(cluster.map_shared_rank(tilebuf, r))[k]);
    }
    partial[static_cast<long long>(cid) * chunks + k] = v;
  }
  REPRO_STAMP(4);
  // the last cluster of a set to arrive adds the set's partials in cluster
  // order (its first barrier also keeps every block until the others have
  // read its tiles)
  const int set_size = min(kSet, clusters - set * kSet);
  if (!last_to_arrive(cluster, ticket + 1 + set, set_size, last_flag)) return;
  const bool one_set = sets == 1;
  float* Q = out;
  float* s_out = out + static_cast<long long>(m) * m;
  if (!one_set) {
    for (int k = first; k < chunks; k += cthreads) {
      set_partial[static_cast<long long>(set) * chunks + k] =
          sum4(partial + static_cast<long long>(set) * kSet * chunks + k, chunks, set_size);
    }
    // the last set: the set partials in set order
    if (!last_to_arrive(cluster, ticket, sets, last_flag)) return;
  }
  REPRO_STAMP(5);

  // the result, then the tail rows
  for (int k = first; k < chunks; k += cthreads) {
    const int slot = 4 * k / tile_stride<TI>(), off = 4 * k % tile_stride<TI>();
    if (off >= TI * TI) continue;  // the tile's padding
    int ti, tj;
    if (!slot_tile<BAND>(pass, slot, nt, ti, tj)) continue;
    const float4 v = one_set ? sum4(partial + k, chunks, clusters)
                             : sum4(set_partial + k, chunks, sets);
    const int i = ti * TI + off / TI;
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll 1
    for (int u = 0; u < 4; ++u) {
      const int j = tj * TI + off % TI + u;
      if (i > j || j >= n) continue;
      float e = vs[u];
      for (long long r = 4 * quads; r < B; ++r) {
        const float* xr = x + r * m;
        e = __fmaf_rn(__fmul_rn(col_of(xr, i, m), __ldg(w + r)), col_of(xr, j, m), e);
      }
      if (j < m) {
        Q[static_cast<long long>(i) * m + j] = e;
        Q[static_cast<long long>(j) * m + i] = e;
      } else if (i < m) {
        s_out[i] = e;
      } else {
        s_out[m] = e;  // c
      }
    }
  }
  REPRO_STAMP(6);
}

// Launch, or with `clusters` set, ask how many clusters of this launch can
// run at once (the wrapper keeps the grid within one wave).
template <int TI, int MAXT, bool BAND>
cudaError_t launch(const float* x, const float* w, long long B, int m, int groups,
                   int R, int blocks, int passes, unsigned int* counters, float* partials,
                   float* out, cudaStream_t stream, int* clusters) {
  const int n = m + 1, nt = (n + TI - 1) / TI;
  const int nb = (nt + kBand - 1) / kBand;
  if (passes != (BAND ? nb * (nb + 1) / 2 : 1)) return cudaErrorInvalidValue;
  const int threads = BAND ? MAXT : (groups * nt * (nt + 1) / 2 + 31) / 32 * 32;
  if (threads > MAXT || (BAND && groups != 1)) return cudaErrorInvalidValue;
  const auto kernel = cofactor_update_kernel<TI, MAXT, BAND>;
  const size_t bytes = 4 * smem_floats<TI, BAND>(m, R, threads) + 8 * kStages + 16;
  static size_t allowed = 48 * 1024;  // dynamic shared memory opted into
  if (bytes > allowed) {
    cudaError_t err = repro::allow_smem(kernel, bytes);
    // all of the SM's shared memory, so that two blocks of ~70 KB share one
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    }
    if (err != cudaSuccess) return err;
    allowed = bytes;
  }
  if (clusters) {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(blocks);
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = bytes;
    return cudaOccupancyMaxActiveClusters(clusters, kernel, &config);
  }
  kernel<<<dim3(blocks, passes), threads, bytes, stream>>>(x, w, B, m, groups, R, counters,
                                                          partials, out);
  return cudaGetLastError();
}

cudaError_t dispatch(const float* x, const float* w, long long B, int m, int tile,
                     int groups, int R, int blocks, int passes, unsigned int* counters,
                     float* partials, float* out, cudaStream_t stream, int* clusters) {
  if (m < 0 || groups < 1 || R < 4 || R % 4 || blocks < kCluster || blocks % kCluster ||
      passes < 1 || passes > 65535) {
    return cudaErrorInvalidValue;
  }
  if (tile == 4) {
    return launch<4, 256, false>(x, w, B, m, groups, R, blocks, passes, counters, partials,
                                 out, stream, clusters);
  }
  if (tile != 8) return cudaErrorInvalidValue;
  const int nt = (m + 8) / 8;
  if (groups * nt * (nt + 1) / 2 <= 320) {
    return launch<8, 320, false>(x, w, B, m, groups, R, blocks, passes, counters, partials,
                                 out, stream, clusters);
  }
  return launch<8, kBand * kBand, true>(x, w, B, m, groups, R, blocks, passes, counters,
                                        partials, out, stream, clusters);
}

}  // namespace

// out = [Q (m·m) | s (m) | c] of x [B, m] and w [B] (both 16-byte aligned),
// in one launch of `blocks` x `passes` blocks (blocks a multiple of 4;
// passes 1 up to m = 191, else the pairs of bands of 24 tile columns) of
// `groups` groups of tiles of edge `tile` (4 or 8), staging `stage_rows`
// rows (a multiple of 4) at a time.  counters holds, for each pass, one
// ticket counter for its sets and one for each set of eight clusters (zero
// before the call and zero again after); partials holds, for each pass,
// one partial a cluster and one a set (of two sets or more), each the
// pass's tile slots of tile² + 4 floats.
extern "C" int repro_cofactor_update(const float* x, const float* w, long long B,
                                     int m, int tile, int groups, int stage_rows,
                                     int blocks, int passes, unsigned int* counters,
                                     float* partials, float* out, cudaStream_t stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 == 0;
  if (!aligned || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(x, w, B, m, tile, groups, stage_rows, blocks, passes,
                                   counters, partials, out, stream, nullptr));
}

// *clusters = the clusters of a call at (m, tile, groups, stage_rows,
// passes) that the card runs at once.
extern "C" int repro_cofactor_max_clusters(int m, int tile, int groups, int stage_rows,
                                           int passes, int* clusters) {
  return static_cast<int>(dispatch(nullptr, nullptr, 0, m, tile, groups, stage_rows,
                                   kCluster, passes, nullptr, nullptr, nullptr, nullptr,
                                   clusters));
}

REPRO_DEFINE_ERROR_STRING(repro_cofactor_update)
