// One fused trigger chain on Hopper:
//   view[out_ids[b], :] += vals[b, :] ⊗ Π_i plane_i[clamp(ids_i[b]), :]
// in place, with the ring product of the scalar or the degree-m ring.
//
// Replaces: src/repro/kernels/ring_fused.py::_fused_pallas (Pallas body
// _fused_kernel), the runtime of every FusedChain op of a trigger plan.
// The TPU kernel keeps each source plane whole in VMEM, gathers rows with
// one-hot matmuls on the MXU, multiplies in registers, dedups the tile's
// out ids and contracts a one-hot into the revisited output block; the
// plan refuses chains whose planes pass MAX_FUSED_PLANE rows or whose VMEM
// model passes VMEM_BUDGET.  Here the source planes stay in device memory
// (L2 holds a 9216 x 111 float32 plane, 4.1 MB) and each warp reads only
// the rows it gathers, so no bound on source rows is needed; the plan-time
// model (ring_fused.chain_smem_bytes) is the block's shared memory.
//
// Design, d >= 2: a block of 8 warps takes one tile of T = tile_rows(d)
// batch rows (8 at d = 111), a warp a row (T / 8 rows in turn a warp where
// T > 8), its lanes over the row's reduction groups (repro::RowSplit,
// common.cuh: at most four columns a lane a round of 32 groups).
// 1. Ids, one round trip: lanes < T load the tile's out ids, other lanes
//    the warp's rows' gather ids; shuffles broadcast them; gather ids clamp
//    into the plane (the reference's jnp.take(..., mode="clip")).  Every
//    warp finds the tile's duplicate out ids with __match_any_sync.
// 2. Rows, one round trip: a lane loads its columns of the value row and of
//    every gathered row before the first product (the next round's while it
//    multiplies, where a row takes more than one round).
// 3. The product, per warp: term by term in ring_mul_flat's order with
//    round-to-nearest multiplies and adds (__fmul_rn/__fadd_rn: nvcc would
//    otherwise contract a*b + c into an FMA and round differently from the
//    plain PyTorch version).  The degree-m ring's Q columns read the s
//    entries of both factors at (i, j): the factors' (c, s) columns, all in
//    the first round, go to the warp's slots in shared memory behind a
//    __syncwarp a source; each lane steps its columns' (i, j) once a round,
//    outside the source loop (one division a lane for its first Q column,
//    none an element), and computes every term of a column without
//    branches, its kind picking the result.
// 4. The product goes to `prod` when asked (a later plan op reads the
//    chain's end delta).
// 5. Dedup: rows whose out id is alone in the tile issue their reductions
//    from registers (repro::reduce_group: float4 reductions on the view
//    row's aligned interior, scalar on its head and tail).  Only where the
//    tile has a duplicate id do its grouped rows go to the tile in shared
//    memory, behind one block barrier; each group's lowest row then adds the
//    others' rows in ascending row order and issues the reductions.
// d = 1 (the scalar ring): a thread a row, a warp a tile of 32 rows: the
// value, out id and gather ids in one round trip, the gathered values in a
// second, the product in registers, the group sum by shuffles in ascending
// lane order (repro::warp_group_sum), one atomic add a distinct id.  No
// shared memory.
//
// Bound: bytes for the scalar ring; for the degree-m ring about 1 + 3m²
// flops per product element against 4 bytes per source row element, still
// bytes at d = 111.  A call reads B·d·4 bytes of values, 4·B bytes of ids
// per source and the gathered source rows, writes the product when asked,
// and reads and writes back the touched view rows.  Shared memory (d >= 2):
// T·d floats of tile and 8 warps × 2·kMaxSources (c, s) slots of m + 1
// floats.  Rows whose out id is < 0 or >= S are padding and drop.  Within a
// tile the order of the adds is fixed (tests/_dedup_order.py); tiles meet
// in the reductions in no fixed order: exact for integer-valued payloads.
#include "common.cuh"

// Variants: 0 in the library; tools/kernel_variants.py builds the source
// with REPRO_VARIANT set to one of the cuts below, to time what each part
// costs.
#ifndef REPRO_VARIANT
#define REPRO_VARIANT 0
#endif

namespace {

constexpr int kVariant = REPRO_VARIANT;
constexpr int kNoGathers = 1;     // no gather-id or source-row loads
constexpr int kNoProduct = 2;     // the product of each source skipped
constexpr int kNoDedup = 3;       // every in-range row its own group
constexpr int kNoReductions = 4;  // no global atomics

constexpr int kMaxSources = 4;
constexpr int kWarps = 8;  // warps a block of the d >= 2 kernel
constexpr unsigned kFull = repro::kFullMask;

// The kernel's argument struct: up to kMaxSources (plane, ids) pairs.  The
// plan keeps a chain with more sources unfused.
struct Sources {
  const float* plane[kMaxSources];
  const int* ids[kMaxSources];
  long long rows[kMaxSources];
  int n;
};

__device__ __forceinline__ unsigned match(int key, int lane) {
  return kVariant == kNoDedup ? 1u << lane : __match_any_sync(kFull, key);
}

__device__ __forceinline__ long long clamp_row(int g, long long rows) {
  return g < 0 ? 0 : (g >= rows ? rows - 1 : g);
}

__device__ __forceinline__ void reduce(float* row, const repro::RowSplit& s, int g,
                                       const float (&x)[4]) {
  if (kVariant == kNoReductions) {
    for (int t = 0; t < 4; ++t) repro::keep(x[t]);
  } else {
    repro::reduce_group(row, s, g, x);
  }
}

// d = 1: a thread a row, a warp a tile of 32 rows (the scalar ring).
__global__ void __launch_bounds__(repro::kThreads)
    fused_chain_kernel_lanes(float* __restrict__ view, const int* __restrict__ out_ids,
                             const float* __restrict__ vals, float* __restrict__ prod,
                             long long S, long long B, Sources src) {
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = b < B;
  float x = live ? __ldg(vals + b) : 0.0f;
  const int id = live ? __ldg(out_ids + b) : -1;
  int gid[kMaxSources];
#pragma unroll
  for (int i = 0; i < kMaxSources; ++i) {
    gid[i] = live && i < src.n && kVariant != kNoGathers ? __ldg(src.ids[i] + b) : 0;
  }
  float y[kMaxSources];
#pragma unroll
  for (int i = 0; i < kMaxSources; ++i) {
    y[i] = live && i < src.n && kVariant != kNoGathers
               ? __ldg(src.plane[i] + clamp_row(gid[i], src.rows[i]))
               : x;
  }
#pragma unroll
  for (int i = 0; i < kMaxSources; ++i) {
    if (i < src.n) {
      if (kVariant == kNoProduct) {
        repro::keep(y[i]);
      } else {
        x = __fmul_rn(x, y[i]);
      }
    }
  }
  if (prod != nullptr && live) prod[b] = x;
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

// Where a lane's columns sit in the degree-m ring: p = c - 1 - m is the
// index into Q (c and s where it is negative), (i, j) its row and column
// while p >= 0 and (0, p) while it is negative, so that one step to the
// next column is j + 1, carried into i at m.  Padding columns past
// 1 + m + m² have i >= m.
struct QCoord {
  int i, j;
  __device__ __forceinline__ void step(int m) {
    if (++j == m) {
      j = 0;
      ++i;
    }
  }
};

// Where the (up to) four columns c0 .. c0 + 3 of a lane's group read the s
// entries of the degree-m ring's factors, set once a round outside the
// source loop: for a Q column, offsets 1 + i and 1 + j into a (c, s) slot;
// for the c and s columns (kind 0 and 1) and the padding columns past
// 1 + m + m² (kind 3), offset 0, a valid slot entry whose product is not
// used.  Kind 2 is a Q column.
struct ColumnTerms {
  int oi[4], oj[4], kind[4];

  __device__ __forceinline__ ColumnTerms(int c0, QCoord q, int m) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const bool is_q = q.j >= 0 && q.i < m;
      kind[t] = c0 + t == 0 ? 0 : (q.j < 0 ? 1 : (is_q ? 2 : 3));
      oi[t] = is_q ? 1 + q.i : 0;
      oj[t] = is_q ? 1 + q.j : 0;
      q.step(m);
    }
  }
};

// x[t] = (a ⊗ b)[c0 + t] where x[t] = a[c0 + t], y[t] = b[c0 + t], for the
// degree-m ring; A and Bs are the (c, s) slots of a and b (m + 1 floats
// each).  Every term is computed for every column, without branches, and
// the column's kind picks the result:
//   c = ca·cb;  s = sa·cb + ca·sb;
//   q = qa·cb + ca·qb, then + sa_i·sb_j, then + sb_i·sa_j;  padding 0.
__device__ __forceinline__ void ring_mul_group(float (&x)[4], const float (&y)[4],
                                               const ColumnTerms& ct, const float* A,
                                               const float* Bs) {
  const float ca = A[0], cb = Bs[0];
  float a_i[4], b_j[4], b_i[4], a_j[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    a_i[t] = A[ct.oi[t]];
    b_j[t] = Bs[ct.oj[t]];
    b_i[t] = Bs[ct.oi[t]];
    a_j[t] = A[ct.oj[t]];
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float s = __fadd_rn(__fmul_rn(x[t], cb), __fmul_rn(ca, y[t]));
    const float q = __fadd_rn(__fadd_rn(s, __fmul_rn(a_i[t], b_j[t])),
                              __fmul_rn(b_i[t], a_j[t]));
    const int k = ct.kind[t];
    x[t] = k == 0 ? __fmul_rn(x[t], y[t]) : (k == 1 ? s : (k == 2 ? q : 0.0f));
  }
}

// d >= 2: a block of kWarps warps a tile of T rows.
__global__ void __launch_bounds__(kWarps * 32)
    fused_chain_kernel_rows(float* __restrict__ view, const int* __restrict__ out_ids,
                            const float* __restrict__ vals, float* __restrict__ prod,
                            long long S, int d, long long B, int m, Sources src, int T) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per_warp = T / kWarps;  // rows a warp takes, in turn
  const int slot = m > 0 ? m + 1 : 0;
  float* tile = smem;  // [T, d] grouped rows' products
  // this warp's (c, s) slots: a_i at 2i, b_i at 2i + 1
  float* cs = smem + T * d + warp * 2 * kMaxSources * slot;
  const long long r0 = static_cast<long long>(blockIdx.x) * T;

  // 1. ids: out ids on lanes < T, the warp's gather ids on lanes
  // 32 - per_warp·n .. 31 (source i of the warp's row k at lane
  // 31 - (i·per_warp + k))
  const bool tile_lane = lane < T && r0 + lane < B;
  const int key = repro::dedup_key(tile_lane ? __ldg(out_ids + r0 + lane) : -1, S,
                                   tile_lane, lane);
  int gid = 0;
  {
    const int u = 31 - lane, i = u / per_warp, k = u - i * per_warp;
    const long long b = r0 + warp + kWarps * k;
    if (kVariant != kNoGathers && i < src.n && b < B) {
      const int* ids = i == 0 ? src.ids[0] : i == 1 ? src.ids[1] : i == 2 ? src.ids[2] : src.ids[3];
      gid = __ldg(ids + b);
    }
  }
  const unsigned group = match(key, lane);
  const bool dup_tile = __any_sync(kFull, key >= 0 && __popc(group) > 1);  // block-wide

  for (int k = 0; k < per_warp; ++k) {
    const int r = warp + kWarps * k;  // the row within the tile
    const long long b = r0 + r;
    const unsigned mine = __shfl_sync(kFull, group, r);
    const int id = __shfl_sync(kFull, key, r);
    long long grow[kMaxSources];
#pragma unroll
    for (int i = 0; i < kMaxSources; ++i) {
      const int g = __shfl_sync(kFull, gid, 31 - (i * per_warp + k));
      grow[i] = i < src.n ? clamp_row(g, src.rows[i]) * d : 0;
    }
    if (b >= B) continue;  // the same for the whole warp
    const bool grouped = dup_tile && id >= 0 && __popc(mine) > 1;
    float* row = view + static_cast<long long>(id >= 0 ? id : 0) * d;
    const repro::RowSplit split = repro::row_split(row, d);
    const int rounds = (split.groups() + 31) >> 5;
    const float* v = vals + b * d;

    // columns of round `round`: x from the value row, y[i] from source i
    auto load = [&](int round, float(&x)[4], float(&y)[kMaxSources][4]) {
      const int g = lane + 32 * round;
      const int c0 = split.start(g), n = g < split.groups() ? split.width(g) : 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) x[t] = t < n ? __ldg(v + c0 + t) : 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxSources; ++i) {
        const float* p = i == 0 ? src.plane[0] : i == 1 ? src.plane[1]
                         : i == 2 ? src.plane[2] : src.plane[3];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          y[i][t] = i < src.n && t < n && kVariant != kNoGathers ? __ldg(p + grow[i] + c0 + t)
                                                                 : x[t];
        }
      }
    };

    __syncwarp();  // the previous row's (c, s) slots are read
    float x[4], y[kMaxSources][4];
    load(0, x, y);
    QCoord first{0, 0};
    bool have = false;
    int step_i = 0, step_j = 0;  // 128 columns: (i, j) += (step_i, step_j)
    if (m > 0) {
      step_i = 128 / m;
      step_j = 128 - step_i * m;
    }
    for (int round = 0; round < rounds; ++round) {
      float xn[4], yn[kMaxSources][4];
      if (round + 1 < rounds) load(round + 1, xn, yn);
      const int g = lane + 32 * round;
      const int c0 = split.start(g), n = g < split.groups() ? split.width(g) : 0;
      const int p0 = c0 - 1 - m;
      if (m > 0 && p0 >= 0) {
        if (have) {  // c0 moved by 128 columns since the last round
          first.i += step_i;
          first.j += step_j;
          if (first.j >= m) {
            first.j -= m;
            ++first.i;
          }
        } else {
          first.i = p0 / m;
          first.j = p0 - first.i * m;
          have = true;
        }
      }
      const ColumnTerms terms(c0, p0 >= 0 ? first : QCoord{0, p0}, m);
#pragma unroll
      for (int i = 0; i < kMaxSources; ++i) {
        if (i >= src.n) break;
        const float* A = cs + 2 * i * slot;
        const float* Bs = A + slot;
        if (round == 0 && m > 0) {  // the (c, s) columns all lie in round 0
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            if (t < n && c0 + t <= m) {
              cs[2 * i * slot + c0 + t] = x[t];
              cs[(2 * i + 1) * slot + c0 + t] = y[i][t];
            }
          }
          __syncwarp();
        }
        if (kVariant == kNoProduct) {
#pragma unroll
          for (int t = 0; t < 4; ++t) repro::keep(y[i][t]);
          continue;
        }
        if (m == 0) {
#pragma unroll
          for (int t = 0; t < 4; ++t) x[t] = __fmul_rn(x[t], y[i][t]);
        } else {
          ring_mul_group(x, y[i], terms, A, Bs);
        }
      }
      if (prod != nullptr) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (t < n) prod[b * d + c0 + t] = x[t];
        }
      }
      if (grouped) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (t < n) tile[r * d + c0 + t] = x[t];
        }
      } else if (id >= 0 && g < split.groups()) {
        reduce(row, split, g, x);
      }
      if (round + 1 < rounds) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          x[t] = xn[t];
#pragma unroll
          for (int i = 0; i < kMaxSources; ++i) y[i][t] = yn[i][t];
        }
      }
    }
  }
  if (!dup_tile) return;  // the same for the whole block
  __syncthreads();
  for (int k = 0; k < per_warp; ++k) {
    const int r = warp + kWarps * k;
    const unsigned mine = __shfl_sync(kFull, group, r);
    const int id = __shfl_sync(kFull, key, r);
    if (id < 0 || __popc(mine) < 2 || __ffs(mine) - 1 != r) continue;
    float* row = view + static_cast<long long>(id) * d;
    const repro::RowSplit split = repro::row_split(row, d);
    for (int g = lane; g < split.groups(); g += 32) {
      const int c0 = split.start(g), n = split.width(g);
      float x[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) x[t] = t < n ? tile[r * d + c0 + t] : 0.0f;
      for (unsigned rest = mine & (mine - 1); rest; rest &= rest - 1) {
        const int f = __ffs(rest) - 1;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (t < n) x[t] = __fadd_rn(x[t], tile[f * d + c0 + t]);
        }
      }
      reduce(row, split, g, x);
    }
  }
}

}  // namespace

// Shared memory of the d >= 2 kernel, bytes: the tile and the (c, s) slots
// (ring_fused.chain_smem_bytes).
inline size_t chain_smem(int d, int m, int tile_rows) {
  const size_t slot = m > 0 ? static_cast<size_t>(m) + 1 : 0;
  return sizeof(float) * (static_cast<size_t>(tile_rows) * d + kWarps * 2 * kMaxSources * slot);
}

// view [S, d] += vals [B, d] ⊗ Π plane_i [rows_i, d] row ids_i[b], at
// out_ids[b], for n_src <= 4 sources (pointers past n_src are ignored);
// prod [B, d] receives the per-row product unless it is null.  m = 0 for
// the scalar ring, else the degree m (1 + m + m² <= d, m <= 123: the (c, s)
// columns lie in a lane's first round).  tile_rows is 32 at d = 1 and 8,
// 16 or 32 otherwise.
extern "C" int repro_fused_chain(float* view, const int* out_ids, const float* vals,
                                 float* prod, long long S, int d, long long B, int m,
                                 int n_src, const float* p0, const float* p1,
                                 const float* p2, const float* p3, const int* i0,
                                 const int* i1, const int* i2, const int* i3,
                                 long long r0, long long r1, long long r2,
                                 long long r3, int tile_rows, cudaStream_t stream) {
  const bool tile_ok = d == 1 ? tile_rows == 32
                              : (tile_rows == 8 || tile_rows == 16 || tile_rows == 32);
  if (n_src < 0 || n_src > kMaxSources || !tile_ok || m < 0 || m > 123 ||
      (m > 0 && 1 + m + static_cast<long long>(m) * m > d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Sources src = {{p0, p1, p2, p3}, {i0, i1, i2, i3}, {r0, r1, r2, r3}, n_src};
  if (B * static_cast<long long>(d) > 0) {
    if (d == 1) {
      const long long blocks = (B + repro::kThreads - 1) / repro::kThreads;
      fused_chain_kernel_lanes<<<static_cast<unsigned>(blocks), repro::kThreads, 0, stream>>>(
          view, out_ids, vals, prod, S, B, src);
    } else {
      const size_t smem = chain_smem(d, m, tile_rows);
      cudaError_t err = repro::allow_smem(fused_chain_kernel_rows, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      const long long blocks = (B + tile_rows - 1) / tile_rows;
      fused_chain_kernel_rows<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(
          view, out_ids, vals, prod, S, d, B, m, src, tile_rows);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_DEFINE_ERROR_STRING(repro_fused_chain)
