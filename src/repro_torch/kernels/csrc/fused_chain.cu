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
// (L2 holds a 9216 x 111 float32 plane, 4.1 MB) and each block reads only
// the rows its tile gathers, so no bound on source rows is needed; the
// plan-time model (ring_fused.chain_smem_bytes) bounds the block's shared
// memory instead.
//
// Design: one block per tile of `tile_rows` batch rows (grid stride over
// tiles).  1. The tile's value rows and out ids go to shared memory.
// 2. For each source, the gathered rows (ids clamped into range, as the
// reference's jnp.take(..., mode="clip")) go to a second tile, and
// 3. the ring product of the two tiles goes to a third, one thread per
// (row, column), term by term in ring_mul_flat's order with
// round-to-nearest multiplies and adds (__fmul_rn/__fadd_rn: nvcc would
// otherwise contract a*b + c into an FMA and round differently from the
// plain PyTorch version).  4. When the caller asks for it (a later plan op
// reads the chain's end delta), the per-row product is written to `prod`.
// 5. The tile's out ids dedup in shared memory (repro::tile_dedup_*,
// common.cuh) and each (distinct id, column) issues one atomic add.
//
// Bound: bytes for the scalar ring; for the degree-m ring about 1 + 3m²
// flops per product element against 4 bytes per source row element, still
// bytes at d = 111.  A call reads B·d·4 bytes of values, 4·B bytes of ids
// per source and the gathered source rows, writes the product when asked,
// and reads and writes back the touched view rows.  Shared memory:
// 3 · tile_rows · d floats and 2 · tile_rows ints.  Rows whose out id is
// < 0 or >= S are padding and drop.  Atomics reorder duplicate adds across
// tiles: exact for integer-valued payloads.
#include "common.cuh"

namespace {

constexpr int kMaxSources = 4;

// The kernel's argument struct: up to kMaxSources (plane, ids) pairs.  The
// plan keeps a chain with more sources unfused.
struct Sources {
  const float* plane[kMaxSources];
  const int* ids[kMaxSources];
  long long rows[kMaxSources];
  int n;
};

// Column c of a ⊗ b for one row, a and b [d] in shared memory.  m = 0 is
// the scalar ring (columnwise product); m > 0 the degree-m ring (c, s, Q)
// with c at column 0, s at 1..m and Q row-major after it, where columns
// past 1 + m + m² are padding and stay zero.
__device__ inline float ring_mul_col(const float* a, const float* b, int c, int m) {
  if (m == 0) return __fmul_rn(a[c], b[c]);
  const float ca = a[0], cb = b[0];
  if (c == 0) return __fmul_rn(ca, cb);
  if (c <= m) return __fadd_rn(__fmul_rn(a[c], cb), __fmul_rn(ca, b[c]));
  const int p = c - 1 - m;
  if (p >= m * m) return 0.0f;
  const int i = p / m, j = p - i * m;
  // q = qa·cb + ca·qb, then + sa_i·sb_j, then + sb_i·sa_j
  float q = __fadd_rn(__fmul_rn(a[c], cb), __fmul_rn(ca, b[c]));
  q = __fadd_rn(q, __fmul_rn(a[1 + i], b[1 + j]));
  q = __fadd_rn(q, __fmul_rn(b[1 + i], a[1 + j]));
  return q;
}

__global__ void fused_chain_kernel(float* __restrict__ view,
                                   const int* __restrict__ out_ids,
                                   const float* __restrict__ vals,
                                   float* __restrict__ prod, long long S, int d,
                                   long long B, int m, Sources src, int tile_rows) {
  extern __shared__ float smem[];
  const int td = tile_rows * d;
  float* gat = smem + td;  // [T, d] gathered source rows
  int* ids_s = reinterpret_cast<int*>(smem + 3 * td);  // [T]
  int* lead = ids_s + tile_rows;                       // [T]
  const long long tiles = (B + tile_rows - 1) / tile_rows;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    float* cur = smem;           // [T, d] running product
    float* nxt = smem + 2 * td;  // [T, d] next product
    const long long r0 = t * tile_rows;
    const int n = static_cast<int>(B - r0 < tile_rows ? B - r0 : tile_rows);
    const float* v = vals + r0 * d;
    for (int e = threadIdx.x; e < n * d; e += blockDim.x) cur[e] = __ldg(v + e);
    for (int r = threadIdx.x; r < n; r += blockDim.x) ids_s[r] = __ldg(out_ids + r0 + r);
    for (int i = 0; i < src.n; ++i) {
      const float* plane = src.plane[i];
      const int* ids = src.ids[i];
      const long long last = src.rows[i] - 1;
      for (int e = threadIdx.x; e < n * d; e += blockDim.x) {
        const int r = e / d;
        long long g = __ldg(ids + r0 + r);
        g = g < 0 ? 0 : (g > last ? last : g);
        gat[e] = __ldg(plane + g * d + (e - r * d));
      }
      __syncthreads();
      for (int e = threadIdx.x; e < n * d; e += blockDim.x) {
        const int r = e / d;
        nxt[e] = ring_mul_col(cur + r * d, gat + r * d, e - r * d, m);
      }
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    if (prod != nullptr) {
      float* p = prod + r0 * d;
      for (int e = threadIdx.x; e < n * d; e += blockDim.x) p[e] = cur[e];
    }
    __syncthreads();
    repro::tile_dedup_leaders(ids_s, lead, n, S);
    __syncthreads();
    repro::tile_dedup_scatter(view, d, ids_s, lead, cur, n);
    __syncthreads();  // the next tile overwrites the shared arrays
  }
}

}  // namespace

// view [S, d] += vals [B, d] ⊗ Π plane_i [rows_i, d] row ids_i[b], at
// out_ids[b], for n_src <= 4 sources (pointers past n_src are ignored);
// prod [B, d] receives the per-row product unless it is null.  m = 0 for
// the scalar ring, else the degree m (d = 1 + m + m²).
extern "C" int repro_fused_chain(float* view, const int* out_ids, const float* vals,
                                 float* prod, long long S, int d, long long B, int m,
                                 int n_src, const float* p0, const float* p1,
                                 const float* p2, const float* p3, const int* i0,
                                 const int* i1, const int* i2, const int* i3,
                                 long long r0, long long r1, long long r2,
                                 long long r3, int tile_rows, cudaStream_t stream) {
  if (n_src < 0 || n_src > kMaxSources) return static_cast<int>(cudaErrorInvalidValue);
  Sources src = {{p0, p1, p2, p3}, {i0, i1, i2, i3}, {r0, r1, r2, r3}, n_src};
  if (B * static_cast<long long>(d) > 0) {
    const size_t smem = sizeof(float) * 3 * static_cast<size_t>(tile_rows) * d +
                        sizeof(int) * 2 * static_cast<size_t>(tile_rows);
    cudaError_t err = repro::allow_smem(fused_chain_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tiles = (B + tile_rows - 1) / tile_rows;
    fused_chain_kernel<<<repro::grid_for_tiles(tiles), repro::kThreads, smem, stream>>>(
        view, out_ids, vals, prod, S, d, B, m, src, tile_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_DEFINE_ERROR_STRING(repro_fused_chain)
