// ⊎ with in-tile key dedup on Hopper: view[ids[b], :] += vals[b, :], in
// place, where each tile of batch rows first sums its duplicate ids.
//
// Replaces: src/repro/kernels/ring_scatter.py::scatter_add_onehot with
// dedup=True (Pallas body _scatter_dedup_kernel, which calls tile_dedup),
// the reference's onehot_dedup ⊎ backend.  The TPU kernel collapses a
// tile's duplicate ids with a 0/1 matmul in VMEM before its one-hot
// contraction.  Here one block takes one tile of `tile_rows` batch rows,
// stages its ids and value rows in shared memory, marks each row's first
// occurrence (repro::tile_dedup_leaders, common.cuh) and issues one float32
// atomic add per (distinct id, column) (repro::tile_dedup_scatter).  A tile
// whose rows all hit one id (a collapsed-to-scalar view) costs d atomics
// instead of tile_rows · d.
//
// Bound: bytes.  A call reads B·4 bytes of ids and B·d·4 bytes of values,
// and reads and writes back the touched view rows; one add per element.
// Shared memory: tile_rows · d floats and 2 · tile_rows ints (the wrapper
// sizes tile_rows so that this stays far below the 227 KB a block may
// take).  Rows whose id is < 0 or >= S are padding and drop.  Exact for
// integer-valued payloads; otherwise within float32 rounding of any order.
#include "common.cuh"

namespace {

__global__ void scatter_dedup_kernel(float* __restrict__ view,
                                     const int* __restrict__ ids,
                                     const float* __restrict__ vals,
                                     long long S, int d, long long B,
                                     int tile_rows) {
  extern __shared__ float smem[];
  float* tile = smem;                                           // [T, d]
  int* ids_s = reinterpret_cast<int*>(tile + tile_rows * d);    // [T]
  int* lead = ids_s + tile_rows;                                // [T]
  const long long tiles = (B + tile_rows - 1) / tile_rows;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r0 = t * tile_rows;
    const int n = static_cast<int>(B - r0 < tile_rows ? B - r0 : tile_rows);
    const float* src = vals + r0 * d;
    for (int e = threadIdx.x; e < n * d; e += blockDim.x) tile[e] = __ldg(src + e);
    for (int r = threadIdx.x; r < n; r += blockDim.x) ids_s[r] = __ldg(ids + r0 + r);
    __syncthreads();
    repro::tile_dedup_leaders(ids_s, lead, n, S);
    __syncthreads();
    repro::tile_dedup_scatter(view, d, ids_s, lead, tile, n);
    __syncthreads();  // the next tile overwrites the shared arrays
  }
}

}  // namespace

// view [S, d] += vals [B, d] at ids [B], duplicates summed per tile of
// tile_rows rows; all contiguous, on one device.
extern "C" int repro_scatter_dedup(float* view, const int* ids, const float* vals,
                                   long long S, int d, long long B, int tile_rows,
                                   cudaStream_t stream) {
  if (B * static_cast<long long>(d) > 0) {
    const size_t smem = sizeof(float) * static_cast<size_t>(tile_rows) * d +
                        sizeof(int) * 2 * static_cast<size_t>(tile_rows);
    cudaError_t err = repro::allow_smem(scatter_dedup_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tiles = (B + tile_rows - 1) / tile_rows;
    scatter_dedup_kernel<<<repro::grid_for_tiles(tiles), repro::kThreads, smem, stream>>>(
        view, ids, vals, S, d, B, tile_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_DEFINE_ERROR_STRING(repro_scatter_dedup)
