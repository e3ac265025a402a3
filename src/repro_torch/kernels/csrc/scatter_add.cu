// ⊎ on Hopper: scatter-add of a [B, d] float32 payload batch into an
// [S, d] float32 view, in place.
//
// Replaces: src/repro/kernels/ring_scatter.py::scatter_add_onehot (Pallas
// body _scatter_kernel).  The TPU kernel builds one-hot [B, S] blocks in
// VMEM and contracts them on the MXU because a TPU has no fast scatter.  On
// Hopper that form would spend S·B·d multiply-adds on B·d payload values;
// the card has float32 reductions that resolve in L2, so each payload row
// becomes adds into its view row.
//
// Bound: bytes.  A call reads B·d·4 bytes of values and B·4 bytes of ids,
// and reads and writes back the touched view rows (U·d·4 each way for U
// distinct ids); it does one add per element, far below the card's rate.
// Design: one warp per batch row, with a grid stride over rows.  Lane 0
// reads the row's id and shuffles it to the warp, so no element pays an
// index division.  The view row's 16-byte aligned interior takes Hopper's
// vector reductions, one per four columns; the scalar head before it and
// tail after it take scalar reductions (repro::RowSplit, common.cuh; at
// d = 111 where the row starts within 16 bytes depends on its id).  The
// view stays where it is in device memory and is never copied.  Rows whose
// id is < 0 or >= S are padding and drop.  Duplicate ids of one batch meet
// in the reductions in no fixed order: the sum is exact for integer-valued
// payloads and within float32 rounding otherwise.
#include "common.cuh"

namespace {

__global__ void scatter_add_kernel(float* __restrict__ view,
                                   const int* __restrict__ ids,
                                   const float* __restrict__ vals,
                                   long long S, int d, long long B) {
  const int lane = threadIdx.x & 31;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long b = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       b < B; b += warps) {
    int id = lane == 0 ? __ldg(ids + b) : 0;
    id = __shfl_sync(0xffffffffu, id, 0);
    if (id < 0 || id >= S) continue;  // the same for the whole warp
    float* row = view + static_cast<long long>(id) * d;
    const float* src = vals + b * d;
    const repro::RowSplit split = repro::row_split(row, d);
    for (int g = lane; g < split.groups(); g += 32) {
      const int c0 = split.start(g), n = split.width(g);
      float x[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) x[t] = t < n ? __ldg(src + c0 + t) : 0.0f;
      repro::reduce_group(row, split, g, x);
    }
  }
}

}  // namespace

// view [S, d] += values [B, d] at ids [B]; all contiguous, on one device.
extern "C" int repro_scatter_add(float* view, const int* ids, const float* vals,
                                 long long S, int d, long long B,
                                 cudaStream_t stream) {
  if (B > 0 && d > 0) {
    scatter_add_kernel<<<repro::grid_for(32 * B), repro::kThreads, 0, stream>>>(
        view, ids, vals, S, d, B);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_DEFINE_ERROR_STRING(repro_scatter_add)
