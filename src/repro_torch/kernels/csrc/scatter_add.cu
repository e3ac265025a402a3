// ⊎ on Hopper: scatter-add of a [B, d] float32 payload batch into an
// [S, d] float32 view, in place.
//
// Replaces: src/repro/kernels/ring_scatter.py::scatter_add_onehot (Pallas
// body _scatter_kernel).  The TPU kernel builds one-hot [B, S] blocks in
// VMEM and contracts them on the MXU because a TPU has no fast scatter.  On
// Hopper that form would spend S·B·d multiply-adds on B·d payload values;
// the card has float32 atomics that resolve in L2, so each payload element
// becomes one atomic add into its view row.
//
// Bound: bytes.  A call reads B·d·4 bytes of values and B·4 bytes of ids,
// and reads and writes back the touched view rows (U·d·4 each way for U
// distinct ids); it does one add per element, far below the card's rate.
// Design: one thread per (row b, column j), neighbouring threads on
// neighbouring columns, so both the value reads and the view-row updates
// coalesce; the view stays where it is in device memory and is never
// copied.  Rows whose id is < 0 or >= S are padding and drop.  Duplicate
// ids of one batch meet in the atomics in no fixed order: the sum is exact
// for integer-valued payloads and within float32 rounding otherwise.
#include "common.cuh"

namespace {

__global__ void scatter_add_kernel(float* __restrict__ view,
                                   const int* __restrict__ ids,
                                   const float* __restrict__ vals,
                                   long long S, int d, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < n; t += stride) {
    const long long b = t / d;
    const int id = __ldg(ids + b);
    if (id >= 0 && id < S) {
      atomicAdd(view + static_cast<long long>(id) * d + (t - b * d), __ldg(vals + t));
    }
  }
}

}  // namespace

// view [S, d] += values [B, d] at ids [B]; all contiguous, on one device.
extern "C" int repro_scatter_add(float* view, const int* ids, const float* vals,
                                 long long S, int d, long long B,
                                 cudaStream_t stream) {
  const long long n = B * static_cast<long long>(d);
  if (n > 0) {
    scatter_add_kernel<<<repro::grid_for(n), repro::kThreads, 0, stream>>>(
        view, ids, vals, S, d, n);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_DEFINE_ERROR_STRING(repro_scatter_add)
