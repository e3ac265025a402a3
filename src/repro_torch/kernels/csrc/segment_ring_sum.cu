// Segment sum of ring payload rows on Hopper: out[s, :] = Σ values[b, :]
// over the rows b whose segment id is s.
//
// Replaces: src/repro/kernels/segment_ring_sum.py::segment_ring_sum (Pallas
// body _kernel), the inner kernel of the compact ⊎
// (src/repro/kernels/scatter_ops.py::_compact_scatter).  The TPU kernel
// contracts one-hot [B, S] blocks on the MXU; here the Python wrapper sorts
// the ids once (stable) and hands this kernel the row order and the
// segment offsets, as the reference argsorts and ranks outside its kernel.
//
// Bound: bytes.  A call reads B·d·4 bytes of values, B·4 of the row order
// and (S+1)·4 of offsets, and writes S·d·4 bytes of sums; it does one add
// per value.  Design: one warp per segment, its 32 lanes on neighbouring
// columns, so each row's read and each sum's write coalesce; every output
// element is written exactly once, so the wrapper allocates the output
// without zeroing it.  Each lane adds its column's rows in sorted order
// with no atomics, so the result is the same on every run.
#include "common.cuh"

namespace {

__global__ void segment_ring_sum_kernel(const float* __restrict__ vals,
                                        const int* __restrict__ order,
                                        const int* __restrict__ offsets,
                                        long long S, int d,
                                        float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long s = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       s < S; s += warps) {
    const int lo = __ldg(offsets + s);
    const int hi = __ldg(offsets + s + 1);
    for (int j = lane; j < d; j += 32) {
      float acc = 0.0f;
      for (int r = lo; r < hi; ++r) {
        acc += __ldg(vals + static_cast<long long>(__ldg(order + r)) * d + j);
      }
      out[s * d + j] = acc;
    }
  }
}

}  // namespace

// out [S, d] = segment sums of values [B, d]; order [B] lists the rows by
// segment and offsets [S + 1] bounds each segment's run in it.
extern "C" int repro_segment_ring_sum(const float* vals, const int* order,
                                      const int* offsets, long long S, int d,
                                      float* out, cudaStream_t stream) {
  const long long n = S * 32;
  if (S > 0 && d > 0) {
    segment_ring_sum_kernel<<<repro::grid_for(n), repro::kThreads, 0, stream>>>(
        vals, order, offsets, S, d, out);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_DEFINE_ERROR_STRING(repro_segment_ring_sum)
