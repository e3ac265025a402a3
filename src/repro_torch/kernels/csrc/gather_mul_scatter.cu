// Fused sibling gather, scale and ⊎ on Hopper:
// view[out_ids[b], :] += scale[b] · src[in_ids[b], :], in place.
//
// Replaces: src/repro/kernels/ring_scatter.py::gather_mul_scatter (Pallas
// body _gms_kernel), reached from BatchedDelta.apply_to when a deferred
// sibling gather meets the final ⊎.  The TPU kernel gathers with a one-hot
// matmul against the whole source plane held in VMEM, so its dispatch only
// takes it while the source has at most MAX_FUSED_SRC = 4096 rows.  Here
// each thread reads its source element straight from device memory (L2
// holds the hot rows), so the source is never staged whole and that guard
// does not apply: (S, Sg) = (96, 9216) launches this kernel too.
//
// Bound: bytes.  A call reads 3·B·4 bytes of ids and scales, the gathered
// source rows (at most B·d·4 bytes) and reads and writes back the touched
// view rows; one multiply and one add per element.  Design: one thread per
// (row b, column j), neighbouring threads on neighbouring columns; the
// [B, d] product never exists in device memory.  Rows whose out_id is < 0
// or >= S are padding and drop; in_ids clamp to [0, Sg - 1] as the
// reference's jnp.take(..., mode="clip") does, so a padding row that keeps
// a valid out_id must carry scale 0.  Duplicate out_ids meet in the
// atomics in no fixed order: exact for integer-valued payloads.
#include "common.cuh"

namespace {

__global__ void gather_mul_scatter_kernel(float* __restrict__ view,
                                          const int* __restrict__ out_ids,
                                          const float* __restrict__ src,
                                          const int* __restrict__ in_ids,
                                          const float* __restrict__ scale,
                                          long long S, long long Sg, int d,
                                          long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < n; t += stride) {
    const long long b = t / d;
    const int oid = __ldg(out_ids + b);
    if (oid >= 0 && oid < S) {
      long long iid = __ldg(in_ids + b);
      iid = iid < 0 ? 0 : (iid >= Sg ? Sg - 1 : iid);
      const long long j = t - b * d;
      const float v = __ldg(src + iid * d + j) * __ldg(scale + b);
      atomicAdd(view + static_cast<long long>(oid) * d + j, v);
    }
  }
}

}  // namespace

// view [S, d] += scale[b] · src [Sg, d] row in_ids[b], at out_ids[b].
extern "C" int repro_gather_mul_scatter(float* view, const int* out_ids,
                                        const float* src, const int* in_ids,
                                        const float* scale, long long S,
                                        long long Sg, int d, long long B,
                                        cudaStream_t stream) {
  const long long n = B * static_cast<long long>(d);
  if (n > 0 && Sg > 0) {
    gather_mul_scatter_kernel<<<repro::grid_for(n), repro::kThreads, 0, stream>>>(
        view, out_ids, src, in_ids, scale, S, Sg, d, n);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_DEFINE_ERROR_STRING(repro_gather_mul_scatter)
