// Rank-1 accumulate on Hopper: out[i, j] = V[i, j] + u[i]·v[j], for V and
// out [n, m] float32, out a new tensor (the reference is out of place too).
//
// Replaces: src/repro/kernels/rank1_chain.py::outer_accumulate (Pallas body
// _outer_acc_kernel), the ⊎-apply of a factorized rank-1 delta to a
// materialized view (ops.rank1_chain_update).  The TPU kernel forms each
// [bm, bn] block of u vᵀ on the MXU and adds it to V's block in VMEM; the
// outer product never reaches HBM, and here it never leaves registers.
//
// Bound: bytes (reads V, writes out: 8 bytes per element for 2 flops).
// Design: a grid stride over the elements, 16-byte loads and stores where
// m % 4 == 0 and the pointers are aligned.  Each element is one rounded
// multiply and one rounded add (__fmul_rn/__fadd_rn, no FMA contraction),
// so the result equals V + torch.outer(u, v) bit for bit on any data.
#include <cstdint>

#include "common.cuh"

namespace {

__global__ void outer_acc_vec_kernel(const float4* __restrict__ V,
                                     const float* __restrict__ u,
                                     const float* __restrict__ v, long long n,
                                     long long m, float4* __restrict__ out) {
  const long long m4 = m / 4;
  const long long total = n * m4;
  for (long long q = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       q < total; q += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = q / m4;
    const long long j = (q - i * m4) * 4;
    const float ui = __ldg(u + i);
    const float4 a = __ldg(V + q);
    const float4 b = __ldg(reinterpret_cast<const float4*>(v + j));
    out[q] = make_float4(__fadd_rn(a.x, __fmul_rn(ui, b.x)), __fadd_rn(a.y, __fmul_rn(ui, b.y)),
                         __fadd_rn(a.z, __fmul_rn(ui, b.z)), __fadd_rn(a.w, __fmul_rn(ui, b.w)));
  }
}

__global__ void outer_acc_kernel(const float* __restrict__ V, const float* __restrict__ u,
                                 const float* __restrict__ v, long long n, long long m,
                                 float* __restrict__ out) {
  const long long total = n * m;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = e / m;
    out[e] = __fadd_rn(__ldg(V + e), __fmul_rn(__ldg(u + i), __ldg(v + (e - i * m))));
  }
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

}  // namespace

// out [n, m] = V [n, m] + u [n] v [m]ᵀ (all contiguous float32).
extern "C" int repro_outer_accumulate(const float* V, const float* u, const float* v,
                                      long long n, long long m, float* out,
                                      cudaStream_t stream) {
  if (n * m > 0) {
    if (m % 4 == 0 && aligned16(V) && aligned16(v) && aligned16(out)) {
      outer_acc_vec_kernel<<<repro::grid_for(n * m / 4), repro::kThreads, 0, stream>>>(
          reinterpret_cast<const float4*>(V), u, v, n, m, reinterpret_cast<float4*>(out));
    } else {
      outer_acc_kernel<<<repro::grid_for(n * m), repro::kThreads, 0, stream>>>(V, u, v, n,
                                                                              m, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_DEFINE_ERROR_STRING(repro_outer_accumulate)
