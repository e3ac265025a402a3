// Batched degree-m ring product on Hopper (paper Def. 7.2), for K keys:
//   c = c_a c_b
//   s = c_b s_a + c_a s_b
//   Q = ((c_b Q_a + c_a Q_b) + s_a s_bᵀ) + s_b s_aᵀ
//
// Replaces: src/repro/kernels/ring_mul.py::ring_mul (Pallas body _kernel).
// The TPU kernel walks (K, m/bm, m/bm) blocks and forms the two outer
// products on the MXU as rank-1 dot_generals, adding them to each other
// first.  Here every output element is one thread's handful of scalar
// operations, in the order of the plain version (ref.ring_mul_ref) and of
// Ring.mul, each rounded once (__fmul_rn/__fadd_rn: nvcc would otherwise
// contract a*b + c into an FMA), so the result equals both bit for bit on
// any float32 data.
//
// Bound: bytes.  A call reads the two operands' 1 + m + m² floats per key
// and writes as many; it does at most 7 flops per element.  Design: a grid
// stride over the K·(1 + m + m²) output elements (each thread steps its key
// and column by the stride without dividing), neighbouring threads on
// neighbouring elements of one key, so the Q reads and writes coalesce and
// the key's c and s reads hit L1.  The operands are read through per-key
// strides, so the components may be column slices of one [K, d] payload
// plane (the engine's layout) as well as separate contiguous tensors.
#include "common.cuh"

namespace {

struct Operand {
  const float* c;
  const float* s;
  const float* Q;
  long long sc, ss, sQ;  // per-key strides (floats); s and Q are dense inside a key
};

__global__ void ring_mul_kernel(Operand a, Operand b, long long K, int m,
                                float* __restrict__ c, float* __restrict__ s,
                                float* __restrict__ Q) {
  const long long d = 1 + m + static_cast<long long>(m) * m;
  const long long n = K * d;
  const long long e0 = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  // (k, col) of element e, advanced by the grid stride without a division
  const long long dk = step / d;
  const int dcol = static_cast<int>(step - dk * d);
  long long k = e0 / d;
  int col = static_cast<int>(e0 - k * d);
  for (long long e = e0; e < n; e += step, k += dk, col += dcol) {
    if (col >= d) {
      col -= static_cast<int>(d);
      ++k;
    }
    const float ca = __ldg(a.c + k * a.sc), cb = __ldg(b.c + k * b.sc);
    if (col == 0) {
      c[k] = __fmul_rn(ca, cb);
      continue;
    }
    const float* sa = a.s + k * a.ss;
    const float* sb = b.s + k * b.ss;
    if (col <= m) {
      const int i = col - 1;
      s[k * m + i] = __fadd_rn(__fmul_rn(cb, __ldg(sa + i)), __fmul_rn(ca, __ldg(sb + i)));
      continue;
    }
    const int p = col - 1 - m;
    const int i = p / m, j = p - i * m;
    float q = __fadd_rn(__fmul_rn(cb, __ldg(a.Q + k * a.sQ + p)),
                        __fmul_rn(ca, __ldg(b.Q + k * b.sQ + p)));
    q = __fadd_rn(q, __fmul_rn(__ldg(sa + i), __ldg(sb + j)));
    q = __fadd_rn(q, __fmul_rn(__ldg(sb + i), __ldg(sa + j)));
    Q[k * m * m + p] = q;
  }
}

}  // namespace

// c [K], s [K, m], Q [K, m, m] (contiguous) = a ⊗ b, where each operand's
// components sit at key k at c + k·sc, s + k·ss (m floats) and Q + k·sQ
// (m·m floats, row-major).
extern "C" int repro_ring_mul(const float* ca, const float* sa, const float* Qa,
                              long long sca, long long ssa, long long sQa,
                              const float* cb, const float* sb, const float* Qb,
                              long long scb, long long ssb, long long sQb,
                              long long K, int m, float* c, float* s, float* Q,
                              cudaStream_t stream) {
  const Operand a = {ca, sa, Qa, sca, ssa, sQa};
  const Operand b = {cb, sb, Qb, scb, ssb, sQb};
  const long long n = K * (1 + m + static_cast<long long>(m) * m);
  if (n > 0) {
    ring_mul_kernel<<<repro::grid_for(n), repro::kThreads, 0, stream>>>(a, b, K, m, c,
                                                                         s, Q);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_DEFINE_ERROR_STRING(repro_ring_mul)
