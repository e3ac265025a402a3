// Probe of a sparse view's key table on Hopper: for each id, the slot where
// it lives or the first free slot of its chain.
//
// Replaces: src/repro/core/storage.py::_find_slots and ::_probe_slots, the
// reference's probe loops (lax.while_loop, lockstep and per row; no Pallas
// kernel).  In PyTorch the loop's test, jnp.any(pending), would be a host
// read each round, which CUDA graph capture refuses; here the whole probe
// is one launch.
//
// Bound: bytes.  A call reads B ids and, for each, the table words of its
// chain (one at a load factor far below 0.7, a few more under contention),
// and writes a slot and a flag per id.  Design: one thread an id with a grid
// stride; each walks its own chain and ends as soon as it resolves (the
// per-row form of the reference; the lockstep form gives the same slots).
// At most C steps: a full table without the id ends where it began.  Ids
// below 0 are padding: not probed, slot hash(0) = 0, found false.
#include "common.cuh"
#include "hash_table.cuh"

namespace {

__global__ void hash_probe_kernel(const int* __restrict__ table,
                                  const int* __restrict__ ids,
                                  int* __restrict__ slot_out,
                                  bool* __restrict__ found_out, int C,
                                  long long B) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       b < B; b += stride) {
    const int id = ids[b];
    const bool valid = id >= 0;
    int slot = repro::hash_slot(valid ? id : 0, C);
    if (valid) {
      for (int i = 0; i < C; ++i) {
        const int cur = __ldg(table + slot);
        if (cur == id || cur == repro::kEmpty) break;
        slot = (slot + 1) & (C - 1);
      }
    }
    slot_out[b] = slot;
    found_out[b] = valid && __ldg(table + slot) == id;
  }
}

}  // namespace

// slot [B], found [B] of ids [B] in table [C] (C a power of two).
extern "C" int repro_hash_probe(const int* table, const int* ids, int* slot,
                                bool* found, int C, long long B,
                                cudaStream_t stream) {
  if (B > 0) {
    hash_probe_kernel<<<repro::grid_for(B), repro::kThreads, 0, stream>>>(
        table, ids, slot, found, C, B);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_DEFINE_ERROR_STRING(repro_hash_probe)
