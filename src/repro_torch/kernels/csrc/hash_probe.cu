// Probe of a sparse view's key table on Hopper: for each id, the slot where
// it lives or the first free slot of its chain, and the row a gather reads.
//
// Replaces: src/repro/core/storage.py::_find_slots and ::_probe_slots, the
// reference's probe loops (lax.while_loop, lockstep and per row; no Pallas
// kernel).  In PyTorch the loop's test, jnp.any(pending), would be a host
// read each round, which CUDA graph capture refuses; here the whole probe
// is one launch.
//
// Bound: bytes.  A call reads B ids (or the key columns they are
// linearized from) and, for each, the table words of its chain (1.83 on
// average at the housing tables), and writes a slot, a flag and a gather
// row an id.  The first version walked a chain a thread, one dependent
// load a slot, and read the final slot once more for the flag.  Design: a
// group of kGroup = 8 lanes (faster than 4 at the main path's 2,000-id
// probes, PERF.md section 6) takes one id and loads 8 consecutive slots
// of its chain at once (wrapping mod C; one or two 32-byte sectors);
// __ballot_sync over cur == id || cur == EMPTY finds the first stop in
// chain order, which is the slot the sequential walk stops at, and the
// ballot of cur == id at that lane is the flag.  A chain
// shorter than 8 is one dependent load.  A full table that holds neither
// the id nor a free slot ends where it began after C slots (slot
// hash(id), found false), as the walk does.  Ids below 0 are padding: not
// probed, slot hash(0) = 0, found false.
//
// The keyed form takes the delta's key matrix and the view's columns and
// strides (hash_table.cuh's KeySpec, by value) and linearizes in the
// kernel, so a sibling gather needs no stacked key copy, no linear-id pass
// and no torch.where around the probe: it writes the gather row id
// found ? slot : C (the plane's zero row C for a missed key) beside slot
// and found.
#include "common.cuh"
#include "hash_table.cuh"

namespace {

constexpr int kGroup = 8;  // lanes that probe one id together

__global__ void __launch_bounds__(repro::kThreads)
hash_probe_kernel(const int* __restrict__ table, const int* __restrict__ src,
                  const repro::KeySpec spec, int* __restrict__ slot_out,
                  bool* __restrict__ found_out, int* __restrict__ row_out, int C,
                  long long B) {
  constexpr int kPerWarp = 32 / kGroup;
  constexpr unsigned kGroupBits = (1u << kGroup) - 1u;
  const int lane = threadIdx.x & 31, sub = lane % kGroup, group = lane / kGroup;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  const unsigned mask = static_cast<unsigned>(C - 1);
  for (long long w = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       w * kPerWarp < B; w += warps) {
    const long long b = w * kPerWarp + group;
    const bool live = b < B;
    const int id = live ? repro::id_of(src, spec, b) : -1;
    const unsigned h = static_cast<unsigned>(repro::hash_slot(id >= 0 ? id : 0, C));
    int slot = static_cast<int>(h);
    bool found = false, done = id < 0;
    for (int base = 0; base < C && __any_sync(repro::kFullMask, !done); base += kGroup) {
      const int s = static_cast<int>((h + base + sub) & mask);
      const int cur = done ? 0 : __ldg(table + s);
      const unsigned stop =
          (__ballot_sync(repro::kFullMask, !done && (cur == id || cur == repro::kEmpty)) >>
           (group * kGroup)) & kGroupBits;
      const unsigned hit = (__ballot_sync(repro::kFullMask, !done && cur == id) >>
                            (group * kGroup)) & kGroupBits;
      if (stop) {
        const int first = __ffs(stop) - 1;
        slot = static_cast<int>((h + base + first) & mask);
        found = (hit >> first) & 1u;
        done = true;
      }
    }
    if (live && sub == 0) {
      slot_out[b] = slot;
      found_out[b] = found;
      if (row_out) row_out[b] = found ? slot : C;
    }
  }
}

}  // namespace

// slot [B], found [B] and (where rows is not null) the gather row rows [B]
// of the B ids spec names in src (hash_table.cuh) in table [C] (C a power
// of two).
extern "C" int repro_hash_probe(const int* table, const int* src, repro::KeySpec spec,
                                int* slot, bool* found, int* rows, int C, long long B,
                                cudaStream_t stream) {
  if (spec.arity < 0 || spec.arity > repro::kMaxKeyArity) return cudaErrorInvalidValue;
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  hash_probe_kernel<<<repro::grid_for(B * kGroup), repro::kThreads, 0, stream>>>(
      table, src, spec, slot, found, rows, C, B);
  return static_cast<int>(cudaGetLastError());
}

REPRO_DEFINE_ERROR_STRING(repro_hash_probe)
