// Open-addressed key tables of sparse view storage: the sentinel of a free
// slot and the hash, shared by hash_probe.cu and hash_insert.cu.  The hash
// is the reference's (repro/core/storage.py::_hash_ids): the id as an
// unsigned 32-bit word times Knuth's constant, wrapped mod 2^32, masked to
// a power-of-two capacity.
#pragma once

namespace repro {

constexpr int kEmpty = -1;

__device__ __forceinline__ int hash_slot(int id, int capacity) {
  return static_cast<int>((static_cast<unsigned>(id) * 2654435761u) &
                          static_cast<unsigned>(capacity - 1));
}

}  // namespace repro
