// Open-addressed key tables of sparse view storage: the sentinel of a free
// slot, the hash and the source of a call's ids, shared by hash_probe.cu
// and hash_insert.cu.  The hash is the reference's
// (repro/core/storage.py::_hash_ids): the id as an unsigned 32-bit word
// times Knuth's constant, wrapped mod 2^32, masked to a power-of-two
// capacity.
#pragma once

namespace repro {

constexpr int kEmpty = -1;

// The key columns a kernel linearizes itself: 3, the widest key of the
// retailer and housing plans (the retailer's V0@units).  The wrappers
// linearize a wider key before the launch and pass its ids (arity 0).
constexpr int kMaxKeyArity = 3;

__device__ __forceinline__ int hash_slot(int id, int capacity) {
  return static_cast<int>((static_cast<unsigned>(id) * 2654435761u) &
                          static_cast<unsigned>(capacity - 1));
}

// Where a call's ids come from, passed by value.  arity 0: src is an id
// column, id b = src[b].  arity k > 0: src is an int32 key matrix with rows
// row_stride words apart, and id b is the view key of its columns col[0..k)
// linearized row-major as storage.linear_ids does: the sum of
// key[col[j]] * stride[j] in int32, wrapping mod 2^32.
struct KeySpec {
  int arity;
  int row_stride;
  int col[kMaxKeyArity];
  int stride[kMaxKeyArity];
};

__device__ __forceinline__ int id_of(const int* __restrict__ src, const KeySpec& k,
                                     long long b) {
  if (k.arity == 0) return __ldg(src + b);
  const int* row = src + b * k.row_stride;
  unsigned v = 0;
#pragma unroll
  for (int j = 0; j < kMaxKeyArity; ++j) {
    if (j < k.arity) {
      v += static_cast<unsigned>(__ldg(row + k.col[j])) * static_cast<unsigned>(k.stride[j]);
    }
  }
  return static_cast<int>(v);
}

}  // namespace repro
