// Insert of distinct keys into a sparse view's key table on Hopper, in
// place, building exactly the table of the reference's lockstep rounds.
//
// Replaces: src/repro/core/storage.py::_insert_ids, the reference's insert
// loop (a lax.while_loop that ends on jnp.any(pending); no Pallas kernel).
// In PyTorch that test would be a host read each round, which CUDA graph
// capture refuses; here the whole insert is one launch.
//
// Each round, as the reference's: (1) every pending row reads its slot; a
// hit resolves the row; a row that meets a free slot claims it with an
// atomicMin of its row index on the slot's claim word; (2) the winner of
// each claimed slot (the lowest row) writes its id; (3) the losers, and the
// rows that met another key, advance one slot.  At most C + B rounds; a row
// still pending then (a full table) reports placed = false and slot 0, as
// does a row whose id is below 0 (not inserted).  The table a round writes
// is what the next round reads, so the phases are separated by block
// barriers, and the rounds run in one block of 1024 threads that walks the
// rows with a stride.  A barrier orders global memory for the threads of
// one block, and the table and claim words are read through L2 (__ldcg), so
// no thread reads a stale word.
//
// Bound: bytes, at one read of each id and of each table word on its chain
// and one write of each result; the kernel is latency bound instead (one
// block, three barriers a round, rounds = the longest chain), which at the
// main path's batches (at most a few thousand ids, chains of a few slots)
// is a few microseconds.  A multi-block form would need a grid-wide barrier
// a phase.
//
// Scratch: claim [C] (set free here), and the per-row state lives in the
// outputs: slot [B] is the row's current slot, placed [B] its state code
// until the last pass turns it into 0 or 1.
#include "common.cuh"
#include "hash_table.cuh"

namespace {

constexpr int kInsertThreads = 1024;
constexpr int kClaimFree = 0x7fffffff;

// per-row state codes, kept in placed[] during the rounds
enum : unsigned char { kPending = 0, kPlaced = 1, kClaimed = 2, kWon = 3,
                       kLost = 4, kSkipped = 5 };

__global__ void __launch_bounds__(kInsertThreads)
hash_insert_kernel(int* __restrict__ table, const int* __restrict__ ids,
                   int* __restrict__ claim, int* __restrict__ slot,
                   unsigned char* __restrict__ state, int C, int B) {
  const int t = threadIdx.x, T = blockDim.x;
  for (int c = t; c < C; c += T) claim[c] = kClaimFree;
  bool pending = false;
  for (int b = t; b < B; b += T) {
    const int id = ids[b];
    slot[b] = repro::hash_slot(id >= 0 ? id : 0, C);
    state[b] = id >= 0 ? kPending : kSkipped;
    pending |= id >= 0;
  }
  pending = __syncthreads_or(pending);
  const long long rounds = static_cast<long long>(C) + B;
  for (long long r = 0; pending && r < rounds; ++r) {
    // (1) read the slot: a hit resolves, a free slot is claimed
    for (int b = t; b < B; b += T) {
      if (state[b] != kPending) continue;
      const int s = slot[b], cur = __ldcg(table + s), id = ids[b];
      if (cur == id) {
        state[b] = kPlaced;
      } else if (cur == repro::kEmpty) {
        atomicMin(claim + s, b);
        state[b] = kClaimed;
      }
    }
    __syncthreads();
    // (2) the lowest claimant of each slot writes its id
    for (int b = t; b < B; b += T) {
      if (state[b] != kClaimed) continue;
      const int s = slot[b];
      if (__ldcg(claim + s) == b) {
        table[s] = ids[b];
        state[b] = kWon;
      } else {
        state[b] = kLost;
      }
    }
    __syncthreads();
    // (3) winners free their claim word; the rest advance one slot
    bool left = false;
    for (int b = t; b < B; b += T) {
      const unsigned char st = state[b];
      if (st == kWon) {
        claim[slot[b]] = kClaimFree;
        state[b] = kPlaced;
      } else if (st == kLost || st == kPending) {
        slot[b] = (slot[b] + 1) & (C - 1);
        state[b] = kPending;
        left = true;
      }
    }
    pending = __syncthreads_or(left);
  }
  for (int b = t; b < B; b += T) {
    const bool ok = state[b] == kPlaced;
    if (!ok) slot[b] = 0;
    state[b] = ok ? 1 : 0;
  }
}

}  // namespace

// ids [B] (distinct, EMPTY = skip) into table [C] (a power of two), in
// place; slot [B] and placed [B] (bool) out; claim [C] is scratch.
extern "C" int repro_hash_insert(int* table, const int* ids, int* claim,
                                 int* slot, bool* placed, int C, int B,
                                 cudaStream_t stream) {
  if (B > 0) {
    hash_insert_kernel<<<1, kInsertThreads, 0, stream>>>(
        table, ids, claim, slot, reinterpret_cast<unsigned char*>(placed), C,
        B);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_DEFINE_ERROR_STRING(repro_hash_insert)
