// Insert into a sparse view's key table on Hopper, in place, building exactly
// the table of the reference's lockstep rounds.
//
// Replaces: src/repro/core/storage.py::_insert_ids, the reference's insert
// loop (a lax.while_loop that ends on jnp.any(pending); no Pallas kernel),
// and, as hash_insert_targets, the composition of _rank_ids, _insert_ids
// and the gather back to rows that fused_slot_targets and
// gather_mul_scatter run.  In PyTorch the loop's test would be a host read
// each round, which CUDA graph capture refuses; here the whole insert is one
// launch.
//
// Two entries share one kernel, a template on the claim priority:
// * hash_insert: distinct ids; the lowest row wins a contended slot;
// * hash_insert_targets: a batch's raw ids, duplicates and sentinels
//   included; the smallest id wins.  That is the reference's result:
//   _rank_ids orders the distinct ids ascending, so its lowest row is the
//   smallest id, and rows of one id start at one slot, advance together,
//   claim with one value and write one word.  No rank prepass (an argsort,
//   a cumsum and scatters) runs before it.
//
// Each round, as the reference's, at most C + B of them: (1) every pending
// row reads its slot; a hit resolves the row; a free slot is claimed with
// an atomicMin of the row's priority on the slot's claim word; another key
// sends the row one slot on; (2) each claimant reads its claim word: the
// winner writes its id, the losers advance one slot.  A claimed slot is
// always won, so it is never claimed again, and the claim words are set
// free once a call.  A row still pending after C + B rounds (a full table)
// and an id below 0 are not placed.
//
// Bound: bytes, at one read of each id (or key row) and of each table word
// on its chain and one write of each result; the first version (one block,
// table and claim words read through L2 between barriers, a claim [C]
// scratch allocated and reset in every call) was latency bound at 3,500x
// that bound.  Routes, which the wrapper picks from C and B (neither falls
// back to the other; a refused launch is an error):
// * cta (C <= 16,384, B <= 8,192): one block of up to 1,024 threads keeps
//   the table and the claim words in shared memory (64 KB at the housing
//   tables' 8,192 slots, 128 KB at most), the table loaded by one bulk copy
//   (cp.async.bulk on an mbarrier); the rows' state (id, slot, flag bits)
//   lives in registers, up to 8 rows a thread; __syncthreads separates the
//   phases and ORs the rows still pending.  A won slot is written to the
//   shared copy and the global table at once, so the table is updated in
//   place with no copy back.
// * global (any size): one block of 1,024 threads; the table and the claim
//   words are read through L2 (__ldcg) between block barriers and the rows'
//   state lives in a global scratch buffer (claim [C], id, slot and state
//   [B]): the first version's form.
#include "common.cuh"
#include "hash_table.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxRows = 8;           // rows a thread keeps in registers
constexpr int kSlotsPerBlock = 16384; // table and claim words: 128 KB
constexpr int kClaimFree = 0x7fffffff;

enum Route : int { kRouteCta = 0, kRouteGlobal = 1 };

// Where the results go: (slot, placed) for hash_insert (slot 0 where not
// placed), or target (the slot, EMPTY where not placed) for
// hash_insert_targets; rounds, where not null, receives the rounds run.
struct Out {
  int* slot;
  bool* placed;
  int* target;
  int* rounds;
};

__device__ __forceinline__ void write_row(const Out& o, long long b, bool ok, int s) {
  if (o.target) {
    o.target[b] = ok ? s : repro::kEmpty;
  } else {
    o.slot[b] = ok ? s : 0;
    o.placed[b] = ok;
  }
}

template <int R, bool kById>
__global__ void __launch_bounds__(kMaxThreads)
smem_insert_kernel(int* __restrict__ table, const int* __restrict__ src,
                   const repro::KeySpec spec, const Out out, int C, int B) {
  extern __shared__ __align__(16) int smem[];
  __shared__ __align__(8) unsigned long long bar;
  int* tab = smem;
  int* claim = smem + C;
  const int t = threadIdx.x, T = blockDim.x;
  // the table: one bulk copy where it is 16-byte aligned, else word by word
  const bool bulk = C % 4 == 0 && (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  const uint32_t bar_addr = repro::smem_u32(&bar);
  if (bulk && t == 0) {
    repro::mbar_init(bar_addr, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const uint32_t bytes = static_cast<uint32_t>(C) * 4u;
    repro::mbar_expect_tx(bar_addr, bytes);
    for (uint32_t off = 0; off < bytes; off += 16384u) {
      const uint32_t n = bytes - off < 16384u ? bytes - off : 16384u;
      repro::bulk_load(reinterpret_cast<char*>(tab) + off,
                       reinterpret_cast<const char*>(table) + off, n, bar_addr);
    }
  }
  if (!bulk) {
    for (int c = t; c < C; c += T) tab[c] = table[c];
  }
  for (int c = t; c < C; c += T) claim[c] = kClaimFree;
  // the rows of this thread: b = t, t + T, ...; state in registers, flags
  // as bits
  int id[R], slot[R];
  unsigned pending = 0, placed = 0;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int b = t + k * T;
    id[k] = b < B ? repro::id_of(src, spec, b) : -1;
    slot[k] = repro::hash_slot(id[k] >= 0 ? id[k] : 0, C);
    if (id[k] >= 0) pending |= 1u << k;
  }
  if (bulk) {
    __syncthreads();  // the barrier's init before any thread waits on it
    repro::mbar_wait(bar_addr, 0);
  }
  // the table and the claim words set before the first round
  bool any = __syncthreads_or(pending != 0) != 0;
  const long long max_rounds = static_cast<long long>(C) + B;
  long long rounds_run = 0;
  for (; any && rounds_run < max_rounds; ++rounds_run) {
    // (1) read: hit, claim a free slot, or advance past another key
    unsigned claimed = 0;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (!((pending >> k) & 1u)) continue;
      const int cur = tab[slot[k]];
      if (cur == id[k]) {
        pending &= ~(1u << k);
        placed |= 1u << k;
      } else if (cur == repro::kEmpty) {
        atomicMin(claim + slot[k], kById ? id[k] : t + k * T);
        claimed |= 1u << k;
      } else {
        slot[k] = (slot[k] + 1) & (C - 1);
      }
    }
    __syncthreads();
    // (2) the claimant whose priority the claim word holds writes its id;
    // the others advance
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (!((claimed >> k) & 1u)) continue;
      if (claim[slot[k]] == (kById ? id[k] : t + k * T)) {
        tab[slot[k]] = id[k];
        table[slot[k]] = id[k];
        pending &= ~(1u << k);
        placed |= 1u << k;
      } else {
        slot[k] = (slot[k] + 1) & (C - 1);
      }
    }
    any = __syncthreads_or(pending != 0) != 0;
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int b = t + k * T;
    if (b < B) write_row(out, b, (placed >> k) & 1u, slot[k]);
  }
  if (out.rounds && t == 0) *out.rounds = static_cast<int>(rounds_run);
}

// The global route: per-row state codes, kept in scratch during the rounds.
enum : int { kPending = 0, kPlaced = 1, kClaimed = 2, kSkipped = 3 };

template <bool kById>
__global__ void __launch_bounds__(kMaxThreads)
global_insert_kernel(int* __restrict__ table, const int* __restrict__ src,
                     const repro::KeySpec spec, const Out out, int* __restrict__ claim,
                     int* __restrict__ ids, int* __restrict__ slot, int* __restrict__ state,
                     int C, int B) {
  const int t = threadIdx.x, T = blockDim.x;
  for (int c = t; c < C; c += T) claim[c] = kClaimFree;
  bool left = false;
  for (int b = t; b < B; b += T) {
    const int id = repro::id_of(src, spec, b);
    ids[b] = id;
    slot[b] = repro::hash_slot(id >= 0 ? id : 0, C);
    state[b] = id >= 0 ? kPending : kSkipped;
    left |= id >= 0;
  }
  bool any = __syncthreads_or(left);
  const long long max_rounds = static_cast<long long>(C) + B;
  long long rounds_run = 0;
  for (; any && rounds_run < max_rounds; ++rounds_run) {
    for (int b = t; b < B; b += T) {
      if (state[b] != kPending) continue;
      const int s = slot[b], cur = __ldcg(table + s), id = ids[b];
      if (cur == id) {
        state[b] = kPlaced;
      } else if (cur == repro::kEmpty) {
        atomicMin(claim + s, kById ? id : b);
        state[b] = kClaimed;
      } else {
        slot[b] = (s + 1) & (C - 1);
      }
    }
    __syncthreads();
    left = false;
    for (int b = t; b < B; b += T) {
      const int st = state[b];
      if (st == kClaimed) {
        const int s = slot[b], id = ids[b];
        if (__ldcg(claim + s) == (kById ? id : b)) {
          table[s] = id;
          state[b] = kPlaced;
          continue;
        }
        slot[b] = (s + 1) & (C - 1);
        state[b] = kPending;
        left = true;
      } else if (st == kPending) {
        left = true;
      }
    }
    any = __syncthreads_or(left);
  }
  for (int b = t; b < B; b += T) write_row(out, b, state[b] == kPlaced, slot[b]);
  if (out.rounds && t == 0) *out.rounds = static_cast<int>(rounds_run);
}

template <int R, bool kById>
cudaError_t launch_smem(int* table, const int* src, const repro::KeySpec& spec, const Out& out,
                        int C, int B, int threads, cudaStream_t stream) {
  const auto kernel = smem_insert_kernel<R, kById>;
  // opted into once an instance: the largest table's dynamic shared memory
  static bool smem_allowed = false;
  if (!smem_allowed) {
    const cudaError_t err = repro::allow_smem(kernel, 2 * kSlotsPerBlock * sizeof(int));
    if (err != cudaSuccess) return err;
    smem_allowed = true;
  }
  kernel<<<1, threads, 2 * static_cast<size_t>(C) * sizeof(int), stream>>>(table, src, spec,
                                                                          out, C, B);
  return cudaGetLastError();
}

template <bool kById>
cudaError_t dispatch(int* table, const int* src, const repro::KeySpec& spec, const Out& out,
                     int* scratch, int C, int B, int route, cudaStream_t stream) {
  if (route == kRouteCta) {
    if (C > kSlotsPerBlock) return cudaErrorInvalidValue;
    const int threads = B >= kMaxThreads ? kMaxThreads : ((B + 31) / 32) * 32;
    const long long rows = (static_cast<long long>(B) + threads - 1) / threads;
#define REPRO_ROWS(r) \
  if (rows <= r) return launch_smem<r, kById>(table, src, spec, out, C, B, threads, stream);
    REPRO_ROWS(1)
    REPRO_ROWS(2)
    REPRO_ROWS(4)
    REPRO_ROWS(8)
#undef REPRO_ROWS
    return cudaErrorInvalidValue;  // more than kMaxRows rows a thread
  }
  if (route != kRouteGlobal || scratch == nullptr) return cudaErrorInvalidValue;
  int* claim = scratch;
  int* ids = claim + C;
  int* slot = ids + B;
  int* state = slot + B;
  global_insert_kernel<kById><<<1, kMaxThreads, 0, stream>>>(table, src, spec, out, claim, ids,
                                                             slot, state, C, B);
  return cudaGetLastError();
}

}  // namespace

// The B ids spec names in src (hash_table.cuh; distinct, or any with
// by_id) into table [C] (a power of two), in place, by route (0 cta, 1
// global, whose scratch holds C + 3 B words).  Out: slot [B] and placed
// [B], or (by_id) target [B]; rounds [1] where not null.
extern "C" int repro_hash_insert(int* table, const int* src, repro::KeySpec spec, int* slot,
                                 bool* placed, int* target, int* rounds, int* scratch, int C,
                                 int B, int route, int by_id, cudaStream_t stream) {
  if (spec.arity < 0 || spec.arity > repro::kMaxKeyArity) return cudaErrorInvalidValue;
  if (by_id ? target == nullptr : (slot == nullptr || placed == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const Out out{by_id ? nullptr : slot, by_id ? nullptr : placed, by_id ? target : nullptr,
                rounds};
  return by_id ? dispatch<true>(table, src, spec, out, scratch, C, B, route, stream)
               : dispatch<false>(table, src, spec, out, scratch, C, B, route, stream);
}

REPRO_DEFINE_ERROR_STRING(repro_hash_insert)
