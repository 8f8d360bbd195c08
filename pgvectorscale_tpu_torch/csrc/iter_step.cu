// One refill of the streaming iterator's expansion, one launch and one
// block, for sm_90a.
//
// Replaces the JAX package's `lax.while_loop` in `iter_step`
// (pgvectorscale_tpu/graph/iterate.py:279; cond :206, body :213), which
// the port ran as blocks of 16 masked steps from the host (one host read a
// block, ~30 launches a step and one edge-gather launch a visit).  The
// wrapper (ops/iter_step.py) seeds the window with the best `emit_n`
// unemitted visited rows (a library sort over the table, as JAX's
// `lax.top_k` outside its loop) and marks the emitted rows afterwards;
// this kernel runs the loop between: while fewer than `visit_budget` nodes
// were expanded and the frontier's best entry is closer than the window's
// worst, one step, in the order of JAX's body:
//  1. expand frontier slot 0 (the frontier is ascending): mark it visited
//     and keep its distance in `vdist`;
//  2. insert the visit into the sorted window after every equal entry (a
//     stable sort of the window with the visit appended), dropping the last;
//  3. slot 0 becomes INVALID_ID / +inf;
//  4. read its R neighbours and drop INVALID ones, visited ones, ones in the
//     frontier and in-row duplicates (the first slot of an id survives);
//  5. score the rest: Hamming on the codes (hamming.cuh), or full precision
//     on the rows' prefix (rowdist.cuh);
//  6. merge the candidates, ordered by (distance, slot), with the frontier
//     and keep the best F: the stable sort of concat([frontier, candidates]).
// Step 6 does not take the frontier as sorted after step 3, since slot 0
// is then +inf: the stable order of the frontier alone is its slots 1..m
// (the finite ones, ascending), then slot 0, then its other +inf slots.  A
// frontier entry's place in the merge is its place there plus the
// candidates below its distance; a candidate's is its rank among the
// candidates plus the frontier entries at most its distance.  That holds
// whatever ids the +inf entries carry.
//
// Bound on an H100: the chain.  Every step waits on the adjacency row of
// the node it expands, then on the visited flags and code (or vector) rows
// of its neighbours, and the next step's node is known only after the
// merge; phase 14's 1M-row table does not stay in the 50 MB L2, so a step
// whose rows come from device memory takes two dependent device-memory
// latencies; the rest of a step is its bookkeeping, one block on one SM.
// What the card showed (microbench/smem_ops.cu, iter_ab.py): a dependent
// shared-memory load takes ~29 cycles alone and ~340 while the block's
// other warps keep random global loads in flight, a load whose predicate
// is off costs as much as one that runs, and a loop that each lane leaves
// on its own (a probe loop with an atomic in it) runs a lane at a time.
// Design, one block of 256 threads:
// - The next step's loads in this one.  The merge's next node is known
//   right after the scoring barrier: the best candidate when it is below
//   the frontier's slot 1 (whose row was started at the step's start),
//   else slot 1.  Its slots' ids (the best candidate's row), or their
//   visited flags and code rows (slot 1's, whose ids are in), are loaded
//   then, into registers, while the step merges; every step after the
//   first finds its first round of slots started.  A unit of lanes takes
//   a slot: on the codes hamming.cuh's group of lanes, neighbouring lanes
//   on neighbouring chunks, as many lanes a row as leave R slots in one
//   round of the block (further rounds, as at R = 260, load as they go).
// - The checks once the loads are in: the frontier's set and the row's
//   table (each slot under its id with atomicMin, the least slot kept) are
//   open-addressing hash tables in shared memory, probed by a warp's lanes
//   together (straight-line for the first probes, a loop only while a
//   lane needs more).  The frontier's set is kept from step to step: the
//   entering candidates go in, dropped entries leave tombstones (the
//   expanded node's id may stay: it is visited), and it is made anew in a
//   spare once it holds f + min(f, its half - f - R) entries, or every
//   step when the frontier came in with an id twice (a reseed's).
// - The window's insert position and the frontier's finite entries are
//   found by one warp each (32 entries tested a round); the window shifts
//   through registers, 1,024 entries a round, loads and stores across the
//   step's barriers.
// - The survivors are listed as candidates below the frontier's last
//   finite entry (low: they may enter anywhere) or above it (high: only
//   into the frontier's free places), with 64-bit keys (distance bits,
//   slot) and the step's least key.  A low candidate's place is its rank
//   among the low ones plus the frontier entries at most its distance; a
//   high one's, m + the low ones + its rank among the high ones, while
//   places are free (with one free place, the least key's alone).  A
//   frontier entry moves by the low candidates below it; the merged
//   frontier goes to the other of two buffers.  Three block barriers a
//   step on the codes, four in full precision, whose survivors' rows are
//   read a warp a row.
// The frontier, the window, the tables and the query's prefix sit in
// shared memory, or, for a state over the shared limit, in a scratch
// buffer of device memory through the same code; `visited` / `vdist` are
// the wrapper's copies in device memory (thread 0 stores a visit's vdist at
// the end of its step, off the chain).
//
// Plain C interface for ctypes: raw pointers, sizes and the caller's
// stream.  The function launches, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hamming.cuh"
#include "rowdist.cuh"

// The phase stamps of microbench/iter_ab.py, which defines them; none
// otherwise.
#ifndef PGVS_PHASE_INIT
#define PGVS_PHASE_INIT
#define PGVS_PHASE(k)
#define PGVS_PHASE_DEP(k, v)
#define PGVS_PHASE_ADD(k, n)
#define PGVS_PHASE_SAVE(steps)
#define PGVS_WARP_START
#define PGVS_WARP_MARK(k)
#endif

// Test hooks (tests/test_torch_iterate_emulated.py): PGVS_ITER_COLLIDE
// puts every id at the same place of the hash tables; PGVS_ITER_SPEC_MISS
// loads the next node's slots ahead and never uses them; PGVS_ITER_SET_SLACK
// (> 0) makes the frontier's set anew once it holds that many entries past
// the frontier's width.
#ifndef PGVS_ITER_COLLIDE
#define PGVS_ITER_COLLIDE 0
#endif
#ifndef PGVS_ITER_SPEC_MISS
#define PGVS_ITER_SPEC_MISS 0
#endif
#ifndef PGVS_ITER_SET_SLACK
#define PGVS_ITER_SET_SLACK 0
#endif


namespace {

#ifndef PGVS_ITER_THREADS
#define PGVS_ITER_THREADS 256
#endif
constexpr int kThreads = PGVS_ITER_THREADS;
constexpr int kWarps = kThreads / 32;
// A thread's share of the window entries the block shifts in one round of
// an insert (a window of 1,024 at 256 threads in one round).
constexpr int kWinPer = 4;
constexpr int kWinRound = kWinPer * kThreads;
constexpr unsigned kFull32 = 0xffffffffu;
// The most chunks of a code row a lane loads at once (a wider row's lanes
// read the rest after).
constexpr int kMaxCpl = 8;

enum Kind { kCodes = 0, kFull = 1 };
// misc words, each of a pair used by steps of odd and even parity in
// turn: the candidates (below the frontier's last finite entry in the low
// 16 bits, above it in the high 16), the survivors (full precision); then
// the step's least key on the codes (distance << 16 | slot); then the
// window's insert position, the frontier's finite entries past slot 0 and
// the last one's distance; the entries the frontier's set uses, and
// whether the frontier came in with an id twice.
enum { kCands = 0, kSurv = 2, kBest = 4, kAt = 6, kM = 7, kT = 8, kUsed = 9, kTwice = 10,
       kMisc = 12 };
constexpr int kHighOne = 1 << 16;

struct Params {
  const int* adjacency;  // [cap, R]
  // Codes (kCodes).
  const int* codes;  // [cap, W]
  const int* qcode;  // [W]
  // Full precision (kFull).
  const void* vectors;  // [cap, D]: f32, bf16 or int8
  const float* scales;  // [cap]: the int8 rows' scales
  const float* qvec;    // [Dt]
  // The state, read and written in place (the wrapper's copies).
  unsigned char* visited;  // [cap]
  float* vdist;            // [cap]
  // The state in shared memory, or here (null: in shared memory).
  unsigned char* scratch;
  // The state in and the window seed.
  const int* fr_ids_in;    // [F]
  const float* fr_d_in;    // [F]
  const int* win_ids_in;   // [emit_n]
  const float* win_d_in;   // [emit_n]
  const int* n_visits_in;  // [1]
  const int* n_comps_in;   // [1]
  // Out.
  int* fr_ids;    // [F]
  float* fr_d;    // [F]
  int* win_ids;   // [emit_n]
  float* win_d;   // [emit_n]
  int* n_visits;  // [1]
  int* n_comps;   // [1]
  int* steps;     // [1]
  long long stride;  // D, elements a row (kFull)
  int cap, r, f, emit_n, budget, w, chunks, log2g, dt, metric, vec;
  // The state's arrays, in words from its base (Layout::place), and the
  // hash tables' sizes (log2 of entries).
  int o_fr_id, o_win_d, o_win_id, o_fset, o_rkey, o_rslot, o_sid, o_sh, o_sd, o_pl, o_cd, o_ci,
      o_misc, o_keys, fset_log2, rtab_log2, o_state;
};

__host__ __device__ inline int log2_at_least(int x) {
  int l = 1;  // at least 2 entries: the hash takes the top log2 bits
  while ((1 << l) < x) ++l;
  return l;
}

// The state: arrays of 4-byte words, in this order (after the query's
// prefix in shared memory, or in the scratch buffer).  The keys start on
// 16 bytes; after them the least key of the steps of odd and even parity.
struct Layout {
  int f, en, r, fset_log2, rtab_log2;
  __host__ __device__ Layout(int f_, int en_, int r_) : f(f_), en(en_), r(r_) {
    fset_log2 = log2_at_least(4 * f_ + 2 * r_);
    rtab_log2 = log2_at_least(2 * r_);
  }
  __host__ __device__ long long keys_word() const {
    const long long w = 4LL * f + 2LL * en + 2LL * (1 << fset_log2) + 2LL * (1 << rtab_log2) +
                        7LL * r + kMisc;
    return (w + 3) & ~3LL;
  }
  __host__ __device__ long long bytes() const { return (keys_word() + 2LL * r + 4) * 4; }
  void place(Params& p) const {
    p.fset_log2 = fset_log2;
    p.rtab_log2 = rtab_log2;
    p.o_fr_id = 2 * f;                           // [2][F] ids (distances [2][F] at 0)
    p.o_win_d = 4 * f;                           // [emit_n]
    p.o_win_id = p.o_win_d + en;                 // [emit_n]
    p.o_fset = p.o_win_id + en;                  // [2][2^fset_log2] the frontier's ids, spare
    p.o_rkey = p.o_fset + 2 * (1 << fset_log2);  // [2^rtab_log2] the row's ids
    p.o_rslot = p.o_rkey + (1 << rtab_log2);     // [2^rtab_log2] their least slots
    p.o_sid = p.o_rslot + (1 << rtab_log2);      // [R] a slot's id, -1: dropped
    p.o_sh = p.o_sid + r;                        // [R] its row-table entry
    p.o_sd = p.o_sh + r;                         // [R] its distance (codes)
    p.o_pl = p.o_sd + r;                         // [2][R] the survivors' slots, ids (full)
    p.o_cd = p.o_pl + 2 * r;                     // [R] the candidates' distances
    p.o_ci = p.o_cd + r;                         // [R] their ids
    p.o_misc = p.o_ci + r;                       // [kMisc]
    p.o_keys = static_cast<int>(keys_word());    // [R + 2] u64 (distance, slot)
  }
};

// Entries of a[0, n) (ascending) below x (LESS) or at most x, by the 32
// lanes of a warp (every lane must call it; every lane gets the count):
// each round tests 32 evenly spaced entries and narrows to the span
// between the last that passes and the next.
template <bool LESS>
__device__ __forceinline__ int warp_count(const float* a, int n, float x, int lane) {
  int lo = 0, hi = n;  // the count is in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int idx = lo + (lane + 1) * step - 1;
    bool in = false;
    if (idx < hi) in = LESS ? a[idx] < x : a[idx] <= x;
    const int pass = __popc(__ballot_sync(kFull32, in));
    lo += pass * step;
    hi = min(hi, lo + step - 1);
  }
  return lo;
}

// Entries of a[0, n) (ascending) at most x, by one thread: halving steps
// from `top` (a power of two >= n, the same for a warp's lanes), so that
// lanes with other x take as many rounds and stay together.
__device__ __forceinline__ int count_at_most(const float* a, int n, float x, int top) {
  int lo = 0;
  for (int step = top; step > 0; step >>= 1) {
    const int at = lo + step;
    if (at <= n && a[at - 1] <= x) lo = at;
  }
  return lo;
}

// The frontier's stable order after slot 0 left it: slots 1..m, then
// slot 0 (+inf), then slots m+1.. (all +inf).
__device__ __forceinline__ int stable_slot(int i, int m) { return i < m ? i + 1 : (i == m ? 0 : i); }

__device__ __forceinline__ unsigned hash_of(int id, int log2) {
#if PGVS_ITER_COLLIDE
  (void)id;
  (void)log2;
  return 0u;
#else
  return (static_cast<unsigned>(id) * 0x9E3779B1u) >> (32 - log2);
#endif
}

// Open-addressing sets of 2^log2 entries (-1: empty), holding fewer ids
// than entries.  The lanes of a warp that `want` to probe for their id
// (>= 0) do so together, one probe a round each, for as many rounds as the
// warp's longest probe: every lane of the warp must call.  (A loop that
// each lane leaves on its own is run a lane at a time.)
// A dropped id leaves a tombstone (-2), which lookups pass and inserts do
// not reuse.
// The first kProbes probes of a lane are straight-line code; a loop runs
// only while a lane of the warp needs more (a loop with an atomic in it is
// compiled with a yield to the scheduler, which costs every round).
constexpr int kProbes = 2;

// Insert: a present id stays; returns the id's entry, or -1 when not
// wanted; `fresh`: the insert took an empty entry.
__device__ __forceinline__ int warp_set_insert(int* keys, int id, bool want, int log2,
                                               bool& fresh) {
  const unsigned mask = (1u << log2) - 1u;
  unsigned h = hash_of(id, log2);
  int at = -1;
  bool pending = want;
  fresh = false;
  auto probe = [&]() {
    const int prev = atomicCAS(keys + h, -1, id);
    if (prev == -1 || prev == id) {
      at = static_cast<int>(h);
      fresh = prev == -1;
      pending = false;
    } else {
      h = (h + 1) & mask;
    }
  };
#pragma unroll
  for (int k = 0; k < kProbes; ++k) {
    if (pending) probe();
  }
  while (__any_sync(kFull32, pending)) {
    if (pending) probe();
  }
  return at;
}
__device__ __forceinline__ int warp_set_insert(int* keys, int id, bool want, int log2) {
  bool fresh;
  return warp_set_insert(keys, id, want, log2, fresh);
}

// The id's entry, or -1 (absent, or not wanted): a lookup.
__device__ __forceinline__ int warp_set_find(const int* keys, int id, bool want, int log2) {
  const unsigned mask = (1u << log2) - 1u;
  unsigned h = hash_of(id, log2);
  int at = -1;
  bool pending = want;
  auto probe = [&]() {
    const int k = keys[h];
    if (k == id) at = static_cast<int>(h);
    pending = k != id && k != -1;
    h = (h + 1) & mask;
  };
#pragma unroll
  for (int k = 0; k < kProbes; ++k) {
    if (pending) probe();
  }
  while (__any_sync(kFull32, pending)) {
    if (pending) probe();
  }
  return at;
}

// Add the lanes' `one`s to *count, one atomic a warp (every lane must call).
__device__ __forceinline__ void warp_count_add(bool one, int* count) {
  const unsigned m = __ballot_sync(kFull32, one);
  if ((threadIdx.x & 31) == 0 && m) atomicAdd(count, __popc(m));
}

// The rank's key of a candidate: the distance's bits made to order as
// unsigned integers as the floats order (-0.0 first made +0.0, which it
// equals), then the slot.
__device__ __forceinline__ unsigned long long rank_key(float d, int slot) {
  unsigned u = __float_as_uint(d == 0.0f ? 0.0f : d);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(slot);
}

// Append for the lanes of a warp with `put` (every lane must call it): one
// atomic a warp on *count; returns this lane's index.
__device__ __forceinline__ int warp_append(bool put, int* count) {
  const unsigned m = __ballot_sync(kFull32, put);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && m) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(kFull32, base, 0);
  return base + __popc(m & ((1u << lane) - 1u));
}

// warp_append of two kinds at once on a count of the first in the low 16
// bits and the second in the high 16 (every lane must call it): the
// first kind's index from 0 up, the second's from r - 1 down.
__device__ __forceinline__ int warp_append2(bool first, bool second, int* count, int r) {
  const unsigned m1 = __ballot_sync(kFull32, first), m2 = __ballot_sync(kFull32, second);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && (m1 | m2)) base = atomicAdd(count, __popc(m1) + __popc(m2) * kHighOne);
  base = __shfl_sync(kFull32, base, 0);
  const unsigned below = (1u << lane) - 1u;
  return first ? (base & 0xffff) + __popc(m1 & below) : r - 1 - (base >> 16) - __popc(m2 & below);
}

// The least of the lanes' keys into *best (every lane must call it; ~0:
// none): the least distance bits, then the least slot among them.
__device__ __forceinline__ void warp_min_into(unsigned long long key, unsigned long long* best) {
  const unsigned hi = __reduce_min_sync(kFull32, static_cast<unsigned>(key >> 32));
  const unsigned lo = __reduce_min_sync(
      kFull32, static_cast<unsigned>(key >> 32) == hi ? static_cast<unsigned>(key) : ~0u);
  const unsigned long long least = (static_cast<unsigned long long>(hi) << 32) | lo;
  if ((threadIdx.x & 31) == 0 && least != ~0ull) atomicMin(best, least);
}

// KIND kCodes: A the chunk width (1 or 4 ints); kFull: A the row dtype, B
// the query's prefix in shared memory.  S: the state in the scratch buffer.
// A template parameter, not a test of p.scratch, so that with S false every
// state access is a shared-memory one: through a pointer the compiler
// cannot place, each is a generic access, which made a stream refill about
// 8% slower on an H100.
template <int KIND, int A, int B, bool S>
__global__ void __launch_bounds__(kThreads, 1) iter_step_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  using C = pgvs::Chunk<KIND == kCodes ? A : 1>;
  using T = typename C::T;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int f = p.f, en = p.emit_n, r = p.r;
  float* qs = reinterpret_cast<float*>(smem);  // the query's prefix (kFull, B: in shared)
  int* base = reinterpret_cast<int*>(S ? p.scratch : smem + p.o_state);
  float* fr_d_all = reinterpret_cast<float*>(base);  // [2][F]
  int* fr_id_all = base + p.o_fr_id;                 // [2][F]
  float* win_d = reinterpret_cast<float*>(base + p.o_win_d);
  int* win_id = base + p.o_win_id;
  int* fset_all = base + p.o_fset;  // [2][2^fset_log2]
  int* rkey = base + p.o_rkey;
  int* rslot = base + p.o_rslot;
  int* sid = base + p.o_sid;
  int* sh = base + p.o_sh;
  float* sd = reinterpret_cast<float*>(base + p.o_sd);
  int* pl_slot = base + p.o_pl;  // full precision: the survivors to score
  int* pl_id = pl_slot + r;
  float* cd = reinterpret_cast<float*>(base + p.o_cd);  // the candidates: low from 0 up,
  int* ci = base + p.o_ci;                               // high from r - 1 down
  int* misc = base + p.o_misc;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(base + p.o_keys);
  unsigned long long* best = keys + r;  // [2] the least key of a step (by parity)
  const int fset_log2 = p.fset_log2, fset_n = 1 << fset_log2, rtab_log2 = p.rtab_log2;
  PGVS_PHASE_INIT

  if constexpr (KIND == kFull && B) {
    for (int j = tid; j < p.dt; j += kThreads) qs[j] = p.qvec[j];
  }
  for (int j = tid; j < f; j += kThreads) {
    fr_d_all[j] = p.fr_d_in[j];
    fr_id_all[j] = p.fr_ids_in[j];
  }
  for (int j = tid; j < en; j += kThreads) {
    win_d[j] = p.win_d_in[j];
    win_id[j] = p.win_ids_in[j];
  }
  for (int j = tid; j < 2 * fset_n; j += kThreads) fset_all[j] = -1;
  for (int j = tid; j < (1 << rtab_log2); j += kThreads) {
    rkey[j] = -1;
    rslot[j] = 0x7fffffff;
  }
  if (tid < kMisc) misc[tid] = tid == kBest || tid == kBest + 1 ? -1 : 0;
  if (tid < 2) best[tid] = ~0ull;
  // On the codes a key fits 32 bits while a distance (at most 32 W) and a
  // slot each fit 16.
  const bool keys32 = KIND == kCodes && p.w <= 2048 && r <= 65536;
  int nv = *p.n_visits_in, nc = *p.n_comps_in, steps = 0;
  __syncthreads();
  for (int j0 = 0; j0 < f; j0 += kThreads) {
    if (j0 + (warp << 5) >= f) break;  // the warp has no entry left
    const int id = j0 + tid < f ? fr_id_all[j0 + tid] : -1;
    bool fresh;
    warp_set_insert(fset_all, id, id >= 0, fset_log2, fresh);
    warp_count_add(fresh, misc + kUsed);
    warp_count_add(id >= 0 && !fresh, misc + kTwice);
  }
  __syncthreads();
  // An id twice in the frontier (a reseed's) stays in it while either copy
  // does: the set is then made anew every step.
  const bool twice = misc[kTwice] != 0;
  // The entries past f the set may use before it is made anew: with those
  // of a step's inserts it stays at most half full (about a quarter on the
  // default sizes, for short probes).
  const int set_slack = PGVS_ITER_SET_SLACK > 0 ? PGVS_ITER_SET_SLACK : min(f, fset_n / 2 - f - r);

  // The lanes that take a neighbour (a unit): on the codes a group of
  // 2^log2g lanes, B chunks of the row a lane, neighbouring lanes on
  // neighbouring chunks (the launch's shape); in full precision a thread
  // (which scores the survivors a warp a row).  Unit u takes slots u, u +
  // n_units, ... (rounds); the first lane of a unit its bookkeeping.
  const int log2g = KIND == kCodes ? p.log2g : 0;
  const int g = 1 << log2g, lig = tid & (g - 1), unit = tid >> log2g;
  const int n_units = kThreads >> log2g;
  const bool leader = lig == 0;
  constexpr int kCpl = KIND == kCodes ? B : 1;
  const T* qrow = reinterpret_cast<const T*>(p.qcode);

  // The first round of a step's slots, in registers: the slot's id, its
  // visited flag and (codes) this lane's chunks of its row.  `piped` 2: all
  // of them were loaded during the last step (its merge confirmed the node
  // whose row started then); 1: the id was; 0: none was.  x_id: the same
  // slot of the frontier's slot 1's row, started at a step's start.
  int b_id = -1, x_id = -1;
  unsigned b_vis = 1;
  T b_a[kCpl];
  int piped = 0, spec = -1;
  // The visited flag and row chunks of a slot's id.
  auto load_slot = [&](int id, unsigned& vis, T (&a)[kCpl]) {
    const long long row = min(max(id, 0), p.cap - 1);
    vis = leader && id >= 0 ? p.visited[row] : 1;
    if constexpr (KIND == kCodes) {
      const T* crow = reinterpret_cast<const T*>(p.codes + row * p.w);
#pragma unroll
      for (int i = 0; i < kCpl; ++i) {
        const int ch = lig + i * g;
        a[i] = id >= 0 && ch < p.chunks ? __ldg(crow + ch) : C::zero();
      }
    }
  };
  // The distance of a slot's id from its row chunks (every lane of the
  // unit; chunks past the lanes' share read now).
  auto score_slot = [&](int id, const T (&a)[kCpl]) {
    unsigned pop = 0;
    if constexpr (KIND == kCodes) {
#pragma unroll
      for (int i = 0; i < kCpl; ++i) {
        const int ch = lig + i * g;
        if (ch < p.chunks) pop += C::pop_xor(a[i], __ldg(qrow + ch));
      }
      if (id >= 0) {
        const T* crow = reinterpret_cast<const T*>(p.codes + min(id, p.cap - 1) * static_cast<long long>(p.w));
        for (int ch = lig + kCpl * g; ch < p.chunks; ch += g)
          pop += C::pop_xor(__ldg(crow + ch), __ldg(qrow + ch));
      }
      pop = pgvs::group_sum(pop, g);
    }
    return static_cast<float>(pop);
  };

  int cur = 0;       // which of the two frontier buffers holds the frontier
  int live = 0;      // which of the two sets holds its ids
  bool clear = false;  // the spare set is to be cleared (it was the live one)
  while (true) {
    const float* fd = fr_d_all + cur * f;
    const int* fi = fr_id_all + cur * f;
    int* fset = fset_all + live * fset_n;
    int* spare = fset_all + (live ^ 1) * fset_n;
    // The set is kept from step to step, the entering candidates put in and
    // the dropped entries' ids tombstoned (the expanded node's may stay: it
    // is visited), while it stays at most half full; else, or when the
    // frontier came in with an id twice, it is made anew in the spare.
    const bool rebuild = twice || misc[kUsed] > f + set_slack;
    const float nd = fd[0];
    if (!(steps < p.budget && nd < win_d[en - 1])) break;
    // 1: expand slot 0 (finite, so a valid id).
    const int nid = fi[0];
    const long long row = nid < 0 ? 0 : nid;
    const bool hit = !PGVS_ITER_SPEC_MISS && spec >= 0 && nid == spec;
    if (!hit) piped = 0;
    PGVS_PHASE_ADD(10, piped == 2);
    PGVS_PHASE_ADD(11, piped == 1);
    PGVS_PHASE_ADD(13, steps > 0);
    PGVS_WARP_START;
    // vdist's old value is stored over at the end of the step, so that no
    // thread waits on its read.
    float vdist_old = 0.0f;
    if (tid == 0) {
      p.visited[row] = 1;
      vdist_old = p.vdist[row];
    }
    ++steps;
    ++nv;
    const int par = steps & 1;
    const int* adj = p.adjacency + row * r;

    // 4, 5: the slots' ids, their loads (unless the last step started
    // them), the slot of slot 1's row (the next node unless a candidate
    // beats it), then the checks once the loads are in: the frontier's set,
    // the row's table (each slot under its id, the least slot kept), the
    // visited flag, and on the codes the distance.
    if (piped == 0) b_id = unit < r ? __ldg(adj + unit) : -1;
    PGVS_PHASE_DEP(1, b_id);
    if (piped < 2) load_slot(b_id, b_vis, b_a);
    const int nspec = f > 1 && fd[1] < INFINITY ? fi[1] : -1;
    x_id = nspec >= 0 && unit < r
               ? __ldg(p.adjacency + static_cast<long long>(min(nspec, p.cap - 1)) * r + unit)
               : -1;
    PGVS_WARP_MARK(0);
    // A slot that passes the frontier set goes under its id in the row's
    // table, keeping its id's least slot; its id (or -1: dropped), its
    // entry and its distance are kept.
    // Every lane of the warp calls it; `mine`: the lane takes slot c.
    auto check_slot = [&](int id, int c, bool mine, unsigned vis, float d) {
      const bool want = mine && id >= 0 && id != nid;
      const bool in_frontier = warp_set_find(fset, id, want, fset_log2) >= 0;
      PGVS_PHASE_DEP(3, in_frontier);
      const int h = warp_set_insert(rkey, id, want && !in_frontier, rtab_log2);
      if (h >= 0) atomicMin(rslot + h, c);
      if (mine) {
        sid[c] = h >= 0 && vis == 0 ? id : -1;
        sh[c] = h;
        if constexpr (KIND == kCodes) sd[c] = d;
      }
    };
    {
      const float d = score_slot(b_id, b_a);
      PGVS_PHASE_DEP(2, b_vis + static_cast<unsigned>(d));
      PGVS_WARP_MARK(1);
      check_slot(b_id, unit, leader && unit < r, b_vis, d);
    }
    // Slots past the first round, loaded and checked a round at a time.
    for (int c0 = n_units; c0 < r; c0 += n_units) {
      const int c = c0 + unit;
      const int id = c < r ? __ldg(adj + c) : -1;
      unsigned vis;
      T a[kCpl];
      load_slot(id, vis, a);
      const float d = score_slot(id, a);
      check_slot(id, c, leader && c < r, vis, d);
    }
    PGVS_WARP_MARK(2);
    if (clear) {
      for (int j = tid; j < fset_n; j += kThreads) spare[j] = -1;
    }
    // 2: the window's insert position (after every entry <= nd), and m (the
    // finite entries of slots 1..f-1) with the last one's distance: one
    // warp each, the block's last two (the ones least likely to hold slots).
    if (warp == kWarps - 2) {
      const int at = warp_count<false>(win_d, en, nd, lane);
      if (lane == 0) misc[kAt] = at;
    } else if (warp == kWarps - 1) {
      const int m = warp_count<true>(fd + 1, f - 1, INFINITY, lane);
      if (lane == 0) {
        misc[kM] = m;
        reinterpret_cast<float*>(misc)[kT] = m > 0 ? fd[m] : -INFINITY;
      }
    }
    PGVS_WARP_MARK(3);
    PGVS_WARP_MARK(5);
    __syncthreads();
    PGVS_PHASE(4);
    if (rebuild && tid == 0) misc[kUsed] = 0;  // the spare's count from here

    const int at = misc[kAt], m = misc[kM];
    const float t_low = reinterpret_cast<const float*>(misc)[kT];
    // 2: positions at+1.. of the window take their left neighbour (into
    // registers now, stored after the next barrier), in rounds of
    // kWinRound from the top (a round reads below the rounds above it
    // write); a thread's rounds stop at the window's end.
    float wd[kWinPer];
    int wi[kWinPer];
    for (int c = (en - at - 2) / kWinRound; c >= 1; --c) {
      const int j0 = at + 1 + c * kWinRound + tid;
#pragma unroll
      for (int k = 0; k < kWinPer; ++k) {
        if (j0 + k * kThreads >= en) break;
        wd[k] = win_d[j0 + k * kThreads - 1];
        wi[k] = win_id[j0 + k * kThreads - 1];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kWinPer; ++k) {
        if (j0 + k * kThreads >= en) break;
        win_d[j0 + k * kThreads] = wd[k];
        win_id[j0 + k * kThreads] = wi[k];
      }
    }
    const int j0 = at + 1 + tid;
#pragma unroll
    for (int k = 0; k < kWinPer; ++k) {
      if (j0 + k * kThreads >= en) break;
      wd[k] = win_d[j0 + k * kThreads - 1];
      wi[k] = win_id[j0 + k * kThreads - 1];
    }
    PGVS_PHASE(0);
    PGVS_WARP_MARK(6);

    // 4: the survivors: a slot that passed every check and is its id's
    // least slot.  On the codes each is listed as a candidate below the
    // frontier's last finite entry (low: it may enter anywhere) or above it
    // (high: only into the frontier's free places), with its key, and the
    // step's least key kept; in full precision listed to be scored.
    int* n_cands = misc + kCands + par;
    for (int c0 = 0; c0 < r; c0 += kThreads) {
      if (c0 + (warp << 5) >= r) break;  // the warp has no slot left
      const int c = c0 + tid;
      bool put = false;
      if (c < r) {
        const int h = sh[c];
        const bool won = h >= 0 && rslot[h] == c;
        put = won && sid[c] >= 0;
        sh[c] = won ? h : -1;  // the entry this slot clears
      }
      if constexpr (KIND == kCodes) {
        const float d = put ? sd[c] : 0.0f;
        const bool low = put && d <= t_low, high = put && !low;
        const unsigned long long key = put ? rank_key(d, c) : ~0ull;
        const int j = warp_append2(low, high, n_cands, r);
        if (put) {
          cd[j] = d;
          ci[j] = sid[c];
          keys[j] = key;
        }
        if (keys32) {
          const unsigned k32 = __reduce_min_sync(
              kFull32, put ? static_cast<unsigned>(d) << 16 | static_cast<unsigned>(c) : ~0u);
          if (lane == 0 && k32 != ~0u) atomicMin(reinterpret_cast<unsigned*>(misc) + kBest + par, k32);
        } else {
          warp_min_into(key, best + par);
        }
      } else {
        const int j = warp_append(put, misc + kSurv + par);
        if (put) {
          pl_slot[j] = c;
          pl_id[j] = sid[c];
        }
      }
    }
    PGVS_WARP_MARK(7);
    __syncthreads();
    if constexpr (KIND == kFull) {
      // The survivors' rows, a warp a row; each listed as on the codes (a
      // row at +inf is counted and never enters: the frontier's +inf
      // entries come before it).
      const int ns = misc[kSurv + par];
      nc += ns;
      for (int j = warp; j < ns; j += kWarps) {
        const long long vrow = min(max(pl_id[j], 0), p.cap - 1);
        const void* ptr = static_cast<const char*>(p.vectors) +
                          vrow * p.stride * pgvs::row_elem_bytes<A>();
        const float scale = A == pgvs::kRowI8 ? __ldg(p.scales + vrow) : 1.0f;
        const float d = pgvs::warp_row_distance<A, B != 0>(ptr, scale, B ? qs : p.qvec, p.dt,
                                                           p.vec != 0, p.metric, lane);
        if (lane == 0) sd[pl_slot[j]] = d;
        if (lane == 0 && d < INFINITY) {
          const unsigned long long key = rank_key(d, pl_slot[j]);
          const int jj = d <= t_low ? atomicAdd(n_cands, 1) & 0xffff
                                    : r - 1 - (atomicAdd(n_cands, kHighOne) >> 16);
          cd[jj] = d;
          ci[jj] = pl_id[j];
          keys[jj] = key;
          atomicMin(best + par, key);
        }
      }
      PGVS_WARP_MARK(8);
      __syncthreads();
    }
    PGVS_PHASE(5);
    const int nl = *n_cands & 0xffff, nh = *n_cands >> 16;
    if constexpr (KIND == kCodes) nc += nl + nh;
    PGVS_PHASE_ADD(9, nl + nh);
    if (tid == 0) {  // the next step's counts and least key
      misc[kCands + (par ^ 1)] = 0;
      misc[kSurv + (par ^ 1)] = 0;
      best[par ^ 1] = ~0ull;
      misc[kBest + (par ^ 1)] = -1;
    }
    // The window's shifted entries, and the visit.
#pragma unroll
    for (int k = 0; k < kWinPer; ++k) {
      if (j0 + k * kThreads >= en) break;
      win_d[j0 + k * kThreads] = wd[k];
      win_id[j0 + k * kThreads] = wi[k];
    }
    if (tid == 0 && at < en) {
      win_d[at] = nd;
      win_id[at] = nid;
    }

    // The next node: the best candidate when it is below slot 1 (among
    // equals the frontier's entries come first), else slot 1.  Its slots'
    // ids (the best candidate's row) or their visited flags and row chunks
    // (slot 1's, whose ids are in) are started now, for the next step.
    int best_slot;  // the least key's slot, or -1
    if (keys32) {
      const unsigned k32 = static_cast<unsigned>(misc[kBest + par]);
      best_slot = k32 == ~0u ? -1 : static_cast<int>(k32 & 0xffffu);
    } else {
      const unsigned long long bk = best[par];
      best_slot = bk == ~0ull ? -1 : static_cast<int>(bk & 0xffffffffu);
    }
    bool next_y = false;
    spec = nspec;
    if (best_slot >= 0 && sd[best_slot] < (nspec >= 0 ? fd[1] : INFINITY)) {
      spec = sid[best_slot];
      next_y = true;
    }
    piped = spec < 0 ? 0 : next_y ? 1 : 2;
    if (next_y) {
      b_id = unit < r
                 ? __ldg(p.adjacency + static_cast<long long>(min(spec, p.cap - 1)) * r + unit)
                 : -1;
    } else if (piped == 2) {
      b_id = x_id;
      load_slot(b_id, b_vis, b_a);
    }
    PGVS_WARP_MARK(9);

    // 6: the merge into the other buffer and its set.  A low candidate's
    // place: its rank among the low ones by key plus the frontier entries at
    // most its distance; a high one's, only while the frontier has free
    // places: m + nl + its rank among the high ones.  A warp a candidate.
    float* nx_d = fr_d_all + (cur ^ 1) * f;
    int* nx_id = fr_id_all + (cur ^ 1) * f;
    int* tgt = rebuild ? spare : fset;
    int* used = misc + kUsed;
    // With one free place and no low candidate (a full frontier's usual
    // step), only the best candidate enters, at m; its key is the step's
    // least.
    const int room = f - m - nl;
    const bool one_high = room == 1 && nl == 0 && nh > 0;
    if (one_high && tid == 0) {
      nx_d[m] = sd[best_slot];
      nx_id[m] = sid[best_slot];
    }
    if (one_high && warp == 0) {
      bool fresh;
      warp_set_insert(tgt, sid[best_slot], lane == 0, fset_log2, fresh);
      warp_count_add(fresh, used);
    }
    PGVS_WARP_MARK(14);
    const int n_in = nl + (room > 0 && !one_high ? nh : 0);
    int top = 1;  // a power of two >= m
    while (top < m) top <<= 1;
    PGVS_PHASE_ADD(8, nl);
    PGVS_PHASE_ADD(12, n_in - nl);
    PGVS_PHASE_ADD(14, rebuild);
    for (int j0 = 0; j0 < n_in; j0 += kThreads) {  // a lane a candidate
      if (j0 + (warp << 5) >= n_in) break;  // the warp has no candidate left
      const int j = j0 + tid;
      const bool low = j < nl;
      const int jj = low ? j : r - 1 - (j - nl);
      int pos = f, id = -1;
      float d = 0.0f;
      // Every lane runs the longer list's rounds (the warp stays together).
      const unsigned long long mine = j < n_in ? keys[jj] : 0ull;
      const unsigned long long* kk = low ? keys : keys + r - nh;
      const int n = low ? nl : nh;
      int rank = 0;
#pragma unroll 4
      for (int k = 0; k < max(nl, n_in - nl); ++k) rank += k < n && kk[k] < mine;
      if (j < n_in) {
        d = cd[jj];
        id = ci[jj];
      }
      const int below = count_at_most(fd + 1, m, d, top);
      if (j < n_in) pos = low ? rank + below : rank < room ? m + nl + rank : f;
      if (pos < f) {
        nx_d[pos] = d;
        nx_id[pos] = id;
      }
      bool fresh;
      warp_set_insert(tgt, id, pos < f, fset_log2, fresh);
      warp_count_add(fresh, used);
    }
    PGVS_PHASE(6);
    PGVS_WARP_MARK(10);
    // A frontier entry's place: its place in the stable order plus the
    // candidates below its distance (the low ones; every candidate for the
    // +inf entries).
    for (int i0 = 0; i0 < f; i0 += kThreads) {
      if (i0 + (warp << 5) >= f) break;  // the warp has no entry left
      const int i = i0 + tid;
      const int slot = stable_slot(i, m);
      int pos = i + nl + nh, id = -1;
      float d = INFINITY;
      if (i < m) {
        d = fd[slot];
        int below = 0;
        for (int k = 0; k < nl; ++k) below += cd[k] < d;
        pos = i + below;
      }
      if (i < f) id = slot == 0 ? -1 : fi[slot];
      if (i < f && pos < f) {
        nx_d[pos] = d;
        nx_id[pos] = id;
      }
      if (rebuild) {
        bool fresh;
        warp_set_insert(tgt, id, id >= 0 && pos < f, fset_log2, fresh);
        warp_count_add(fresh, used);
      } else {
        const int h = warp_set_find(fset, id, id >= 0 && pos >= f, fset_log2);
        if (h >= 0) fset[h] = -2;
      }
    }
    PGVS_WARP_MARK(11);
    if (tid == 0) p.vdist[row] = fminf(vdist_old, nd);
    // The row table's entries go back to empty, each by its id's least slot.
    for (int c = tid; c < r; c += kThreads) {
      const int h = sh[c];
      if (h >= 0) {
        rkey[h] = -1;
        rslot[h] = 0x7fffffff;
      }
    }
    PGVS_WARP_MARK(12);
    __syncthreads();
    PGVS_PHASE(7);
    PGVS_WARP_MARK(13);
    cur ^= 1;
    live ^= rebuild;
    clear = rebuild;
  }

  const float* fd = fr_d_all + cur * f;
  const int* fi = fr_id_all + cur * f;
  for (int j = tid; j < f; j += kThreads) {
    p.fr_d[j] = fd[j];
    p.fr_ids[j] = fi[j];
  }
  for (int j = tid; j < en; j += kThreads) {
    p.win_d[j] = win_d[j];
    p.win_ids[j] = win_id[j];
  }
  PGVS_PHASE_SAVE(steps);
  if (tid == 0) {
    *p.n_visits = nv;
    *p.n_comps = nc;
    *p.steps = steps;
  }
}

template <int KIND, int A, int B, bool S>
cudaError_t launch_kernel(const Params& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        iter_step_kernel<KIND, A, B, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  iter_step_kernel<KIND, A, B, S><<<1, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int KIND, int A, int B>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  return p.scratch ? launch_kernel<KIND, A, B, true>(p, smem, stream)
                   : launch_kernel<KIND, A, B, false>(p, smem, stream);
}

}  // namespace

// Bytes of the state (shared memory, or the scratch buffer).
extern "C" long long pgvs_iter_step_state_bytes(int f, int emit_n, int r) {
  return Layout(f, emit_n, r).bytes();
}

// Shared memory the query's prefix of Dt floats takes when it is there.
extern "C" long long pgvs_iter_step_query_bytes(int dt) { return pgvs::query_smem_bytes(dt); }

// Inputs: adjacency i32[cap, R]; on codes (use_codes != 0) codes i32[cap, W]
// and query_code i32[W]; in full precision vectors [cap, D] of `dtype` (0
// f32, 1 bf16, 2 int8), scales f32[cap] (int8; else null), query_vec
// f32[Dt], metric config.DistanceType, query_shared: the prefix in shared
// memory.  visited u8[cap] and vdist f32[cap] are written in place.  The
// frontier in (F ids, F distances), the window seed (emit_n each), the
// visit and comparison counts in (i32[1] each); out: the frontier, the
// window, the counts and the steps taken.  scratch: null to keep the state
// in shared memory, else pgvs_iter_step_state_bytes of device memory.
extern "C" int pgvs_iter_step(
    const void* adjacency, const void* codes, const void* query_code, const void* vectors,
    const void* scales, const void* query_vec, void* visited, void* vdist, const void* fr_ids_in,
    const void* fr_d_in, const void* win_ids_in, const void* win_d_in, const void* n_visits_in,
    const void* n_comps_in, void* fr_ids, void* fr_d, void* win_ids, void* win_d,
    void* n_visits, void* n_comps, void* steps, void* scratch, int cap, int r, int f,
    int emit_n, int budget, int use_codes, int w, long long d, int dt, int dtype, int metric,
    int query_shared, int device, void* stream) {
  if (cap <= 0 || r <= 0 || f < 1 || emit_n < 1 || budget < 0 ||
      (use_codes && (w <= 0 || codes == nullptr)) ||
      (!use_codes && (dt <= 0 || dt > d || dtype < 0 || dtype > 2 || metric < 0 ||
                      metric > 2 || (dtype == 2 && scales == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.adjacency = static_cast<const int*>(adjacency);
  p.codes = static_cast<const int*>(codes);
  p.qcode = static_cast<const int*>(query_code);
  p.vectors = vectors;
  p.scales = static_cast<const float*>(scales);
  p.qvec = static_cast<const float*>(query_vec);
  p.visited = static_cast<unsigned char*>(visited);
  p.vdist = static_cast<float*>(vdist);
  p.fr_ids_in = static_cast<const int*>(fr_ids_in);
  p.fr_d_in = static_cast<const float*>(fr_d_in);
  p.win_ids_in = static_cast<const int*>(win_ids_in);
  p.win_d_in = static_cast<const float*>(win_d_in);
  p.n_visits_in = static_cast<const int*>(n_visits_in);
  p.n_comps_in = static_cast<const int*>(n_comps_in);
  p.fr_ids = static_cast<int*>(fr_ids);
  p.fr_d = static_cast<float*>(fr_d);
  p.win_ids = static_cast<int*>(win_ids);
  p.win_d = static_cast<float*>(win_d);
  p.n_visits = static_cast<int*>(n_visits);
  p.n_comps = static_cast<int*>(n_comps);
  p.steps = static_cast<int*>(steps);
  p.scratch = static_cast<unsigned char*>(scratch);
  p.stride = d;
  p.cap = cap;
  p.r = r;
  p.f = f;
  p.emit_n = emit_n;
  p.budget = budget;
  p.w = w;
  p.dt = dt;
  p.metric = metric;
  p.chunks = 0;
  p.log2g = 5;
  p.vec = 0;
  const Layout lay(f, emit_n, r);
  lay.place(p);
  const bool qs = !use_codes && query_shared;
  p.o_state = qs ? static_cast<int>(pgvs::query_smem_bytes(dt)) : 0;
  const size_t smem = static_cast<size_t>((scratch ? 0 : lay.bytes()) + p.o_state);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_codes) {
    // 16-byte chunks when W % 4 == 0 and both tables start on 16 bytes;
    // then as many lanes a row (a power of two) as leave every slot of the
    // row in one round of the block, and enough that a lane takes at most
    // kMaxCpl chunks, up to 32.
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(codes) | reinterpret_cast<uintptr_t>(query_code)) & 15) == 0;
    const int v = w % 4 == 0 && aligned ? 4 : 1;
    p.chunks = w / v;
    p.log2g = 0;
    while (p.log2g < 5 && (kThreads >> (p.log2g + 1)) >= r && (1 << p.log2g) < p.chunks)
      ++p.log2g;
    while (p.log2g < 5 && ((p.chunks + (1 << p.log2g) - 1) >> p.log2g) > kMaxCpl) ++p.log2g;
    const int cpl = (p.chunks + (1 << p.log2g) - 1) >> p.log2g;
#define PGVS_LAUNCH(V)                                                     \
  switch (cpl) {                                                           \
    case 1: err = launch<kCodes, V, 1>(p, smem, st); break;                \
    case 2: err = launch<kCodes, V, 2>(p, smem, st); break;                \
    case 3: err = launch<kCodes, V, 3>(p, smem, st); break;                \
    case 4: err = launch<kCodes, V, 4>(p, smem, st); break;                \
    case 5: case 6: err = launch<kCodes, V, 6>(p, smem, st); break;        \
    default: err = launch<kCodes, V, kMaxCpl>(p, smem, st); break;         \
  }
    if (v == 4) {
      PGVS_LAUNCH(4)
    } else {
      PGVS_LAUNCH(1)
    }
#undef PGVS_LAUNCH
  } else {
    if (dtype == 0) {
      p.vec = pgvs::rows_vectorizable<pgvs::kRowF32>(vectors, d);
      err = qs ? launch<kFull, pgvs::kRowF32, 1>(p, smem, st)
               : launch<kFull, pgvs::kRowF32, 0>(p, smem, st);
    } else if (dtype == 1) {
      p.vec = pgvs::rows_vectorizable<pgvs::kRowBF16>(vectors, d);
      err = qs ? launch<kFull, pgvs::kRowBF16, 1>(p, smem, st)
               : launch<kFull, pgvs::kRowBF16, 0>(p, smem, st);
    } else {
      p.vec = pgvs::rows_vectorizable<pgvs::kRowI8>(vectors, d);
      err = qs ? launch<kFull, pgvs::kRowI8, 1>(p, smem, st)
               : launch<kFull, pgvs::kRowI8, 0>(p, smem, st);
    }
  }
  return static_cast<int>(err);
}
