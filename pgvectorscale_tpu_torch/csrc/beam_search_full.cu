// The whole full-precision beam search, one launch per query batch, for
// sm_90a.
//
// Replaces the JAX package's `lax.while_loop` in `beam_search`
// (pgvectorscale_tpu/graph/search.py:580) with use_codes=False: the
// traversal of plain storage and of builds with build_distance="exact",
// whose scoring branch is `_candidate_distances` (:200-235) on the rows'
// indexed prefix.  Every piece of the loop's state is a query's own, and a
// query with no unvisited entry, or with its visit budget spent, is left
// unchanged by a further iteration, so each query runs its own loop in its
// own block, and the batch's iteration count is the largest of the
// queries' counts.
//
// One block per query runs the plain version's iteration in its order:
//  1. the E best unvisited beam entries: the first E unvisited valid
//     entries of the sorted beam (the stable sort's order);
//  2. the visit budget: entries past H stay unvisited;
//  3. mark them visited, write the history, count the visits;
//  4. gather their adjacency rows (E*R slots);
//  5. a filtered search keeps a neighbour only if its labels overlap the
//     query's (sentinel excluded);
//  6. drop neighbours already in the beam;
//  7. drop a neighbour seen in an earlier slot (the first slot of an id
//     survives): each slot puts itself under its id in a hash table with
//     atomicMin and survives when it is its id's least; the plain version's
//     two dedup branches keep the same survivors and differ in their
//     order: slot order for E*R <= 192, id order above;
//  8. the survivors' full-precision distances (rowdist.cuh): a survivor the
//     query has scored before takes its distance from the memo below; the
//     others (the misses) are read and scored, a warp a row;
//  9. rank the survivors that can reach a kept entry by (distance, slot or
//     id), as 64-bit keys, and merge them into the window (when kept) and
//     the beam with the plain version's bitonic network: [row | +inf pad |
//     candidates descending], strides n/2 .. 1, a swap only on a strict >.
// The start nodes' dedup, distances and stable sort happen here too.
//
// The memo.  An open-addressing table of (id, distance) entries in the
// query's state holds every row the block has scored, the start nodes
// included, until three quarters of its entries are in; then a miss is
// scored and not kept.  The same code on the same row and query gives the
// same float, so a hit is exactly what scoring the row again would give,
// and every later rank and merge sees the plain version's values.
// `n_dist_comps` stays the plain version's count of survivors; the
// optional `rows_read` output counts the rows read, which equals the
// distinct rows scored while the memo has room.
//
// Bound on an H100: bytes, behind the chain of dependent iterations.  The
// least device-memory traffic of a query is each distinct row it scores
// (Dt elements), each distinct frontier row's R adjacency ids, its inputs
// and its outputs, once; the 100k x 768 f32 table (307 MB) does not stay in
// the 50 MB L2.  A batch is bound by the bytes of its queries' distinct
// rows (the memo reads each once a query, while it has room); a query
// alone by what one SM reads from device memory, ~55 GB/s on an H100 for
// random 3 KB rows (microbench/sm_read_rate.cu), so an iteration takes its
// misses' bytes over that rate, behind the chain of an adjacency read.
// Design: one block per query: of 256 threads, two an SM, for a batch
// larger than the SMs (the state, the memo and the rings take ~100 KB, and
// 128 registers a thread allow no more); of 512, one an SM, for a smaller
// batch, whose SMs would otherwise wait on too few warps' loads.  When the
// rows start on 16 bytes (rows_vectorizable), each warp streams its misses
// through a ring of `slots` row buffers in shared memory: each lane
// cp.async's its own 16-byte chunks of a row, `slots` rows ahead of the one
// the warp sums out of shared memory, so a row's copy holds no registers;
// the wrapper picks the slots (up to 6 a warp; 2 at the 768-wide search).
// Other tables keep warp_row_distance's loads from device memory, a warp a
// row.  Bulk copies (cp.async.bulk on an mbarrier, one lane a row)
// were measured too and read slower at every shape (PERF.md).
// The query's prefix sits in shared memory while it fits (else it is read
// through the read-only cache); the beam, window, candidate rows, merge
// buffer and memo live in shared memory (dynamic, above 48 KB after
// cudaFuncSetAttribute) or, for a state over the shared limit (a build
// wave's L=200 beam, a window of 1,500), in the query's slice of a scratch
// buffer, through the same code.
//
// Plain C interface for ctypes: raw pointers, sizes and the caller's
// stream.  The function launches, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rowdist.cuh"

// The phase stamps of microbench/beam_full_ab.py, which defines them; none
// otherwise.
#ifndef PGVS_PHASE_INIT
#define PGVS_PHASE_INIT
#define PGVS_PHASE(k)
#define PGVS_SPLIT_BEGIN
#define PGVS_SPLIT_END(k)
#define PGVS_PHASE_ADD(k, n)
#define PGVS_PHASE_SAVE(it)
#endif

namespace {

// The distance memo's most entries, a power of two (a test builds it tiny);
// a launch takes a power of two up to it (Params::memo_log2).
#ifndef PGVS_FULL_MEMO
#define PGVS_FULL_MEMO 8192
#endif
// A block runs 256 threads (a batch: two blocks an SM) or 512 (a batch no
// larger than the SMs: one block an SM, twice the warps); either way an SM
// holds 512 threads at once, which caps a thread at 128 registers.
constexpr int kMaxWarps = 16;
constexpr int kLabelSentinel = 0x7fffffff;
constexpr int kNarrowRow = 192;  // E*R <= 192: slot order, else id order
constexpr int kMemoMax = PGVS_FULL_MEMO;
constexpr int kMaxSlots = 8;  // ring slots a warp (cp.async waits on a count below 8)
static_assert(kMemoMax >= 2 && (kMemoMax & (kMemoMax - 1)) == 0, "the memo is a power of two");
// misc words: the start nodes' count, the memo's insertions, the rows read.
enum { kStarts = 0, kMemoCount = 1, kRead = 2, kMisc = 4 };

struct Params {
  const void* vectors;     // [cap, D]: f32, bf16 or int8
  const float* scales;     // [cap]: the int8 rows' scales (else unused)
  const int* adjacency;    // [cap, R]
  const int* node_labels;  // [cap, Lm]
  const float* qvecs;      // [Q, Dt]: the queries' indexed prefixes
  const int* start_ids;    // [Q, S]
  const int* qlabels;      // [Q, Lq]
  int* beam_ids;           // [Q, L]
  float* beam_dists;       // [Q, L]
  uint8_t* beam_vis;       // [Q, L]
  int* hist_ids;           // [Q, h_cap]
  float* hist_dists;       // [Q, h_cap]
  int* n_visited;          // [Q]
  int* n_comps;            // [Q]
  int* win_ids;            // [Q, max(window_n, 1)]
  float* win_dists;        // [Q, max(window_n, 1)]
  int* iters;              // [Q]
  int* rows_read;          // [Q], or null
  unsigned char* scratch;  // [Q, state_bytes], or null: shared memory
  long long state_bytes;
  long long stride;        // D, elements a row
  int cap, dt, metric, vec, r, lm, s, lq, l, h, h_cap, track_hist, e, window_n,
      iter_bound;
  int slots, copy_bytes;     // ring slots a warp (0: no ring), bytes a row copy
  int memo_log2, memo_fill;  // the memo's 2^memo_log2 entries, the most it keeps
  // Where things are (Layout::place), kept here in the constant bank so
  // that a pointer is one add from a constant and needs no register across
  // the loop: the rings and the state, in bytes from the dynamic shared
  // memory; the state's arrays, in words from its base.
  int o_ring, o_state;
  int er, nm, nm_log2, o_beam_t, o_win_d, o_win_t, o_fid, o_nb, o_kept, o_kd, o_cs_d, o_cs_t,
      o_miss, o_md, o_mt, o_sel_pos, o_sel_id, o_wtot, o_misc, o_memo_k, o_memo_v;
};

__host__ __device__ inline int pow2_at_least(int x) {
  int n = 1;
  while (n < x) n <<= 1;
  return n;
}

__host__ __device__ inline int round4(int words) { return (words + 3) & ~3; }

// The query's state: arrays of 4-byte words, in this order (the memo last).
// The merge buffer starts on 16 bytes: it holds the rank's 8-byte keys too.
struct Layout {
  int l, wn, er, e, nm, memo;
  __host__ __device__ Layout(int l_, int window_n, int e_, int r, int memo_log2)
      : l(l_), wn(window_n), e(e_), memo(1 << memo_log2) {
    er = e_ * r;
    nm = pow2_at_least(l_ + er);
    if (wn > 0 && pow2_at_least(wn + er) > nm) nm = pow2_at_least(wn + er);
  }
  __host__ __device__ int md() const { return round4(2 * l + 2 * wn + 7 * er); }
  __host__ __device__ long long words() const {
    return md() + 2LL * nm + 2LL * e + 2LL * kMaxWarps + kMisc + 2LL * memo;
  }
  __host__ __device__ long long bytes() const { return ((words() * 4 + 15) / 16) * 16; }
  // The arrays' offsets, in words, into p (beam_d is at 0).
  void place(Params& p) const {
    p.er = er;
    p.nm = nm;
    p.nm_log2 = 0;
    while ((1 << p.nm_log2) < nm) ++p.nm_log2;
    p.o_beam_t = l;
    p.o_win_d = p.o_beam_t + l;
    p.o_win_t = p.o_win_d + wn;
    p.o_fid = p.o_win_t + wn;
    p.o_nb = p.o_fid + er;
    p.o_kept = p.o_nb + er;
    p.o_kd = p.o_kept + er;
    p.o_cs_d = p.o_kd + er;
    p.o_cs_t = p.o_cs_d + er;
    p.o_miss = p.o_cs_t + er;
    p.o_md = md();
    p.o_mt = p.o_md + nm;
    p.o_sel_pos = p.o_mt + nm;
    p.o_sel_id = p.o_sel_pos + e;
    p.o_wtot = p.o_sel_id + e;
    p.o_misc = p.o_wtot + 2 * kMaxWarps;
    p.o_memo_k = p.o_misc + kMisc;
    p.o_memo_v = p.o_memo_k + memo;
  }
};

// Shared bytes of the rings: a warp's slots buffers of copy_bytes (a
// multiple of 16), for each of `warps` warps.
__host__ __device__ inline long long ring_bytes(int slots, int copy_bytes, int warps) {
  return static_cast<long long>(warps) * slots * copy_bytes;
}

__device__ __forceinline__ unsigned hash_of(int id, int log2_entries) {
  return (static_cast<unsigned>(id) * 0x9E3779B1u) >> (32 - log2_entries);
}

// Insert id into an open-addressing table of 2^log2 entries (-1: empty)
// with fewer ids than entries; a present id stays.  Returns its entry.
__device__ __forceinline__ int table_insert(int* keys, int id, int log2) {
  const unsigned mask = (1u << log2) - 1u;
  unsigned h = hash_of(id, log2);
  while (true) {
    const int prev = atomicCAS(keys + h, -1, id);
    if (prev == -1 || prev == id) return static_cast<int>(h);
    h = (h + 1) & mask;
  }
}

// The entry of id, which the table holds.
__device__ __forceinline__ int table_find(const int* keys, int id, int log2) {
  const unsigned mask = (1u << log2) - 1u;
  unsigned h = hash_of(id, log2);
  while (keys[h] != id) h = (h + 1) & mask;
  return static_cast<int>(h);
}

// The memo probes by double hashing (an odd step from a second hash), so
// its runs stay short at three quarters full: the slowest lookup of a step
// sets when the block goes on.
__device__ __forceinline__ unsigned memo_step(int id) {
  return ((static_cast<unsigned>(id) * 0x85EBCA6Bu) >> 16) | 1u;
}

// The entry of id in the memo, or -1.
__device__ __forceinline__ int memo_find(const int* keys, int id, int log2) {
  const unsigned mask = (1u << log2) - 1u, step = memo_step(id);
  unsigned h = hash_of(id, log2);
  while (true) {
    const int k = keys[h];
    if (k == id) return static_cast<int>(h);
    if (k == -1) return -1;
    h = (h + step) & mask;
  }
}

// Keep id's distance (id is not in the memo; the memo has room for it).
__device__ __forceinline__ void memo_insert(int* keys, float* vals, int id, float d, int log2) {
  const unsigned mask = (1u << log2) - 1u, step = memo_step(id);
  unsigned h = hash_of(id, log2);
  while (atomicCAS(keys + h, -1, id) != -1) h = (h + step) & mask;
  vals[h] = d;
}

// memo_insert for the lanes of a warp with `put` (every lane must call
// it), while the memo has room: `count` counts the rows offered, one
// atomic a warp, and the first `fill` offered go in.
__device__ __forceinline__ void memo_put_warp(bool put, int* keys, float* vals, int* count,
                                              int id, float d, int log2, int fill) {
  const unsigned m = __ballot_sync(0xffffffffu, put);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && m) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (put && base + __popc(m & ((1u << lane) - 1u)) < fill) memo_insert(keys, vals, id, d, log2);
}

// The rank's key of a candidate: the distance's bits made to order as
// unsigned integers as the floats order (-0.0 first made +0.0, which it
// equals), then the tie-break (a slot or an id, >= 0).
__device__ __forceinline__ unsigned long long rank_key(float d, int tie) {
  unsigned u = __float_as_uint(d == 0.0f ? 0.0f : d);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(tie);
}

// block_prefix of two predicates at once (the second implies the first):
// each one's exclusive prefix count over the block, and both totals.
// Every thread must call it; `wtot` holds 2 * kWarps words.
template <int kWarps>
__device__ __forceinline__ int2 block_prefix2(bool a, bool b, int* wtot, int& total_a,
                                              int& total_b) {
  const unsigned ma = __ballot_sync(0xffffffffu, a), mb = __ballot_sync(0xffffffffu, b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    wtot[warp] = __popc(ma);
    wtot[kWarps + warp] = __popc(mb);
  }
  __syncthreads();
  int before_a = 0, before_b = 0, ta = 0, tb = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int ca = wtot[k], cb = wtot[kWarps + k];
    before_a += k < warp ? ca : 0;
    before_b += k < warp ? cb : 0;
    ta += ca;
    tb += cb;
  }
  __syncthreads();
  total_a = ta;
  total_b = tb;
  const unsigned below = (1u << lane) - 1u;
  return make_int2(before_a + __popc(ma & below), before_b + __popc(mb & below));
}

// Merge the nr sorted candidates (cs_d ascending, their tags tag_mul *
// cs_t) into the sorted row (row_d, row_t) of width wl, keeping the best wl:
// the plain version's network over n = pow2(wl + E*R) entries ([row | +inf
// pad | candidates descending], strides n/2 .. 1, a swap only on a strict
// >), trimmed to the blocks that meet [0, wl): when wl <= n/2 the first
// stride is fused into the buffer's build and only its lower half kept,
// strides of 16 and below run on registers with shuffles, a 32-entry
// segment a warp.  The kept entries go through exactly the whole network's
// compare-exchanges (the SBQ kernel's merge, csrc/beam_search.cu);
// pad_tag marks the +inf entries.
template <int NT>
__device__ __forceinline__ void merge_row(float* row_d, int* row_t, int wl, int n, int nr,
                                          const float* cs_d, const int* cs_t, int tag_mul,
                                          int pad_tag, float* md, int* mt) {
  constexpr int kThreads = NT, kWarps = NT / 32;
  auto tag = [&](int c) { return tag_mul * cs_t[c]; };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int s = n >> 1;  // the next stride to run
  int live;        // entries [0, live) of the buffer are written
  if (wl <= s) {   // the first stride, fused: only its lower half is kept
#pragma unroll 1
    for (int u = tid; u < s; u += kThreads) {
      float a = u < wl ? row_d[u] : INFINITY;
      int ta = u < wl ? row_t[u] : pad_tag;
      const int c = s - 1 - u;  // the candidate at u + s, if any
      if (c < nr) {
        const float b = cs_d[c];
        if (a > b) {
          a = b;
          ta = tag(c);
        }
      }
      md[u] = a;
      mt[u] = ta;
    }
    live = s;
    s >>= 1;
  } else {
#pragma unroll 1
    for (int j = tid; j < n; j += kThreads) {
      if (j < wl) {
        md[j] = row_d[j];
        mt[j] = row_t[j];
      } else if (j >= n - nr) {
        md[j] = cs_d[n - 1 - j];
        mt[j] = tag(n - 1 - j);
      } else {
        md[j] = INFINITY;
        mt[j] = pad_tag;
      }
    }
    live = n;
  }
  __syncthreads();
#pragma unroll 1
  for (; s >= 32; s >>= 1) {
    const int pairs = ((wl + 2 * s - 1) / (2 * s)) * s;
#pragma unroll 1
    for (int pi = tid; pi < pairs; pi += kThreads) {
      const int lo = ((pi & ~(s - 1)) << 1) | (pi & (s - 1));
      const int hi = lo + s;
      const float a = md[lo], b = md[hi];
      if (a > b) {
        md[lo] = b;
        md[hi] = a;
        const int t = mt[lo];
        mt[lo] = mt[hi];
        mt[hi] = t;
      }
    }
    __syncthreads();
  }
  const int segments = (wl + 31) >> 5;
#pragma unroll 1
  for (int seg = warp; seg < segments; seg += kWarps) {
    const int j = seg * 32 + lane;
    float d = j < live ? md[j] : INFINITY;
    int t = j < live ? mt[j] : pad_tag;
#pragma unroll 1
    for (int st = s; st >= 1; st >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, d, st);
      const int ot = __shfl_xor_sync(0xffffffffu, t, st);
      const bool swap = (lane & st) ? (od > d) : (d > od);
      if (swap) {
        d = od;
        t = ot;
      }
    }
    if (j < wl) {
      row_d[j] = d;
      row_t[j] = t;
    }
  }
  __syncthreads();
}

template <int DT>
__device__ __forceinline__ const void* row_ptr(const Params& p, int id) {
  const long long row = min(max(id, 0), p.cap - 1);
  return static_cast<const char*>(p.vectors) + row * p.stride * pgvs::row_elem_bytes<DT>();
}

template <int DT>
__device__ __forceinline__ float row_scale(const Params& p, int id) {
  return DT == pgvs::kRowI8 ? __ldg(p.scales + min(max(id, 0), p.cap - 1)) : 1.0f;
}

// One row's distance to the query from device memory, by the calling warp.
template <int DT, bool QS>
__device__ __forceinline__ float score_row(const Params& p, int id, const float* qrow, int lane) {
  return pgvs::warp_row_distance<DT, QS>(row_ptr<DT>(p, id), row_scale<DT>(p, id), qrow, p.dt,
                                         p.vec != 0, p.metric, lane);
}

template <int DT, bool QS, int NT>
__global__ void __launch_bounds__(NT, 512 / NT) beam_search_full_kernel(Params p) {
  constexpr int kThreads = NT, kWarps = NT / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int l = p.l, wn = p.window_n, er = p.er, e = p.e, r = p.r;
  // Shared memory: the query's prefix (QS), the rings, then the state (no
  // scratch).
  float* qs = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + p.o_ring;
  int* base = reinterpret_cast<int*>(
      p.scratch ? p.scratch + static_cast<long long>(q) * p.state_bytes : smem + p.o_state);
  float* beam_d = reinterpret_cast<float*>(base);
  int* beam_t = base + p.o_beam_t;                            // 2 * id + visited; -2 = empty
  float* win_d = reinterpret_cast<float*>(base + p.o_win_d);
  int* win_t = base + p.o_win_t;                              // id; -1 = empty
  int* fid = base + p.o_fid;                                  // [E*R] candidate id, or -1
  int* nb = base + p.o_nb;                                    // [nf] the survivors' ids
  int* kept = base + p.o_kept;                                // [nf] the survivors' slots
  float* kd = reinterpret_cast<float*>(base + p.o_kd);        // [nf] their distances
  float* cs_d = reinterpret_cast<float*>(base + p.o_cs_d);    // [nf] sorted ascending
  int* cs_t = base + p.o_cs_t;                                // [nf] their ids
  int* miss = base + p.o_miss;                                // [nf] the survivors to read
  float* md = reinterpret_cast<float*>(base + p.o_md);        // merge buffer
  int* mt = base + p.o_mt;
  int* sel_pos = base + p.o_sel_pos;                          // [E]
  int* sel_id = base + p.o_sel_id;                            // [E]
  int* wtot = base + p.o_wtot;                                // [2 * kMaxWarps]
  int* misc = base + p.o_misc;                                // [kMisc]
  int* memo_k = base + p.o_memo_k;                            // [2^memo_log2] id, or -1
  float* memo_v = reinterpret_cast<float*>(base + p.o_memo_v);
  PGVS_PHASE_INIT

  const float* qg = p.qvecs + static_cast<long long>(q) * p.dt;
  if constexpr (QS) {
    for (int j = tid; j < p.dt; j += kThreads) qs[j] = qg[j];
  }
  const float* qrow = QS ? qs : qg;
  const int* starts = p.start_ids + static_cast<long long>(q) * p.s;
  int ring_pos = 0;  // the slot of the warp's next row

  // ---- the start nodes: dedup, distances, the stable sort into the beam ----
  const int memo_log2 = p.memo_log2;
  if (tid < kMisc) misc[tid] = 0;
  for (int j = tid; j < (1 << memo_log2); j += kThreads) memo_k[j] = -1;
  for (int j = tid; j < l; j += kThreads) {
    beam_d[j] = INFINITY;
    beam_t[j] = -2;
  }
  __syncthreads();
  const int s_in = p.s < l ? p.s : l;  // starts past L never enter the beam
  int local = 0;
  for (int j = tid; j < p.s; j += kThreads) {
    const int sid = starts[j];
    bool v = sid >= 0;
    for (int k = 0; k < j && v; ++k) v = starts[k] != sid;
    local += v;
    if (j < s_in) {
      mt[j] = v ? sid : -1;
      md[j] = 0.0f;
    }
  }
  atomicAdd(misc + kStarts, local);
  __syncthreads();
  int n_comps = misc[kStarts];
  for (int b0 = 0; b0 < s_in; b0 += kWarps) {  // one warp a start node
    const int j = b0 + warp;
    if (j < s_in) {
      const int sid = mt[j];
      const float d = sid >= 0 ? score_row<DT, QS>(p, sid, qrow, lane) : INFINITY;
      if (lane == 0) {
        md[j] = d;
        if (sid >= 0) {
          if (atomicAdd(misc + kMemoCount, 1) < p.memo_fill)
            memo_insert(memo_k, memo_v, sid, d, memo_log2);
          atomicAdd(misc + kRead, 1);
        }
      }
    }
  }
  __syncthreads();
  for (int j = tid; j < s_in; j += kThreads) {
    if (mt[j] < 0) continue;  // its slot keeps +inf and the empty tag
    const float dj = md[j];
    int rank = 0;  // the stable sort's place (a dropped start counts as +inf)
    for (int k = 0; k < s_in; ++k) {
      const float dk = md[k];
      rank += (dk < dj) || (dk == dj && k < j);
    }
    beam_d[rank] = dj;
    beam_t[rank] = 2 * mt[j];
  }
  __syncthreads();
  const long long wrow = static_cast<long long>(q) * (wn > 0 ? wn : 1);
  if (wn > 0) {
    for (int j = tid; j < wn; j += kThreads) {
      win_d[j] = j < l ? beam_d[j] : INFINITY;
      win_t[j] = j < l ? (beam_t[j] >> 1) : -1;
    }
  } else if (tid == 0) {
    p.win_ids[wrow] = beam_t[0] >> 1;
    p.win_dists[wrow] = beam_d[0];
  }
  const long long hrow = static_cast<long long>(q) * p.h_cap;
  for (int j = tid; j < p.h_cap; j += kThreads) {
    p.hist_ids[hrow + j] = -1;
    p.hist_dists[hrow + j] = INFINITY;
  }
  __syncthreads();

  // The in-row dedup's table: ids in the merge buffer's first half, each
  // id's least slot in its second (free from the end of a merge to the
  // start of the next).
  int* tk = reinterpret_cast<int*>(md);
  int n_vis = 0, it = 0;
  while (it < p.iter_bound) {
    bool unvisited = false;
    for (int j = tid; j < l; j += kThreads) {
      const int t = beam_t[j];
      unvisited |= t >= 0 && !(t & 1);
    }
    if (!__syncthreads_or(unvisited) || n_vis >= p.h) break;

    // 1-3: select, apply the budget, visit; the dedup table cleared.
    int found = 0;
    for (int b0 = 0; b0 < l && found < e; b0 += kThreads) {
      const int j = b0 + tid;
      bool pred = false;
      if (j < l) {
        const int t = beam_t[j];
        pred = t >= 0 && !(t & 1) && beam_d[j] < INFINITY;
      }
      int tot;
      const int idx = pgvs::block_prefix<kWarps>(pred, wtot, tot);
      if (pred && found + idx < e) sel_pos[found + idx] = j;
      found += tot;
    }
    for (int j = tid; j < p.nm; j += kThreads) {
      tk[j] = -1;
      mt[j] = 0x7fffffff;
    }
    __syncthreads();
    const int nsel = found < e ? found : e;
    const int nact = nsel < p.h - n_vis ? nsel : p.h - n_vis;
    for (int k = tid; k < nact; k += kThreads) {
      const int pos = sel_pos[k];
      const int t = beam_t[pos];
      sel_id[k] = t >> 1;
      beam_t[pos] = t | 1;
      if (p.track_hist) {
        p.hist_ids[hrow + n_vis + k] = t >> 1;
        p.hist_dists[hrow + n_vis + k] = beam_d[pos];
      }
    }
    n_vis += nact;
    __syncthreads();
    PGVS_PHASE(0);

    // 4-6: expand, the label mask, the in-beam dedup; each kept slot puts
    // itself under its id in the dedup table, keeping the least slot.
    for (int i = tid; i < er; i += kThreads) {
      const int k = i / r;
      int nbv = -1;
      bool v = false;
      if (k < nact) {
        nbv = __ldg(p.adjacency + static_cast<long long>(sel_id[k]) * r + (i - k * r));
        v = nbv != -1;
      }
      if (v && p.lq > 0) {
        const int* nl = p.node_labels + static_cast<long long>(nbv < 0 ? 0 : nbv) * p.lm;
        bool any = false;
        const int* qlab = p.qlabels + static_cast<long long>(q) * p.lq;
        for (int a = 0; a < p.lm && !any; ++a) {
          const int x = __ldg(nl + a);
          if (x == kLabelSentinel) continue;
          for (int b = 0; b < p.lq; ++b) any |= __ldg(qlab + b) == x;
        }
        v = any;
      }
      PGVS_SPLIT_BEGIN;
      if (v) {
        bool hit = false;
#pragma unroll 4
        for (int j = 0; j < l; ++j) hit |= (beam_t[j] >> 1) == nbv;
        v = !hit;
      }
      PGVS_SPLIT_END(2);
      fid[i] = v ? nbv : -1;
      if (v) atomicMin(mt + table_insert(tk, nbv, p.nm_log2), i);
    }
    __syncthreads();
    PGVS_PHASE(1);

    // 7-8: a slot survives when it is its id's least (the first slot of an
    // id survives); a survivor the memo holds takes its distance, the
    // others (the misses) are listed, both in slot order.
    int nf = 0, nmiss = 0;
    for (int b0 = 0; b0 < er; b0 += kThreads) {
      const int i = b0 + tid;
      const int id = i < er ? fid[i] : -1;
      const bool keep = id >= 0 && mt[table_find(tk, id, p.nm_log2)] == i;
      int at = -1;
      if (keep) at = memo_find(memo_k, id, memo_log2);
      int tot, tot_miss;
      const int2 idx = block_prefix2<kWarps>(keep, keep && at < 0, wtot, tot, tot_miss);
      if (keep) {
        const int c = nf + idx.x;
        kept[c] = i;
        nb[c] = id;
        cs_t[c] = at < 0;  // the memo takes its distance at the rank
        if (at >= 0) {
          kd[c] = memo_v[at];
        } else {
          miss[nmiss + idx.y] = c;
        }
      }
      nf += tot;
      nmiss += tot_miss;
    }
    __syncthreads();
    n_comps += nf;
    PGVS_PHASE(3);
    PGVS_PHASE(4);
    PGVS_PHASE_ADD(12, nf);
    PGVS_PHASE_ADD(13, nmiss);
    if (nf == 0) {  // nothing to merge: both rows stay as they are
      ++it;
      continue;
    }

    // The misses' distances: warp w takes misses w, w + kWarps, ...
    const int nw = nmiss > warp ? (nmiss - warp + kWarps - 1) / kWarps : 0;
    if (p.slots > 0) {
      // Each lane copies its 16-byte chunks of the warp's j-th miss into
      // the slot, one cp.async group a row (an empty group past the last
      // row), so `slots` groups are in flight at each wait.
      const int slots = p.slots;
      unsigned char* my_ring = ring + static_cast<long long>(warp) * slots * p.copy_bytes;
      auto copy_row = [&](int j) {
        if (j < nw) {
          pgvs::lane_row_copy(my_ring + static_cast<long long>((ring_pos + j) % slots) *
                                            p.copy_bytes,
                              row_ptr<DT>(p, nb[miss[warp + j * kWarps]]), p.copy_bytes, lane);
        } else {
          __pipeline_commit();
        }
      };
      for (int j = 0; j < slots; ++j) copy_row(j);
      for (int j = 0; j < nw; ++j) {
        const int c = miss[warp + j * kWarps];
        const float scale = row_scale<DT>(p, nb[c]);
        pgvs::lane_copies_wait(slots - 1);
        __syncwarp();  // the row's tail may be another lane's copy
        const float d = pgvs::warp_shared_row_distance<DT, QS>(
            my_ring + static_cast<long long>((ring_pos + j) % slots) * p.copy_bytes, scale, qrow,
            p.dt, p.metric, lane);
        __syncwarp();  // every lane has read the slot
        copy_row(j + slots);
        if (lane == 0) kd[c] = d;
      }
      ring_pos = (ring_pos + nw) % slots;
    } else {
      for (int j = 0; j < nw; ++j) {
        const int c = miss[warp + j * kWarps];
        const float d = score_row<DT, QS>(p, nb[c], qrow, lane);
        if (lane == 0) kd[c] = d;
      }
    }
    if (tid == 0) misc[kRead] += nmiss;
    __syncthreads();
    PGVS_PHASE(5);

    // 9: rank by (distance, slot or id), then the window and beam merges.
    // Only the candidates that can reach a kept entry are ranked: with t a
    // merged row's last distance, when t is finite its first wl outputs are
    // entries <= t, and an entry <= t meets one > t in a compare-exchange
    // only to stay in the lower wire, so a candidate > t may be +inf padding
    // instead.  The candidates <= T (the larger t of the beam and the
    // window) keep the positions they would have among all (the n - 1 - c
    // of the c-th smallest), since the dropped ones are the largest; each
    // is ranked among the kept ones only, which hold every smaller key.
    // Their keys (rank_key) go to the merge buffer, two read at a time.
    // The misses' distances go into the memo here, off the reads' path.
    const float t_row = beam_d[l - 1];
    const float t_cut = wn > 0 && win_d[wn - 1] > t_row ? win_d[wn - 1] : t_row;
    const int* tb = er <= kNarrowRow ? kept : nb;  // the tie-break: slot or id
    unsigned long long* keys = reinterpret_cast<unsigned long long*>(md);
    int nr = 0;
    for (int b0 = 0; b0 < nf; b0 += kThreads) {
      const int c = b0 + tid;
      const bool in = c < nf && kd[c] <= t_cut;
      const bool put = c < nf && cs_t[c];
      memo_put_warp(put, memo_k, memo_v, misc + kMemoCount, put ? nb[c] : 0, put ? kd[c] : 0.0f,
                    memo_log2, p.memo_fill);
      int tot;
      const int idx = pgvs::block_prefix<kWarps>(in, wtot, tot);
      if (in) {
        miss[nr + idx] = c;  // the misses' list is free again
        keys[nr + idx] = rank_key(kd[c], tb[c]);
      }
      nr += tot;
    }
    if (tid == 0) keys[nr] = ~0ull;  // an odd count's pair is whole
    __syncthreads();
    const ulonglong2* keys2 = reinterpret_cast<const ulonglong2*>(keys);
    for (int a = tid; a < nr; a += kThreads) {
      const unsigned long long mine = keys[a];
      int rank = 0;
#pragma unroll 4
      for (int b = 0; b < (nr + 1) >> 1; ++b) {
        const ulonglong2 k2 = keys2[b];
        rank += (k2.x < mine) + (k2.y < mine);
      }
      const int c = miss[a];
      cs_d[rank] = kd[c];
      cs_t[rank] = nb[c];
    }
    __syncthreads();
    PGVS_PHASE(6);
    if (nr == 0) {  // every candidate is +inf padding: both rows stay sorted as they are
      ++it;
      continue;
    }
    if (wn > 0)  // the window's tags are ids, the beam's 2 * id + visited
      merge_row<kThreads>(win_d, win_t, wn, pow2_at_least(wn + er), nr, cs_d, cs_t, 1, -1, md,
                          mt);
    PGVS_PHASE(7);
    merge_row<kThreads>(beam_d, beam_t, l, pow2_at_least(l + er), nr, cs_d, cs_t, 2, -2, md, mt);
    PGVS_PHASE(8);
    ++it;
  }

  const long long brow = static_cast<long long>(q) * l;
  for (int j = tid; j < l; j += kThreads) {
    const int t = beam_t[j];
    p.beam_ids[brow + j] = t >> 1;
    p.beam_dists[brow + j] = beam_d[j];
    p.beam_vis[brow + j] = static_cast<uint8_t>(t & 1);
  }
  for (int j = tid; j < wn; j += kThreads) {
    p.win_ids[wrow + j] = win_t[j];
    p.win_dists[wrow + j] = win_d[j];
  }
  PGVS_PHASE_SAVE(it);
  if (tid == 0) {
    p.n_visited[q] = n_vis;
    p.n_comps[q] = n_comps;
    p.iters[q] = it;
    if (p.rows_read) p.rows_read[q] = misc[kRead];
  }
}

template <int DT, bool QS, int NT>
cudaError_t launch(const Params& p, int q, size_t smem, cudaStream_t stream) {
  constexpr int kThreads = NT;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        beam_search_full_kernel<DT, QS, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  beam_search_full_kernel<DT, QS, NT><<<q, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_dtype(const Params& p, int q, bool qs, int threads, size_t smem,
                         cudaStream_t stream) {
  if (threads == 512)
    return qs ? launch<DT, true, 512>(p, q, smem, stream)
              : launch<DT, false, 512>(p, q, smem, stream);
  return qs ? launch<DT, true, 256>(p, q, smem, stream)
            : launch<DT, false, 256>(p, q, smem, stream);
}

int elem_bytes(int dtype) { return dtype == 0 ? 4 : dtype == 1 ? 2 : 1; }

}  // namespace

// Bytes of one query's state with a memo of 2^memo_log2 entries (shared
// memory, or its slice of the scratch).
extern "C" long long pgvs_beam_search_full_state_bytes(int l, int window_n, int e, int r,
                                                       int memo_log2) {
  return Layout(l, window_n, e, r, memo_log2).bytes();
}

// Shared memory the query's prefix of Dt floats takes when it is there.
extern "C" long long pgvs_beam_search_full_query_bytes(int dt) {
  return pgvs::query_smem_bytes(dt);
}

// Shared memory the rings of `slots` row copies take in a block of
// `threads` (rows of dt elements of `dtype`, 0 f32, 1 bf16, 2 int8).
extern "C" long long pgvs_beam_search_full_ring_bytes(int slots, int dt, int dtype, int threads) {
  return slots > 0 ? ring_bytes(slots, pgvs::row_copy_bytes(dt, elem_bytes(dtype)), threads / 32)
                   : 0;
}

// The memo's most entries (a launch takes a power of two up to it).
extern "C" int pgvs_beam_search_full_memo_entries() { return kMemoMax; }

// Inputs: vectors [cap, D] of `dtype` (0 f32, 1 bf16, 2 int8), scales
// f32[cap] (int8; else null), adjacency i32[cap, R], node_labels
// i32[cap, Lm] (null when Lq == 0), query_vecs f32[Q, Dt], start_ids
// i32[Q, S], query_labels i32[Q, Lq]; metric: config.DistanceType.
// Outputs as in Params; rows_read: null, or i32[Q] for the rows each query
// read.  scratch: null to keep the state in shared memory, else Q *
// state_bytes bytes; query_shared: the query's prefix in shared memory
// (else read from query_vecs); slots: ring slots a warp (0: each miss read
// by warp_row_distance; above 0, at most kMaxSlots, only when the rows
// start on 16 bytes);
// memo_log2: the memo's 2^memo_log2 entries (1 up to log2 of
// pgvs_beam_search_full_memo_entries()), of which it fills three quarters;
// threads: a block's, 256 or 512.
extern "C" int pgvs_beam_search_full(
    const void* vectors, const void* scales, const void* adjacency, const void* node_labels,
    const void* query_vecs, const void* start_ids, const void* query_labels, void* beam_ids,
    void* beam_dists, void* beam_vis, void* hist_ids, void* hist_dists, void* n_visited,
    void* n_comps, void* win_ids, void* win_dists, void* iters, void* rows_read, void* scratch,
    int q, int cap, long long d, int dt, int dtype, int metric, int r, int lm, int s, int lq,
    int l, int h, int track_hist, int e, int window_n, int query_shared, int slots,
    int memo_log2, int threads, int device, void* stream) {
  if (q <= 0) return static_cast<int>(cudaSuccess);
  if (cap <= 0 || dt <= 0 || dt > d || dtype < 0 || dtype > 2 || metric < 0 || metric > 2 ||
      r <= 0 || s < 0 || lq < 0 || lm < 0 || l <= 0 || h < 0 || e < 1 || e > l ||
      window_n < 0 || slots < 0 || slots > kMaxSlots || memo_log2 < 1 ||
      (threads != 256 && threads != 512) ||
      (1 << memo_log2) > kMemoMax ||
      (lq > 0 && lm > 0 && node_labels == nullptr) || (dtype == 2 && scales == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // This library carries its own CUDA runtime, whose current device is
  // separate from the caller's: point it at the device of the tensors.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.vectors = vectors;
  p.scales = static_cast<const float*>(scales);
  p.adjacency = static_cast<const int*>(adjacency);
  p.node_labels = static_cast<const int*>(node_labels);
  p.qvecs = static_cast<const float*>(query_vecs);
  p.start_ids = static_cast<const int*>(start_ids);
  p.qlabels = static_cast<const int*>(query_labels);
  p.beam_ids = static_cast<int*>(beam_ids);
  p.beam_dists = static_cast<float*>(beam_dists);
  p.beam_vis = static_cast<uint8_t*>(beam_vis);
  p.hist_ids = static_cast<int*>(hist_ids);
  p.hist_dists = static_cast<float*>(hist_dists);
  p.n_visited = static_cast<int*>(n_visited);
  p.n_comps = static_cast<int*>(n_comps);
  p.win_ids = static_cast<int*>(win_ids);
  p.win_dists = static_cast<float*>(win_dists);
  p.iters = static_cast<int*>(iters);
  p.rows_read = static_cast<int*>(rows_read);
  p.scratch = static_cast<unsigned char*>(scratch);
  const Layout lay(l, window_n, e, r, memo_log2);
  p.memo_log2 = memo_log2;
  p.memo_fill = (1 << memo_log2) - (1 << memo_log2) / 4;
  p.state_bytes = lay.bytes();
  lay.place(p);
  p.stride = d;
  p.cap = cap;
  p.dt = dt;
  p.metric = metric;
  p.vec = dtype == 0   ? pgvs::rows_vectorizable<pgvs::kRowF32>(vectors, d)
          : dtype == 1 ? pgvs::rows_vectorizable<pgvs::kRowBF16>(vectors, d)
                       : pgvs::rows_vectorizable<pgvs::kRowI8>(vectors, d);
  if (slots > 0 && !p.vec) return static_cast<int>(cudaErrorInvalidValue);
  p.r = r;
  p.lm = lm;
  p.s = s;
  p.lq = lq;
  p.l = l;
  p.h = h;
  p.track_hist = track_hist != 0;
  p.h_cap = track_hist ? h : 1;
  p.e = e;
  p.window_n = window_n;
  p.iter_bound = (h + e - 1) / e + 1;
  p.slots = slots;
  p.copy_bytes = pgvs::row_copy_bytes(dt, elem_bytes(dtype));
  p.o_ring = query_shared ? static_cast<int>(pgvs::query_smem_bytes(dt)) : 0;
  p.o_state = p.o_ring + static_cast<int>(ring_bytes(slots, p.copy_bytes, threads / 32));
  const size_t smem = static_cast<size_t>(p.o_state + (scratch ? 0 : p.state_bytes));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool qs = query_shared != 0;
  if (dtype == 0) {
    err = launch_dtype<pgvs::kRowF32>(p, q, qs, threads, smem, st);
  } else if (dtype == 1) {
    err = launch_dtype<pgvs::kRowBF16>(p, q, qs, threads, smem, st);
  } else {
    err = launch_dtype<pgvs::kRowI8>(p, q, qs, threads, smem, st);
  }
  return static_cast<int>(err);
}
