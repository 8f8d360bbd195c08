// The whole SBQ beam search, one launch per query batch, for sm_90a.
//
// Replaces the JAX package's `lax.while_loop` in `beam_search`
// (pgvectorscale_tpu/graph/search.py:580); not a Pallas kernel.  Its inner
// step, the Hamming distance through the adjacency, is the TPU kernel
// `hamming_edge_gather_pallas`'s, on the CUDA cores.  Every piece of the
// loop's state is a query's own; the batch shares only the iteration bound.
// A query with no unvisited entry, or with its visit budget spent, is left
// unchanged by a further iteration, so each query runs its own loop to
// convergence or to the bound, and the batch's iteration count is the
// largest of the queries' counts.
//
// One block per query runs the plain version's iteration (graph/search.py
// `beam_search_plain`) in its order:
//  1. the E best unvisited beam entries: the beam is sorted, so they are
//     the first E unvisited valid entries (the stable sort's order); one
//     warp finds them with ballots;
//  2. the visit budget: entries past H stay unvisited;
//  3. mark them visited, write the history, count the visits;
//  4. gather their adjacency rows (E*R slots), every load in flight at once
//     (slot i's row is i / R, a high multiply);
//  5. a filtered search keeps a neighbour only if its labels overlap the
//     query's (sentinel excluded), one vector load a label row;
//  6. drop neighbours already in the beam: a lookup in an open-addressing
//     table of the beam's ids, rebuilt after each merge;
//  7. drop a neighbour seen in an earlier slot: each slot puts its slot
//     into a second table with atomicMin under its id, and survives when
//     the minimum is its own, the "first slot of an id survives" set of
//     the plain version's two dedup branches (which differ only in the
//     candidates' order: slot order for E*R <= 192, id order above);
//  8. score the survivors (Hamming through the adjacency), each warp its
//     own, two rows a lane group in flight, the query row in shared memory;
//     each warp keeps the keys of the ones the merges need (below) in its
//     own part of the key buffer, so no atomics;
//  9. sort them by the key (distance, slot or id) and merge them into the
//     window (when kept) and the beam with the plain version's bitonic
//     network: [row | +inf pad | candidates descending], strides n/2 .. 1,
//     a swap only on a strict >.
// The start nodes' dedup, distances and stable sort happen here too.
//
// What the merge needs of the candidates, and so what is sorted.  Let t be
// the row's last distance.  When t is finite, at least wl entries (the
// row) are <= t, so the first wl outputs are entries <= t, and an entry
// <= t meets an entry > t in a compare-exchange only to stay in the lower
// wire: its path does not depend on the larger value.  So a candidate > t
// may be replaced by +inf padding without changing the first wl outputs.
// The candidates <= T (T the larger of the beam's and the window's t) are
// the only ones sorted and placed; they keep their positions, the n - 1 - c
// of the c-th smallest, because the dropped ones are the largest.
//
// The merge network, trimmed.  A bitonic merge's stride s leaves each
// 2s-block closed under every later stride, so only the blocks that meet
// the kept [0, wl) run; when wl <= n/2 the first stride is fused into the
// build of the buffer and only its lower half is written.  Strides of 16
// and below run on registers with shuffles, one 32-entry segment a warp.
// The kept entries go through exactly the compare-exchanges of the whole
// network, so every tie lands where it lands in the plain version.
//
// The sort key: the distance (an integer <= 32 W) in the high 32 bits, the
// tie-break (the slot, or the id in a wide row) in the low 32; keys are
// unique among survivors, so any sort gives the same order.  Up to 32 keys
// (most iterations, once the beam is full): one a lane of warp 0, a bitonic
// network of shuffles.  Up to 128: warp 0 on registers, items e = 32 m +
// lane, m < 4.  More: every warp, 128 keys each; strides below 32 shuffle,
// 32 and 64 swap inside a thread, 128 and above go through shared memory
// (one barrier each, double buffered).
//
// Bound: bytes, and the chain of dependent iterations (each waits on an
// adjacency read and then on code-row reads; the 100k code table, 19.2 MB
// at W = 48, and the adjacency fit in the 50 MB L2).  Design: one block a
// query, of 256 threads unless that needs more rounds of blocks over the
// SMs than 128 (launch_as): 1,024 queries at the search's 23 KB state run
// in one round of 128-thread blocks, 8 an SM; a query alone runs in 256.
// At either size a thread has at most 64 registers and none spills.  The
// loop's code is kept small (one copy of the dedup and of the merge, no
// unrolled loops of runtime length): it is fetched again every iteration,
// and instruction fetch, not arithmetic, set most of its time.  The state
// lives in shared memory (32-bit shared-window pointers, from offsets in the
// constant bank) or, when the caller gives a scratch buffer for a state too
// large, in the query's slice of it, through the same code.  The loop has
// no host in it.
//
// Plain C interface for ctypes: raw pointers, sizes and the caller's
// stream.  The function launches, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hamming.cuh"

// 0: the launch picks the block of 128 or 256 threads (beam_search_kernel's
// NT); 128 or 256 forces one, for a comparison of the two.
#ifndef PGVS_BEAM_THREADS
#define PGVS_BEAM_THREADS 0
#endif

namespace {

// A block of NT threads (128 or 256) runs a query; NT * blocks an SM must
// hold at once is 1,024 threads, which caps a thread at 64 registers.
constexpr int kMaxWarps = 8;
// Slots a pass of the expansion covers; a thread holds kChunk / NT of them
// in registers.
constexpr int kChunk = 512;
// Keys a lane holds in the sort; a warp sorts 128, the block NT / 32 * 128.
constexpr int kItems = 4;
constexpr int kLabelSentinel = 0x7fffffff;
constexpr int kNarrowRow = 192;  // E*R <= 192: slot order, else id order
constexpr int kEmpty = -1;       // an empty hash slot
constexpr unsigned long long kNoKey = ~0ull;
// misc words: the stop flag, the active visits, the start nodes' count, then
// each warp's survivors and kept keys.
enum {
  kStop = 0,
  kNact = 1,
  kNs = 2,
  kSurv = 8,
  kKept = 8 + kMaxWarps,
  kMisc = 8 + 2 * kMaxWarps,
};

struct Params {
  const int* codes;        // [cap, W]
  const int* adjacency;    // [cap, R]
  const int* node_labels;  // [cap, Lm]
  const int* qcodes;       // [Q, W]
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
  unsigned char* scratch;  // [Q, state_bytes], or null: shared memory
  long long state_bytes;
  int cap, w, r, lm, lm_vec, s, lq, l, h, h_cap, track_hist, e, window_n, iter_bound, chunks,
      log2g;
  // The state's layout (Layout), in 4-byte words from the query's base.
  // Kept here, in the constant bank, so that the kernel's pointers are one
  // add from a constant and need no register across the loop.
  int er, narrow, n_beam, n_win, hb, hr, hb_shift, hr_shift, query_at;
  unsigned r_magic;  // ceil(2^32 / R), or 0 when R == 1: __umulhi(i, r_magic) == i / R
  int o_sk, o_md, o_mt, o_bh, o_rk, o_rv, o_beam_d, o_beam_t, o_win_d, o_win_t, o_fid, o_cs_d,
      o_cs_t, o_sel_pos, o_sel_id, o_misc;
};

__host__ __device__ inline int pow2_at_least(int x) {
  int n = 1;
  while (n < x) n <<= 1;
  return n;
}

__host__ __device__ inline int log2_of(int pow2) {
  int k = 0;
  while ((1 << k) < pow2) ++k;
  return k;
}

__host__ __device__ inline long long round4(long long words) { return (words + 3) & ~3LL; }

// The keys a warp of a block of nt threads may keep: 32 a pass of the
// expansion's slots.
__host__ __device__ inline int sk_span(int er, int nt) { return 32 * ((er + nt - 1) / nt); }

// Words of shared memory that hold the query's code row and labels.
__host__ __device__ inline long long query_words(int w, int lq) { return round4(w) + round4(lq); }

// The query's state, in 4-byte words, in this order (each part a multiple
// of 4 words, so the 8- and 16-byte parts stay aligned):
//   sk    [ps] u64     the keys to sort; the sort's first buffer
//   mm    [2 * nmm]    the merge buffer (md | mt); the sort's second buffer
//                      (nmm u64); the warps' survivor lists (nmm int2)
//   bh    [2 * hb]     two tables of the beam's ids (current, next)
//   rk,rv [hr], [hr]   the in-row table: id, least slot
//   beam_d, beam_t [L]; win_d, win_t [Wn]; fid, cs_d, cs_t [E*R];
//   sel_pos, sel_id [E]; misc [kMisc]
// The query's code row and labels (query_words(W, Lq)) follow it in shared
// memory, or stand alone there when the state is in the scratch buffer.
struct Layout {
  int l, wn, er, e, nm, ps, nmm, hb, hr;
  Layout(int l_, int window_n, int e_, int r) : l(l_), wn(window_n), e(e_) {
    er = e_ * r;
    nm = pow2_at_least(l_ + er);
    if (wn > 0 && pow2_at_least(wn + er) > nm) nm = pow2_at_least(wn + er);
    // Room for the sort's power of two, and for each warp's keys at either
    // block shape (sk_span).
    ps = pow2_at_least(er < 2 ? 2 : er);
    if (ps < 4 * sk_span(er, 128)) ps = 4 * sk_span(er, 128);
    if (ps < 8 * sk_span(er, 256)) ps = 8 * sk_span(er, 256);
    nmm = nm;
    if (nmm < ps) nmm = ps;
    if (nmm < kChunk) nmm = kChunk;
    hb = pow2_at_least(2 * l_);
    if (hb < 4) hb = 4;
    hr = pow2_at_least(2 * er);
    if (hr < 4) hr = 4;
  }
  long long mm() const { return 2LL * ps; }  // sk is at 0
  long long bh() const { return mm() + 2LL * nmm; }
  long long rk() const { return bh() + 2LL * hb; }
  long long rest() const { return rk() + 2LL * hr; }
  long long words() const { return rest() + 2LL * l + 2LL * wn + 3LL * er + 2LL * e + kMisc; }
  long long bytes() const { return ((words() * 4 + 15) / 16) * 16; }
  // Write the offsets into p.
  void place(Params& p) const {
    p.er = er;
    p.narrow = er <= kNarrowRow;
    p.n_beam = pow2_at_least(l + er);
    p.n_win = wn > 0 ? pow2_at_least(wn + er) : 0;
    p.hb = hb;
    p.hr = hr;
    p.hb_shift = 32 - log2_of(hb);
    p.hr_shift = 32 - log2_of(hr);
    p.o_sk = 0;
    p.o_md = static_cast<int>(mm());
    p.o_mt = p.o_md + nmm;
    p.o_bh = static_cast<int>(bh());
    p.o_rk = static_cast<int>(rk());
    p.o_rv = p.o_rk + hr;
    p.o_beam_d = static_cast<int>(rest());
    p.o_beam_t = p.o_beam_d + l;
    p.o_win_d = p.o_beam_t + l;
    p.o_win_t = p.o_win_d + wn;
    p.o_fid = p.o_win_t + wn;
    p.o_cs_d = p.o_fid + er;
    p.o_cs_t = p.o_cs_d + er;
    p.o_sel_pos = p.o_cs_t + er;
    p.o_sel_id = p.o_sel_pos + e;
    p.o_misc = p.o_sel_id + e;
  }
};

__device__ __forceinline__ unsigned hash_slot(int id, int shift) {
  return (static_cast<unsigned>(id) * 0x9E3779B1u) >> shift;
}

// Insert id into an open-addressing table of 2^(32 - shift) slots; a
// present id is left as it is.  Returns its slot.
__device__ __forceinline__ unsigned table_insert(int* table, int id, int shift) {
  const unsigned mask = (1u << (32 - shift)) - 1u;
  unsigned hs = hash_slot(id, shift);
  while (true) {
    const int prev = atomicCAS(table + hs, kEmpty, id);
    if (prev == kEmpty || prev == id) return hs;
    hs = (hs + 1) & mask;
  }
}

// The slot of id in the table, or -1 when it is absent.
__device__ __forceinline__ int table_find(const int* table, int id, int shift) {
  const unsigned mask = (1u << (32 - shift)) - 1u;
  unsigned hs = hash_slot(id, shift);
  while (true) {
    const int x = table[hs];
    if (x == id) return static_cast<int>(hs);
    if (x == kEmpty) return -1;
    hs = (hs + 1) & mask;
  }
}

template <int NT>
__device__ __forceinline__ void fill(int* a, int n, int v) {  // n % 4 == 0, a 16-byte aligned
  int4* a4 = reinterpret_cast<int4*>(a);
#pragma unroll 1
  for (int j = threadIdx.x; j < (n >> 2); j += NT) a4[j] = make_int4(v, v, v, v);
}

template <int V>
__device__ __forceinline__ typename pgvs::Chunk<V>::T load_chunk(const int* row, int c) {
  return __ldg(reinterpret_cast<const typename pgvs::Chunk<V>::T*>(row) + c);
}

template <int V>
__device__ __forceinline__ typename pgvs::Chunk<V>::T shared_chunk(const int* row, int c) {
  return reinterpret_cast<const typename pgvs::Chunk<V>::T*>(row)[c];
}

// popc(code row ^ query row) of U rows at once, this lane's share: chunks
// lane, lane + g, ...; CPL chunks a round; rows[u] < 0 adds nothing.  Every
// load of a round is issued before any is used.  The query row is in
// shared memory.
template <int V, int CPL, int U>
__device__ __forceinline__ void lane_pops(const int* codes, const int (&rows)[U], int w,
                                          const int* qs, int chunks, int lane_in_group, int g,
                                          unsigned (&pop)[U]) {
  using C = pgvs::Chunk<V>;
  using T = typename C::T;
#pragma unroll
  for (int u = 0; u < U; ++u) pop[u] = 0;
#pragma unroll 1
  for (int c0 = lane_in_group; c0 < chunks; c0 += CPL * g) {
    T a[U][CPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int* crow = codes + static_cast<long long>(rows[u] < 0 ? 0 : rows[u]) * w;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = c0 + i * g;
        a[u][i] = (c < chunks && rows[u] >= 0) ? load_chunk<V>(crow, c) : C::zero();
      }
    }
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = c0 + i * g;
      if (c < chunks) {
        const T b = shared_chunk<V>(qs, c);
#pragma unroll
        for (int u = 0; u < U; ++u) pop[u] += C::pop_xor(a[u][i], b);
      }
    }
  }
}

// Key e of the kept keys: warp w's cw[w] keys sit at sk[w * span ...].
__device__ __forceinline__ unsigned long long key_at(const unsigned long long* sk, const int* cw,
                                                     int span, int e) {
  int w = 0;
  while (e >= cw[w]) e -= cw[w++];
  return sk[w * span + e];
}

__device__ __forceinline__ unsigned long long umin(unsigned long long a, unsigned long long b) {
  return a < b ? a : b;
}
__device__ __forceinline__ unsigned long long umax(unsigned long long a, unsigned long long b) {
  return a < b ? b : a;
}

// One in-thread compare-exchange of the sort: items x < y of element e.
__device__ __forceinline__ void sort_pair(unsigned long long& x, unsigned long long& y, int e,
                                          int k) {
  const unsigned long long lo = umin(x, y), hi = umax(x, y);
  const bool asc = !(e & k);
  x = asc ? lo : hi;
  y = asc ? hi : lo;
}

// Sort n keys ascending (n a power of two; element e >= the live count
// holds kNoKey).  key[m] is element 128 * warp + 32 * m + lane.  Every
// thread must call it when n > 128; at n <= 128 only warp 0 has work.
__device__ __forceinline__ void block_sort(unsigned long long (&key)[kItems], int n,
                                           unsigned long long* buf0, unsigned long long* buf1) {
  const int lane = threadIdx.x & 31;
  const int base = (threadIdx.x >> 5) * 32 * kItems;
  int parity = 0;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 32 * kItems) {  // across warps, through shared memory
        unsigned long long* b = parity ? buf1 : buf0;
        parity ^= 1;
#pragma unroll
        for (int m = 0; m < kItems; ++m) {
          const int e = base + m * 32 + lane;
          if (e < n) b[e] = key[m];
        }
        __syncthreads();
#pragma unroll
        for (int m = 0; m < kItems; ++m) {
          const int e = base + m * 32 + lane;
          if (e >= n) continue;
          const unsigned long long o = b[e ^ j];
          const bool keep_min = !(e & k) == !(e & j);
          key[m] = keep_min ? umin(key[m], o) : umax(key[m], o);
        }
      } else if (base >= n) {  // a warp past the keys: nothing to sort
        continue;
      } else if (j >= 32) {  // inside a thread
        if (j == 32) {
          sort_pair(key[0], key[1], base + lane, k);
          sort_pair(key[2], key[3], base + 64 + lane, k);
        } else {
          sort_pair(key[0], key[2], base + lane, k);
          sort_pair(key[1], key[3], base + 32 + lane, k);
        }
      } else {  // across lanes
#pragma unroll
        for (int m = 0; m < kItems; ++m) {
          if (m * 32 >= n) break;  // at n <= 96 the higher items are all kNoKey
          const int e = base + m * 32 + lane;
          const unsigned long long o = __shfl_xor_sync(0xffffffffu, key[m], j);
          const bool keep_min = !(e & k) == !(lane & j);
          key[m] = keep_min ? umin(key[m], o) : umax(key[m], o);
        }
      }
    }
  }
}

// Merge the nr sorted candidates (cs_d ascending, their tags tag_mul *
// cs_t) into the sorted row (row_d, row_t) of width wl, keeping the best wl:
// the plain version's network over n = pow2(wl + E*R) entries, trimmed to
// the blocks that meet [0, wl); pad_tag marks the +inf entries.
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
    for (int p = tid; p < pairs; p += kThreads) {
      const int lo = ((p & ~(s - 1)) << 1) | (p & (s - 1));
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

// Does the label row nl (lm words) overlap the query's labels (ql, lq
// words)?  The sentinel pads both and matches nothing.  lm_vec: 4 when the
// rows are 16-byte aligned multiples of 4 words, 2 when they are 2 aligned
// words (one vector load a row, or a quarter row), else 1.
__device__ __forceinline__ bool labels_overlap(const int* nl, int lm, int lm_vec, const int* ql,
                                               int lq) {
  bool any = false;
#pragma unroll 1
  for (int a = 0; a < lm; a += 4) {
    int4 x;
    if (lm_vec == 4) {
      x = __ldg(reinterpret_cast<const int4*>(nl + a));
    } else if (lm_vec == 2) {
      const int2 y = __ldg(reinterpret_cast<const int2*>(nl));
      x = make_int4(y.x, y.y, kLabelSentinel, kLabelSentinel);
    } else {
      x.x = __ldg(nl + a);
      x.y = a + 1 < lm ? __ldg(nl + a + 1) : kLabelSentinel;
      x.z = a + 2 < lm ? __ldg(nl + a + 2) : kLabelSentinel;
      x.w = a + 3 < lm ? __ldg(nl + a + 3) : kLabelSentinel;
    }
#pragma unroll 1
    for (int b = 0; b < lq; ++b) {
      const int y = ql[b];
      any |= y != kLabelSentinel && (x.x == y || x.y == y || x.z == y || x.w == y);
    }
  }
  return any;
}

// kScratch: the state is in the query's slice of p.scratch (generic
// pointers), else in shared memory, where every pointer below is a 32-bit
// shared-window address and every access a shared-memory instruction.
template <int V, int CPL, bool kScratch, int NT>
__global__ void __launch_bounds__(NT, 1024 / NT)
    beam_search_kernel(const __grid_constant__ Params p) {
  constexpr int kThreads = NT, kWarps = NT / 32, kSlots = kChunk / NT;
  constexpr int kSortCap = kWarps * 32 * kItems;
  static_assert(NT % 32 == 0 && kChunk % NT == 0 && kWarps <= kMaxWarps, "block shape");
  extern __shared__ __align__(16) unsigned char smem[];
  // Rows a lane group scores at once: at most 24 words of loads in flight a
  // lane (3 rows at W = 48 spill under the 64-register cap).
  constexpr int U = V * CPL <= 4 ? 3 : (V * CPL <= 12 ? 2 : 1);
  const int q = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int l = p.l, wn = p.window_n, er = p.er, e = p.e, r = p.r;
  int* words = reinterpret_cast<int*>(
      kScratch ? p.scratch + static_cast<long long>(q) * p.state_bytes : smem);
  unsigned long long* sk = reinterpret_cast<unsigned long long*>(words + p.o_sk);
  float* md = reinterpret_cast<float*>(words + p.o_md);
  int* mt = words + p.o_mt;
  int* bh = words + p.o_bh;  // [2][hb]
  int* rk = words + p.o_rk;
  int* rv = words + p.o_rv;
  int* qs = reinterpret_cast<int*>(smem) + p.query_at;  // [W]
  int* ql = qs + round4(p.w);                           // [Lq]
  float* beam_d = reinterpret_cast<float*>(words + p.o_beam_d);
  int* beam_t = words + p.o_beam_t;  // 2 * id + visited; -2 = empty
  float* win_d = reinterpret_cast<float*>(words + p.o_win_d);
  int* win_t = words + p.o_win_t;                          // id; -1 = empty
  int* fid = words + p.o_fid;                              // [E*R] candidate id, or -1
  float* cs_d = reinterpret_cast<float*>(words + p.o_cs_d);  // [nr] sorted ascending
  int* cs_t = words + p.o_cs_t;                            // [nr] their ids
  int* sel_pos = words + p.o_sel_pos;                      // [E]
  int* sel_id = words + p.o_sel_id;                        // [E]
  int* misc = words + p.o_misc;                            // [kMisc]
  const int hb_shift = p.hb_shift, hr_shift = p.hr_shift;
  const int span = sk_span(er, NT);  // a warp's room in sk

  const int g = 1 << p.log2g;
  const int lane_in_group = lane & (g - 1);
  const int group = lane >> p.log2g;  // in the warp
  const int groups = 32 >> p.log2g;   // a warp's
  const int* starts = p.start_ids + static_cast<long long>(q) * p.s;
  const bool narrow = p.narrow;
  // A warp's survivor list: (slot, id) pairs, 32 * kSlots of them.
  int2* wlist = reinterpret_cast<int2*>(md) + warp * 32 * kSlots;

  // ---- set-up: the query's rows, empty tables, the start nodes ----
  for (int j = tid; j < p.w; j += kThreads) qs[j] = p.qcodes[static_cast<long long>(q) * p.w + j];
  for (int j = tid; j < p.lq; j += kThreads)
    ql[j] = p.qlabels[static_cast<long long>(q) * p.lq + j];
  fill<NT>(bh, 2 * p.hb, kEmpty);
  fill<NT>(rk, p.hr, kEmpty);
  fill<NT>(rv, p.hr, 0x7fffffff);
  for (int j = tid; j < l; j += kThreads) {
    beam_d[j] = INFINITY;
    beam_t[j] = -2;
  }
  if (tid == 0) misc[kNs] = 0;
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
  if (local) atomicAdd(misc + kNs, local);
  __syncthreads();
  int n_comps = misc[kNs];
  for (int b0 = 0; b0 < s_in; b0 += kWarps * groups) {
    const int j = b0 + warp * groups + group;
    int rows[1] = {j < s_in ? mt[j] : -1};
    if (rows[0] >= 0) rows[0] = min(rows[0], p.cap - 1);
    unsigned pop[1];
    lane_pops<V, CPL, 1>(p.codes, rows, p.w, qs, p.chunks, lane_in_group, g, pop);
    pop[0] = pgvs::group_sum(pop[0], g);
    if (j < s_in && lane_in_group == 0) md[j] = mt[j] >= 0 ? static_cast<float>(pop[0]) : INFINITY;
  }
  __syncthreads();
  for (int j = tid; j < s_in; j += kThreads) {
    const float dj = md[j];
    if (!(dj < INFINITY)) continue;
    int rank = 0;
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
  for (int j = tid; j < l; j += kThreads) {
    const int t = beam_t[j];
    if (t >= 0) table_insert(bh, t >> 1, hb_shift);
  }
  __syncthreads();

  int cur = 0;  // the beam table that holds the beam's ids
  int n_vis = 0, it = 0;
  while (it < p.iter_bound) {
    // 1-3: select, apply the budget, visit (warp 0).
    if (warp == 0) {
      bool any = false;
      int found = 0;
#pragma unroll 1
      for (int b0 = 0; b0 < l; b0 += 32) {
        const int j = b0 + lane;
        const int t = j < l ? beam_t[j] : -2;
        const bool unvisited = t >= 0 && !(t & 1);
        const bool pred = unvisited && beam_d[j] < INFINITY;
        any |= __any_sync(0xffffffffu, unvisited);
        const unsigned m = __ballot_sync(0xffffffffu, pred);
        const int idx = found + __popc(m & ((1u << lane) - 1u));
        if (pred && idx < e) sel_pos[idx] = j;
        found += __popc(m);
        if (found >= e) break;
      }
      const int nsel = found < e ? found : e;
      const int nact = nsel < p.h - n_vis ? nsel : p.h - n_vis;
      __syncwarp();
#pragma unroll 1
      for (int k = lane; k < nact; k += 32) {
        const int pos = sel_pos[k];
        const int t = beam_t[pos];
        sel_id[k] = t >> 1;
        beam_t[pos] = t | 1;
        if (p.track_hist) {
          p.hist_ids[hrow + n_vis + k] = t >> 1;
          p.hist_dists[hrow + n_vis + k] = beam_d[pos];
        }
      }
      if (lane == 0) {
        misc[kStop] = !any || n_vis >= p.h;
        misc[kNact] = nact;
      }
    }
    __syncthreads();
    if (misc[kStop]) break;
    const int nact = misc[kNact];
    n_vis += nact;

    // 4-7: expand, the label mask, the in-beam lookup, the in-row insert.
    fill<NT>(bh + (cur ^ 1) * p.hb, p.hb, kEmpty);
    const int* beam_table = bh + cur * p.hb;
    for (int c0 = 0; c0 < er; c0 += kChunk) {
      int nbv[kSlots];
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        const int i = c0 + m * kThreads + tid;
        const int k = p.r_magic ? __umulhi(i, p.r_magic) : i;  // i / r
        nbv[m] = (i < er && k < nact)
                     ? __ldg(p.adjacency + static_cast<long long>(sel_id[k]) * r + (i - k * r))
                     : -1;
      }
      // Park the ids, so that the dedup below is one copy of its code.
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        const int i = c0 + m * kThreads + tid;
        if (i < er) fid[i] = nbv[m];
      }
#pragma unroll 1
      for (int i = c0 + tid; i < er && i < c0 + kChunk; i += kThreads) {
        int id = fid[i];
        if (id >= 0 && p.lq > 0 &&
            !labels_overlap(p.node_labels + static_cast<long long>(id) * p.lm, p.lm, p.lm_vec,
                            ql, p.lq))
          id = -1;
        if (id >= 0 && table_find(beam_table, id, hb_shift) >= 0) id = -1;
        if (id >= 0) atomicMin(rv + table_insert(rk, id, hr_shift), i);
        fid[i] = id;
      }
    }
    __syncthreads();

    // 7-8: the survivors (the least slot of their id), scored by the warps.
    float t_row = beam_d[l - 1];
    if (wn > 0 && win_d[wn - 1] > t_row) t_row = win_d[wn - 1];
    const unsigned below = (1u << lane) - 1u;
    int surv_w = 0, kept_w = 0;  // this warp's survivors and kept keys
    for (int c0 = 0; c0 < er; c0 += kChunk) {
      int cnt = 0;
#pragma unroll 1
      for (int m = 0; m < kSlots; ++m) {
        const int i = c0 + m * kThreads + tid;
        const int id = i < er ? fid[i] : -1;
        const bool surv = id >= 0 && rv[table_find(rk, id, hr_shift)] == i;
        const unsigned bm = __ballot_sync(0xffffffffu, surv);
        if (surv) wlist[cnt + __popc(bm & below)] = make_int2(i, id);
        cnt += __popc(bm);
      }
      surv_w += cnt;
      __syncwarp();
      for (int b0 = 0; b0 < cnt; b0 += U * groups) {
        int rows[U];
        int2 sl[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = b0 + u * groups + group;
          sl[u] = c < cnt ? wlist[c] : make_int2(-1, -1);
          rows[u] = sl[u].y < 0 ? -1 : min(sl[u].y, p.cap - 1);
        }
        unsigned pop[U];
        lane_pops<V, CPL, U>(p.codes, rows, p.w, qs, p.chunks, lane_in_group, g, pop);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const unsigned d = pgvs::group_sum(pop[u], g);
          const bool keep =
              lane_in_group == 0 && sl[u].y >= 0 && static_cast<float>(d) <= t_row;
          const unsigned km = __ballot_sync(0xffffffffu, keep);
          if (keep) {
            const unsigned tb = narrow ? sl[u].x : sl[u].y;
            sk[warp * span + kept_w + __popc(km & below)] =
                (static_cast<unsigned long long>(d) << 32) | tb;
          }
          kept_w += __popc(km);
        }
      }
      __syncwarp();
    }
    if (lane == 0) {
      misc[kSurv + warp] = surv_w;
      misc[kKept + warp] = kept_w;
    }
    __syncthreads();
    fill<NT>(rk, p.hr, kEmpty);
    fill<NT>(rv, p.hr, 0x7fffffff);
    int nr = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      n_comps += misc[kSurv + w];
      nr += misc[kKept + w];
    }
    const int* kept = misc + kKept;
    if (nr == 0) {  // nothing to merge: both rows stay as they are
      ++it;
      continue;
    }

    // 9: sort by (distance, slot or id), then the window and beam merges.
    if (nr <= 32) {  // most iterations: one key a lane of warp 0
      if (warp == 0) {
        unsigned long long key = lane < nr ? key_at(sk, kept, span, lane) : kNoKey;
        const int n = pow2_at_least(nr);
#pragma unroll 1
        for (int k = 2; k <= n; k <<= 1) {
#pragma unroll 1
          for (int j = k >> 1; j > 0; j >>= 1) {
            const unsigned long long o = __shfl_xor_sync(0xffffffffu, key, j);
            key = !(lane & k) == !(lane & j) ? umin(key, o) : umax(key, o);
          }
        }
        if (lane < nr) {
          const unsigned tb = static_cast<unsigned>(key);
          cs_d[lane] = static_cast<float>(static_cast<unsigned>(key >> 32));
          cs_t[lane] = narrow ? fid[tb] : static_cast<int>(tb);
        }
      }
    } else if (nr <= kSortCap) {
      const int n = pow2_at_least(nr);
      if (n > 32 * kItems || warp == 0) {
        unsigned long long key[kItems];
#pragma unroll
        for (int m = 0; m < kItems; ++m) {
          const int ei = warp * 32 * kItems + m * 32 + lane;
          key[m] = ei < nr ? key_at(sk, kept, span, ei) : kNoKey;
        }
        if (n > 32 * kItems) __syncthreads();  // every key read before sk is reused
        block_sort(key, n, sk, reinterpret_cast<unsigned long long*>(md));
#pragma unroll
        for (int m = 0; m < kItems; ++m) {
          const int ei = warp * 32 * kItems + m * 32 + lane;
          if (ei < nr) {
            const unsigned tb = static_cast<unsigned>(key[m]);
            cs_d[ei] = static_cast<float>(static_cast<unsigned>(key[m] >> 32));
            cs_t[ei] = narrow ? fid[tb] : static_cast<int>(tb);
          }
        }
      }
    } else {  // wider than the register sort (E*R > kSortCap): rank by count
      for (int c = tid; c < nr; c += kThreads) {
        const unsigned long long kc = key_at(sk, kept, span, c);
        int rank = 0;
        for (int k = 0; k < nr; ++k) rank += key_at(sk, kept, span, k) < kc;
        const unsigned tb = static_cast<unsigned>(kc);
        cs_d[rank] = static_cast<float>(static_cast<unsigned>(kc >> 32));
        cs_t[rank] = narrow ? fid[tb] : static_cast<int>(tb);
      }
    }
    __syncthreads();
    // The window (its tags are ids), then the beam (2 * id + visited): one
    // copy of the merge's code for both.
#pragma unroll 1
    for (int row = wn > 0 ? 0 : 1; row < 2; ++row) {
      const bool beam = row == 1;
      merge_row<NT>(beam ? beam_d : win_d, beam ? beam_t : win_t, beam ? l : wn,
                beam ? p.n_beam : p.n_win, nr, cs_d, cs_t, beam ? 2 : 1, beam ? -2 : -1, md, mt);
    }
    cur ^= 1;
#pragma unroll 1
    for (int j = tid; j < l; j += kThreads) {
      const int t = beam_t[j];
      if (t >= 0) table_insert(bh + cur * p.hb, t >> 1, hb_shift);
    }
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
  if (tid == 0) {
    p.n_visited[q] = n_vis;
    p.n_comps[q] = n_comps;
    p.iters[q] = it;
  }
}

template <int V, int CPL, bool kScratch, int NT>
cudaError_t prepare(size_t smem, int* blocks_per_sm) {
  const auto kernel = beam_search_kernel<V, CPL, kScratch, NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, NT, smem);
  return err;
}

// The block of 256 threads, unless it needs more rounds of blocks over the
// card's SMs than the block of 128: each query's loop is then shorter, and
// the batch as many rounds long.
template <int V, int CPL, bool kScratch>
cudaError_t launch_as(const Params& p, int q, size_t smem, cudaStream_t stream) {
  int b128 = 0, b256 = 0, sms = 0, device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = prepare<V, CPL, kScratch, 128>(smem, &b128);
  if (err == cudaSuccess) err = prepare<V, CPL, kScratch, 256>(smem, &b256);
  if (err != cudaSuccess) return err;
  if (b128 < 1 || b256 < 1) return cudaErrorInvalidConfiguration;
  const long long rounds128 = (q + static_cast<long long>(sms) * b128 - 1) / (sms * b128);
  const long long rounds256 = (q + static_cast<long long>(sms) * b256 - 1) / (sms * b256);
  const bool wide = PGVS_BEAM_THREADS ? PGVS_BEAM_THREADS == 256 : rounds256 <= rounds128;
  if (wide)
    beam_search_kernel<V, CPL, kScratch, 256><<<q, 256, smem, stream>>>(p);
  else
    beam_search_kernel<V, CPL, kScratch, 128><<<q, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int V, int CPL>
cudaError_t launch(const Params& p, int q, size_t smem, cudaStream_t stream) {
  return p.scratch ? launch_as<V, CPL, true>(p, q, smem, stream)
                   : launch_as<V, CPL, false>(p, q, smem, stream);
}

}  // namespace

// Bytes of one query's state (shared memory, or its slice of the scratch).
// The query's code row and labels, 4 * query_words(W, Lq) bytes, are in
// shared memory besides.
extern "C" long long pgvs_beam_search_state_bytes(int l, int window_n, int e, int r) {
  return Layout(l, window_n, e, r).bytes();
}

// Inputs: codes i32[cap, W], adjacency i32[cap, R], node_labels i32[cap, Lm]
// (null when Lq == 0), query_codes i32[Q, W], start_ids i32[Q, S],
// query_labels i32[Q, Lq].  Outputs as in Params.  scratch: null to keep
// the state in shared memory, else Q * state_bytes bytes.
extern "C" int pgvs_beam_search(const void* codes, const void* adjacency, const void* node_labels,
                                const void* query_codes, const void* start_ids,
                                const void* query_labels, void* beam_ids, void* beam_dists,
                                void* beam_vis, void* hist_ids, void* hist_dists, void* n_visited,
                                void* n_comps, void* win_ids, void* win_dists, void* iters,
                                void* scratch, int q, int cap, int w, int r, int lm, int s, int lq,
                                int l, int h, int track_hist, int e, int window_n, int device,
                                void* stream) {
  if (q <= 0) return static_cast<int>(cudaSuccess);
  if (cap <= 0 || w <= 0 || r <= 0 || s < 0 || lq < 0 || lm < 0 || l <= 0 || h < 0 || e < 1 ||
      e > l || window_n < 0 || (lq > 0 && lm > 0 && node_labels == nullptr) ||
      static_cast<long long>(e) * r * r >= (1LL << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  // This library carries its own CUDA runtime, whose current device is
  // separate from the caller's: point it at the device of the tensors.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.codes = static_cast<const int*>(codes);
  p.adjacency = static_cast<const int*>(adjacency);
  p.node_labels = static_cast<const int*>(node_labels);
  p.qcodes = static_cast<const int*>(query_codes);
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
  p.scratch = static_cast<unsigned char*>(scratch);
  const Layout lay(l, window_n, e, r);
  p.state_bytes = lay.bytes();
  lay.place(p);
  p.query_at = scratch ? 0 : static_cast<int>(p.state_bytes / 4);
  p.cap = cap;
  p.w = w;
  p.r = r;
  p.lm = lm;
  // One vector load a label row when the row is 2 or 4 words and aligned.
  const uintptr_t lab = reinterpret_cast<uintptr_t>(node_labels);
  p.lm_vec = (lm % 4 == 0 && lab % 16 == 0) ? 4 : ((lm == 2 && lab % 8 == 0) ? 2 : 1);
  p.s = s;
  p.lq = lq;
  p.l = l;
  p.h = h;
  p.track_hist = track_hist != 0;
  p.h_cap = track_hist ? h : 1;
  p.e = e;
  p.window_n = window_n;
  p.iter_bound = (h + e - 1) / e + 1;
  // i / R as a high multiply, exact while i * R < 2^32 for every slot i < E*R.
  p.r_magic = r > 1 ? static_cast<unsigned>(((1ULL << 32) + r - 1) / r) : 0u;
  const pgvs::GroupShape shape = pgvs::group_shape(w, codes, query_codes);
  p.chunks = w / shape.v;
  p.log2g = shape.log2g;
  const size_t smem =
      (scratch ? 0 : static_cast<size_t>(p.state_bytes)) + 4 * query_words(w, lq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PGVS_LAUNCH(V, CPL) err = launch<V, CPL>(p, q, smem, st)
  if (shape.v == 4) {
    switch (shape.cpl) {
      case 1: PGVS_LAUNCH(4, 1); break;
      case 2: PGVS_LAUNCH(4, 2); break;
      case 3: PGVS_LAUNCH(4, 3); break;
      default: PGVS_LAUNCH(4, 4); break;
    }
  } else {
    switch (shape.cpl) {
      case 1: PGVS_LAUNCH(1, 1); break;
      case 2: PGVS_LAUNCH(1, 2); break;
      case 3: PGVS_LAUNCH(1, 3); break;
      default: PGVS_LAUNCH(1, 4); break;
    }
  }
#undef PGVS_LAUNCH
  return static_cast<int>(err);
}
