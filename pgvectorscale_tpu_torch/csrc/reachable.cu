// Reachability from the start node, one launch per BFS, for sm_90a.
//
// Replaces the JAX package's two device loops of the build's reachability
// BFS: the scatter BFS (`_reachable_scatter`'s `lax.while_loop`,
// pgvectorscale_tpu/graph/build.py:1115) and the CSR pull-BFS
// (`_reachable_csr`, :1153), which `reachable_on_device` (:1163) chooses
// between by capacity; neither is a Pallas kernel.
//
// What it computes: out[v] = 1 for the rows v in [0, count) reachable from
// `start` over adjacency int32[cap, r], else 0, for every v < cap.  A
// negative id is no edge; an id at or past `count` is neither reached nor
// expanded (ids past `cap` included); with start < 0 or start >= count
// nothing is reachable.
//
// Bound on an H100: each reached row's adjacency is read once (count * r * 4
// bytes at most) and the output written once; on a chain, one dependent
// device read a level.  Design: a level-synchronous push BFS in one
// cooperative launch, one block of 1,024 threads an SM (132 blocks meet at
// a grid barrier, written by hand: one arrival word whose top bit flips
// when the last block arrives, as cooperative groups' grid barrier does,
// without -rdc).  In scratch the caller allocates: the visited bitmap and
// two frontier bitmaps (cap bits each), a small stash a block, a head.
// - A grid level takes the frontier from its bitmap: each warp owns every
//   warps-th word (32 rows each; neighbouring words on other SMs), reads
//   and clears them, and expands each word's rows together: the rows'
//   spans (at most 18 aligned 16-byte chunks for r = 65) laid end to end
//   over the warp's lanes, kUnroll chunks a lane a round, the next round's
//   loads started before this round's ids are probed.  Dense levels read
//   runs of neighbouring rows.
// - A new id is probed in the block's copy of the visited bitmap in shared
//   memory when the bitmap fits (PGVS_REACH_SMEM_BITMAP_MAX bytes: 1.79M
//   rows), else in L2; only a bit clear there goes to the global atomicOr,
//   whose old word decides the claim and refreshes the copy.  The copy is
//   refreshed from L2 after the barrier when the level's slots outweigh it
//   (n * r * PGVS_REACH_REFRESH >= words * blocks): a stale copy only lets
//   more candidates through to the atomic.  A lane's probes, and then its
//   atomics, are issued together, so their round trips overlap.
// - A claimed id sets its bit in the next frontier bitmap (an atomicOr
//   without a return) and counts in a register; a block adds its count to
//   the level's count word once (no hot counter) and keeps its first kSmall
//   claims in its stash, its warps' places taken with one shared atomic a
//   warp.
// - A frontier of at most kSmall rows (two a warp) is expanded by block 0
//   alone, from a queue in shared memory gathered from the stashes, with an
//   exact bitmap copy (it is the only writer; it claims there and writes the
//   copy back when the run ends), level after level under __syncthreads; of
//   at most kWarpRows rows by warp 0 alone under __syncwarp (a chain level
//   is then one device read and shared-memory work, with no global write).
//   A claim past the queue's room sets its frontier bit, and the queue's
//   rows set theirs when the run ends, so the grid takes the bitmap as it
//   is when the frontier grows past kSmall.
// - The count words rotate through three, indexed by the phase (each grid
//   level is one phase, and so is each run of one-block levels), not by the
//   level: a block released from a barrier may read the phase's word late,
//   so until the next barrier nobody writes it.  In grid phase P block 0
//   zeroes word P + 2 while the blocks add to word P + 1; in one-block
//   phase P block 0 writes its last frontier's count to word P + 1, zeroes
//   word P + 2 and writes its level to a head word that the blocks read
//   after the barrier.  A stash is read only in the phase after the one
//   that wrote it, and rewritten only in the grid level after that.
//
// Plain C interface for ctypes: raw pointers, sizes and the caller's
// stream.  The function launches, allocates nothing, does not synchronise,
// and returns the launch's error.  Built with -DPGVS_REACH_THREADS=N it runs
// N threads a block (the CPU emulation runs 64); -DPGVS_REACH_STAMPS=1 and
// -DPGVS_REACH_COUNTS=1 fill a debug buffer (block 0's clock at each level's
// steps; per-level counters) that pgvs_reachable_debug reads
// (microbench/reach_ab.py).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef PGVS_REACH_THREADS
#define PGVS_REACH_THREADS 1024
#endif
#ifndef PGVS_REACH_SMEM_BITMAP_MAX
#define PGVS_REACH_SMEM_BITMAP_MAX 224256
#endif
#ifndef PGVS_REACH_REFRESH
#define PGVS_REACH_REFRESH 8
#endif

namespace {

constexpr int kThreads = PGVS_REACH_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kSmall = 2 * kWarps;  // a frontier block 0 expands alone
constexpr int kWarpRows = 2;        // a frontier warp 0 expands alone
constexpr int kMaxBlocks = 1024;
constexpr int kUnroll = 2;  // 16-byte loads a lane starts before it probes (4: spills)
constexpr unsigned kFull = 0xffffffffu;

// The head of the scratch, 32-bit words the caller zeroes, then the bitmaps.
enum : int {
  kBarrier = 0,      // arrivals at the grid barrier
  kCounts = 1,       // three rotating frontier counts
  kLevel = 4,        // the level after block 0's one-block levels
  kGridLevels = 5,   // levels expanded by the grid
  kBlockLevels = 6,  // levels expanded by block 0 alone (one-warp ones too)
  kWarpLevels = 7,   // levels expanded by warp 0 alone
  kHeadWords = 8,
};

// The debug buffer: the stamps taken, kMaxStamps stamps (tag << 56 | level
// << 32 | n, clock64, %globaltimer), then kDebugLevels levels of 4 counters
// (bitmap atomics with a return, claims, count-word atomics, rows expanded).
constexpr int kMaxStamps = 4096, kDebugLevels = 1100;
enum : unsigned {
  kStampEntry = 0, kStampArrive = 1, kStampRelease = 2, kStampPhase = 3, kStampBlockLevel = 4,
  kStampWarpLevel = 5, kStampOutput = 6, kStampCopied = 7, kStampGathered = 8,
};

}  // namespace

#if PGVS_REACH_STAMPS || PGVS_REACH_COUNTS
__device__ unsigned long long g_reach_debug[1 + 3 * kMaxStamps + 4 * kDebugLevels];
#endif

namespace {

#if PGVS_REACH_STAMPS
__device__ __forceinline__ unsigned long long global_ns() {
#ifdef PGVS_CUDA_EMU
  return emu_globaltimer();
#else
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
#endif
}
// Block 0's thread 0 records (tag, level, n) and the time.
__device__ __forceinline__ void stamp(unsigned tag, int level, unsigned n) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  const unsigned long long i = g_reach_debug[0]++;
  if (i >= kMaxStamps) return;
  g_reach_debug[1 + 3 * i] = (static_cast<unsigned long long>(tag) << 56) |
                             (static_cast<unsigned long long>(level & 0xffffff) << 32) | n;
  g_reach_debug[2 + 3 * i] = clock64();
  g_reach_debug[3 + 3 * i] = global_ns();
}
#else
__device__ __forceinline__ void stamp(unsigned, int, unsigned) {}
#endif

// A thread's counts of one level, added to the debug buffer by each warp.
struct Tally {
#if PGVS_REACH_COUNTS
  unsigned c[4] = {0, 0, 0, 0};
  __device__ void add(int k, unsigned n = 1) { c[k] += n; }
  __device__ void flush(int level) {
    const int lv = level < kDebugLevels - 1 ? level : kDebugLevels - 1;
    for (int k = 0; k < 4; ++k) {
      const unsigned s = __reduce_add_sync(kFull, c[k]);
      if ((threadIdx.x & 31) == 0 && s)
        atomicAdd(&g_reach_debug[1 + 3 * kMaxStamps + 4 * lv + k],
                  static_cast<unsigned long long>(s));
      c[k] = 0;
    }
  }
#else
  __device__ void add(int, unsigned = 1) {}
  __device__ void flush(int) {}
#endif
};

struct Params {
  const int4* adj4;  // the adjacency's 16-byte-aligned base
  uint8_t* out;
  unsigned* head;     // kHeadWords words, then the bitmaps
  unsigned* visited;  // words = ceil(cap / 32) words each
  unsigned* front0;   // the frontier of even levels
  unsigned* front1;   // of odd levels
  int* stash_n;       // a block's claims kept (kMaxBlocks)
  int* stash;         // its first kSmall claims (kMaxBlocks x kSmall)
  int adj_off;        // ints from adj4 to adjacency[0][0]
  int cap, r, count, start, words;
  int smem_bitmap;  // blocks keep a copy of the visited bitmap in shared memory
};

// The block's shared memory: this, then (smem_bitmap) the bitmap's copy.
struct Shared {
  unsigned n_next;   // a one-block level's claims
  unsigned stash_n;  // a grid level's claims kept in the stash
  unsigned fresh;    // a grid level's claims
  int n, level, cur;  // warp 0's hand-back
  int queue[2][kSmall];
  int rows[kWarps][32];  // a grid word's rows, a warp each
};
constexpr int kSharedBytes = (static_cast<int>(sizeof(Shared)) + 15) / 16 * 16;
// The most a launch asks for: the largest bitmap copy too.
constexpr int kMaxSharedBytes = kSharedBytes + (PGVS_REACH_SMEM_BITMAP_MAX + 15) / 16 * 16;

__device__ __forceinline__ unsigned load_volatile(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

// The frontier bitmap of `level`: a select, not an index into the
// parameters (which would copy them to local memory).
__device__ __forceinline__ unsigned* front(const Params& p, int level) {
  return (level & 1) ? p.front1 : p.front0;
}

// Every block of the grid waits here for the others: each block's thread 0
// adds 1 to the arrival word (block 0 adds 2^31 - (blocks - 1)), so the
// word's top bit flips once all have arrived and its low bits are as before.
__device__ void grid_barrier(unsigned* arrived) {
  __syncthreads();
  if (threadIdx.x == 0) {
    stamp(kStampArrive, 0, 0);
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(arrived, add);
    while (((old ^ load_volatile(arrived)) & 0x80000000u) == 0) __nanosleep(32);
    __threadfence();
    stamp(kStampRelease, 0, 0);
  }
  __syncthreads();
}

// The block's threads copy the visited bitmap into shared memory.
__device__ void copy_bitmap(const Params& p, unsigned* copy) {
  const int n4 = p.words >> 2;
  const uint4* src = reinterpret_cast<const uint4*>(p.visited);
  uint4* dst = reinterpret_cast<uint4*>(copy);
  for (int i = threadIdx.x; i < n4; i += kThreads) dst[i] = __ldcg(src + i);
  for (int w = 4 * n4 + threadIdx.x; w < p.words; w += kThreads) copy[w] = __ldcg(p.visited + w);
  __syncthreads();
}

// Component c of v.
__device__ __forceinline__ int lane_id(const int4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// An exclusive prefix of x over the warp's lanes; *total: their sum.
__device__ __forceinline__ unsigned warp_prefix(unsigned x, unsigned* total) {
  const int lane = threadIdx.x & 31;
  unsigned s = x;
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, s, d);
    if (lane >= d) s += y;
  }
  *total = __shfl_sync(kFull, s, 31);
  return s - x;
}

// Round t0's kU chunks of a thread of a group: chunks t0, t0 + stride, ...
// of the n rows of `list`, their spans of 16-byte chunks ((r + 6) / 4 of
// them at most) laid end to end; j0: the slot of each chunk's first id
// (past the spans' end: no chunk, ids -1).
template <int kU>
__device__ __forceinline__ void load_chunks(const Params& p, const int* list, int per,
                                            float inv_per, int total, int t0, int stride,
                                            int4 (&v)[kU], int (&j0)[kU]) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int t = t0 + u * stride;
    v[u] = make_int4(-1, -1, -1, -1);
    j0[u] = 0;
    if (t < total) {
      // t / per without a division: t + 0.5 lies at least 0.5 from a
      // multiple of per, beyond the float product's error while t < 2^22
      // (t < 64 * per: any r below 262,000).
      const int k = static_cast<int>((static_cast<float>(t) + 0.5f) * inv_per);
      const long long g = static_cast<long long>(list[k]) * p.r + p.adj_off;
      const long long i4 = (g >> 2) + (t - k * per);
      if (i4 < ((g + p.r + 3) >> 2)) {
        v[u] = __ldg(p.adj4 + i4);
        j0[u] = static_cast<int>(i4 * 4 - g);
      }
    }
  }
}

// The claims of one round's chunks, every thread of the group in step (the
// warp-wide votes and scans need all 32 lanes):
// 1. the candidates: slots of the row, ids below count, bits clear in the
//    copy (the shared-memory loads together);
// 2. without the copy, their bits probed in L2 (the loads together);
// 3. the claims, atomicOr issued together before any old word is read, 8
//    ids at a time (their old words fit in registers): in kAlone runs
//    (block 0 or warp 0 alone) in its exact copy when it has one (written
//    back when the run ends), else in the global bitmap, whose old word
//    then refreshes the copy (a copy missing bits is only stale, so a
//    store racing another warp's is harmless);
// 4. their places, one shared atomic a warp: kAlone onto `queue_next`
//    while it has room (past it, the claim sets its frontier bit), else
//    into the block's stash while it has room, the frontier bit set and
//    counted in `fresh`.
template <bool kAlone, int kU>
__device__ __forceinline__ void claim_chunks(const Params& p, Shared* sh, unsigned* copy,
                                             const int4 (&v)[kU], const int (&j0)[kU],
                                             unsigned* next, int* queue_next, unsigned& fresh,
                                             Tally& tally) {
  unsigned cand = 0;
#pragma unroll
  for (int i = 0; i < 4 * kU; ++i) {
    const int id = lane_id(v[i >> 2], i & 3);
    const int j = j0[i >> 2] + (i & 3);
    if (j < 0 || j >= p.r || static_cast<unsigned>(id) >= static_cast<unsigned>(p.count))
      continue;
    if (p.smem_bitmap && ((copy[id >> 5] >> (id & 31)) & 1u)) continue;
    cand |= 1u << i;
  }
  if (!__any_sync(kFull, cand)) return;
  constexpr int kGroup = kU % 2 == 0 ? 2 : 1;
  unsigned mine = 0;
#pragma unroll
  for (int g0 = 0; g0 < 4 * kU; g0 += 4 * kGroup) {
    unsigned m = (cand >> g0) & ((1u << (4 * kGroup)) - 1u);
    unsigned got[4 * kGroup];
    if (!p.smem_bitmap) {
#pragma unroll
      for (int i = 0; i < 4 * kGroup; ++i) {
        const int id = lane_id(v[(g0 + i) >> 2], i & 3);
        got[i] = (m >> i) & 1u ? __ldcg(p.visited + (id >> 5)) : 0u;
      }
#pragma unroll
      for (int i = 0; i < 4 * kGroup; ++i)
        if ((got[i] >> (lane_id(v[(g0 + i) >> 2], i & 3) & 31)) & 1u) m &= ~(1u << i);
    }
    if (kAlone && p.smem_bitmap) {
#pragma unroll
      for (int i = 0; i < 4 * kGroup; ++i) {
        const int id = lane_id(v[(g0 + i) >> 2], i & 3);
        got[i] = (m >> i) & 1u ? atomicOr(copy + (id >> 5), 1u << (id & 31)) : ~0u;
      }
    } else {
      tally.add(0, __popc(m));
#pragma unroll
      for (int i = 0; i < 4 * kGroup; ++i) {
        const int id = lane_id(v[(g0 + i) >> 2], i & 3);
        got[i] = (m >> i) & 1u ? atomicOr(p.visited + (id >> 5), 1u << (id & 31)) : ~0u;
      }
    }
#pragma unroll
    for (int i = 0; i < 4 * kGroup; ++i) {
      const int id = lane_id(v[(g0 + i) >> 2], i & 3);
      const unsigned bit = 1u << (id & 31);
      if (!kAlone && p.smem_bitmap && ((m >> i) & 1u)) copy[id >> 5] = got[i] | bit;
      if (!(got[i] & bit)) mine |= 1u << (g0 + i);
    }
  }
  if (!__any_sync(kFull, mine)) return;
  const unsigned claims = __popc(mine);
  tally.add(1, claims);
  if (!kAlone) fresh += claims;
  unsigned* counter = kAlone ? &sh->n_next : &sh->stash_n;
  const bool room =
      kAlone || __shfl_sync(kFull, load_volatile(counter), 0) < static_cast<unsigned>(kSmall);
  unsigned pos = 0, sum = 0;
  if (room) {
    pos = warp_prefix(claims, &sum);
    unsigned at = 0;
    if ((threadIdx.x & 31) == 31 && sum) at = atomicAdd(counter, sum);
    pos += __shfl_sync(kFull, at, 31);
  }
#pragma unroll
  for (int i = 0; i < 4 * kU; ++i) {
    if (!((mine >> i) & 1u)) continue;
    const int id = lane_id(v[i >> 2], i & 3);
    const bool kept = room && pos < static_cast<unsigned>(kSmall);
    if (kept && kAlone) queue_next[pos] = id;
    if (kept && !kAlone) p.stash[blockIdx.x * kSmall + pos] = id;
    if (!kAlone || !kept) atomicOr(next + (id >> 5), 1u << (id & 31));
    ++pos;
  }
}

// Threads first, first + stride, ... of a group (a warp, or block 0) expand
// the n rows of `list`, a round of kU chunks a thread at a time, the next
// round's loads started before this round's claims.
template <bool kAlone, int kU>
__device__ void expand_rows(const Params& p, Shared* sh, unsigned* copy, const int* list, int n,
                            int first, int stride, unsigned* next, int* queue_next,
                            unsigned& fresh, Tally& tally) {
  const int per = (p.r + 6) >> 2;
  const int total = n * per;
  const float inv_per = 1.0f / static_cast<float>(per);
  const int step = stride * kU;
  int4 v[kU];
  int j0[kU];
  load_chunks<kU>(p, list, per, inv_per, total, first, stride, v, j0);
  for (int base = 0; base < total; base += step) {
    int4 vn[kU];
    int jn[kU];
    load_chunks<kU>(p, list, per, inv_per, total, base + step + first, stride, vn, jn);
    claim_chunks<kAlone, kU>(p, sh, copy, v, j0, next, queue_next, fresh, tally);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      v[u] = vn[u];
      j0[u] = jn[u];
    }
  }
}

// One grid level in phase `phase`: every warp expands the rows of its words
// of the frontier bitmap, clearing them.  Leaves the next level's count
// (added block by block) and each block's stash for the next phase.
__device__ void grid_level(const Params& p, Shared* sh, unsigned* copy, unsigned phase, int level,
                           unsigned n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned* counts = p.head + kCounts;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    counts[(phase + 2) % 3] = 0;
    p.head[kGridLevels] += 1;
  }
  if (p.smem_bitmap && static_cast<long long>(n) * p.r * PGVS_REACH_REFRESH >=
                           static_cast<long long>(p.words) * gridDim.x) {
    copy_bitmap(p, copy);
    stamp(kStampCopied, level, n);
  }
  unsigned* cur = front(p, level);
  unsigned* next = front(p, level + 1);
  // Warp k of block b owns the words b + blocks * (k + kWarps * i): a
  // table of fewer words than warps still spreads over every SM.
  const long long blocks = gridDim.x;
  const long long warps = blocks * kWarps;
  unsigned fresh = 0;
  Tally tally;
  for (long long base = blockIdx.x + blocks * warp; base < p.words; base += 32 * warps) {
    const long long w = base + lane * warps;
    unsigned m = 0;
    if (w < p.words) {
      m = __ldcg(cur + w);
      if (m) cur[w] = 0;
    }
    for (unsigned any = __ballot_sync(kFull, m != 0); any; any &= any - 1) {
      const int src = __ffs(any) - 1;
      const unsigned mask = __shfl_sync(kFull, m, src);
      const int row0 = static_cast<int>((base + src * warps) * 32);
      if ((mask >> lane) & 1u) sh->rows[warp][__popc(mask & ((1u << lane) - 1u))] = row0 + lane;
      __syncwarp();
      tally.add(3, lane == 0 ? __popc(mask) : 0);
      expand_rows<false, kUnroll>(p, sh, copy, sh->rows[warp], __popc(mask), lane, 32, next,
                                  nullptr, fresh, tally);
      __syncwarp();  // every lane has read rows[warp] before it is rewritten
    }
  }
  fresh = __reduce_add_sync(kFull, fresh);
  if (lane == 0 && fresh) atomicAdd(&sh->fresh, fresh);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (sh->fresh) {
      atomicAdd(counts + (phase + 1) % 3, sh->fresh);
      tally.add(2);
    }
    p.stash_n[blockIdx.x] = sh->stash_n < static_cast<unsigned>(kSmall)
                                ? static_cast<int>(sh->stash_n) : kSmall;
    sh->fresh = 0;
    sh->stash_n = 0;
  }
  tally.flush(level);
}

// Warp 0 alone while the frontier has 1..kWarpRows rows: levels under
// __syncwarp; leaves the frontier's count, level and queue in sh.
__device__ void warp_levels(const Params& p, Shared* sh, unsigned* copy, int level, int n,
                            int cur, int& levels) {
  const int lane = threadIdx.x & 31;
  unsigned fresh = 0;
  Tally tally;
  while (n >= 1 && n <= kWarpRows) {
    if (lane == 0) sh->n_next = 0;
    __syncwarp();
    tally.add(3, lane == 0 ? n : 0);
    expand_rows<true, 1>(p, sh, copy, sh->queue[cur], n, lane, 32, front(p, level + 1),
                         sh->queue[cur ^ 1], fresh, tally);
    __syncwarp();
    tally.flush(level);
    n = static_cast<int>(sh->n_next);
    cur ^= 1;
    ++level;
    ++levels;
    stamp(kStampWarpLevel, level, n);
    __syncwarp();  // every lane has read n_next before it is zeroed again
  }
  if (lane == 0) {
    sh->n = n;
    sh->level = level;
    sh->cur = cur;
  }
}

// Block 0 alone, in phase `phase` from level `level` with `n` (<= kSmall)
// rows in the blocks' stashes (at level 0, the start): gathers them into
// its queue, then expands levels until the frontier is empty or grows past
// kSmall, and leaves the state for the grid's next phase (the level, its
// count, the count after it 0).  It leaves the phase's own count word
// alone: the other blocks may not have read it yet.
__device__ void block_run(const Params& p, Shared* sh, unsigned* copy, unsigned phase, int level,
                          int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (level == 0) {
    // The first run: the start alone, already in block 0's copy.
    if (threadIdx.x == 0) sh->queue[0][0] = p.start;
  } else if (warp == 0) {
    unsigned at = 0;
    for (int b0 = 0; b0 < static_cast<int>(gridDim.x); b0 += 32) {
      const int b = b0 + lane;
      const int c = b < static_cast<int>(gridDim.x) ? __ldcg(p.stash_n + b) : 0;
      unsigned sum = 0;
      const unsigned off = at + warp_prefix(c, &sum);
      for (int i = 0; i < c; ++i) {
        const int v = __ldcg(p.stash + b * kSmall + i);
        sh->queue[0][off + i] = v;
        front(p, level)[v >> 5] = 0;  // the level's frontier bits are these ids'
      }
      at += sum;
    }
  }
  if (p.smem_bitmap && level > 0) copy_bitmap(p, copy);
  __syncthreads();
  stamp(kStampGathered, level, n);
  int cur = 0, levels = 0, warp_run = 0;
  unsigned fresh = 0;
  Tally tally;
  while (n >= 1 && n <= kSmall) {
    if (n <= kWarpRows) {
      if (warp == 0) warp_levels(p, sh, copy, level, n, cur, warp_run);
      __syncthreads();
      n = sh->n;
      level = sh->level;
      cur = sh->cur;
      __syncthreads();  // every thread has read the hand-back before it is rewritten
      continue;
    }
    if (threadIdx.x == 0) sh->n_next = 0;
    __syncthreads();
    tally.add(3, threadIdx.x == 0 ? n : 0);
    expand_rows<true, 2>(p, sh, copy, sh->queue[cur], n, threadIdx.x, kThreads,
                         front(p, level + 1), sh->queue[cur ^ 1], fresh, tally);
    __syncthreads();
    tally.flush(level);
    n = static_cast<int>(sh->n_next);
    cur ^= 1;
    ++level;
    ++levels;
    stamp(kStampBlockLevel, level, n);
    __syncthreads();  // every thread has read n_next before it is zeroed again
  }
  // The queue's rows join the frontier bitmap that the grid takes next
  // (the claims past it set their bits when made), and the global bitmap
  // takes block 0's claims.
  if (n > kSmall && threadIdx.x < kSmall) {
    const int v = sh->queue[cur][threadIdx.x];
    atomicOr(front(p, level) + (v >> 5), 1u << (v & 31));
  }
  if (p.smem_bitmap)
    for (int w = threadIdx.x; w < p.words; w += kThreads) p.visited[w] = copy[w];
  if (threadIdx.x == 0) {
    unsigned* counts = p.head + kCounts;
    counts[(phase + 1) % 3] = static_cast<unsigned>(n);
    counts[(phase + 2) % 3] = 0;
    p.head[kLevel] = static_cast<unsigned>(level);
    p.head[kBlockLevels] += static_cast<unsigned>(levels + warp_run);
    p.head[kWarpLevels] += static_cast<unsigned>(warp_run);
  }
}

__global__ void __launch_bounds__(kThreads, 1) reachable_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared* sh = reinterpret_cast<Shared*>(smem);
  unsigned* copy = reinterpret_cast<unsigned*>(smem + kSharedBytes);
  unsigned* counts = p.head + kCounts;
  stamp(kStampEntry, 0, 0);
  if (p.smem_bitmap) {
    for (int w = threadIdx.x; w < p.words; w += kThreads) copy[w] = 0;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    sh->fresh = 0;
    sh->stash_n = 0;
    if (blockIdx.x == 0 && p.start >= 0 && p.start < p.count) {
      p.visited[p.start >> 5] = 1u << (p.start & 31);
      if (p.smem_bitmap) copy[p.start >> 5] = 1u << (p.start & 31);
      counts[0] = 1;
    }
  }
  grid_barrier(p.head + kBarrier);

  int level = 0;
  for (unsigned phase = 0;; ++phase) {
    const unsigned n = load_volatile(counts + phase % 3);
    stamp(kStampPhase, static_cast<int>(phase), n);
    if (n == 0) break;
    if (n <= static_cast<unsigned>(kSmall)) {
      if (blockIdx.x == 0) block_run(p, sh, copy, phase, level, static_cast<int>(n));
      grid_barrier(p.head + kBarrier);
      level = static_cast<int>(load_volatile(p.head + kLevel));
      continue;
    }
    grid_level(p, sh, copy, phase, level, n);
    grid_barrier(p.head + kBarrier);
    ++level;
  }

  // The output: a thread a bitmap word, 32 bytes of 0 or 1 in two 16-byte
  // stores (a byte at a time at the table's end).
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long w = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; w < p.words;
       w += stride) {
    const unsigned bits = __ldcg(p.visited + w);
    const long long v0 = w * 32;
    if (v0 + 32 <= p.cap) {
      unsigned b[8];
      for (int k = 0; k < 8; ++k) b[k] = (((bits >> (4 * k)) & 15u) * 0x00204081u) & 0x01010101u;
      uint4* o = reinterpret_cast<uint4*>(p.out + v0);
      o[0] = make_uint4(b[0], b[1], b[2], b[3]);
      o[1] = make_uint4(b[4], b[5], b[6], b[7]);
    } else {
      for (long long v = v0; v < p.cap; ++v) p.out[v] = (bits >> (v - v0)) & 1u;
    }
  }
  stamp(kStampOutput, 0, 0);
}

// The shared memory a launch over `words` bitmap words asks for.
int shared_bytes(int words, bool smem_bitmap) {
  return kSharedBytes + (smem_bitmap ? (words + 3) / 4 * 16 : 0);
}

// The grid a launch of `max_blocks` blocks (0: as many as the card holds
// at once) asking for `smem` bytes runs: every block must be resident for
// the grid barrier.  The kernel's ceiling is always kMaxSharedBytes, so a
// launch on another thread never lowers it under this one.
cudaError_t grid_blocks(int max_blocks, int device, int smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(reachable_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSharedBytes);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, reachable_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  if (*blocks > kMaxBlocks) *blocks = kMaxBlocks;
  if (max_blocks > 0 && max_blocks < *blocks) *blocks = max_blocks;
  return *blocks > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace

// 32-bit words of scratch the caller zeroes: the head and the three bitmaps.
extern "C" long long pgvs_reachable_zeroed_words(int cap) {
  return kHeadWords + 3 * ((static_cast<long long>(cap) + 31) / 32);
}

// The largest table whose visited bitmap the blocks copy into shared
// memory (8 rows a byte); above it they probe the bitmap in L2.
extern "C" long long pgvs_reachable_smem_bitmap_max_rows() {
  return 8LL * PGVS_REACH_SMEM_BITMAP_MAX;
}

// 32-bit words of the stash the caller allocates (not zeroed).
extern "C" long long pgvs_reachable_stash_words() {
  return static_cast<long long>(kMaxBlocks) * (kSmall + 1);
}

// out: uint8[cap]; zeroed: pgvs_reachable_zeroed_words(cap) words, all 0;
// stash: pgvs_reachable_stash_words() int32.  head[kGridLevels],
// head[kBlockLevels] and head[kWarpLevels] count the levels each way after
// the run.
extern "C" int pgvs_reachable(const void* adj, void* out, void* zeroed, void* stash, int cap,
                              int r, int count, int start, int max_blocks, int device,
                              void* stream) {
  if (cap <= 0) return static_cast<int>(cudaSuccess);
  if (r < 0 || count < 0 || count > cap) return static_cast<int>(cudaErrorInvalidValue);
  // This library carries its own CUDA runtime, whose current device is
  // separate from the caller's: point it at the device of the tensors.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.words = (cap + 31) / 32;
  p.smem_bitmap = static_cast<long long>(p.words) * 4 <= PGVS_REACH_SMEM_BITMAP_MAX;
  const int smem = shared_bytes(p.words, p.smem_bitmap);
  int blocks = 0;
  err = grid_blocks(max_blocks, device, smem, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t a = reinterpret_cast<uintptr_t>(adj);
  p.adj4 = reinterpret_cast<const int4*>(a & ~static_cast<uintptr_t>(15));
  p.adj_off = static_cast<int>((a & 15) / 4);
  p.out = static_cast<uint8_t*>(out);
  p.head = static_cast<unsigned*>(zeroed);
  p.visited = p.head + kHeadWords;
  p.front0 = p.visited + p.words;
  p.front1 = p.front0 + p.words;
  p.stash_n = static_cast<int*>(stash);
  p.stash = p.stash_n + kMaxBlocks;
  p.cap = cap;
  p.r = r;
  p.count = count;
  p.start = start;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reachable_kernel, dim3(blocks), dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

#if PGVS_REACH_STAMPS || PGVS_REACH_COUNTS
// Copies the debug buffer to the host's `out` and zeroes it.
extern "C" int pgvs_reachable_debug(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, g_reach_debug, sizeof(g_reach_debug));
  void* d = nullptr;
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&d, g_reach_debug);
  if (err == cudaSuccess) err = cudaMemset(d, 0, sizeof(g_reach_debug));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}
#endif
