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
// (the finite ones, ascending), then slot 0, then its other +inf slots, and
// each entry's place in the merge is its place there plus the entries of
// the other side that precede it (a frontier entry before a candidate of
// equal distance).  That holds whatever ids the +inf entries carry.
//
// Bound on an H100: the chain.  Every step waits on the adjacency row of
// the node it expands, then on the visited flags and code (or vector) rows
// of its neighbours, and the next step's node is known only after the
// merge; phase 14's 1M-row table does not stay in the 50 MB L2, so each
// step is about two device-memory latencies.  Design: the whole loop in one
// block of 256 threads, with the frontier, the window and the query's
// prefix in shared memory (the state in a scratch buffer of device memory
// when it does not fit: a search list of thousands), and `visited` /
// `vdist` in the wrapper's copies in device memory; a step is a handful of
// block barriers, its neighbours read a slot a thread in rounds of the block
// and scored in parallel (a group of lanes a code row, a warp a vector row),
// the window shifted through registers 4,096 entries a round (one round
// overlapped with the adjacency row's read), the merge by binary searches
// instead of a sort.
//
// Plain C interface for ctypes: raw pointers, sizes and the caller's
// stream.  The function launches, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hamming.cuh"
#include "rowdist.cuh"

namespace {

#ifndef PGVS_ITER_THREADS
#define PGVS_ITER_THREADS 256
#endif
constexpr int kThreads = PGVS_ITER_THREADS;
constexpr int kWarps = kThreads / 32;
// The window entries the block shifts in one round of an insert (the
// iterator grows emit_n to 4,096: one round), a thread's share of them.
constexpr int kWinRound = 4096;
constexpr int kWinPer = kWinRound / kThreads;

enum Kind { kCodes = 0, kFull = 1 };

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
};

// The state: words of 4 bytes, in this order (after the query's prefix in
// shared memory, or in the scratch buffer).
__host__ __device__ inline long long state_bytes(int f, int emit_n, int r) {
  return (4LL * f + 2LL * emit_n + 6LL * r + kWarps + 4) * 4;
}

// Window entries [j0, j0 + kWinRound) of positions j > at (and below en)
// into registers: the entries they take in the insert, win[j - 1].
__device__ __forceinline__ void window_load(const float* win_d, const int* win_id, int j0, int en,
                                            float (&wd)[kWinPer], int (&wi)[kWinPer]) {
#pragma unroll
  for (int k = 0; k < kWinPer; ++k) {
    const int j = j0 + threadIdx.x + k * kThreads;
    if (j < en) {
      wd[k] = win_d[j - 1];
      wi[k] = win_id[j - 1];
    }
  }
}
__device__ __forceinline__ void window_store(float* win_d, int* win_id, int j0, int en,
                                             const float (&wd)[kWinPer], const int (&wi)[kWinPer]) {
#pragma unroll
  for (int k = 0; k < kWinPer; ++k) {
    const int j = j0 + threadIdx.x + k * kThreads;
    if (j < en) {
      win_d[j] = wd[k];
      win_id[j] = wi[k];
    }
  }
}

// Entries of a[0, n) (ascending) below x / at most x.
__device__ __forceinline__ int count_below(const float* a, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}
__device__ __forceinline__ int count_at_most(const float* a, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The frontier's stable order after slot 0 left it: slots 1..m, then
// slot 0 (+inf), then slots m+1.. (all +inf).
__device__ __forceinline__ int stable_slot(int i, int m) { return i < m ? i + 1 : (i == m ? 0 : i); }

// S: the state in the scratch buffer.  A template parameter, not a test of
// p.scratch, so that with S false every state access is a shared-memory
// one: through a pointer the compiler cannot place, each is a generic
// access, which made a stream refill about 8% slower on an H100.
template <int KIND, int A, int B, bool S>
__global__ void __launch_bounds__(kThreads, 1) iter_step_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int f = p.f, en = p.emit_n, r = p.r;
  float* qs = reinterpret_cast<float*>(smem);  // the query's prefix (kFull, B: in shared)
  const bool q_in_smem = KIND == kFull && B;
  float* fr_d = reinterpret_cast<float*>(
      S ? p.scratch : smem + (q_in_smem ? pgvs::query_smem_bytes(p.dt) : 0));
  int* fr_id = reinterpret_cast<int*>(fr_d + f);
  float* nx_d = reinterpret_cast<float*>(fr_id + f);  // the merge's output
  int* nx_id = reinterpret_cast<int*>(nx_d + f);
  float* win_d = reinterpret_cast<float*>(nx_id + f);
  int* win_id = reinterpret_cast<int*>(win_d + en);
  int* nbs = win_id + en;                            // [R] neighbour ids
  int* in_fr = nbs + r;                              // [R] 1: in the frontier
  int* kept = in_fr + r;                             // [nf] survivors' ids, slot order
  float* kd = reinterpret_cast<float*>(kept + r);    // [nf] their distances
  float* cs_d = kd + r;                              // [nf] ascending by (distance, slot)
  int* cs_id = reinterpret_cast<int*>(cs_d + r);     // [nf]
  int* wtot = cs_id + r;                             // [kWarps]

  if constexpr (KIND == kFull && B) {
    for (int j = tid; j < p.dt; j += kThreads) qs[j] = p.qvec[j];
  }
  for (int j = tid; j < f; j += kThreads) {
    fr_d[j] = p.fr_d_in[j];
    fr_id[j] = p.fr_ids_in[j];
  }
  for (int j = tid; j < en; j += kThreads) {
    win_d[j] = p.win_d_in[j];
    win_id[j] = p.win_ids_in[j];
  }
  int nv = *p.n_visits_in, nc = *p.n_comps_in, steps = 0;
  __syncthreads();

  // Lanes a neighbour is scored by, and the groups of them.
  const int log2g = KIND == kCodes ? p.log2g : 5;
  const int g = 1 << log2g, lane_in_group = tid & (g - 1), group = tid >> log2g;
  const int n_groups = kThreads >> log2g;

  while (steps < p.budget && fr_d[0] < win_d[en - 1]) {
    // 1: expand slot 0 (finite, so a valid id).
    const float nd = fr_d[0];
    const int nid = fr_id[0];
    const long long row = nid < 0 ? 0 : nid;
    if (tid == 0) {
      p.visited[row] = 1;
      p.vdist[row] = fminf(p.vdist[row], nd);
    }
    ++steps;
    ++nv;
    // 2: the window's insert position, after every entry <= nd; positions
    // at+1.. take their left neighbour, in rounds of kWinRound from the top
    // (a round reads below the rounds above it write), the lowest round's
    // reads overlapped with the adjacency row's.
    const int at = count_at_most(win_d, en, nd);
    float wd[kWinPer];
    int wi[kWinPer];
    for (int c = (en - at - 2) / kWinRound; c >= 1; --c) {
      window_load(win_d, win_id, at + 1 + c * kWinRound, en, wd, wi);
      __syncthreads();
      window_store(win_d, win_id, at + 1 + c * kWinRound, en, wd, wi);
    }
    window_load(win_d, win_id, at + 1, en, wd, wi);
    // 4 (first half): the neighbours, valid (not INVALID, not visited) or
    // -1, a slot a thread.
    for (int i = tid; i < r; i += kThreads) {
      const int nbv = __ldg(p.adjacency + row * r + i);
      nbs[i] = nbv != -1 && nbv != nid && p.visited[nbv] == 0 ? nbv : -1;
      in_fr[i] = 0;
    }
    __syncthreads();
    // 2, 3: the window's lowest round shifts; slot 0 leaves the frontier.
    window_store(win_d, win_id, at + 1, en, wd, wi);
    if (tid == 0) {
      if (at < en) {
        win_d[at] = nd;
        win_id[at] = nid;
      }
      fr_d[0] = INFINITY;
      fr_id[0] = -1;
    }
    // 4: the frontier dedup, a frontier slot against every neighbour.
    for (int j = tid + 1; j < f; j += kThreads) {
      const int id = fr_id[j];
      if (id < 0) continue;
      for (int i = 0; i < r; ++i)
        if (nbs[i] == id) in_fr[i] = 1;
    }
    __syncthreads();
    // 4: the in-row dedup (an id's slots are all valid or all -1), then the
    // survivors in slot order, a round of the block at a time.
    int nf = 0;
    for (int b0 = 0; b0 < r; b0 += kThreads) {
      const int i = b0 + tid;
      const int id = i < r ? nbs[i] : -1;
      bool keep = id >= 0 && in_fr[i] == 0;
      if (keep) {
        for (int k = 0; k < i; ++k) keep &= nbs[k] != id;
      }
      int tot;
      const int idx = pgvs::block_prefix<kWarps>(keep, wtot, tot);
      if (keep) kept[nf + idx] = id;
      nf += tot;
    }
    __syncthreads();
    nc += nf;

    // 5: score the survivors.
    for (int b0 = 0; b0 < nf; b0 += n_groups) {
      const int c = b0 + group;
      if constexpr (KIND == kCodes) {
        unsigned pop = 0;
        if (c < nf) {
          const long long crow = min(max(kept[c], 0), p.cap - 1);
          pop = pgvs::lane_pop_xor<A, B>(p.codes + crow * p.w, p.qcode, p.chunks, lane_in_group,
                                         g);
        }
        pop = pgvs::group_sum(pop, g);
        if (c < nf && lane_in_group == 0) kd[c] = static_cast<float>(pop);
      } else {
        if (c < nf) {  // a warp a row: c is the same on every lane of it
          const long long vrow = min(max(kept[c], 0), p.cap - 1);
          const void* ptr = static_cast<const char*>(p.vectors) +
                            vrow * p.stride * pgvs::row_elem_bytes<A>();
          const float scale = A == pgvs::kRowI8 ? __ldg(p.scales + vrow) : 1.0f;
          const float d = pgvs::warp_row_distance<A, B != 0>(ptr, scale, B ? qs : p.qvec, p.dt,
                                                             p.vec != 0, p.metric, lane);
          if (lane == 0) kd[c] = d;
        }
      }
    }
    __syncthreads();

    // 6: the candidates by (distance, slot), then the merge.
    for (int c = tid; c < nf; c += kThreads) {
      const float dc = kd[c];
      int rank = 0;
      for (int k = 0; k < nf; ++k) {
        const float dk = kd[k];
        rank += (dk < dc) | ((dk == dc) & (k < c));
      }
      cs_d[rank] = dc;
      cs_id[rank] = kept[c];
    }
    // m: the finite entries of slots 1..f-1 (ascending, then +inf).
    int lo = 1, hi = f;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (fr_d[mid] < INFINITY) lo = mid + 1; else hi = mid;
    }
    const int m = lo - 1;
    __syncthreads();
    for (int i = tid; i < f; i += kThreads) {
      const int slot = stable_slot(i, m);
      const float d = fr_d[slot];
      const int rank = i + count_below(cs_d, nf, d);
      if (rank < f) {
        nx_d[rank] = d;
        nx_id[rank] = fr_id[slot];
      }
    }
    for (int c = tid; c < nf; c += kThreads) {
      const float d = cs_d[c];
      // frontier entries at most d, in the stable order: binary search
      int a = 0, b = f;
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (fr_d[stable_slot(mid, m)] <= d) a = mid + 1; else b = mid;
      }
      const int rank = c + a;
      if (rank < f) {
        nx_d[rank] = d;
        nx_id[rank] = cs_id[c];
      }
    }
    __syncthreads();
    for (int i = tid; i < f; i += kThreads) {
      fr_d[i] = nx_d[i];
      fr_id[i] = nx_id[i];
    }
    __syncthreads();
  }

  for (int j = tid; j < f; j += kThreads) {
    p.fr_d[j] = fr_d[j];
    p.fr_ids[j] = fr_id[j];
  }
  for (int j = tid; j < en; j += kThreads) {
    p.win_d[j] = win_d[j];
    p.win_ids[j] = win_id[j];
  }
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
  return state_bytes(f, emit_n, r);
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
  const bool qs = !use_codes && query_shared;
  const size_t smem = static_cast<size_t>((scratch ? 0 : state_bytes(f, emit_n, r)) +
                                          (qs ? pgvs::query_smem_bytes(dt) : 0));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_codes) {
    const pgvs::GroupShape shape = pgvs::group_shape(w, codes, query_code);
    p.chunks = w / shape.v;
    p.log2g = shape.log2g;
#define PGVS_LAUNCH(V, CPL) err = launch<kCodes, V, CPL>(p, smem, st)
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
