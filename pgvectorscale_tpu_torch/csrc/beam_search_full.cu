// The whole full-precision beam search, one launch per query batch, for
// sm_90a.
//
// Replaces the JAX package's `lax.while_loop` in `beam_search`
// (pgvectorscale_tpu/graph/search.py:580) with use_codes=False: the
// traversal of plain storage and of builds with build_distance="exact",
// whose scoring branch is `_candidate_distances` (:200-235) on the rows'
// indexed prefix.  The port ran it as a Python loop
// (graph/search.py `beam_search_plain`) of one host read and ~150 small
// launches an iteration.  Every piece of the loop's state is a query's own,
// and a query with no unvisited entry, or with its visit budget spent, is
// left unchanged by a further iteration, so each query runs its own loop
// in its own block, and the batch's iteration count is the largest of the
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
//     survives); the plain version's two dedup branches keep the same
//     survivors and differ in their order: slot order for E*R <= 192, id
//     order above;
//  8. score the survivors in full precision (rowdist.cuh), a warp a row;
//  9. rank them by (distance, slot or id), compared as a float and an
//     int, and merge them into the window (when kept) and the beam with
//     the plain version's bitonic network: [row | +inf pad | candidates
//     descending], strides n/2 .. 1, a swap only on a strict >.
// The start nodes' dedup, distances and stable sort happen here too.
//
// Bound on an H100: bytes, behind the chain of dependent iterations.  The
// least traffic is each distinct scored row's Dt elements, each distinct
// frontier row's R adjacency ids, the inputs and the outputs once; the
// 100k x 768 f32 table (307 MB) does not stay in the 50 MB L2, so an
// iteration waits on an adjacency read and then on row reads from device
// memory.  Design: one block of 256 threads per query (a batch of 1,024
// queries fills the 132 SMs several blocks deep, so one block's waits
// overlap the others' work); the query's prefix sits in shared memory
// while it fits (else it is read through the read-only cache); the beam,
// window, candidate rows and merge buffer live in shared memory (dynamic,
// above 48 KB after cudaFuncSetAttribute) or, for a state over the shared
// limit (a build wave's L=200 beam, a window of 1,500), in the query's
// slice of a scratch buffer, through the same code; each warp scores one
// survivor with 16-byte loads, two in flight a lane.
//
// Plain C interface for ctypes: raw pointers, sizes and the caller's
// stream.  The function launches, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rowdist.cuh"

namespace {

#ifndef PGVS_FULL_THREADS
#define PGVS_FULL_THREADS 256
#endif
constexpr int kThreads = PGVS_FULL_THREADS;
constexpr int kWarps = kThreads / 32;
// Blocks an SM must hold at once: 1,024 threads, which caps a thread at 64
// registers.
constexpr int kMinBlocks = 1024 / kThreads;
constexpr int kLabelSentinel = 0x7fffffff;
constexpr int kNarrowRow = 192;  // E*R <= 192: slot order, else id order

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
  unsigned char* scratch;  // [Q, state_bytes], or null: shared memory
  long long state_bytes;
  long long stride;        // D, elements a row
  int cap, dt, metric, vec, r, lm, s, lq, l, h, h_cap, track_hist, e, window_n,
      iter_bound;
};

__host__ __device__ inline int pow2_at_least(int x) {
  int n = 1;
  while (n < x) n <<= 1;
  return n;
}

// The query's state: arrays of 4-byte words, in this order.
struct Layout {
  int l, wn, er, e, nm;
  __host__ __device__ Layout(int l_, int window_n, int e_, int r) : l(l_), wn(window_n), e(e_) {
    er = e_ * r;
    nm = pow2_at_least(l_ + er);
    if (wn > 0 && pow2_at_least(wn + er) > nm) nm = pow2_at_least(wn + er);
  }
  __host__ __device__ long long words() const {
    return 2LL * l + 2LL * wn + 6LL * er + 2LL * nm + 2LL * e + kWarps + 4;
  }
  __host__ __device__ long long bytes() const { return ((words() * 4 + 15) / 16) * 16; }
};

// The plain version's merge network over n entries, in place.
__device__ __forceinline__ void bitonic_merge(float* md, int* mt, int n) {
  for (int stride = n >> 1; stride >= 1; stride >>= 1) {
    for (int pi = threadIdx.x; pi < (n >> 1); pi += kThreads) {
      const int lo = ((pi & ~(stride - 1)) << 1) | (pi & (stride - 1));
      const int hi = lo + stride;
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
}

// Merge the nf sorted candidates (cs_d ascending, cs_t their tags) into the
// sorted row (row_d, row_t) of width wl, keeping the best wl; pad_tag marks
// the +inf entries.
__device__ __forceinline__ void merge_row(float* row_d, int* row_t, int wl, const float* cs_d,
                                          const int* cs_t, int nf, int er, int pad_tag,
                                          float* md, int* mt) {
  const int n = pow2_at_least(wl + er);
  for (int j = threadIdx.x; j < n; j += kThreads) {
    if (j < wl) {
      md[j] = row_d[j];
      mt[j] = row_t[j];
    } else if (j >= n - nf) {
      md[j] = cs_d[n - 1 - j];
      mt[j] = cs_t[n - 1 - j];
    } else {
      md[j] = INFINITY;
      mt[j] = pad_tag;
    }
  }
  __syncthreads();
  bitonic_merge(md, mt, n);
  for (int j = threadIdx.x; j < wl; j += kThreads) {
    row_d[j] = md[j];
    row_t[j] = mt[j];
  }
  __syncthreads();
}

// One row's distance to the query, by the calling warp.
template <int DT, bool QS>
__device__ __forceinline__ float score_row(const Params& p, int id, const float* qrow, int lane) {
  const long long row = min(max(id, 0), p.cap - 1);
  const void* ptr = static_cast<const char*>(p.vectors) +
                    row * p.stride * pgvs::row_elem_bytes<DT>();
  const float scale = DT == pgvs::kRowI8 ? __ldg(p.scales + row) : 1.0f;
  return pgvs::warp_row_distance<DT, QS>(ptr, scale, qrow, p.dt, p.vec != 0, p.metric, lane);
}

template <int DT, bool QS>
__global__ void __launch_bounds__(kThreads, kMinBlocks) beam_search_full_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const Layout lay(p.l, p.window_n, p.e, p.r);
  const int l = p.l, wn = p.window_n, er = lay.er, e = p.e, r = p.r;
  // Shared memory: the query's prefix (QS), then the state (no scratch).
  float* qs = reinterpret_cast<float*>(smem);
  unsigned char* after_q = smem + (QS ? pgvs::query_smem_bytes(p.dt) : 0);
  unsigned char* base =
      p.scratch ? p.scratch + static_cast<long long>(q) * p.state_bytes : after_q;
  float* beam_d = reinterpret_cast<float*>(base);
  int* beam_t = reinterpret_cast<int*>(beam_d + l);  // 2 * id + visited; -2 = empty
  float* win_d = reinterpret_cast<float*>(beam_t + l);
  int* win_t = reinterpret_cast<int*>(win_d + wn);  // id; -1 = empty
  int* fid = win_t + wn;                            // [E*R] candidate id, or -1
  int* nb = fid + er;                               // [nf] the survivors' ids
  int* kept = nb + er;                              // [nf] the survivors' slots
  float* kd = reinterpret_cast<float*>(kept + er);  // [nf] their distances
  float* cs_d = kd + er;                            // [nf] sorted ascending
  int* cs_t = reinterpret_cast<int*>(cs_d + er);    // [nf] their ids
  float* md = reinterpret_cast<float*>(cs_t + er);  // merge buffer
  int* mt = reinterpret_cast<int*>(md + lay.nm);
  int* sel_pos = mt + lay.nm;  // [E]
  int* sel_id = sel_pos + e;   // [E]
  int* wtot = sel_id + e;      // [kWarps]
  int* misc = wtot + kWarps;   // [4]

  const float* qg = p.qvecs + static_cast<long long>(q) * p.dt;
  if constexpr (QS) {
    for (int j = tid; j < p.dt; j += kThreads) qs[j] = qg[j];
  }
  const float* qrow = QS ? qs : qg;
  const int* qlab = p.qlabels + static_cast<long long>(q) * p.lq;
  const int* starts = p.start_ids + static_cast<long long>(q) * p.s;
  const bool narrow = er <= kNarrowRow;

  // ---- the start nodes: dedup, distances, the stable sort into the beam ----
  if (tid == 0) misc[0] = 0;
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
  atomicAdd(misc, local);
  __syncthreads();
  int n_comps = misc[0];
  for (int b0 = 0; b0 < s_in; b0 += kWarps) {  // one warp a start node
    const int j = b0 + warp;
    if (j < s_in) {
      const int sid = mt[j];
      const float d = sid >= 0 ? score_row<DT, QS>(p, sid, qrow, lane) : INFINITY;
      if (lane == 0) md[j] = d;
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

  int n_vis = 0, it = 0;
  while (it < p.iter_bound) {
    bool unvisited = false;
    for (int j = tid; j < l; j += kThreads) {
      const int t = beam_t[j];
      unvisited |= t >= 0 && !(t & 1);
    }
    if (!__syncthreads_or(unvisited) || n_vis >= p.h) break;

    // 1-3: select, apply the budget, visit.
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

    // 4-6: expand, the label mask, the in-beam dedup.
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
        for (int a = 0; a < p.lm && !any; ++a) {
          const int x = __ldg(nl + a);
          if (x == kLabelSentinel) continue;
          for (int b = 0; b < p.lq; ++b) any |= __ldg(qlab + b) == x;
        }
        v = any;
      }
      if (v) {
        bool hit = false;
#pragma unroll 4
        for (int j = 0; j < l; ++j) hit |= (beam_t[j] >> 1) == nbv;
        v = !hit;
      }
      fid[i] = v ? nbv : -1;
    }
    __syncthreads();

    // 7: the in-row dedup (the first slot of an id survives).
    int nf = 0;
    for (int b0 = 0; b0 < er; b0 += kThreads) {
      const int i = b0 + tid;
      const int id = i < er ? fid[i] : -1;
      bool keep = id >= 0;
      if (keep) {
        bool dup = false;
#pragma unroll 4
        for (int j = 0; j < i; ++j) dup |= fid[j] == id;
        keep = !dup;
      }
      int tot;
      const int idx = pgvs::block_prefix<kWarps>(keep, wtot, tot);
      if (keep) {
        kept[nf + idx] = i;
        nb[nf + idx] = id;
      }
      nf += tot;
    }
    __syncthreads();
    n_comps += nf;
    if (nf == 0) {  // nothing to merge: both rows stay as they are
      ++it;
      continue;
    }

    // 8: full-precision distances of the survivors, one warp each.
    for (int b0 = 0; b0 < nf; b0 += kWarps) {
      const int c = b0 + warp;
      if (c < nf) {
        const float d = score_row<DT, QS>(p, nb[c], qrow, lane);
        if (lane == 0) kd[c] = d;
      }
    }
    __syncthreads();

    // 9: rank by (distance, slot or id), then the window and beam merges.
    const int* tb = narrow ? kept : nb;  // the tie-break: slot or id
    for (int c = tid; c < nf; c += kThreads) {
      const float dc = kd[c];
      const int tc = tb[c];
      int rank = 0;
#pragma unroll 4
      for (int k = 0; k < nf; ++k) {
        const float dk = kd[k];
        rank += (dk < dc) | ((dk == dc) & (tb[k] < tc));
      }
      cs_d[rank] = dc;
      cs_t[rank] = nb[c];
    }
    __syncthreads();
    if (wn > 0) merge_row(win_d, win_t, wn, cs_d, cs_t, nf, er, -1, md, mt);
    for (int c = tid; c < nf; c += kThreads) cs_t[c] *= 2;  // the beam's tags
    __syncthreads();
    merge_row(beam_d, beam_t, l, cs_d, cs_t, nf, er, -2, md, mt);
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

template <int DT, bool QS>
cudaError_t launch(const Params& p, int q, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        beam_search_full_kernel<DT, QS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  beam_search_full_kernel<DT, QS><<<q, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_dtype(const Params& p, int q, bool qs, size_t smem, cudaStream_t stream) {
  return qs ? launch<DT, true>(p, q, smem, stream) : launch<DT, false>(p, q, smem, stream);
}

}  // namespace

// Bytes of one query's state (shared memory, or its slice of the scratch).
extern "C" long long pgvs_beam_search_full_state_bytes(int l, int window_n, int e, int r) {
  return Layout(l, window_n, e, r).bytes();
}

// Shared memory the query's prefix of Dt floats takes when it is there.
extern "C" long long pgvs_beam_search_full_query_bytes(int dt) {
  return pgvs::query_smem_bytes(dt);
}

// Inputs: vectors [cap, D] of `dtype` (0 f32, 1 bf16, 2 int8), scales
// f32[cap] (int8; else null), adjacency i32[cap, R], node_labels
// i32[cap, Lm] (null when Lq == 0), query_vecs f32[Q, Dt], start_ids
// i32[Q, S], query_labels i32[Q, Lq]; metric: config.DistanceType.
// Outputs as in Params.  scratch: null to keep the state in shared memory,
// else Q * state_bytes bytes; query_shared: the query's prefix in shared
// memory (else read from query_vecs).
extern "C" int pgvs_beam_search_full(
    const void* vectors, const void* scales, const void* adjacency, const void* node_labels,
    const void* query_vecs, const void* start_ids, const void* query_labels, void* beam_ids,
    void* beam_dists, void* beam_vis, void* hist_ids, void* hist_dists, void* n_visited,
    void* n_comps, void* win_ids, void* win_dists, void* iters, void* scratch, int q, int cap,
    long long d, int dt, int dtype, int metric, int r, int lm, int s, int lq, int l, int h,
    int track_hist, int e, int window_n, int query_shared, int device, void* stream) {
  if (q <= 0) return static_cast<int>(cudaSuccess);
  if (cap <= 0 || dt <= 0 || dt > d || dtype < 0 || dtype > 2 || metric < 0 || metric > 2 ||
      r <= 0 || s < 0 || lq < 0 || lm < 0 || l <= 0 || h < 0 || e < 1 || e > l ||
      window_n < 0 || (lq > 0 && lm > 0 && node_labels == nullptr) ||
      (dtype == 2 && scales == nullptr))
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
  p.scratch = static_cast<unsigned char*>(scratch);
  p.state_bytes = Layout(l, window_n, e, r).bytes();
  p.stride = d;
  p.cap = cap;
  p.dt = dt;
  p.metric = metric;
  p.vec = dtype == 0   ? pgvs::rows_vectorizable<pgvs::kRowF32>(vectors, d)
          : dtype == 1 ? pgvs::rows_vectorizable<pgvs::kRowBF16>(vectors, d)
                       : pgvs::rows_vectorizable<pgvs::kRowI8>(vectors, d);
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
  const size_t smem = static_cast<size_t>((scratch ? 0 : p.state_bytes) +
                                          (query_shared ? pgvs::query_smem_bytes(dt) : 0));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool qs = query_shared != 0;
  if (dtype == 0) {
    err = launch_dtype<pgvs::kRowF32>(p, q, qs, smem, st);
  } else if (dtype == 1) {
    err = launch_dtype<pgvs::kRowBF16>(p, q, qs, smem, st);
  } else {
    err = launch_dtype<pgvs::kRowI8>(p, q, qs, smem, st);
  }
  return static_cast<int>(err);
}
