// The whole SBQ beam search, one launch per query batch, for sm_90a.
//
// Replaces the JAX package's `lax.while_loop` in `beam_search`
// (pgvectorscale_tpu/graph/search.py:580); not a Pallas kernel.  Its inner
// step, the Hamming distance through the adjacency, is the TPU kernel
// `hamming_edge_gather_pallas`'s, with edge_gather.cu's device code
// (hamming.cuh).  Every piece of the loop's state is a query's own; the
// batch shares only the iteration bound and the stop when no query has
// work left.  A query with no unvisited entry, or with its visit budget
// spent, is left unchanged by a further iteration (its candidates are all
// masked and a merge of +inf candidates swaps nothing), so each query runs
// its own loop to convergence or to the bound, and the batch's iteration
// count is the largest of the queries' counts.
//
// One block per query runs the plain version's iteration (graph/search.py
// `beam_search_plain`) in its order:
//  1. the E best unvisited beam entries: the beam is sorted, so they are
//     the first E unvisited valid entries (the stable sort's order);
//  2. the visit budget: entries past H stay unvisited;
//  3. mark them visited, write the history, count the visits;
//  4. gather their adjacency rows (E*R slots);
//  5. a filtered search keeps a neighbour only if its labels overlap the
//     query's (sentinel excluded);
//  6. drop neighbours already in the beam;
//  7. drop a neighbour seen in an earlier slot; the survivors are the same
//     in the plain version's two dedup branches, which differ only in the
//     candidates' order: slot order for E*R <= 192, id order above;
//  8. score the survivors (Hamming through the adjacency);
//  9. sort them by (distance, slot or id) and merge them into the window
//     (when kept) and the beam with the plain version's bitonic network:
//     [row | +inf pad | candidates descending], strides n/2 .. 1, a swap
//     only on a strict >.  Entries of equal distance and equal tag are the
//     same entry, so only the finite candidates' order matters.
// The start nodes' dedup, distances and stable sort happen here too.
//
// Bound: bytes, and the chain of dependent iterations.  The least traffic
// is each distinct frontier row's R adjacency ids, each distinct
// neighbour's code row, the inputs and the outputs once; the 100k code
// table (19.2 MB at W = 48) and adjacency fit in the 50 MB L2.  Design:
// one block per query, so a batch of 1,024 queries fills the card's SMs
// with several blocks each; the beam, the window, the candidate rows and
// the merge buffer live in shared memory (dynamic, above 48 KB after
// cudaFuncSetAttribute) or, when the caller gives a scratch buffer for a
// state too large, in the query's slice of it, through the same code.
// A block-wide step is a ballot prefix or a loop over shared memory
// between barriers; the loop has no host in it.
//
// Plain C interface for ctypes: raw pointers, sizes and the caller's
// stream.  The function launches, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hamming.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Blocks an SM must hold at once: caps a thread at 64 registers, so 1,024
// queries need at most two rounds of the 132 SMs.
constexpr int kMinBlocks = 4;
constexpr int kLabelSentinel = 0x7fffffff;
constexpr int kNarrowRow = 192;  // E*R <= 192: slot order, else id order

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
  int cap, w, r, lm, s, lq, l, h, h_cap, track_hist, e, window_n, iter_bound, chunks, log2g;
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

// Exclusive prefix count of `pred` over the block and the block's total.
// Every thread must call it; `wtot` holds kWarps words of shared state.
__device__ __forceinline__ int block_prefix(bool pred, int* wtot, int& total) {
  const unsigned m = __ballot_sync(0xffffffffu, pred);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) wtot[warp] = __popc(m);
  __syncthreads();
  int before = 0, tot = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int c = wtot[k];
    before += k < warp ? c : 0;
    tot += c;
  }
  __syncthreads();
  total = tot;
  return before + __popc(m & ((1u << lane) - 1u));
}

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

template <int V, int CPL>
__global__ void __launch_bounds__(kThreads, kMinBlocks) beam_search_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const Layout lay(p.l, p.window_n, p.e, p.r);
  const int l = p.l, wn = p.window_n, er = lay.er, e = p.e, r = p.r;
  unsigned char* base = p.scratch ? p.scratch + static_cast<long long>(q) * p.state_bytes : smem;
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

  const int g = 1 << p.log2g;
  const int lane_in_group = tid & (g - 1);
  const int group = tid >> p.log2g;
  const int n_groups = kThreads >> p.log2g;
  const int* qrow = p.qcodes + static_cast<long long>(q) * p.w;
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
  for (int b0 = 0; b0 < s_in; b0 += n_groups) {
    const int j = b0 + group;
    const int sid = j < s_in ? mt[j] : -1;
    unsigned pop = 0;
    if (sid >= 0) {
      const int row = min(sid, p.cap - 1);
      pop = pgvs::lane_pop_xor<V, CPL>(p.codes + static_cast<long long>(row) * p.w, qrow,
                                       p.chunks, lane_in_group, g);
    }
    pop = pgvs::group_sum(pop, g);
    if (j < s_in && lane_in_group == 0) md[j] = sid >= 0 ? static_cast<float>(pop) : INFINITY;
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
      const int idx = block_prefix(pred, wtot, tot);
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
      if (v) {  // no early exit: the loads pipeline
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
      const int idx = block_prefix(keep, wtot, tot);
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

    // 8: Hamming distances of the survivors, one group of lanes each.
    for (int b0 = 0; b0 < nf; b0 += n_groups) {
      const int c = b0 + group;
      unsigned pop = 0;
      if (c < nf) {
        const int row = min(max(nb[c], 0), p.cap - 1);
        pop = pgvs::lane_pop_xor<V, CPL>(p.codes + static_cast<long long>(row) * p.w, qrow,
                                         p.chunks, lane_in_group, g);
      }
      pop = pgvs::group_sum(pop, g);
      if (c < nf && lane_in_group == 0) kd[c] = static_cast<float>(pop);
    }
    __syncthreads();

    // 9: sort by (distance, slot or id), then the window and beam merges.
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

template <int V, int CPL>
cudaError_t launch(const Params& p, int q, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        beam_search_kernel<V, CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  beam_search_kernel<V, CPL><<<q, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Bytes of one query's state (shared memory, or its slice of the scratch).
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
      e > l || window_n < 0 || (lq > 0 && lm > 0 && node_labels == nullptr))
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
  p.state_bytes = Layout(l, window_n, e, r).bytes();
  p.cap = cap;
  p.w = w;
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
  const pgvs::GroupShape shape = pgvs::group_shape(w, codes, query_codes);
  p.chunks = w / shape.v;
  p.log2g = shape.log2g;
  const size_t smem = scratch ? 0 : static_cast<size_t>(p.state_bytes);
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
