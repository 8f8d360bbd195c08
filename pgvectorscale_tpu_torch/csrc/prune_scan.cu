// RobustPrune's dependent scan, one launch per prune, for sm_90a.
//
// Replaces the JAX package's `lax.fori_loop` over n_alphas * C steps in
// `robust_prune` (pgvectorscale_tpu/graph/prune.py:157); not a Pallas
// kernel.  The candidates of each row b are already sorted (the caller's
// two-key stable sort: distance, then id distance for zero distances) and
// come in sorted order, except the pair distances and the labels, which are
// read through `order` (so the [B, C, C] reorders of the pair matrix never
// exist).  With i the picker and j a later candidate, both sorted positions:
//
//   pd          = pair[b, order[i], order[j]]
//   factor(i,j) = pd < eps ? (dist[j] < eps ? tie_q[j] / max(|id_i - id_j|, 1) : BIG)
//                          : dist[j] / max(pd, eps)
//   gate(i,j)   = labels[j] ∩ node_labels ⊆ labels[i]   (labeled rows only)
//
// and the scan, for each alpha and i = 0..C-1 in order: i is picked iff
// count < R, i is unpicked, f[i] <= alpha and valid[i]; a pick sets
// sel[i] = count, count += 1, f[j] = max(f[j], factor(i, j)) for every j > i
// that passes the gate.  f starts at 0; max and the division propagate NaN
// (torch's maximum and clamp do).
//
// The f32 operations are the plain version's, in its order, and the build
// never uses fast math, so `sel` is bit-equal to it.
//
// Bound: a pick's update needs the picked candidate's pair row, one
// dependent read from device memory (the [B, C, C] matrix is far larger
// than L2), so a row is a chain of (its picks) dependent reads plus the
// searches between them; bytes: the picked rows plus the [B, C] inputs
// and output.  Design:
// - one warp a row, several rows a block, so a wave's 4,096 rows run in one
//   round on 132 SMs; no block barrier, warp-wide steps only;
// - sorted position j lives in lane j % 32, slot j / 32: its f and order
//   in registers (C <= 32 * 11), else in shared memory through the same
//   steps; dead positions (invalid, padding, picked, or with f past every
//   alpha, so never pickable again) are bits of one word (in shared
//   memory: order -1), and an update skips them;
// - the next pick is found by one ballot a slot from the last pick on,
//   `__ffs` of the first non-zero mask: f only grows within a round, so a
//   position the ballot passed over could not be picked later in that
//   round; the chain of a round is about C/32 ballots plus the picks;
// - a pick's row is copied whole, in the matrix's order, into shared
//   memory by `cp.async` (128 contiguous bytes an instruction, no register
//   held), and read there through the order; the row of the next position
//   pickable under the pre-update f is started before the update and
//   used if the search after the update finds that position again;
// - the label gate is one AND a pair: each slot k of the node's labels is
//   a bit, M_j = the bits whose label candidate j carries (built once a
//   row, O(C * Lm^2)), and gate(i, j) = (M_j & ~M_i) == 0, in ceil(Lm / 32)
//   words; duplicated node labels set equal bits in both masks and an
//   all-sentinel row has no bit, as the plain gate has it;
// - the scan stops once count == R.
//
// Plain C interface for ctypes: raw pointers, sizes and the caller's
// stream.  The function launches, allocates nothing, does not synchronise,
// and returns cudaGetLastError().  Built with -DPGVS_PRUNE_STATS=1 it also
// counts speculative row loads, their hits and the cycles of each phase
// (`pgvs_prune_scan_stats`); with -DPGVS_PRUNE_REGISTERS=0 it keeps the
// state in shared memory at every C.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef PGVS_PRUNE_STATS
#define PGVS_PRUNE_STATS 0
#endif
#ifndef PGVS_PRUNE_REGISTERS
#define PGVS_PRUNE_REGISTERS 1
#endif

namespace {

constexpr float kEps = 1.1920928955078125e-07f;  // float32 eps, 2**-23
constexpr float kBig = 3.0e38f;
constexpr int kUnselected = 0x7fffffff;
constexpr int kLabelSentinel = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 4;  // one warp a row
constexpr int kMaxRegSlots = 11;  // C <= 352 keeps the state in registers
// Shared memory a block may use on sm_90a (232,448 bytes of the SM's 256 KB).
constexpr long long kMaxSmem = 232448;

#if PGVS_PRUNE_STATS
// Over all rows: speculative row loads issued, of them used, picks, then
// clock64 cycles in the set-up, the searches (next_pick), the row copies'
// start, the waits for a row, and the updates.
constexpr int kStats = 8;
__device__ unsigned long long g_stats[kStats];
#define PGVS_TICK(t) (t) = clock64()
#define PGVS_TOCK(acc, t) (acc) += clock64() - (t)
#else
#define PGVS_TICK(t)
#define PGVS_TOCK(acc, t)
#endif

struct Params {
  const int* order;        // [B, C]
  const float* pair;       // [B, C, C] unsorted
  const float* dists;      // [B, C] sorted
  const int* ids;          // [B, C] sorted
  const uint8_t* valid;    // [B, C] sorted
  const float* tie_q;      // [B, C] sorted
  const int* cand_labels;  // [B, C, Lm] unsorted, or null
  const int* node_labels;  // [B, Lm], or null
  const float* alphas;     // [n_alphas]
  int* sel;                // [B, C]
  int b, c, lm, words, n_alphas, r;
  int slots;               // positions a lane holds: 32 * slots >= C
  int rows;                // rows (warps) a block
  int row_bytes;           // shared memory of one row
};

// |a - b| with int32 wrap-around, as the plain version's int32 tensors.
__device__ __forceinline__ float abs_diff_f32(int a, int b) {
  int d = static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
  d = d < 0 ? static_cast<int>(0u - static_cast<unsigned>(d)) : d;
  return static_cast<float>(d);
}

// factor(i, j) when pd < eps and num < eps: the tie-break by id distance.
// Rare, so out of line: the unrolled update keeps one call a slot.
__device__ __noinline__ float tie_factor(const Params& p, long long row, int i, int j) {
  const float tie = abs_diff_f32(__ldg(p.ids + row + i), __ldg(p.ids + row + j));
  return __ldg(p.tie_q + row + j) / fmaxf(tie, 1.0f);
}

// torch.maximum: NaN if either is.
__device__ __forceinline__ float max_nan(float f, float fac) {
  return (f != f || fac != fac) ? f + fac : fmaxf(f, fac);
}

// gate(i, j) on the row's label masks, [words][cp] in shared memory;
// more than one word (Lm > 32) is rare, so out of line.
__device__ __noinline__ bool gate(const unsigned* mask, int cp, int words, int i, int j) {
  for (int w = 0; w < words; ++w)
    if (mask[w * cp + j] & ~mask[w * cp + i]) return false;
  return true;
}

// Position j's mask: bit k of word k / 32 when node label k is a label
// and candidate j (unsorted row `raw`) carries it.  The candidate's labels
// are read four at a time, the loads in flight together; the node's
// (the same for every lane) come from L1.
__device__ __forceinline__ void build_mask(const Params& p, int b, int raw, unsigned* mask,
                                           int cp, int j) {
  const int* node = p.node_labels + static_cast<long long>(b) * p.lm;
  const int* lab = p.cand_labels + (static_cast<long long>(b) * p.c + raw) * p.lm;
  for (int w = 1; w < p.words; ++w) mask[w * cp + j] = 0u;
  unsigned m0 = 0;
  for (int q0 = 0; q0 < p.lm; q0 += 4) {
    int x[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) x[t] = q0 + t < p.lm ? __ldg(lab + q0 + t) : kLabelSentinel;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (x[t] == kLabelSentinel) continue;
      for (int k = 0; k < p.lm; ++k) {
        if (__ldg(node + k) != x[t]) continue;
        if (k < 32) m0 |= 1u << k;
        else mask[(k >> 5) * cp + j] |= 1u << (k & 31);
      }
    }
  }
  mask[j] = m0;
}

// The row's scan state.  Position j = 32 * s + lane: its f, its order
// (the row of the pair matrix) and whether it is dead.  K > 0: in
// registers, f and order in arrays that every loop over the K slots
// indexes with constants (loops unrolled; no slot is chosen by a runtime
// index), dead as the bits of one word.  K == 0: in shared memory, dead as
// order -1; each lane touches its own positions only.  Both keep the
// orders in shared memory too, where every lane reads the picker's.
template <int K>
struct State {
  float f_[K > 0 ? K : 1];
  int ord_[K > 0 ? K : 1];
  unsigned dead;
  float* f_sh;
  int* ord_sh;
  int slots, lane;
  __device__ __forceinline__ int n() const { return K > 0 ? K : slots; }
  // The first slot of a loop over slots >= lo: 0 in registers (the loop
  // is unrolled and skips the slots below lo).
  __device__ __forceinline__ int first(int lo) const { return K > 0 ? 0 : lo; }
  __device__ __forceinline__ float& f(int s) {
    if constexpr (K > 0) return f_[s];
    else return f_sh[s * 32 + lane];
  }
  __device__ __forceinline__ int ord(int s) const {
    if constexpr (K > 0) return ord_[s];
    else return ord_sh[s * 32 + lane];
  }
  __device__ __forceinline__ bool live(int s) const {
    if constexpr (K > 0) return !((dead >> s) & 1u);
    else return ord_sh[s * 32 + lane] >= 0;
  }
  __device__ __forceinline__ void kill(int s) {
    if constexpr (K > 0) dead |= 1u << s;
    else ord_sh[s * 32 + lane] = -1;
  }
  // Position i dies (every lane calls it; its lane marks it).
  __device__ __forceinline__ void kill_position(int i) {
    if (lane == (i & 31)) {
      if constexpr (K > 0) dead |= 1u << (i >> 5);
      else ord_sh[i] = -1;
    }
  }
};

// The first live position >= from with f <= alpha, or -1.
template <int K>
__device__ __forceinline__ int next_pick(State<K>& st, int from, float alpha) {
#pragma unroll
  for (int s = st.first(from >> 5); s < st.n(); ++s) {
    if (s < (from >> 5)) continue;
    const int j = s * 32 + st.lane;
    const unsigned m = __ballot_sync(kFull, st.live(s) && st.f(s) <= alpha && j >= from);
    if (m) return s * 32 + __ffs(m) - 1;
  }
  return -1;
}

// Start the copies of picker i's pair row into buf (shared memory), whole
// and in the matrix's (unsorted) order: each copy instruction moves 128
// contiguous bytes, and no register holds them.
template <int K>
__device__ __forceinline__ void issue_row(const State<K>& st, const Params& p, long long row,
                                          float* buf, int i) {
  const float* prow = p.pair + (row + st.ord_sh[i]) * p.c;
#pragma unroll
  for (int s = 0; s < st.n(); ++s) {
    const int k = s * 32 + st.lane;
    if (k < p.c) __pipeline_memcpy_async(buf + k, prow + k, 4);
  }
}

// Picker i's update of f from its row in buf (read through the order) at
// the live later positions it gates; a position whose f passes amax
// (every alpha) dies.
template <int K>
__device__ __forceinline__ void apply_row(State<K>& st, const Params& p, long long row,
                                          const unsigned* mask, int cp, const float* d_sh,
                                          const float* buf, int i, float amax) {
  const unsigned mi = p.words ? mask[i] : 0u;
  // In registers, every slot's pair distance is read before the first
  // branch, so the reads overlap.
  float pds[K > 0 ? K : 1];
  if constexpr (K > 0) {
#pragma unroll
    for (int s = 0; s < K; ++s) pds[s] = buf[st.ord(s)];
  }
#pragma unroll
  for (int s = st.first((i + 1) >> 5); s < st.n(); ++s) {
    const int j = s * 32 + st.lane;
    if (s < (i + 1) >> 5 || j <= i || !st.live(s)) continue;
    if (p.words == 1 ? (mask[j] & ~mi) != 0 : p.words > 1 && !gate(mask, cp, p.words, i, j))
      continue;
    float pd;
    if constexpr (K > 0) pd = pds[s];
    else pd = buf[st.ord(s)];
    const float num = d_sh[j];
    float fac = num / (pd != pd ? pd : fmaxf(pd, kEps));
    if (pd < kEps) fac = num < kEps ? tie_factor(p, row, i, j) : kBig;
    const float f = max_nan(st.f(s), fac);
    st.f(s) = f;
    if (!(f <= amax)) st.kill(s);
  }
}

// One row's scan.  Each step finds n, the first position pickable under
// the current f.  With no pick pending, n is the next pick: its row was
// started a step earlier if it is the speculated position, else it is
// started now.  With a pick cur pending, n is the speculation (pickable
// under the f before cur's update): its row is started, then cur's row
// (started a step earlier) updates f, and the next step's search starts
// at n (f only grew, so no position in (cur, n) became pickable; it finds
// n again if n is still pickable).
template <int K>
__device__ __forceinline__ void scan_row(const Params& p, int b, long long row,
                                         unsigned char* base, int lane) {
  const int cp = 32 * p.slots;
#if PGVS_PRUNE_STATS
  long long t = 0, cyc[5] = {0, 0, 0, 0, 0};
#endif
  PGVS_TICK(t);
  float* d_sh = reinterpret_cast<float*>(base);
  float* buf_cur = d_sh + cp;
  float* buf_next = buf_cur + cp;
  unsigned* mask = reinterpret_cast<unsigned*>(buf_next + cp);
  State<K> st;
  st.ord_sh = reinterpret_cast<int*>(mask + static_cast<long long>(p.words) * cp);
  st.f_sh = reinterpret_cast<float*>(st.ord_sh + cp);
  st.slots = p.slots;
  st.lane = lane;
  st.dead = 0;
  // Set-up in loops that are not fully unrolled (a row runs them once:
  // their code is fetched once), then the registers from shared memory.
  // Every load of a pass is independent of the others.  A dead position's
  // order is -1 in shared memory; a picker is never dead.
#pragma unroll 4
  for (int j = lane; j < cp; j += 32) {
    int o = -1;
    float dv = 0.0f;
    if (j < p.c) {
      const int raw = __ldg(p.order + row + j);
      dv = __ldg(p.dists + row + j);
      o = p.valid[row + j] ? raw : -1;
      p.sel[row + j] = kUnselected;
    }
    d_sh[j] = dv;
    st.ord_sh[j] = o;
    if constexpr (K == 0) st.f_sh[j] = 0.0f;
  }
  if (p.words)
    for (int j = lane; j < p.c; j += 32)
      if (st.ord_sh[j] >= 0) build_mask(p, b, st.ord_sh[j], mask, cp, j);
  if constexpr (K > 0) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int o = st.ord_sh[s * 32 + lane];
      st.ord_[s] = o < 0 ? 0 : o;
      st.f_[s] = 0.0f;
      if (o < 0) st.kill(s);
    }
  }
  float amax = 0.0f;  // the largest alpha
  for (int a = 0; a < p.n_alphas; ++a)
    amax = a ? fmaxf(amax, __ldg(p.alphas + a)) : __ldg(p.alphas);
  float alpha = p.n_alphas > 0 ? __ldg(p.alphas) : 0.0f;
  __syncwarp();
  int count = 0, cur = -1, spec_n = -1, from = 0, a = 0;
  unsigned spec = 0, hits = 0;
  PGVS_TOCK(cyc[0], t);
  while (a < p.n_alphas && count < p.r) {
    PGVS_TICK(t);
    const int n = next_pick(st, from, alpha);
    PGVS_TOCK(cyc[1], t);
    PGVS_TICK(t);
    const bool hit = cur < 0 && n >= 0 && n == spec_n;
    if (cur < 0 && spec_n >= 0 && !hit) __pipeline_wait_prior(0);  // buf_next is free
    const bool start = n >= 0 && !hit && (cur < 0 || count + 1 < p.r);
    if (start) issue_row(st, p, row, cur < 0 ? buf_cur : buf_next, n);
    __pipeline_commit();
    PGVS_TOCK(cyc[2], t);
    if (cur < 0) {
      spec_n = -1;
      if (n < 0) {  // the round is over
        from = 0;
        if (++a < p.n_alphas) alpha = __ldg(p.alphas + a);
        continue;
      }
      if (hit) {
        ++hits;
        float* tmp = buf_cur;
        buf_cur = buf_next;
        buf_next = tmp;
      }
      cur = n;
      from = n + 1;
      continue;
    }
    spec += start;
    spec_n = start ? n : -1;
    PGVS_TICK(t);
    __pipeline_wait_prior(1);  // cur's row has landed: this lane's copies,
    __syncwarp();              // then every lane's
    PGVS_TOCK(cyc[3], t);
    PGVS_TICK(t);
    apply_row(st, p, row, mask, cp, d_sh, buf_cur, cur, amax);
    __syncwarp();  // every lane's reads of buf_cur are done before it is refilled
    st.kill_position(cur);
    if (lane == (cur & 31)) p.sel[row + cur] = count;
    ++count;
    from = n >= 0 ? n : 32 * st.n();
    cur = -1;
    PGVS_TOCK(cyc[4], t);
  }
  __pipeline_wait_prior(0);
#if PGVS_PRUNE_STATS
  if (lane == 0) {
    atomicAdd(&g_stats[0], static_cast<unsigned long long>(spec));
    atomicAdd(&g_stats[1], static_cast<unsigned long long>(hits));
    atomicAdd(&g_stats[2], static_cast<unsigned long long>(count));
    for (int k = 0; k < 5; ++k)
      atomicAdd(&g_stats[3 + k], static_cast<unsigned long long>(cyc[k]));
  }
#else
  (void)spec;
  (void)hits;
#endif
}

// 8 blocks of 4 rows an SM (at most 64 registers a thread) run 4,224
// rows at once on 132 SMs: a wave's 4,096 in one round.  Past 6 register
// slots (C > 192) 6 blocks, so the state stays in registers.
template <int K>
__global__ void __launch_bounds__(32 * kRowsPerBlock, K <= 6 ? 8 : 6)
    prune_scan_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * p.rows + warp;
  if (b >= p.b) return;
  scan_row<K>(p, b, static_cast<long long>(b) * p.c,
              smem + static_cast<long long>(warp) * p.row_bytes, lane);
}

template <int K>
cudaError_t launch_as(const Params& p, int blocks, int threads, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(prune_scan_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  prune_scan_kernel<K><<<blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Register slots of the kernel for C candidates, or 0 for the state in
// shared memory (always, when built with -DPGVS_PRUNE_REGISTERS=0).
int register_slots(int c) {
  if (!PGVS_PRUNE_REGISTERS) return 0;
  static const int kSlots[] = {2, 4, 6, 8, kMaxRegSlots};
  const int need = (c + 31) / 32;
  for (int k : kSlots)
    if (need <= k) return k;
  return 0;
}

// Shared memory of one row: dists, two pair-row buffers, the label masks
// and the orders, and f past the register path.
long long row_bytes(int c, int words) {
  const int k = register_slots(c);
  const long long cp = 32LL * (k ? k : (c + 31) / 32);
  return 4 * cp * (4 + words + (k ? 0 : 1));
}

}  // namespace

// Shared memory bytes a row needs for C candidates (labels of up to 32 a
// row; 4 * 32 * ceil(C / 32) bytes more for every further 32).
extern "C" int pgvs_prune_scan_smem_bytes(int c) {
  const long long n = row_bytes(c, 1);
  return n > 0x7fffffff ? 0x7fffffff : static_cast<int>(n);
}

extern "C" int pgvs_prune_scan(const void* order, const void* pair, const void* dists,
                               const void* ids, const void* valid, const void* tie_q,
                               const void* cand_labels, const void* node_labels,
                               const void* alphas, void* sel, int b, int c, int lm,
                               int n_alphas, int r, int device, void* stream) {
  if (b <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  if (lm < 0 || n_alphas < 0 || (lm > 0 && (cand_labels == nullptr || node_labels == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = (lm + 31) / 32;
  const long long bytes = row_bytes(c, words);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // This library carries its own CUDA runtime, whose current device is
  // separate from the caller's: point it at the device of the tensors.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.order = static_cast<const int*>(order);
  p.pair = static_cast<const float*>(pair);
  p.dists = static_cast<const float*>(dists);
  p.ids = static_cast<const int*>(ids);
  p.valid = static_cast<const uint8_t*>(valid);
  p.tie_q = static_cast<const float*>(tie_q);
  p.cand_labels = static_cast<const int*>(cand_labels);
  p.node_labels = static_cast<const int*>(node_labels);
  p.alphas = static_cast<const float*>(alphas);
  p.sel = static_cast<int*>(sel);
  p.b = b;
  p.c = c;
  p.lm = lm;
  p.words = words;
  p.n_alphas = n_alphas;
  p.r = r;
  const int k = register_slots(c);
  p.slots = k ? k : (c + 31) / 32;
  p.row_bytes = static_cast<int>(bytes);
  p.rows = static_cast<int>(kMaxSmem / bytes < kRowsPerBlock ? kMaxSmem / bytes : kRowsPerBlock);
  const int blocks = (b + p.rows - 1) / p.rows, threads = 32 * p.rows;
  const int smem = p.rows * p.row_bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 2: err = launch_as<2>(p, blocks, threads, smem, st); break;
    case 4: err = launch_as<4>(p, blocks, threads, smem, st); break;
    case 6: err = launch_as<6>(p, blocks, threads, smem, st); break;
    case 8: err = launch_as<8>(p, blocks, threads, smem, st); break;
    case kMaxRegSlots: err = launch_as<kMaxRegSlots>(p, blocks, threads, smem, st); break;
    default: err = launch_as<0>(p, blocks, threads, smem, st); break;
  }
  return static_cast<int>(err);
}

#if PGVS_PRUNE_STATS
// Copies the counters (as g_stats) to out[0..7] on the host and zeroes
// them.
extern "C" int pgvs_prune_scan_stats(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_stats, sizeof(g_stats));
  const unsigned long long zero[kStats] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_stats, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif
