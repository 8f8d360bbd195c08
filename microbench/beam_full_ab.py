"""Time two builds of the full-precision beam-search kernel on one card, in
turns, time one iteration of each by phase, and measure the repeat share.

Usage, from the repository root on a machine with an NVIDIA GPU:

    python3 microbench/beam_full_ab.py [<parent dir>] [--new <dir>] [--out <json path>]

``<parent dir>`` holds another commit's ``beam_search_full.cu`` and
``rowdist.cuh`` (for example ``git show <commit>:pgvectorscale_tpu_torch/
csrc/beam_search_full.cu``), default ``microbench/_parent``; ``--new`` the
sources that stand for this checkout's (default its ``csrc/``).  Each build is
driven through its own C interface: a library that exports
``pgvs_beam_search_full_ring_bytes`` through ``ops.beam_search_full.launch``,
one without it through ``launch_before_memo`` below (the interface before
the distance memo).  The script builds, with one nvcc each, all started
together: the parent and this checkout as the port builds them, both
again with the phase timers put in (``instrument``), and
``microbench/sm_read_rate.cu``, and prints each build's ``-Xptxas -v``
lines.  It runs ``sm_read_rate`` first (random 3 KB rows into shared
memory by the lanes' cp.async and by bulk copies, one block and one block
an SM, rings of 1 to 8 rows a warp).

The shapes: ``chip_smoke.py`` phase 2's random-graph search (Q=1,024, 768
f32 unit rows, cosine, L=100, visit budget 166, E=4 over 100,352 slots, 23%
of the adjacency empty) and build wave (Q=4,096, the history kept), one
query of the search alone; then the seeded 100k x 768 "cohere" corpus of
``chip_smoke.py`` phase 10: its plain-storage index searched at L=100
(1,024 queries, the arguments ``DiskannIndex.search`` passes, captured),
one of those queries alone, and wave 12 of a build with build_distance
"exact" (``profile_main_path.py``'s wave; its arguments captured with a
copy of the adjacency as the wave saw it).  At each shape every build's
outputs are compared with ``beam_search_full_plain`` (``results_close``:
float rows, reported) and with each other bit for bit (the fields that
differ, reported); then each is timed in turns
(parent, new, new, parent), each the mean of 10 launches between CUDA
events queued behind a device sleep, and this checkout's kernel twice at
each of the other launch shapes of ``BATCH_VARIANTS`` or
``ALONE_VARIANTS`` (their outputs compared with the plan's bit for bit).  Per shape it prints the repeat
share: the survivors scored (``n_dist_comps``), the distinct rows among
them (``distinct_scored_plain``) and, for a build with the memo, the rows
it read (its ``rows_read`` output).  Per phase of the loop (``PHASES``), the
cycles an iteration of thread 0 of one block (a phase's cycles include
its waits at the barrier that ends it), at one query alone and at two
blocks of the batch shapes.  Prints the card's name and power limit
first, and one JSON line with everything at the end, also written to
``--out`` (default ``microbench/_out/beam_full_ab.json``, where the
builds go too).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pgvectorscale_tpu_torch.config import DistanceType  # noqa: E402
from pgvectorscale_tpu_torch.graph.search import SearchResult  # noqa: E402
from pgvectorscale_tpu_torch.ops import _build  # noqa: E402
from pgvectorscale_tpu_torch.ops import beam_search_full as bsf  # noqa: E402

CAP, INVALID_SHARE, SEED = 100_352, 0.23, 10
N, NQ, CORPUS_SEED, WAVE = 100_000, 1024, 0, 12
SEARCH = dict(search_list_size=100, max_iters=166, expand_factor=4, track_hist=False,
              window_n=0, distance_type=DistanceType.COSINE)
TIMED_CALLS = 10
# Other launch shapes of this checkout's kernel, timed beside its plan's
# (``ops.beam_search_full.launch``'s overrides): threads a block, the
# ring's slots a warp and the memo's entries (log2).
BATCH_VARIANTS = {"256 threads, 3 slots, memo 2048": dict(threads=256, slots=3, memo_log2=11),
                  "512 threads, 2 slots, memo 8192": dict(threads=512, slots=2, memo_log2=13)}
ALONE_VARIANTS = {"256 threads, 5 slots, memo 8192": dict(threads=256, slots=5, memo_log2=13),
                  "512 threads, 3 slots, memo 4096": dict(threads=512, slots=3, memo_log2=12)}
QUEUE_SLEEP_CYCLES = 39_600_000
# The loop's phases, in order; then the counters: the survivors and the
# rows read by the timed block, and its iterations.
PHASES = ("select", "expand + labels", "in-beam dedup", "in-row dedup", "memo", "score",
          "rank", "window merge", "beam merge")
N_SURV, N_READ, N_ITERS = 12, 13, 15

# What ``instrument`` puts in front of the kernel: the counters, thread 0
# of block g_phase_block's clock, and the macros the kernel's phase marks
# call (a kernel without marks gets them at ANCHORS).
HEADER = r"""
__device__ unsigned long long g_phase[16];
__device__ int g_phase_block;
#define PGVS_PHASE_INIT                                                          \
  __shared__ unsigned long long phase_[16];                                     \
  if (threadIdx.x < 16) phase_[threadIdx.x] = 0;                                \
  long long t_last_ = clock64(), t_split_ = 0, split_acc_ = 0;                   \
  const bool timing_ = threadIdx.x == 0 && blockIdx.x == g_phase_block;
#define PGVS_PHASE(k)                                                            \
  do {                                                                           \
    if (timing_) {                                                               \
      const long long t_ = clock64();                                            \
      phase_[k] += t_ - t_last_ - split_acc_;                                    \
      split_acc_ = 0;                                                            \
      t_last_ = t_;                                                              \
    }                                                                            \
  } while (0)
#define PGVS_SPLIT_BEGIN                                                         \
  do {                                                                           \
    if (timing_) t_split_ = clock64();                                           \
  } while (0)
#define PGVS_SPLIT_END(k)                                                        \
  do {                                                                           \
    if (timing_) {                                                               \
      const long long d_ = clock64() - t_split_;                                 \
      phase_[k] += d_;                                                           \
      split_acc_ += d_;                                                          \
    }                                                                            \
  } while (0)
#define PGVS_PHASE_ADD(k, n)                                                     \
  do {                                                                           \
    if (timing_) phase_[k] += (n);                                               \
  } while (0)
#define PGVS_PHASE_SAVE(it)                                                      \
  do {                                                                           \
    if (timing_) {                                                               \
      for (int k_ = 0; k_ < 15; ++k_) g_phase[k_] = phase_[k_];                  \
      g_phase[15] = (it);                                                        \
    }                                                                            \
  } while (0)
"""
READER = r"""
extern "C" int pgvs_phase_read(unsigned long long* out, int block) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, g_phase, sizeof(unsigned long long) * 16);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_block, &block, sizeof(int));
  return static_cast<int>(err);
}
"""
# The marks of the kernel before the memo, which has none in its source:
# (anchor, text, put before the anchor).  Its survivors are all read.
ANCHORS = [
    ("  const bool narrow = er <= kNarrowRow;\n", "  PGVS_PHASE_INIT\n", False),
    ("    n_vis += nact;\n    __syncthreads();\n", "    PGVS_PHASE(0);\n", False),
    ("      if (v) {\n        bool hit = false;\n", "      PGVS_SPLIT_BEGIN;\n", True),
    ("        v = !hit;\n      }\n", "      PGVS_SPLIT_END(2);\n", False),
    ("      fid[i] = v ? nbv : -1;\n    }\n    __syncthreads();\n", "    PGVS_PHASE(1);\n",
     False),
    ("    __syncthreads();\n    n_comps += nf;\n",
     "    PGVS_PHASE(3);\n    PGVS_PHASE(4);\n    PGVS_PHASE_ADD(12, nf);\n"
     "    PGVS_PHASE_ADD(13, nf);\n", False),
    ("        if (lane == 0) kd[c] = d;\n      }\n    }\n    __syncthreads();\n",
     "    PGVS_PHASE(5);\n", False),
    ("      cs_t[rank] = nb[c];\n    }\n    __syncthreads();\n", "    PGVS_PHASE(6);\n", False),
    ("    if (wn > 0) merge_row(win_d, win_t, wn, cs_d, cs_t, nf, er, -1, md, mt);\n",
     "    PGVS_PHASE(7);\n", False),
    ("    merge_row(beam_d, beam_t, l, cs_d, cs_t, nf, er, -2, md, mt);\n",
     "    PGVS_PHASE(8);\n", False),
    ("  if (tid == 0) {\n    p.n_visited[q] = n_vis;", "  PGVS_PHASE_SAVE(it);\n", True),
]


def instrument(src: str) -> str:
    """The kernel's source with the phase timers on."""
    out = src
    if "PGVS_PHASE_INIT" not in out:
        for anchor, text, before in ANCHORS:
            if out.count(anchor) != 1:
                raise SystemExit(f"beam_search_full.cu changed: {anchor!r} is not there once")
            out = out.replace(anchor, text + anchor if before else anchor + text)
    inc = '#include "rowdist.cuh"\n'
    if out.count(inc) != 1:
        raise SystemExit("beam_search_full.cu does not include rowdist.cuh once")
    return out.replace(inc, inc + HEADER) + READER


def build_all(parent: Path, new: Path, out_dir: Path) -> dict:
    """Start every nvcc at once; return name -> (library path, ptxas lines)."""
    nvcc = _build.find_nvcc()
    flags = list(_build.NVCC_FLAGS)
    sources = {"parent": parent, "new": new}
    jobs = {}
    for name, src_dir in sources.items():
        jobs[name] = [*flags, "-o", str(out_dir / f"lib_{name}.so"),
                      str(src_dir / "beam_search_full.cu")]
        work = out_dir / f"{name}_phases"
        work.mkdir(parents=True, exist_ok=True)
        for header in src_dir.glob("*.cuh"):
            (work / header.name).write_text(header.read_text())
        (work / "beam_search_full.cu").write_text(
            instrument((src_dir / "beam_search_full.cu").read_text()))
        jobs[f"{name}_phases"] = [*flags, "-o", str(out_dir / f"lib_{name}_phases.so"),
                                  str(work / "beam_search_full.cu")]
    jobs["sm_read_rate"] = ["-O3", "-gencode", "arch=compute_90a,code=sm_90a", "-o",
                            str(out_dir / "sm_read_rate"),
                            str(ROOT / "microbench" / "sm_read_rate.cu")]
    procs = {k: subprocess.Popen([nvcc, *v], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True) for k, v in jobs.items()}
    built = {}
    for name, proc in procs.items():
        text, _ = proc.communicate(timeout=_build.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{text}")
        path = jobs[name][jobs[name].index("-o") + 1]
        built[name] = (path, [ln for ln in text.splitlines() if "ptxas" in ln or "spill" in ln])
    return built


def bind_before_memo(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C interface of the kernel before the memo."""
    fn = lib.pgvs_beam_search_full
    fn.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 14 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.pgvs_beam_search_full_state_bytes.argtypes = [ctypes.c_int] * 4
    lib.pgvs_beam_search_full_state_bytes.restype = ctypes.c_longlong
    lib.pgvs_beam_search_full_query_bytes.argtypes = [ctypes.c_int]
    lib.pgvs_beam_search_full_query_bytes.restype = ctypes.c_longlong
    return lib


def launch_before_memo(lib, arrays, qv, starts, ql, *, search_list_size, max_iters,
                       expand_factor, track_hist, window_n, distance_type):
    """One launch through the interface before the memo: (outputs, iters)."""
    q, s = starts.shape
    l, h, e = search_list_size, max_iters, expand_factor
    vecs = arrays.vectors
    cap, d = vecs.shape
    dt, r, lq = qv.shape[1], arrays.adjacency.shape[1], ql.shape[1]
    i32, f32 = dict(dtype=torch.int32, device="cuda"), dict(dtype=torch.float32, device="cuda")
    h_cap, wn = (h if track_hist else 1), max(window_n, 1)
    out = dict(beam_ids=torch.empty((q, l), **i32), beam_dists=torch.empty((q, l), **f32),
               beam_visited=torch.empty((q, l), dtype=torch.bool, device="cuda"),
               hist_ids=torch.empty((q, h_cap), **i32), hist_dists=torch.empty((q, h_cap), **f32),
               n_visited=torch.empty(q, **i32), n_dist_comps=torch.empty(q, **i32),
               window_ids=torch.empty((q, wn), **i32), window_dists=torch.empty((q, wn), **f32))
    iters = torch.empty(q, **i32)
    state = lib.pgvs_beam_search_full_state_bytes(l, window_n, e, r)
    state_shared, query_shared = bsf.placement(
        state, lib.pgvs_beam_search_full_query_bytes(dt), _build.MAX_SHARED_BYTES)
    scratch = None if state_shared else torch.empty(q * state, dtype=torch.uint8, device="cuda")
    int8 = vecs.dtype == torch.int8
    err = lib.pgvs_beam_search_full(
        vecs.data_ptr(), arrays.vec_scales.data_ptr() if int8 else None,
        arrays.adjacency.data_ptr(), arrays.node_labels.data_ptr() if lq else None,
        qv.data_ptr(), starts.data_ptr(), ql.data_ptr(),
        *(out[f].data_ptr() for f in bsf.RESULT_FIELDS), iters.data_ptr(),
        None if scratch is None else scratch.data_ptr(), q, cap, d, dt,
        bsf.ROW_DTYPES[vecs.dtype], int(distance_type), r, arrays.node_labels.shape[1] if lq else 0,
        s, lq, l, h, int(track_hist), e, window_n, int(query_shared),
        torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise SystemExit(f"launch failed: CUDA error {err}")
    return out, iters


class Build:
    """One library and the launch of its interface."""

    def __init__(self, path: str):
        lib = ctypes.CDLL(path)
        self.memo = hasattr(lib, "pgvs_beam_search_full_ring_bytes")
        self.lib = bsf.bind(lib) if self.memo else bind_before_memo(lib)
        if hasattr(lib, "pgvs_phase_read"):
            lib.pgvs_phase_read.argtypes = [ctypes.c_void_p, ctypes.c_int]

    def run(self, args, kw, rows_read=None, **shape):
        if self.memo:
            return bsf.launch(*args, lib=self.lib, rows_read=rows_read, **shape, **kw)
        return launch_before_memo(self.lib, *args, **kw)

    def result(self, args, kw) -> SearchResult:
        out, iters = self.run(args, kw)
        return SearchResult(iters=int(iters.max()), **out)


def timed_ms(fn) -> float:
    """Mean device time of TIMED_CALLS calls of ``fn``, between CUDA events
    queued behind a device sleep (so the host's launch pace does not show)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = QUEUE_SLEEP_CYCLES
    for _ in range(4):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(TIMED_CALLS):
            fn()
        end.record()
        if not start.query():
            torch.cuda.synchronize()
            return start.elapsed_time(end) / TIMED_CALLS
        cycles *= 4
    raise SystemExit("the device sleep ended before the calls were queued")


def phases(build: Build, args, kw, block: int) -> dict:
    """Cycles an iteration of each phase for thread 0 of ``block``."""
    buf = torch.zeros(16, dtype=torch.int64)
    lib = build.lib
    if lib.pgvs_phase_read(buf.data_ptr(), block) != 0:
        raise SystemExit("reading the phase counters failed")
    build.run(args, kw)
    if lib.pgvs_phase_read(buf.data_ptr(), block) != 0:
        raise SystemExit("reading the phase counters failed")
    v = buf.tolist()
    it = max(v[N_ITERS], 1)
    per = {name: v[k] / it for k, name in enumerate(PHASES)}
    total = sum(per.values())
    return dict(block=block, iters=v[N_ITERS], cycles_per_iter=per, total_cycles_per_iter=total,
                share={k: x / total for k, x in per.items()} if total else {},
                survivors_per_iter=v[N_SURV] / it, rows_read_per_iter=v[N_READ] / it)


def capture_built(vectors, queries) -> dict:
    """The arguments of the plain-storage index's search and of wave WAVE of
    an "exact" build (a copy of the adjacency as that wave read it)."""
    from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig, QueryParams
    from pgvectorscale_tpu_torch.config import StorageLayout
    from pgvectorscale_tpu_torch.graph import search

    real = search.beam_search_full
    calls, waves, target = [], [0], [-1]  # target: the wave recorded, None: every call

    def record(arrays, qv, starts, ql=None, **kw):
        if target[0] is None or waves[0] == target[0]:
            labels = ql if ql is not None else torch.zeros(
                (qv.shape[0], 0), dtype=torch.int32, device=qv.device)
            calls.append((arrays._replace(adjacency=arrays.adjacency.clone()), qv.clone(),
                          starts.clone(), labels, dict(kw)))
        return real(arrays, qv, starts, ql, **kw)

    def progress(stage, done, total):
        if stage == "inserting tuples":
            waves[0] += 1

    search.beam_search_full = record
    try:
        d = vectors.shape[1]
        plain = DiskannIndex.build(vectors, IndexConfig(num_dimensions=d,
                                                        storage_layout=StorageLayout.PLAIN))
        target[0] = None
        qdev = torch.as_tensor(queries).cuda()
        plain.search(qdev, 10, QueryParams(search_list_size=100, rescore=50))
        torch.cuda.synchronize()
        if len(calls) != 1:
            raise SystemExit(f"the plain index's search made {len(calls)} beam searches")
        out = {"built search": calls.pop()}
        del plain
        target[0] = WAVE - 1
        DiskannIndex.build(vectors, IndexConfig(num_dimensions=d, build_distance="exact"),
                           progress_callback=progress)
        torch.cuda.synchronize()
        if len(calls) != 1:
            raise SystemExit(f"wave {WAVE} of the exact build made {len(calls)} searches")
        out[f"exact wave {WAVE}"] = calls.pop()
    finally:
        search.beam_search_full = real
    return out


def search_kwargs(kw: dict) -> dict:
    keys = ("search_list_size", "max_iters", "expand_factor", "track_hist", "window_n",
            "distance_type")
    return {k: kw[k] for k in keys}


def main() -> None:
    args = sys.argv[1:]
    out_path = ROOT / "microbench" / "_out" / "beam_full_ab.json"
    if "--out" in args:
        i = args.index("--out")
        out_path = Path(args[i + 1])
        del args[i:i + 2]
    new_dir = _build.CSRC
    if "--new" in args:
        i = args.index("--new")
        new_dir = Path(args[i + 1])
        del args[i:i + 2]
    parent = Path(args[0]) if args else ROOT / "microbench" / "_parent"
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build_dir = ROOT / "microbench" / "_out" / "beam_full_ab_build"
    build_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    built = build_all(parent, new_dir, build_dir)
    print(f"built in {time.perf_counter() - t0:.2f}s", flush=True)
    for name, (_, ptxas) in built.items():
        for line in ptxas:
            print(f"  {name}: {line}", flush=True)
    rate = json.loads(subprocess.run([built.pop("sm_read_rate")[0]], capture_output=True,
                                     text=True, timeout=300, check=True).stdout)
    print(f"sm_read_rate: {json.dumps(rate)}", flush=True)
    builds = {k: Build(v[0]) for k, v in built.items()}
    out = {"card": smi, "ptxas": {k: v[1] for k, v in built.items()}, "sm_read_rate": rate,
           "shapes": {}}

    from pgvectorscale_tpu_torch.io.datasets import synthetic_corpus

    g = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = {}
    arrays, qv, starts, ql = bsf.check_inputs(q=4096, cap=CAP, d=768, r=65, values=0,
                                              invalid_share=INVALID_SHARE, device="cuda",
                                              generator=g)
    shapes["search"] = (arrays, qv[:NQ], starts[:NQ], ql[:NQ], SEARCH)
    shapes["build wave"] = (arrays, qv, starts, ql, dict(SEARCH, track_hist=True))
    shapes["one query"] = (arrays, qv[:1], starts[:1], ql[:1], SEARCH)
    vectors, queries = synthetic_corpus("cohere", N, NQ, seed=CORPUS_SEED)
    captured = capture_built(np.ascontiguousarray(vectors), queries)
    a, q_, s_, l_, kw = captured["built search"]
    shapes["built search"] = (a, q_, s_, l_, search_kwargs(kw))
    shapes["built one query"] = (a, q_[:1], s_[:1], l_[:1], search_kwargs(kw))
    a, q_, s_, l_, kw = captured[f"exact wave {WAVE}"]
    shapes[f"exact wave {WAVE}"] = (a, q_, s_, l_, search_kwargs(kw))

    for shape, (arrays, qv, starts, ql, kw) in shapes.items():
        call = (arrays, qv, starts, ql)
        plain, distinct = bsf.distinct_scored_plain(*call, **kw)
        rec = {"q": qv.shape[0], "search": {k: str(v) for k, v in kw.items()},
               "iters": plain.iters}
        results = {name: builds[name].result(call, kw) for name in ("parent", "new")}
        # Float rows: a near-tie that rounding orders the other way can send
        # a query down another path, so closeness is reported, not required.
        rec["close_to_plain"] = {k: bsf.results_close(v, plain) for k, v in results.items()}
        rec["parent_new_differ"] = bsf.results_equal(results["parent"], results["new"])
        comps = int(plain.n_dist_comps.sum())
        rec.update(scored=comps, distinct=int(distinct.sum()),
                   repeat_share=1 - int(distinct.sum()) / max(comps, 1),
                   kernel_n_dist_comps_equal=bool(torch.equal(results["new"].n_dist_comps,
                                                              plain.n_dist_comps)))
        if builds["new"].memo:
            rows_read = torch.zeros(qv.shape[0], dtype=torch.int32, device="cuda")
            builds["new"].run(call, kw, rows_read=rows_read)
            torch.cuda.synchronize()
            rec["rows_read"] = int(rows_read.sum())
            rec["rows_read_equal_distinct"] = bool(torch.equal(rows_read, distinct))
        times = {"parent": [], "new": []}
        for name in ("parent", "new", "new", "parent"):
            b = builds[name]
            times[name].append(timed_ms(lambda: b.run(call, kw)))
        rec["ms"] = times
        rec["speedup"] = sum(times["parent"]) / sum(times["new"])
        if builds["new"].memo:
            variants = ALONE_VARIANTS if qv.shape[0] == 1 else BATCH_VARIANTS
            b = builds["new"]
            rec["variants_ms"], rec["variants_differ"] = {}, {}
            for name, over in variants.items():
                out_v, iters_v = b.run(call, kw, **over)
                rec["variants_differ"][name] = bsf.results_equal(
                    SearchResult(iters=int(iters_v.max()), **out_v), results["new"])
                rec["variants_ms"][name] = [timed_ms(lambda: b.run(call, kw, **over))
                                            for _ in range(2)]
        blocks = (0,) if qv.shape[0] == 1 else (0, qv.shape[0] // 2)
        rec["phases"] = {name: [phases(builds[f"{name}_phases"], call, kw, b) for b in blocks]
                         for name in ("parent", "new")}
        out["shapes"][shape] = rec
        print(f"{shape}: {json.dumps(rec)}", flush=True)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
