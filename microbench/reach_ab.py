"""Time two builds of the reachability BFS kernel on one card, in turns, and
split each BFS by level.

Usage, from the repository root on a machine with an NVIDIA GPU:

    python3 microbench/reach_ab.py [<parent dir>] [--new <dir>] [--out <json path>]
                                   [--graphs a,b] [--variant NAME=-DX=1,...]

``<parent dir>`` holds another commit's ``reachable.cu`` (for example
``git show <commit>:pgvectorscale_tpu_torch/csrc/reachable.cu``), default
``microbench/_parent``; ``--new`` the source that stands for this
checkout's (default its ``csrc/``).  The script builds, with one nvcc each,
all started together: both as the port builds them, both with block 0's
stamps (``-DPGVS_REACH_STAMPS=1``: ``clock64`` and ``%globaltimer`` at the
kernel's entry, each phase's start, each grid barrier's arrival and
release, each one-block and one-warp level, each refresh of the
shared-memory bitmap and the output pass's end) and both with per-level
counters (``-DPGVS_REACH_COUNTS=1``: the bitmap atomics, the fresh claims
and the queue or count atomics, a level each; a separate build, since the
counting perturbs the times), and any ``--variant`` build of the new
source.  A source without the hooks (the parent's) gets them by the text
anchors below.  It prints each build's ``-Xptxas -v`` lines.

The graphs: ``chip_smoke.py`` phase 2's "random 1M" (1,000,448 x 65, 23%
of the slots empty), "chain" (a 1,000-level chain over 100k) and
"islands"; a random 100,000 x 65 graph (the finalize and add shape of the
100k builds), the adjacency of a built 100k exact-prune index (the
seeded "cohere" corpus, 768 wide) and phase 2's "random 2M" (above the
shared-memory bitmap's limit: the new kernel probes the bitmap in L2).  At each, every build's result must
equal ``reachable_scatter_plain``'s and ``reachable_csr_plain``'s; then
the parent and the new build are timed in turns (parent, new, new,
parent), each the mean of 10 launches between CUDA events queued behind a
device sleep (``microbench/beam_ab.py``'s ``timed_ms``), each variant
twice.  Per level: the frontier, the slots, the ids probed (in ``[0,
count)``) and the claims (a plain level-by-level BFS), each build's bitmap
atomics, claims and queue or count atomics (its counters), and each
stamped build's split (block 0's view: the time from one stamp to the
next, by stamp).  Prints the card's name and power limit first, a line a
graph, and one JSON line with everything at the end, also written to
``--out`` (default ``microbench/_out/reach_ab.json``, where the builds go
too).
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
sys.path.insert(0, str(ROOT / "microbench"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from beam_ab import timed_ms  # noqa: E402
from chip_smoke import (HBM_BYTES_PER_S, HBM_READ_NS, INVALID_EDGE_SHARE, ORPHANS,  # noqa: E402
                        SCALE_CAP, SEED)
from pgvectorscale_tpu_torch.ops import _build  # noqa: E402
from pgvectorscale_tpu_torch.ops import reachable as rc  # noqa: E402

# The layout of the debug buffer both instrumented sources write
# (``pgvs_reachable_debug`` copies it out and zeroes it): the stamps taken,
# MAX_STAMPS stamps of 3 words (tag << 56 | level << 32 | n, clock64,
# %globaltimer), then MAX_LEVELS levels of 4 counters.
MAX_STAMPS, MAX_LEVELS = 4096, 1100
COUNTERS = ("bitmap atomics", "claims", "queue or count atomics", "rows expanded")
STAMPS = {0: "entry", 1: "barrier arrive", 2: "barrier release", 3: "phase start",
          4: "one-block level", 5: "one-warp level", 6: "output end", 7: "bitmap copied",
          8: "queue gathered"}
SM_HZ = 1.98e9  # clocks.max.sm of an H100 SXM: cycles to microseconds

# What a source without the hooks gets in front of its kernel: the debug
# buffer, the stamp and the counters, live only under their flags.
HEADER = r"""
#if PGVS_REACH_STAMPS || PGVS_REACH_COUNTS
__device__ unsigned long long g_reach_debug[1 + 3 * 4096 + 4 * 1100];
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
#if PGVS_REACH_STAMPS
__device__ __forceinline__ void pgvs_stamp(unsigned tag, unsigned level, unsigned n) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned long long i = g_reach_debug[0]++;
  if (i >= 4096) return;
  g_reach_debug[1 + 3 * i] = (static_cast<unsigned long long>(tag) << 56) |
                             (static_cast<unsigned long long>(level & 0xffffffu) << 32) | n;
  g_reach_debug[2 + 3 * i] = clock64();
  g_reach_debug[3 + 3 * i] = t;
}
#define PGVS_STAMP(tag, level, n) pgvs_stamp(tag, level, n)
#else
#define PGVS_STAMP(tag, level, n) ((void)0)
#endif
#if PGVS_REACH_COUNTS
__device__ __forceinline__ void pgvs_count(int level, int k, unsigned n) {
  atomicAdd(&g_reach_debug[1 + 3 * 4096 + 4 * (level < 1099 ? level : 1099) + k],
            static_cast<unsigned long long>(n));
}
#define PGVS_COUNT(level, k, n) pgvs_count(level, k, n)
#define PGVS_COUNT_WARP(level, k, pred)                                       \
  do {                                                                        \
    const unsigned c_ = __popc(__ballot_sync(0xffffffffu, pred));             \
    if ((threadIdx.x & 31) == 0 && c_) pgvs_count(level, k, c_);             \
  } while (0)
#else
#define PGVS_COUNT(level, k, n) ((void)0)
#define PGVS_COUNT_WARP(level, k, pred) ((void)0)
#endif
"""
# The parent's hooks: (text, its replacement), each text there once.
PARENT_MARKS = [
    ("#include <stdint.h>\n", "#include <stdint.h>\n" + HEADER),
    ("    const unsigned old = atomicAdd(arrived, add);\n",
     "    PGVS_STAMP(1, 0, 0);\n    const unsigned old = atomicAdd(arrived, add);\n"),
    ("    while (((old ^ load_volatile(arrived)) & 0x80000000u) == 0) __nanosleep(32);\n",
     "    while (((old ^ load_volatile(arrived)) & 0x80000000u) == 0) __nanosleep(32);\n"
     "    PGVS_STAMP(2, 0, 0);\n"),
    ("int* next, unsigned* next_count, int lane) {",
     "int* next, unsigned* next_count, int lane, int level_) {"),
    ("    bool fresh = false;\n    if (v >= 0 && v < p.count) {",
     "    bool fresh = false, tried_ = false;\n    if (v >= 0 && v < p.count) {"),
    ("      if (!(__ldcg(word) & bit)) fresh = !(atomicOr(word, bit) & bit);",
     "      if (!(__ldcg(word) & bit)) {\n        tried_ = true;\n"
     "        fresh = !(atomicOr(word, bit) & bit);\n      }"),
    ("    const unsigned mask = __ballot_sync(kFull, fresh);",
     "    PGVS_COUNT_WARP(level_, 0, tried_);\n    PGVS_COUNT_WARP(level_, 1, fresh);\n"
     "    const unsigned mask = __ballot_sync(kFull, fresh);"),
    ("      if (lane == 0) base = atomicAdd(",
     "      if (lane == 0) PGVS_COUNT(level_, 2, 1);\n      if (lane == 0) base = atomicAdd("),
    ("expand_row(p, __ldcg(cur + i), next, s_count, lane);",
     "expand_row(p, __ldcg(cur + i), next, s_count, lane, level);\n"
     "    if (threadIdx.x == 0) PGVS_COUNT(level, 3, n);"),
    ("    n = *s_count;\n    ++level;\n",
     "    n = *s_count;\n    ++level;\n    PGVS_STAMP(4, level, n);\n"),
    ("  const long long gwarp", "  PGVS_STAMP(0, 0, 0);\n  const long long gwarp"),
    ("    const unsigned n = load_volatile(counts + phase % 3);\n",
     "    const unsigned n = load_volatile(counts + phase % 3);\n    PGVS_STAMP(3, phase, n);\n"),
    ("expand_row(p, __ldcg(cur + i), next, counts + (phase + 1) % 3, lane);",
     "expand_row(p, __ldcg(cur + i), next, counts + (phase + 1) % 3, lane, level);\n"
     "    if (blockIdx.x == 0 && threadIdx.x == 0) PGVS_COUNT(level, 3, n);"),
    ("    p.out[v] = (__ldcg(p.bitmap + (v >> 5)) >> (v & 31)) & 1u;\n}",
     "    p.out[v] = (__ldcg(p.bitmap + (v >> 5)) >> (v & 31)) & 1u;\n  PGVS_STAMP(6, 0, 0);\n}"),
]


def instrument(src: str) -> str:
    """The source with the stamp and counter hooks (a source that has them
    is returned as it is)."""
    if "PGVS_REACH_STAMPS" in src:
        return src
    for text, repl in PARENT_MARKS:
        if src.count(text) != 1:
            raise SystemExit(f"reachable.cu changed: {text!r} is not there once")
        src = src.replace(text, repl)
    return src


def build_all(parent: Path, new: Path, out_dir: Path, variants: dict) -> dict:
    """Start every nvcc at once; return name -> (library path, ptxas lines)."""
    nvcc = _build.find_nvcc()
    flags = list(_build.NVCC_FLAGS)
    jobs = {}
    for name, src_dir in (("parent", parent), ("new", new)):
        src = out_dir / f"{name}.cu"
        src.write_text(instrument((src_dir / "reachable.cu").read_text()))
        jobs[name] = [*flags, "-o", str(out_dir / f"lib_{name}.so"), str(src)]
        for mode in ("stamps", "counts"):
            jobs[f"{name}_{mode}"] = [*flags, f"-DPGVS_REACH_{mode.upper()}=1", "-o",
                                      str(out_dir / f"lib_{name}_{mode}.so"), str(src)]
    for name, defines in variants.items():
        jobs[name] = [*flags, *defines, "-o", str(out_dir / f"lib_{name}.so"),
                      str(out_dir / "new.cu")]
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


class Build:
    """One library of either C interface: the parent's (two queues of
    ``count`` ids) or the one with a stash (``pgvs_reachable_stash_words``),
    which ``ops.reachable.launch`` drives."""

    def __init__(self, path: str):
        self.cdll = ctypes.CDLL(path)
        self.stash = hasattr(self.cdll, "pgvs_reachable_stash_words")
        if self.stash:
            self.lib = rc.bind(self.cdll)
        else:
            fn = self.cdll.pgvs_reachable
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            words = self.cdll.pgvs_reachable_zeroed_words
            words.argtypes = [ctypes.c_int]
            words.restype = ctypes.c_longlong
            self.lib = (fn, words)
        self.debug = getattr(self.cdll, "pgvs_reachable_debug", None)
        if self.debug is not None:
            self.debug.argtypes = [ctypes.c_void_p]

    def launch(self, adj, count, start):
        """(bool[cap], the scratch head)."""
        if self.stash:
            return rc.launch(adj, count, start, lib=self.lib)
        fn, words = self.lib
        cap, r = adj.shape
        out = torch.empty((cap,), dtype=torch.bool, device=adj.device)
        head = torch.zeros((words(cap),), dtype=torch.int32, device=adj.device)
        queues = torch.empty((2 * max(count, 1),), dtype=torch.int32, device=adj.device)
        err = fn(adj.data_ptr(), out.data_ptr(), head.data_ptr(), queues.data_ptr(), cap, r,
                 count, start, 0, adj.device.index or 0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")
        return out, head

    def read_debug(self) -> list[int]:
        buf = torch.zeros(1 + 3 * MAX_STAMPS + 4 * MAX_LEVELS, dtype=torch.int64)
        if self.debug(buf.data_ptr()) != 0:
            raise SystemExit("reading the debug buffer failed")
        return [v & (2**64 - 1) for v in buf.tolist()]


def plain_levels(adj, count: int, start: int) -> list[dict]:
    """A level-by-level BFS: each level's frontier, slots, ids probed (in
    ``[0, count)``) and claims (the next frontier)."""
    cap, r = adj.shape
    if not 0 <= start < count:
        return []
    seen = torch.zeros(cap, dtype=torch.bool, device=adj.device)
    seen[start] = True
    frontier = torch.tensor([start], device=adj.device)
    out = []
    while frontier.numel():
        ids = adj[frontier].reshape(-1)
        ids = ids[(ids >= 0) & (ids < count)].long()
        new = torch.unique(ids)
        new = new[~seen[new]]
        seen[new] = True
        out.append(dict(frontier=frontier.numel(), slots=frontier.numel() * r,
                        probed=ids.numel(), claims=new.numel()))
        frontier = new
    return out


def split(words: list[int]) -> dict:
    """Block 0's stamps as steps: each stamp, the time since the one before
    it (microseconds at SM_HZ and by %globaltimer), summed by stamp."""
    n = min(words[0], MAX_STAMPS)
    steps, by = [], {}
    prev = None
    for i in range(n):
        head, clk, ns = words[1 + 3 * i: 4 + 3 * i]
        tag, level, val = head >> 56, (head >> 32) & 0xffffff, head & 0xffffffff
        if prev is not None:
            us = (clk - prev[0]) / SM_HZ * 1e6
            steps.append(dict(stamp=STAMPS.get(tag, str(tag)), level=level, n=val,
                              us=round(us, 4), timer_us=round((ns - prev[1]) / 1e3, 4)))
            by[steps[-1]["stamp"]] = by.get(steps[-1]["stamp"], 0.0) + us
        prev = (clk, ns)
    return dict(stamps=n, by_stamp_us={k: round(v, 4) for k, v in by.items()},
                total_us=round(sum(by.values()), 4), steps=steps)


def counts(words: list[int]) -> list[dict]:
    base = 1 + 3 * MAX_STAMPS
    out = []
    for lv in range(MAX_LEVELS):
        c = words[base + 4 * lv: base + 4 * lv + 4]
        if any(c):
            out.append(dict(level=lv, **dict(zip(COUNTERS, c))))
    return out


def built_graph():
    """The adjacency of a built 100k exact-prune index (``profile_main_path.py``'s)."""
    from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig
    from pgvectorscale_tpu_torch.io.datasets import synthetic_corpus

    vectors, _ = synthetic_corpus("cohere", 100_000, 1, seed=0)
    index = DiskannIndex.build(np.ascontiguousarray(vectors),
                               IndexConfig(num_dimensions=vectors.shape[1]))
    a = index.arrays
    return a.adjacency, a.count, a.default_start


def main() -> None:
    args = sys.argv[1:]

    def option(name, default):
        if name in args:
            i = args.index(name)
            value = args[i + 1]
            del args[i:i + 2]
            return value
        return default

    out_path = Path(option("--out", ROOT / "microbench" / "_out" / "reach_ab.json"))
    new_dir = Path(option("--new", _build.CSRC))
    only = option("--graphs", None)
    variants = {}
    while "--variant" in args:
        name, _, defines = option("--variant", "").partition("=")
        variants[name] = defines.split(",")
    parent = Path(args[0]) if args else ROOT / "microbench" / "_parent"
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    build_dir = ROOT / "microbench" / "_out" / "reach_ab_build"
    build_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    built = build_all(parent, new_dir, build_dir, variants)
    print(f"built in {time.perf_counter() - t0:.2f}s", flush=True)
    for name, (_, ptxas) in built.items():
        for line in ptxas:
            print(f"  {name}: {line}", flush=True)
    builds = {k: Build(v[0]) for k, v in built.items()}
    out = {"card": smi, "ptxas": {k: v[1] for k, v in built.items()}, "graphs": {}}

    g = torch.Generator(device="cuda").manual_seed(SEED + 21)

    def case(kind, cap, **kw):
        return lambda: rc.graph_case(kind, cap, 65, "cuda", g, **kw)

    graphs = {
        "random 1M": case("random", SCALE_CAP, invalid_share=INVALID_EDGE_SHARE),
        "chain": case("chain", 100_000, levels=ORPHANS),
        "islands": case("islands", 100_000, count=90_000),
        "random 100k": case("random", 100_000, invalid_share=INVALID_EDGE_SHARE),
        "built 100k": built_graph,
        "random 2M": case("random", 2_000_000, invalid_share=INVALID_EDGE_SHARE),
    }
    names = ["parent", "new", *variants]
    for gname, make in graphs.items():
        if only and gname not in only.split(","):
            continue
        adj, count, start = make()
        cap, r = adj.shape
        want = rc.reachable_scatter_plain(adj, count, start)
        csr = rc.reachable_csr_plain(adj, count, start)
        rec = dict(cap=cap, r=r, count=count, start=start, reached=int(want.sum()),
                   plain_equal=bool(torch.equal(want, csr)), equal={}, levels={})
        for n, b in builds.items():
            got, head = b.launch(adj, count, start)
            torch.cuda.synchronize()
            rec["equal"][n] = bool(torch.equal(got, want))
            rec["levels"][n] = rc.levels(head)
            if not rec["equal"][n]:
                raise SystemExit(f"{n} differs from the plain BFS at {gname}")
        times = {n: [] for n in names}
        for n in ("parent", "new", "new", "parent", *(v for v in variants for _ in range(2))):
            b = builds[n]
            times[n].append(timed_ms(lambda: b.launch(adj, count, start)))
        rec["ms"] = times
        rec["mean_ms"] = {n: sum(t) / len(t) for n, t in times.items()}
        rec["speedup"] = sum(times["parent"]) / sum(times["new"])
        rec["bound_ms"] = rc.bound_bytes(cap, r, rec["reached"]) / HBM_BYTES_PER_S * 1e3
        rec["plain_levels"] = plain_levels(adj, count, start)
        rec["chain_bound_ms"] = len(rec["plain_levels"]) * HBM_READ_NS * 1e-6
        rec["split"], rec["counts"] = {}, {}
        for n in ("parent", "new"):
            sb, cb = builds[f"{n}_stamps"], builds[f"{n}_counts"]
            sb.read_debug()
            sb.launch(adj, count, start)
            rec["split"][n] = split(sb.read_debug())
            cb.read_debug()
            cb.launch(adj, count, start)
            rec["counts"][n] = counts(cb.read_debug())
        out["graphs"][gname] = rec
        brief = {k: rec[k] for k in ("cap", "count", "reached", "mean_ms", "speedup", "bound_ms",
                                     "chain_bound_ms", "levels")}
        brief["by_stamp_us"] = {n: s["by_stamp_us"] for n, s in rec["split"].items()}
        brief["plain_levels"] = rec["plain_levels"][:12]
        brief["counts"] = {n: c[:12] for n, c in rec["counts"].items()}
        print(f"{gname}: {json.dumps(brief)}", flush=True)
        del adj, want, csr
        torch.cuda.empty_cache()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k != "graphs"}), flush=True)


if __name__ == "__main__":
    main()
