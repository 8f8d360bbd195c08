"""Time two builds of the streaming iterator's kernel on one card, in turns,
and time one step of each by phase.

Usage, from the repository root on a machine with an NVIDIA GPU:

    python3 microbench/iter_ab.py [<parent dir>] [--new <dir>] [--out <json path>]

``<parent dir>`` holds another commit's ``iter_step.cu``, ``hamming.cuh``
and ``rowdist.cuh`` (for example ``git show <commit>:pgvectorscale_tpu_torch/
csrc/iter_step.cu``), default ``microbench/_parent``; ``--new`` the sources
that stand for this checkout's (default its ``csrc/``).  Both builds share
the C interface (``pgvs_iter_step``, ``pgvs_iter_step_state_bytes``,
``pgvs_iter_step_query_bytes``), so ``ops.iter_step.bind`` and ``launch``
drive either.  The script builds, with one nvcc each, all started
together: the parent and this checkout as the port builds them, both
again with the phase stamps put in (``instrument``: thread 0's
``clock64`` between the points of a step listed in ``PHASES``, a phase's
cycles including its waits at the barrier that ends it), and this
checkout with blocks of ``ALT_THREADS`` threads (and any ``--variant
NAME=-DX=1,...`` builds of this checkout); it prints each build's
``-Xptxas -v`` lines and each kernel's instructions and the bytes of its
largest loop (``cuobjdump -sass``).  ``--shapes a,b`` runs only those
refills.

The refills: ``chip_smoke.py`` phase 2's "stream" (1 bit a
dim of 768, W = 24 codes over 1,000,448 slots, R = 65, frontier 256,
emit_n 128, budget 512, from a fresh state) and "wide R=260" shapes, the
stream's refill with the state in the scratch buffer, a refill deep into
the stream (emit_n 1,024, budget 4,096, after refills of 128, 256 and
512), a full-precision refill (768 integer f32 rows, L2), and a refill on
a built index (``profile_main_path.py``'s exact-prune 100k x 768
"cohere" index, its first query's second refill).  At each, every build's
refill (``graph.iterate.iter_step_kernel``) is compared with
``iter_step_plain`` and with the others bit for bit (the fields that
differ, reported); then the parent and this checkout are timed in turns
(parent, new, new, parent), each the mean of 10 launches between CUDA
events queued behind a device sleep (``microbench/beam_ab.py``'s
``timed_ms``), and each other build twice.  Per build with stamps: the
cycles a step by phase (thread 0's) and the survivors a step; for a
build that marks them (this checkout's kernel), the steps whose loads were
started in the step before (the hit share: slot 1's row with its slots'
visited flags and code rows, or the best candidate's row's ids), each
warp's cycles from a step's start to the points of ``MARKS`` (its slowest
lane), and a step's merge counts (``COUNTS``).
Prints the card's name and power limit first, and one JSON line with
everything at the end, also written to ``--out`` (default
``microbench/_out/iter_ab.json``, where the builds go too).
"""
from __future__ import annotations

import ctypes
import json
import re
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
from chip_smoke import HBM_READ_NS, INVALID_EDGE_SHARE, SCALE_CAP, SEED  # noqa: E402
from pgvectorscale_tpu_torch.config import DistanceType  # noqa: E402
from pgvectorscale_tpu_torch.graph import iterate  # noqa: E402
from pgvectorscale_tpu_torch.ops import _build  # noqa: E402
from pgvectorscale_tpu_torch.ops import iter_step as its  # noqa: E402

CAP_MAIN = 100_352  # chip_smoke.py's phase-3 cap
ALT_THREADS = 128
SOURCES = ("iter_step.cu", "hamming.cuh", "rowdist.cuh")
# A step's phases, in the order of the counters; then the counters: the
# survivors, the steps that read their adjacency row from the copy started
# at the last step's start (slot 1's) and from the one started after its
# scoring (its best candidate's), the steps after the first, the steps.
PHASES = ("window insert", "adjacency read", "visited-flag read", "frontier dedup",
          "in-row dedup and prefix", "score", "rank", "merge and copy back")
N_SURV, N_SLOT1, N_CAND, N_NEXT, N_STEPS = 9, 10, 11, 13, 15
# A build whose kernel marks them (PGVS_WARP_MARK): the cycles from a
# step's start to each of these points, the slowest lane of each warp's;
# and a step's counts of its merge (COUNTS).
MARKS = ("id", "loads issued", "row table", "window", "scored", "barrier 1", "window stored",
         "survivors listed", "scored (full)", "next node", "ranked", "frontier placed",
         "tables cleared", "barrier 3", "one free place", "")
COUNTS = {8: "low candidates", 12: "high candidates placed", 14: "sets made anew"}

# What ``instrument`` puts in front of the kernel: the counters, thread 0's
# clock, and the macros the kernel's phase marks call (the parent, which
# has no marks, gets them at PARENT_MARKS).  PGVS_PHASE_DEP ends a phase
# once a loaded value has arrived (a store of it into shared memory waits
# for it; the clock is read after).
HEADER = r"""
__device__ unsigned long long g_phase[16];
__device__ unsigned long long g_marks[256];
#define PGVS_PHASE_INIT                                                          \
  __shared__ unsigned long long phase_[16];                                     \
  __shared__ unsigned long long marks_[256];                                    \
  long long warp_t0_ = 0;                                                       \
  if ((threadIdx.x & 31) == 0)                                                  \
    for (int k_ = 0; k_ < 16; ++k_) marks_[k_ * 16 + (threadIdx.x >> 5)] = 0;   \
  __shared__ volatile int dep_sink_;                                            \
  const bool timing_ = threadIdx.x == 0;                                        \
  if (timing_)                                                                  \
    for (int k_ = 0; k_ < 16; ++k_) phase_[k_] = 0;                             \
  long long t_last_ = clock64();
#define PGVS_PHASE(k)                                                            \
  do {                                                                           \
    if (timing_) {                                                               \
      const long long t_ = clock64();                                            \
      phase_[k] += t_ - t_last_;                                                 \
      t_last_ = t_;                                                              \
    }                                                                            \
  } while (0)
#define PGVS_PHASE_DEP(k, v)                                                     \
  do {                                                                           \
    if (timing_) dep_sink_ = static_cast<int>(v);                                \
    PGVS_PHASE(k);                                                               \
  } while (0)
#define PGVS_PHASE_ADD(k, n)                                                     \
  do {                                                                           \
    if (timing_) phase_[k] += (n);                                               \
  } while (0)
#define PGVS_PHASE_SAVE(steps)                                                   \
  do {                                                                           \
    if (timing_) {                                                               \
      for (int k_ = 0; k_ < 15; ++k_) g_phase[k_] = phase_[k_];                  \
      g_phase[15] = (steps);                                                     \
    }                                                                            \
    if ((threadIdx.x & 31) == 0)                                                 \
      for (int k_ = 0; k_ < 16; ++k_)                                            \
        g_marks[k_ * 16 + (threadIdx.x >> 5)] = marks_[k_ * 16 + (threadIdx.x >> 5)]; \
  } while (0)
#define PGVS_WARP_START                                                          \
  do {                                                                           \
    warp_t0_ = clock64();                                                        \
  } while (0)
#define PGVS_WARP_MARK(k)                                                        \
  do {                                                                           \
    const unsigned t_ = __reduce_max_sync(                                       \
        0xffffffffu, static_cast<unsigned>(clock64() - warp_t0_));               \
    if ((threadIdx.x & 31) == 0) marks_[(k) * 16 + (threadIdx.x >> 5)] += t_;    \
  } while (0)
"""
READER = r"""
extern "C" int pgvs_phase_read(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, g_phase, sizeof(unsigned long long) * 16);
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out + 16, g_marks, sizeof(unsigned long long) * 256);
  return static_cast<int>(err);
}
"""
# The parent's marks: (text, its replacement), each text there once.
PARENT_MARKS = [
    ("  while (steps < p.budget && fr_d[0] < win_d[en - 1]) {\n",
     "  PGVS_PHASE_INIT\n  while (steps < p.budget && fr_d[0] < win_d[en - 1]) {\n"),
    ("    window_load(win_d, win_id, at + 1, en, wd, wi);\n",
     "    window_load(win_d, win_id, at + 1, en, wd, wi);\n    PGVS_PHASE(0);\n"),
    ("      const int nbv = __ldg(p.adjacency + row * r + i);\n",
     "      const int nbv = __ldg(p.adjacency + row * r + i);\n      PGVS_PHASE_DEP(1, nbv);\n"),
    ("    __syncthreads();\n    // 2, 3: the window's lowest round shifts",
     "    __syncthreads();\n    PGVS_PHASE(2);\n    // 2, 3: the window's lowest round shifts"),
    ("        if (nbs[i] == id) in_fr[i] = 1;\n    }\n    __syncthreads();\n",
     "        if (nbs[i] == id) in_fr[i] = 1;\n    }\n    __syncthreads();\n    PGVS_PHASE(3);\n"),
    ("    __syncthreads();\n    nc += nf;\n",
     "    __syncthreads();\n    nc += nf;\n    PGVS_PHASE(4);\n    PGVS_PHASE_ADD(9, nf);\n"),
    ("    __syncthreads();\n\n    // 6: the candidates by (distance, slot)",
     "    __syncthreads();\n    PGVS_PHASE(5);\n\n    // 6: the candidates by (distance, slot)"),
    ("    const int m = lo - 1;\n    __syncthreads();\n",
     "    const int m = lo - 1;\n    __syncthreads();\n    PGVS_PHASE(6);\n"),
    ("      fr_id[i] = nx_id[i];\n    }\n    __syncthreads();\n  }\n",
     "      fr_id[i] = nx_id[i];\n    }\n    __syncthreads();\n    PGVS_PHASE(7);\n  }\n"),
    ("  if (tid == 0) {\n    *p.n_visits = nv;",
     "  PGVS_PHASE_SAVE(steps);\n  if (tid == 0) {\n    *p.n_visits = nv;"),
]


def instrument(src: str) -> str:
    """The kernel's source with the phase stamps on."""
    out = src
    if "PGVS_PHASE_INIT" not in out:
        for text, repl in PARENT_MARKS:
            if out.count(text) != 1:
                raise SystemExit(f"iter_step.cu changed: {text!r} is not there once")
            out = out.replace(text, repl)
    inc = '#include "rowdist.cuh"\n'
    if out.count(inc) != 1:
        raise SystemExit("iter_step.cu does not include rowdist.cuh once")
    return out.replace(inc, inc + HEADER) + READER


def loop_sizes(lib: str) -> dict:
    """Each kernel of a library: its instructions and the bytes of its
    largest loop (the longest backward branch of its SASS), from cuobjdump."""
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", lib], capture_output=True, text=True,
                          timeout=300).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        name = func.split("\n", 1)[0].strip()
        m = re.search(r"iter_step_kernelILi(\d)ELi(\d)ELi(\d)ELb(\d)E", name)
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", func)
        loop = 0
        for addr, text_ in ins:
            b = re.search(r"BRA\s+(?:\S+,\s*)?0x([0-9a-f]+)", text_)
            if b and int(b.group(1), 16) < int(addr, 16):
                loop = max(loop, int(addr, 16) - int(b.group(1), 16))
        out["<%s>" % ",".join(m.groups()) if m else name[:40]] = dict(instructions=len(ins),
                                                                      loop_bytes=loop)
    return out


def build_all(parent: Path, new: Path, out_dir: Path, variants: dict) -> dict:
    """Start every nvcc at once; return name -> (library path, ptxas lines)."""
    nvcc = _build.find_nvcc()
    flags = list(_build.NVCC_FLAGS)
    jobs = {}
    for name, src_dir in (("parent", parent), ("new", new)):
        work = out_dir / name
        work.mkdir(parents=True, exist_ok=True)
        for f in SOURCES:
            (work / f).write_text((src_dir / f).read_text())
        (work / "iter_step_phases.cu").write_text(instrument((src_dir / "iter_step.cu").read_text()))
        jobs[name] = [*flags, "-o", str(out_dir / f"lib_{name}.so"), str(work / "iter_step.cu")]
        jobs[f"{name}_phases"] = [*flags, "-o", str(out_dir / f"lib_{name}_phases.so"),
                                  str(work / "iter_step_phases.cu")]
    for name, defines in variants.items():
        jobs[name] = [*flags, *defines, "-o", str(out_dir / f"lib_{name}.so"),
                      str(out_dir / "new" / "iter_step.cu")]
    procs = {k: subprocess.Popen([nvcc, *v], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True) for k, v in jobs.items()}
    built = {}
    for name, proc in procs.items():
        text, _ = proc.communicate(timeout=_build.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{text}")
        path = jobs[name][jobs[name].index("-o") + 1]
        built[name] = (path, [ln for ln in text.splitlines() if "ptxas" in ln or "spill" in ln],
                       loop_sizes(path))
    return built


class Build:
    """One library of the iterator's C interface."""

    def __init__(self, path: str):
        lib = ctypes.CDLL(path)
        self.lib = its.bind(lib)
        if hasattr(lib, "pgvs_phase_read"):
            lib.pgvs_phase_read.argtypes = [ctypes.c_void_p]

    def refill(self, shape: dict):
        """One refill through the kernel (window seed, launch, emitted rows)."""
        return iterate.iter_step_kernel(shape["state"], shape["arrays"], shape["qv"],
                                        shape["qc"], lib=self.lib, **shape["kw"])

    def launch(self, shape: dict, win):
        return its.launch(shape["state"], shape["arrays"], shape["qv"], shape["qc"], *win,
                          lib=self.lib, **{k: v for k, v in shape["kw"].items()
                                           if k != "emit_n"})


def phases(build: Build, shape: dict) -> dict:
    """Cycles a step of each phase for thread 0, and the counters."""
    buf = torch.zeros(16 + 256, dtype=torch.int64)
    if build.lib.pgvs_phase_read(buf.data_ptr()) != 0:
        raise SystemExit("reading the phase counters failed")
    build.refill(shape)
    if build.lib.pgvs_phase_read(buf.data_ptr()) != 0:
        raise SystemExit("reading the phase counters failed")
    v = buf.tolist()
    steps = max(v[N_STEPS], 1)
    per = {name: v[k] / steps for k, name in enumerate(PHASES)}
    total = sum(per.values())
    out = dict(steps=v[N_STEPS], cycles_per_step=per, total_cycles_per_step=total,
               share={k: x / total for k, x in per.items()} if total else {},
               survivors_per_step=v[N_SURV] / steps)
    marks = v[16:]
    if any(marks):
        out["warp_marks"] = {name: [round(marks[k * 16 + w] / steps) for w in range(16)]
                             for k, name in enumerate(MARKS) if any(marks[k * 16:k * 16 + 16])}
        out["per_step"] = {n: v[k] / steps for k, n in COUNTS.items()}
    if v[N_NEXT]:
        out.update(steps_after_first=v[N_NEXT], row_from_slot1=v[N_SLOT1],
                   row_from_candidate=v[N_CAND], slot1_share=v[N_SLOT1] / v[N_NEXT],
                   candidate_share=v[N_CAND] / v[N_NEXT],
                   hit_share=(v[N_SLOT1] + v[N_CAND]) / v[N_NEXT])
    return out


def random_shape(cap: int, r: int, refill: tuple, dist: DistanceType, seed: int,
                 use_codes=True, pre=(), **inputs) -> dict:
    """A refill of (emit_n, visit_budget) ``refill`` on a random graph
    (``ops.iter_step.check_inputs``), from a fresh state after the refills
    ``pre``; the inputs from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    arrays, qv, qc, starts = its.check_inputs(cap, r, use_codes, device="cuda", generator=g,
                                              invalid_share=INVALID_EDGE_SHARE, **inputs)
    traversal = dict(distance_type=dist, use_codes=use_codes)
    state = iterate.init_state(arrays, qv, qc, starts, frontier=256, **traversal)
    for emit_n, budget in pre:
        state, _, _ = iterate.iter_step(state, arrays, qv, qc, emit_n=emit_n,
                                        visit_budget=budget, **traversal)
    exact = its.exact_case(dict(inputs, use_codes=use_codes), traversal)
    return dict(arrays=arrays, qv=qv, qc=qc, state=state, exact=exact,
                kw=dict(emit_n=refill[0], visit_budget=refill[1], **traversal))


def built_shape() -> dict:
    """``profile_main_path.py``'s refill: the exact-prune 100k x 768 index,
    its first row as the query, the state after a first refill."""
    from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig
    from pgvectorscale_tpu_torch.distance import preprocess_query
    from pgvectorscale_tpu_torch.graph.search import get_start_ids
    from pgvectorscale_tpu_torch.io.datasets import synthetic_corpus
    from pgvectorscale_tpu_torch.ops import sbq

    vectors, _ = synthetic_corpus("cohere", 100_000, 1, seed=0)
    index = DiskannIndex.build(np.ascontiguousarray(vectors),
                               IndexConfig(num_dimensions=vectors.shape[1]))
    cfg = index.config
    traversal = dict(distance_type=cfg.distance_type, use_codes=cfg.uses_sbq)
    qv = preprocess_query(torch.as_tensor(index.arrays.vectors[:1].float()),
                          cfg.distance_type)[0, : cfg.dims_to_index]
    qc = sbq.encode(qv[None], index.sbq_stats, cfg.bits_per_dimension)[0]
    state = iterate.init_state(index.arrays, qv, qc, get_start_ids(index.arrays, 1)[0],
                               frontier=256, **traversal)
    state, _, _ = iterate.iter_step(state, index.arrays, qv, qc, emit_n=128, visit_budget=512,
                                    **traversal)
    return dict(arrays=index.arrays, qv=qv, qc=qc, state=state, exact=True,
                kw=dict(emit_n=128, visit_budget=512, **traversal))


def main() -> None:
    args = sys.argv[1:]
    out_path = ROOT / "microbench" / "_out" / "iter_ab.json"
    if "--out" in args:
        i = args.index("--out")
        out_path = Path(args[i + 1])
        del args[i:i + 2]
    new_dir = _build.CSRC
    if "--new" in args:
        i = args.index("--new")
        new_dir = Path(args[i + 1])
        del args[i:i + 2]
    variants = {f"new_{ALT_THREADS}": [f"-DPGVS_ITER_THREADS={ALT_THREADS}"]}
    while "--variant" in args:
        i = args.index("--variant")
        name, _, defines = args[i + 1].partition("=")
        variants[name] = defines.split(",")
        del args[i:i + 2]
    only = None
    if "--shapes" in args:
        i = args.index("--shapes")
        only = args[i + 1].split(",")
        del args[i:i + 2]
    parent = Path(args[0]) if args else ROOT / "microbench" / "_parent"
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    build_dir = ROOT / "microbench" / "_out" / "iter_ab_build"
    build_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    built = build_all(parent, new_dir, build_dir, variants)
    print(f"built in {time.perf_counter() - t0:.2f}s", flush=True)
    for name, (_, ptxas, sizes) in built.items():
        for line in ptxas:
            print(f"  {name}: {line}", flush=True)
        print(f"  {name}: kernels <KIND,A,B,S>: {json.dumps(sizes)}", flush=True)
    builds = {k: Build(v[0]) for k, v in built.items()}
    out = {"card": smi, "ptxas": {k: v[1] for k, v in built.items()},
           "sass": {k: v[2] for k, v in built.items()}, "shapes": {}}

    cos, l2 = DistanceType.COSINE, DistanceType.L2
    stream = random_shape(SCALE_CAP, 65, (128, 512), cos, SEED + 7, w=24)
    shapes = {  # made when run, each from its own seed
        "stream": lambda: stream,
        "stream, state in scratch": lambda: dict(stream, kw=dict(stream["kw"], shared_limit=0)),
        "wide R=260": lambda: random_shape(CAP_MAIN, 260, (128, 512), cos, SEED + 8, w=24),
        "deep": lambda: random_shape(SCALE_CAP, 65, (1024, 4096), cos, SEED + 9, w=24,
                                     pre=((128, 512), (256, 1024), (512, 2048))),
        "f32 L2 integer": lambda: random_shape(CAP_MAIN, 65, (128, 512), l2, SEED + 10,
                                               use_codes=False, d=768),
        "built index": built_shape,
    }

    names = ["parent", "new", *variants]
    for shape_name, make in shapes.items():
        if only and shape_name not in only:
            continue
        shape = make()
        kw = shape["kw"]
        plain_kw = {k: v for k, v in kw.items() if k != "shared_limit"}
        want = iterate.iter_step_plain(shape["state"], shape["arrays"], shape["qv"], shape["qc"],
                                       **plain_kw)
        results = {n: builds[n].refill(shape) for n in names}
        torch.cuda.synchronize()
        steps = int(results["new"][0].n_visits) - int(shape["state"].n_visits)
        rec = {"search": {k: str(v) for k, v in kw.items()}, "visits": steps,
               "scored": int(want[0].n_comps) - int(shape["state"].n_comps),
               "differ_from_plain": {n: its.refill_differs(v, want, shape["exact"])
                                     for n, v in results.items()},
               "differ_from_parent": {n: its.refill_differs(v, results["parent"], True)
                                      for n, v in results.items() if n != "parent"}}
        win_d, win_ids = iterate.window_seed(shape["state"], kw["emit_n"])
        times = {n: [] for n in names}
        for n in ("parent", "new", "new", "parent", *(v for v in variants for _ in range(2))):
            b = builds[n]
            times[n].append(timed_ms(lambda: b.launch(shape, (win_ids, win_d))))
        rec["ms"] = times
        rec["us_per_visit"] = {n: sum(t) / len(t) / max(steps, 1) * 1e3 for n, t in times.items()}
        rec["speedup"] = sum(times["parent"]) / sum(times["new"])
        rec["chain_ms"] = steps * 2 * HBM_READ_NS * 1e-6
        rec["phases"] = {n: phases(builds[f"{n}_phases"], shape) for n in ("parent", "new")}
        out["shapes"][shape_name] = rec
        print(f"{shape_name}: {json.dumps(rec)}", flush=True)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
