"""Time two builds of the beam-search kernel on one card, in turns, and the
chain bound beside the byte bound.

Usage, from the repository root on a machine with an NVIDIA GPU:

    python3 microbench/beam_ab.py [<parent dir>] [--out <json path>]

``<parent dir>`` holds another commit's ``beam_search.cu`` and
``hamming.cuh`` (for example ``git show <commit>:pgvectorscale_tpu_torch/
csrc/beam_search.cu``), default ``microbench/_parent``; the C interface
(``pgvs_beam_search``, ``pgvs_beam_search_state_bytes``) is the same, so
one binding (``ops.beam_search.bind``) drives both.  The script builds,
with one nvcc each, all started together: the parent's kernel, this
checkout's as the port builds it (the launch picks 128 or 256 threads a
block) and forced to 128 and to 256 (``-DPGVS_BEAM_THREADS``), and
``microbench/l2_latency.cu``; it prints each build's ``-Xptxas -v``
lines.  At ``chip_smoke.py`` phase 2's search shape (Q=1,024, L=100,
visit budget 166, E=4, W=48, R=65 over 100,352 slots, 23% of the
adjacency empty) and its build-wave shape (Q=4,096, the history kept),
and for one query of each alone, it checks every build's outputs
bit-equal to ``beam_search_plain`` and then times them in turns (parent,
new, 128, 256, 256, 128, new, parent), each the mean of 10 launches
between CUDA events queued behind a device sleep; at the search shape
also the three new builds at batches of 66 to 792 queries.  The chain
bound is the longest query's iterations times two dependent L2 reads (an
adjacency row, then the code rows), at the L2 hit latency ``l2_latency``
measures.  Prints the card's name and power limit, then one JSON line
with every time, the bounds and the ratios, also written to ``--out``
(default ``microbench/_out/beam_ab.json``, where the builds go too).
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

import torch  # noqa: E402

from pgvectorscale_tpu_torch.graph.search import SearchResult  # noqa: E402
from pgvectorscale_tpu_torch.ops import _build  # noqa: E402
from pgvectorscale_tpu_torch.ops import beam_search as bs  # noqa: E402

CAP, INVALID_SHARE, SEED = 100_352, 0.23, 4
SHAPES = {
    "search": (dict(q=1024, w=48, r=65), dict(search_list_size=100, max_iters=166,
                                               expand_factor=4, track_hist=False)),
    "build wave": (dict(q=4096, w=48, r=65), dict(search_list_size=100, max_iters=166,
                                                   expand_factor=4, track_hist=True)),
}
TIMED_CALLS = 10
SUBSET_QS = (66, 132, 264, 528, 792)
QUEUE_SLEEP_CYCLES = 39_600_000
# Bytes a second of the card's memory (H100 SXM HBM3), for the byte bound.
HBM_BYTES_PER_S = 3.35e12


def build_all(parent: Path, out_dir: Path) -> dict:
    """Start every nvcc at once; return name -> (path, ptxas lines)."""
    nvcc = _build.find_nvcc()
    flags = list(_build.NVCC_FLAGS)
    csrc = _build.CSRC
    jobs = {
        "parent": [*flags, "-o", str(out_dir / "libbeam_parent.so"),
                   str(parent / "beam_search.cu")],
        "new": [*flags, "-o", str(out_dir / "libbeam_new.so"), str(csrc / "beam_search.cu")],
        "new128": [*flags, "-DPGVS_BEAM_THREADS=128", "-o", str(out_dir / "libbeam_new128.so"),
                   str(csrc / "beam_search.cu")],
        "new256": [*flags, "-DPGVS_BEAM_THREADS=256", "-o", str(out_dir / "libbeam_new256.so"),
                   str(csrc / "beam_search.cu")],
        "l2_latency": ["-O3", "-gencode", "arch=compute_90a,code=sm_90a", "-o",
                       str(out_dir / "l2_latency"), str(ROOT / "microbench" / "l2_latency.cu")],
    }
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


def main() -> None:
    args = sys.argv[1:]
    out_path = ROOT / "microbench" / "_out" / "beam_ab.json"
    if "--out" in args:
        i = args.index("--out")
        out_path = Path(args[i + 1])
        del args[i:i + 2]
    parent = Path(args[0]) if args else ROOT / "microbench" / "_parent"
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    build_dir = ROOT / "microbench" / "_out" / "beam_ab_build"
    build_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    built = build_all(parent, build_dir)
    print(f"built in {time.perf_counter() - t0:.2f}s", flush=True)
    for name, (_, ptxas) in built.items():
        for line in ptxas:
            print(f"  {name}: {line}", flush=True)
    chase = json.loads(subprocess.run([built["l2_latency"][0]], capture_output=True, text=True,
                                      timeout=300, check=True).stdout.strip().splitlines()[-1])
    l2_ns = chase["chase"][0]["ns_per_load"]
    print(f"pointer chase: {json.dumps(chase)}", flush=True)
    libs = {k: bs.bind(ctypes.CDLL(built[k][0])) for k in ("parent", "new", "new128", "new256")}
    order = ["parent", "new", "new128", "new256", "new256", "new128", "new", "parent"]
    out = {"card": smi, "l2_chase": chase, "ptxas": {k: v[1] for k, v in built.items()}}
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for shape, (inputs, search) in SHAPES.items():
        arrays, qc, starts, ql = bs.check_inputs(**inputs, cap=CAP, invalid_share=INVALID_SHARE,
                                                 device="cuda", generator=g)
        kw = dict(dict(window_n=0), **search)
        plain = bs.beam_search_codes_plain(arrays, qc, starts, ql, **kw)
        one = [t[:1] for t in (qc, starts, ql)]
        plain_one = bs.beam_search_codes_plain(arrays, *one, **kw)
        rec = {"iters": plain.iters, "iters_one": plain_one.iters}
        for name, lib in libs.items():
            for args_, want in (((qc, starts, ql), plain), (one, plain_one)):
                got, iters = bs.launch(arrays, *args_, lib=lib, **kw)
                bad = bs.results_equal(SearchResult(iters=int(iters.max()), **got), want)
                if bad:
                    raise SystemExit(f"{name} differs from beam_search_plain at {shape}: {bad}")
        times = {k: [] for k in libs}
        times_one = {k: [] for k in libs}
        for name in order:
            lib = libs[name]
            times[name].append(timed_ms(lambda: bs.launch(arrays, qc, starts, ql, lib=lib, **kw)))
            times_one[name].append(timed_ms(lambda: bs.launch(arrays, *one, lib=lib, **kw)))
        # Batch sizes between one query and one round of blocks, to place the
        # block shape's crossover (128 threads: 8 blocks an SM; 256: 4).
        by_q = {}
        for qn in SUBSET_QS if shape == "search" else ():
            sub = [t[:qn] for t in (qc, starts, ql)]
            by_q[qn] = {"new": [], "new128": [], "new256": []}
            for name in ("new", "new128", "new256", "new256", "new128", "new"):
                by_q[qn][name].append(
                    timed_ms(lambda: bs.launch(arrays, *sub, lib=libs[name], **kw)))
        rec["by_q_ms"] = by_q
        # The byte bound, from this search's own visits (chip_smoke.py's).
        hist, _ = bs.launch(arrays, qc, starts, ql, lib=libs["new"],
                            **dict(kw, track_hist=True))
        visited = torch.unique(hist["hist_ids"][hist["hist_ids"] >= 0])
        nbrs = arrays.adjacency[visited.long()]
        nbr_rows = int(torch.unique(nbrs[nbrs >= 0]).numel())
        got, iters = bs.launch(arrays, qc, starts, ql, lib=libs["new"], **kw)
        out_bytes = sum(t.numel() * t.element_size() for t in got.values()) + qc.shape[0] * 4
        nbytes = bs.bound_bytes(inputs["q"], inputs["w"], inputs["r"], 1, 0, 0, out_bytes,
                                int(visited.numel()), nbr_rows)
        max_iters = int(iters.max())
        rec.update(
            ms={k: v for k, v in times.items()}, one_query_ms=times_one,
            bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            chain_bound_ms=max_iters * 2 * l2_ns * 1e-6, chain_iters=max_iters, l2_ns=l2_ns,
            speedup={k: sum(times["parent"]) / sum(times[k]) for k in ("new", "new128", "new256")},
            speedup_one={k: sum(times_one["parent"]) / sum(times_one[k])
                         for k in ("new", "new128", "new256")},
        )
        out[shape] = rec
        print(f"{shape}: {json.dumps(rec)}", flush=True)
        del arrays, qc, starts, ql, plain
        torch.cuda.empty_cache()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
