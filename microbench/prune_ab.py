"""Time two builds of the prune-scan kernel on one card, in turns, beside
its chain bound, and count how often its speculative row loads are used.

Usage, from the repository root on a machine with an NVIDIA GPU:

    python3 microbench/prune_ab.py [<parent dir>] [--out <json path>]

``<parent dir>`` holds another commit's ``prune_scan.cu`` (for example
``git show <commit>:pgvectorscale_tpu_torch/csrc/prune_scan.cu``), default
``microbench/_parent``; the C interface (``pgvs_prune_scan``,
``pgvs_prune_scan_smem_bytes``) is the same, so one binding
(``ops.prune_scan.bind``) drives both.  The script builds, with one nvcc
each, all started together: the parent's kernel, this checkout's, this
checkout's with f and order in shared memory at every C
(``-DPGVS_PRUNE_REGISTERS=0``), this checkout's with
``-DPGVS_PRUNE_STATS=1`` (counters of speculative row loads and their
hits, and clock64 cycles by phase: set-up, the searches for the next
pick, starting a row's copies, waiting for a row, the updates), ``microbench/l2_latency.cu`` and
``microbench/ballot_latency.cu``; it prints each build's ``-Xptxas -v``
lines.  At every ``chip_smoke.py`` PRUNE_CASES shape (the same seeded
inputs as its phase 2), and on a real wave's prune (the largest prune of
the seeded 100k x 768 "cohere" exact-prune build, as ``chip_smoke.py``
phase 3 builds it, captured on the card), it checks every build's ``sel``
bit-equal to ``prune_scan_plain``, reads the counters (cycles a pick, for
the batch and for its first row alone), and times the
parent and this checkout's two builds in turns (parent, new, shared,
shared, new, parent), each the
mean of 10 launches between CUDA events queued behind a device sleep,
for the whole batch and for its first row alone.  The bounds: bytes
(``ops.prune_scan.bound_bytes`` over 3.35 TB/s) and the chain, the most
picks in a row times one dependent device-memory read (the 1 GB chase of
``l2_latency``) plus n_alphas x ceil(C / 32) dependent ballots
(``ballot_latency``); for one row alone, whose pair rows sit in L2, its
picks times the 16 MB chase plus the ballots.  Prints the card's name
and power limit, then one JSON line with every time, bound and ratio,
also written to ``--out`` (default ``microbench/_out/prune_ab.json``,
where the builds go too).
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "microbench"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from beam_ab import HBM_BYTES_PER_S, timed_ms  # noqa: E402
from chip_smoke import PRUNE_CASES, PRUNE_MAX_ALPHA, PRUNE_R, SEED  # noqa: E402
from pgvectorscale_tpu_torch.graph import prune  # noqa: E402
from pgvectorscale_tpu_torch.ops import _build  # noqa: E402
from pgvectorscale_tpu_torch.ops import prune_scan as ps  # noqa: E402

WAVE_N, WAVE_DIM = 100_000, 768  # chip_smoke.py phase 3's corpus and index


def build_all(parent: Path, out_dir: Path) -> dict:
    """Start every nvcc at once; return name -> (path, ptxas lines)."""
    nvcc = _build.find_nvcc()
    flags = list(_build.NVCC_FLAGS)
    src = str(_build.CSRC / "prune_scan.cu")
    plain = ["-O3", "-gencode", "arch=compute_90a,code=sm_90a"]
    jobs = {
        "parent": [*flags, "-o", str(out_dir / "libprune_parent.so"),
                   str(parent / "prune_scan.cu")],
        "new": [*flags, "-o", str(out_dir / "libprune_new.so"), src],
        "shared": [*flags, "-DPGVS_PRUNE_REGISTERS=0", "-o", str(out_dir / "libprune_shared.so"),
                   src],
        "stats": [*flags, "-DPGVS_PRUNE_STATS=1", "-o", str(out_dir / "libprune_stats.so"), src],
        "l2_latency": [*plain, "-o", str(out_dir / "l2_latency"),
                       str(ROOT / "microbench" / "l2_latency.cu")],
        "ballot_latency": [*plain, "-o", str(out_dir / "ballot_latency"),
                           str(ROOT / "microbench" / "ballot_latency.cu")],
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


def run_json(path: str) -> dict:
    out = subprocess.run([path], capture_output=True, text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def capture_wave() -> tuple:
    """The arguments of the largest prune (B x C) of the seeded 100k x 768
    exact-prune build, cloned on the card."""
    from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig
    from pgvectorscale_tpu_torch.io.datasets import synthetic_corpus

    vectors, _ = synthetic_corpus("cohere", WAVE_N, 1, seed=SEED)
    vectors = np.ascontiguousarray(vectors)
    seen = {"size": 0, "args": None, "kw": None, "prunes": 0}
    real = prune.prune_scan

    def record(*args, **kw):
        seen["prunes"] += 1
        size = args[3].numel()
        if size > seen["size"]:
            seen.update(size=size, kw=dict(kw),
                        args=tuple(None if t is None else t.clone() for t in args))
        return real(*args, **kw)

    prune.prune_scan = record
    try:
        DiskannIndex.build(vectors, IndexConfig(num_dimensions=WAVE_DIM))
    finally:
        prune.prune_scan = real
    torch.cuda.synchronize()
    return seen["args"], seen["kw"], seen["prunes"]


def measure(name: str, args: tuple, kw: dict, libs: dict, stats_fn, lat: dict) -> dict:
    order, pair, d, ids, valid, tq, cl, nl = args
    b, c = ids.shape
    lm = 0 if cl is None else cl.shape[-1]
    want = ps.prune_scan_plain(*args, **kw)
    one = tuple(None if t is None else t[:1].contiguous() for t in args)
    want_one = ps.prune_scan_plain(*one, **kw)
    for lib_name, lib in libs.items():
        for a, w in ((args, want), (one, want_one)):
            got = ps.launch(*a, lib=lib, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, w):
                raise SystemExit(f"{lib_name} differs from prune_scan_plain at {name}")
    counters = (ctypes.c_ulonglong * 8)()
    stats_fn(counters)  # zero
    ps.launch(*args, lib=libs["stats"], **kw)
    torch.cuda.synchronize()
    stats_fn(counters)
    spec, hits, picks_counted = (int(x) for x in counters[:3])
    phases = ("set-up", "search", "issue", "wait", "update")
    cycles = {k: int(v) for k, v in zip(phases, counters[3:])}
    ps.launch(*one, lib=libs["stats"], **kw)
    torch.cuda.synchronize()
    stats_fn(counters)
    cycles_one = {k: int(v) for k, v in zip(phases, counters[3:])}
    row_picks = (want != ps.UNSELECTED).sum(1)
    picks = int(row_picks.sum())
    if picks_counted != picks:
        raise SystemExit(f"the counters saw {picks_counted} picks at {name}, sel {picks}")
    times = {"parent": [], "new": [], "shared": []}
    times_one = {"parent": [], "new": [], "shared": []}
    for lib_name in ("parent", "new", "shared", "shared", "new", "parent"):
        lib = libs[lib_name]
        times[lib_name].append(timed_ms(lambda: ps.launch(*args, lib=lib, **kw)))
        times_one[lib_name].append(timed_ms(lambda: ps.launch(*one, lib=lib, **kw)))
    n_alphas = len(kw["alphas"])
    ballots = n_alphas * math.ceil(c / 32)
    hbm_ns, l2_ns, ballot_ns = lat["hbm_ns"], lat["l2_ns"], lat["ballot_ns"]
    bytes_ms = ps.bound_bytes(b, c, picks, lm) / HBM_BYTES_PER_S * 1e3
    chain_ms = (int(row_picks.max()) * hbm_ns + ballots * ballot_ns) * 1e-6
    chain_one_ms = (int(row_picks[0]) * l2_ns + ballots * ballot_ns) * 1e-6
    rec = dict(
        shape=dict(b=b, c=c, lm=lm, r=kw["num_neighbors"], n_alphas=n_alphas),
        picks=picks, max_row_picks=int(row_picks.max()), one_row_picks=int(row_picks[0]),
        speculative_loads=spec, speculative_hits=hits,
        hit_rate=hits / spec if spec else None,
        ms=times, one_row_ms=times_one,
        cycles_per_pick={k: v / picks for k, v in cycles.items()},
        cycles_per_pick_one_row={k: v / max(int(row_picks[0]), 1) for k, v in cycles_one.items()},
        bytes_bound_ms=bytes_ms, chain_bound_ms=chain_ms, chain_bound_one_row_ms=chain_one_ms,
        bound_ms=max(bytes_ms, chain_ms),
        bound_by="chain" if chain_ms >= bytes_ms else "bytes",
        speedup=sum(times["parent"]) / sum(times["new"]),
        speedup_one_row=sum(times_one["parent"]) / sum(times_one["new"]),
        shared_over_new=sum(times["shared"]) / sum(times["new"]),
        shared_over_new_one_row=sum(times_one["shared"]) / sum(times_one["new"]),
    )
    print(f"{name}: {json.dumps(rec)}", flush=True)
    return rec


def main() -> None:
    args = sys.argv[1:]
    out_path = ROOT / "microbench" / "_out" / "prune_ab.json"
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
    build_dir = ROOT / "microbench" / "_out" / "prune_ab_build"
    build_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    built = build_all(parent, build_dir)
    print(f"built in {time.perf_counter() - t0:.2f}s", flush=True)
    for name, (_, ptxas) in built.items():
        for line in ptxas:
            print(f"  {name}: {line}", flush=True)
    chase = run_json(built["l2_latency"][0])
    ballot = run_json(built["ballot_latency"][0])
    print(f"pointer chase: {json.dumps(chase)}", flush=True)
    print(f"ballot chain: {json.dumps(ballot)}", flush=True)
    by_bytes = {rec["bytes"]: rec["ns_per_load"] for rec in chase["chase"]}
    lat = dict(l2_ns=by_bytes[16 << 20], hbm_ns=by_bytes[1 << 30],
               ballot_ns=ballot["ns_per_ballot"])
    dlls = {k: ctypes.CDLL(built[k][0]) for k in ("parent", "new", "shared", "stats")}
    libs = {k: ps.bind(v) for k, v in dlls.items()}
    stats_fn = dlls["stats"].pgvs_prune_scan_stats
    stats_fn.argtypes = [ctypes.c_void_p]
    stats_fn.restype = ctypes.c_int
    out = {"card": smi, "l2_chase": chase, "ballot": ballot, "latency_ns": lat,
           "ptxas": {k: v[1] for k, v in built.items()}}
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    kw = dict(num_neighbors=PRUNE_R, alphas=prune.alpha_schedule(PRUNE_MAX_ALPHA))
    for b, c, lm in PRUNE_CASES:  # chip_smoke.py phase 2's inputs, in its order
        node, cand, cd, pair, cl, nl = ps.check_inputs(b, c, lm, "cuda", g)
        order, ids, d, valid, tq = prune.sort_candidates(node, cand, cd)
        case_args = (order, pair, d, ids, valid, tq, cl, nl)
        out[f"B={b} C={c} Lm={lm}"] = measure(f"B={b} C={c} Lm={lm}", case_args, kw, libs,
                                               stats_fn, lat)
        del node, cand, cd, pair, cl, nl, case_args, order, ids, d, valid, tq
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    wave_args, wave_kw, prunes = capture_wave()
    print(f"real wave: the largest of {prunes} prunes of the 100k build "
          f"({time.perf_counter() - t0:.2f}s to build)", flush=True)
    b, c = wave_args[3].shape
    out["real wave"] = measure(f"real wave B={b} C={c}", wave_args, wave_kw, libs, stats_fn,
                               lat)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
