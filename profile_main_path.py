"""Where the port's main path spends its time on the card: a
torch.profiler view of one build wave and of one search batch.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 profile_main_path.py

It builds the same seeded 100k x 768 "cohere" SBQ index as
``chip_smoke.py`` twice: once without the profiler, timing every wave,
and once profiling wave ``WAVE`` (the build is deterministic, so both
builds do the same work).  It then profiles one 1,024-query search at
rescore 50 and at rescore 300, and two refills of the streaming iterator
on that index: emit_n 128 with the iterator's budget of 512 visits, from
the state after a first refill, and a deep one (emit_n 1,024, budget
4,096) after refills of 128, 256 and 512; for each also the device time
and wall time a visit.  Then the full-precision paths: wave
``WAVE`` of a build with build_distance "exact" (built twice the same
way) and a plain-storage build with one 1,024-query search at L=100.
For each it prints: the wall
milliseconds, the summed device time of all kernels, the device's busy
share (kernels run on one stream, so the sum does not double count), the
number of kernel launches, and the kernels that take the most device
time.  The busy share divides the device time by the wall time of the
same work run without the profiler (the profiler's own cost per launch
would inflate the wall): the same wave of the unprofiled build, and the
best of three unprofiled searches.  If the profiler records no device
time it says so instead of printing shares.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig, QueryParams
from pgvectorscale_tpu_torch.config import StorageLayout
from pgvectorscale_tpu_torch.io.datasets import synthetic_corpus

N = 100_000  # rows, as in chip_smoke.py
NQ = 1024  # queries per search batch, as in chip_smoke.py
WAVE = 12  # the profiled build wave (1-based), a searched wave of full size
TOP = 12  # kernels listed per profile


def _summary(prof, wall_s: float, plain_wall_s: float, label: str) -> float:
    """Device-side entries only (kernels, copies): the CPU-side op that
    launched a kernel carries the same device time and is left out.
    Returns the device milliseconds (0 when none was recorded)."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    wall_ms, plain_ms = wall_s * 1e3, plain_wall_s * 1e3
    if dev_us == 0:
        print(f"{label}: wall {plain_ms:.2f} ms; the profiler recorded no device time")
        return 0.0
    print(f"{label}: wall {plain_ms:.2f} ms unprofiled ({wall_ms:.2f} ms profiled), "
          f"device {dev_us / 1e3:.2f} ms, busy {dev_us / 1e3 / plain_ms:.3f}, "
          f"device launches {launches}")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:TOP]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:110]}")
    return dev_us / 1e3


def _build(vectors: np.ndarray, config: IndexConfig, profile_wave: int = 0):
    """Build the index; return it, each wave's wall seconds and the
    profiler that recorded wave ``profile_wave`` (None when 0)."""
    walls: list[float] = []
    state = {"t": time.perf_counter(), "prof": None}

    def progress(stage, done, total):
        torch.cuda.synchronize()
        now = time.perf_counter()
        wall, state["t"] = now - state["t"], now
        if stage != "inserting tuples":
            return
        walls.append(wall)
        if len(walls) == profile_wave:
            state["prof"].stop()
        elif len(walls) == profile_wave - 1:
            state["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            state["prof"].start()
            state["t"] = time.perf_counter()

    index = DiskannIndex.build(vectors, config, progress_callback=progress)
    torch.cuda.synchronize()
    return index, walls, state["prof"]


def _profile_call(fn, label: str):
    """``fn()`` three times unprofiled (the best wall) and once under the
    profiler; the summary under ``label`` (a callable of the last result
    gives the label's tail).  Returns (the last result, device ms, the best
    unprofiled wall ms)."""
    plain = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        plain.append(time.perf_counter() - t)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    dev_ms = _summary(prof, wall, min(plain), label(out) if callable(label) else label)
    return out, dev_ms, min(plain) * 1e3


def _profile_refill(index) -> None:
    """Two refills of the streaming iterator on ``index`` (its first
    query's stream): emit_n 128 after a first refill, and emit_n 1,024
    after refills of 128, 256 and 512."""
    from pgvectorscale_tpu_torch.distance import preprocess_query
    from pgvectorscale_tpu_torch.graph import iterate
    from pgvectorscale_tpu_torch.graph.search import get_start_ids
    from pgvectorscale_tpu_torch.ops import sbq

    cfg = index.config
    kw = dict(distance_type=cfg.distance_type, use_codes=cfg.uses_sbq)
    q = torch.as_tensor(index.arrays.vectors[:1].float())
    qv = preprocess_query(q, cfg.distance_type)[0, : cfg.dims_to_index]
    qc = (sbq.encode(qv[None], index.sbq_stats, cfg.bits_per_dimension)[0] if cfg.uses_sbq
          else torch.zeros((0,), dtype=torch.int32, device=qv.device))
    state = iterate.init_state(index.arrays, qv, qc, get_start_ids(index.arrays, 1)[0],
                               frontier=256, **kw)
    deep = state
    for emit_n in (128, 256, 512):
        deep, _, _ = iterate.iter_step(deep, index.arrays, qv, qc, emit_n=emit_n,
                                       visit_budget=4 * emit_n, **kw)
        if emit_n == 128:
            state = deep
    for name, start, emit_n in (("stream refill", state, 128), ("deep stream refill", deep, 1024)):
        before = int(start.n_visits)
        out, dev_ms, wall_ms = _profile_call(
            lambda: iterate.iter_step(start, index.arrays, qv, qc, emit_n=emit_n,
                                      visit_budget=4 * emit_n, **kw),
            lambda out: f"{name} emit_n={emit_n} ({int(out[0].n_visits) - before} visits)")
        visits = max(int(out[0].n_visits) - before, 1)
        print(f"    a visit: device {dev_ms / visits * 1e3:.3f} us, wall {wall_ms / visits * 1e3:.3f} "
              f"us (unprofiled)")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(f"device: {smi.stdout.strip().splitlines()[0]}, torch {torch.__version__}")

    vectors, queries = synthetic_corpus("cohere", N, NQ, seed=0)
    vectors = np.ascontiguousarray(vectors)
    config = IndexConfig(num_dimensions=vectors.shape[1])
    t = time.perf_counter()
    _, plain_walls, _ = _build(vectors, config)
    print(f"build: {time.perf_counter() - t:.2f} s for {N} rows, "
          f"{len(plain_walls)} waves, unprofiled")
    index, walls, prof = _build(vectors, config, profile_wave=WAVE)
    _summary(prof, walls[WAVE - 1], plain_walls[WAVE - 1], f"build wave {WAVE}")

    qdev = torch.as_tensor(queries).cuda()
    for rescore in (50, 300):
        params = QueryParams(search_list_size=100, rescore=rescore)
        _profile_call(lambda: index.search(qdev, 10, params),
                      lambda _: f"search Q={NQ} rescore {rescore} "
                                f"({index.last_search.iters} beam iterations)")
    _profile_refill(index)
    del index

    exact = IndexConfig(num_dimensions=vectors.shape[1], build_distance="exact")
    _, exact_walls, _ = _build(vectors, exact)
    _, walls, prof = _build(vectors, exact, profile_wave=WAVE)
    _summary(prof, walls[WAVE - 1], exact_walls[WAVE - 1], f"\"exact\" build wave {WAVE}")

    plain_cfg = IndexConfig(num_dimensions=vectors.shape[1], storage_layout=StorageLayout.PLAIN)
    t = time.perf_counter()
    p_index, _, _ = _build(vectors, plain_cfg)
    print(f"plain build: {time.perf_counter() - t:.2f} s for {N} rows, unprofiled")
    params = QueryParams(search_list_size=100, rescore=50)
    _profile_call(lambda: p_index.search(qdev, 10, params),
                  lambda _: f"plain search Q={NQ} L=100 ({p_index.last_search.iters} beam "
                            f"iterations)")


if __name__ == "__main__":
    main()
