"""Where the port's main path spends its time on the card: a
torch.profiler view of one build wave and of one search batch.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 profile_main_path.py

It builds the same seeded 100k x 768 "cohere" SBQ index as
``chip_smoke.py`` twice: once without the profiler, timing every wave,
and once profiling wave ``WAVE`` (the build is deterministic, so both
builds do the same work).  It then profiles one 1,024-query search at
rescore 50 and at rescore 300.  For each it prints: the wall
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
from pgvectorscale_tpu_torch.io.datasets import synthetic_corpus

N = 100_000  # rows, as in chip_smoke.py
NQ = 1024  # queries per search batch, as in chip_smoke.py
WAVE = 12  # the profiled build wave (1-based), a searched wave of full size
TOP = 12  # kernels listed per profile


def _summary(prof, wall_s: float, plain_wall_s: float, label: str) -> None:
    """Device-side entries only (kernels, copies): the CPU-side op that
    launched a kernel carries the same device time and is left out."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    wall_ms, plain_ms = wall_s * 1e3, plain_wall_s * 1e3
    if dev_us == 0:
        print(f"{label}: wall {plain_ms:.2f} ms; the profiler recorded no device time")
        return
    print(f"{label}: wall {plain_ms:.2f} ms unprofiled ({wall_ms:.2f} ms profiled), "
          f"device {dev_us / 1e3:.2f} ms, busy {dev_us / 1e3 / plain_ms:.3f}, "
          f"device launches {launches}")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:TOP]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:110]}")


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
        plain = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            index.search(qdev, 10, params)
            torch.cuda.synchronize()
            plain.append(time.perf_counter() - t)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            index.search(qdev, 10, params)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        _summary(prof, wall, min(plain), f"search Q={NQ} rescore {rescore} "
                 f"({index.last_search.iters} beam iterations)")


if __name__ == "__main__":
    main()
