"""Where one iteration of the beam-search kernel spends its time, on the card.

Usage, from the repository root on a machine with an NVIDIA GPU:

    python3 microbench/beam_phases.py [--out <json path>]

Makes a copy of ``pgvectorscale_tpu_torch/csrc/beam_search.cu`` in which
thread 0 of one chosen block reads ``clock64()`` at the boundaries of the
loop's phases and adds each difference to a counter in shared memory, and
builds it with the port's nvcc flags.  The boundaries are found by the
kernel's own lines; the script stops with a message if a line it needs is
gone.  The copy also runs warp 0's selection scan twice in each iteration
and times both passes: the same instructions on the same shared-memory
data, so the difference is what fetching the scan's instructions costs
when the loop comes round to them again.

At ``chip_smoke.py`` phase 2's search shape (L=100, visit budget 166, E=4,
W=48, R=65 over 100,352 slots) it runs one query alone and a batch of
1,024 (block 0 and block 500 timed), and prints cycles an iteration for
each phase, the keys sorted and the scoring rounds an iteration, the
launch's time (CUDA events around 5 launches), the build's ``-Xptxas -v``
lines and the card's name and power limit; one JSON line at the end,
also written to ``--out`` (default ``microbench/_out/beam_phases.json``,
where the builds go too).  A phase's cycles include the waits of thread
0 (warp 0) only: the barrier phases are the time it waited for the
slowest warp.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from pgvectorscale_tpu_torch.ops import _build  # noqa: E402
from pgvectorscale_tpu_torch.ops import beam_search as bs  # noqa: E402

CAP, INVALID_SHARE, SEED = 100_352, 0.23, 4
SEARCH = dict(search_list_size=100, max_iters=166, expand_factor=4, track_hist=False,
              window_n=0)
# Counters: the phases in loop order, then the keys sorted, the scoring
# rounds of warp 0 and the two passes of the selection scan.
PHASES = ("select", "wait B1", "expand", "dedup", "wait B2", "readback", "score", "wait B3",
          "counts", "sort", "wait B4", "window merge", "beam merge", "hash insert")
N_KEYS, N_ROUNDS, SCAN_1, SCAN_2, N_COUNTERS = 14, 15, 16, 17, 18


def instrument(src: str) -> str:
    """The kernel's source with the phase timers put in."""
    out = src

    def put(anchor: str, text: str, before: bool = False) -> None:
        nonlocal out
        if out.count(anchor) != 1:
            raise SystemExit(f"beam_search.cu changed: {anchor!r} is not there once")
        out = out.replace(anchor, text + anchor if before else anchor + text)

    def mark(k: int) -> str:
        return f"    PHASE_MARK({k});\n"

    put('#include "hamming.cuh"\n',
        "__device__ unsigned long long g_phase[32];\n__device__ int g_phase_block;\n"
        "#define PHASE_MARK(k) do { if (timing) { const long long t_ = clock64(); "
        "phase[k] += t_ - t_last; t_last = t_; } } while (0)\n")
    put("  int cur = 0;  // the beam table that holds the beam's ids\n",
        f"  __shared__ unsigned long long phase[{N_COUNTERS}];\n"
        f"  if (threadIdx.x < {N_COUNTERS}) phase[threadIdx.x] = 0;\n"
        "  long long t_last = clock64();\n"
        "  const bool timing = threadIdx.x == 0 && blockIdx.x == g_phase_block;\n")
    # The selection scan, twice.
    put("#pragma unroll 1\n      for (int b0 = 0; b0 < l; b0 += 32) {",
        "      for (int pass = 0; pass < 2; ++pass) {\n      any = false;\n      found = 0;\n"
        "      const long long t_scan = clock64();\n", before=True)
    put("        if (found >= e) break;\n      }\n",
        f"      if (timing) phase[{SCAN_1} + pass] += clock64() - t_scan;\n      }}\n")
    put("    __syncthreads();\n    if (misc[kStop]) break;\n", mark(0), before=True)
    put("    __syncthreads();\n    if (misc[kStop]) break;\n", mark(1))
    put("      // Park the ids", mark(2), before=True)
    put("        fid[i] = id;\n      }\n    }\n", mark(3))
    put("        fid[i] = id;\n      }\n    }\n" + mark(3) + "    __syncthreads();\n", mark(4))
    put("      surv_w += cnt;\n", mark(5), before=True)
    put("      for (int b0 = 0; b0 < cnt; b0 += U * groups) {\n",
        f"        if (timing) phase[{N_ROUNDS}] += 1;\n")
    put("      misc[kKept + warp] = kept_w;\n    }\n", mark(6))
    put("      misc[kKept + warp] = kept_w;\n    }\n" + mark(6) + "    __syncthreads();\n", mark(7))
    put("    const int* kept = misc + kKept;\n",
        mark(8) + f"    if (timing) phase[{N_KEYS}] += nr;\n")
    put("    __syncthreads();\n    // The window (its tags are ids)", mark(9), before=True)
    put("    // The window (its tags are ids)", mark(10), before=True)
    put("      const bool beam = row == 1;\n", "      if (beam) PHASE_MARK(11);\n")
    put("    cur ^= 1;\n", mark(12), before=True)
    put("    ++it;\n  }\n\n  const long long brow", mark(13), before=True)
    put("  if (tid == 0) {\n    p.n_visited[q] = n_vis;",
        f"  if (timing) {{\n    for (int k = 0; k < {N_COUNTERS}; ++k) g_phase[k] = phase[k];\n"
        f"    g_phase[{N_COUNTERS}] = it;\n  }}\n", before=True)
    out += ("\nextern \"C\" int pgvs_phase_read(unsigned long long* out, int block) {\n"
            "  cudaError_t err = cudaDeviceSynchronize();\n"
            "  if (err == cudaSuccess)\n"
            "    err = cudaMemcpyFromSymbol(out, g_phase, sizeof(unsigned long long) * 32);\n"
            "  if (err == cudaSuccess)\n"
            "    err = cudaMemcpyToSymbol(g_phase_block, &block, sizeof(int));\n"
            "  return static_cast<int>(err);\n}\n")
    return out


def main() -> None:
    args = sys.argv[1:]
    out_path = ROOT / "microbench" / "_out" / "beam_phases.json"
    if "--out" in args:
        out_path = Path(args[args.index("--out") + 1])
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    work = ROOT / "microbench" / "_out" / "beam_phases_build"
    work.mkdir(parents=True, exist_ok=True)
    (work / "hamming.cuh").write_text((_build.CSRC / "hamming.cuh").read_text())
    (work / "beam_phases.cu").write_text(instrument((_build.CSRC / "beam_search.cu").read_text()))
    lib_path = work / "libbeam_phases.so"
    built = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                            str(work / "beam_phases.cu")], capture_output=True, text=True,
                           timeout=_build.NVCC_TIMEOUT_S)
    ptxas = [ln for ln in (built.stdout + built.stderr).splitlines()
             if "ptxas" in ln or "spill" in ln or "error" in ln]
    if built.returncode != 0:
        raise SystemExit("nvcc failed:\n" + "\n".join(ptxas))
    lib = bs.bind(ctypes.CDLL(str(lib_path)))
    lib.pgvs_phase_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    arrays, qc, starts, ql = bs.check_inputs(q=1024, cap=CAP, w=48, r=65,
                                             invalid_share=INVALID_SHARE, device="cuda",
                                             generator=g)
    buf = torch.zeros(32, dtype=torch.int64)
    result = {"card": smi, "ptxas": ptxas, "runs": []}
    for q, block in ((1, 0), (1024, 0), (1024, 500)):
        if lib.pgvs_phase_read(buf.data_ptr(), block) != 0:
            raise SystemExit("reading the counters failed")
        bs.launch(arrays, qc[:q], starts[:q], ql[:q], lib=lib, **SEARCH)
        if lib.pgvs_phase_read(buf.data_ptr(), block) != 0:
            raise SystemExit("reading the counters failed")
        v = buf.tolist()
        it = max(v[N_COUNTERS], 1)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            bs.launch(arrays, qc[:q], starts[:q], ql[:q], lib=lib, **SEARCH)
        end.record()
        torch.cuda.synchronize()
        run = dict(q=q, block=block, iters=v[N_COUNTERS],
                   cycles_per_iter={n: v[k] / it for k, n in enumerate(PHASES)},
                   total_cycles_per_iter=sum(v[:len(PHASES)]) / it,
                   keys_sorted_per_iter=v[N_KEYS] / it, score_rounds_per_iter=v[N_ROUNDS] / it,
                   scan_pass_cycles_per_iter=[v[SCAN_1] / it, v[SCAN_2] / it],
                   launch_ms=start.elapsed_time(end) / 5)
        result["runs"].append(run)
        print(json.dumps(run), flush=True)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
