"""The prune-scan kernel's own source, run on the CPU, against the plain scan.

``csrc/prune_scan.cu`` is compiled by g++ against ``tests/cuda_emu/cuda_emu.h``
(each CUDA thread a fiber on one host thread, switched at the warp-wide
steps: ballots, shuffles, ``__syncwarp``; a ``cp.async`` copy lands only
at the thread's ``__pipeline_wait_prior``) and its C interface is called
on CPU tensors.  ``sel`` must equal ``prune_scan_plain``'s bit for bit
(tolerance: none) at every ``CHECK_CASES`` shape cut to a few rows (the
card runs them whole in ``tests/test_torch_kernels.py``): the register path
at each of its slot counts, the shared-memory path past it, one and two
label-mask words, edge rows (no valid candidate, all-sentinel and repeated
labels), R = 1 and R reached in the first round, one to three alpha
rounds; and on NaN pair distances, which the plain version propagates.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pgvectorscale_tpu_torch.graph.prune import alpha_schedule, sort_candidates
from pgvectorscale_tpu_torch.ops import _build
from pgvectorscale_tpu_torch.ops import prune_scan as ps

EMU_HEADER = Path(__file__).resolve().parent / "cuda_emu" / "cuda_emu.h"
ROWS = 5  # a block of 4 rows and one of 1: warps without a row exit


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel built for the CPU: its bound C interface."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to build the emulated kernel")
    src = (_build.CSRC / "prune_scan.cu").read_text()
    src = src.replace("#include <cuda_pipeline.h>\n", "")
    src = src.replace("#include <cuda_runtime.h>", f'#include "{EMU_HEADER}"')
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = emu_block->smem;")
    src, n = re.subn(r"prune_scan_kernel<K><<<blocks, threads, smem, stream>>>\(p\);",
                     "emu_launch(prune_scan_kernel<K>, p, blocks, threads, smem);", src)
    assert n == 1, "the kernel's launch line changed"
    d = tmp_path_factory.mktemp("prune_emu")
    (d / "prune_scan_emu.cpp").write_text(src)
    lib = d / "libprune_scan_emu.so"
    cmd = ["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-o", str(lib),
           str(d / "prune_scan_emu.cpp")]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    return ps.bind(ctypes.CDLL(str(lib)))


def run_emulated(lib, order, pair, d, ids, valid, tq, cl, nl, *, num_neighbors, alphas):
    fn, _ = lib
    b, c = ids.shape
    sel = torch.full((b, c), -5, dtype=torch.int32)
    alphas_t = torch.tensor(alphas, dtype=torch.float32)
    lm = 0 if cl is None else cl.shape[-1]
    err = fn(order.data_ptr(), pair.data_ptr(), d.data_ptr(), ids.data_ptr(), valid.data_ptr(),
             tq.data_ptr(), None if cl is None else cl.data_ptr(),
             None if nl is None else nl.data_ptr(), alphas_t.data_ptr(), sel.data_ptr(), b, c, lm,
             len(alphas), num_neighbors, 0, None)
    assert err == 0
    return sel


def check(lib, inputs, r, max_alpha):
    node, cand, cd, pair, cl, nl = inputs
    order, ids, d, valid, tq = sort_candidates(node, cand, cd)
    kw = dict(num_neighbors=r, alphas=alpha_schedule(max_alpha))
    want = ps.prune_scan_plain(order, pair, d, ids, valid, tq, cl, nl, **kw)
    got = run_emulated(lib, order, pair, d, ids, valid, tq, cl, nl, **kw)
    assert torch.equal(got, want)
    return want


@pytest.mark.parametrize("case", ps.CHECK_CASES, ids=ps.case_id)
def test_emulated_kernel_matches_plain(emulated, case):
    g = torch.Generator().manual_seed(17 + case["c"] + case["lm"])
    inputs = ps.case_inputs(dict(case, b=ROWS), "cpu", g)
    want = check(emulated, inputs, case["r"], case["max_alpha"])
    picks = (want != ps.UNSELECTED).sum(1)
    assert int(picks.max()) <= case["r"]
    if case["c"] > 1:
        assert int(picks.max()) > 0
    if case.get("edge_rows"):
        assert int(picks[0]) == 0  # the row without a valid candidate


@pytest.mark.parametrize("c", [70, 400])
def test_emulated_kernel_propagates_nan_as_plain(emulated, c):
    """NaN pair distances make the factor NaN in the plain version (torch's
    clamp and maximum propagate it), so the occluded candidate is never
    picked; the kernel does the same, in registers (C=70) and in shared
    memory (C=400)."""
    g = torch.Generator().manual_seed(5)
    node, cand, cd, pair, cl, nl = ps.check_inputs(ROWS, c, 0, "cpu", g)
    pair[torch.rand(pair.shape, generator=g) < 0.05] = float("nan")
    want = check(emulated, (node, cand, cd, pair, cl, nl), 65, 1.2)
    assert int((want != ps.UNSELECTED).sum()) > 0



F32_MAX = float(np.finfo(np.float32).max)


@pytest.mark.parametrize("alphas", [(1.0, 1.2), (1.0, 1.2, 1.44), (1.2, 1.0), (0.0, 1.0),
                                    (-1.0, 0.5, 2.0), (float("inf"),), (F32_MAX, 1.0),
                                    (2.0**-149, 1.0)],
                         ids=lambda a: "-".join(map(str, a)))
def test_emulated_kernel_quotients_at_the_alphas(emulated, alphas):
    """Occlusion factors within 3 ulps of every alpha, signed distances,
    pair distances below eps (the tie-break and BIG), quotients at the
    midpoint between 0 and the least denormal (num = 2**-149, pd = 2: even
    rounds down to 0) and between the odd least denormal and the next float
    (num = 3 * 2**-149: even rounds up), and alpha sets that are unsorted,
    negative, 0, +inf or the largest float, pick as the plain scan does."""
    rng = np.random.default_rng(7 + len(alphas))
    b, c = ROWS, 64
    num = np.sort(rng.choice([-0.75, 0.0, 0.3, 0.5, 1.0, 1.7], (b, c)), axis=1)
    num = num.astype(np.float32)
    num[0, 1] = np.float32(2.0**-149)
    num[0, 2] = np.float32(3 * 2.0**-149)
    finite = [a for a in alphas if np.isfinite(a) and a != 0.0] or [1.0]
    target = np.float32(rng.choice(finite, (b, c, c)))
    steps = rng.integers(-3, 4, (b, c, c))
    toward = np.where(steps > 0, np.float32(np.inf), np.float32(-np.inf))
    q = target
    with np.errstate(over="ignore", divide="ignore", invalid="ignore"):  # F32_MAX's next is inf
        for k in range(1, 4):  # up to 3 ulps either way
            q = np.where(np.abs(steps) >= k, np.nextafter(q, toward), q)
        pair = (num[:, None, :] / q).astype(np.float32)
    pair = np.where(np.isfinite(pair) & (pair > 0), pair, np.float32(0.5))
    pair[rng.random(pair.shape) < 0.05] = 0.0  # below eps: the tie-break or BIG
    pair[0, 0, 1] = pair[0, 0, 2] = 2.0
    ids = torch.from_numpy(rng.permutation(4 * b * c)[: b * c].reshape(b, c).astype(np.int32))
    t = dict(order=torch.arange(c, dtype=torch.int32).repeat(b, 1), pair=torch.from_numpy(pair),
             d=torch.from_numpy(num), ids=ids, valid=torch.ones((b, c), dtype=torch.bool),
             tq=torch.from_numpy(rng.integers(1, 9, (b, c)).astype(np.float32)))
    args = (t["order"], t["pair"], t["d"], t["ids"], t["valid"], t["tq"], None, None)
    kw = dict(num_neighbors=c, alphas=alphas)
    want = ps.prune_scan_plain(*args, **kw)
    got = run_emulated(emulated, *args, **kw)
    assert torch.equal(got, want)
