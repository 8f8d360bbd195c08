"""The reachability kernel's own source, run on the CPU, against the plain BFS.

``csrc/reachable.cu`` is compiled by g++ against ``tests/cuda_emu/cuda_emu.h``
at 64 threads a block (``-DPGVS_REACH_THREADS=64``: two warps, so block 0
takes a frontier of up to 4 rows alone).  Its cooperative launch runs
every block's fibers together, so the kernel's own grid barrier (a spin on
one word with ``__nanosleep``) runs as written.  Its C interface is called
on CPU tensors with the grid capped at a few blocks, and the reachable set
must equal ``reachable_scatter_plain``'s and ``reachable_csr_plain``'s
(tolerance: none; booleans) on random graphs (several blocks claim bits and
append to one queue in the same level), islands with ids at and past
``count`` and ``cap``, ``start`` -1 and past ``count``, and graphs whose
frontier narrows to one row and widens again, so that block 0 takes the
levels alone and hands them back to the grid, also with one block running
ahead of the others past every barrier (``emu_lead_block``).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from pgvectorscale_tpu_torch.ops import _build
from pgvectorscale_tpu_torch.ops import reachable as rc

EMU_HEADER = Path(__file__).resolve().parent / "cuda_emu" / "cuda_emu.h"
THREADS = 64
SMALL = 2 * THREADS // 32  # the frontier block 0 takes alone


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
    src = (_build.CSRC / "reachable.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", f'#include "{EMU_HEADER}"')
    old = "extern __shared__ __align__(16) unsigned char smem[];"
    assert src.count(old) == 1, "the kernel's shared-memory line changed"
    src = src.replace(old, "unsigned char* smem = emu_block->smem;")
    src += 'extern "C" void emu_set_lead_block(int b) { emu_lead_block = b; }\n'
    d = tmp_path_factory.mktemp("reachable_emu")
    (d / "reachable_emu.cpp").write_text(src)
    lib = d / "libreachable_emu.so"
    cmd = ["g++", "-std=c++20", "-O1", "-fPIC", "-shared", f"-DPGVS_REACH_THREADS={THREADS}",
           "-o", str(lib), str(d / "reachable_emu.cpp")]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    cdll = ctypes.CDLL(str(lib))
    cdll.emu_set_lead_block.argtypes = [ctypes.c_int]
    return rc.bind(cdll), cdll.emu_set_lead_block


def run(lib, adj, count, start, blocks, lead=-1):
    bound, set_lead = lib
    set_lead(lead)
    try:
        out, head = rc.launch(adj, count, start, max_blocks=blocks, lib=bound, device_index=0,
                              stream=0)
    finally:
        set_lead(-1)
    return out, rc.levels(head)


def check(lib, adj, count, start, blocks, lead=-1):
    want = rc.reachable_scatter_plain(adj, count, start)
    assert torch.equal(rc.reachable_csr_plain(adj, count, start), want)
    got, levels = run(lib, adj, count, start, blocks, lead)
    assert torch.equal(got, want)
    return want, levels


@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("cap,r,share", [(300, 8, 0.3), (257, 4, 0.3), (200, 7, 0.6),
                                         (150, 2, 0.8), (120, 40, 0.3)])
def test_emulated_kernel_matches_plain_on_random_graphs(emulated, cap, r, share, blocks):
    g = torch.Generator().manual_seed(cap + r)
    adj, count, start = rc.graph_case("random", cap, r, "cpu", g, invalid_share=share)
    want, levels = check(emulated, adj, count, start, blocks)
    if share <= 0.3:
        assert int(want.sum()) > cap // 2
        assert levels["grid"] > 0  # frontiers past SMALL rows went to the grid


def test_emulated_kernel_respects_count_islands_and_ids_past_the_table(emulated):
    g = torch.Generator().manual_seed(3)
    adj, count, start = rc.graph_case("islands", 260, 6, "cpu", g, count=200)
    assert int((adj >= 260).sum()) > 0 and int(((adj >= 200) & (adj < 260)).sum()) > 0
    want, _ = check(emulated, adj, count, start, 3)
    assert not want[100:].any() and int(want.sum()) > 50


@pytest.mark.parametrize("start,count", [(-1, 200), (250, 200), (0, 0), (199, 200)])
def test_emulated_kernel_at_the_start_edges(emulated, start, count):
    g = torch.Generator().manual_seed(11)
    adj, _, _ = rc.graph_case("random", 260, 5, "cpu", g, count=max(count, 1))
    want, _ = check(emulated, adj, count, start, 3)
    if start < 0 or start >= count:
        assert not want.any()


@pytest.mark.parametrize("kind,levels,fan", [("chain", 40, 0), ("chain", 25, 6), ("fan", 30, 6)])
def test_emulated_kernel_takes_one_block_levels_and_returns(emulated, kind, levels, fan):
    """A frontier of one row for ``levels`` levels runs in block 0 alone;
    a fan of ``fan`` > SMALL rows hands it back to the grid."""
    g = torch.Generator().manual_seed(levels)
    adj, count, start = rc.graph_case(kind, 240, 8, "cpu", g, levels=levels, fan=fan)
    want, got = check(emulated, adj, count, start, 3)
    assert got["block"] >= levels
    if fan > SMALL:
        assert got["grid"] > 0 and int(want.sum()) > levels + fan
    else:
        assert got["grid"] == 0 and int(want.sum()) == levels + 1


@pytest.mark.parametrize("lead", [0, 1])
@pytest.mark.parametrize("kind,levels,fan", [("chain", 40, 0), ("chain", 41, 0), ("chain", 42, 0),
                                             ("chain", 40, 6), ("chain", 41, 6), ("chain", 42, 6),
                                             ("fan", 30, 6)])
def test_emulated_kernel_with_one_block_running_ahead(emulated, kind, levels, fan, lead):
    """One block runs on past every barrier until it must wait, while the
    others lag (``emu_lead_block``): block 0 takes its one-block levels
    before the others have read the count that sent it there.  Chains of
    40, 41 and 42 one-block levels end that run at each of the three count
    words; the kernel must neither stop early nor hang."""
    g = torch.Generator().manual_seed(levels + fan)
    adj, count, start = rc.graph_case(kind, 240, 8, "cpu", g, levels=levels, fan=fan)
    want, got = check(emulated, adj, count, start, 3, lead)
    assert got["block"] >= levels
    assert int(want.sum()) > levels


def test_emulated_kernel_zero_capacity(emulated):
    out, _ = run(emulated, torch.zeros((0, 4), dtype=torch.int32), 0, 0, 3)
    assert out.shape == (0,)
