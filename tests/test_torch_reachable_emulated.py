"""The reachability kernel's own source, run on the CPU, against the plain BFS.

``csrc/reachable.cu`` is compiled by g++ against ``tests/cuda_emu/cuda_emu.h``
at 64 threads a block (``-DPGVS_REACH_THREADS=64``: two warps, so block 0
takes a frontier of up to 4 rows alone and warp 0 one of up to 2).  Its
cooperative launch runs every block's fibers together, so the kernel's own
grid barrier (a spin on one word with ``__nanosleep``) runs as written.
Its C interface is called on CPU tensors with the grid capped at a few
blocks, and the reachable set must equal ``reachable_scatter_plain``'s and
``reachable_csr_plain``'s (tolerance: none; booleans) on random graphs
(several blocks' warps take words of one frontier bitmap, claim bits and
keep them in their stashes in the same level), islands with ids at and
past ``count`` and ``cap``, ``start`` -1 and past ``count``, and graphs
whose frontier narrows to one row and widens again, so that block 0 (and
warp 0) take the levels alone and hand them back to the grid, also with
one block running ahead of the others past every barrier
(``emu_lead_block``).  Three builds: the kernel as the card runs it (the
visited bitmap copied into shared memory), the L2-probe branch
(``-DPGVS_REACH_SMEM_BITMAP_MAX=0``: a table above the shared-memory
limit), and one whose blocks never refresh their copy (a stale copy lets
every candidate through to the atomic) with the stamps and per-level
counters on, whose counts are held to the BFS's own.
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
WARP_ROWS = 2  # the frontier warp 0 takes alone


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _build_emu(d: Path, defines: list[str]):
    """The kernel built for the CPU with ``defines``: its loaded library."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to build the emulated kernel")
    src = (_build.CSRC / "reachable.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", f'#include "{EMU_HEADER}"')
    old = "extern __shared__ __align__(16) unsigned char smem[];"
    assert src.count(old) == 1, "the kernel's shared-memory line changed"
    src = src.replace(old, "unsigned char* smem = emu_block->smem;")
    src += 'extern "C" void emu_set_lead_block(int b) { emu_lead_block = b; }\n'
    (d / "reachable_emu.cpp").write_text(src)
    lib = d / "libreachable_emu.so"
    cmd = ["g++", "-std=c++20", "-O1", "-fPIC", "-shared", f"-DPGVS_REACH_THREADS={THREADS}",
           *defines, "-o", str(lib), str(d / "reachable_emu.cpp")]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    cdll = ctypes.CDLL(str(lib))
    cdll.emu_set_lead_block.argtypes = [ctypes.c_int]
    return cdll


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel as the card runs it: its bound C interface."""
    cdll = _build_emu(tmp_path_factory.mktemp("reachable_emu"), [])
    return rc.bind(cdll), cdll.emu_set_lead_block, cdll


@pytest.fixture(scope="module")
def emulated_l2(tmp_path_factory):
    """The branch that probes the visited bitmap in L2, as above the
    shared-memory limit."""
    cdll = _build_emu(tmp_path_factory.mktemp("reachable_emu_l2"),
                      ["-DPGVS_REACH_SMEM_BITMAP_MAX=0"])
    return rc.bind(cdll), cdll.emu_set_lead_block, cdll


@pytest.fixture(scope="module")
def emulated_debug(tmp_path_factory):
    """Copies never refreshed, with the stamps and counters on: its bound
    interface, the lead-block setter and the debug reader."""
    cdll = _build_emu(tmp_path_factory.mktemp("reachable_emu_debug"),
                      ["-DPGVS_REACH_REFRESH=0", "-DPGVS_REACH_STAMPS=1",
                       "-DPGVS_REACH_COUNTS=1"])
    cdll.pgvs_reachable_debug.argtypes = [ctypes.c_void_p]
    return rc.bind(cdll), cdll.emu_set_lead_block, cdll.pgvs_reachable_debug


def run(lib, adj, count, start, blocks, lead=-1):
    bound, set_lead = lib[:2]
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


@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("cap,r,share", [(300, 8, 0.3), (200, 100, 0.3), (300, 1, 0.0),
                                         (150, 2, 0.8)])
def test_emulated_l2_branch_matches_plain(emulated_l2, cap, r, share, blocks):
    """The blocks probe the bitmap in L2 (no copy in shared memory), as at
    a table above the shared-memory limit."""
    g = torch.Generator().manual_seed(cap + r + 5)
    adj, count, start = rc.graph_case("random", cap, r, "cpu", g, invalid_share=share)
    check(emulated_l2, adj, count, start, blocks)


@pytest.mark.parametrize("kind,levels,fan", [("chain", 30, 6), ("fan", 20, 6)])
@pytest.mark.parametrize("lead", [-1, 1])
def test_emulated_l2_branch_hands_levels_back(emulated_l2, kind, levels, fan, lead):
    g = torch.Generator().manual_seed(levels + 7)
    adj, count, start = rc.graph_case(kind, 240, 8, "cpu", g, levels=levels, fan=fan)
    want, got = check(emulated_l2, adj, count, start, 3, lead)
    assert got["block"] >= levels and got["grid"] > 0


@pytest.mark.parametrize("cap,r", [(200, 100), (300, 1), (260, 65), (100, 200)])
@pytest.mark.parametrize("blocks", [1, 3])
def test_emulated_kernel_at_wide_and_one_slot_rows(emulated, cap, r, blocks):
    """Rows wider than 64 slots (spans of many 16-byte chunks, more than a
    warp's lanes) and rows of one slot (a chunk holds parts of four rows;
    a random graph of out-degree 1 is a long path)."""
    g = torch.Generator().manual_seed(cap * r)
    adj, count, start = rc.graph_case("random", cap, r, "cpu", g, invalid_share=0.1)
    check(emulated, adj, count, start, blocks)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_emulated_kernel_on_an_adjacency_off_a_16_byte_boundary(emulated, offset):
    """A contiguous view whose first id lies 4, 8 or 12 bytes past a 16-byte
    boundary: the rows' spans are cut from the aligned chunks around them."""
    g = torch.Generator().manual_seed(offset)
    adj, count, start = rc.graph_case("random", 250, 7, "cpu", g)
    store = torch.full((adj.numel() + 8,), -1, dtype=torch.int32)
    base = (-store.data_ptr() // 4) % 4  # ints to the first 16-byte boundary
    view = store[base + offset: base + offset + adj.numel()].view(adj.shape)
    view.copy_(adj)
    assert view.data_ptr() % 16 == 4 * offset and view.is_contiguous()
    check(emulated, view, count, start, 3)


def layered(sizes, r: int, cap: int, g) -> torch.Tensor:
    """An adjacency whose BFS from row 0 has exactly ``sizes`` rows a level:
    layer i's rows link to all of layer i + 1's between them (row j to
    rows j, j + len(layer i), ...), their other slots back to rows already
    reached or -1; rows past the layers are unreachable."""
    adj = torch.full((cap, r), -1, dtype=torch.int32)
    first = [sum(sizes[:i]) for i in range(len(sizes) + 1)]
    for i, n in enumerate(sizes):
        rows = torch.arange(first[i], first[i] + n)
        back = torch.randint(0, first[i] + 1, (n, r), generator=g, dtype=torch.int32)
        adj[rows] = torch.where(torch.rand((n, r), generator=g) < 0.5, back, -1)
        if i + 1 < len(sizes):
            nxt = sizes[i + 1]
            assert nxt <= n * r
            for j in range(nxt):
                adj[first[i] + j % n, j // n] = first[i + 1] + j
    return adj


@pytest.mark.parametrize("sizes", [
    [1, 2, 1, 2, 1], [1, 3, 1, 4, 2, 1], [1, 5, 1, 9, 1, 1], [1, 2, 4, 5, 4, 2, 1],
    [1, 9, 3, 2, 16, 2, 1],
])
@pytest.mark.parametrize("lead", [-1, 0, 1])
def test_emulated_kernel_crosses_the_warp_and_block_thresholds(emulated, sizes, lead):
    """Frontiers that cross WARP_ROWS (warp 0 alone) and SMALL (block 0
    alone) rows in both directions: each level runs where its size says,
    and the grid takes it back past SMALL."""
    g = torch.Generator().manual_seed(len(sizes) + sum(sizes))
    adj = layered(sizes, 9, 120, g)
    want, got = check(emulated, adj, 120, 0, 3, lead)
    assert int(want.sum()) == sum(sizes)
    assert got["warp"] == sum(n <= WARP_ROWS for n in sizes)
    assert got["block"] == sum(n <= SMALL for n in sizes)
    assert got["grid"] == sum(n > SMALL for n in sizes)


def read_debug(lib) -> list[int]:
    buf = torch.zeros(1 + 3 * 4096 + 4 * 1100, dtype=torch.int64)
    assert lib[2](buf.data_ptr()) == 0
    return buf.tolist()


@pytest.mark.parametrize("kind,cap,r,opts", [
    ("random", 300, 8, dict(invalid_share=0.3)),
    ("fan", 240, 9, dict(levels=12, fan=9)),
    ("islands", 260, 6, dict(count=200)),
])
@pytest.mark.parametrize("blocks", [1, 3])
def test_emulated_kernel_with_stale_copies_and_its_counters(emulated_debug, kind, cap, r, opts,
                                                             blocks):
    """Blocks that never refresh their bitmap copy send every candidate to
    the atomic; the result is the same.  The counters: every reached row
    expanded once, every reached row but the start claimed once, a level's
    claims the next level's rows, a grid level's claims each through a
    global atomic; block 0's stamps from the entry to the output pass."""
    g = torch.Generator().manual_seed(cap + blocks)
    adj, count, start = rc.graph_case(kind, cap, r, "cpu", g, **opts)
    read_debug(emulated_debug)
    want, levels = check(emulated_debug, adj, count, start, blocks)
    words = read_debug(emulated_debug)
    per_level = [words[1 + 3 * 4096 + 4 * lv: 1 + 3 * 4096 + 4 * lv + 4] for lv in range(1100)]
    atomics, claims, _, rows = (sum(c[k] for c in per_level) for k in range(4))
    reached = int(want.sum())
    assert rows == reached and claims == reached - 1
    # A grid level's claims (those with count-word atomics) each went
    # through a global atomic; block 0's alone are exact in shared memory.
    assert all(c[0] >= c[1] for c in per_level if c[2]) and atomics > 0
    n_levels = levels["grid"] + levels["block"]
    assert all(per_level[lv][1] == per_level[lv + 1][3] for lv in range(n_levels - 1))
    tags = [(words[1 + 3 * i] >> 56) & 0xff for i in range(words[0])]
    assert tags[0] == 0 and tags[-1] == 6 and tags.count(3) >= levels["grid"] + 1
    assert read_debug(emulated_debug)[0] == 0  # the reader zeroes the buffer


def test_shared_bitmap_limit_matches_the_kernel_and_a_card_case_passes_it(emulated, emulated_l2):
    """``ops.reachable.smem_bitmap_max_rows`` reads the kernel's limit (8
    rows a byte of ``PGVS_REACH_SMEM_BITMAP_MAX``; 0 in the L2-probe build),
    and the card's CHECK_CASES hold tables on both sides of the default
    one, so both branches of the kernel run on the card."""
    limit = rc.smem_bitmap_max_rows(emulated[2])
    assert limit == 8 * 224_256
    assert rc.smem_bitmap_max_rows(emulated_l2[2]) == 0
    caps = [c["cap"] for c in rc.CHECK_CASES]
    assert max(caps) > limit > min(caps)
