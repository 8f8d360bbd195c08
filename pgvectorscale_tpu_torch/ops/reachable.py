"""Reachability from the start node: the build's BFS, one launch.

Replaces the JAX package's two device loops of the reachability BFS in
``graph/build.py``: the scatter BFS (``_reachable_scatter``'s
``lax.while_loop``, pgvectorscale_tpu/graph/build.py:1115) and the CSR
pull-BFS (``_reachable_csr``, :1153), between which its
``reachable_on_device`` (:1163) chooses by capacity.  Neither is a Pallas
kernel.  Both have plain versions here, each a loop of whole-graph rounds
with one host read a round: ``reachable_scatter_plain`` (a scatter-max of
``seen`` across every edge) and ``reachable_csr_plain`` (a stable sort of
the (dst, src) edges by dst once, then one gather and one cumsum a round).

What it computes: ``bool[cap]``, the rows in ``[0, count)`` reachable from
``start`` over ``adjacency`` int32[cap, r].  A negative id is no edge; an
id at or past ``count`` is neither reached nor expanded, and ids past
``cap`` are dropped; with ``start < 0`` or ``start >= count`` nothing is.

The kernel (``csrc/reachable.cu``) is a level-synchronous push BFS in one
cooperative launch, one block of 1,024 threads an SM: a visited bitmap and
two frontier bitmaps in zeroed scratch and a small stash a block,
allocated here; a grid level takes the frontier from its bitmap, a warp a
word of 32 rows, their spans read in 16-byte chunks; new ids are probed in
a copy of the visited bitmap in shared memory while it fits
(``smem_bitmap_max_rows``), else in L2; block 0 (or warp 0) alone while the
frontier is small (a chain costs no grid barrier).  Bound on an H100: the
reached rows' adjacency once and the output (``bound_bytes``); on a
chain, one dependent device read a level.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version that the JAX package picks for its capacity: the CSR pull-BFS from
``CSR_BFS_MIN_CAP`` rows on, else the scatter BFS.  ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

# From this capacity on a CPU adjacency takes the CSR pull-BFS, as the JAX
# package's reachable_on_device does.
CSR_BFS_MIN_CAP = 300_000
# 32-bit words at the head of the kernel's scratch (reachable.cu's enum):
# the levels expanded by the whole grid, by block 0 alone (warp 0's
# included) and by warp 0 alone.
HEAD_GRID_LEVELS = 5
HEAD_BLOCK_LEVELS = 6
HEAD_WARP_LEVELS = 7
HEAD_WORDS = 8

launches = 0
_launch_lock = threading.Lock()


def count_launch() -> None:
    global launches
    with _launch_lock:
        launches += 1


def _start_mask(cap: int, start: int, dev) -> torch.Tensor:
    seen = torch.zeros((cap,), dtype=torch.bool, device=dev)
    if 0 <= start < cap:
        seen[start] = True
    return seen


def reachable_scatter_plain(adjacency: torch.Tensor, count: int, start: int) -> torch.Tensor:
    """JAX's scatter BFS: each round propagates ``seen`` across every edge
    with one scatter-max, until nothing changes (one host read a round)."""
    cap = adjacency.shape[0]
    dev = adjacency.device
    in_graph = torch.arange(cap, device=dev) < count
    seen = _start_mask(cap, start, dev).to(torch.int32)
    # Ids past the table land in one spare slot (JAX's mode="drop").
    targets = torch.where((adjacency >= 0) & (adjacency < cap), adjacency, cap).reshape(-1).long()
    edge_ok = adjacency >= 0
    while True:
        contrib = ((seen > 0) & in_graph)[:, None] & edge_ok
        new_seen = torch.cat([seen, seen.new_zeros(1)]).scatter_reduce(
            0, targets, contrib.reshape(-1).to(torch.int32), reduce="amax"
        )[:cap]
        changed = bool(torch.any(new_seen != seen))
        seen = new_seen
        if not changed:
            break
    return (seen > 0) & in_graph


def reachable_csr_plain(adjacency: torch.Tensor, count: int, start: int) -> torch.Tensor:
    """JAX's CSR pull-BFS: the (dst, src) edge list sorted by dst once
    (stable) with ``searchsorted`` offsets for every row, then each round
    one gather of the sources' flags, one cumsum and two boundary gathers
    give any(seen[in-neighbours(v)]) for every v (one host read a round)."""
    cap, r = adjacency.shape
    dev = adjacency.device
    row = torch.arange(cap, device=dev)
    in_graph = row < count
    seen = _start_mask(cap, start, dev)
    if cap * r == 0:
        return seen & in_graph
    src = row[:, None].expand(cap, r).reshape(-1)
    # Invalid edges and edges from rows past count bucket at `cap` (or past
    # it), beyond the offset table.
    dst = torch.where((adjacency >= 0) & in_graph[:, None], adjacency.long(), cap).reshape(-1)
    sdst, order = torch.sort(dst, stable=True)
    ssrc = src[order]
    off = torch.searchsorted(sdst, torch.arange(cap + 1, device=dev))
    lo, hi = off[:-1], off[1:]
    while True:
        s = torch.cumsum(seen[ssrc], 0)
        s_lo = torch.where(lo > 0, s[(lo - 1).clamp_min(0)], 0)
        s_hi = torch.where(hi > 0, s[(hi - 1).clamp_min(0)], 0)
        new_seen = (seen | (s_hi > s_lo)) & in_graph
        if torch.equal(new_seen, seen):
            break
        seen = new_seen
    return seen & in_graph


def _check(adjacency: torch.Tensor, count: int) -> None:
    if adjacency.dtype != torch.int32:
        raise TypeError(f"adjacency must be torch.int32, got {adjacency.dtype}")
    if adjacency.dim() != 2:
        raise ValueError(f"adjacency must be 2-D, got shape {tuple(adjacency.shape)}")
    if not adjacency.is_contiguous():
        raise ValueError("adjacency must be contiguous")
    if not 0 <= count <= adjacency.shape[0]:
        raise ValueError(f"count {count} is outside [0, {adjacency.shape[0]}]")


def reachable(adjacency: torch.Tensor, count: int, start: int, *,
              csr_min_cap: int = CSR_BFS_MIN_CAP) -> torch.Tensor:
    """``bool[cap]``: the rows below ``count`` reachable from ``start``.
    On the CPU, the CSR pull-BFS from ``csr_min_cap`` rows on, else the
    scatter BFS."""
    _check(adjacency, count)
    device = adjacency.device
    if device.type == "cpu":
        if adjacency.shape[0] >= csr_min_cap:
            return reachable_csr_plain(adjacency, count, start)
        return reachable_scatter_plain(adjacency, count, start)
    if device.type != "cuda":
        raise ValueError(f"no reachability kernel for device {device}")
    out, _ = launch(adjacency, count, start)
    if adjacency.shape[0]:
        count_launch()
    return out


def launch(adjacency: torch.Tensor, count: int, start: int, *, max_blocks: int = 0,
           lib=None, device_index=None, stream=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel on a checked adjacency, uncounted: (``bool[cap]``, the
    scratch head, whose ``levels`` the caller may read).  ``max_blocks``
    caps the grid (0: as many blocks as the card holds at once); ``lib``:
    the ``bind`` of another build of the same C interface;
    ``device_index`` / ``stream``: the CUDA device and stream handle
    (default: the adjacency's device and its current stream)."""
    cap, r = adjacency.shape
    dev = adjacency.device
    out = torch.empty((cap,), dtype=torch.bool, device=dev)
    fn, zeroed_words, stash_words = lib if lib is not None else bind(_build.load("reachable"))
    head = torch.zeros((zeroed_words(cap),), dtype=torch.int32, device=dev)
    if cap == 0:
        return out, head
    stash = torch.empty((stash_words(),), dtype=torch.int32, device=dev)
    if device_index is None:
        device_index = dev.index if dev.index is not None else torch.cuda.current_device()
    if stream is None:
        stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(adjacency.data_ptr(), out.data_ptr(), head.data_ptr(), stash.data_ptr(), cap, r,
             count, start, max_blocks, device_index, stream)
    if err != 0:
        raise RuntimeError(f"reachability kernel launch failed: CUDA error {err}")
    return out, head


def levels(head: torch.Tensor) -> dict:
    """The levels a launch expanded, from its scratch head (a host read):
    by the whole grid, by block 0 alone (warp 0's included) and by warp 0
    alone."""
    h = head[:HEAD_WORDS].cpu()
    return {"grid": int(h[HEAD_GRID_LEVELS]), "block": int(h[HEAD_BLOCK_LEVELS]),
            "warp": int(h[HEAD_WARP_LEVELS])}


def bind(lib: ctypes.CDLL):
    """(launch function, zeroed-words function, stash-words function) of a
    loaded build of ``csrc/reachable.cu``, with their ctypes signatures set."""
    fn = lib.pgvs_reachable
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    words = lib.pgvs_reachable_zeroed_words
    words.argtypes = [ctypes.c_int]
    words.restype = ctypes.c_longlong
    stash = lib.pgvs_reachable_stash_words
    stash.argtypes = []
    stash.restype = ctypes.c_longlong
    return fn, words, stash


def smem_bitmap_max_rows(lib: ctypes.CDLL | None = None) -> int:
    """The largest table whose visited bitmap the kernel's blocks copy into
    shared memory (a build of ``csrc/reachable.cu``, the port's by default);
    above it they probe the bitmap in L2."""
    lib = lib if lib is not None else _build.load("reachable")
    fn = lib.pgvs_reachable_smem_bitmap_max_rows
    fn.argtypes = []
    fn.restype = ctypes.c_longlong
    return int(fn())


def bound_bytes(cap: int, r: int, reached: int) -> int:
    """Bytes the BFS must move: each reached row's adjacency once and the
    bool[cap] output.  The kernel's bitmaps are its own overhead: a BFS need
    not keep them."""
    return reached * r * 4 + cap


def graph_case(kind: str, cap: int, r: int, device, generator=None, *, count=None,
               start: int = 0, invalid_share: float = 0.23, levels: int = 0,
               fan: int = 0) -> tuple[torch.Tensor, int, int]:
    """A test graph ``(adjacency int32[cap, r], count, start)``, with
    ``invalid_share`` of its slots -1:

    - ``"random"``: ids uniform below ``count`` (default ``cap``); rows
      past ``count`` hold stale ids;
    - ``"islands"``: rows link below ``count // 2``, except those in
      ``[count // 2, count)``, which link only among themselves (an island
      the start cannot reach); 5% of all slots hold ids at or past
      ``count``, some past ``cap``;
    - ``"chain"``: rows 0..levels a chain from the start at 0 (row i's
      first slot i + 1, its other slots back to rows <= i), so every level
      adds one row; the chain's last row links to ``fan`` rows after it
      (0: none), and every later row links at random among those rows;
    - ``"fan"``: the start links to rows 1..fan (``fan <= r``), which all
      link to row fan + 1, the head of a chain of ``levels`` rows, then as
      ``"chain"``: a wide level, one-row levels, wide levels again.
    """
    count = cap if count is None else count
    kw = dict(device=device, generator=generator)

    def ids_in(lo, hi, shape):
        return torch.randint(lo, max(hi, lo + 1), shape, dtype=torch.int32, **kw)

    def drop(t):
        return torch.where(torch.rand(t.shape, **kw) < invalid_share, -1, t)

    if kind == "random":
        adj = drop(ids_in(0, count, (cap, r)))
    elif kind == "islands":
        half = count // 2
        adj = ids_in(0, half, (cap, r))
        adj[half:count] = ids_in(half, count, (count - half, r))
        adj = torch.where(torch.rand((cap, r), **kw) < 0.05, ids_in(count, cap + 100, (cap, r)),
                          adj)
        adj = drop(adj)
    elif kind in ("chain", "fan"):
        head = fan + 1 if kind == "fan" else 0
        end = head + levels
        if end + fan >= cap or (kind == "fan" and fan > r):
            raise ValueError("the chain and its fans do not fit the table")
        row = torch.arange(cap, dtype=torch.int32, device=device)
        adj = ids_in(end + 1, cap, (cap, r))
        adj[:end + 1] = torch.remainder(ids_in(0, 2**30, (end + 1, r)), row[:end + 1, None] + 1)
        adj = drop(adj)
        adj[head:end, 0] = row[head + 1:end + 1]
        if kind == "fan":
            adj[0, :fan] = row[1:fan + 1]
            adj[1:fan + 1, 0] = head
        adj[end] = -1
        adj[end, :fan] = row[end + 1:end + 1 + fan]
    else:
        raise ValueError(f"unknown graph kind {kind!r}")
    return adj.contiguous(), count, start


# The graphs the kernel is held to on the card (tests/test_torch_kernels.py):
# random graphs at the built graph's width (R = 65, 23% of the slots empty)
# and at 60% empty, one above smem_bitmap_max_rows() (the blocks probe the
# bitmap in L2 there), islands with ids at and past count and cap, start -1
# and past count, a 1,000-level chain, a chain that fans out again, a wide
# level that narrows to a chain and widens again, and a tiny table.
CHECK_CASES = [
    dict(kind="random", cap=100_000, r=65),
    dict(kind="random", cap=2_000_000, r=65),
    dict(kind="random", cap=4_000, r=7, invalid_share=0.6),
    dict(kind="islands", cap=50_000, r=65, count=40_000),
    dict(kind="random", cap=10_000, r=65, start=-1),
    dict(kind="random", cap=10_000, r=65, count=8_000, start=9_000),
    dict(kind="chain", cap=20_000, r=65, levels=1_000),
    dict(kind="chain", cap=20_000, r=65, levels=300, fan=64),
    dict(kind="fan", cap=20_000, r=65, levels=200, fan=65),
    dict(kind="random", cap=3, r=1),
]


def case_id(case: dict) -> str:
    return "-".join(f"{k}{v}" if k != "kind" else str(v) for k, v in case.items())


def case_graph(case: dict, device, generator=None) -> tuple[torch.Tensor, int, int]:
    """``graph_case`` of one CHECK_CASES entry."""
    opts = {k: v for k, v in case.items() if k not in ("kind", "cap", "r")}
    return graph_case(case["kind"], case["cap"], case["r"], device, generator, **opts)
