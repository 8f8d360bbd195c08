"""The whole SBQ beam search, one launch per query batch.

Replaces the JAX package's ``lax.while_loop`` in ``beam_search``
(pgvectorscale_tpu/graph/search.py:580), a device loop and not a Pallas
kernel, whose inner step is the TPU kernel ``hamming_edge_gather_pallas``;
the port ran it as a Python loop (``graph.search.beam_search_plain``) of
one host read and ~150 small launches an iteration.  Each query's state
(its beam, visit history, counters and rescore window) is its own, and a
query that has converged or spent its visit budget is left unchanged by
another iteration, so the kernel (``csrc/beam_search.cu``) runs each query
in its own block to its own end, and the batch's iteration count is the
largest of the queries' counts (one host read a batch).

Bound on an H100: bytes, behind the chain of dependent iterations.  The
least device-memory traffic is each distinct frontier row's R adjacency
ids, each distinct neighbour's code row (and label row when filtered),
the inputs and the outputs once (``bound_bytes``); the rows a search reads
again come from L2 (the 100k code table, 19.2 MB at W = 48, and the
adjacency fit in its 50 MB).  Each iteration waits on an adjacency read
and then on code-row reads, so the iterations of the longest query, two
L2 reads each, bound it too (``microbench/beam_ab.py`` measures both).

The kernel's design: one block a query, of 128 threads (8 blocks an SM: a
batch of 1,024 queries in one round) or, when that needs no more rounds
of blocks, 256; the dedup through hash tables of ids, the survivors
scored several rows a lane group at once, those that can reach the kept
entries sorted by (distance, slot or id) on registers and merged through
the plain version's bitonic network trimmed to the kept entries.  Its
state lives in shared memory, or, for a state over
``_build.MAX_SHARED_BYTES`` (a wide beam or window), in its slice of a
scratch buffer the wrapper allocates, through the same code.  Every step
keeps the plain version's stable orders and merge network, so every
output is bit-equal to it.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version, ``beam_search_plain``.  ``launches`` counts kernel
launches (under a lock: readers may search from several host threads).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from . import _build

launches = 0
_launch_lock = threading.Lock()


def count_launch() -> None:
    global launches
    with _launch_lock:
        launches += 1


def beam_search_codes_plain(arrays, query_codes, start_ids, query_labels=None, *,
                            search_list_size: int, max_iters: int, expand_factor: int,
                            track_hist: bool, window_n: int):
    """The plain version: ``graph.search.beam_search_plain`` on the codes."""
    from ..graph.search import beam_search_plain

    return beam_search_plain(
        arrays, query_codes, start_ids, search_list_size=search_list_size,
        max_iters=max_iters, expand_factor=expand_factor, track_hist=track_hist,
        use_codes=True, window_n=window_n, query_labels=query_labels,
    )


def _check(arrays, query_codes, start_ids, query_labels, l: int, h: int, e: int,
           window_n: int) -> None:
    dev = arrays.codes.device
    filtered = query_labels.shape[-1] > 0  # node_labels is read only then
    tensors = [("codes", arrays.codes), ("adjacency", arrays.adjacency),
               ("query_codes", query_codes), ("start_ids", start_ids),
               ("query_labels", query_labels)]
    tensors += [("node_labels", arrays.node_labels)] if filtered else []
    for name, t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, codes on {dev}")
    cap, w = arrays.codes.shape
    q = query_codes.shape[0]
    if cap == 0 or arrays.adjacency.shape[0] != cap or (
            filtered and arrays.node_labels.shape[0] != cap):
        raise ValueError("codes, adjacency and node_labels need the same cap > 0")
    if w == 0 or arrays.adjacency.shape[1] == 0 or query_codes.shape[1] != w:
        raise ValueError(f"query_codes rows hold {query_codes.shape[1]} words, codes rows "
                         f"{w}, adjacency rows {arrays.adjacency.shape[1]}: all need > 0 "
                         "and the words must agree")
    if start_ids.shape[0] != q or query_labels.shape[0] != q:
        raise ValueError(f"start_ids has {start_ids.shape[0]} rows and query_labels "
                         f"{query_labels.shape[0]}, query_codes {q}")
    if not 1 <= e <= l or h < 0 or window_n < 0:
        raise ValueError(f"need 1 <= expand_factor ({e}) <= search_list_size ({l}), "
                         f"max_iters ({h}) >= 0 and window_n ({window_n}) >= 0")
    r = arrays.adjacency.shape[1]
    if e * r * r >= 2**32:  # the kernel divides slots by R with a high multiply
        raise ValueError(f"expand_factor * R_max**2 ({e} * {r}**2) must stay below 2**32")
    check_sort_key(w, e * r, cap)


# The kernel sorts a query's candidates by one 64-bit key: the Hamming
# distance (at most 32 W) in the high SORT_KEY_FIELD_BITS bits, the
# tie-break (the slot, below E*R, in a narrow row; the id, below cap, in a
# wide one) in the low SORT_KEY_FIELD_BITS.
SORT_KEY_FIELD_BITS = 32
NARROW_ROW = 192  # E*R <= 192: ties by slot, else by id


def check_sort_key(w: int, er: int, cap: int) -> None:
    """Raise unless the distance and the tie-break each fit their field of
    the kernel's sort key."""
    top = 1 << SORT_KEY_FIELD_BITS
    tie_max = er - 1 if er <= NARROW_ROW else cap - 1
    if 32 * w >= top or tie_max >= top:
        raise ValueError(
            f"the sort key's {SORT_KEY_FIELD_BITS}-bit fields cannot hold a distance up to "
            f"{32 * w} (W={w}) and a tie-break up to {tie_max} (E*R={er}, cap={cap})")


def beam_search_codes(
    arrays,  # store.GraphArrays: codes, adjacency, node_labels are read
    query_codes: torch.Tensor,  # i32[Q, W]
    start_ids: torch.Tensor,  # i32[Q, S]
    query_labels: Optional[torch.Tensor] = None,  # i32[Q, Lq] (filtered when Lq > 0)
    *,
    search_list_size: int,
    max_iters: int,
    expand_factor: int = 1,
    track_hist: bool = True,
    window_n: int = 0,
    shared_limit: int = _build.MAX_SHARED_BYTES,
):
    """The SBQ beam search over ``arrays.codes`` (a ``graph.search
    .SearchResult``; arguments as ``beam_search_plain``'s).  On the card a
    query's state lives in shared memory when it takes at most
    ``shared_limit`` bytes, else in a scratch buffer."""
    from ..graph.search import SearchResult

    device = start_ids.device
    q = start_ids.shape[0]
    l, h, e = search_list_size, max_iters, expand_factor
    if query_labels is None:
        query_labels = torch.zeros((q, 0), dtype=torch.int32, device=device)
    _check(arrays, query_codes, start_ids, query_labels, l, h, e, window_n)
    if device.type == "cpu":
        return beam_search_codes_plain(
            arrays, query_codes, start_ids, query_labels, search_list_size=l, max_iters=h,
            expand_factor=e, track_hist=track_hist, window_n=window_n)
    if device.type != "cuda":
        raise ValueError(f"no beam-search kernel for device {device}")
    out, iters = launch(arrays, query_codes, start_ids, query_labels, search_list_size=l,
                        max_iters=h, expand_factor=e, track_hist=track_hist,
                        window_n=window_n, shared_limit=shared_limit)
    return SearchResult(iters=int(iters.max()) if q else 0, **out)


def launch(arrays, query_codes, start_ids, query_labels, *, search_list_size: int,
           max_iters: int, expand_factor: int, track_hist: bool, window_n: int,
           shared_limit: int = _build.MAX_SHARED_BYTES, lib=None):
    """One launch on checked CUDA inputs: (the SearchResult's tensors by
    field name, the per-query iteration counts i32[Q]); no host read.
    ``lib``: a library bound by ``bind`` (another build of the same C
    interface), else this checkout's."""
    q, s = start_ids.shape
    l, h, e = search_list_size, max_iters, expand_factor
    device = start_ids.device
    cap, w = arrays.codes.shape
    r = arrays.adjacency.shape[1]
    lq = query_labels.shape[1]
    lm = arrays.node_labels.shape[1] if lq else 0  # read only by a filtered search
    h_cap = h if track_hist else 1
    wn = window_n if window_n > 0 else 1
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    out = dict(
        beam_ids=torch.empty((q, l), **i32), beam_dists=torch.empty((q, l), **f32),
        beam_visited=torch.empty((q, l), dtype=torch.bool, device=device),
        hist_ids=torch.empty((q, h_cap), **i32), hist_dists=torch.empty((q, h_cap), **f32),
        n_visited=torch.empty((q,), **i32), n_dist_comps=torch.empty((q,), **i32),
        window_ids=torch.empty((q, wn), **i32), window_dists=torch.empty((q, wn), **f32),
    )
    iters = torch.empty((q,), **i32)
    if q == 0:
        return out, iters
    lib = lib or _kernel()
    state = lib.pgvs_beam_search_state_bytes(l, window_n, e, r)
    scratch = (torch.empty((q * state,), dtype=torch.uint8, device=device)
               if state + query_bytes(w, lq) > shared_limit else None)
    o = out
    err = lib.pgvs_beam_search(
        arrays.codes.data_ptr(), arrays.adjacency.data_ptr(),
        arrays.node_labels.data_ptr() if lq else None,
        query_codes.data_ptr(), start_ids.data_ptr(), query_labels.data_ptr(),
        o["beam_ids"].data_ptr(), o["beam_dists"].data_ptr(), o["beam_visited"].data_ptr(),
        o["hist_ids"].data_ptr(), o["hist_dists"].data_ptr(), o["n_visited"].data_ptr(),
        o["n_dist_comps"].data_ptr(), o["window_ids"].data_ptr(), o["window_dists"].data_ptr(),
        iters.data_ptr(), None if scratch is None else scratch.data_ptr(),
        q, cap, w, r, lm, s, lq, l, h, int(track_hist), e, window_n,
        device.index if device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"beam-search kernel launch failed: CUDA error {err}")
    count_launch()
    return out, iters


def state_bytes(search_list_size: int, window_n: int, expand_factor: int, r_max: int) -> int:
    """Bytes of one query's state in the kernel (shared memory or scratch)."""
    return _kernel().pgvs_beam_search_state_bytes(search_list_size, window_n, expand_factor,
                                                  r_max)


def query_bytes(w: int, lq: int) -> int:
    """Shared memory the kernel takes besides the state: the query's code
    row and labels, each rounded up to 16 bytes."""
    return 4 * (-(-w // 4) * 4 + -(-lq // 4) * 4)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface's argument types on a loaded library."""
    fn = lib.pgvs_beam_search
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sb = lib.pgvs_beam_search_state_bytes
    sb.argtypes = [ctypes.c_int] * 4
    sb.restype = ctypes.c_longlong
    return lib


def _kernel():
    return bind(_build.load("beam_search"))


def bound_bytes(q: int, w: int, r_max: int, s: int, lq: int, lm: int, out_bytes: int,
                visited_rows: int, nbr_rows: int) -> int:
    """Bytes the search must move from device memory: the R adjacency ids
    of each of the ``visited_rows`` distinct frontier rows, the code row
    (and, filtered, the label row) of each of the ``nbr_rows`` distinct
    neighbours, the query codes, start ids and query labels read once, and
    the ``out_bytes`` of the outputs written once."""
    per_nbr = w + (lm if lq > 0 else 0)
    return (visited_rows * r_max + nbr_rows * per_nbr + q * (w + s + lq)) * 4 + out_bytes


def check_inputs(q: int, cap: int, w: int, r: int, s: int = 1, lm: int = 0, lq: int = 0,
                 word_values: int = 2**31, invalid_share: float = 0.23, device="cpu",
                 generator=None):
    """Random inputs of one kernel check: (arrays, query_codes [Q, W],
    start_ids [Q, S], query_labels [Q, Lq]).  ``arrays`` is a GraphArrays
    whose codes, adjacency and node_labels are random: code words drawn
    from [0, word_values) (a small range makes equal distances common),
    ``invalid_share`` of the adjacency INVALID_ID, labels from 4 values
    with ~25% sentinel padding.  Start ids: one column in [0, cap), the
    rest ~25% INVALID_ID and the last a copy of the first (a duplicate)."""
    from ..store import GraphArrays

    kw = dict(device=device, generator=generator)
    i32 = dict(dtype=torch.int32, **kw)
    lo = -(2**31) if word_values == 2**31 else 0
    hi = 2**31 - 1 if word_values == 2**31 else word_values
    codes = torch.randint(lo, hi, (cap, w), **i32)
    adjacency = torch.randint(0, cap, (cap, r), **i32)
    adjacency[torch.rand((cap, r), **kw) < invalid_share] = -1

    def labels(shape):
        lab = torch.randint(0, 4, shape, **i32)
        lab[torch.rand(shape, **kw) < 0.25] = 2**31 - 1
        return lab

    starts = torch.randint(0, cap, (q, s), **i32)
    if s > 1:
        starts[:, 1:][torch.rand((q, s - 1), **kw) < 0.25] = -1
        starts[:, -1] = starts[:, 0]
    arrays = GraphArrays(
        vectors=torch.zeros((cap, 0), dtype=torch.float32, device=device), codes=codes,
        adjacency=adjacency, deleted=torch.zeros((cap,), dtype=torch.bool, device=device),
        count=cap, default_start=0, node_labels=labels((cap, lm)),
        label_start_keys=torch.zeros((0,), dtype=torch.int32, device=device),
        label_start_ids=torch.zeros((0,), dtype=torch.int32, device=device),
        vec_scales=torch.ones((cap,), dtype=torch.float32, device=device),
    )
    return arrays, torch.randint(lo, hi, (q, w), **i32), starts, labels((q, lq))


# Ids above 2**20, as SIFT-1M's 1,000,448 slots give them.
WIDE_ID_CAP = 1_000_448

# The cases the kernel is held to on the card (tests/test_torch_kernels.py):
# check_inputs arguments, then the search's.  Narrow (E*R <= 192) and wide
# rows, heavy ties (4-valued code words), windows, filtered searches (one
# and two query labels, sentinel padding), no history, a visit budget that
# binds, the scratch path (shared_limit 0), and W = 1, 16, 192 and 500.
# Then the inputs that stress the kernel's hashed dedup and sort: every
# code word equal (every distance ties, the tie-break alone orders), in a
# narrow and a wide row; 64 and 128 slots (adjacency rows full of repeated
# ids, colliding hash slots); a wide row over ids above 2**20 (the id
# tie-break's key width); E*R = 520 with no empty slot (two passes of the
# kernel's 512-slot expansion, and more keys than its register sort holds).
CHECK_CASES = [
    (dict(q=64, cap=4096, w=48, r=65), dict(search_list_size=32, max_iters=64, expand_factor=2)),
    (dict(q=64, cap=4096, w=48, r=65), dict(search_list_size=32, max_iters=64, expand_factor=4)),
    (dict(q=64, cap=512, w=4, r=17, word_values=4),
     dict(search_list_size=16, max_iters=40, expand_factor=2, window_n=50)),
    (dict(q=64, cap=512, w=4, r=65, word_values=4),
     dict(search_list_size=24, max_iters=40, expand_factor=4, window_n=30)),
    (dict(q=64, cap=2048, w=8, r=65, s=2, lm=2, lq=1, word_values=4),
     dict(search_list_size=32, max_iters=64, expand_factor=2)),
    (dict(q=64, cap=2048, w=8, r=65, s=3, lm=2, lq=2, word_values=4),
     dict(search_list_size=32, max_iters=64, expand_factor=4, window_n=100)),
    (dict(q=64, cap=4096, w=48, r=65),
     dict(search_list_size=64, max_iters=96, expand_factor=4, window_n=200, track_hist=False)),
    (dict(q=64, cap=4096, w=48, r=65), dict(search_list_size=64, max_iters=8, expand_factor=4)),
    (dict(q=32, cap=4096, w=48, r=65),
     dict(search_list_size=64, max_iters=96, expand_factor=2, window_n=300, shared_limit=0)),
    (dict(q=64, cap=1024, w=1, r=9), dict(search_list_size=16, max_iters=32, expand_factor=1)),
    (dict(q=64, cap=4096, w=16, r=65), dict(search_list_size=32, max_iters=64, expand_factor=4)),
    (dict(q=32, cap=4096, w=192, r=65), dict(search_list_size=32, max_iters=64, expand_factor=2)),
    (dict(q=16, cap=1024, w=500, r=21), dict(search_list_size=32, max_iters=64, expand_factor=2)),
    (dict(q=64, cap=4096, w=48, r=65, word_values=1),
     dict(search_list_size=32, max_iters=64, expand_factor=2, window_n=100)),
    (dict(q=64, cap=4096, w=8, r=65, word_values=1),
     dict(search_list_size=64, max_iters=96, expand_factor=4)),
    (dict(q=64, cap=64, w=8, r=65, word_values=4),
     dict(search_list_size=32, max_iters=64, expand_factor=4, window_n=60)),
    (dict(q=64, cap=128, w=4, r=33, word_values=4),
     dict(search_list_size=16, max_iters=40, expand_factor=2)),
    (dict(q=32, cap=WIDE_ID_CAP, w=16, r=65, word_values=4),
     dict(search_list_size=100, max_iters=166, expand_factor=4)),
    (dict(q=32, cap=4096, w=16, r=65, invalid_share=0.0),
     dict(search_list_size=64, max_iters=96, expand_factor=8)),
]

RESULT_FIELDS = ("beam_ids", "beam_dists", "beam_visited", "hist_ids", "hist_dists",
                 "n_visited", "n_dist_comps", "window_ids", "window_dists")


def results_equal(a, b) -> list:
    """The fields of two SearchResults that differ (``iters`` included);
    empty when every field is bit-equal."""
    bad = [f for f in RESULT_FIELDS if not torch.equal(getattr(a, f), getattr(b, f))]
    return bad + (["iters"] if a.iters != b.iters else [])
