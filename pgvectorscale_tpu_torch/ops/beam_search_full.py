"""The whole full-precision beam search, one launch per query batch.

Replaces the JAX package's ``lax.while_loop`` in ``beam_search``
(pgvectorscale_tpu/graph/search.py:580) with ``use_codes=False``: the
traversal of plain storage and of builds with ``build_distance="exact"``,
whose scoring branch is ``_candidate_distances`` (:200-235) on the rows'
indexed prefix.  The port ran it as a Python loop
(``graph.search.beam_search_plain``) of one host read and ~150 small
launches an iteration, gathering [Q, E*R, Dt] rows through
``distance.row_distances``.  The kernel (``csrc/beam_search_full.cu``) runs
each query in its own block to its own end, as the SBQ kernel does.  A
survivor that its query scored in an earlier iteration takes its distance
from a per-query memo (an id -> distance table in the query's state); the
others are read and scored in place (``csrc/rowdist.cuh``, a warp a row):
when the rows start on 16 bytes, each warp streams them into a ring of
``slots`` row buffers in shared memory by asynchronous copies (each lane
``cp.async``'s its own 16-byte chunks), ``slots`` rows ahead of the one it
dots.  No gathered rows are materialised.

Bound on an H100: bytes, behind the chain of dependent iterations.  The
least device-memory traffic of a query is each distinct row it scores (Dt
elements), each distinct frontier row's R adjacency ids (and each
filtered neighbour's label row), its inputs and its outputs, once
(``bound_bytes`` counts the batch's distinct rows once); the 100k x 768
f32 table (307 MB) does not stay in the 50 MB L2.  A batch is bound by the
bytes of its queries' distinct rows, which the memo reads once a query; a
query alone by one SM's rate from device memory (about 55 GB/s for random
3 KB rows on an H100, ``microbench/sm_read_rate.cu``): its misses' bytes
an iteration over that rate, behind the chain of an adjacency read
(``plan``: a block of 512 threads and up to 6 ring slots a warp for a
batch no larger than the SMs; blocks of 256 and 2 slots for a larger one,
which keeps two blocks an SM).

Parity: every step is the plain version's, with its stable orders and its
bitonic merge network; the distances are sums in another order, so the
outputs are bit-equal to the plain version's where those sums are exact in
any order (integer-valued rows), and otherwise within float32 rounding.  A
memo hit is the float that scoring the row again gives (the same code on
the same row and query), so the memo changes no output; ``n_dist_comps``
counts the survivors, as the plain version does.  Candidates are ranked by
64-bit keys: the distance's bits made to order as the floats do (-0.0
taken as +0.0, which it equals, as in ``torch.sort``), then the
tie-break; every float maps, so no range limits the distances (negative
ones included: inner product) or the ids.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version, ``beam_search_full_plain``.  ``launches`` counts kernel
launches (under a lock: readers may search from several host threads).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from ..config import DistanceType
from . import _build

launches = 0
_launch_lock = threading.Lock()

# The kernel's row types (csrc/rowdist.cuh RowDtype).
ROW_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def count_launch() -> None:
    global launches
    with _launch_lock:
        launches += 1


def beam_search_full_plain(arrays, query_vecs, start_ids, query_labels=None, *,
                           search_list_size: int, max_iters: int, expand_factor: int = 1,
                           track_hist: bool = True, window_n: int = 0,
                           distance_type: DistanceType, on_scored=None):
    """The plain version: ``graph.search.beam_search_plain`` in full precision."""
    from ..graph.search import beam_search_plain

    q = start_ids.shape[0]
    no_codes = torch.zeros((q, 0), dtype=torch.int32, device=start_ids.device)
    return beam_search_plain(
        arrays, no_codes, start_ids, search_list_size=search_list_size, max_iters=max_iters,
        expand_factor=expand_factor, track_hist=track_hist, query_vecs=query_vecs,
        use_codes=False, distance_type=distance_type, window_n=window_n,
        query_labels=query_labels, on_scored=on_scored,
    )


def distinct_scored_plain(arrays, query_vecs, start_ids, query_labels=None, **search):
    """The plain loop's SearchResult and, per query, the distinct rows it
    scored (start nodes and survivors), i32[Q]: ``n_dist_comps`` minus it
    is the scoring of rows that the query had scored before."""
    seen = []
    result = beam_search_full_plain(
        arrays, query_vecs, start_ids, query_labels,
        on_scored=lambda ids, valid: seen.append(torch.where(valid, ids, -1)), **search)
    ids = torch.sort(torch.cat(seen, dim=1), dim=1).values
    first = torch.cat([ids[:, :1] >= 0, (ids[:, 1:] != ids[:, :-1]) & (ids[:, 1:] >= 0)], dim=1)
    return result, first.sum(dim=1, dtype=torch.int32)


def check_rows(arrays, query_vecs: torch.Tensor) -> None:
    """Raise unless the row table, its scales and the queries' prefixes are
    what the full-precision kernels take: rows f32, bf16 or int8 [cap, D]
    (int8 with f32 scales [cap]) and the prefixes f32 [..., Dt], Dt <= D,
    all contiguous on the rows' device."""
    vecs = arrays.vectors
    if vecs.dtype not in ROW_DTYPES:
        raise TypeError(f"vectors must be float32, bfloat16 or int8, got {vecs.dtype}")
    if query_vecs.dtype != torch.float32:
        raise TypeError(f"query_vecs must be float32, got {query_vecs.dtype}")
    if vecs.dim() != 2 or vecs.shape[0] == 0 or vecs.shape[1] == 0:
        raise ValueError(f"vectors must be [cap > 0, D > 0], got {tuple(vecs.shape)}")
    dt = query_vecs.shape[-1]
    if not 0 < dt <= vecs.shape[1]:
        raise ValueError(f"the query prefix has {dt} dims, the rows {vecs.shape[1]}")
    tensors = [("vectors", vecs), ("query_vecs", query_vecs)]
    if vecs.dtype == torch.int8:
        scales = arrays.vec_scales
        if scales is None or scales.dtype != torch.float32 or scales.shape != (vecs.shape[0],):
            raise ValueError("int8 rows need float32 scales [cap]")
        tensors.append(("vec_scales", scales))
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != vecs.device:
            raise ValueError(f"{name} is on {t.device}, vectors on {vecs.device}")


def _check(arrays, query_vecs, start_ids, query_labels, l: int, h: int, e: int,
           window_n: int) -> None:
    check_rows(arrays, query_vecs)
    dev = arrays.vectors.device
    filtered = query_labels.shape[-1] > 0  # node_labels is read only then
    tensors = [("adjacency", arrays.adjacency), ("start_ids", start_ids),
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
            raise ValueError(f"{name} is on {t.device}, vectors on {dev}")
    cap = arrays.vectors.shape[0]
    q = start_ids.shape[0]
    if query_vecs.dim() != 2 or query_vecs.shape[0] != q or query_labels.shape[0] != q:
        raise ValueError(f"query_vecs {tuple(query_vecs.shape)} and query_labels "
                         f"{tuple(query_labels.shape)} need the {q} rows of start_ids")
    if arrays.adjacency.shape[0] != cap or arrays.adjacency.shape[1] == 0 or (
            filtered and arrays.node_labels.shape[0] != cap):
        raise ValueError("vectors, adjacency and node_labels need the same cap, and "
                         "adjacency rows > 0 slots")
    if not 1 <= e <= l or h < 0 or window_n < 0:
        raise ValueError(f"need 1 <= expand_factor ({e}) <= search_list_size ({l}), "
                         f"max_iters ({h}) >= 0 and window_n ({window_n}) >= 0")


def beam_search_full(
    arrays,  # store.GraphArrays: vectors, vec_scales, adjacency, node_labels are read
    query_vecs: torch.Tensor,  # f32[Q, Dt] (the queries' indexed prefixes)
    start_ids: torch.Tensor,  # i32[Q, S]
    query_labels: Optional[torch.Tensor] = None,  # i32[Q, Lq] (filtered when Lq > 0)
    *,
    search_list_size: int,
    max_iters: int,
    expand_factor: int = 1,
    track_hist: bool = True,
    window_n: int = 0,
    distance_type: DistanceType,
    shared_limit: int = _build.MAX_SHARED_BYTES,
):
    """The full-precision beam search over ``arrays.vectors`` (a
    ``graph.search.SearchResult``; arguments as ``beam_search_plain``'s).
    On the card a query's state lives in shared memory when it and the
    query's prefix take at most ``shared_limit`` bytes, else in a scratch
    buffer; the prefix stays in shared memory while it fits beside it."""
    from ..graph.search import SearchResult

    device = start_ids.device
    q = start_ids.shape[0]
    l, h, e = search_list_size, max_iters, expand_factor
    if query_labels is None:
        query_labels = torch.zeros((q, 0), dtype=torch.int32, device=device)
    _check(arrays, query_vecs, start_ids, query_labels, l, h, e, window_n)
    if device.type == "cpu":
        return beam_search_full_plain(
            arrays, query_vecs, start_ids, query_labels, search_list_size=l, max_iters=h,
            expand_factor=e, track_hist=track_hist, window_n=window_n,
            distance_type=distance_type)
    if device.type != "cuda":
        raise ValueError(f"no beam-search kernel for device {device}")
    out, iters = launch(arrays, query_vecs, start_ids, query_labels, search_list_size=l,
                        max_iters=h, expand_factor=e, track_hist=track_hist,
                        window_n=window_n, distance_type=distance_type,
                        shared_limit=shared_limit)
    return SearchResult(iters=int(iters.max()) if q else 0, **out)


def placement(state: int, query: int, shared_limit: int) -> tuple[bool, bool]:
    """(state in shared memory, query prefix in shared memory) for a state
    and a prefix of these bytes: both while they fit together, else the
    state first, else the prefix alone."""
    if state + query <= shared_limit:
        return True, True
    if state <= shared_limit:
        return True, False
    return False, query <= shared_limit


# A batch no larger than the SMs runs a block of ALONE_THREADS an SM: the
# memo at its most entries and the deepest ring up to RING_SLOTS_ALONE
# beside the state and the prefix (2 slots at the 768-wide f32 search: 32
# rows in flight a block).  A larger batch runs blocks of BATCH_THREADS,
# BATCH_BLOCKS an SM (an SM holds 512 threads of the kernel's 128
# registers): a ring of RING_SLOTS_BATCH and the largest memo that fits
# beside it (4,096 entries at that search).
ALONE_THREADS, BATCH_THREADS = 512, 256
RING_SLOTS_ALONE, RING_SLOTS_BATCH, BATCH_BLOCKS = 6, 2, 2
# An H100 SM's shared memory (228 KB), of which each block reserves 1 KB.
SM_SHARED_BYTES, BLOCK_RESERVED_BYTES = 233_472, 1024
# The smallest memo a batch's plan takes to fit its blocks, and the one it
# takes when the state goes to the scratch buffer anyway (log2 of entries).
MIN_MEMO_LOG2, SCRATCH_MEMO_LOG2 = 8, 12


def rows_vectorizable(vecs: torch.Tensor) -> bool:
    """Whether the rows start on 16 bytes (``rowdist.cuh``'s test): the
    ring's 16-byte copies need it."""
    return vecs.data_ptr() % 16 == 0 and vecs.shape[1] * vecs.element_size() % 16 == 0


def plan(lib, *, q: int, sms: int, l: int, window_n: int, e: int, r: int, dt: int,
         dtype: torch.dtype, vec: bool, shared_limit: int, slots: Optional[int] = None,
         memo_log2: Optional[int] = None, threads: Optional[int] = None) -> dict:
    """How a launch runs: ``threads`` a block, ``memo_log2`` (the memo's
    2^memo_log2 entries), ``slots`` (ring slots a warp; 0 without the ring:
    the rows are not on 16 bytes or no ring fits), ``state_bytes`` (a
    query's state, the memo included), ``state_shared`` and
    ``query_shared`` (else the scratch buffer, else device memory).  A
    batch within ``sms`` takes ALONE_THREADS, the largest memo and the
    deepest ring up to RING_SLOTS_ALONE that fits beside the state and the
    prefix, else beside the state, else alone (the state goes to the
    scratch buffer); a larger batch BATCH_THREADS, RING_SLOTS_BATCH and the
    largest memo with which BATCH_BLOCKS blocks fit an SM (at least
    2^MIN_MEMO_LOG2 entries; 2^SCRATCH_MEMO_LOG2 when even the smallest does
    not fit and the state goes to the scratch buffer).  ``slots``,
    ``memo_log2`` and ``threads`` given: those, for a comparison."""
    query = lib.pgvs_beam_search_full_query_bytes(dt)
    code = ROW_DTYPES[dtype]
    most = lib.pgvs_beam_search_full_memo_entries().bit_length() - 1
    alone = q <= sms
    if threads is None:
        threads = ALONE_THREADS if alone else BATCH_THREADS

    def ring(k: int) -> int:
        return lib.pgvs_beam_search_full_ring_bytes(k, dt, code, threads)

    def state(m: int) -> int:
        return lib.pgvs_beam_search_full_state_bytes(l, window_n, e, r, m)

    if slots is None:
        want = (RING_SLOTS_ALONE if alone else RING_SLOTS_BATCH) if vec else 0
        depths = range(want, 0, -1)
        st = state(most if memo_log2 is None else memo_log2)
        slots = next((k for k in depths if ring(k) + st + query <= shared_limit),
                     next((k for k in depths if ring(k) + st <= shared_limit),
                          next((k for k in depths if ring(k) <= shared_limit), 0)))
    if memo_log2 is None:
        memo_log2 = most
        if not alone:
            budget = min(shared_limit,
                         SM_SHARED_BYTES // BATCH_BLOCKS - BLOCK_RESERVED_BYTES) - ring(slots)
            least = min(MIN_MEMO_LOG2, most)
            if state(least) + query > budget:
                memo_log2 = min(SCRATCH_MEMO_LOG2, most)
            else:
                while state(memo_log2) + query > budget:
                    memo_log2 -= 1
    state_bytes = state(memo_log2)
    state_shared, query_shared = placement(state_bytes, query, shared_limit - ring(slots))
    return dict(state_bytes=state_bytes, state_shared=state_shared, query_shared=query_shared,
                slots=slots, memo_log2=memo_log2, threads=threads)


def launch(arrays, query_vecs, start_ids, query_labels, *, search_list_size: int,
           max_iters: int, expand_factor: int, track_hist: bool, window_n: int,
           distance_type: DistanceType, shared_limit: int = _build.MAX_SHARED_BYTES,
           lib=None, rows_read: Optional[torch.Tensor] = None, slots: Optional[int] = None,
           memo_log2: Optional[int] = None, threads: Optional[int] = None):
    """One launch on checked CUDA inputs: (the SearchResult's tensors by
    field name, the per-query iteration counts i32[Q]); no host read.
    ``lib``: a library bound by ``bind`` (another build of the same C
    interface), else this checkout's.  ``rows_read`` (diagnostics): an
    i32[Q] tensor that gets the rows each query read (survivors the memo
    did not hold, and start nodes).  ``slots``, ``memo_log2``, ``threads``:
    in place of ``plan``'s, to compare launches of other shapes."""
    q, s = start_ids.shape
    l, h, e = search_list_size, max_iters, expand_factor
    device = start_ids.device
    vecs = arrays.vectors
    cap, d = vecs.shape
    dt = query_vecs.shape[1]
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
    if rows_read is not None and (rows_read.dtype != torch.int32 or rows_read.shape != (q,)
                                  or rows_read.device != device):
        raise ValueError("rows_read must be int32 [Q] on the queries' device")
    index = device.index if device.index is not None else torch.cuda.current_device()
    where = plan(lib, q=q, sms=torch.cuda.get_device_properties(index).multi_processor_count,
                 l=l, window_n=window_n, e=e, r=r, dt=dt, dtype=vecs.dtype,
                 vec=rows_vectorizable(vecs), shared_limit=shared_limit, slots=slots,
                 memo_log2=memo_log2, threads=threads)
    scratch = None if where["state_shared"] else torch.empty(
        (q * where["state_bytes"],), dtype=torch.uint8, device=device)
    int8 = vecs.dtype == torch.int8
    o = out
    err = lib.pgvs_beam_search_full(
        vecs.data_ptr(), arrays.vec_scales.data_ptr() if int8 else None,
        arrays.adjacency.data_ptr(), arrays.node_labels.data_ptr() if lq else None,
        query_vecs.data_ptr(), start_ids.data_ptr(), query_labels.data_ptr(),
        o["beam_ids"].data_ptr(), o["beam_dists"].data_ptr(), o["beam_visited"].data_ptr(),
        o["hist_ids"].data_ptr(), o["hist_dists"].data_ptr(), o["n_visited"].data_ptr(),
        o["n_dist_comps"].data_ptr(), o["window_ids"].data_ptr(), o["window_dists"].data_ptr(),
        iters.data_ptr(), None if rows_read is None else rows_read.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        q, cap, d, dt, ROW_DTYPES[vecs.dtype], int(distance_type), r, lm, s, lq, l, h,
        int(track_hist), e, window_n, int(where["query_shared"]), where["slots"],
        where["memo_log2"], where["threads"], index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"full-precision beam-search kernel launch failed: CUDA error {err}")
    count_launch()
    return out, iters


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface's argument types on a loaded library."""
    fn = lib.pgvs_beam_search_full
    fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 17 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    for name, n_args in (("state_bytes", 5), ("query_bytes", 1), ("ring_bytes", 4)):
        f = getattr(lib, f"pgvs_beam_search_full_{name}")
        f.argtypes = [ctypes.c_int] * n_args
        f.restype = ctypes.c_longlong
    me = lib.pgvs_beam_search_full_memo_entries
    me.argtypes = []
    me.restype = ctypes.c_int
    return lib


def _kernel():
    return bind(_build.load("beam_search_full"))


def bound_bytes(q: int, dt: int, row_bytes: int, r_max: int, s: int, lq: int, lm: int,
                out_bytes: int, visited_rows: int, scored_rows: int,
                int8: bool = False) -> int:
    """Bytes the search must move from device memory: the R adjacency ids
    of each of the ``visited_rows`` distinct frontier rows, the Dt elements
    of ``row_bytes`` (and, int8, the scale; filtered, the label row) of each
    of the ``scored_rows`` distinct scored rows, the query prefixes, start
    ids and query labels read once, and the ``out_bytes`` of the outputs
    written once."""
    per_row = dt * row_bytes + (4 if int8 else 0) + (4 * lm if lq > 0 else 0)
    return (visited_rows * r_max * 4 + scored_rows * per_row + q * (4 * dt + 4 * s + 4 * lq)
            + out_bytes)


def check_inputs(q: int, cap: int, d: int, r: int, dt: Optional[int] = None, s: int = 1,
                 lm: int = 0, lq: int = 0, dtype: torch.dtype = torch.float32,
                 values: int = 3, invalid_share: float = 0.23, device="cpu",
                 generator=None):
    """Random inputs of one kernel check: (arrays, query_vecs [Q, Dt],
    start_ids [Q, S], query_labels [Q, Lq]).  Rows and queries hold integers
    in [-values, values] (every distance an exact integer in any summation
    order, ties common), stored as ``dtype``; int8 rows carry random scales
    in [0.5, 1.5) (``values`` 0: unit-norm float rows and queries instead,
    as a cosine index stores them, int8 from them with their maxabs
    scale; every partial sum of a distance then stays within [-2, 2], so
    float32 sums in two orders differ by well under 1e-5).  The graph: ``invalid_share`` of the
    adjacency INVALID_ID, labels from 4 values with ~25% sentinel padding;
    start ids one column in [0, cap), the rest ~25% INVALID_ID and the last
    a copy of the first (a duplicate)."""
    from ..store import GraphArrays

    dt = d if dt is None else dt
    kw = dict(device=device, generator=generator)
    i32 = dict(dtype=torch.int32, **kw)
    scales = torch.ones((cap,), dtype=torch.float32, device=device)
    if values > 0:
        rows = torch.randint(-values, values + 1, (cap, d), **i32).to(torch.float32)
        qv = torch.randint(-values, values + 1, (q, dt), **i32).to(torch.float32)
        if dtype == torch.int8:
            scales = 0.5 + torch.rand((cap,), **kw)
    else:  # unit rows and queries, as a cosine index stores them
        rows = torch.randn((cap, d), **kw)
        rows = rows / rows.norm(dim=1, keepdim=True)
        qv = torch.randn((q, dt), **kw)
        qv = qv / qv.norm(dim=1, keepdim=True)
        if dtype == torch.int8:
            scales = rows.abs().amax(dim=1).clamp_min(1e-30) / 127
            rows = torch.round(rows / scales[:, None])
    vectors = rows.to(dtype)
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
        vectors=vectors, codes=torch.zeros((cap, 0), dtype=torch.int32, device=device),
        adjacency=adjacency, deleted=torch.zeros((cap,), dtype=torch.bool, device=device),
        count=cap, default_start=0, node_labels=labels((cap, lm)),
        label_start_keys=torch.zeros((0,), dtype=torch.int32, device=device),
        label_start_ids=torch.zeros((0,), dtype=torch.int32, device=device),
        vec_scales=scales,
    )
    return arrays, qv.contiguous(), starts, labels((q, lq))


# The cases the kernel is held to on the card (tests/test_torch_kernels.py):
# check_inputs arguments, then the search's.  Integer rows (``values`` > 0)
# under L2 and inner product in f32 and bf16 must be bit-equal to the plain
# loop; int8 rows, cosine and float rows (``values`` 0) are held within
# float32 rounding (``results_close``).  Narrow (E*R <= 192) and wide rows,
# windows, 1- and 2-label filtered searches, no history, a visit budget that
# binds, the three placements besides all in shared memory (the state in
# the scratch buffer with the prefix in shared memory, the state in shared
# memory with the prefix read from device memory, both in device memory;
# no room for the rows' ring in any), a prefix shorter than the row
# (Matryoshka) and a row stride that rules out 16-byte loads and the ring
# (D = 33), R = 65, heavy ties (values 1); then a graph of 256 rows whose
# neighbourhoods overlap (most survivors hit the memo), and the state and
# its memo in the scratch buffer with the ring in shared memory.
CHECK_CASES = [
    (dict(q=64, cap=4096, d=64, r=65),
     dict(search_list_size=32, max_iters=64, expand_factor=2, distance_type=DistanceType.L2)),
    (dict(q=64, cap=4096, d=64, r=65),
     dict(search_list_size=32, max_iters=64, expand_factor=4,
          distance_type=DistanceType.INNER_PRODUCT)),
    (dict(q=64, cap=2048, d=48, r=17, dtype=torch.bfloat16, values=1),
     dict(search_list_size=16, max_iters=40, expand_factor=2, window_n=50,
          distance_type=DistanceType.L2)),
    (dict(q=64, cap=2048, d=48, r=65, dtype=torch.bfloat16),
     dict(search_list_size=24, max_iters=40, expand_factor=4, window_n=30,
          distance_type=DistanceType.INNER_PRODUCT)),
    (dict(q=64, cap=2048, d=32, r=65, s=2, lm=2, lq=1),
     dict(search_list_size=32, max_iters=64, expand_factor=2, distance_type=DistanceType.L2)),
    (dict(q=64, cap=2048, d=32, r=65, s=3, lm=2, lq=2, values=1),
     dict(search_list_size=32, max_iters=64, expand_factor=4, window_n=100,
          distance_type=DistanceType.INNER_PRODUCT)),
    (dict(q=64, cap=4096, d=96, dt=40, r=65),
     dict(search_list_size=64, max_iters=96, expand_factor=4, window_n=200, track_hist=False,
          distance_type=DistanceType.L2)),
    (dict(q=64, cap=4096, d=33, r=65),
     dict(search_list_size=64, max_iters=8, expand_factor=4, distance_type=DistanceType.L2)),
    (dict(q=32, cap=4096, d=64, r=65),
     dict(search_list_size=64, max_iters=96, expand_factor=2, window_n=300, shared_limit=1024,
          distance_type=DistanceType.INNER_PRODUCT)),
    (dict(q=32, cap=4096, d=768, r=65),
     dict(search_list_size=32, max_iters=48, expand_factor=4, shared_limit=12_000,
          distance_type=DistanceType.L2)),
    (dict(q=32, cap=4096, d=96, r=65, s=2),
     dict(search_list_size=48, max_iters=64, expand_factor=2, window_n=60, shared_limit=0,
          distance_type=DistanceType.L2)),
    (dict(q=64, cap=4096, d=64, r=65, dtype=torch.int8),
     dict(search_list_size=32, max_iters=64, expand_factor=4, distance_type=DistanceType.L2)),
    (dict(q=64, cap=4096, d=100, r=65, dtype=torch.int8, values=0),
     dict(search_list_size=32, max_iters=64, expand_factor=2,
          distance_type=DistanceType.COSINE)),
    (dict(q=64, cap=4096, d=64, r=65, values=0),
     dict(search_list_size=32, max_iters=64, expand_factor=4,
          distance_type=DistanceType.INNER_PRODUCT)),
    (dict(q=64, cap=256, d=64, r=65),
     dict(search_list_size=32, max_iters=64, expand_factor=4, distance_type=DistanceType.L2)),
    (dict(q=32, cap=4096, d=64, r=65, s=2),
     dict(search_list_size=64, max_iters=96, expand_factor=2, window_n=300,
          shared_limit=40_000, distance_type=DistanceType.INNER_PRODUCT)),
]

RESULT_FIELDS = ("beam_ids", "beam_dists", "beam_visited", "hist_ids", "hist_dists",
                 "n_visited", "n_dist_comps", "window_ids", "window_dists")


def exact_case(inputs: dict, search: dict) -> bool:
    """Whether a case's distances are exact in any summation order (integer
    rows under L2 or inner product, f32 or bf16): the kernel must then equal
    the plain loop bit for bit."""
    return (inputs.get("values", 3) > 0
            and inputs.get("dtype", torch.float32) in (torch.float32, torch.bfloat16)
            and search["distance_type"] in (DistanceType.L2, DistanceType.INNER_PRODUCT))


def results_equal(a, b) -> list:
    """The fields of two SearchResults that differ (``iters`` included);
    empty when every field is bit-equal."""
    bad = [f for f in RESULT_FIELDS if not torch.equal(getattr(a, f), getattr(b, f))]
    return bad + (["iters"] if a.iters != b.iters else [])


RTOL = 1e-5


def rows_close(ids_a, d_a, ids_b, d_b, rtol: float = RTOL) -> list:
    """The rows of two [N, M] (ids, distances) pairs that differ beyond
    float32 rounding, as (row, entry): distances within ``rtol`` relative
    to the larger of their magnitudes and 1 (+inf equal to +inf) and ids
    equal, up to the first entry where they part.  Rounding may swap
    near-ties, after which two traversals may take them in the other order
    but find the same rows: so that entry must be a near-tie (both
    distances finite and within ``rtol``), and from it on the two rows must
    hold the same distances within ``rtol`` once sorted."""

    def close(x, y):
        fin = torch.isfinite(x) & torch.isfinite(y)
        near = (x - y).abs() <= rtol * torch.maximum(x.abs(), y.abs()).clamp_min(1.0)
        return fin, near, torch.where(fin, near, x == y)

    fin, near, dist_same = close(d_a, d_b)
    same = (ids_a == ids_b) & dist_same
    bad = []
    for row in torch.nonzero(~same.all(dim=1)).flatten().tolist():
        j = int((~same[row]).int().argmax())
        rest = close(torch.sort(d_a[row, j:]).values, torch.sort(d_b[row, j:]).values)[2]
        if not bool(near[row, j] & fin[row, j]) or not bool(rest.all()):
            bad.append((row, j))
    return bad


def results_close(a, b, rtol: float = RTOL) -> list:
    """The fields of two SearchResults that differ beyond float32 rounding
    (``rows_close`` of the beam, the history and the window); empty when
    they agree."""
    bad = []
    for ids_f, d_f in (("beam_ids", "beam_dists"), ("hist_ids", "hist_dists"),
                       ("window_ids", "window_dists")):
        rows = rows_close(getattr(a, ids_f), getattr(a, d_f), getattr(b, ids_f),
                          getattr(b, d_f), rtol)
        bad += [f"{ids_f}[{row}, {j}]" for row, j in rows[:1]]
    return bad
