"""One refill of the streaming iterator's expansion, one launch.

Replaces the JAX package's ``lax.while_loop`` in ``iter_step``
(pgvectorscale_tpu/graph/iterate.py:279; cond :206, body :213).  Its plain
version is ``graph.iterate.iter_step_plain``, blocks of
``graph.iterate.STEP_BLOCK`` masked steps from the host (one host read a
block, ~30 launches a step, one edge-gather launch a visit), and
``graph.iterate.iter_step`` dispatches between the two.  On the card the
window seed (a stable sort of the pending rows over the table, as JAX's
``lax.top_k`` outside its loop) and the emitted-row update after the loop
stay PyTorch (``graph.iterate.iter_step_kernel``), and the kernel
(``csrc/iter_step.cu``, one block; ``launch`` here) runs every step of the
loop in between: the frontier, the window, the frontier's hash set, the
row's dedup table and the query's prefix in shared memory (the state in a
scratch buffer when it does not fit), ``visited`` and ``vdist`` written in
copies of the state's tensors, so ``state`` is not written.  It takes
adjacency rows of any width and windows of any size.

Bound on an H100: the chain.  Each step waits on the expanded node's
adjacency row, then on its neighbours' visited flags and code (or vector)
rows, and the next node is known only after the merge; the 1M-row tables
of the stream do not stay in the 50 MB L2.  The kernel knows the next node
right after a step's scoring and starts its loads then, so a step finds
its own loads started (the design in the source).

Codes are scored by Hamming distance (integers, exact), so on codes the
kernel equals the plain loop bit for bit; in full precision (plain storage,
"exact" builds) the distances are sums in another order (bit-equal on
integer-valued rows, else within float32 rounding).

``check`` holds the inputs of either version; ``launches`` counts kernel
launches (under a lock: iterators may refill from several host threads).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..config import DistanceType
from . import _build
from .beam_search_full import ROW_DTYPES, check_rows, placement

launches = 0
_launch_lock = threading.Lock()


def count_launch() -> None:
    global launches
    with _launch_lock:
        launches += 1


def check(state, arrays, query_vec, query_code, emit_n: int, visit_budget: int,
          use_codes: bool) -> None:
    """Raise on a refill's inputs that neither version takes (types, shapes,
    devices); ``query_vec`` must be contiguous in full precision."""
    dev = state.beam_ids.device
    cap = arrays.adjacency.shape[0]
    checks = [("adjacency", arrays.adjacency, torch.int32, 2),
              ("beam_ids", state.beam_ids, torch.int32, 1),
              ("beam_dists", state.beam_dists, torch.float32, 1),
              ("visited", state.visited, torch.bool, 1),
              ("vdist", state.vdist, torch.float32, 1),
              ("emitted", state.emitted, torch.bool, 1),
              ("n_visits", state.n_visits, torch.int32, 0),
              ("n_comps", state.n_comps, torch.int32, 0)]
    if use_codes:
        checks += [("codes", arrays.codes, torch.int32, 2),
                   ("query_code", query_code, torch.int32, 1)]
    for name, t, dtype, dim in checks:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != dim:
            raise ValueError(f"{name} must be {dim}-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the state on {dev}")
    if use_codes:
        w = arrays.codes.shape[1]
        if arrays.codes.shape[0] != cap or w == 0 or query_code.shape[0] != w:
            raise ValueError(f"codes {tuple(arrays.codes.shape)} and query_code "
                             f"{tuple(query_code.shape)} need cap {cap} rows of W > 0 words")
    else:
        check_rows(arrays, query_vec)
        if query_vec.dim() != 1 or arrays.vectors.shape[0] != cap:
            raise ValueError("query_vec must be 1-D and the rows must number cap")
    if any(t.shape[0] != cap for t in (state.visited, state.vdist, state.emitted)):
        raise ValueError(f"visited, vdist and emitted need the table's {cap} rows")
    if state.beam_dists.shape != state.beam_ids.shape or state.beam_ids.shape[0] == 0:
        raise ValueError("the frontier's ids and distances need the same width > 0")
    if arrays.adjacency.shape[1] == 0:
        raise ValueError("adjacency rows need a slot at least")
    if emit_n < 1 or visit_budget < 0:
        raise ValueError(f"need emit_n ({emit_n}) >= 1 and visit_budget ({visit_budget}) >= 0")


def launch(state, arrays, query_vec, query_code, win_ids, win_d, *, visit_budget: int,
           distance_type: DistanceType, use_codes: bool,
           shared_limit: int = _build.MAX_SHARED_BYTES, lib=None, device_args=None):
    """One launch on checked CUDA inputs and a window seed: (the state with
    the new frontier, visited, vdist and counts, its ``emitted`` the
    input's; the window's ids and distances; the steps taken i32[]); no
    host read.  The state sits in shared memory when it fits under
    ``shared_limit``, else in a scratch buffer, and the query's prefix in
    shared memory when it fits beside it (``placement``).  ``lib``: a
    library bound by ``bind`` (another build of the same C interface), else
    this checkout's; ``device_args``: (device index, stream) for it, else
    the tensors' card and its current stream."""
    device = state.beam_ids.device
    lib = lib or _kernel()
    if device_args is None:
        device_args = (device.index if device.index is not None else torch.cuda.current_device(),
                       torch.cuda.current_stream(device).cuda_stream)
    f = state.beam_ids.shape[0]
    emit_n = win_ids.shape[0]
    cap, r = arrays.adjacency.shape
    i32 = dict(dtype=torch.int32, device=device)
    visited, vdist = state.visited.clone(), state.vdist.clone()
    fr_ids, fr_d = torch.empty((f,), **i32), torch.empty((f,), dtype=torch.float32,
                                                         device=device)
    out_ids = torch.empty((emit_n,), **i32)
    out_d = torch.empty((emit_n,), dtype=torch.float32, device=device)
    n_visits, n_comps, steps = (torch.empty((), **i32) for _ in range(3))
    if use_codes:
        w, d, dt, dtype = arrays.codes.shape[1], 0, 0, 0
        tables = (arrays.codes.data_ptr(), query_code.data_ptr(), None, None, None)
    else:
        vecs = arrays.vectors
        w, d, dt, dtype = 0, vecs.shape[1], query_vec.shape[0], ROW_DTYPES[vecs.dtype]
        int8 = vecs.dtype == torch.int8
        tables = (None, None, vecs.data_ptr(), arrays.vec_scales.data_ptr() if int8 else None,
                  query_vec.data_ptr())
    state_bytes = lib.pgvs_iter_step_state_bytes(f, emit_n, r)
    query_bytes = 0 if use_codes else lib.pgvs_iter_step_query_bytes(dt)
    state_shared, qs = placement(state_bytes, query_bytes, shared_limit)
    scratch = None if state_shared else torch.empty((state_bytes,), dtype=torch.uint8,
                                                    device=device)
    win_ids, win_d = win_ids.contiguous(), win_d.contiguous()
    err = lib.pgvs_iter_step(
        arrays.adjacency.data_ptr(), *tables, visited.data_ptr(), vdist.data_ptr(),
        state.beam_ids.data_ptr(), state.beam_dists.data_ptr(), win_ids.data_ptr(),
        win_d.data_ptr(), state.n_visits.data_ptr(), state.n_comps.data_ptr(),
        fr_ids.data_ptr(), fr_d.data_ptr(), out_ids.data_ptr(), out_d.data_ptr(),
        n_visits.data_ptr(), n_comps.data_ptr(), steps.data_ptr(),
        None if scratch is None else scratch.data_ptr(), cap, r, f, emit_n, visit_budget,
        int(use_codes), w, d, dt, dtype, int(distance_type), int(qs), *device_args,
    )
    if err != 0:
        raise RuntimeError(f"iterator kernel launch failed: CUDA error {err}")
    count_launch()
    new = state._replace(visited=visited, vdist=vdist, beam_ids=fr_ids, beam_dists=fr_d,
                         n_visits=n_visits, n_comps=n_comps)
    return new, out_ids, out_d, steps


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface's argument types on a loaded library."""
    fn = lib.pgvs_iter_step
    fn.argtypes = ([ctypes.c_void_p] * 22 + [ctypes.c_int] * 7 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    sb = lib.pgvs_iter_step_state_bytes
    sb.argtypes = [ctypes.c_int] * 3
    sb.restype = ctypes.c_longlong
    qb = lib.pgvs_iter_step_query_bytes
    qb.argtypes = [ctypes.c_int]
    qb.restype = ctypes.c_longlong
    return lib


def _kernel():
    return bind(_build.load("iter_step"))


def check_inputs(cap: int, r: int, use_codes: bool, w: int = 24, d: int = 64, dt=None,
                 s: int = 1, dtype: torch.dtype = torch.float32, values: int = 3,
                 word_values: int = 2**31, invalid_share: float = 0.23, device="cpu",
                 generator=None):
    """Random inputs of one kernel check: (arrays, query_vec f32[Dt] (empty
    on codes), query_code i32[W] (empty in full precision), start_ids
    i32[S]): the graphs of ``ops.beam_search.check_inputs`` (codes, words
    from [0, word_values)) and ``ops.beam_search_full.check_inputs`` (rows,
    integers in [-values, values] or, with 0, float rows) for one query."""
    from . import beam_search, beam_search_full

    if use_codes:
        arrays, qc, starts, _ = beam_search.check_inputs(
            1, cap, w, r, s=s, word_values=word_values, invalid_share=invalid_share,
            device=device, generator=generator)
        return arrays, torch.zeros((0,), device=device), qc[0], starts[0]
    arrays, qv, starts, _ = beam_search_full.check_inputs(
        1, cap, d, r, dt=dt, s=s, dtype=dtype, values=values, invalid_share=invalid_share,
        device=device, generator=generator)
    return arrays, qv[0], torch.zeros((0,), dtype=torch.int32, device=device), starts[0]


# The cases the kernel is held to (tests/test_torch_kernels.py on the card,
# tests/test_torch_iterate_emulated.py on the CPU with smaller budgets):
# check_inputs arguments, then the traversal's: the frontier's width, the
# distance, and the refills' (emit_n, visit_budget), a reseed of the
# lowest unvisited row before the last refill.  On the codes and on integer
# rows under L2 and inner product (f32, bf16) the kernel must equal the
# plain loop bit for bit; int8 rows, cosine and float rows within float32
# rounding.  The stream's shape (1 bit a dim of 768: W = 24, R = 65, F =
# 256, emit_n 128 then 256), every code word equal (ties everywhere), W = 7
# (4-byte loads), 90% of the slots empty (the frontier mostly +inf, which
# empties), the widest window (4,096) cut by its budget, and in full
# precision f32, bf16 (ties), int8, cosine, a Matryoshka prefix, a row
# stride that rules out 16-byte loads and the prefix read from device
# memory (a shared limit below the state and the prefix together).  Then
# adjacency rows wider than the block (num_neighbors 200: R = 260 slots for
# 256 threads) on the codes with the state in the scratch buffer and in
# full precision with the prefix beside the scratch state, and windows
# wider than a round of the shift (5,000 and 9,000) over 12,000 rows
# visited and not emitted before the first refill (``previsit``), so the
# shift moves rows across its rounds.  Then one slot a row (R = 1), and
# frontiers of 100 entries (not a multiple of a warp) on the codes and in
# full precision.
CHECK_CASES = [
    (dict(cap=4096, r=65, use_codes=True, w=24),
     dict(frontier=256, distance_type=DistanceType.COSINE, refills=((128, 512), (256, 1024)))),
    (dict(cap=2048, r=65, use_codes=True, w=8, word_values=1),
     dict(frontier=64, distance_type=DistanceType.COSINE, refills=((10, 40), (10, 40), (64, 200)))),
    (dict(cap=2048, r=33, use_codes=True, w=7, word_values=4),
     dict(frontier=128, distance_type=DistanceType.COSINE, refills=((32, 128), (64, 256)))),
    (dict(cap=2048, r=65, use_codes=True, w=24, invalid_share=0.9),
     dict(frontier=256, distance_type=DistanceType.COSINE, refills=((64, 256), (64, 256)))),
    (dict(cap=8192, r=65, use_codes=True, w=24),
     dict(frontier=256, distance_type=DistanceType.COSINE, refills=((4096, 96), (4096, 96)))),
    (dict(cap=2048, r=65, use_codes=False, d=64),
     dict(frontier=256, distance_type=DistanceType.L2, refills=((10, 40), (100, 400)))),
    (dict(cap=2048, r=65, use_codes=False, d=64),
     dict(frontier=128, distance_type=DistanceType.INNER_PRODUCT, refills=((32, 128), (32, 128)))),
    (dict(cap=2048, r=17, use_codes=False, d=48, dtype=torch.bfloat16, values=1),
     dict(frontier=64, distance_type=DistanceType.L2, refills=((16, 64), (16, 64)))),
    (dict(cap=2048, r=65, use_codes=False, d=96, dt=40),
     dict(frontier=128, distance_type=DistanceType.L2, refills=((32, 128), (64, 256)))),
    (dict(cap=2048, r=65, use_codes=False, d=33),
     dict(frontier=128, distance_type=DistanceType.INNER_PRODUCT, refills=((32, 128),))),
    (dict(cap=2048, r=65, use_codes=False, d=768),
     dict(frontier=256, distance_type=DistanceType.L2, refills=((4096, 64),), shared_limit=20_000)),
    (dict(cap=2048, r=65, use_codes=False, d=64, dtype=torch.int8),
     dict(frontier=128, distance_type=DistanceType.L2, refills=((32, 128), (32, 128)))),
    (dict(cap=2048, r=65, use_codes=False, d=100, dtype=torch.int8, values=0),
     dict(frontier=128, distance_type=DistanceType.COSINE, refills=((32, 128), (32, 128)))),
    (dict(cap=4096, r=260, use_codes=True, w=24),
     dict(frontier=256, distance_type=DistanceType.COSINE, refills=((64, 256), (128, 256)),
          shared_limit=0)),
    (dict(cap=2048, r=260, use_codes=False, d=64),
     dict(frontier=128, distance_type=DistanceType.L2, refills=((32, 128), (64, 128)),
          shared_limit=1024)),
    (dict(cap=16384, r=65, use_codes=True, w=8),
     dict(frontier=256, distance_type=DistanceType.COSINE, refills=((5000, 96), (9000, 96)),
          previsit=12000)),
    (dict(cap=1024, r=1, use_codes=True, w=24, invalid_share=0.05),
     dict(frontier=64, distance_type=DistanceType.COSINE, refills=((16, 64), (16, 64)))),
    (dict(cap=2048, r=65, use_codes=True, w=24),
     dict(frontier=100, distance_type=DistanceType.COSINE, refills=((32, 128), (64, 256)))),
    (dict(cap=2048, r=33, use_codes=False, d=64),
     dict(frontier=100, distance_type=DistanceType.L2, refills=((32, 128), (32, 128)))),
]


def previsit(state, n: int, generator=None):
    """``state`` (an ``IterState``) with ``n`` random rows marked visited
    and not emitted, at random distances above the frontier's: the next
    window seeds hold up to ``n`` rows, as in a deep scan."""
    if n == 0:
        return state
    dev = state.visited.device
    rows = torch.randperm(state.visited.shape[0], generator=generator, device=dev)[:n]
    finite = state.beam_dists[torch.isfinite(state.beam_dists)]
    base = float(finite.max()) + 1.0 if finite.numel() else 1.0
    visited, vdist = state.visited.clone(), state.vdist.clone()
    visited[rows] = True
    vdist[rows] = base + 1000.0 * torch.rand((n,), generator=generator, device=dev)
    return state._replace(visited=visited, vdist=vdist)


def exact_case(inputs: dict, traversal: dict) -> bool:
    """Whether a case's distances are exact in any summation order (codes,
    or integer rows under L2 or inner product in f32 or bf16): the kernel
    must then equal the plain loop bit for bit."""
    return inputs["use_codes"] or (
        inputs.get("values", 3) > 0
        and inputs.get("dtype", torch.float32) in (torch.float32, torch.bfloat16)
        and traversal["distance_type"] in (DistanceType.L2, DistanceType.INNER_PRODUCT))


STATE_FIELDS = ("visited", "emitted", "vdist", "beam_ids", "beam_dists", "n_visits", "n_comps")


def refill_differs(a, b, exact: bool) -> list:
    """What differs between two refills' (state, ids, dists): with
    ``exact`` every state field and the emitted ids and distances bit for
    bit, else the emitted rows and the frontier within float32 rounding
    (``beam_search_full.rows_close``)."""
    from .beam_search_full import rows_close

    (sa, ia, da), (sb, ib, db) = a, b
    if exact:
        bad = [f for f in STATE_FIELDS if not torch.equal(getattr(sa, f), getattr(sb, f))]
        return bad + [n for n, x, y in (("ids", ia, ib), ("dists", da, db))
                      if not torch.equal(x, y)]
    bad = ["emitted rows"] if rows_close(ia[None], da[None], ib[None], db[None]) else []
    return bad + (["frontier"] if rows_close(sa.beam_ids[None], sa.beam_dists[None],
                                             sb.beam_ids[None], sb.beam_dists[None]) else [])
