"""Resumable single-query traversal for the streaming iterator (PyTorch
port of ``graph/iterate.py``).

The reference's ``greedy_search_iterate`` resumes the same search state
every time the scan needs more rows (pgvectorscale/src/access_method/
graph/mod.rs:357-385), so a full-table scan visits each node once.  The
state lives on the device:

- ``visited`` bool[cap] and ``vdist`` f32[cap]: expanded nodes and their
  distance at visit time (nothing is expanded twice across refills);
- ``emitted`` bool[cap]: visited rows already handed to the caller;
- a fixed-width frontier of the best unvisited candidates, ascending.

Each refill (``iter_step``) seeds a window with the best ``emit_n``
unemitted visited rows, expands the frontier's best node until the
frontier cannot improve the window (frontier min >= the window's worst
slot) or ``visit_budget`` nodes were expanded, then emits the window in
ascending order.  ``first_unseen`` and ``reseed`` restart a starved
frontier from the lowest-id unexpanded live row, so a full scan ends.

The JAX package runs the expansion as a device ``while_loop``; so does the
port on the card, as one kernel launch a refill (``iter_step_kernel``:
``ops.iter_step.launch`` of ``csrc/iter_step.cu``), which ``iter_step``
dispatches a CUDA state to.
``iter_step_plain`` is the loop from the host, the CPU's path and the
kernel's reference: the loop condition is computed on the device before
every step and masks every write of the step, so a step taken after the
loop would have stopped leaves the state as it was; the host reads the
condition once per block of ``STEP_BLOCK`` steps.  The results equal the
while loop's.  Neighbours are scored on the codes by the edge-gather
kernel with one frontier node (``sel`` = [[node]]), which computes the JAX
package's ``hamming_gather`` of that node's adjacency row; full-precision
scoring (plain storage, "exact" builds) goes through
``_candidate_distances``.  Every sort is stable, as ``lax.sort``,
``lax.top_k`` and ``jnp.argsort`` order ties.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import DistanceType
from ..ops import _build
from ..ops import iter_step as iter_step_op
from ..ops.edge_gather import hamming_edge_gather
from ..store import INVALID_ID, GraphArrays
from .search import _candidate_distances

INF = math.inf
# Expansion steps between two host reads of the loop condition.
STEP_BLOCK = 16


class IterState(NamedTuple):
    """Device-resident resumable traversal state (one query)."""

    visited: torch.Tensor  # bool[cap]: expanded nodes (never re-expanded)
    emitted: torch.Tensor  # bool[cap]: rows already returned to the caller
    vdist: torch.Tensor  # f32[cap]: distance at visit time (INF unvisited)
    beam_ids: torch.Tensor  # i32[F] frontier, INVALID_ID padded, ascending
    beam_dists: torch.Tensor  # f32[F]
    n_visits: torch.Tensor  # i32 scalar
    n_comps: torch.Tensor  # i32 scalar


def _one_query_distances(arrays, query_vec, query_code, ids, *, use_codes, distance_type):
    """``_candidate_distances`` of one query to ids i32[M] -> f32[M]."""
    return _candidate_distances(
        arrays, query_vec[None, :], query_code[None, :], ids[None, :],
        use_codes=use_codes, distance_type=distance_type,
    )[0]


def init_state(
    arrays: GraphArrays,
    query_vec: torch.Tensor,  # f32[Dt] (preprocessed, indexed prefix)
    query_code: torch.Tensor,  # i32[W] (W may be 0)
    start_ids: torch.Tensor,  # i32[S]
    *,
    frontier: int,
    distance_type: DistanceType,
    use_codes: bool,
) -> IterState:
    """A fresh state whose frontier holds the (deduplicated) start nodes."""
    dev = start_ids.device
    s = start_ids.shape[0]
    valid = start_ids >= 0
    ar = torch.arange(s, device=dev)
    eq = (start_ids[:, None] == start_ids[None, :]) & valid[None, :]
    valid = valid & ~torch.any(eq & (ar[:, None] > ar[None, :]), dim=-1)
    d = _one_query_distances(arrays, query_vec, query_code, start_ids,
                             use_codes=use_codes, distance_type=distance_type)
    d = torch.where(valid, d, INF)
    ids = torch.where(valid, start_ids, INVALID_ID)
    pad = max(frontier - s, 0)
    d = torch.cat([d, torch.full((pad,), INF, device=dev)])[:frontier]
    ids = torch.cat([ids, torch.full((pad,), INVALID_ID, dtype=torch.int32, device=dev)])
    d, order = torch.sort(d, stable=True)
    cap = arrays.capacity
    return IterState(
        visited=torch.zeros((cap,), dtype=torch.bool, device=dev),
        emitted=torch.zeros((cap,), dtype=torch.bool, device=dev),
        vdist=torch.full((cap,), INF, device=dev),
        beam_ids=ids[:frontier][order],
        beam_dists=d,
        n_visits=torch.zeros((), dtype=torch.int32, device=dev),
        n_comps=valid.sum(dtype=torch.int32),
    )


def reseed(
    state: IterState,
    arrays: GraphArrays,
    query_vec: torch.Tensor,
    query_code: torch.Tensor,
    node_id: int,
    *,
    distance_type: DistanceType,
    use_codes: bool,
) -> IterState:
    """Drop a starvation-restart node into the frontier's last slot at its
    true traversal distance and re-sort the frontier."""
    dev = state.beam_ids.device
    nid = torch.tensor([node_id], dtype=torch.int32, device=dev)
    d = _one_query_distances(arrays, query_vec, query_code, nid,
                             use_codes=use_codes, distance_type=distance_type)
    beam_dists = torch.cat([state.beam_dists[:-1], d])
    beam_ids = torch.cat([state.beam_ids[:-1], nid])
    beam_dists, order = torch.sort(beam_dists, stable=True)
    return state._replace(beam_ids=beam_ids[order], beam_dists=beam_dists)


def first_unseen(state: IterState, arrays: GraphArrays) -> int:
    """Lowest-id live row not yet expanded (INVALID_ID when none): the
    full-scan starvation restart.  One host read."""
    cap = arrays.capacity
    cand = ((torch.arange(cap, device=arrays.device) < arrays.count)
            & ~state.visited & ~arrays.deleted)
    first = torch.argmax(cand.to(torch.int32))
    return int(torch.where(cand[first], first, INVALID_ID))


def iter_step(
    state: IterState,
    arrays: GraphArrays,
    query_vec: torch.Tensor,  # f32[Dt]
    query_code: torch.Tensor,  # i32[W]
    *,
    emit_n: int,
    visit_budget: int,
    distance_type: DistanceType,
    use_codes: bool,
    step_block: int = STEP_BLOCK,
    shared_limit: int = _build.MAX_SHARED_BYTES,
) -> tuple[IterState, torch.Tensor, torch.Tensor]:
    """Advance the traversal and emit the next ``emit_n`` results
    (arguments and result as ``iter_step_plain``'s): on the card one
    launch of the iterator kernel (``iter_step_kernel``, which alone reads
    ``shared_limit``), on the CPU ``iter_step_plain`` (which alone reads
    ``step_block``)."""
    device = state.beam_ids.device
    if not use_codes:
        query_vec = query_vec.contiguous()
    iter_step_op.check(state, arrays, query_vec, query_code, emit_n, visit_budget, use_codes)
    kw = dict(emit_n=emit_n, visit_budget=visit_budget, distance_type=distance_type,
              use_codes=use_codes)
    if device.type == "cpu":
        return iter_step_plain(state, arrays, query_vec, query_code, step_block=step_block, **kw)
    if device.type != "cuda":
        raise ValueError(f"no iterator kernel for device {device}")
    return iter_step_kernel(state, arrays, query_vec, query_code, shared_limit=shared_limit,
                            **kw)


def iter_step_kernel(
    state: IterState,
    arrays: GraphArrays,
    query_vec: torch.Tensor,  # f32[Dt], contiguous
    query_code: torch.Tensor,  # i32[W]
    *,
    emit_n: int,
    visit_budget: int,
    distance_type: DistanceType,
    use_codes: bool,
    shared_limit: int = _build.MAX_SHARED_BYTES,
    lib=None,
    device_args=None,
) -> tuple[IterState, torch.Tensor, torch.Tensor]:
    """One refill through the iterator kernel on checked inputs: the window
    seed, one launch (``ops.iter_step.launch``, whose ``shared_limit``,
    ``lib`` and ``device_args`` these are), the emitted rows."""
    win_d, win_ids = window_seed(state, emit_n)
    new, ids, d, _ = iter_step_op.launch(
        state, arrays, query_vec, query_code, win_ids, win_d, visit_budget=visit_budget,
        distance_type=distance_type, use_codes=use_codes, shared_limit=shared_limit, lib=lib,
        device_args=device_args)
    return new._replace(emitted=mark_emitted(state.emitted, ids)), ids, d


def window_seed(state: IterState, emit_n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The refill's window seed: the best ``emit_n`` unemitted visited rows,
    (distances f32[emit_n] ascending, ids i32[emit_n]), INVALID_ID / +inf
    padded (``lax.top_k`` of the negated distances == the head of a stable
    ascending sort)."""
    dev = state.visited.device
    cap = state.visited.shape[0]
    pend = torch.where(state.visited & ~state.emitted, state.vdist, INF)
    win_d, win_ids = torch.sort(pend, stable=True)
    k = min(emit_n, cap)
    win_d, win_ids = win_d[:k], win_ids[:k].to(torch.int32)
    win_ids = torch.where(win_d < INF, win_ids, INVALID_ID)
    if k < emit_n:  # cap smaller than the window (tiny index)
        win_d = torch.cat([win_d, torch.full((emit_n - k,), INF, device=dev)])
        win_ids = torch.cat([win_ids, torch.full((emit_n - k,), INVALID_ID,
                                                 dtype=torch.int32, device=dev)])
    return win_d, win_ids


def mark_emitted(emitted: torch.Tensor, win_ids: torch.Tensor) -> torch.Tensor:
    """``emitted`` with every valid window id set (a new tensor; invalid
    slots write a spare row)."""
    cap = emitted.shape[0]
    hit = torch.zeros((cap + 1,), dtype=torch.bool, device=emitted.device)
    hit[torch.where(win_ids != INVALID_ID, win_ids, cap).long()] = True
    return emitted | hit[:cap]


def iter_step_plain(
    state: IterState,
    arrays: GraphArrays,
    query_vec: torch.Tensor,  # f32[Dt]
    query_code: torch.Tensor,  # i32[W]
    *,
    emit_n: int,
    visit_budget: int,
    distance_type: DistanceType,
    use_codes: bool,
    step_block: int = STEP_BLOCK,
) -> tuple[IterState, torch.Tensor, torch.Tensor]:
    """Advance the traversal and emit the next ``emit_n`` results:
    (state, emit_ids i32[emit_n], emit_dists f32[emit_n]), ascending by
    traversal distance, INVALID_ID padded.  Deleted rows are emitted (the
    caller filters them).  ``state`` is not written."""
    dev = arrays.device
    f = state.beam_ids.shape[0]
    r = arrays.max_degree
    win_d, win_ids = window_seed(state, emit_n)

    visited, vdist = state.visited.clone(), state.vdist.clone()
    beam_ids, beam_dists = state.beam_ids, state.beam_dists
    steps = torch.zeros((), dtype=torch.int32, device=dev)
    nv, nc = state.n_visits, state.n_comps
    ar = torch.arange(r, device=dev)
    earlier = ar[:, None] > ar[None, :]
    query_codes = query_code[None, :].contiguous()

    def going() -> torch.Tensor:
        # Frontier min < worst window slot: the window is not settled.
        return (steps < visit_budget) & (beam_dists[:1] < win_d[emit_n - 1 :])

    while bool(going()):
        for _ in range(step_block):
            # The frontier is ascending and holds unvisited entries only:
            # expand slot 0, if the loop is still going.
            nid, nd = beam_ids[:1], beam_dists[:1]
            act = going() & (nd < INF)  # bool[1]
            safe_nid = nid.clamp_min(0).long()
            visited[safe_nid] = visited[safe_nid] | act
            vdist[safe_nid] = torch.minimum(vdist[safe_nid], torch.where(act, nd, INF))
            inc = act.to(torch.int32)[0]
            steps, nv = steps + inc, nv + inc
            # The visit joins the sorted window (a masked step inserts +inf
            # behind every slot and changes nothing).
            wd = torch.cat([win_d, torch.where(act, nd, INF)])
            wi = torch.cat([win_ids, torch.where(act, nid, INVALID_ID)])
            wd, order = torch.sort(wd, stable=True)
            win_d, win_ids = wd[:emit_n], wi[order[:emit_n]]
            # The expanded entry leaves the frontier.
            beam_ids = torch.cat([torch.where(act, INVALID_ID, nid), beam_ids[1:]])
            beam_dists = torch.cat([torch.where(act, INF, nd), beam_dists[1:]])

            nbrs = arrays.adjacency[safe_nid][0]  # [R]
            valid = (nbrs != INVALID_ID) & act
            valid = valid & ~visited[nbrs.clamp_min(0).long()]
            valid = valid & ~torch.any(nbrs[:, None] == beam_ids[None, :], dim=-1)
            dup = torch.any((nbrs[:, None] == nbrs[None, :]) & earlier & valid[None, :],
                            dim=-1)
            valid = valid & ~dup
            if use_codes:
                d = hamming_edge_gather(
                    arrays.codes, arrays.adjacency, safe_nid.to(torch.int32)[None, :],
                    query_codes,
                )[0]
            else:
                d = _one_query_distances(arrays, query_vec, query_code, nbrs,
                                         use_codes=False, distance_type=distance_type)
            d = torch.where(valid, d, INF)
            cand_ids = torch.where(valid, nbrs, INVALID_ID)
            nc = nc + valid.sum(dtype=torch.int32)
            # A masked step merges only +inf candidates behind the sorted
            # frontier, which keeps it as it was.
            all_d, order = torch.sort(torch.cat([beam_dists, d]), stable=True)
            beam_dists = all_d[:f]
            beam_ids = torch.cat([beam_ids, cand_ids])[order[:f]]

    new_state = IterState(
        visited=visited, emitted=mark_emitted(state.emitted, win_ids), vdist=vdist,
        beam_ids=beam_ids, beam_dists=beam_dists, n_visits=nv, n_comps=nc,
    )
    return new_state, win_ids, win_d
