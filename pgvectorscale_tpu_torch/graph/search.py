"""Batched greedy graph search (PyTorch port of ``graph/search.py``).

The Vamana beam search, batched over Q queries with fixed-width state, as
in the JAX package:

- Per query, the beam is a top-L array of (distance, id, visited flag);
  the search ends when every beam entry is visited or the visit budget is
  spent (the reference's ``ListSearchResult::visit_closest`` rule).
- Each step visits the E best unvisited entries, gathers their adjacency
  rows, scores the neighbours (Hamming on SBQ codes through the
  edge-gather kernel, which reads the codes through the adjacency), drops
  duplicates and merges the candidates into the beam with one bitonic
  merge.
- The visit history doubles as the build-time candidate set.

The loop is a Python loop over iterations with one host read per
iteration (the termination test); everything inside an iteration is
batched tensor work.  Ties follow the JAX package: ``lax.top_k`` and
``lax.sort`` become stable ``torch.sort``, and the bitonic network is the
same network, so equal inputs give equal beams.  Only the unfiltered
search without a scored-candidate window is ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.edge_gather import hamming_edge_gather
from ..ops.hamming import hamming_gather
from ..store import INVALID_ID, GraphArrays

INF = math.inf
_I32_MAX = 2**31 - 1


def _stable_sort_by(key: torch.Tensor, *vals: torch.Tensor):
    """Sort ``key`` ascending along dim 1 (stable) and carry ``vals``."""
    s_key, order = torch.sort(key, dim=1, stable=True)
    return (s_key, *[torch.gather(v, 1, order) for v in vals])


def merge_sorted_into_beam(
    beam_d: torch.Tensor,  # f32[Q, L] ascending
    beam_ids: torch.Tensor,  # i32[Q, L]
    beam_vis: torch.Tensor,  # bool[Q, L]
    cand_d: torch.Tensor,  # f32[Q, E] unsorted (INF for invalid)
    cand_ids: torch.Tensor,  # i32[Q, E]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge candidates into the sorted beam and keep the best L.

    The candidates are sorted (stable) and reversed, so
    [beam ascending | INF pad | candidates descending] is bitonic, and one
    bitonic-merge network sorts it: log2(n) compare-exchange stages, the
    same network as the JAX package's, so ties land where they land there.
    Ids and visited flags travel together as ``2*id + visited``."""
    q, bl = beam_d.shape
    er = cand_d.shape[1]
    cd, cid = _stable_sort_by(cand_d, cand_ids)
    cd, cid = cd.flip(1), cid.flip(1)

    n = 1 << (bl + er - 1).bit_length()
    pad = n - bl - er
    dev = beam_d.device
    d = torch.cat(
        [beam_d, torch.full((q, pad), INF, dtype=torch.float32, device=dev), cd],
        dim=1,
    )
    tag = torch.cat(
        [
            beam_ids * 2 + beam_vis.to(torch.int32),
            torch.full((q, pad), 2 * INVALID_ID, dtype=torch.int32, device=dev),
            cid * 2,
        ],
        dim=1,
    )
    stride = n // 2
    while stride >= 1:
        ds = d.view(q, -1, 2, stride)
        ts = tag.view(q, -1, 2, stride)
        lo_d, hi_d = ds[:, :, 0, :], ds[:, :, 1, :]
        swap = lo_d > hi_d
        d = torch.stack(
            [torch.where(swap, hi_d, lo_d), torch.where(swap, lo_d, hi_d)], dim=2
        ).view(q, n)
        lo_t, hi_t = ts[:, :, 0, :], ts[:, :, 1, :]
        tag = torch.stack(
            [torch.where(swap, hi_t, lo_t), torch.where(swap, lo_t, hi_t)], dim=2
        ).view(q, n)
        stride //= 2
    tag = tag[:, :bl]
    return d[:, :bl], torch.div(tag, 2, rounding_mode="floor"), (tag & 1).bool()


class SearchResult(NamedTuple):
    beam_ids: torch.Tensor  # i32[Q, L] sorted by distance
    beam_dists: torch.Tensor  # f32[Q, L]
    beam_visited: torch.Tensor  # bool[Q, L]
    hist_ids: torch.Tensor  # i32[Q, H] visit order
    hist_dists: torch.Tensor  # f32[Q, H]
    n_visited: torch.Tensor  # i32[Q]
    n_dist_comps: torch.Tensor  # i32[Q]
    iters: int


def _candidate_distances(
    arrays: GraphArrays, query_codes: torch.Tensor, ids: torch.Tensor
) -> torch.Tensor:
    """Hamming distances from each query to its candidate ids: f32[Q, R]
    (SBQ storage; plain storage's full-precision traversal is not ported)."""
    return hamming_gather(query_codes, arrays.codes, ids).to(torch.float32)


def get_start_ids(arrays: GraphArrays, num_queries: int) -> torch.Tensor:
    """Start nodes for each query: the default start (unfiltered search)."""
    return torch.full(
        (num_queries, 1), arrays.default_start, dtype=torch.int32,
        device=arrays.device,
    )


def beam_search(
    arrays: GraphArrays,
    query_codes: torch.Tensor,  # i32[Q, W]
    start_ids: torch.Tensor,  # i32[Q, S]
    *,
    search_list_size: int,
    max_iters: int,
    expand_factor: int = 1,
    track_hist: bool = True,
) -> SearchResult:
    """Batched greedy beam search over SBQ codes; ``expand_factor`` (E)
    frontier nodes are visited per iteration, ``max_iters`` is the visit
    budget.  The neighbours are scored by the edge-gather kernel, which
    reads ``arrays.codes`` through ``arrays.adjacency``."""
    q, s = start_ids.shape
    l = search_list_size
    r_max = arrays.max_degree
    h = max_iters
    e = expand_factor
    if not 1 <= e <= l:
        raise ValueError(f"expand_factor {e} must be in [1, {l}]")
    dev = start_ids.device
    i32 = dict(dtype=torch.int32, device=dev)

    # ---- init: the start nodes, deduplicated, sorted into the beam ----
    start_valid = start_ids >= 0
    ar = torch.arange(s, **i32)
    eq = start_ids[:, :, None] == start_ids[:, None, :]
    earlier = ar[None, :, None] > ar[None, None, :]
    dup = torch.any(eq & earlier & start_valid[:, None, :], dim=-1)
    start_valid = start_valid & ~dup
    start_dists = torch.where(
        start_valid, _candidate_distances(arrays, query_codes, start_ids), INF
    )
    n_comps = start_valid.sum(dim=1, dtype=torch.int32)

    pad = max(l - s, 0)
    init_ids = torch.cat(
        [torch.where(start_valid, start_ids, INVALID_ID),
         torch.full((q, pad), INVALID_ID, **i32)], dim=1,
    )[:, :l]
    init_dists = torch.cat(
        [start_dists, torch.full((q, pad), INF, dtype=torch.float32, device=dev)],
        dim=1,
    )[:, :l]
    beam_dists, beam_ids = _stable_sort_by(init_dists, init_ids)
    beam_visited = torch.zeros((q, l), dtype=torch.bool, device=dev)

    # The history carries one spare column that absorbs out-of-budget
    # writes (the JAX package's mode="drop"); it is cut off at the end.
    h_cap = h if track_hist else 1
    hist_ids = torch.full((q, h_cap + 1), INVALID_ID, **i32)
    hist_dists = torch.full((q, h_cap + 1), INF, dtype=torch.float32, device=dev)
    n_visited = torch.zeros((q,), **i32)

    iter_bound = -(-max_iters // e) + 1
    er = e * r_max
    ar_er = torch.arange(er, **i32)
    it = 0
    while it < iter_bound:
        has_unvisited = torch.any((beam_ids != INVALID_ID) & ~beam_visited, dim=1)
        if not bool(torch.any(has_unvisited & (n_visited < h))):
            break

        # --- the E best unvisited beam entries per query ---
        unvisited_d = torch.where(
            (beam_ids != INVALID_ID) & ~beam_visited, beam_dists, INF
        )
        sel_dist, sel_pos = torch.sort(unvisited_d, dim=1, stable=True)
        sel_dist, sel_pos = sel_dist[:, :e], sel_pos[:, :e]
        active = sel_dist < INF
        # Visit-budget guard: entries past the history stay unvisited.
        rank = torch.cumsum(active.to(torch.int32), dim=1, dtype=torch.int32) - 1
        pos = n_visited[:, None] + rank
        active = active & (pos < h)
        sel_id = torch.where(active, torch.gather(beam_ids, 1, sel_pos), INVALID_ID)

        beam_visited = beam_visited.scatter(
            1, sel_pos, torch.gather(beam_visited, 1, sel_pos) | active
        )
        if track_hist:
            pos_w = torch.where(active, pos, h).long()
            hist_ids.scatter_(1, pos_w, sel_id)
            hist_dists.scatter_(1, pos_w, sel_dist)
        n_visited = n_visited + active.sum(dim=1, dtype=torch.int32)

        # --- expand: the E adjacency rows ---
        safe_sel = sel_id.clamp_min(0)
        nbrs = arrays.adjacency[safe_sel.long()].reshape(q, er)
        valid = (nbrs != INVALID_ID) & active.repeat_interleave(r_max, dim=1)
        # Dedup against the beam (the reference's `inserted` set).
        in_beam = torch.any(nbrs[:, :, None] == beam_ids[:, None, :], dim=-1)
        valid = valid & ~in_beam

        cand_d_raw = hamming_edge_gather(
            arrays.codes, arrays.adjacency, safe_sel.contiguous(), query_codes
        )

        # Dedup within the candidate row: broadcast compare for narrow
        # rows, sort by id + adjacent equality for wide ones (the JAX
        # package's two branches, which order candidates differently).
        if er <= 192:
            nbr_dup = torch.any(
                (nbrs[:, :, None] == nbrs[:, None, :])
                & (ar_er[None, :, None] > ar_er[None, None, :])
                & valid[:, None, :],
                dim=-1,
            )
            valid = valid & ~nbr_dup
            nbrs = torch.where(valid, nbrs, INVALID_ID)
            cand_d = torch.where(valid, cand_d_raw, INF)
        else:
            key = torch.where(valid, nbrs, _I32_MAX)
            s_key, s_d = _stable_sort_by(key, torch.where(valid, cand_d_raw, INF))
            dup = torch.cat(
                [torch.zeros((q, 1), dtype=torch.bool, device=dev),
                 s_key[:, 1:] == s_key[:, :-1]], dim=1,
            )
            valid = (s_key != _I32_MAX) & ~dup
            nbrs = torch.where(valid, s_key, INVALID_ID)
            cand_d = torch.where(valid, s_d, INF)
        n_comps = n_comps + valid.sum(dim=1, dtype=torch.int32)

        beam_dists, beam_ids, beam_visited = merge_sorted_into_beam(
            beam_dists, beam_ids, beam_visited, cand_d, nbrs
        )
        it += 1

    return SearchResult(
        beam_ids=beam_ids,
        beam_dists=beam_dists,
        beam_visited=beam_visited,
        hist_ids=hist_ids[:, :h_cap],
        hist_dists=hist_dists[:, :h_cap],
        n_visited=n_visited,
        n_dist_comps=n_comps,
        iters=it,
    )
