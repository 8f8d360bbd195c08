"""Batched greedy graph search (PyTorch port of ``graph/search.py``).

The Vamana beam search, batched over Q queries with fixed-width state, as
in the JAX package:

- Per query, the beam is a top-L array of (distance, id, visited flag);
  the search ends when every beam entry is visited or the visit budget is
  spent (the reference's ``ListSearchResult::visit_closest`` rule).
- Each step visits the E best unvisited entries, gathers their adjacency
  rows, scores the neighbours, drops duplicates and merges the candidates
  into the beam with one bitonic merge.  SBQ traversal scores Hamming
  distances on the codes, read through the adjacency; full-precision
  traversal (plain storage, and builds with ``build_distance="exact"``)
  gathers the rows' indexed prefix and takes L2, inner-product or cosine
  distances.
- The visit history doubles as the build-time candidate set.
- ``window_n`` > 0 keeps a side buffer of the best ``window_n`` scored
  candidates seen anywhere in the search (the "scored" rescore window),
  merged by the beam's network without visited flags.

On the card, SBQ traversal runs the whole loop in one kernel launch
(``ops.beam_search``, one block a query: every piece of the loop's state
is a query's own).  ``beam_search_plain`` is the loop as a Python loop
over iterations with one host read per iteration (the termination test),
everything inside an iteration batched tensor work: the CPU's path, the
kernel's reference, and full-precision traversal's path on the card.
Ties follow the JAX package: ``lax.top_k`` and ``lax.sort`` become stable
``torch.sort``, and the bitonic network is the same network, so equal
inputs give equal beams.

A filtered search (label sets, the ``&&`` predicate) starts from the
default start and one start node per query label, and a neighbour stays
a candidate only if its labels overlap the query's (sbq/storage.rs:
165-172).  The plain loop scores every neighbour (the edge-gather
kernel) and applies the label mask beside it, as the JAX package does;
the beam-search kernel masks before it scores.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import DistanceType
from ..distance import row_distances
from ..labels import overlaps
from ..ops.beam_search import beam_search_codes
from ..ops.edge_gather import hamming_edge_gather
from ..ops.hamming import hamming_gather
from ..store import INVALID_ID, GraphArrays, lookup_label_starts

INF = math.inf
_I32_MAX = 2**31 - 1


def _stable_sort_by(key: torch.Tensor, *vals: torch.Tensor):
    """Sort ``key`` ascending along dim 1 (stable) and carry ``vals``."""
    s_key, order = torch.sort(key, dim=1, stable=True)
    return (s_key, *[torch.gather(v, 1, order) for v in vals])


def _merge_sorted(
    d0: torch.Tensor,  # f32[Q, W] ascending
    tag0: torch.Tensor,  # i32[Q, W] payload
    cand_d: torch.Tensor,  # f32[Q, E] unsorted (INF for invalid)
    cand_tag: torch.Tensor,  # i32[Q, E]
    pad_tag: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge candidates into a sorted row and keep the best W.

    The candidates are sorted (stable) and reversed, so
    [row ascending | INF pad | candidates descending] is bitonic, and one
    bitonic-merge network sorts it: log2(n) compare-exchange stages, the
    same network as the JAX package's, so ties land where they land there.
    The payload travels with its distance."""
    q, wl = d0.shape
    er = cand_d.shape[1]
    cd, ctag = _stable_sort_by(cand_d, cand_tag)
    cd, ctag = cd.flip(1), ctag.flip(1)

    n = 1 << (wl + er - 1).bit_length()
    pad = n - wl - er
    dev = d0.device
    d = torch.cat(
        [d0, torch.full((q, pad), INF, dtype=torch.float32, device=dev), cd], dim=1
    )
    tag = torch.cat(
        [tag0, torch.full((q, pad), pad_tag, dtype=torch.int32, device=dev), ctag],
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
    return d[:, :wl], tag[:, :wl]


def merge_sorted_into_beam(
    beam_d: torch.Tensor,  # f32[Q, L] ascending
    beam_ids: torch.Tensor,  # i32[Q, L]
    beam_vis: torch.Tensor,  # bool[Q, L]
    cand_d: torch.Tensor,  # f32[Q, E] unsorted (INF for invalid)
    cand_ids: torch.Tensor,  # i32[Q, E]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge candidates into the sorted beam and keep the best L (one
    bitonic merge, ``_merge_sorted``).  Ids and visited flags travel
    together as ``2*id + visited``."""
    d, tag = _merge_sorted(
        beam_d, beam_ids * 2 + beam_vis.to(torch.int32), cand_d, cand_ids * 2,
        2 * INVALID_ID,
    )
    return d, torch.div(tag, 2, rounding_mode="floor"), (tag & 1).bool()


def merge_sorted_into_window(
    win_d: torch.Tensor,  # f32[Q, W] ascending
    win_ids: torch.Tensor,  # i32[Q, W]
    cand_d: torch.Tensor,  # f32[Q, E] unsorted (INF for invalid)
    cand_ids: torch.Tensor,  # i32[Q, E]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge a scored-candidate block into the rescore-window buffer and
    keep the best W: the beam's merge without visited flags.  The window
    may hold an id twice (a candidate evicted from the beam and proposed
    again carries the same distance); the query path dedups once, before
    finalize."""
    return _merge_sorted(win_d, win_ids, cand_d, cand_ids, INVALID_ID)


class SearchResult(NamedTuple):
    beam_ids: torch.Tensor  # i32[Q, L] sorted by distance
    beam_dists: torch.Tensor  # f32[Q, L]
    beam_visited: torch.Tensor  # bool[Q, L]
    hist_ids: torch.Tensor  # i32[Q, H] visit order
    hist_dists: torch.Tensor  # f32[Q, H]
    n_visited: torch.Tensor  # i32[Q]
    n_dist_comps: torch.Tensor  # i32[Q]
    iters: int
    window_ids: torch.Tensor  # i32[Q, Wn] scored-candidate window ([Q, 1] off)
    window_dists: torch.Tensor  # f32[Q, Wn]


def _candidate_distances(
    arrays: GraphArrays,
    query_vecs: torch.Tensor,  # f32[Q, Dt] (indexed prefix; unused on codes)
    query_codes: torch.Tensor,  # i32[Q, W]
    ids: torch.Tensor,  # i32[Q, R]
    *,
    use_codes: bool,
    distance_type: DistanceType,
) -> torch.Tensor:
    """Distances from each query to its candidate ids, f32[Q, R]: Hamming
    on the codes when ``use_codes``, else full precision on the rows'
    first ``Dt`` dims (stored vectors are full width, traversal uses the
    indexed prefix; the rescore uses the full vector later).  Invalid ids
    are clamped; callers mask them."""
    if use_codes:
        return hamming_gather(query_codes, arrays.codes, ids).to(torch.float32)
    return row_distances(arrays.vectors, query_vecs, ids, distance_type, arrays.vec_scales)


def get_start_ids(
    arrays: GraphArrays,
    num_queries: int,
    query_labels: Optional[torch.Tensor] = None,  # i32[Q, Lq]
) -> torch.Tensor:
    """Start nodes for each query, i32[Q, 1 + Lq]: the default start,
    followed, when the queries carry labels, by each label's start node
    (INVALID_ID where the label has none; StartNodes::get_for_node,
    graph/start_nodes.rs)."""
    default = torch.full(
        (num_queries, 1), arrays.default_start, dtype=torch.int32,
        device=arrays.device,
    )
    if query_labels is None or query_labels.shape[-1] == 0:
        return default
    return torch.cat([default, lookup_label_starts(arrays, query_labels)], dim=1)


def beam_search(
    arrays: GraphArrays,
    query_codes: torch.Tensor,  # i32[Q, W] (W == 0 for plain storage)
    start_ids: torch.Tensor,  # i32[Q, S]
    *,
    search_list_size: int,
    max_iters: int,
    expand_factor: int = 1,
    track_hist: bool = True,
    query_vecs: Optional[torch.Tensor] = None,  # f32[Q, Dt]
    use_codes: bool = True,
    distance_type: DistanceType = DistanceType.COSINE,
    window_n: int = 0,
    query_labels: Optional[torch.Tensor] = None,  # i32[Q, Lq]
) -> SearchResult:
    """Batched greedy beam search (arguments and result as
    ``beam_search_plain``).  SBQ traversal (``use_codes``) goes to
    ``ops.beam_search.beam_search_codes``: on the card one kernel launch
    runs the whole loop, on the CPU it is ``beam_search_plain``.
    Full-precision traversal runs ``beam_search_plain`` on either device."""
    if use_codes:
        return beam_search_codes(
            arrays, query_codes, start_ids, query_labels,
            search_list_size=search_list_size, max_iters=max_iters,
            expand_factor=expand_factor, track_hist=track_hist, window_n=window_n,
        )
    return beam_search_plain(
        arrays, query_codes, start_ids, search_list_size=search_list_size,
        max_iters=max_iters, expand_factor=expand_factor, track_hist=track_hist,
        query_vecs=query_vecs, use_codes=False, distance_type=distance_type,
        window_n=window_n, query_labels=query_labels,
    )


def beam_search_plain(
    arrays: GraphArrays,
    query_codes: torch.Tensor,  # i32[Q, W] (W == 0 for plain storage)
    start_ids: torch.Tensor,  # i32[Q, S]
    *,
    search_list_size: int,
    max_iters: int,
    expand_factor: int = 1,
    track_hist: bool = True,
    query_vecs: Optional[torch.Tensor] = None,  # f32[Q, Dt]
    use_codes: bool = True,
    distance_type: DistanceType = DistanceType.COSINE,
    window_n: int = 0,
    query_labels: Optional[torch.Tensor] = None,  # i32[Q, Lq]
) -> SearchResult:
    """Batched greedy beam search as a Python loop over iterations;
    ``expand_factor`` (E) frontier nodes are visited per iteration,
    ``max_iters`` is the visit budget.

    ``use_codes``: the neighbours are scored by the edge-gather kernel,
    which reads ``arrays.codes`` through ``arrays.adjacency``.  Otherwise
    the start nodes and the neighbours are scored in full precision
    against ``query_vecs`` (the queries' indexed prefix) under
    ``distance_type``, and the kernel is not called.

    ``window_n`` > 0 keeps the best ``window_n`` scored candidates of the
    whole search in ``window_ids``/``window_dists``, seeded from the
    sorted start beam, with one window merge per step before the beam
    merge; with 0 the window stays one column wide.

    ``query_labels`` of width > 0 (a filtered search): a neighbour is a
    candidate only if its labels (``arrays.node_labels``) overlap its
    query's; the start nodes are not filtered."""
    q, s = start_ids.shape
    l = search_list_size
    r_max = arrays.max_degree
    h = max_iters
    e = expand_factor
    if not 1 <= e <= l:
        raise ValueError(f"expand_factor {e} must be in [1, {l}]")
    if not use_codes and query_vecs is None:
        raise ValueError("full-precision traversal needs query_vecs")
    dev = start_ids.device
    i32 = dict(dtype=torch.int32, device=dev)
    label_filter = query_labels is not None and query_labels.shape[-1] > 0

    def dist_fn(ids: torch.Tensor) -> torch.Tensor:
        return _candidate_distances(
            arrays, query_vecs, query_codes, ids,
            use_codes=use_codes, distance_type=distance_type,
        )

    # ---- init: the start nodes, deduplicated, sorted into the beam ----
    start_valid = start_ids >= 0
    ar = torch.arange(s, **i32)
    eq = start_ids[:, :, None] == start_ids[:, None, :]
    earlier = ar[None, :, None] > ar[None, None, :]
    dup = torch.any(eq & earlier & start_valid[:, None, :], dim=-1)
    start_valid = start_valid & ~dup
    start_dists = torch.where(
        start_valid, dist_fn(start_ids), INF
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

    # The scored-candidate window, seeded from the sorted start beam so the
    # start nodes are rescore candidates too.
    wn = window_n if window_n > 0 else 1
    win_pad = max(wn - l, 0)
    win_ids = torch.cat([beam_ids, torch.full((q, win_pad), INVALID_ID, **i32)],
                        dim=1)[:, :wn]
    win_dists = torch.cat(
        [beam_dists, torch.full((q, win_pad), INF, dtype=torch.float32, device=dev)],
        dim=1,
    )[:, :wn]

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
        if label_filter:
            nbr_labels = arrays.node_labels[nbrs.clamp_min(0).long()]
            valid = valid & overlaps(nbr_labels, query_labels[:, None, :])
        # Dedup against the beam (the reference's `inserted` set).
        in_beam = torch.any(nbrs[:, :, None] == beam_ids[:, None, :], dim=-1)
        valid = valid & ~in_beam

        if use_codes:
            cand_d_raw = hamming_edge_gather(
                arrays.codes, arrays.adjacency, safe_sel.contiguous(), query_codes
            )
        else:
            cand_d_raw = dist_fn(nbrs)

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

        if window_n > 0:
            win_dists, win_ids = merge_sorted_into_window(
                win_dists, win_ids, cand_d, nbrs
            )
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
        window_ids=win_ids,
        window_dists=win_dists,
    )
