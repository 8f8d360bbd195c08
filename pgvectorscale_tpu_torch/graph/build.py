"""Wave-based Vamana graph construction (PyTorch port of ``graph/build.py``).

The JAX package's wave build: candidates come from a beam search (or,
while the graph is small, from a brute-force scan); one batched
RobustPrune turns them into neighbour lists; reverse edges are appended
with a sort-based scatter, and rows that overflow are re-pruned in the
same wave.  ``finalize`` trims every row to R and repairs orphans.  A
refinement wave (``insert_wave`` with ``n_existing=None`` and
``include_existing``) re-inserts nodes against the finished graph with
their current neighbours in contention.

The build measures (``IndexConfig.build_distance``, SBQ storage):

- ``exact-prune`` (default): traversal scores Hamming distances on the
  codes over a snapshot of the adjacency; brute-force seeds, candidate
  distances and the prune's pairwise distances are full precision, and
  beam-search candidates are re-measured in full precision.
- ``storage`` (the reference's own build, sbq/mod.rs:161-190): every
  distance is Hamming on the codes.  The brute-force seed scan goes
  through the Hamming-matrix kernel, and the prune's pairwise distances
  come from the popcount-dot identity on unpacked bits.
- ``exact``: every distance is full precision, traversal included; it
  reads the live adjacency as it stood at the start of the wave.

Plain storage (no codes) builds as ``exact`` does.

Labeled indexes (Filtered-DiskANN): every searched wave runs a second,
filtered beam search from the start nodes of each row's labels over the
same adjacency, and its visit history joins the candidates; the prune is
label-aware.  Brute-force waves have no filtered pass.

Every step is batched over the wave.  Python loops run only where the
JAX package runs a sequential loop: over waves, beam iterations,
RobustPrune's dependent scan and the finalize batches; the reachability
BFS is one kernel launch on the card (``ops.reachable``).
Rows that the JAX package writes with ``mode="drop"`` go through one
spare row (``_set_rows``), so no write needs a host round trip.
"""

from __future__ import annotations

import logging
import math
from typing import Optional

import numpy as np
import torch

from .. import native
from ..config import DistanceType, IndexConfig
from ..distance import row_distances
from ..ops.hamming import hamming_gather
from ..ops.hamming_matrix import hamming_matrix
from ..ops.reachable import (
    CSR_BFS_MIN_CAP,
    reachable,
    reachable_csr_plain,
    reachable_scatter_plain,
)
from ..store import INVALID_ID, GraphArrays, dequant_rows
from .prune import (
    alpha_schedule,
    pairwise_distance_matrix_full,
    pairwise_hamming_mxu,
    robust_prune,
    unpack_code_bits,
)
from .search import beam_search, get_start_ids

logger = logging.getLogger("pgvectorscale_tpu_torch")

# Wave sizes: builds of at least 2 * MAX_WAVE rows use MAX_WAVE-row waves
# throughout; smaller builds ramp up geometrically from INITIAL_WAVE.
MAX_WAVE = 4096
INITIAL_WAVE = 256
# Refresh cadence of the build's adjacency snapshot: traversal runs
# against a snapshot up to this many waves old, as in the JAX package.
BUILD_SNAPSHOT_REFRESH_WAVES = 4
# Rows per re-prune batch in finalize.
PRUNE_BATCH = 8192
# Max distinct overflowing rows re-pruned per wave; further rejected
# edges wait for finalize and orphan repair.
MAX_OVERFLOW_ROWS = 4096
# Multi-frontier width for build-time searches.
BUILD_EXPAND_FACTOR = 4
# While the graph has at most this many nodes, candidates come from an
# exact brute-force scan instead of a beam search.
BRUTE_CANDIDATE_THRESHOLD = 4096
# Reverse edges considered per overflowing row per wave.
INCOMING_CAP = 64
# Orphans chained per repair round (JAX's top_k width); JAX's repair stops
# after 256 rounds.
_REPAIR_CHAIN_MAX = 4096
_REPAIR_ROUNDS = 256
# From this capacity on a CPU adjacency takes the CSR pull-BFS, as the JAX
# package's reachable_on_device does (the card always takes the kernel).
_CSR_BFS_MIN_CAP = CSR_BFS_MIN_CAP
# Above this many code bits the prune's bit unpack is chunked over words,
# bounding the transient [B, C, bits] f32 tensor (16k-dim indexes).
_PAIRWISE_CHUNK_BITS = 4096
_I32_MAX = 2**31 - 1


class BuildContext:
    """Build-wide settings derived once from the config."""

    def __init__(self, config: IndexConfig):
        self.config = config
        self.alphas = alpha_schedule(config.max_alpha)
        self.code_bits = config.dims_to_index * config.bits_per_dimension
        # The build's stats.WriteStats, when one is attached: insert_wave
        # counts waves, finalize counts re-pruned rows.
        self.stats = None


def _set_rows(table: torch.Tensor, row_ids: torch.Tensor, rows) -> torch.Tensor:
    """``table`` with ``table[row_ids] = rows``, where negative or
    out-of-range ids are dropped (they land in a spare row that is cut
    off).  Valid ids must be distinct."""
    n = table.shape[0]
    ext = torch.cat([table, table[:1]], dim=0)
    idx = torch.where((row_ids >= 0) & (row_ids < n), row_ids, n).long()
    ext[idx] = rows
    return ext[:n]


def candidate_pair_distances(
    arrays: GraphArrays,
    cand_ids: torch.Tensor,  # i32[B, C]
    *,
    use_codes: bool,
    code_bits: int,
    distance_type: DistanceType,
    trunc_dims: int,
) -> torch.Tensor:
    """Pairwise distances among each row's candidates, f32[B, C, C]:
    Hamming on the codes (popcount-dot on unpacked bits) when
    ``use_codes``, else full precision on the indexed prefix."""
    safe = cand_ids.clamp_min(0).long()
    if not use_codes:
        vecs = dequant_rows(arrays.vectors, arrays.vec_scales, safe)[..., :trunc_dims]
        return pairwise_distance_matrix_full(vecs, distance_type)
    codes = arrays.codes[safe]  # [B, C, W]
    if code_bits <= _PAIRWISE_CHUNK_BITS:
        return pairwise_hamming_mxu(unpack_code_bits(codes, code_bits))
    # Wide codes: accumulate the popcount-dot over word blocks so at most
    # [B, C, _PAIRWISE_CHUNK_BITS] bits are unpacked at once.
    b, c = cand_ids.shape
    wpc = _PAIRWISE_CHUNK_BITS // 32
    dots = torch.zeros((b, c, c), dtype=torch.float32, device=cand_ids.device)
    pops = torch.zeros((b, c), dtype=torch.float32, device=cand_ids.device)
    for w0 in range(0, codes.shape[-1], wpc):
        nb = min(code_bits - w0 * 32, wpc * 32)
        cb = unpack_code_bits(codes[..., w0 : w0 + wpc], nb)
        dots += torch.bmm(cb, cb.transpose(1, 2))
        pops += torch.sum(cb, dim=-1)
    return pops[:, :, None] + pops[:, None, :] - 2.0 * dots


def prune_candidate_sets(
    arrays: GraphArrays,
    node_ids: torch.Tensor,  # i32[B]
    cand_ids: torch.Tensor,  # i32[B, C]
    cand_dists: torch.Tensor,  # f32[B, C]
    *,
    use_codes: bool,
    code_bits: int,
    distance_type: DistanceType,
    alphas: tuple,
    num_neighbors: int,
    trunc_dims: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched add_neighbors-style prune: candidates -> neighbour lists;
    on a labeled index the nodes' and the candidates' labels go to the
    label-aware prune.  The pair matrix is handed over without a reference
    kept here; the prune kernel reads it in place, unsorted."""
    cand_labels = node_labels = None
    if arrays.node_labels.shape[1] > 0:
        cand_labels = arrays.node_labels[cand_ids.clamp_min(0).long()]
        node_labels = arrays.node_labels[node_ids.clamp_min(0).long()]
    return robust_prune(
        node_ids, cand_ids, cand_dists,
        candidate_pair_distances(
            arrays, cand_ids, use_codes=use_codes, code_bits=code_bits,
            distance_type=distance_type, trunc_dims=trunc_dims,
        ),
        cand_labels, node_labels,
        num_neighbors=num_neighbors, alphas=alphas,
    )


def append_backlinks(
    adjacency: torch.Tensor,  # i32[cap, R_max]
    edge_dst: torch.Tensor,  # i32[E] node receiving a reverse edge
    edge_src: torch.Tensor,  # i32[E] new node (INVALID_ID = no edge)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Append reverse edges into free adjacency slots: (adjacency,
    accepted bool[E]).  Edges whose destination row is full are rejected
    and left to the overflow prune.

    Edges sort by (dst, src), so duplicates are adjacent and each edge's
    rank in its dst run gives its slot, degree[dst] + rank."""
    cap, r_max = adjacency.shape
    e = edge_dst.shape[0]
    dev = adjacency.device

    valid = (edge_src != INVALID_ID) & (edge_dst != INVALID_ID)
    valid = valid & (edge_src != edge_dst)
    dst = torch.where(valid, edge_dst, _I32_MAX)
    # Lexicographic (dst, src) stable sort: minor key first.
    order = torch.sort(edge_src, stable=True).indices
    order = order[torch.sort(dst[order], stable=True).indices]
    s_dst, s_src, s_valid = dst[order], edge_src[order], valid[order]

    first = torch.ones((1,), dtype=torch.bool, device=dev)
    is_start = torch.cat([first, s_dst[1:] != s_dst[:-1]])

    safe_dst = s_dst.clamp(0, cap - 1).long()
    rows = adjacency[safe_dst]  # [E, R_max]
    already = torch.any(rows == s_src[:, None], dim=1)
    s_valid = s_valid & ~already
    dup = torch.cat(
        [~first, (s_dst[1:] == s_dst[:-1]) & (s_src[1:] == s_src[:-1])]
    ) & s_valid
    s_valid = s_valid & ~dup

    # Rank among the valid edges of each dst run.
    grp = s_valid.to(torch.int64)
    run_prefix = torch.cumsum(grp, 0) - grp
    run_base = torch.cummax(torch.where(is_start, run_prefix, 0), 0).values
    rank = run_prefix - run_base

    degree = torch.sum(rows != INVALID_ID, dim=1)
    pos = degree + rank
    fits = s_valid & (pos < r_max)

    # Only fitting edges are written; the rest go to a spare slot.
    flat = torch.cat([adjacency.reshape(-1), adjacency.new_full((1,), INVALID_ID)])
    write_idx = torch.where(fits, safe_dst * r_max + pos.clamp(0, r_max - 1), cap * r_max)
    flat[write_idx] = s_src
    new_adj = flat[: cap * r_max].view(cap, r_max)

    accepted = torch.zeros((e,), dtype=torch.bool, device=dev)
    accepted[order] = fits | already | dup
    return new_adj, accepted


def _dedup_candidates(cand_ids: torch.Tensor, cand_dists: torch.Tensor):
    """One copy per id per row: sort by id, drop adjacent repeats.  The
    output is ordered by id (robust_prune re-sorts by distance)."""
    b = cand_ids.shape[0]
    key = torch.where(cand_ids == INVALID_ID, _I32_MAX, cand_ids)
    s_ids, order = torch.sort(key, dim=1, stable=True)
    s_d = torch.gather(cand_dists, 1, order)
    dup = torch.cat(
        [torch.zeros((b, 1), dtype=torch.bool, device=cand_ids.device),
         s_ids[:, 1:] == s_ids[:, :-1]], dim=1,
    )
    drop = dup | (s_ids == _I32_MAX)
    return torch.where(drop, INVALID_ID, s_ids), torch.where(drop, torch.inf, s_d)


def _brute_candidates(
    arrays: GraphArrays,
    node_ids: torch.Tensor,  # i32[B]
    prefix: int,  # candidates restricted to ids < prefix
    *,
    slice_rows: int,
    num_candidates: int,
    distance_type: DistanceType,
    trunc_dims: int,
    use_codes: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-C candidates over the first ``prefix`` rows in the build's
    measure: Hamming on the codes through the Hamming-matrix kernel when
    ``use_codes`` (storage builds), else full precision.  Integer
    distances tie everywhere; the stable sort keeps the lowest id among
    ties, as ``lax.top_k`` does."""
    safe_ids = node_ids.clamp_min(0).long()
    if use_codes:
        d = hamming_matrix(
            arrays.codes[safe_ids], arrays.codes[:slice_rows]
        ).to(torch.float32)
    else:
        qv = dequant_rows(arrays.vectors, arrays.vec_scales, safe_ids)[:, :trunc_dims].float()
        pts = dequant_rows(
            arrays.vectors, arrays.vec_scales, slice(None, slice_rows))[:, :trunc_dims].float()
        dots = qv @ pts.T
        if distance_type == DistanceType.L2:
            q_sq = torch.sum(qv * qv, dim=-1, keepdim=True)
            c_sq = torch.sum(pts * pts, dim=-1)[None, :]
            d = torch.clamp_min(q_sq - 2.0 * dots + c_sq, 0.0)
        elif distance_type == DistanceType.INNER_PRODUCT:
            d = -dots
        else:
            d = torch.clamp_min(1.0 - dots, 0.0)
    col = torch.arange(slice_rows, device=d.device)[None, :]
    d = torch.where(col < prefix, d, torch.inf)
    dists, ids = torch.sort(d, dim=1, stable=True)
    dists, ids = dists[:, :num_candidates], ids[:, :num_candidates]
    ids = torch.where(torch.isfinite(dists), ids.to(torch.int32), INVALID_ID)
    return ids, dists


def _build_max_iters(l: int) -> int:
    """Build-time visit budget."""
    return int(math.ceil(1.5 * l)) + 16


def _prune_rows_core(
    arrays: GraphArrays,
    row_ids: torch.Tensor,  # i32[B] (INVALID_ID padding allowed)
    incoming: torch.Tensor,  # i32[B, W_inc]
    *,
    use_codes: bool,
    code_bits: int,
    distance_type: DistanceType,
    alphas: tuple,
    num_neighbors: int,
    trunc_dims: int,
) -> GraphArrays:
    """Prune rows to num_neighbors with candidates = existing + incoming
    (add_neighbors' overflow path)."""
    safe_rows = row_ids.clamp_min(0).long()
    existing = arrays.adjacency[safe_rows]
    cand_ids = torch.cat([existing, incoming], dim=1)
    cand_ids = torch.where((row_ids != INVALID_ID)[:, None], cand_ids, INVALID_ID)
    if use_codes:
        cand_d = hamming_gather(
            arrays.codes[safe_rows], arrays.codes, cand_ids
        ).to(torch.float32)
    else:
        qv = dequant_rows(arrays.vectors, arrays.vec_scales, safe_rows)[:, :trunc_dims].float()
        cand_d = row_distances(arrays.vectors, qv, cand_ids, distance_type, arrays.vec_scales)
    cand_d = torch.where(cand_ids == INVALID_ID, torch.inf, cand_d)
    cand_ids, cand_d = _dedup_candidates(cand_ids, cand_d)
    nbr_ids, _ = prune_candidate_sets(
        arrays, row_ids, cand_ids, cand_d,
        use_codes=use_codes, code_bits=code_bits,
        distance_type=distance_type, alphas=alphas,
        num_neighbors=num_neighbors, trunc_dims=trunc_dims,
    )
    rows = torch.nn.functional.pad(
        nbr_ids, (0, arrays.max_degree - nbr_ids.shape[1]), value=INVALID_ID
    )
    return arrays._replace(adjacency=_set_rows(arrays.adjacency, row_ids, rows))


def _overflow_prune(
    arrays: GraphArrays,
    edge_dst: torch.Tensor,  # i32[E]
    edge_src: torch.Tensor,  # i32[E]
    rejected: torch.Tensor,  # bool[E]
    **prune_kw,
) -> GraphArrays:
    """Re-prune up to MAX_OVERFLOW_ROWS distinct full rows, each with
    candidates = existing + up to INCOMING_CAP rejected reverse edges.
    The JAX package pads the batch to MAX_OVERFLOW_ROWS rows to keep one
    compiled shape; padded rows write nothing, so the port prunes only
    the rows that overflowed (one host read of their count)."""
    e = edge_dst.shape[0]
    dev = edge_dst.device

    key = torch.where(rejected, edge_dst, _I32_MAX)
    s = torch.sort(key).values
    is_first = torch.cat(
        [torch.ones((1,), dtype=torch.bool, device=dev), s[1:] != s[:-1]]
    ) & (s != _I32_MAX)
    m = min(MAX_OVERFLOW_ROWS, int(is_first.sum()))
    uniq = torch.sort(torch.where(is_first, s, _I32_MAX)).values[:m]
    row_ids = torch.where(uniq != _I32_MAX, uniq, INVALID_ID)

    order = torch.sort(key, stable=True).indices
    s_dst, s_src = key[order], edge_src[order]
    idx = torch.arange(e, dtype=torch.int64, device=dev)
    is_start = torch.cat(
        [torch.ones((1,), dtype=torch.bool, device=dev), s_dst[1:] != s_dst[:-1]]
    )
    start_idx = torch.cummax(torch.where(is_start, idx, 0), 0).values
    rank = idx - start_idx

    row_pos = torch.searchsorted(uniq, s_dst).clamp(0, m - 1)
    hit = (uniq[row_pos] == s_dst) & (s_dst != _I32_MAX)
    write_row = torch.where(hit & (rank < INCOMING_CAP), row_pos, m)
    write_col = rank.clamp(0, INCOMING_CAP - 1)
    incoming = torch.full((m + 1, INCOMING_CAP), INVALID_ID, dtype=torch.int32, device=dev)
    incoming[write_row, write_col] = s_src
    return _prune_rows_core(arrays, row_ids, incoming[:m], **prune_kw)


def _wave_step(
    arrays: GraphArrays,
    node_ids: torch.Tensor,  # i32[B], INVALID_ID padded
    prefix: int,  # rows < prefix may be candidates
    snap_adjacency: Optional[torch.Tensor],  # i32[cap, R] snapshot
    **kw,
) -> GraphArrays:
    """One wave: candidates, prune (``_wave_neighbours``), then row writes,
    backlinks and the overflow prune (``_wave_commit``)."""
    nbr_ids = _wave_neighbours(arrays, node_ids, prefix, snap_adjacency, **kw)
    return _wave_commit(arrays, node_ids, nbr_ids, **_prune_kw(kw))


def _prune_kw(wave_kw: dict) -> dict:
    """The prune's settings among a wave step's keyword arguments."""
    return dict(
        use_codes=wave_kw["prune_use_codes"], code_bits=wave_kw["code_bits"],
        distance_type=wave_kw["distance_type"], alphas=wave_kw["alphas"],
        num_neighbors=wave_kw["num_neighbors"], trunc_dims=wave_kw["trunc_dims"],
    )


def _wave_neighbours(
    arrays: GraphArrays,
    node_ids: torch.Tensor,  # i32[B], INVALID_ID padded
    prefix: int,  # rows < prefix may be candidates
    snap_adjacency: Optional[torch.Tensor],  # i32[cap, R] snapshot
    *,
    search_list_size: int,
    max_iters: int,
    brute: bool,
    slice_rows: int,
    distance_type: DistanceType,
    alphas: tuple,
    num_neighbors: int,
    trunc_dims: int,
    prune_use_codes: bool,
    code_bits: int,
    use_codes: bool = True,
    include_existing: bool = False,
) -> torch.Tensor:
    """A wave's neighbour lists, i32[B, R]: candidates, then the prune.
    Each row's list depends on that row and the arrays alone, so a wave
    split into parts gives the same lists.

    ``use_codes`` is the traversal measure: Hamming on the codes over
    ``snap_adjacency`` (which a searched wave then needs), else full
    precision over the live adjacency, as it stands when the wave starts.
    ``prune_use_codes`` (storage builds) makes the brute-force seeds, the
    candidate distances and the prune Hamming too, else they are full
    precision, and candidates that Hamming traversal generated are
    re-measured (exact-prune).  ``include_existing`` (refinement) adds
    each node's current neighbours to its candidates, scored by the
    prune's measure.

    Labeled index: a searched wave runs a second, filtered beam search from
    the start nodes of each row's labels (the live label table) over the
    same adjacency, reading the live ``node_labels``; both visit
    histories, deduped, are the candidates, and the prune is
    label-aware."""
    l = search_list_size
    safe_ids = node_ids.clamp_min(0).long()
    query_codes = arrays.codes[safe_ids]
    query_vecs = dequant_rows(
        arrays.vectors, arrays.vec_scales, safe_ids)[:, :trunc_dims].float()
    labeled = arrays.node_labels.shape[1] > 0
    node_labels = arrays.node_labels[safe_ids] if labeled else None
    prune_kw = dict(
        use_codes=prune_use_codes, code_bits=code_bits,
        distance_type=distance_type, alphas=alphas,
        num_neighbors=num_neighbors, trunc_dims=trunc_dims,
    )

    if brute:
        # Candidates over the prefix plus the wave itself, so intra-wave
        # edges form directly (+1: each node scores itself).
        cand_ids, cand_dists = _brute_candidates(
            arrays, node_ids, prefix,
            slice_rows=slice_rows,
            num_candidates=min(l + 1, slice_rows),
            distance_type=distance_type,
            trunc_dims=trunc_dims,
            use_codes=prune_use_codes,
        )
    else:
        if use_codes and snap_adjacency is None:
            raise ValueError("a searched wave on codes needs the snapshot's adjacency")
        b = node_ids.shape[0]
        search_arrays = arrays._replace(adjacency=snap_adjacency) if use_codes else arrays
        search_kw = dict(
            search_list_size=l,
            max_iters=max_iters,
            expand_factor=min(BUILD_EXPAND_FACTOR, l),
            query_vecs=query_vecs,
            use_codes=use_codes,
            distance_type=distance_type,
        )
        res = beam_search(search_arrays, query_codes, get_start_ids(arrays, b),
                          **search_kw)
        cand_ids, cand_dists = _dedup_candidates(res.hist_ids, res.hist_dists)
        if labeled:
            # The filtered pass from the label starts (two-phase insert,
            # graph/mod.rs:652-660).
            res_f = beam_search(
                search_arrays, query_codes, get_start_ids(arrays, b, node_labels),
                query_labels=node_labels, **search_kw,
            )
            cand_ids, cand_dists = _dedup_candidates(
                torch.cat([cand_ids, res_f.hist_ids], dim=1),
                torch.cat([cand_dists, res_f.hist_dists], dim=1),
            )

    if include_existing:
        # Refinement: the current neighbours stay in contention.
        existing = arrays.adjacency[safe_ids]
        if prune_use_codes:
            ex_d = hamming_gather(query_codes, arrays.codes, existing).to(torch.float32)
        else:
            ex_d = row_distances(arrays.vectors, query_vecs, existing, distance_type,
                                 arrays.vec_scales)
        ex_d = torch.where(existing == INVALID_ID, torch.inf, ex_d)
        cand_ids, cand_dists = _dedup_candidates(
            torch.cat([cand_ids, existing], dim=1), torch.cat([cand_dists, ex_d], dim=1)
        )

    if use_codes and not prune_use_codes and not brute:
        # exact-prune: re-measure the Hamming-generated candidates.
        ex = row_distances(arrays.vectors, query_vecs, cand_ids, distance_type,
                           arrays.vec_scales)
        cand_dists = torch.where(cand_ids == INVALID_ID, torch.inf, ex)

    nbr_ids, _ = prune_candidate_sets(
        arrays, node_ids, cand_ids, cand_dists, **prune_kw
    )
    return nbr_ids


def _wave_commit(
    arrays: GraphArrays,
    node_ids: torch.Tensor,  # i32[B], INVALID_ID padded
    nbr_ids: torch.Tensor,  # i32[B, R] the wave's pruned neighbour lists
    **prune_kw,
) -> GraphArrays:
    """The wave's writes: the rows themselves, the backlinks and the
    overflow prune of the rows the backlinks overfill."""
    rows = torch.nn.functional.pad(
        nbr_ids, (0, arrays.max_degree - nbr_ids.shape[1]), value=INVALID_ID
    )
    arrays = arrays._replace(adjacency=_set_rows(arrays.adjacency, node_ids, rows))

    edge_dst = nbr_ids.reshape(-1)
    edge_src = node_ids.repeat_interleave(nbr_ids.shape[1])
    adjacency, accepted = append_backlinks(arrays.adjacency, edge_dst, edge_src)
    arrays = arrays._replace(adjacency=adjacency)

    rejected = ~accepted & (edge_dst != INVALID_ID) & (edge_src != INVALID_ID)
    if bool(rejected.any()):
        arrays = _overflow_prune(arrays, edge_dst, edge_src, rejected, **prune_kw)
    return arrays


def insert_wave(
    arrays: GraphArrays,
    ctx: BuildContext,
    node_ids: torch.Tensor,  # i32[B] ids of stored rows, INVALID_ID padded
    *,
    n_existing: Optional[int] = None,
    n_real: int = 0,
    prefix_rows: Optional[int] = None,
    snap_adjacency: Optional[torch.Tensor] = None,
    include_existing: bool = False,
) -> GraphArrays:
    """Insert a wave of ``n_real`` stored rows (INVALID_ID padded).

    ``n_existing``: the wave's ids follow the ``n_existing`` rows already
    in the graph, so candidates are rows < n_existing + n_real.
    ``prefix_rows``: the wave's ids are scattered below ``prefix_rows``
    (tombstone reuse); candidates are rows < prefix_rows.  At most one of
    the two is given.  While the candidate rows number at most
    BRUTE_CANDIDATE_THRESHOLD the candidates come from a brute-force scan,
    else from a beam search.  With neither (refinement) the wave always
    beam-searches the whole graph.

    ``snap_adjacency`` is what a beam search on codes traverses; a
    full-precision traversal (``build_traversal_uses_codes`` False) reads
    the live adjacency and ignores it."""
    if n_existing is not None and prefix_rows is not None:
        raise ValueError("give at most one of n_existing and prefix_rows")
    config = ctx.config
    l = config.search_list_size
    if prefix_rows is not None:
        brute = prefix_rows <= BRUTE_CANDIDATE_THRESHOLD
        prefix = prefix_rows
    elif n_existing is not None:
        brute = n_existing <= BRUTE_CANDIDATE_THRESHOLD
        prefix = n_existing + n_real
    else:
        brute = False
        prefix = n_real
    use_codes = config.build_traversal_uses_codes
    if ctx.stats is not None:
        ctx.stats.num_waves += 1
    return _wave_step(
        arrays, node_ids, prefix,
        None if brute or not use_codes else snap_adjacency,
        search_list_size=l,
        max_iters=_build_max_iters(l),
        brute=brute,
        slice_rows=min(BRUTE_CANDIDATE_THRESHOLD + node_ids.shape[0], arrays.capacity),
        distance_type=config.distance_type,
        alphas=ctx.alphas,
        num_neighbors=config.num_neighbors,
        trunc_dims=config.dims_to_index,
        prune_use_codes=config.build_prune_uses_codes,
        code_bits=ctx.code_bits,
        use_codes=use_codes,
        include_existing=include_existing,
    )


def finalize(arrays: GraphArrays, ctx: BuildContext) -> GraphArrays:
    """Trim every row above num_neighbors with one more prune, then repair
    orphans (finalize_index_build)."""
    return repair_orphans(prune_over_degree(arrays, ctx))


def prune_over_degree(arrays: GraphArrays, ctx: BuildContext) -> GraphArrays:
    """Re-prune every row with more than num_neighbors neighbours, in
    batches of PRUNE_BATCH rows (ascending ids): finalize's prune pass."""
    config = ctx.config
    cap = arrays.capacity
    dev = arrays.device
    row = torch.arange(cap, dtype=torch.int32, device=dev)
    deg = torch.sum(arrays.adjacency != INVALID_ID, dim=1)
    over = (row < arrays.count) & (deg > config.num_neighbors)
    order = torch.sort(torch.where(over, row, _I32_MAX)).values
    n_over = int(over.sum())
    if ctx.stats is not None:
        ctx.stats.num_prunes += n_over
    # Batches of PRUNE_BATCH rows; the last one is not padded (padded rows
    # write nothing).
    for i in range(0, n_over, PRUNE_BATCH):
        batch = order[i : min(i + PRUNE_BATCH, n_over)]
        inc = torch.full((batch.shape[0], 1), INVALID_ID, dtype=torch.int32, device=dev)
        arrays = _prune_rows_core(
            arrays, batch, inc,
            use_codes=config.build_prune_uses_codes, code_bits=ctx.code_bits,
            distance_type=config.distance_type, alphas=ctx.alphas,
            num_neighbors=config.num_neighbors, trunc_dims=config.dims_to_index,
        )
    return arrays


def _reachable_scatter(arrays: GraphArrays) -> torch.Tensor:
    """bool[cap] reachability from the default start node by JAX's scatter
    BFS (one host read a round): a plain version."""
    return reachable_scatter_plain(arrays.adjacency, arrays.count, arrays.default_start)


def _reachable_csr(arrays: GraphArrays) -> torch.Tensor:
    """bool[cap] reachability from the default start node by JAX's CSR
    pull-BFS (one host read a round): a plain version."""
    return reachable_csr_plain(arrays.adjacency, arrays.count, arrays.default_start)


def reachable_on_device(arrays: GraphArrays) -> torch.Tensor:
    """bool[cap] reachability from the default start node.  On the card,
    one launch of the BFS kernel at every capacity; on the CPU the plain
    BFS that the JAX package picks for the capacity."""
    return reachable(arrays.adjacency, arrays.count, arrays.default_start,
                     csr_min_cap=_CSR_BFS_MIN_CAP)


def repair_orphans_device(arrays: GraphArrays) -> GraphArrays:
    """One BFS, then chain the orphans off the start node:
    start -> o_0 -> o_1 -> ... using the last slots of orphan rows (no
    path from the start runs through an orphan) and re-homing the start's
    displaced last edge as the head's second-to-last edge.

    JAX's loop takes k = min(cap, _REPAIR_CHAIN_MAX) orphans a round in
    ascending id for up to _REPAIR_ROUNDS rounds.  Its writes are written
    here at once, in fixed-shape tensor ops with no host read: with p an
    orphan's place in ascending order, g = p // k its round and q = p % k
    its place in the round, for p < _REPAIR_ROUNDS * k,

      (o_p, R-1)  <- o_{p+1}      when q < k - 1 and o_{p+1} exists;
      (o_p, R-2)  <- t_g          when q == 0: t_0 = adj[start, R-1] (if
                                  not -1), t_g = o_{(g-1) k} (the head that
                                  round g - 1 wrote into the start's slot);
      (start, R-1) <- the last round's head.

    With the start past the table JAX drops the entry write and reads the
    clamped row cap - 1, whose last slot no round writes (it is not an
    orphan, or the last one): every round re-homes t_0.
    """
    cap, r_max = arrays.adjacency.shape
    start = arrays.default_start
    if start < 0 or cap == 0:
        return arrays
    dev = arrays.device
    k = min(cap, _REPAIR_CHAIN_MAX)
    row = torch.arange(cap, device=dev)
    orphan = (row < arrays.count) & ~reachable_on_device(arrays)
    pos = torch.cumsum(orphan, 0) - 1  # an orphan's place in ascending order
    total = pos[-1:] + 1
    taken = orphan & (pos < _REPAIR_ROUNDS * k)
    # ids[p]: the p-th orphan (slot cap takes every other row's write).
    ids = torch.zeros((cap + 1,), dtype=torch.int64, device=dev)
    ids.scatter_(0, torch.where(taken, pos, cap), row)
    q = torch.remainder(pos, k)
    g = torch.div(pos, k, rounding_mode="floor")
    adj = arrays.adjacency.clone()
    link = taken & (q < k - 1) & (pos + 1 < total)
    nxt = ids[(pos + 1).clamp(0, cap)]
    adj[:, r_max - 1] = torch.where(link, nxt, adj[:, r_max - 1].long()).to(torch.int32)
    t_first = arrays.adjacency[min(start, cap - 1), r_max - 1:r_max].long()
    prev_head = ids[((g - 1) * k).clamp_min(0)] if start < cap else t_first
    t_old = torch.where(g > 0, prev_head, t_first)
    rehome = taken & (q == 0) & (t_old != INVALID_ID)
    adj[:, r_max - 2] = torch.where(rehome, t_old, adj[:, r_max - 2].long()).to(torch.int32)
    if start < cap:
        n_taken = total.clamp_max(_REPAIR_ROUNDS * k)
        last_head = ids[torch.div((n_taken - 1).clamp_min(0), k, rounding_mode="floor") * k]
        entry = adj[start, r_max - 1:r_max]
        entry.copy_(torch.where(n_taken > 0, last_head, entry.long()).to(torch.int32))
    return arrays._replace(adjacency=adj)


def repair_orphans(arrays: GraphArrays) -> GraphArrays:
    """Guarantee every node is reachable from the default start node.

    Batched insertion can orphan a node when every row it linked to prunes
    the backlink away (the reference warns about orphans,
    graph/mod.rs:706-716, and its tests assert full reachability).  The
    device repair runs first; if it leaves an orphan, the host repair
    (``repair_orphans_host``) finishes."""
    n = arrays.count
    if n == 0 or arrays.default_start < 0:
        return arrays
    n_orphans = int((~reachable_on_device(arrays)[:n]).sum())
    if n_orphans == 0:
        return arrays
    logger.warning(
        "repairing %d orphaned node(s): forcing edges from reachable "
        "nodes so the full graph stays scannable", n_orphans,
    )
    arrays = repair_orphans_device(arrays)
    n_orphans = int((~reachable_on_device(arrays)[:n]).sum())
    if n_orphans == 0:
        return arrays
    logger.warning(
        "device orphan repair left %d orphan(s); falling back to the "
        "host repair path", n_orphans,
    )
    return repair_orphans_host(arrays)


def repair_orphans_host(arrays: GraphArrays) -> GraphArrays:
    """Download ``adjacency[:count]``, give every node unreachable from the
    default start a forced edge from a reachable host (its own nearest
    reachable forward neighbour with a free slot first, else the orphan
    repaired just before it, else a full neighbour or the start, whose
    last edge is overwritten), and write the rows back as a new tensor.
    The native runtime does it in C++; without it, the same chain repair
    runs in NumPy.  Returns ``arrays`` itself when nothing was forced."""
    n, start = arrays.count, arrays.default_start
    if n == 0 or start < 0:
        return arrays
    adj = np.ascontiguousarray(arrays.adjacency[:n].cpu().numpy(), dtype=np.int32).copy()
    if native.available():
        forced = native.repair_orphans_inplace(adj, start)
    else:
        forced = _repair_orphans_numpy(adj, start)
    if forced == 0:
        return arrays
    new_adj = arrays.adjacency.clone()
    new_adj[:n] = torch.from_numpy(adj).to(new_adj.device)
    return arrays._replace(adjacency=new_adj)


def _repair_orphans_numpy(adj: np.ndarray, start: int) -> int:
    """The native chain repair (``host_graph.cc``) in NumPy, in place;
    returns the number of forced edges."""
    r = adj.shape[1]
    forced = 0

    def free_slot(node):
        free = np.nonzero(adj[node] == INVALID_ID)[0]
        return int(free[0]) if free.size else -1

    for _ in range(64):
        seen = native.bfs_reachable(adj, start)
        orphans = np.nonzero(~seen)[0]
        if orphans.size == 0:
            break
        progress = False
        chain_prev = -1
        for u in orphans:
            host = host_full = -1
            for w in adj[u]:
                w = int(w)
                if w < 0 or w >= len(seen) or not seen[w]:
                    continue
                if free_slot(w) >= 0:
                    host = w
                    break
                if host_full < 0:
                    host_full = w
            if host < 0 and chain_prev >= 0 and free_slot(chain_prev) >= 0:
                host = chain_prev
            if host < 0:
                host = host_full if host_full >= 0 else start
            if host == u:
                continue
            slot = free_slot(host)
            adj[host, slot if slot >= 0 else r - 1] = u
            seen[u] = True  # the host is reachable, so u now is too
            chain_prev = int(u)
            forced += 1
            progress = True
        if not progress:
            break
    return forced
