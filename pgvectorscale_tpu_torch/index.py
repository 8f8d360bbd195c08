"""DiskannIndex: the index's life cycle (PyTorch port of ``index.py``).

The JAX package's public index for f32, bf16 and int8 vectors, SBQ or
plain storage, labeled or not: ``build`` (ingest, in chunks above
INGEST_CHUNK_BYTES of host input; wave inserts, finalize, optional
refinement passes; every ``build_distance``; N may be 0; label sets per
row), ``add`` (tombstone reuse first, then fresh rows), ``delete`` /
``delete_external``, ``compact``, ``search`` with the "expand", "beam"
and "scored" rescore windows and the label filter (``query_labels``: the
``&&`` overlap predicate), the streaming ``search_iter``
(``SearchIterator``, resumable traversal in ``graph/iterate.py``), and
``save`` / ``load`` in the JAX package's checkpoint format (version 3;
versions 1-2 are migrated on load).  Search results are internal row
ids; ``to_external`` maps them.  The bf16 tier stores the rows in
bfloat16 (rounded to nearest even from the float32 rows, which the codes
are encoded from) and converts gathered rows to float32 before each dot;
the int8 tier stores round-half-even(x / scale) with a per-row scale
(``store.quantize_rows``) and rescores with the scale factored out of the
sum (``_exact_batch_distances``).  ``enable_durability`` journals every
later mutation and ``load`` replays the journal (``durability.py``);
``last_search_stats``, ``build_stats`` and ``estimate_query_cost`` report
the work done (``stats.py``).

Readers see snapshots, as in the JAX package: ``add`` and ``delete`` never
write a tensor or host array that ``index.arrays`` or
``index.external_ids`` held before the call.  They build new ones and
publish them at the end (the arrays first, then the host mirrors), so a
search that took ``index.arrays`` keeps a consistent index, and an
exception inside ``add`` leaves the index as it was.  Callers serialize
writers.

``build``, ``search``, ``load`` and ``from_jax_state`` run on
``torch.device("cuda")`` unless the caller names another device, and
raise when that device is missing.  Float32 matrix products run in full
float32 (TF32 off) for the whole call.
"""

from __future__ import annotations

import contextlib
import heapq
import json
import logging
import math
import os
import time
from typing import Iterable, Optional

import numpy as np
import torch

from . import store
from .config import CHECKPOINT_MAGIC, CHECKPOINT_VERSION, DistanceType, IndexConfig, QueryParams
from .distance import GATHER_CHUNK_BYTES, preprocess_query, row_distances
from .graph.build import (
    BRUTE_CANDIDATE_THRESHOLD,
    BUILD_SNAPSHOT_REFRESH_WAVES,
    INITIAL_WAVE,
    MAX_WAVE,
    BuildContext,
    _dedup_candidates,
    finalize,
    insert_wave,
    repair_orphans,
)
from .durability import DurableIndexMixin, MutationJournal, atomic_write_npz, normalize_ckpt_path
from .graph.search import _stable_sort_by, beam_search, get_start_ids
from .labels import LABEL_SENTINEL, make_label_array, overlaps
from .ops import sbq
from .ops.edge_gather import hamming_edge_gather
from .stats import GreedySearchStats, WriteStats
from .store import INVALID_ID, GraphArrays

logger = logging.getLogger("pgvectorscale_tpu_torch")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def _full_f32():
    """Float32 matrix products in full float32 (no TF32), as the JAX
    package's Precision.HIGHEST."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _query_max_iters(l: int, visit_factor: float = 1.0) -> int:
    return int(math.ceil(1.5 * l * visit_factor)) + 16


def _expand_rescore_window(
    arrays: GraphArrays,
    query_codes: torch.Tensor,  # i32[Q, W]
    beam_ids: torch.Tensor,  # i32[Q, L] ascending by distance
    beam_dists: torch.Tensor,  # f32[Q, L]
    *,
    expand_m: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Widen the rescore window with the 1-hop neighbourhood of the top
    ``expand_m`` beam nodes (scored by the edge-gather kernel), deduped."""
    q = beam_ids.shape[0]
    r = arrays.max_degree
    top = beam_ids[:, :expand_m]
    safe = top.clamp_min(0).contiguous()
    rows = arrays.adjacency[safe.long()]  # [Q, m, R]
    nbrs = rows.reshape(q, expand_m * r)
    valid = ((top != INVALID_ID)[:, :, None] & (rows != INVALID_ID)).reshape(
        q, expand_m * r
    )
    nd = hamming_edge_gather(arrays.codes, arrays.adjacency, safe, query_codes)
    nd = torch.where(valid, nd, torch.inf)
    nbrs = torch.where(valid, nbrs, INVALID_ID)
    return _dedup_candidates(
        torch.cat([beam_ids, nbrs], dim=1), torch.cat([beam_dists, nd], dim=1)
    )


def _window_plan(config: IndexConfig, params: QueryParams, k: int, l: int,
                 use_exact: bool, r_max: int) -> tuple[int, int, int]:
    """(beam width, "expand" window's m, "scored" window's n) of a search.
    A rescore window wider than the beam: "expand" (SBQ) caps the beam
    near 2L and widens the candidates with the top beam nodes' 1-hop
    neighbours; "scored" caps the beam the same way and keeps the best
    `window` scored candidates of the search; otherwise ("beam", and
    plain storage's "expand") the beam itself widens.  The visit budget
    stays keyed to L."""
    window = params.rescore + k if use_exact else 0
    beam_width = max(l, window)
    if config.uses_sbq and params.window_strategy == "expand" and window > 2 * l + 16:
        beam_width = 2 * l + 16
        return beam_width, min(beam_width, max(4, -(-2 * (window - beam_width) // r_max))), 0
    if params.window_strategy == "scored" and window > l:
        return min(2 * l + 16, window), 0, window
    return beam_width, 0, 0


def _exact_batch_distances(
    vectors: torch.Tensor,  # f32, bf16 or int8[cap, D]
    scales: torch.Tensor,  # f32[cap]
    query_vecs: torch.Tensor,  # f32[Q, D]
    ids: torch.Tensor,  # i32[Q, M] (clamped; callers mask)
    distance_type: DistanceType,
) -> torch.Tensor:
    """Full-precision distances from each query to its candidate rows,
    f32[Q, M]: the rescore.

    int8 rows: the per-row scale factors out of the sum (<s·r, q> =
    s·<r, q>, ||s·r||² = s²·||r||²), and the query is split into
    q_hi = bf16(q) and q_lo = bf16(q - q_hi), as in the JAX package's two
    bf16 passes with float32 accumulation.  int8 values and both halves
    are exact in float32, so each pass is one full-float32 product of the
    widened operands (``torch.bmm`` on bf16 operands would round the sums
    to bf16); ||r||² sums integer products below 2**24, exactly.  The
    rows are widened per chunk of queries, at most GATHER_CHUNK_BYTES of
    float32 rows (twice that for L2) on top of their int8 gather.
    Other tiers: ``distance.row_distances``."""
    if vectors.dtype != torch.int8:
        return row_distances(vectors, query_vecs, ids, distance_type, scales)
    q, m = ids.shape
    safe = ids.clamp_min(0).long()
    q_hi = query_vecs.to(torch.bfloat16).to(torch.float32)
    q_lo = (query_vecs - q_hi).to(torch.bfloat16).to(torch.float32)
    q_split = torch.stack([q_hi, q_lo], dim=2)  # [Q, D, 2]
    l2 = distance_type == DistanceType.L2
    per_query = m * vectors.shape[1] * 4 * (2 if l2 else 1)
    chunk = max(1, GATHER_CHUNK_BYTES // max(per_query, 1))
    out = []
    for i in range(0, max(q, 1), chunk):
        idx = safe[i : i + chunk]
        rows = vectors[idx].to(torch.float32)  # [c, M, D], exact
        parts = torch.bmm(rows, q_split[i : i + chunk])  # [c, M, 2]
        dot = parts[..., 0] + parts[..., 1]
        sc = scales[idx]
        if l2:
            rnorm2 = torch.sum(rows * rows, dim=-1)
            qv = query_vecs[i : i + chunk]
            qnorm2 = torch.sum(qv * qv, dim=-1)[:, None]
            out.append(torch.clamp_min(sc * sc * rnorm2 - 2.0 * sc * dot + qnorm2, 0.0))
        elif distance_type == DistanceType.INNER_PRODUCT:
            out.append(-(sc * dot))
        else:
            out.append(torch.clamp_min(1.0 - sc * dot, 0.0))
    return out[0] if len(out) == 1 else torch.cat(out)


def _exact_distances(arrays: GraphArrays, query_vec: torch.Tensor, ids: torch.Tensor,
                     distance_type: DistanceType) -> torch.Tensor:
    """Full-precision distances from one query f32[D] to rows i32[M]."""
    return _exact_batch_distances(
        arrays.vectors, arrays.vec_scales, query_vec[None, :], ids[None, :], distance_type
    )[0]


def _finalize_results(
    arrays: GraphArrays,
    query_vecs: torch.Tensor,  # f32[Q, D]
    beam_ids: torch.Tensor,  # i32[Q, L]
    beam_dists: torch.Tensor,  # f32[Q, L]
    query_labels: Optional[torch.Tensor] = None,  # i32[Q, Lq] when filtered
    *,
    k: int,
    rescore_n: int,
    distance_type: DistanceType,
    use_exact: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tombstone filter + label filter + full-precision rescore + top-k."""
    safe = beam_ids.clamp_min(0).long()
    live = (beam_ids != INVALID_ID) & ~arrays.deleted[safe]
    if query_labels is not None and query_labels.shape[-1] > 0:
        live = live & overlaps(arrays.node_labels[safe], query_labels[:, None, :])
    d = torch.where(live, beam_dists, torch.inf)
    ids = torch.where(live, beam_ids, INVALID_ID)
    d, ids = _stable_sort_by(d, ids)
    if not use_exact:
        return ids[:, :k], d[:, :k]
    m = min(rescore_n + k, ids.shape[1])
    top_ids, top_d = ids[:, :m], d[:, :m]
    exact = _exact_batch_distances(
        arrays.vectors, arrays.vec_scales, query_vecs, top_ids, distance_type)
    exact = torch.where(top_ids == INVALID_ID, torch.inf, exact)
    exact = torch.where(top_d == torch.inf, torch.inf, exact)
    sd, sids = _stable_sort_by(exact, top_ids)
    return sids[:, :k], sd[:, :k]


def _search(
    arrays: GraphArrays,
    sbq_stats: sbq.SbqStats,
    raw_queries: torch.Tensor,  # f32[Q, D]
    *,
    config: IndexConfig,
    k: int,
    search_list_size: int,
    max_iters: int,
    rescore_n: int,
    use_exact: bool,
    expand_factor: int,
    expand_window_m: int = 0,
    window_n: int = 0,
    query_labels: Optional[torch.Tensor] = None,
):
    """Query path: normalize, encode (SBQ; plain storage's query codes
    are [Q, 0]), start nodes (and the label starts when ``query_labels``
    is given: a filtered search), beam search, the rescore window
    ("scored": the search's window buffer, deduped; "expand": the beam
    widened by 1-hop neighbours), label and tombstone filter, rescore,
    top-k."""
    q = raw_queries.shape[0]
    qv = preprocess_query(raw_queries, config.distance_type)
    q_indexed = qv[:, : config.dims_to_index]
    if config.uses_sbq:
        qc = sbq.encode(q_indexed, sbq_stats, config.bits_per_dimension)
    else:
        qc = torch.zeros((q, 0), dtype=torch.int32, device=qv.device)
    res = beam_search(
        arrays, qc, get_start_ids(arrays, q, query_labels),
        query_labels=query_labels,
        search_list_size=search_list_size,
        max_iters=max_iters,
        expand_factor=expand_factor,
        track_hist=False,
        query_vecs=q_indexed,
        use_codes=config.uses_sbq,
        distance_type=config.distance_type,
        window_n=window_n,
    )
    cand_ids, cand_dists = res.beam_ids, res.beam_dists
    if window_n > 0:
        # The window may hold an id twice: one dedup here.
        cand_ids, cand_dists = _dedup_candidates(res.window_ids, res.window_dists)
    if expand_window_m > 0:
        cand_ids, cand_dists = _expand_rescore_window(
            arrays, qc, cand_ids, cand_dists, expand_m=expand_window_m
        )
    ids, dists = _finalize_results(
        arrays, qv, cand_ids, cand_dists, query_labels,
        k=k, rescore_n=rescore_n, distance_type=config.distance_type,
        use_exact=use_exact,
    )
    return ids, dists, res


def _store_rows(arrays: GraphArrays, dev: torch.Tensor, stats: sbq.SbqStats, idx,
                config: IndexConfig) -> None:
    """Write preprocessed float32 rows ``dev`` at ``idx`` (a slice or row
    ids), in place: the rows in the tier's storage form (int8: quantized,
    with their scales) and, for SBQ, their codes under ``stats``."""
    if config.vector_dtype == "int8":
        arrays.vectors[idx], arrays.vec_scales[idx] = store.quantize_rows(dev)
    else:
        arrays.vectors[idx] = dev.to(arrays.vectors.dtype)
    if config.uses_sbq:
        arrays.codes[idx] = sbq.encode(
            dev[:, : config.dims_to_index], stats, config.bits_per_dimension
        )


def _ingest(raw: torch.Tensor, config: IndexConfig, capacity: int,
            stats: Optional[sbq.SbqStats] = None):
    """Allocate the store, normalize, train the quantizer (unless
    ``stats`` is given, or the storage is plain, which keeps untrained
    statistics and no codes), encode, store the rows (int8: quantized)."""
    n = raw.shape[0]
    arrays = store.empty_arrays(config, capacity, raw.device)
    dev = preprocess_query(raw, config.distance_type)
    if stats is None:
        stats = (sbq.train(dev[:, : config.dims_to_index]) if config.uses_sbq
                 else sbq.empty_stats(config.dims_to_index, raw.device))
    _store_rows(arrays, dev, stats, slice(0, n), config)
    return arrays._replace(count=n), stats


# Host input above this many float32 bytes is ingested in chunks: the
# one-shot ingest holds the input and the store on the device at once.
INGEST_CHUNK_BYTES = 1 << 30


def _ingest_chunk_rows(n: int, d: int) -> int:
    """Rows a chunk of the chunked ingest: about 512 MiB of float32 input,
    a multiple of 1,024 rows, at most N rounded up."""
    return min(_round_up(max(1, (512 << 20) // (d * 4)), 1024), _round_up(n, 1024))


def _train_chunk(stats: sbq.SbqStats, raw_chunk: torch.Tensor,
                 config: IndexConfig) -> sbq.SbqStats:
    """``stats`` merged with one chunk's statistics (Chan's update)."""
    dev = preprocess_query(raw_chunk, config.distance_type)
    return sbq.merge_stats(stats, sbq.train(dev[:, : config.dims_to_index]))


def _ingest_chunk(arrays: GraphArrays, raw_chunk: torch.Tensor, stats: sbq.SbqStats,
                  i0: int, config: IndexConfig) -> GraphArrays:
    """Normalize, encode and store one chunk at rows [i0, i0 + c), in
    place."""
    dev = preprocess_query(raw_chunk, config.distance_type)
    _store_rows(arrays, dev, stats, slice(i0, i0 + dev.shape[0]), config)
    return arrays


def _ingest_chunked(vectors: np.ndarray, config: IndexConfig, capacity: int,
                    stats: Optional[sbq.SbqStats], device: torch.device):
    """Two-pass ingest of a host corpus too large to sit on the device as
    one float32 tensor beside the store: pass 1 merges each chunk's
    quantizer statistics (``sbq.merge_stats``; not bit-equal to one
    batched pass, as in the JAX package), pass 2 normalizes, encodes and
    stores each chunk.  One chunk of input is on the device at a time."""
    n, d = vectors.shape
    chunk = _ingest_chunk_rows(n, d)

    def on_device(i0):
        return torch.from_numpy(np.ascontiguousarray(vectors[i0 : i0 + chunk])).to(device)

    if stats is None:
        stats = sbq.empty_stats(config.dims_to_index, device)
        if config.uses_sbq:
            for i0 in range(0, n, chunk):
                stats = _train_chunk(stats, on_device(i0), config)
    arrays = store.empty_arrays(config, capacity, device)
    for i0 in range(0, n, chunk):
        arrays = _ingest_chunk(arrays, on_device(i0), stats, i0, config)
    return arrays._replace(count=n), stats


def _add_ingest(arrays: GraphArrays, stats: sbq.SbqStats, raw: torch.Tensor,
                n0: int, config: IndexConfig) -> GraphArrays:
    """Normalize and encode with the stored statistics (never retrained)
    and store at rows [n0, n0 + M) (aminsert's create_node), in place:
    ``arrays`` must be the caller's own tensors, never published ones."""
    m = raw.shape[0]
    return _ingest_chunk(arrays, raw, stats, n0, config)._replace(count=n0 + m)


def _reuse_ingest(arrays: GraphArrays, stats: sbq.SbqStats, raw: torch.Tensor,
                  rows: torch.Tensor, config: IndexConfig) -> GraphArrays:
    """Overwrite tombstoned ``rows``: normalize, encode with the stored
    statistics, clear the tombstone and the outgoing edges (the in-place
    side of vacuum).  Stale incoming edges stay: they now lead to the new
    vector.  Writes in place: ``arrays`` must be the caller's own tensors,
    never published ones."""
    idx = rows.long()
    _store_rows(arrays, preprocess_query(raw, config.distance_type), stats, idx, config)
    arrays.deleted[idx] = False
    arrays.adjacency[idx] = INVALID_ID
    return arrays


def _own(arrays: GraphArrays) -> GraphArrays:
    """``arrays`` with copies of every tensor a write may touch: a reader
    may hold the originals.  The label tables are replaced, never
    written."""
    return arrays._replace(
        vectors=arrays.vectors.clone(), codes=arrays.codes.clone(),
        adjacency=arrays.adjacency.clone(), deleted=arrays.deleted.clone(),
        node_labels=arrays.node_labels.clone(), vec_scales=arrays.vec_scales.clone(),
    )


def _migrate_v1_to_v2(z: dict) -> dict:
    # v2 added config.vector_dtype (defaulted on read) and uint16 bit views
    # for bf16 vectors; v1 checkpoints are all-f32, nothing to rewrite.
    return z


def _migrate_v2_to_v3(z: dict) -> dict:
    # v3 added the int8 vector tier's per-row vec_scales; before it the
    # scale is the identity.
    z["vec_scales"] = np.ones(len(z["vectors"]), dtype=np.float32)
    return z


_CHECKPOINT_MIGRATIONS = {1: _migrate_v1_to_v2, 2: _migrate_v2_to_v3}


def _migrate_checkpoint(z: dict, version: int) -> dict:
    """Upgrade a loaded checkpoint dict to CHECKPOINT_VERSION, one version
    at a time (the reference's meta-page migration on fetch)."""
    while version < CHECKPOINT_VERSION:
        migrate = _CHECKPOINT_MIGRATIONS.get(version)
        if migrate is None:
            raise ValueError(f"no migration path from checkpoint version {version}")
        z = migrate(z)
        version += 1
    return z


def _stats_on(stats, device: torch.device) -> sbq.SbqStats:
    """SBQ statistics of either package (tensors or arrays) on ``device``."""
    def f32(x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, dtype=np.float32))
        return x.to(device, torch.float32)

    return sbq.SbqStats(int(np.asarray(stats.count)), f32(stats.mean), f32(stats.m2))


def _as_vectors(vectors, device: torch.device) -> torch.Tensor:
    if not isinstance(vectors, torch.Tensor):
        vectors = torch.from_numpy(np.ascontiguousarray(vectors, dtype=np.float32))
    return vectors.to(device, torch.float32)


def _register_label_starts(
    arrays: GraphArrays,
    label_arr: np.ndarray,  # i32[M, Lm] rows being stored
    node_ids: np.ndarray,  # i32[M] where they are stored
    grow: bool = True,
) -> GraphArrays:
    """The first row carrying a label that has no start node becomes its
    start node (update_start_nodes, graph/mod.rs:490-533).  New entries
    fill the table's free slots in ascending order, in the order the
    JAX package's row-by-row walk discovers them (row-major first
    occurrence); the table doubles when it runs out, or, with
    ``grow=False`` (the sharded index's rule, whose shards' tables keep
    one width), the labels found after the last free slot get none.
    Returns new table tensors; the old ones are not written."""
    keys = arrays.label_start_keys.cpu().numpy()
    ids = arrays.label_start_ids.cpu().numpy()
    lm = label_arr.shape[1]
    flat = label_arr.reshape(-1)
    rows = np.repeat(np.arange(label_arr.shape[0]), lm)
    real = flat != LABEL_SENTINEL
    labels, first = np.unique(flat[real], return_index=True)
    new = ~np.isin(labels, keys[keys != LABEL_SENTINEL])
    labels, first = labels[new], first[new]
    if len(labels) == 0:
        return arrays
    order = np.argsort(first, kind="stable")
    labels = labels[order]
    nodes = np.asarray(node_ids)[rows[real][first[order]]]
    free = np.nonzero(keys == LABEL_SENTINEL)[0]
    if not grow:
        labels, nodes = labels[: len(free)], nodes[: len(free)]
        if len(labels) == 0:
            return arrays
    elif len(free) < len(labels):
        grow_by = max(len(labels) - len(free), len(keys))
        keys = np.concatenate([keys, np.full(grow_by, LABEL_SENTINEL, np.int32)])
        ids = np.concatenate([ids, np.full(grow_by, INVALID_ID, np.int32)])
        free = np.nonzero(keys == LABEL_SENTINEL)[0]
    keys, ids = keys.copy(), ids.copy()
    keys[free[: len(labels)]] = labels
    ids[free[: len(labels)]] = nodes
    return _with_label_table(arrays, keys, ids)


def _clear_label_starts(arrays: GraphArrays, rows: np.ndarray) -> GraphArrays:
    """Unregister every label start node among ``rows`` (rows about to be
    recycled may start labels they will no longer carry); the label falls
    back to the default start until a row registers it again."""
    keys = arrays.label_start_keys.cpu().numpy()
    ids = arrays.label_start_ids.cpu().numpy()
    stale = np.isin(ids, rows) & (keys != LABEL_SENTINEL)
    if not stale.any():
        return arrays
    keys, ids = keys.copy(), ids.copy()
    keys[stale] = LABEL_SENTINEL
    ids[stale] = INVALID_ID
    return _with_label_table(arrays, keys, ids)


def _with_label_table(arrays: GraphArrays, keys: np.ndarray, ids: np.ndarray) -> GraphArrays:
    """``arrays`` with a new label table (new tensors on its device)."""
    dev = arrays.device
    return arrays._replace(label_start_keys=torch.from_numpy(keys).to(dev),
                           label_start_ids=torch.from_numpy(ids).to(dev))


class DiskannIndex(DurableIndexMixin):
    """A StreamingDiskANN index resident in one device's memory.

    ``enable_durability(path)`` (``durability.py``) attaches a mutation
    journal: every later ``add``/``delete`` appends its validated host
    inputs to it before any device write, and ``load(path)`` replays it."""

    def __init__(self, config: IndexConfig, arrays: GraphArrays,
                 sbq_stats: sbq.SbqStats, external_ids=None):
        self.config = config
        self.arrays = arrays
        self.sbq_stats = sbq_stats
        self._build_ctx = None  # made by the first insert (see _ctx)
        n = arrays.count
        if external_ids is None:
            external_ids = np.arange(n, dtype=np.int64)
        self.external_ids = np.array(external_ids, dtype=np.int64)  # host [count]
        if self.external_ids.shape != (n,):
            raise ValueError(f"external_ids must be [{n}]")
        # Host mirror of the tombstones: the add free list and the live
        # count read it without a device round trip.
        self._deleted_np = arrays.deleted.cpu().numpy().copy()
        self.last_search = None  # SearchResult of the latest search
        self._last_search_l = 0  # its search list size
        self.build_stats = None  # stats.WriteStats after build()

    @property
    def last_search_stats(self) -> Optional[GreedySearchStats]:
        """Stats of the latest search (GreedySearchStats analog), computed
        on access from ``last_search``: the search itself reads nothing
        back for them."""
        if self.last_search is None:
            return None
        return GreedySearchStats.from_search_result(self.last_search)

    @property
    def _ctx(self) -> BuildContext:
        """The build settings, made at the first insert."""
        if self._build_ctx is None:
            self._build_ctx = BuildContext(self.config)
        return self._build_ctx

    @property
    def device(self) -> torch.device:
        return self.arrays.device

    @property
    def count(self) -> int:
        """Rows in use, tombstoned rows included."""
        return self.arrays.count

    @property
    def num_deleted(self) -> int:
        return int(self._deleted_np[: self.count].sum())

    @property
    def num_live(self) -> int:
        return self.count - self.num_deleted

    @classmethod
    def build(
        cls,
        vectors,
        config: Optional[IndexConfig] = None,
        *,
        labels=None,
        external_ids=None,
        device=None,
        progress_callback=None,
        initial_wave: Optional[int] = None,
        max_wave: int = MAX_WAVE,
        sbq_stats: Optional[sbq.SbqStats] = None,
        refine_passes: int = 0,
    ) -> "DiskannIndex":
        """Build an index over ``vectors`` [N, D] (numpy or a tensor; N may
        be 0, which leaves the index empty and its quantizer untrained).

        Ingest (normalize, train SBQ, encode): in one pass, or, for host
        input (not a tensor) of more than INGEST_CHUNK_BYTES as float32,
        in chunks moved to the device one at a time (``_ingest_chunked``,
        the JAX package's rule).  Then waves of
        up to ``max_wave`` rows, then finalize.  ``initial_wave=None``
        picks the schedule: ``max_wave`` throughout when N >= 2 *
        ``max_wave``, else a geometric ramp from INITIAL_WAVE.
        ``labels``: one label iterable (or None) per row, for an index
        with ``max_labels_per_vector`` > 0; each label's first row becomes
        its start node.  ``sbq_stats`` reuses a trained quantizer (no
        training pass; its tensors are moved to the device).
        ``refine_passes`` re-inserts every node against the finished graph
        that many times, each pass followed by a finalize.
        ``progress_callback(phase, done, total)`` is called after ingest,
        after every wave and around finalize (the refinement passes
        included).  ``build_stats`` (``stats.WriteStats``) counts the
        waves and finalize's re-pruned rows and times the inserts and
        finalize; the build logs its parameters and its end at INFO."""
        dev = resolve_device(device)
        host_input = not isinstance(vectors, torch.Tensor)
        if host_input:
            vectors = np.asarray(vectors, dtype=np.float32)
        else:
            vectors = vectors.to(dev, torch.float32)
        if vectors.ndim != 2:
            raise ValueError("vectors must be [N, D]")
        n, d = vectors.shape
        if config is None:
            config = IndexConfig(num_dimensions=d)
        if config.num_dimensions != d:
            raise ValueError(
                f"config.num_dimensions={config.num_dimensions} != data dim {d}"
            )
        if labels is not None and not config.has_labels:
            raise ValueError("labels passed but config.max_labels_per_vector == 0")
        label_arr = None
        if n > 0 and labels is not None:
            label_arr = make_label_array(list(labels), config.max_labels_per_vector)
            if label_arr.shape[0] != n:
                raise ValueError("labels must hold one entry per row")
        if external_ids is not None:
            external_ids = np.asarray(external_ids, dtype=np.int64)
            if external_ids.shape != (n,):
                raise ValueError("external_ids must be [N]")
        if initial_wave is None:
            initial_wave = max_wave if n >= 2 * max_wave else INITIAL_WAVE
        if sbq_stats is not None:
            sbq_stats = _stats_on(sbq_stats, dev)
        capacity = max(_round_up(n, 1024), 1024)
        # Build-parameter notice (build.rs:307-313).
        logger.info(
            "building index: %d vectors x %d dims, storage=%s, "
            "num_neighbors=%d, search_list_size=%d, max_alpha=%.2f, "
            "bits/dim=%d",
            n, d, config.storage_layout.name, config.num_neighbors,
            config.search_list_size, config.max_alpha,
            config.bits_per_dimension if config.uses_sbq else 0,
        )
        if n == 0:
            arrays = store.empty_arrays(config, capacity, dev)
            stats = (sbq_stats if sbq_stats is not None
                     else sbq.empty_stats(config.dims_to_index, dev))
            return cls(config, arrays, stats, external_ids)._built(WriteStats())
        with _full_f32():
            if host_input and n * d * 4 > INGEST_CHUNK_BYTES:
                arrays, stats = _ingest_chunked(vectors, config, capacity, sbq_stats, dev)
            else:
                arrays, stats = _ingest(_as_vectors(vectors, dev), config, capacity,
                                        sbq_stats)
            del vectors
            # Labels after whichever ingest ran.
            if label_arr is not None:
                arrays.node_labels[:n] = torch.from_numpy(label_arr).to(dev)
                arrays = _register_label_starts(
                    arrays, label_arr, np.arange(n, dtype=np.int32))
            index = cls(config, arrays, stats, external_ids)
            write_stats = WriteStats()
            index._ctx.stats = write_stats
            if progress_callback:
                progress_callback("training quantizer", n, n)
            t = time.perf_counter()
            arrays = index._insert_ids_into_graph(
                arrays, np.arange(n, dtype=np.int32),
                initial_wave=initial_wave, max_wave=max_wave,
                progress_callback=progress_callback,
            )
            write_stats.insert_s = time.perf_counter() - t
            if progress_callback:
                progress_callback("finalizing graph", 0, n)
            t = time.perf_counter()
            arrays = finalize(arrays, index._ctx)
            for _ in range(refine_passes):
                arrays = finalize(index._refine_pass(arrays), index._ctx)
            write_stats.finalize_s = time.perf_counter() - t
            index.arrays = arrays
            if progress_callback:
                progress_callback("finalizing graph", n, n)
        return index._built(write_stats)

    def _built(self, write_stats: WriteStats) -> "DiskannIndex":
        """Attach the build's stats (later adds keep counting waves into
        them) and log the build's end."""
        write_stats.num_nodes = self.count
        self._ctx.stats = write_stats
        self.build_stats = write_stats
        logger.info(
            "index build complete: %d vectors in %.1fs (%.1f vectors/s)",
            write_stats.num_nodes, write_stats.elapsed_s, write_stats.nodes_per_sec,
        )
        return self

    def _insert_ids_into_graph(
        self,
        arrays: GraphArrays,
        ids: np.ndarray,  # i32 ids of stored rows
        *,
        initial_wave: int = INITIAL_WAVE,
        max_wave: int = MAX_WAVE,
        full_graph: bool = False,
        progress_callback=None,
    ) -> GraphArrays:
        """``arrays`` with stored rows inserted into the graph in waves of
        doubling size, from ``initial_wave`` up to ``max_wave``.  Into an
        empty graph the first id becomes the default start node.
        Publishes nothing.

        ``full_graph``: the ids are scattered through the id space
        (tombstone reuse), so every row below ``count`` is a candidate,
        instead of the rows below each wave's first id."""
        ctx = self._ctx
        use_snap = self.config.build_traversal_uses_codes
        dev = arrays.device
        pos = 0
        if arrays.default_start == INVALID_ID and len(ids) > 0:
            arrays = arrays._replace(default_start=int(ids[0]))
            pos = 1
        remaining = np.ascontiguousarray(ids[pos:], dtype=np.int32)
        remaining_dev = torch.from_numpy(remaining).to(dev)
        done = 0
        bucket = initial_wave
        snap_adj = None
        waves_since_snap = 0
        while done < len(remaining):
            take = min(bucket, len(remaining) - done)
            first = int(remaining[done])
            wave = torch.full((bucket,), INVALID_ID, dtype=torch.int32, device=dev)
            wave[:take] = remaining_dev[done : done + take]
            prefix_est = arrays.count if full_graph else first
            if use_snap and prefix_est > BRUTE_CANDIDATE_THRESHOLD and (
                snap_adj is None or waves_since_snap >= BUILD_SNAPSHOT_REFRESH_WAVES
            ):
                # Traversal on codes reads a snapshot of the adjacency;
                # waves write the live rows.  It reads the live codes: codes
                # are written only at ingest, before any wave, so they equal
                # the codes of every snapshot.  Full-precision traversal
                # reads the live adjacency.
                snap_adj = arrays.adjacency.clone()
                waves_since_snap = 0
            if full_graph:
                arrays = insert_wave(
                    arrays, ctx, wave, prefix_rows=arrays.count,
                    snap_adjacency=snap_adj,
                )
            else:
                arrays = insert_wave(
                    arrays, ctx, wave, n_existing=first, n_real=take,
                    snap_adjacency=snap_adj,
                )
            waves_since_snap += 1
            done += take
            bucket = min(bucket * 2, max_wave)
            if progress_callback:
                progress_callback("inserting tuples", done + pos, len(ids))
        return arrays

    def _refine_pass(self, arrays: GraphArrays) -> GraphArrays:
        """One refinement sweep over ``arrays``: every node, in waves of
        MAX_WAVE ids, beam-searches the current graph and re-prunes with
        its current neighbours in contention.  Traversal on codes reads a
        snapshot taken at the first wave and refreshed every
        BUILD_SNAPSHOT_REFRESH_WAVES waves, whatever the row count.  The
        JAX package pads the last wave to MAX_WAVE ids to keep one
        compiled shape; padded rows write nothing and change no other
        row's result, so the port, which compiles nothing, does not pad.
        Publishes nothing."""
        ctx = self._ctx
        use_snap = self.config.build_traversal_uses_codes
        n = arrays.count
        dev = arrays.device
        snap_adj = None
        waves_since_snap = 0
        for off in range(0, n, MAX_WAVE):
            take = min(MAX_WAVE, n - off)
            ids = torch.arange(off, off + take, dtype=torch.int32, device=dev)
            if use_snap and (
                snap_adj is None or waves_since_snap >= BUILD_SNAPSHOT_REFRESH_WAVES
            ):
                snap_adj = arrays.adjacency.clone()
                waves_since_snap = 0
            arrays = insert_wave(
                arrays, ctx, ids, n_real=take, include_existing=True,
                snap_adjacency=snap_adj,
            )
            waves_since_snap += 1
        return arrays

    def add(self, vectors, *, labels=None, external_ids=None) -> np.ndarray:
        """Insert a batch of vectors [M, D]; returns their internal ids
        (i32, host).  The analog of aminsert: the quantizer is not
        retrained (an index built empty stays untrained), tombstoned rows
        are reused first, the store grows when needed, and the batch is
        inserted in one wave per MAX_WAVE rows, sized to the smallest power
        of two from 256 that fits.  Orphans are repaired afterwards.

        ``labels`` (labeled indexes): one label iterable or None per row
        (None everywhere when omitted).  Recycled rows first lose any label
        start entry that points at them; then each new label's first row
        becomes its start node.  Labels are validated before any work.

        Everything is built on new tensors and published at the end: the
        arrays, then the tombstone mirror and the external ids.  With a
        journal attached, the validated inputs are journaled before any
        device write (a failure after that leaves the record, as in the
        JAX package)."""
        host_vectors = (None if isinstance(vectors, torch.Tensor)
                        else np.asarray(vectors, dtype=np.float32))
        vectors = _as_vectors(vectors if host_vectors is None else host_vectors, self.device)
        if vectors.ndim != 2 or vectors.shape[1] != self.config.num_dimensions:
            raise ValueError("vectors must be [M, num_dimensions]")
        m = vectors.shape[0]
        if m == 0:
            return np.zeros((0,), dtype=np.int32)
        if labels is not None and not self.config.has_labels:
            raise ValueError("labels passed to an unlabeled index")
        label_arr = None
        if self.config.has_labels:
            label_arr = make_label_array(
                list(labels) if labels is not None else [None] * m,
                self.config.max_labels_per_vector,
            )
            if label_arr.shape[0] != m:
                raise ValueError("labels must hold one entry per row")
        if external_ids is None:
            base = int(self.external_ids.max()) + 1 if len(self.external_ids) else 0
            external_ids = np.arange(base, base + m, dtype=np.int64)
        else:
            external_ids = np.asarray(external_ids, dtype=np.int64)
            if external_ids.shape != (m,):
                raise ValueError("external_ids must be [M]")
        # Write-ahead (page.rs:113-124: every reference page write is
        # WAL-logged first); replaying the same inputs is deterministic.
        if self._journal is not None:
            self._journal.append_add(
                host_vectors if host_vectors is not None else vectors.cpu().numpy(),
                external_ids, label_arr,
            )

        arrays = self.arrays
        n0 = arrays.count
        free = np.nonzero(self._deleted_np[:n0])[0]
        n_reuse = int(min(len(free), m))
        reuse_rows = free[:n_reuse].astype(np.int32)
        fresh = m - n_reuse
        needed = n0 + fresh
        fresh_ids = np.arange(n0, needed, dtype=np.int32)
        with _full_f32():
            if needed > arrays.capacity:
                # New tensors: the add owns them.
                arrays = store.grow(
                    arrays, max(_round_up(needed, 1024), 2 * arrays.capacity)
                )
            else:
                arrays = _own(arrays)
            if n_reuse:
                arrays = _reuse_ingest(
                    arrays, self.sbq_stats, vectors[:n_reuse],
                    torch.from_numpy(reuse_rows).to(self.device), self.config,
                )
            if fresh:
                arrays = _add_ingest(
                    arrays, self.sbq_stats, vectors[n_reuse:], n0, self.config
                )
            if label_arr is not None:
                new_labels = torch.from_numpy(label_arr).to(self.device)
                if n_reuse:
                    arrays = _clear_label_starts(arrays, reuse_rows)
                    arrays.node_labels[torch.from_numpy(reuse_rows).to(self.device).long()] = (
                        new_labels[:n_reuse])
                    arrays = _register_label_starts(arrays, label_arr[:n_reuse], reuse_rows)
                if fresh:
                    arrays.node_labels[n0:needed] = new_labels[n_reuse:]
                    arrays = _register_label_starts(arrays, label_arr[n_reuse:], fresh_ids)
            add_bucket = INITIAL_WAVE
            while add_bucket < min(m, MAX_WAVE):
                add_bucket *= 2
            if n_reuse:
                arrays = self._insert_ids_into_graph(
                    arrays, reuse_rows, full_graph=True, initial_wave=add_bucket
                )
            if fresh:
                arrays = self._insert_ids_into_graph(
                    arrays, fresh_ids, initial_wave=add_bucket
                )
            arrays = repair_orphans(arrays)

        deleted_np = np.zeros(arrays.capacity, dtype=bool)
        deleted_np[: len(self._deleted_np)] = self._deleted_np
        deleted_np[reuse_rows] = False
        ext = np.concatenate([self.external_ids, external_ids[n_reuse:]])
        ext[reuse_rows] = external_ids[:n_reuse]
        # Publish: the arrays first, then the host mirrors (new objects, so
        # a reader's copies stay as they were).
        self.arrays = arrays
        self._deleted_np = deleted_np
        self.external_ids = ext
        self._after_durable_mutation(m)
        return np.concatenate([reuse_rows, fresh_ids])

    def delete(self, ids) -> None:
        """Tombstone rows (ambulkdelete): edges stay, searches traverse
        them but never return them, and ``add`` reuses them.  Publishes a
        new tombstone tensor, then a new host mirror."""
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        ids = np.asarray(ids, dtype=np.int32).reshape(-1)
        if len(ids) == 0:
            return
        if (ids < 0).any() or (ids >= self.count).any():
            raise ValueError("delete ids out of range")
        if self._journal is not None:  # write-ahead, as in add
            self._journal.append_delete(ids)
        arrays = self.arrays
        deleted = arrays.deleted.clone()
        deleted[torch.from_numpy(ids).to(self.device).long()] = True
        mirror = self._deleted_np.copy()
        mirror[ids] = True
        self.arrays = arrays._replace(deleted=deleted)
        self._deleted_np = mirror
        self._after_durable_mutation(len(ids))

    def delete_external(self, external_ids) -> None:
        """Tombstone the rows that carry any of ``external_ids``."""
        mask = np.isin(self.external_ids, np.asarray(external_ids, dtype=np.int64))
        self.delete(np.nonzero(mask)[0].astype(np.int32))

    def to_external(self, ids) -> np.ndarray:
        """Internal row ids (numpy or a tensor) -> external ids, int64;
        INVALID_ID -> -1."""
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        ids = np.asarray(ids)
        out = np.full(ids.shape, -1, dtype=np.int64)
        mask = ids >= 0
        out[mask] = self.external_ids[ids[mask]]
        return out

    def compact(self) -> "DiskannIndex":
        """A new index over the live rows, rebuilt on the same device; the
        external ids and label sets are kept.  bf16 and int8 rows are
        converted to float32 (int8: times their scale) and stored again on
        ingest (one more rounding at worst).  The live rows are a device
        tensor, so the rebuild never takes the chunked ingest."""
        live = np.nonzero(~self._deleted_np[: self.count])[0]
        live_dev = torch.from_numpy(live).to(self.device)
        vectors = store.dequant_rows(self.arrays.vectors, self.arrays.vec_scales,
                                     live_dev).float()
        labels = None
        if self.config.has_labels:
            labels = [[int(v) for v in row if v != LABEL_SENTINEL]
                      for row in self.arrays.node_labels[live_dev].cpu().numpy()]
        return DiskannIndex.build(
            vectors, self.config, labels=labels,
            external_ids=self.external_ids[live], device=self.device,
        )

    def save(self, path) -> None:
        """Write the JAX package's checkpoint format (version 3; bf16
        vectors as their uint16 bit view, int8 vectors with their scales)
        to ``path`` (``.npz`` appended when missing), atomically.  Saving
        to the durability path truncates the journal."""
        path = normalize_ckpt_path(path)
        arrays, external_ids = self.arrays, self.external_ids
        host = store.to_host(arrays)
        n = arrays.count
        atomic_write_npz(path, dict(
            magic=np.int64(CHECKPOINT_MAGIC),
            version=np.int64(CHECKPOINT_VERSION),
            config=np.frombuffer(
                json.dumps(self.config.to_dict()).encode(), dtype=np.uint8
            ),
            vectors=host.vectors[:n],
            vec_scales=host.vec_scales[:n],
            codes=host.codes[:n],
            adjacency=host.adjacency[:n],
            node_labels=host.node_labels[:n],
            deleted=host.deleted[:n],
            default_start=host.default_start,
            label_start_keys=host.label_start_keys,
            label_start_ids=host.label_start_ids,
            sbq_count=np.asarray(self.sbq_stats.count, dtype=np.int32),
            sbq_mean=self.sbq_stats.mean.cpu().numpy(),
            sbq_m2=self.sbq_stats.m2.cpu().numpy(),
            external_ids=external_ids,
        ))
        if self._journal is not None and path == self._dur_path:
            self._journal.truncate()
            self._dur_pending = 0

    @classmethod
    def load(cls, path, *, device=None) -> "DiskannIndex":
        """Read a checkpoint of either package (versions 1-3), labeled or
        not, f32, bf16 or int8 (a label table of any grown capacity is
        kept as saved), then replay the mutation journal beside it, if
        any, written by either package (crash recovery, the WAL-redo
        analog): each record goes through ``add``/``delete``.  The loaded
        index has no journal attached."""
        dev = resolve_device(device)
        path = normalize_ckpt_path(path)
        with np.load(path) as z:
            if int(z["magic"]) != CHECKPOINT_MAGIC:
                raise ValueError("not a pgvectorscale_tpu checkpoint")
            if "sharded" in z and int(z["sharded"]) == 1:
                raise ValueError("sharded checkpoint; use ShardedDiskannIndex.load")
            version = int(z["version"])
            if version > CHECKPOINT_VERSION:
                raise ValueError(
                    f"checkpoint version {version} is newer than supported "
                    f"{CHECKPOINT_VERSION}"
                )
            z = _migrate_checkpoint({k: z[k] for k in z.files}, version)
        config = IndexConfig.from_dict(json.loads(bytes(z["config"]).decode()))
        vectors = store.vectors_from_host(z["vectors"], config.vector_dtype)
        n = vectors.shape[0]
        arrays = store.empty_arrays(config, max(_round_up(n, 1024), 1024), dev)

        def put(dst: torch.Tensor, src) -> None:
            if not isinstance(src, torch.Tensor):
                src = torch.from_numpy(np.ascontiguousarray(src))
            dst[:n] = src.to(dev)

        put(arrays.vectors, vectors)
        put(arrays.codes, z["codes"].astype(np.uint32).view(np.int32))
        put(arrays.adjacency, z["adjacency"].astype(np.int32))
        put(arrays.node_labels, z["node_labels"].astype(np.int32))
        put(arrays.deleted, z["deleted"].astype(bool))
        put(arrays.vec_scales, z["vec_scales"].astype(np.float32))
        arrays = _with_label_table(
            arrays._replace(count=n, default_start=int(z["default_start"])),
            z["label_start_keys"].astype(np.int32), z["label_start_ids"].astype(np.int32),
        )
        stats = sbq.SbqStats(
            count=int(z["sbq_count"]),
            mean=torch.from_numpy(z["sbq_mean"].astype(np.float32)).to(dev),
            m2=torch.from_numpy(z["sbq_m2"].astype(np.float32)).to(dev),
        )
        index = cls(config, arrays, stats, z["external_ids"])
        if os.path.isdir(path + ".journal"):
            for rec in MutationJournal(path).records():
                op = bytes(rec["op"]).decode()
                if op == "add":
                    labels = None
                    if "labels" in rec:
                        labels = [[int(v) for v in row if v != LABEL_SENTINEL]
                                  for row in rec["labels"]]
                    index.add(rec["vectors"], labels=labels,
                              external_ids=rec["external_ids"])
                elif op == "delete":
                    index.delete(rec["ids"])
                else:
                    raise ValueError(f"unknown journal op {op!r}")
        return index

    def _needs_rescore(self, params: QueryParams) -> bool:
        """SBQ rescores whenever rescore > 0; plain storage only when the
        index truncates the dimensions (its traversal distances are exact
        otherwise)."""
        if params.rescore == 0:
            return False
        if self.config.uses_sbq:
            return True
        return self.config.dims_to_index < self.config.num_dimensions

    def search(
        self,
        queries,
        k: int,
        params: Optional[QueryParams] = None,
        *,
        query_labels=None,
        max_label_width: Optional[int] = None,
        device=None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched top-k: queries [Q, D] -> (ids i32[Q, k], dists f32[Q, k])
        on the index's device.  Missing results are INVALID_ID / +inf.
        ``query_labels``: one label iterable (or None) per query; a result
        must carry at least one of its query's labels (``labels && $1``),
        and the search also starts from each label's start node.  Label
        rows are ``max_label_width`` wide (default: the index's
        ``max_labels_per_vector``).  ``device`` must name the device the
        index lives on."""
        dev = resolve_device(device)
        if dev.type != self.device.type or (
            dev.index is not None and dev.index != self.device.index
        ):
            raise ValueError(f"the index lives on {self.device}, not {dev}")
        arrays = self.arrays  # one snapshot for the whole search
        params = params or QueryParams()
        config = self.config
        if isinstance(queries, torch.Tensor):
            queries = queries.to(self.device, torch.float32)
        else:
            queries = torch.as_tensor(
                np.atleast_2d(np.asarray(queries, dtype=np.float32))
            ).to(self.device)
        if queries.shape[1] != config.num_dimensions:
            raise ValueError(
                f"query dimension {queries.shape[1]} != index dimension "
                f"{config.num_dimensions}"
            )
        ql = None
        if query_labels is not None:
            width = max_label_width or config.max_labels_per_vector
            ql = torch.from_numpy(make_label_array(list(query_labels), width)).to(
                self.device)
            if ql.shape[0] != queries.shape[0]:
                raise ValueError("query_labels must hold one entry per query")
        l = max(params.search_list_size, k)
        use_exact = self._needs_rescore(params)
        beam_width, expand_window_m, window_n = _window_plan(
            config, params, k, l, use_exact, arrays.max_degree)
        with _full_f32():
            ids, dists, res = _search(
                arrays, self.sbq_stats, queries,
                config=config, k=k, search_list_size=beam_width,
                max_iters=_query_max_iters(
                    l, params.effective_visit_factor(self.num_live)
                ),
                rescore_n=params.rescore, use_exact=use_exact,
                expand_factor=min(params.expand, l),
                expand_window_m=expand_window_m,
                window_n=window_n,
                query_labels=ql,
            )
        self.last_search = res
        self._last_search_l = l
        if logger.isEnabledFor(logging.DEBUG):
            # Opt-in per-query stats dump (amendscan debug1, scan.rs:439-476).
            logger.debug("query stats: %s", self.last_search_stats)
        return ids, dists

    def estimate_query_cost(self, params: Optional[QueryParams] = None) -> dict:
        """Per-query cost estimate (amcostestimate analog,
        cost_estimate.rs:6-50).  After a search on this index: the last
        batch's mean visits and comparisons, scaled by the requested
        search list size over the measured one ("measured").  On a cold
        index: about 1.2 visits a beam slot, R comparisons a visit
        ("model")."""
        params = params or QueryParams()
        l = params.search_list_size
        stats = self.last_search_stats
        if stats is not None and stats.num_queries > 0 and stats.total_visits:
            scale = l / max(self._last_search_l, 1)
            expected_visits = int(stats.total_visits / stats.num_queries * scale)
            expected_comps = int(
                stats.total_distance_comparisons / stats.num_queries * scale)
            basis = "measured"
        else:
            expected_visits = min(int(1.2 * l), max(self.num_live, 1))
            expected_comps = expected_visits * self.config.num_neighbors
            basis = "model"
        return {
            "expected_node_visits": expected_visits,
            "expected_distance_comparisons": expected_comps,
            "expected_full_precision_comparisons": params.rescore
            + (0 if params.rescore == 0 else 10),
            "estimated_rows": max(self.num_live // 100, 1),
            "basis": basis,
        }

    def search_iter(self, query, params: Optional[QueryParams] = None, *,
                    query_labels: Optional[Iterable[int]] = None,
                    device=None) -> "SearchIterator":
        """Streaming relaxed-order search for one query (the
        TSVResponseIterator analog): ``SearchIterator`` yields (row id,
        distance) until the graph is exhausted, so the whole table can be
        scanned through the index even with a small search list.
        ``query_labels``: one label iterable (the filtered fallback).
        ``device`` must name the device the index lives on."""
        dev = resolve_device(device)
        if dev.type != self.device.type or (
            dev.index is not None and dev.index != self.device.index
        ):
            raise ValueError(f"the index lives on {self.device}, not {dev}")
        return SearchIterator(self, query, params or QueryParams(), query_labels)

    def exact_distances_for(self, qv: torch.Tensor, ids) -> np.ndarray:
        """Full-precision distances from a preprocessed query f32[D] to rows
        ``ids`` (host), as a host array: the iterator's rescore hook."""
        ids_t = torch.from_numpy(np.asarray(ids, dtype=np.int32)).to(self.device)
        with _full_f32():
            d = _exact_distances(self.arrays, qv.to(self.device), ids_t,
                                 self.config.distance_type)
        return d.cpu().numpy()


class SearchIterator:
    """Streaming relaxed-order result iterator (TSVResponseIterator,
    scan.rs:210-305): traversal candidates in approximate order feed a
    min-heap of ``rescore`` exact distances; each ``next()`` refills the
    heap, then pops its minimum.

    Unfiltered, the traversal resumes on the device across refills
    (``graph/iterate.py``): each node is expanded at most once over the
    iterator's life, so a full-table scan is O(N) visits.  It scans the
    arrays the index held at construction (rows added later are not
    streamed); rows deleted later are filtered through the index's host
    tombstone mirror.  Each refill's window is rescored in one batch; the
    window grows geometrically (up to 4,096) while refills come back full,
    and a starved frontier restarts from ``first_unseen``.  A
    label-filtered iterator, and an iterator over an index without flat
    ``arrays`` (``ShardedDiskannIndex``: global slot ids), re-run the
    index's ``search`` with a doubled L per refill instead.  Streaming
    statistics (Welford, over the increments of the largest distance
    seen, StreamingStats in scan.rs:119-160) are kept as the JAX package
    keeps them."""

    def __init__(self, index: DiskannIndex, query, params: QueryParams,
                 query_labels: Optional[Iterable[int]] = None):
        self.index = index
        self.params = params
        self.query = np.asarray(query, dtype=np.float32).reshape(1, -1)
        self.query_labels = [list(query_labels)] if query_labels is not None else None
        self._returned: set[int] = set()
        # Everything handed out of a refill: returned, buffered or pending.
        self._seen: set[int] = set()
        self._exhausted = False
        self._l = max(params.search_list_size, 2)
        self._pending: list[tuple[int, float]] = []  # (id, dist), approximate order
        self._buffer: list[tuple[float, int]] = []  # exact-distance min-heap
        self._use_exact = index._needs_rescore(params)
        self._qv = None
        self._it_state = None
        self._it_qv = None
        self._it_qc = None
        # The scan's snapshot; None for an index without flat arrays
        # (ShardedDiskannIndex), which takes the restart fallback.
        self._arrays = getattr(index, "arrays", None)
        self._emit_n = _round_up(max(self._l, 64), 64)
        self.stats_count = 0
        self.stats_mean = 0.0
        self.stats_m2 = 0.0
        self.max_distance = 0.0
        self._refill_pending()

    def _update_streaming_stats(self, distance: float) -> None:
        diff = distance - self.max_distance
        self.max_distance = max(self.max_distance, distance)
        if diff == 0.0:
            return
        self.stats_count += 1
        delta = diff - self.stats_mean
        self.stats_mean += delta / self.stats_count
        self.stats_m2 += delta * (diff - self.stats_mean)

    @property
    def stats_variance(self) -> float:
        if self.stats_count < 2:
            return 0.0
        return self.stats_m2 / (self.stats_count - 1)

    def _query_vec(self) -> torch.Tensor:
        """The preprocessed full-width query f32[D], on the index's device."""
        if self._qv is None:
            q = torch.from_numpy(self.query).to(self.index.device)
            self._qv = preprocess_query(q, self.index.config.distance_type)[0]
        return self._qv

    def _refill_pending(self) -> None:
        with _full_f32():
            if self.query_labels is not None or self._arrays is None:
                self._refill_restart()
            else:
                self._refill_resume()

    def _refill_resume(self) -> None:
        from .graph import iterate

        index = self.index
        config = index.config
        kw = dict(distance_type=config.distance_type, use_codes=config.uses_sbq)
        if self._it_state is None:
            qv = self._query_vec()
            self._it_qv = qv[: config.dims_to_index]
            if config.uses_sbq:
                self._it_qc = sbq.encode(self._it_qv[None, :], index.sbq_stats,
                                         config.bits_per_dimension)[0]
            else:
                self._it_qc = torch.zeros((0,), dtype=torch.int32, device=qv.device)
            start = get_start_ids(self._arrays, 1)[0]
            self._it_state = iterate.init_state(
                self._arrays, self._it_qv, self._it_qc, start,
                frontier=_round_up(max(2 * self._l, 64), 64), **kw,
            )
        while not self._pending and not self._exhausted:
            self._it_state, eids, edists = iterate.iter_step(
                self._it_state, self._arrays, self._it_qv, self._it_qc,
                emit_n=self._emit_n, visit_budget=4 * self._emit_n, **kw,
            )
            eids = eids.cpu().numpy()
            edists = edists.cpu().numpy()
            # Deleted rows are traversed but never returned (scan.rs:231).
            deleted = index._deleted_np
            fresh = [(int(i), float(d)) for i, d in zip(eids, edists)
                     if i >= 0 and not deleted[i]]
            if fresh and self._use_exact:
                fresh = self._rescore_batch(fresh, snapshot=True)
            self._pending = fresh
            self._seen.update(i for i, _ in fresh)
            if len(fresh) == self._emit_n:
                # A deep scan: grow the window geometrically.
                self._emit_n = min(2 * self._emit_n, 4096)
            if not fresh:
                # A starved frontier with live rows unexpanded restarts from
                # the lowest-id one.
                nid = iterate.first_unseen(self._it_state, self._arrays)
                if nid == INVALID_ID:
                    self._exhausted = True
                else:
                    self._it_state = iterate.reseed(
                        self._it_state, self._arrays, self._it_qv, self._it_qc, nid, **kw)

    def _refill_restart(self) -> None:
        """Fallback of a label-filtered iterator and of a sharded index:
        re-run the search with a doubled L until it yields rows not seen
        yet."""
        index = self.index
        n_live = index.num_live
        # A sharded index's search runs on its mesh; it takes no device.
        kw = {"device": index.device} if self._arrays is not None else {}
        while not self._pending and not self._exhausted:
            k = self._l
            ids, dists = index.search(
                self.query, k, QueryParams(search_list_size=self._l, rescore=0),
                query_labels=self.query_labels, **kw,
            )
            fresh = [(int(i), float(d)) for i, d in zip(ids[0].cpu().numpy(),
                                                        dists[0].cpu().numpy())
                     if i != INVALID_ID and int(i) not in self._seen]
            if fresh and self._use_exact:
                fresh = self._rescore_batch(fresh)
            self._pending = fresh
            self._seen.update(i for i, _ in fresh)
            got_all = len(self._seen) >= n_live
            if not fresh:
                if self._l >= 4 * max(n_live, 1):
                    self._exhausted = True
                self._l *= 2
            elif not got_all:
                self._l *= 2  # pre-grow so the next refill reaches deeper

    def _rescore_batch(self, pending: list[tuple[int, float]],
                       snapshot: bool = False) -> list[tuple[int, float]]:
        """Exact distances for a whole refill in one batch: against the
        scan's snapshot on the resume path, through the index's hook on
        the filtered fallback."""
        qv = self._query_vec()
        ids_np = np.asarray([i for i, _ in pending], dtype=np.int32)
        if snapshot:
            ids_t = torch.from_numpy(ids_np).to(qv.device)
            d = _exact_distances(self._arrays, qv, ids_t,
                                 self.index.config.distance_type).cpu().numpy()
        else:
            d = self.index.exact_distances_for(qv, ids_np)
        return [(int(i), float(x)) for i, x in zip(ids_np, d)]

    def __iter__(self):
        return self

    def __next__(self) -> tuple[int, float]:
        # Fill the rescore buffer (resort_size, scan.rs:244-305).
        target = max(self.params.rescore, 1)
        while len(self._buffer) < target:
            if not self._pending:
                self._refill_pending()
                if not self._pending:
                    break
            nid, exact = self._pending.pop(0)
            if nid in self._returned:
                continue
            if len(self._buffer) > 1:
                self._update_streaming_stats(exact)
            heapq.heappush(self._buffer, (exact, nid))
        if not self._buffer:
            raise StopIteration
        d, nid = heapq.heappop(self._buffer)
        self._returned.add(nid)
        return nid, d

    @property
    def total_visits(self) -> int:
        """Nodes expanded over all refills of the resume path (-1 on the
        filtered fallback); at most N however deep the scan.  One device
        read."""
        if self._it_state is None:
            return -1
        return int(self._it_state.n_visits)

    def next_batch(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        ids, dists = [], []
        for _ in range(n):
            try:
                i, d = next(self)
            except StopIteration:
                break
            ids.append(i)
            dists.append(d)
        return np.asarray(ids, dtype=np.int32), np.asarray(dists, dtype=np.float32)


def from_jax_state(host_arrays, sbq_stats, config, *, external_ids=None,
                   device=None) -> DiskannIndex:
    """A port index over the JAX package's index state: its
    ``store.to_host`` arrays (labels and label table included), its SBQ
    statistics (count, mean, m2), its config and its external ids
    (default: the row ids).  Codes arrive as uint32 and are carried as
    their int32 bit view; bf16 vectors arrive as ml_dtypes bfloat16 and
    are carried through their uint16 view, bit for bit."""
    dev = resolve_device(device)
    if not isinstance(config, IndexConfig):
        config = IndexConfig.from_dict(config.to_dict())
    arrays = store.from_host(host_arrays, dev, config.vector_dtype)
    return DiskannIndex(config, arrays, _stats_on(sbq_stats, dev), external_ids)
