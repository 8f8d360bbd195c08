"""Row-sharded multi-device index (PyTorch port of ``parallel/sharded.py``).

The capacity-scaling configuration for corpora larger than one device's
memory.  As in the JAX package:

- Rows are partitioned round-robin over P shards, one a mesh position;
  each shard holds an independent Vamana graph over its rows, and every
  shard has the same capacity.
- The SBQ quantizer is trained once, globally, and shared by the shards
  (the reference trains it before its parallel workers launch,
  build.rs:574-614).
- A query searches every shard, each on its own device, and the shards'
  top-k lists merge into one: global slot ids are ``shard * capacity +
  local id`` (int32), laid out shard-major, stable-sorted by distance.
- Inserts route round-robin to the shards, reusing tombstoned rows first;
  deletes tombstone in the owning shard.

The JAX package stacks the shards' tensors along a leading axis and
``vmap``s one program over it.  The port keeps one ``GraphArrays`` a shard,
each on its position's device (``shards``), and runs the shards one after
another (``mesh.run_on_positions``; cards work at once in a world of
processes); every shard's result equals the JAX shard's.
``_stacked_host()`` gives the JAX package's stacked ``[P, ...]`` layout
as numpy (the checkpoint's).  Search statistics sum visits and
comparisons over the shards and take the largest iteration count.

In a world of several processes (``multihost.global_mesh``) each process
builds and searches only its own positions' shards; a search
all-gathers the shards' ``[Q, k]`` ids and distances, and every process
merges them alike.  Its statistics then cover the local shards.
``add``, ``delete``, ``delete_external``, ``compact``, ``save``, ``load``
and exact distances of remote rows need every shard in one process and
raise ``NotImplementedError`` there.

``enable_durability`` (``durability.DurableIndexMixin``) journals every
mutation; ``load`` replays the journal.  Checkpoints and journals are the
JAX package's: either package loads the other's.
"""

from __future__ import annotations

import json
import os
import time
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from .. import store
from ..config import CHECKPOINT_MAGIC, CHECKPOINT_VERSION, IndexConfig, QueryParams
from ..distance import preprocess_query, row_distances
from ..durability import DurableIndexMixin, MutationJournal, atomic_write_npz, normalize_ckpt_path
from ..graph.build import (
    BRUTE_CANDIDATE_THRESHOLD,
    BuildContext,
    _build_max_iters,
    _dedup_candidates,
    _wave_step,
    prune_over_degree,
    repair_orphans_device,
)
from ..graph.prune import alpha_schedule
from ..graph.search import _stable_sort_by, beam_search, get_start_ids
from ..index import (
    DiskannIndex,
    _add_ingest,
    _as_vectors,
    _clear_label_starts,
    _expand_rescore_window,
    _full_f32,
    _own,
    _query_max_iters,
    _register_label_starts,
    _reuse_ingest,
    _round_up,
    _stats_on,
    _window_plan,
    resolve_device,
)
from ..labels import LABEL_SENTINEL, make_label_array, overlaps
from ..ops import sbq
from ..stats import GreedySearchStats, WriteStats
from ..store import INVALID_ID, GraphArrays
from .mesh import Mesh, run_on_positions
from .multihost import world


def _wave_statics(config: IndexConfig) -> dict:
    """The build's wave settings, as the JAX package's sharded waves take
    them."""
    return dict(
        search_list_size=config.search_list_size,
        max_iters=_build_max_iters(config.search_list_size),
        use_codes=config.build_traversal_uses_codes,
        prune_use_codes=config.build_prune_uses_codes,
        code_bits=config.dims_to_index * config.bits_per_dimension,
        distance_type=config.distance_type,
        alphas=tuple(alpha_schedule(config.max_alpha)),
        num_neighbors=config.num_neighbors,
        trunc_dims=config.dims_to_index,
    )


def _shard_wave(arrays: GraphArrays, ids: torch.Tensor, prefix: int, *, brute: bool,
                slice_rows: int, statics: dict) -> GraphArrays:
    """One wave of one shard over its live adjacency (the JAX sharded wave
    rebuilds its traversal codes from the live adjacency each wave)."""
    snap = None if brute or not statics["use_codes"] else arrays.adjacency
    return _wave_step(arrays, ids, prefix, snap, brute=brute, slice_rows=slice_rows,
                      **statics)


def _finalize_shard(arrays: GraphArrays, config: IndexConfig) -> GraphArrays:
    """The sharded finalize: re-prune the over-degree rows, then the device
    orphan repair (the JAX package's sharded build has no host fallback)."""
    return repair_orphans_device(prune_over_degree(arrays, BuildContext(config)))


def _search_shard(
    arrays: GraphArrays,
    qv: torch.Tensor,  # f32[Q, D] preprocessed, full width (rescore)
    q_indexed: torch.Tensor,  # f32[Q, Dt] (traversal)
    qc: torch.Tensor,  # i32[Q, W]
    ql: Optional[torch.Tensor],  # i32[Q, Lq] when filtered
    *,
    config: IndexConfig,
    k: int,
    search_list_size: int,
    max_iters: int,
    expand_factor: int,
    rescore_n: int,
    use_exact: bool,
    expand_window_m: int,
    window_n: int,
):
    """One shard's part of a search: start nodes, beam search, the
    "scored" window's dedup or the "expand" window, tombstone and label
    mask, stable sort, exact rescore of the best rescore + k (rows in
    float32, int8 rows times their scale), top-k.  Returns (local ids
    i32[Q, k], dists f32[Q, k], visits i32[Q], comparisons i32[Q],
    iterations)."""
    q = qv.shape[0]
    res = beam_search(
        arrays, qc, get_start_ids(arrays, q, ql),
        search_list_size=search_list_size, max_iters=max_iters,
        expand_factor=expand_factor, track_hist=False, query_vecs=q_indexed,
        use_codes=config.uses_sbq, distance_type=config.distance_type,
        window_n=window_n, query_labels=ql,
    )
    cand_ids, cand_dists = res.beam_ids, res.beam_dists
    if window_n > 0:
        cand_ids, cand_dists = _dedup_candidates(res.window_ids, res.window_dists)
    if expand_window_m > 0:
        cand_ids, cand_dists = _expand_rescore_window(
            arrays, qc, cand_ids, cand_dists, expand_m=expand_window_m)
    safe = cand_ids.clamp_min(0).long()
    live = (cand_ids != INVALID_ID) & ~arrays.deleted[safe]
    if ql is not None and ql.shape[-1] > 0:
        live = live & overlaps(arrays.node_labels[safe], ql[:, None, :])
    d = torch.where(live, cand_dists, torch.inf)
    ids = torch.where(live, cand_ids, INVALID_ID)
    d, ids = _stable_sort_by(d, ids)
    m = min(rescore_n + k, ids.shape[1]) if use_exact else k
    top_ids, top_d = ids[:, :m], d[:, :m]
    if use_exact:
        exact = row_distances(arrays.vectors, qv, top_ids, config.distance_type,
                              arrays.vec_scales)
        exact = torch.where(top_ids == INVALID_ID, torch.inf, exact)
        exact = torch.where(top_d == torch.inf, torch.inf, exact)
        top_d, top_ids = _stable_sort_by(exact, top_ids)
    return top_ids[:, :k], top_d[:, :k], res.n_visited, res.n_dist_comps, res.iters


class ShardedDiskannIndex(DurableIndexMixin):
    """A DiskANN index row-sharded over a device mesh.  ``shards[p]`` is
    position p's ``GraphArrays`` (None where another process holds it)."""

    def __init__(
        self,
        config: IndexConfig,
        mesh: Mesh,
        shards: Sequence[Optional[GraphArrays]],
        sbq_stats: sbq.SbqStats,
        external_ids: list[np.ndarray],  # per shard
    ):
        self.config = config
        self.mesh = mesh
        self.shards = list(shards)
        self.sbq_stats = sbq_stats
        self.external_ids = list(external_ids)
        self._next_shard = 0
        self._devices = list(mesh.devices.ravel())
        self._local = mesh.local_positions()
        if len(self.shards) != mesh.size:
            raise ValueError(f"{len(self.shards)} shards for a mesh of {mesh.size} positions")
        if not self._local:
            raise ValueError("this process owns no position of the mesh")
        n_local = np.bincount(mesh.ranks.ravel())
        if n_local.min() != n_local.max():
            raise ValueError("every process must own the same number of positions")
        # Host mirrors of the shards' counts and tombstones: counts, the
        # live count and the add free list read them without a device
        # read.  build() and load() set them.
        self._counts_np = np.zeros(self.num_shards, dtype=np.int64)
        self._deleted_np = np.zeros((self.num_shards, self.shard_capacity), dtype=bool)
        self.build_stats = None  # stats.WriteStats after build()
        # The last search's (visits[Q], comparisons[Q], iterations), summed
        # over the shards, read back only when last_search_stats is read.
        self._last_search_res = None
        self._last_search_l = 0

    # ------------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        """The first local position's device: queries are encoded and
        results merged there."""
        return self._devices[self._local[0]]

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def shard_capacity(self) -> int:
        return self.shards[self._local[0]].capacity

    @property
    def count(self) -> int:
        """Slots used over all shards, tombstoned rows included."""
        return int(self._counts_np.sum())

    @property
    def num_deleted(self) -> int:
        return int(self._deleted_np.sum())

    @property
    def num_live(self) -> int:
        return self.count - self.num_deleted

    @property
    def last_search_stats(self) -> Optional[GreedySearchStats]:
        """Stats of the latest search: visits and comparisons summed over
        the shards, the largest shard's iteration count."""
        if self._last_search_res is None:
            return None
        visits, comps, iters = self._last_search_res
        return GreedySearchStats(
            num_queries=int(visits.shape[0]),
            total_visits=int(visits.sum()),
            total_distance_comparisons=int(comps.sum()),
            iterations=int(iters),
        )

    def estimate_query_cost(self, params: Optional[QueryParams] = None) -> dict:
        """Per-query cost over the whole mesh (amcostestimate analog): the
        last search's means scaled by the requested L over the measured L
        ("measured"), or on a cold index every shard's full-L beam over
        its share of the live rows ("model").  Every shard rescores its
        own rescore + k window, so full-precision work is shard-summed."""
        params = params or QueryParams()
        l = params.search_list_size
        shards = self.num_shards
        stats = self.last_search_stats
        if stats is not None and stats.num_queries > 0 and stats.total_visits:
            scale = l / max(self._last_search_l, 1)
            expected_visits = int(stats.total_visits / stats.num_queries * scale)
            expected_comps = int(stats.total_distance_comparisons / stats.num_queries * scale)
            basis = "measured"
        else:
            rows_per_shard = max(-(-max(self.num_live, 1) // shards), 1)
            expected_visits = min(int(1.2 * l), rows_per_shard) * shards
            expected_comps = expected_visits * self.config.num_neighbors
            basis = "model"
        return {
            "expected_node_visits": expected_visits,
            "expected_distance_comparisons": expected_comps,
            "expected_full_precision_comparisons": (
                params.rescore + (0 if params.rescore == 0 else 10)) * shards,
            "estimated_rows": max(self.num_live // 100, 1),
            "basis": basis,
        }

    _needs_rescore = DiskannIndex._needs_rescore

    def _require_one_process(self, what: str) -> None:
        if len(self._local) != self.num_shards:
            raise NotImplementedError(
                f"{what} needs every shard in one process; this index spans "
                f"{int(self.mesh.ranks.max()) + 1} processes")

    def _on_local(self, fn) -> dict:
        """``{p: fn(p)}`` over this process's positions."""
        return run_on_positions(self._devices, fn, self._local)

    def _stacked_host(self) -> store.HostArrays:
        """Every shard's store in the JAX package's stacked layout: each
        leaf [P, ...] as numpy (codes uint32, bf16 rows as their uint16
        view, count and default_start [P])."""
        self._require_one_process("a stacked host copy")
        hosts = [store.to_host(a) for a in self.shards]
        return store.HostArrays(*(np.stack(leaves) for leaves in zip(*hosts)))

    # ------------------------------------------------------------------

    @classmethod
    def build(
        cls,
        vectors,
        config: IndexConfig,
        mesh: Mesh,
        *,
        labels: Optional[Sequence[Optional[Iterable[int]]]] = None,
        external_ids: Optional[np.ndarray] = None,
        initial_wave: int = 256,
        max_wave: int = 4096,
    ) -> "ShardedDiskannIndex":
        """Build over ``vectors`` [N, D] (numpy, or a tensor on any device).

        The quantizer is trained once over all rows, on the first local
        position's device.  Row i goes to shard i % P; every shard gets
        the capacity ``_round_up(max rows a shard, 1024)``, ingests its
        rows (the whole input as float32 at once, no chunked ingest) and
        registers its label start nodes.  Then every shard runs the same
        wave schedule (one wave of ``initial_wave`` rows, doubling to
        ``max_wave``; seeded by brute force while the wave starts at or
        below BRUTE_CANDIDATE_THRESHOLD, over the first ``threshold +
        wave`` rows), and finalizes (over-degree prune, device orphan
        repair).  Each shard's graph equals a single-device build of its
        rows with the same schedule and quantizer.  ``build_stats``
        counts the waves and times the waves and the finalize."""
        devices = list(mesh.devices.ravel())
        local = mesh.local_positions()
        for d in {str(devices[s]) for s in local}:
            resolve_device(d)
        dev0 = devices[local[0]]
        on_device = isinstance(vectors, torch.Tensor)
        if not on_device:
            vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != config.num_dimensions:
            raise ValueError("vectors must be [N, num_dimensions]")
        n = vectors.shape[0]
        p = mesh.size
        external_ids = (np.arange(n, dtype=np.int64) if external_ids is None
                        else np.asarray(external_ids, dtype=np.int64))
        if external_ids.shape != (n,):
            raise ValueError("external_ids must be [N]")
        if labels is not None and not config.has_labels:
            raise ValueError("labels passed but config.max_labels_per_vector == 0")
        labels_list = list(labels) if labels is not None else None
        rows_per_shard = [np.arange(s, n, p) for s in range(p)]
        real = np.asarray([len(r) for r in rows_per_shard], dtype=np.int64)
        n_s_max = int(real.max()) if n else 0
        capacity = max(_round_up(max(n_s_max, 1), 1024), 1024)
        ext = [external_ids[r] for r in rows_per_shard]
        label_arrs = None
        if config.has_labels:
            label_arrs = [
                make_label_array([labels_list[r] for r in rows] if labels_list is not None
                                 else [None] * len(rows), config.max_labels_per_vector)
                for rows in rows_per_shard]

        write_stats = WriteStats(num_nodes=n)
        with _full_f32():
            stats = sbq.empty_stats(config.dims_to_index, dev0)
            if config.uses_sbq and n > 0:
                dev = preprocess_query(_as_vectors(vectors, dev0), config.distance_type)
                stats = sbq.train(dev[:, : config.dims_to_index])
                del dev

            def ingest(s):
                dev = devices[s]
                arrays = store.empty_arrays(config, capacity, dev)
                if real[s] == 0:
                    return arrays
                if on_device:
                    part = vectors[s::p].to(dev, torch.float32)
                else:
                    part = torch.from_numpy(np.ascontiguousarray(vectors[s::p])).to(dev)
                arrays = _add_ingest(arrays, _stats_on(stats, dev), part, 0, config)
                arrays = arrays._replace(default_start=0)
                if label_arrs is not None:
                    arrays.node_labels[: real[s]] = torch.from_numpy(label_arrs[s]).to(dev)
                    arrays = _register_label_starts(
                        arrays, label_arrs[s], np.arange(real[s], dtype=np.int32), grow=False)
                return arrays

            shards = [None] * p
            shards_local = run_on_positions(devices, ingest, local)
            for s, a in shards_local.items():
                shards[s] = a
            index = cls(config, mesh, shards, stats, ext)
            index._counts_np = real.copy()
            if n == 0:
                index.build_stats = write_stats
                return index

            # The wave schedule, the same for every shard: (first local id,
            # rows taken, padded wave width).
            schedule = []
            done, bucket = 0, initial_wave
            while done < n_s_max - 1:  # local id 0 is the start node
                take = min(bucket, n_s_max - 1 - done)
                schedule.append((1 + done, take, bucket))
                done += take
                bucket = min(bucket * 2, max_wave)
            statics = _wave_statics(config)

            def insert(s):
                arrays = shards[s]
                for start_id, take, width in schedule:
                    n_real = int(np.clip(real[s] - start_id, 0, take))
                    if n_real == 0:
                        continue  # an all-padding wave writes nothing
                    ids = torch.arange(start_id, start_id + n_real, dtype=torch.int32,
                                       device=arrays.device)
                    arrays = _shard_wave(
                        arrays, ids, start_id + n_real,
                        brute=start_id <= BRUTE_CANDIDATE_THRESHOLD,
                        slice_rows=min(BRUTE_CANDIDATE_THRESHOLD + width, capacity),
                        statics=statics)
                return arrays

            t = time.perf_counter()
            shards_local = run_on_positions(devices, insert, local)
            write_stats.num_waves = len(schedule)
            write_stats.insert_s = time.perf_counter() - t
            t = time.perf_counter()
            shards_local = run_on_positions(
                devices, lambda s: _finalize_shard(shards_local[s], config), local)
            write_stats.finalize_s = time.perf_counter() - t
        for s, a in shards_local.items():
            shards[s] = a
        index.shards = shards
        index.build_stats = write_stats
        return index

    # ------------------------------------------------------------------

    def search(
        self,
        queries,
        k: int,
        params: Optional[QueryParams] = None,
        *,
        query_labels: Optional[Sequence[Optional[Iterable[int]]]] = None,
        max_label_width: Optional[int] = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched top-k over every shard: queries [Q, D] -> (global slot
        ids i32[Q, k], dists f32[Q, k]) on ``device``; ``to_external``
        maps the ids.  The windows, the label filter and the visit budget
        follow ``DiskannIndex.search``; the budget is keyed to one shard's
        share of the live rows."""
        params = params or QueryParams()
        config = self.config
        dev0 = self.device
        if isinstance(queries, torch.Tensor):
            queries = queries.to(dev0, torch.float32)
        else:
            queries = torch.as_tensor(
                np.atleast_2d(np.asarray(queries, dtype=np.float32))).to(dev0)
        if queries.shape[1] != config.num_dimensions:
            raise ValueError(
                f"query dimension {queries.shape[1]} != index dimension "
                f"{config.num_dimensions}")
        q = queries.shape[0]
        filtered = query_labels is not None
        ql = None
        if filtered:
            width = max_label_width or config.max_labels_per_vector
            ql = torch.from_numpy(make_label_array(list(query_labels), width)).to(dev0)
            if ql.shape[0] != q:
                raise ValueError("query_labels must hold one entry per query")
        l = max(params.search_list_size, k)
        use_exact = self._needs_rescore(params)
        beam_width, expand_window_m, window_n = _window_plan(
            config, params, k, l, use_exact, config.max_neighbors_during_build)
        kw = dict(
            config=config, k=k, search_list_size=beam_width,
            max_iters=_query_max_iters(l, params.effective_visit_factor(
                max(self.num_live, 1) // max(self.mesh.size, 1))),
            expand_factor=min(params.expand, l), rescore_n=params.rescore,
            use_exact=use_exact, expand_window_m=expand_window_m, window_n=window_n,
        )
        shards = list(self.shards)  # one snapshot for the whole search
        with _full_f32():
            qv = preprocess_query(queries, config.distance_type)
            q_indexed = qv[:, : config.dims_to_index]
            if config.uses_sbq:
                qc = sbq.encode(q_indexed, self.sbq_stats, config.bits_per_dimension)
            else:
                qc = torch.zeros((q, 0), dtype=torch.int32, device=dev0)
            on_dev: dict = {}

            def inputs(dev):
                key = str(dev)
                if key not in on_dev:
                    on_dev[key] = tuple(None if t is None else t.to(dev)
                                        for t in (qv, q_indexed, qc, ql))
                return on_dev[key]

            parts = self._on_local(
                lambda s: _search_shard(shards[s], *inputs(self._devices[s]), **kw))
        ids, dists, visits, comps, iters = self._merge(parts, q, k)
        self._last_search_res = (visits, comps, iters)
        self._last_search_l = l  # the user's L: estimates scale by it
        return ids, dists

    def _merge(self, parts: dict, q: int, k: int):
        """Cross-shard top-k: global ids ``shard * capacity + local``, laid
        out [Q, P*k] shard-major and stable-sorted by distance; visits and
        comparisons summed over the shards, iterations their largest.  In
        a world of several processes the shards' ids and distances are
        all-gathered first (nothing else crosses processes); the
        statistics are the local shards'."""
        dev0 = self.device
        cap = self.shard_capacity
        ids = {s: parts[s][0].to(dev0) for s in self._local}
        dists = {s: parts[s][1].to(dev0) for s in self._local}
        if len(self._local) != self.num_shards:
            ids, dists = self._all_gather(ids, dists)
        gids = [torch.where(ids[s] >= 0, ids[s] + s * cap, INVALID_ID)
                for s in range(self.num_shards)]
        all_ids = torch.stack(gids, dim=1).reshape(q, -1)
        all_d = torch.stack([dists[s] for s in range(self.num_shards)], dim=1).reshape(q, -1)
        sd, sids = _stable_sort_by(all_d, all_ids)
        visits = sum(parts[s][2].to(dev0) for s in self._local)
        comps = sum(parts[s][3].to(dev0) for s in self._local)
        iters = max(int(parts[s][4]) for s in self._local)
        return sids[:, :k], sd[:, :k], visits, comps, iters

    def _all_gather(self, ids: dict, dists: dict) -> tuple[dict, dict]:
        """Every position's [Q, k] ids and distances, from every process:
        one ``all_gather`` each of the local shards' stacked blocks."""
        import torch.distributed as dist

        _, size = world()
        dev0 = self.device
        comm = dev0 if dist.get_backend() == "nccl" else torch.device("cpu")
        ranks = self.mesh.ranks.ravel()
        out_ids, out_d = {}, {}
        for src, out in ((ids, out_ids), (dists, out_d)):
            block = torch.stack([src[s] for s in self._local]).to(comm)
            got = [torch.empty_like(block) for _ in range(size)]
            dist.all_gather(got, block)
            for r in range(size):
                for j, s in enumerate(np.nonzero(ranks == r)[0]):
                    out[int(s)] = got[r][j].to(dev0)
        return out_ids, out_d

    def search_iter(self, query, params: Optional[QueryParams] = None, *,
                    query_labels: Optional[Iterable[int]] = None):
        """Streaming relaxed-order scan over every shard (``SearchIterator``
        by restarts: each refill re-runs ``search`` with a doubled L).
        Yields (global slot id, exact distance); the whole table is
        enumerable through the index."""
        from ..index import SearchIterator

        return SearchIterator(self, query, params or QueryParams(), query_labels)

    def exact_distances_for(self, qv: torch.Tensor, ids) -> np.ndarray:
        """Full-precision distances from a preprocessed query f32[D] to the
        rows at global slot ids (host array): the iterator's rescore hook."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        cap = self.shard_capacity
        safe = np.maximum(ids, 0)
        shard, local = safe // cap, safe % cap
        out = np.empty(len(ids), dtype=np.float32)
        with _full_f32():
            for s in np.unique(shard):
                arrays = self.shards[int(s)]
                if arrays is None:
                    raise NotImplementedError(
                        f"shard {int(s)}'s rows are in another process")
                sel = shard == s
                rows = torch.from_numpy(local[sel].astype(np.int32)).to(arrays.device)
                d = row_distances(arrays.vectors, qv.to(arrays.device)[None, :], rows[None, :],
                                  self.config.distance_type, arrays.vec_scales)[0]
                out[sel] = d.cpu().numpy()
        return out

    def to_external(self, ids) -> np.ndarray:
        """Global slot ids (numpy or a tensor) -> external ids, int64;
        INVALID_ID and slots past a shard's rows -> -1."""
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        ids = np.asarray(ids)
        cap = self.shard_capacity
        out = np.full(ids.shape, -1, dtype=np.int64)
        flat, res = ids.reshape(-1), out.reshape(-1)
        shard, local = flat // cap, flat % cap
        for s, ext in enumerate(self.external_ids):
            m = (flat >= 0) & (shard == s) & (local < len(ext))
            res[m] = ext[local[m]]
        return out

    def compact(self) -> "ShardedDiskannIndex":
        """A new sharded index over the live rows on the same mesh (the
        vacuum-full analog), keeping external ids and labels.  The live
        rows are gathered on their shards' devices, converted to float32
        (int8: times their scale) and rebuilt from the first position's
        device."""
        self._require_one_process("compact")
        dev0 = self.device
        rows, exts, labels = [], [], []
        for s, arrays in enumerate(self.shards):
            live = np.nonzero(~self._deleted_np[s, : self._counts_np[s]])[0]
            live_t = torch.from_numpy(live).to(arrays.device)
            rows.append(store.dequant_rows(arrays.vectors, arrays.vec_scales, live_t)
                        .float().to(dev0))
            exts.append(self.external_ids[s][live])
            if self.config.has_labels:
                labels.extend([int(v) for v in row if v != LABEL_SENTINEL]
                              for row in arrays.node_labels[live_t].cpu().numpy())
        return ShardedDiskannIndex.build(
            torch.cat(rows), self.config, self.mesh,
            labels=labels if self.config.has_labels else None,
            external_ids=np.concatenate(exts),
        )

    # ------------------------------------------------------------------

    def add(
        self,
        vectors,
        external_ids: Optional[np.ndarray] = None,
        *,
        labels: Optional[Sequence[Optional[Iterable[int]]]] = None,
    ) -> None:
        """Insert a batch [M, D] round-robin into the shards (aminsert).

        Tombstoned rows are reused first, interleaved over the shards from
        the next shard in turn; the rest append round-robin.  Shards grow
        together (every shard keeps one capacity).  Each shard with new
        rows overwrites its recycled rows, appends the fresh ones, writes
        their labels (dropping label start entries of recycled rows,
        registering new labels), inserts them all in one wave over its
        live graph, and repairs orphans on the device.  New tensors are
        published at the end, then the host mirrors; with a journal the
        batch is journaled first."""
        self._require_one_process("add")
        if isinstance(vectors, torch.Tensor):
            vectors = vectors.cpu().numpy()
        vectors = np.asarray(vectors, dtype=np.float32)
        config = self.config
        if vectors.ndim != 2 or vectors.shape[1] != config.num_dimensions:
            raise ValueError("vectors must be [M, num_dimensions]")
        m = vectors.shape[0]
        if m == 0:
            return
        if labels is not None and not config.has_labels:
            raise ValueError("labels passed to an unlabeled index")
        if external_ids is None:
            base = max((int(e.max()) + 1 for e in self.external_ids if len(e)), default=0)
            external_ids = np.arange(base, base + m, dtype=np.int64)
        else:
            external_ids = np.asarray(external_ids, dtype=np.int64)
            if external_ids.shape != (m,):
                raise ValueError("external_ids must be [M]")
        labels_list = list(labels) if labels is not None else None
        if self._journal is not None:
            # Write-ahead: validated inputs, before any device write.
            label_batch = (make_label_array(labels_list, config.max_labels_per_vector)
                           if labels_list is not None else None)
            self._journal.append_add(vectors, external_ids, label_batch)
        p = self.num_shards
        counts = self._counts_np.copy()

        # Placement: free slots first, interleaved over the shards from
        # _next_shard; the rest round-robin from where that stopped.
        free_per_shard = [np.nonzero(self._deleted_np[s, : counts[s]])[0].astype(np.int32)
                          for s in range(p)]
        take_free = min(int(sum(len(f) for f in free_per_shard)), m)
        shard_of = np.empty(m, dtype=np.int64)
        taken = [0] * p
        s = self._next_shard
        placed = 0
        while placed < take_free:
            if taken[s] < len(free_per_shard[s]):
                shard_of[placed] = s
                taken[s] += 1
                placed += 1
            s = (s + 1) % p
        if placed < m:
            shard_of[placed:] = (s + np.arange(m - placed)) % p
        rows_per_shard = [np.nonzero(shard_of == s)[0] for s in range(p)]
        reuse_rows_s, reuse_src_s, fresh_src_s = [], [], []
        for s, rows in enumerate(rows_per_shard):
            k = int(min(len(free_per_shard[s]), len(rows)))
            reuse_rows_s.append(free_per_shard[s][:k])
            reuse_src_s.append(rows[:k])
            fresh_src_s.append(rows[k:])
        fresh = np.asarray([len(f) for f in fresh_src_s], dtype=np.int64)
        need = int((counts + fresh).max())
        new_cap = (max(need, 2 * self.shard_capacity) if need > self.shard_capacity
                   else self.shard_capacity)
        statics = _wave_statics(config)

        def add_shard(s):
            arrays = self.shards[s]
            dev = arrays.device
            n_reuse, n_fresh = len(reuse_rows_s[s]), int(fresh[s])
            if n_reuse + n_fresh == 0:
                return store.grow(arrays, new_cap)
            arrays = (store.grow(arrays, new_cap) if new_cap > arrays.capacity
                      else _own(arrays))
            stats = _stats_on(self.sbq_stats, dev)
            n0 = int(counts[s])
            reuse_rows = torch.from_numpy(reuse_rows_s[s]).to(dev)
            if n_reuse:
                arrays = _reuse_ingest(arrays, stats, torch.from_numpy(
                    vectors[reuse_src_s[s]]).to(dev), reuse_rows, config)
            if n_fresh:
                arrays = _add_ingest(arrays, stats, torch.from_numpy(
                    vectors[fresh_src_s[s]]).to(dev), n0, config)
                if arrays.default_start < 0:
                    arrays = arrays._replace(default_start=n0)  # an empty shard's first row
            target = np.concatenate([reuse_rows_s[s],
                                     np.arange(n0, n0 + n_fresh, dtype=np.int32)])
            target_t = torch.from_numpy(target).to(dev)
            if config.has_labels:
                src = np.concatenate([reuse_src_s[s], fresh_src_s[s]])
                label_arr = make_label_array(
                    [labels_list[r] for r in src] if labels_list is not None
                    else [None] * len(src), config.max_labels_per_vector)
                arrays.node_labels[target_t.long()] = torch.from_numpy(label_arr).to(dev)
                arrays = _clear_label_starts(arrays, reuse_rows_s[s])
                arrays = _register_label_starts(arrays, label_arr, target, grow=False)
            arrays = _shard_wave(arrays, target_t, n0 + n_fresh, brute=False,
                                 slice_rows=1, statics=statics)
            return repair_orphans_device(arrays)

        with _full_f32():
            new = self._on_local(add_shard)
        deleted_np = np.zeros((p, new_cap), dtype=bool)
        deleted_np[:, : self._deleted_np.shape[1]] = self._deleted_np
        ext = list(self.external_ids)
        for s in range(p):
            if len(reuse_src_s[s]):
                deleted_np[s, reuse_rows_s[s]] = False
                ext[s] = ext[s].copy()
                ext[s][reuse_rows_s[s]] = external_ids[reuse_src_s[s]]
            if len(fresh_src_s[s]):
                ext[s] = np.concatenate([ext[s], external_ids[fresh_src_s[s]]])
        # Publish: the shards first, then the host mirrors (new objects).
        self.shards = [new[s] for s in range(p)]
        self._deleted_np = deleted_np
        self.external_ids = ext
        self._counts_np = counts + fresh
        self._next_shard = (self._next_shard + m) % p
        self._after_durable_mutation(m)

    def _tombstone(self, shard: np.ndarray, local: np.ndarray) -> None:
        """Publish new tombstone tensors for the touched shards, then a new
        host mirror."""
        shards = list(self.shards)
        for s in np.unique(shard):
            arrays = shards[int(s)]
            deleted = arrays.deleted.clone()
            deleted[torch.from_numpy(local[shard == s]).to(arrays.device).long()] = True
            shards[int(s)] = arrays._replace(deleted=deleted)
        mirror = self._deleted_np.copy()
        mirror[shard, local] = True
        self.shards = shards
        self._deleted_np = mirror

    def delete(self, ids) -> None:
        """Tombstone rows by global slot id (``shard * capacity + local``,
        the ids ``search`` returns)."""
        self._require_one_process("delete")
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        ids = np.asarray(ids, dtype=np.int64).ravel()
        if len(ids) == 0:
            return
        cap = self.shard_capacity
        shard, local = ids // cap, ids % cap
        if (ids < 0).any() or (shard >= self.num_shards).any():
            raise ValueError("delete ids out of range")
        if (local >= self._counts_np[shard]).any():
            raise ValueError("delete ids out of range")
        if self._journal is not None:
            self._journal.append_delete(ids)
        self._tombstone(shard, local)
        self._after_durable_mutation(len(ids))

    def delete_external(self, ext_ids) -> None:
        """Tombstone every row carrying one of the external ids."""
        self._require_one_process("delete_external")
        ext = np.asarray(ext_ids, dtype=np.int64)
        shard_idx, local_idx = [], []
        for s, e in enumerate(self.external_ids):
            loc = np.nonzero(np.isin(e, ext))[0]
            shard_idx.extend([s] * len(loc))
            local_idx.extend(loc.tolist())
        if not shard_idx:
            return
        if self._journal is not None:
            self._journal._append({"op": np.frombuffer(b"delete_external", dtype=np.uint8),
                                   "ids": ext})
        self._tombstone(np.asarray(shard_idx, dtype=np.int64),
                        np.asarray(local_idx, dtype=np.int64))
        self._after_durable_mutation(len(shard_idx))

    # ------------------------------------------------------------------
    # Persistence: one file holding every shard and the shared state.
    # ------------------------------------------------------------------

    def save(self, path) -> None:
        """Write the JAX package's sharded checkpoint (``sharded``,
        ``num_shards``, ``stacked_<leaf>`` [P, ...] at full capacity,
        ``ext_<s>``; bf16 rows as their uint16 view) atomically.  Saving
        to the durability path truncates the journal."""
        path = normalize_ckpt_path(path)
        host = self._stacked_host()
        payload = {
            "magic": np.int64(CHECKPOINT_MAGIC),
            "version": np.int64(CHECKPOINT_VERSION),
            "sharded": np.int64(1),
            "num_shards": np.int64(self.num_shards),
            "config": np.frombuffer(json.dumps(self.config.to_dict()).encode(), dtype=np.uint8),
            "sbq_count": np.asarray(self.sbq_stats.count, dtype=np.int32),
            "sbq_mean": self.sbq_stats.mean.cpu().numpy(),
            "sbq_m2": self.sbq_stats.m2.cpu().numpy(),
        }
        for name, leaf in zip(store.HostArrays._fields, host):
            payload[f"stacked_{name}"] = leaf
        for s, ext in enumerate(self.external_ids):
            payload[f"ext_{s}"] = ext
        atomic_write_npz(path, payload)
        if self._journal is not None and path == self._dur_path:
            self._journal.truncate()
            self._dur_pending = 0

    @classmethod
    def load(cls, path, mesh: Mesh) -> "ShardedDiskannIndex":
        """Read a sharded checkpoint of either package onto ``mesh`` (its
        size must be the checkpoint's shard count; a checkpoint without
        ``vec_scales`` gets unit scales), then replay the journal beside
        it, if any, through ``add`` / ``delete`` / ``delete_external``.
        The loaded index has no journal attached."""
        path = normalize_ckpt_path(path)
        with np.load(path) as z:
            if int(z["magic"]) != CHECKPOINT_MAGIC:
                raise ValueError("not a pgvectorscale_tpu checkpoint")
            if "sharded" not in z or int(z["sharded"]) != 1:
                raise ValueError("not a sharded checkpoint; use DiskannIndex.load")
            if int(z["version"]) > CHECKPOINT_VERSION:
                raise ValueError("checkpoint version newer than supported")
            p = int(z["num_shards"])
            if mesh.size != p:
                raise ValueError(f"checkpoint has {p} shards; mesh has {mesh.size} devices")
            if len(mesh.local_positions()) != p:
                raise NotImplementedError(
                    "load needs every shard in one process; the mesh spans processes")
            config = IndexConfig.from_dict(json.loads(bytes(z["config"]).decode()))
            leaves = {name: z[f"stacked_{name}"] for name in store.HostArrays._fields
                      if f"stacked_{name}" in z}
            if "vec_scales" not in leaves:
                leaves["vec_scales"] = np.ones(leaves["vectors"].shape[:2], dtype=np.float32)
            stats_np = (int(z["sbq_count"]), z["sbq_mean"].astype(np.float32),
                        z["sbq_m2"].astype(np.float32))
            ext = [z[f"ext_{s}"].copy() for s in range(p)]
        devices = list(mesh.devices.ravel())
        for d in {str(d) for d in devices}:
            resolve_device(d)
        shards = [store.from_host(store.HostArrays(**{f: leaves[f][s]
                                                      for f in store.HostArrays._fields}),
                                  devices[s], config.vector_dtype) for s in range(p)]
        dev0 = devices[0]
        stats = sbq.SbqStats(count=stats_np[0], mean=torch.from_numpy(stats_np[1]).to(dev0),
                             m2=torch.from_numpy(stats_np[2]).to(dev0))
        index = cls(config, mesh, shards, stats, ext)
        index._counts_np = np.asarray(leaves["count"], dtype=np.int64).copy()
        index._deleted_np = np.asarray(leaves["deleted"], dtype=bool).copy()
        if os.path.isdir(path + ".journal"):
            for rec in MutationJournal(path).records():
                op = bytes(rec["op"]).decode()
                if op == "add":
                    rlabels = None
                    if "labels" in rec:
                        rlabels = [[int(v) for v in row if v != LABEL_SENTINEL]
                                   for row in rec["labels"]]
                    index.add(rec["vectors"], external_ids=rec["external_ids"],
                              labels=rlabels)
                elif op == "delete":
                    index.delete(rec["ids"])
                elif op == "delete_external":
                    index.delete_external(rec["ids"])
                else:
                    raise ValueError(f"unknown journal op {op!r}")
        return index
