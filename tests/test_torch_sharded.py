"""The port's row-sharded index (``parallel/sharded.py``) against the JAX
package's, on the CPU.

- The JAX index runs on the virtual 8-device CPU mesh (``conftest.py``),
  the port's on ``make_mesh(8, device="cpu")``: eight positions, all the
  CPU, each shard its own ``GraphArrays``.
- Exact parity needs exact arithmetic: the parity fixtures hold integers
  in -3..3 with L2, so every distance is an integer in float32 whatever
  the summation order.  Their builds lower the brute-force threshold to
  64 rows in both packages and start at waves of 32 rows, so every shard
  takes brute-force and searched waves.  Per-shard stores (adjacency,
  codes, rows, counts, start nodes, label tables) must be equal; searches
  give equal ids and distances within 1e-5.
- The JAX side writes reverse edges without its row-0 fault (ROADMAP.md
  §3 fault 1): ``graph.build.append_backlinks`` is replaced for this
  module by ``test_torch_plain.py``'s copy, and JAX's trace caches are
  cleared around the replacement.  The JAX package keeps an edge-code
  cache the port does not have: its results with and without it equal
  the port's.
- Every case of ``tests/test_sharded.py``,
  ``test_durability.py::test_sharded_durability_roundtrip`` and
  ``test_int8.py::test_int8_sharded_smoke`` runs on the port at its sizes
  and floors.
"""

import contextlib
import itertools

import jax
import numpy as np
import pytest
import torch

from pgvectorscale_tpu import IndexConfig as JaxConfig
from pgvectorscale_tpu import QueryParams as JaxParams
from pgvectorscale_tpu.config import DistanceType as JaxDistance
from pgvectorscale_tpu.graph import build as jbuild
from pgvectorscale_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pgvectorscale_tpu.parallel.sharded import ShardedDiskannIndex as JaxSharded
from pgvectorscale_tpu_torch import (
    DiskannIndex,
    IndexConfig,
    QueryParams,
    ShardedDiskannIndex,
    create_index,
)
from pgvectorscale_tpu_torch.config import DistanceType
from pgvectorscale_tpu_torch.distance import distance_matrix, preprocess_query
from pgvectorscale_tpu_torch.graph import build
from pgvectorscale_tpu_torch.labels import LABEL_SENTINEL
from pgvectorscale_tpu_torch.ops import sbq
from pgvectorscale_tpu_torch.parallel import sharded as psharded
from pgvectorscale_tpu_torch.parallel.mesh import make_mesh
from pgvectorscale_tpu_torch.parallel.multihost import global_mesh

from test_torch_plain import _append_backlinks_dropping_misfits

D, R, L = 32, 16, 32
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _setup():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbuild, "append_backlinks", _append_backlinks_dropping_misfits)
        jax.clear_caches()
        yield
    jax.clear_caches()
    torch.set_num_threads(prev)


@contextlib.contextmanager
def _low_threshold():
    """Brute-force seeds up to 64 rows in both packages' sharded builds."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbuild, "BRUTE_CANDIDATE_THRESHOLD", 64)
        mp.setattr(psharded, "BRUTE_CANDIDATE_THRESHOLD", 64)
        yield


def _mesh(n=8):
    return make_mesh(n, axis_name="n", device="cpu")


def _jax_mesh(n=8):
    return jax_make_mesh(n, axis_name="n")


def _ints(n, seed, d=D):
    return np.random.default_rng(seed).integers(-3, 4, (n, d)).astype(np.float32)


def _lowrank(rng, n, q, d, rank=32):
    basis = rng.standard_normal((rank, d)).astype(np.float32)
    return (
        rng.standard_normal((n, rank)).astype(np.float32) @ basis,
        rng.standard_normal((q, rank)).astype(np.float32) @ basis,
    )


def _configs(**kw):
    jkw = dict(kw)
    if "distance_type" in jkw:
        jkw["distance_type"] = JaxDistance[jkw["distance_type"].name]
    base = dict(num_dimensions=D, num_neighbors=R, search_list_size=L)
    return (JaxConfig(**{**base, "distance_type": JaxDistance.L2, **jkw}),
            IndexConfig(**{**base, "distance_type": DistanceType.L2, **kw}))


# Leaves with one entry a row: compared below each shard's count.  The
# JAX package's add writes its whole padded batch from the count on (codes
# of zero rows past the count); the port writes the real rows only.
_ROW_LEAVES = ("vectors", "codes", "adjacency", "node_labels", "deleted", "vec_scales")


def _assert_same_store(pidx, jidx):
    """Every stacked leaf of the two indexes equal, shard by shard (row
    leaves below each shard's count), and the host mirrors."""
    host = pidx._stacked_host()
    counts = np.asarray(jidx.stacked.count)
    for name in host._fields:
        got, want = getattr(host, name), np.asarray(getattr(jidx.stacked, name))
        assert got.shape == want.shape, name
        if name in _ROW_LEAVES:
            for s, c in enumerate(counts):
                np.testing.assert_array_equal(got[s, :c], want[s, :c], err_msg=f"{name} {s}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    for e_p, e_j in zip(pidx.external_ids, jidx.external_ids):
        np.testing.assert_array_equal(e_p, e_j)
    np.testing.assert_array_equal(pidx._counts_np, jidx._counts_np)
    np.testing.assert_array_equal(pidx._deleted_np, jidx._deleted_np)


def _assert_same_search(pidx, jidx, queries, k=10, params=None, query_labels=None):
    jp = JaxParams(**params) if params else None
    pp = QueryParams(**params) if params else None
    jids, jd = jidx.search(queries, k, jp, query_labels=query_labels)
    ids, d = pidx.search(queries, k, pp, query_labels=query_labels)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=ATOL, rtol=0)
    return ids


def _recall(ext, gt):
    q, k = gt.shape
    return sum(len(set(gt[r]) & set(int(i) for i in ext[r] if i >= 0)) for r in range(q)) / (q * k)


def _exact_top(vectors, queries, k, dt, valid=None):
    v = preprocess_query(torch.from_numpy(vectors), dt)
    q = preprocess_query(torch.from_numpy(queries), dt)
    dm = distance_matrix(q, v, dt)
    if valid is not None:
        dm[:, ~torch.from_numpy(valid)] = torch.inf
    return torch.topk(dm, k, largest=False).indices.numpy()


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def l2_pair():
    """1,200 integer rows over 8 shards, built by both packages."""
    jc, pc = _configs()
    v = _ints(1200, 0)
    with _low_threshold():
        jidx = JaxSharded.build(v, jc, _jax_mesh(), initial_wave=32)
        pidx = ShardedDiskannIndex.build(v, pc, _mesh(), initial_wave=32)
    return pidx, jidx, _ints(30, 1)


def test_build_matches_jax_per_shard(l2_pair):
    """Lockstep waves, brute-force and searched, finalize and repair give
    every shard JAX's store; the build stats count JAX's waves."""
    pidx, jidx, _ = l2_pair
    _assert_same_store(pidx, jidx)
    # 150 rows a shard: waves of 32 and 64 rows seeded by brute force, then
    # one searched wave of the last 53.
    assert pidx.build_stats.num_waves == jidx.build_stats.num_waves == 3
    assert pidx.build_stats.num_nodes == jidx.build_stats.num_nodes == 1200
    for p, arrays in enumerate(pidx.shards):
        assert bool(build.reachable_on_device(arrays)[: arrays.count].all())


@pytest.mark.parametrize("strategy", ["expand", "beam", "scored"])
def test_search_matches_jax(l2_pair, strategy):
    """Each window strategy, with rescore 0, 64 and 400 (wider than the
    beam): ids equal, distances within 1e-5."""
    pidx, jidx, queries = l2_pair
    for rescore in (0, 64, 400):
        _assert_same_search(pidx, jidx, queries,
                            params=dict(search_list_size=L, rescore=rescore,
                                        window_strategy=strategy))


def test_stats_and_cost_match_jax(l2_pair):
    """``last_search_stats`` (visits and comparisons summed over shards,
    the largest iteration count) and ``estimate_query_cost`` equal JAX's,
    cold and measured."""
    pidx, jidx, queries = l2_pair
    pidx._last_search_res = None
    jidx._last_search_res = None
    assert pidx.estimate_query_cost() == jidx.estimate_query_cost()
    params = dict(search_list_size=24, rescore=32)
    _assert_same_search(pidx, jidx, queries, k=5, params=params)
    assert vars(pidx.last_search_stats) == vars(jidx.last_search_stats)
    assert (pidx.estimate_query_cost(QueryParams(**params))
            == jidx.estimate_query_cost(JaxParams(**params)))
    assert pidx.last_search_stats.total_visits > 0


def test_edge_code_cache_results_equal_the_port(l2_pair, monkeypatch):
    """The JAX package's per-shard edge-code cache changes no result: its
    searches with and without the cache equal the port's, which keeps no
    cache and reads the codes through the adjacency."""
    pidx, jidx, queries = l2_pair
    params = dict(search_list_size=48, rescore=48)
    ids = _assert_same_search(pidx, jidx, queries, params=params)
    assert jidx._edge_codes is not None
    assert not hasattr(pidx, "_edge_codes")
    monkeypatch.setattr(JaxSharded, "_edge_code_cache", lambda self, s=None: None)
    jids, _ = jidx.search(queries, 10, JaxParams(**params))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


def test_checkpoints_cross_load(l2_pair, tmp_path):
    """A port checkpoint has JAX's keys and arrays; each package loads the
    other's, and both searches equal the live index's."""
    pidx, jidx, queries = l2_pair
    pidx.save(tmp_path / "p")
    jidx.save(str(tmp_path / "j"))
    with np.load(tmp_path / "p.npz") as zp, np.load(tmp_path / "j.npz") as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for f in zp.files:
            if f in ("sbq_mean", "sbq_m2"):
                # One training pass each, summed in another order: an ulp
                # apart at most (every code is equal, test above).
                np.testing.assert_allclose(zp[f], zj[f], rtol=1e-6, atol=0, err_msg=f)
            else:
                np.testing.assert_array_equal(zp[f], zj[f], err_msg=f)
    from_j = ShardedDiskannIndex.load(tmp_path / "j", _mesh())
    from_p = JaxSharded.load(str(tmp_path / "p.npz"), _jax_mesh())
    _assert_same_store(from_j, from_p)
    params = dict(search_list_size=L, rescore=64)
    _assert_same_search(from_j, from_p, queries, params=params)
    _assert_same_search(from_j, jidx, queries, params=params)
    with pytest.raises(ValueError, match="checkpoint has 8 shards"):
        ShardedDiskannIndex.load(tmp_path / "j", _mesh(4))


def test_search_iter_matches_jax(l2_pair):
    """The iterator over a sharded index (restarts with a doubled L) yields
    JAX's ids and distances, in JAX's order."""
    pidx, jidx, queries = l2_pair
    got = list(itertools.islice(
        pidx.search_iter(queries[0], QueryParams(search_list_size=8, rescore=10)), 40))
    want = list(itertools.islice(
        jidx.search_iter(queries[0], JaxParams(search_list_size=8, rescore=10)), 40))
    assert len(got) == 40
    assert [i for i, _ in got] == [int(i) for i, _ in want]
    np.testing.assert_allclose([d for _, d in got], [d for _, d in want], atol=ATOL, rtol=0)


def test_filtered_search_matches_jax():
    """A labeled build (label starts per shard, label-aware prune, the
    filtered second pass of searched waves) equals JAX's store, and its
    one- and two-label searches equal JAX's."""
    jc, pc = _configs(max_labels_per_vector=2)
    v = _ints(960, 2)
    labels = [[i % 4] if i % 3 else [i % 4, 4 + i % 5] for i in range(960)]
    with _low_threshold():
        jidx = JaxSharded.build(v, jc, _jax_mesh(), labels=labels, initial_wave=64)
        pidx = ShardedDiskannIndex.build(v, pc, _mesh(), labels=labels, initial_wave=64)
    _assert_same_store(pidx, jidx)
    queries = _ints(16, 3)
    params = dict(search_list_size=L, rescore=64)
    for ql in ([[2]] * 16, [[1, 6]] * 16):
        ids = _assert_same_search(pidx, jidx, queries, params=params, query_labels=ql)
        ext = pidx.to_external(ids)
        for row in ext:
            for e in row[row >= 0]:
                assert set(labels[e]) & set(ql[0])


def test_add_delete_and_growth_match_jax():
    """Deletes by external and slot id, then an add that reuses every
    tombstone, appends round-robin and grows every shard past its
    capacity: each shard's store equals JAX's, and so do the searches."""
    jc, pc = _configs()
    v = _ints(1000, 4)
    jidx = JaxSharded.build(v, jc, _jax_mesh(2))
    pidx = ShardedDiskannIndex.build(v, pc, _mesh(2))
    for idx in (jidx, pidx):
        idx.delete_external(np.arange(0, 200, 2, dtype=np.int64))
        idx.delete(np.asarray([1024 + 7, 1024 + 9], dtype=np.int64))
        idx.add(_ints(1300, 5))
    assert pidx.shard_capacity == jidx.shard_capacity == 2048
    assert pidx.num_deleted == 0 and pidx.count == jidx.count == 1000 + 1300 - 102
    _assert_same_store(pidx, jidx)
    _assert_same_search(pidx, jidx, _ints(20, 6), params=dict(search_list_size=L, rescore=64))


def test_jax_journal_replays_in_port(tmp_path):
    """A journal written by the JAX sharded index (an add, a delete by
    external id, a delete by slot id) replays in the port's ``load`` to
    JAX's index; a port journal of the same mutations replays in JAX's."""
    jc, pc = _configs()
    v = _ints(320, 7)
    jidx = JaxSharded.build(v[:256], jc, _jax_mesh(4))
    pidx = ShardedDiskannIndex.build(v[:256], pc, _mesh(4))
    for idx, name in ((jidx, "j"), (pidx, "p")):
        idx.enable_durability(str(tmp_path / name))
        idx.add(v[256:])
        idx.delete_external(np.arange(10, dtype=np.int64))
        idx.delete(np.asarray([3, 1024 + 5], dtype=np.int64))
        assert len(idx._journal) == 3
    port_from_j = ShardedDiskannIndex.load(tmp_path / "j", _mesh(4))
    jax_from_p = JaxSharded.load(str(tmp_path / "p.npz"), _jax_mesh(4))
    for p_idx, j_idx in ((port_from_j, jidx), (pidx, jax_from_p)):
        _assert_same_store(p_idx, j_idx)
        _assert_same_search(p_idx, j_idx, v[:16], params=dict(search_list_size=48, rescore=64))


# ---------------------------------------------------------------------------
# The JAX package's sharded tests, on the port
# ---------------------------------------------------------------------------


def test_sharded_recall_matches_single_index(rng):
    """Sharding must not lose recall against one device's index at the
    same parameters."""
    n, d, q, k = 1500, 64, 30, 10
    vectors, queries = _lowrank(rng, n, q, d)
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.COSINE,
                         num_neighbors=20, search_list_size=50)
    params = QueryParams(search_list_size=50, rescore=50)
    gt = _exact_top(vectors, queries, k, DistanceType.COSINE)
    single = DiskannIndex.build(vectors, config, device="cpu")
    recall_single = _recall(single.search(queries, k, params, device="cpu")[0].numpy(), gt)
    index = ShardedDiskannIndex.build(vectors, config, _mesh())
    assert index.count == n
    ids, dists = index.search(queries, k=k, params=params)
    recall_sharded = _recall(index.to_external(ids), gt)
    assert recall_sharded >= recall_single - 0.05, (recall_sharded, recall_single)
    assert bool((dists[:, 1:] - dists[:, :-1] >= -1e-6).all())


def test_sharded_save_load_roundtrip(tmp_path, rng):
    n, d = 640, 32
    vectors, queries = _lowrank(rng, n, 8, d)
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.L2,
                         num_neighbors=12, search_list_size=24)
    mesh = _mesh()
    index = ShardedDiskannIndex.build(vectors, config, mesh)
    path = str(tmp_path / "sharded.npz")
    index.save(path)
    loaded = ShardedDiskannIndex.load(path, mesh)
    assert loaded.count == n
    ids_a, d_a = index.search(queries, k=5)
    ids_b, d_b = loaded.search(queries, k=5)
    np.testing.assert_array_equal(index.to_external(ids_a), loaded.to_external(ids_b))
    assert torch.equal(d_a, d_b)
    with pytest.raises(ValueError, match="sharded checkpoint; use ShardedDiskannIndex.load"):
        DiskannIndex.load(path, device="cpu")
    single = DiskannIndex.build(vectors, config, device="cpu")
    single.save(tmp_path / "single")
    with pytest.raises(ValueError, match="not a sharded checkpoint"):
        ShardedDiskannIndex.load(tmp_path / "single", mesh)


def test_sharded_labeled_filtered_search(rng):
    """Filtered search over the sharded store: results hold the filter,
    filtered recall >= 0.9 against a filtered exact top-10, and an
    unfiltered search of the labeled index still works."""
    n, d, k = 960, 64, 10
    vectors, queries = _lowrank(rng, n, 15, d)
    labels = [[int(i % 4)] for i in range(n)]
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.COSINE,
                         num_neighbors=16, search_list_size=40, max_labels_per_vector=2)
    index = ShardedDiskannIndex.build(vectors, config, _mesh(), labels=labels)
    target = 2
    ids, _ = index.search(queries, k=k, query_labels=[[target]] * len(queries))
    ext = index.to_external(ids)
    assert all(g % 4 == target for g in ext.ravel() if g >= 0)
    gt = _exact_top(vectors, queries, k, DistanceType.COSINE, valid=np.arange(n) % 4 == target)
    assert _recall(ext, gt) >= 0.9
    ids2, _ = index.search(queries, k=k)
    assert (index.to_external(ids2)[:, 0] >= 0).all()


def test_sharded_build_matches_serial_per_shard(rng):
    """Each shard's graph is a single-device build of its rows with the
    shared quantizer."""
    n, d, p = 1200, 32, 8
    vectors, _ = _lowrank(rng, n, 0, d)
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.L2,
                         num_neighbors=16, search_list_size=32)
    index = ShardedDiskannIndex.build(vectors, config, _mesh())
    stats = sbq.train(torch.from_numpy(vectors))
    for s in (0, 3, 7):
        rows = np.arange(s, n, p)
        serial = DiskannIndex.build(vectors[rows], config, sbq_stats=stats, device="cpu")
        assert torch.equal(index.shards[s].adjacency[: len(rows)],
                           serial.arrays.adjacency[: len(rows)])


def test_sharded_iterator_full_scan(rng):
    """The streaming iterator over the sharded store yields every live row
    once, with exact distances."""
    n, d = 600, 32
    vectors, _ = _lowrank(rng, n, 0, d)
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.L2,
                         num_neighbors=16, search_list_size=32)
    index = ShardedDiskannIndex.build(vectors, config, _mesh())
    index.delete_external(np.asarray([5, 17, 123], dtype=np.int64))
    it = index.search_iter(vectors[0], params=QueryParams(search_list_size=8, rescore=10))
    got = list(it)
    gids = [g for g, _ in got]
    assert len(got) == n - 3 and len(set(gids)) == n - 3
    ext = index.to_external(np.asarray(gids))
    assert set(int(e) for e in ext) == set(range(n)) - {5, 17, 123}
    e0 = int(ext[0])
    np.testing.assert_allclose(got[0][1], float(((vectors[e0] - vectors[0]) ** 2).sum()),
                               rtol=1e-4)


def test_sharded_compact(rng):
    n, d = 700, 32
    vectors, queries = _lowrank(rng, n, 10, d)
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.L2,
                         num_neighbors=16, search_list_size=32)
    index = ShardedDiskannIndex.build(vectors, config, _mesh())
    index.delete_external(np.arange(0, 100, dtype=np.int64))
    compacted = index.compact()
    assert compacted.count == n - 100 and compacted.num_deleted == 0
    ids, _ = compacted.search(queries, k=5)
    ext = compacted.to_external(ids)
    assert (ext[ids.numpy() >= 0] >= 100).all()


def test_sharded_add_and_delete(rng):
    n, d = 800, 32
    vectors, _ = _lowrank(rng, n + 100, 0, d)
    vectors, extra = vectors[:n], vectors[n:]
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.L2,
                         num_neighbors=16, search_list_size=32)
    index = ShardedDiskannIndex.build(vectors, config, _mesh())
    index.add(extra)
    assert index.count == n + 100
    ids, _ = index.search(extra[:5], k=1)
    assert (index.to_external(ids)[:, 0] >= n).all()
    index.delete_external(np.arange(n, n + 100, dtype=np.int64))
    ids, _ = index.search(extra[:5], k=3)
    assert (index.to_external(ids) < n).all()


def test_sharded_shards_stay_on_their_positions(rng):
    """Every tensor of shard p lives on mesh position p's device, after
    build, search, add and delete; results come back on the first
    position's device."""
    n, d = 640, 32
    vectors, _ = _lowrank(rng, n + 64, 0, d)
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.L2,
                         num_neighbors=12, search_list_size=24)
    mesh = _mesh()
    index = ShardedDiskannIndex.build(vectors[:n], config, mesh)

    def placed():
        for arrays, dev in zip(index.shards, mesh.devices.ravel()):
            for t in arrays:
                if isinstance(t, torch.Tensor):
                    assert t.device == dev

    placed()
    ids, dists = index.search(vectors[:4], k=1)
    assert ids.device == dists.device == mesh.devices.ravel()[0]
    index.add(vectors[n:])
    index.delete(ids[:, 0].numpy())
    placed()


def test_sharded_search_after_add_sees_new_rows(rng):
    """A search after ``add`` sees the new rows (the JAX cache-invalidation
    test; the port has no cache to invalidate)."""
    n, d = 640, 32
    vectors, _ = _lowrank(rng, n + 64, 0, d)
    vectors, extra = vectors[:n], vectors[n:]
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.L2,
                         num_neighbors=12, search_list_size=24)
    index = ShardedDiskannIndex.build(vectors, config, _mesh())
    index.search(extra[:4], k=1)
    held = index.shards
    index.add(extra)
    assert index.shards is not held
    ids, _ = index.search(extra[:4], k=1)
    assert (index.to_external(ids)[:, 0] >= n).all()


def test_sharded_window_strategies(rng):
    """Rescore windows wider than the beam under every strategy."""
    n, d, q, k = 1500, 64, 30, 10
    vectors, queries = _lowrank(rng, n, q, d)
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.COSINE,
                         num_neighbors=20, search_list_size=50)
    gt = _exact_top(vectors, queries, k, DistanceType.COSINE)
    index = ShardedDiskannIndex.build(vectors, config, _mesh())
    recalls = {}
    for strat in ("expand", "beam", "scored"):
        p = QueryParams(search_list_size=40, rescore=400, window_strategy=strat)
        ids, dists = index.search(queries, k=k, params=p)
        recalls[strat] = _recall(index.to_external(ids), gt)
        assert bool((dists[:, 1:] - dists[:, :-1] >= -1e-6).all())
    assert recalls["beam"] >= 0.9, recalls
    assert recalls["expand"] >= recalls["beam"] - 0.08, recalls
    assert recalls["scored"] >= recalls["beam"] - 0.08, recalls


def test_sharded_stats_cost_and_slot_delete(rng):
    """Build stats, summed search stats, measured and model cost
    estimates, and delete by the global slot ids that search returns."""
    n, d, k = 600, 32, 5
    vectors, queries = _lowrank(rng, n, 12, d)
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.L2,
                         num_neighbors=12, search_list_size=24)
    index = ShardedDiskannIndex.build(vectors, config, _mesh())
    bs = index.build_stats
    assert bs is not None and bs.num_nodes == n and bs.num_waves >= 1
    assert bs.insert_s > 0
    est = index.estimate_query_cost()
    assert est["basis"] == "model"
    assert est["expected_node_visits"] <= n
    assert est["expected_distance_comparisons"] == (
        est["expected_node_visits"] * config.num_neighbors)
    params = QueryParams(search_list_size=24, rescore=32)
    ids, _ = index.search(queries, k=k, params=params)
    stats = index.last_search_stats
    assert stats.num_queries == len(queries)
    assert stats.total_visits > 0
    assert stats.total_distance_comparisons >= stats.total_visits
    est = index.estimate_query_cost(params)
    assert est["basis"] == "measured"
    assert abs(est["expected_node_visits"] - stats.total_visits / stats.num_queries) <= 1
    assert est["expected_full_precision_comparisons"] == (params.rescore + 10) * index.num_shards
    victim = int(ids[0, 0])
    index.delete(np.asarray([victim]))
    ids2, _ = index.search(queries[:1], k=k, params=params)
    assert victim not in set(int(i) for i in ids2[0])
    with pytest.raises(ValueError, match="out of range"):
        index.delete(np.asarray([index.num_shards * index.shard_capacity]))


def test_sharded_tombstone_slot_reuse_keeps_capacity_flat(rng):
    """N adds after N deletes leave count and capacity flat, recycled rows
    are live at their new identity, and deleted ids never return.

    The JAX test also requires each round's first four recycled rows to
    be their own vectors' nearest result.  JAX's package meets that only
    through its row-0 backlink fault: with the fault replaced (this
    module), JAX misses the second row of the third round, a recycled row
    whose in-edges still come from the old vector's neighbourhood, and so
    does the port.  Here the port's results equal JAX's in every round,
    and every other row is found at distance 0."""
    n, d = 1024, 32
    vectors, _ = _lowrank(rng, n, 1, d)
    jc, config = _configs(num_neighbors=12, search_list_size=24)
    index = ShardedDiskannIndex.build(vectors, config, _mesh())
    jidx = JaxSharded.build(vectors, jc, _jax_mesh())
    cap0, count0 = index.shard_capacity, index.count
    assert count0 == n
    next_ext = n
    params = dict(search_list_size=32, rescore=32)
    misses = []
    for r in range(3):
        dead_ext = rng.choice(np.concatenate(index.external_ids), size=128,
                              replace=False).astype(np.int64)
        newv = rng.standard_normal((128, d)).astype(np.float32)
        new_ext = np.arange(next_ext, next_ext + 128, dtype=np.int64)
        for idx in (index, jidx):
            idx.delete_external(dead_ext)
            assert idx.num_deleted == 128
            idx.add(newv, external_ids=new_ext)
        next_ext += 128
        assert index.shard_capacity == cap0 and index.count == count0
        assert index.num_deleted == 0
        got_ids = _assert_same_search(index, jidx, newv[:4], k=1, params=params)
        got_d = index.search(newv[:4], k=1, params=QueryParams(**params))[1]
        ext = index.to_external(got_ids)[:, 0]
        for i in range(4):
            if ext[i] == new_ext[i]:
                assert float(got_d[i, 0]) < 1e-4
            else:
                misses.append((r, i))
    assert misses == [(2, 1)]
    ids, _ = index.search(rng.standard_normal((8, d)).astype(np.float32), k=10,
                          params=QueryParams(**params))
    returned = set(int(e) for e in index.to_external(ids).ravel() if e >= 0)
    assert not returned & set(int(e) for e in dead_ext)


def test_sharded_slot_reuse_clears_stale_label_starts(rng):
    """A recycled row registered as a label start loses the entry when its
    new labels differ; the new label becomes searchable."""
    n, d = 256, 16
    vectors, _ = _lowrank(rng, n, 1, d)
    labels = [[1 + (i % 3)] for i in range(n)]
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.L2,
                         num_neighbors=10, search_list_size=20, max_labels_per_vector=2)
    index = ShardedDiskannIndex.build(vectors, config, _mesh(), labels=labels)
    dead_ext = np.asarray([i for i in range(n) if labels[i] == [3]], dtype=np.int64)
    index.delete_external(dead_ext)
    newv = rng.standard_normal((len(dead_ext), d)).astype(np.float32)
    index.add(newv, external_ids=np.arange(n, n + len(dead_ext), dtype=np.int64),
              labels=[[7]] * len(dead_ext))
    assert index.num_deleted == 0
    for arrays in index.shards:
        keys = arrays.label_start_keys.numpy()
        ids = arrays.label_start_ids.numpy()
        for slot in np.nonzero(keys == 3)[0]:
            row_labels = arrays.node_labels[int(ids[slot])].numpy()
            assert 3 in set(int(v) for v in row_labels if v != LABEL_SENTINEL)
    got, _ = index.search(newv[:4], k=1, params=QueryParams(search_list_size=16, rescore=16),
                          query_labels=[[7]] * 4)
    assert (index.to_external(got)[:, 0] >= n).all()


def test_sharded_durability_roundtrip(tmp_path):
    """Journal an add and a delete by external id, drop the index (the
    crash), and ``load`` replays to the index the same calls give."""
    mesh = global_mesh(n_devices=8, device="cpu")
    path = str(tmp_path / "shards.npz")
    vectors = np.random.default_rng(9).standard_normal((320, D)).astype(np.float32)
    _, config = _configs()
    index = ShardedDiskannIndex.build(vectors[:256], config, mesh)
    index.enable_durability(path)
    index.add(vectors[256:320])
    index.delete_external(np.arange(10, dtype=np.int64))
    assert len(index._journal) == 2
    del index
    recovered = ShardedDiskannIndex.load(path, mesh)
    expected = ShardedDiskannIndex.build(vectors[:256], config, mesh)
    expected.add(vectors[256:320])
    expected.delete_external(np.arange(10, dtype=np.int64))
    assert recovered.num_live == expected.num_live == 310
    params = QueryParams(search_list_size=48, rescore=64)
    ids_r, _ = recovered.search(vectors[:32], k=5, params=params)
    ids_e, _ = expected.search(vectors[:32], k=5, params=params)
    np.testing.assert_array_equal(recovered.to_external(ids_r), expected.to_external(ids_e))


def test_int8_sharded_smoke(tmp_path, rng):
    """int8 rows over 4 shards: recall@10 >= 0.9 on external ids, and a
    save/load roundtrip (the scales are a stacked leaf) searches equal."""
    mesh = make_mesh(4, axis_name="n", device="cpu")
    vectors, queries = _lowrank(rng, 768, 16, 64)
    config = IndexConfig(num_dimensions=64, distance_type=DistanceType.L2, num_neighbors=16,
                         search_list_size=32, vector_dtype="int8")
    index = ShardedDiskannIndex.build(vectors, config, mesh)
    assert all(a.vectors.dtype == torch.int8 for a in index.shards)
    params = QueryParams(search_list_size=48, rescore=100)
    ids, _ = index.search(queries, k=10, params=params)
    gt = _exact_top(vectors, queries, 10, DistanceType.L2)
    assert _recall(index.to_external(ids), gt) >= 0.9
    path = str(tmp_path / "int8_sharded.npz")
    index.save(path)
    loaded = ShardedDiskannIndex.load(path, mesh)
    ids1, _ = loaded.search(queries, k=10, params=params)
    assert torch.equal(ids, ids1)


def test_create_index_picks_the_family(rng):
    """``create_index``: sharded over a mesh of more than one position,
    else one device's index on the mesh's device."""
    vectors, _ = _lowrank(rng, 300, 0, D)
    _, config = _configs()
    assert isinstance(create_index(vectors, config, mesh=_mesh(4)), ShardedDiskannIndex)
    single = create_index(vectors, config, mesh=_mesh(1))
    assert isinstance(single, DiskannIndex) and single.device.type == "cpu"
    assert isinstance(create_index(vectors, config, device="cpu"), DiskannIndex)


def test_add_near_capacity_keeps_the_rows_before_count(rng):
    """An add whose padded batch would pass the capacity while its rows fit
    (1,000 rows in 1,024 slots, 20 more) writes them at the count and
    leaves every earlier row as it was.  The JAX package's sharded add
    writes its 32-row padded batch with ``dynamic_update_slice``, whose
    start is clamped to 992, so its rows 992-999 take the new rows
    (ROADMAP.md §3 fault 6)."""
    v = rng.standard_normal((1000, 16)).astype(np.float32)
    extra = rng.standard_normal((20, 16)).astype(np.float32)
    config = IndexConfig(num_dimensions=16, distance_type=DistanceType.L2, num_neighbors=10,
                         search_list_size=20)
    index = ShardedDiskannIndex.build(v, config, _mesh(1))
    before = index.shards[0].vectors[:1000].clone()
    index.add(extra)
    arrays = index.shards[0]
    assert index.shard_capacity == 1024 and index.count == 1020
    assert torch.equal(arrays.vectors[:1000], before)
    assert torch.equal(arrays.vectors[1000:1020], torch.from_numpy(extra))
    ids, d = index.search(extra, k=1)
    assert index.to_external(ids)[:, 0].tolist() == list(range(1000, 1020))


def test_bf16_checkpoint_loads_in_jax(tmp_path):
    """A sharded bf16 checkpoint carries the rows as their uint16 view:
    the JAX package loads the port's with every stacked leaf equal (its
    rows as ml_dtypes bfloat16, bit for bit), and the port loads it back
    searching as before."""
    _, pc = _configs(vector_dtype="bf16")
    v = np.random.default_rng(8).standard_normal((300, D)).astype(np.float32)
    pidx = ShardedDiskannIndex.build(v, pc, _mesh(4))
    assert all(a.vectors.dtype == torch.bfloat16 for a in pidx.shards)
    pidx.save(tmp_path / "bf16")
    jidx = JaxSharded.load(str(tmp_path / "bf16.npz"), _jax_mesh(4))
    host = pidx._stacked_host()
    np.testing.assert_array_equal(host.vectors, np.asarray(jidx.stacked.vectors).view(np.uint16))
    for name in host._fields[1:]:
        np.testing.assert_array_equal(getattr(host, name), np.asarray(getattr(jidx.stacked, name)),
                                      err_msg=name)
    back = ShardedDiskannIndex.load(tmp_path / "bf16", _mesh(4))
    a, da = pidx.search(v[:8], 5)
    b, db = back.search(v[:8], 5)
    assert torch.equal(a, b) and torch.equal(da, db)
