"""The port's orphan repair on the host (``graph.build.repair_orphans_host``,
the fallback when the device repair leaves an orphan) and its place in
``repair_orphans`` and ``add``.

- ``test_repair.py``'s chain-repair invariants, for the host repair through
  the native runtime and through the NumPy path (``native._load``
  monkeypatched): full reachability after one call, no new orphans,
  determinism, no-op on healthy graphs, many orphans, islands.
- With ``repair_orphans_device`` monkeypatched to do nothing in both
  packages, ``repair_orphans`` falls back to the host repair, and the
  port's adjacency equals the JAX package's, on each path (tolerance:
  none).
- With the device repair disabled, ``add`` into an index with orphans
  completes through the host repair, every row reachable and the degree
  bound kept (the port raised RuntimeError there before).
"""

import numpy as np
import pytest
import torch

from pgvectorscale_tpu import native as jnative
from pgvectorscale_tpu.graph import build as jbuild
from pgvectorscale_tpu.store import GraphArrays as JaxArrays
from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig, native
from pgvectorscale_tpu_torch.config import DistanceType
from pgvectorscale_tpu_torch.graph import build
from pgvectorscale_tpu_torch.store import INVALID_ID, GraphArrays


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    return request.param


def _mk(adj_np, count=None, start=0):
    cap = adj_np.shape[0]
    return GraphArrays(
        vectors=torch.zeros((cap, 4)), codes=torch.zeros((cap, 0), dtype=torch.int32),
        adjacency=torch.from_numpy(np.ascontiguousarray(adj_np, dtype=np.int32)),
        deleted=torch.zeros((cap,), dtype=torch.bool),
        count=cap if count is None else count, default_start=start,
        node_labels=torch.zeros((cap, 0), dtype=torch.int32),
        label_start_keys=torch.zeros((8,), dtype=torch.int32),
        label_start_ids=torch.zeros((8,), dtype=torch.int32),
        vec_scales=torch.ones((cap,)),
    )


def _mk_jax(adj_np, count, start=0):
    import jax.numpy as jnp

    cap = adj_np.shape[0]
    return JaxArrays(
        vectors=jnp.zeros((cap, 4), jnp.float32), codes=jnp.zeros((cap, 0), jnp.uint32),
        adjacency=jnp.asarray(adj_np, jnp.int32), node_labels=jnp.zeros((cap, 0), jnp.int32),
        deleted=jnp.zeros((cap,), jnp.bool_), count=jnp.asarray(count, jnp.int32),
        default_start=jnp.asarray(start, jnp.int32),
        label_start_keys=jnp.zeros((8,), jnp.int32), label_start_ids=jnp.zeros((8,), jnp.int32),
        vec_scales=jnp.ones((cap,), jnp.float32),
    )


def _rand_graph(rng, n, r, p_invalid):
    adj = rng.integers(0, n, size=(n, r), dtype=np.int32)
    adj[rng.random((n, r)) < p_invalid] = INVALID_ID
    return adj


def _reach(arrays):
    n = arrays.count
    return native.bfs_reachable(arrays.adjacency[:n].numpy(), arrays.default_start)


def _random_orphans(seed, n=400, r=6, k=30):
    rng = np.random.default_rng(seed)
    adj = _rand_graph(rng, n, r, 0.3)
    orphans = rng.choice(np.arange(1, n), size=k, replace=False)
    adj[np.isin(adj, orphans)] = INVALID_ID
    return adj


def test_host_repair_fixes_random_orphans(path):
    adj = _random_orphans(1)
    assert not native.bfs_reachable(adj, 0).all()
    before = native.bfs_reachable(adj, 0)
    repaired = build.repair_orphans_host(_mk(adj))
    after = _reach(repaired)
    assert after.all() and (after | ~before).all()
    assert torch.equal(repaired.adjacency, build.repair_orphans_host(_mk(adj.copy())).adjacency)


def test_host_repair_fixes_islands_and_many_orphans(path):
    n, r = 128, 4
    adj = np.full((n, r), INVALID_ID, np.int32)
    adj[:100, 0] = (np.arange(100) + 1) % 100  # core ring, start 0
    adj[100:110, 0] = 100 + (np.arange(10) + 1) % 10  # island 1
    adj[110:128, 0] = 110 + (np.arange(18) + 1) % 18  # island 2
    assert _reach(build.repair_orphans_host(_mk(adj))).all()
    n = 3000
    adj = np.full((n, 3), INVALID_ID, np.int32)
    adj[:40, 0] = (np.arange(40) + 1) % 40  # a tiny core; the rest isolated
    assert _reach(build.repair_orphans_host(_mk(adj))).all()


def test_host_repair_noop_when_healthy(path):
    n = 200
    adj = np.full((n, 5), INVALID_ID, np.int32)
    adj[:, 0] = (np.arange(n) + 1) % n
    arrays = _mk(adj)
    assert build.repair_orphans_host(arrays) is arrays
    empty = _mk(adj, count=0, start=INVALID_ID)
    assert build.repair_orphans_host(empty) is empty


def test_repair_orphans_falls_back_to_the_host_like_jax(path, monkeypatch):
    """Both packages with the device repair disabled: the same adjacency,
    over every row and over the first 280 (rows past ``count`` untouched;
    no edge below it leads past it, as in an index)."""
    monkeypatch.setattr(build, "repair_orphans_device", lambda a: a)
    monkeypatch.setattr(jbuild, "repair_orphans_device", lambda a: a)
    adj = _random_orphans(2, n=300, r=5, k=40)
    part = adj.copy()
    part[:280][part[:280] >= 280] = INVALID_ID
    for a, count in ((adj, 300), (part, 280)):
        got = build.repair_orphans(_mk(a, count=count))
        want = jbuild.repair_orphans(_mk_jax(a, count), None)
        np.testing.assert_array_equal(got.adjacency.numpy(), np.asarray(want.adjacency))
        assert _reach(got).all()
        np.testing.assert_array_equal(got.adjacency[count:].numpy(), a[count:])


def test_add_completes_through_the_host_repair(path, monkeypatch, caplog):
    """An index whose rows 50-59 lost every in-edge, with the device repair
    disabled: ``add`` repairs them on the host."""
    monkeypatch.setattr(build, "repair_orphans_device", lambda a: a)
    rng = np.random.default_rng(3)
    vectors = rng.standard_normal((460, 16)).astype(np.float32)
    config = IndexConfig(num_dimensions=16, distance_type=DistanceType.L2,
                         num_neighbors=10, search_list_size=16)
    index = DiskannIndex.build(vectors[:400], config, device="cpu")
    adj = index.arrays.adjacency.clone()
    adj[torch.isin(adj, torch.arange(50, 60, dtype=torch.int32))] = INVALID_ID
    index.arrays = index.arrays._replace(adjacency=adj)
    assert not _reach(index.arrays)[50:60].any()
    with caplog.at_level("WARNING", logger="pgvectorscale_tpu_torch"):
        index.add(vectors[400:])
    assert "falling back to the host repair path" in caplog.text
    assert _reach(index.arrays).all() and index.count == 460
    deg = (index.arrays.adjacency[: index.count] != INVALID_ID).sum(1)
    assert int(deg.max()) <= config.max_neighbors_during_build
