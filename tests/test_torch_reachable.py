"""The port's reachability BFS and device orphan repair against the JAX package.

On the CPU the port's ``_reachable_scatter`` and ``_reachable_csr`` (the
plain versions of ``ops.reachable``) and ``reachable_on_device`` (which
picks between them by capacity, as JAX's does; on the card it launches
``csrc/reachable.cu``) must equal JAX's ``_reachable_scatter``,
``_reachable_csr`` and ``reachable_on_device`` (tolerance: none; the
results are booleans) on the graphs of JAX's ``tests/test_repair.py``:
random graphs with 30-80% of the slots invalid, ``count < cap`` with stale
rows past it, ``start = -1``, and also ids past ``count`` and ``cap``,
islands and a 2,000-level chain.

``repair_orphans_device`` writes JAX's 256 rounds of chain links at once;
its adjacency must equal JAX's bit for bit with 1 round, several rounds
(more than 4,096 orphans) and at the 256-round cap (``_REPAIR_CHAIN_MAX``
monkeypatched to 8 in both packages, on a capacity no other test traces:
JAX's function is jitted and reads the constant when it is traced).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgvectorscale_tpu.graph import build as jbuild
from pgvectorscale_tpu.store import GraphArrays as JaxArrays
from pgvectorscale_tpu_torch.graph import build
from pgvectorscale_tpu_torch.ops import reachable as rc
from pgvectorscale_tpu_torch.store import INVALID_ID, GraphArrays


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _mk(adj, count, start):
    cap = adj.shape[0]
    return GraphArrays(
        vectors=torch.zeros((cap, 4)), codes=torch.zeros((cap, 0), dtype=torch.int32),
        adjacency=torch.from_numpy(np.ascontiguousarray(adj, dtype=np.int32)),
        deleted=torch.zeros((cap,), dtype=torch.bool), count=count, default_start=start,
        node_labels=torch.zeros((cap, 0), dtype=torch.int32),
        label_start_keys=torch.zeros((8,), dtype=torch.int32),
        label_start_ids=torch.zeros((8,), dtype=torch.int32), vec_scales=torch.ones((cap,)),
    )


def _mk_jax(adj, count, start):
    cap = adj.shape[0]
    return JaxArrays(
        vectors=jnp.zeros((cap, 4), jnp.float32), codes=jnp.zeros((cap, 0), jnp.uint32),
        adjacency=jnp.asarray(adj, jnp.int32), node_labels=jnp.zeros((cap, 0), jnp.int32),
        deleted=jnp.zeros((cap,), jnp.bool_), count=jnp.asarray(count, jnp.int32),
        default_start=jnp.asarray(start, jnp.int32),
        label_start_keys=jnp.zeros((8,), jnp.int32), label_start_ids=jnp.zeros((8,), jnp.int32),
        vec_scales=jnp.ones((cap,), jnp.float32),
    )


def _rand_graph(rng, n, r, p_invalid, high=None):
    adj = rng.integers(0, n if high is None else high, size=(n, r), dtype=np.int32)
    adj[rng.random((n, r)) < p_invalid] = INVALID_ID
    return adj


def _chain(levels, r, seed):
    """Rows 0..levels a chain (row i's first slot i + 1), every other slot
    back to an earlier row or -1: ``levels`` BFS rounds."""
    rng = np.random.default_rng(seed)
    n = levels + 1
    adj = (rng.integers(0, 2**30, (n, r)) % (np.arange(n)[:, None] + 1)).astype(np.int32)
    adj[rng.random((n, r)) < 0.3] = INVALID_ID
    adj[:-1, 0] = np.arange(1, n)
    adj[-1, 0] = INVALID_ID
    return adj


def _graph(case):
    rng = np.random.default_rng(case.get("seed", 0))
    kind = case["kind"]
    if kind == "random":
        adj = _rand_graph(rng, case["n"], case["r"], case["p"], case.get("high"))
    elif kind == "islands":
        n, half = case["n"], case["n"] // 2
        adj = _rand_graph(rng, n, case["r"], 0.3, half)
        adj[half:] = rng.integers(half, n, (n - half, case["r"]), dtype=np.int32)
        adj[half:][rng.random((n - half, case["r"])) < 0.3] = INVALID_ID
    else:
        adj = _chain(case["levels"], case["r"], case.get("seed", 0))
    return adj, case.get("count", adj.shape[0]), case.get("start", 0)


BFS_CASES = {
    # tests/test_repair.py:51-62 (30-80% of the slots invalid)
    "257x4 p0.3": dict(kind="random", n=257, r=4, p=0.3, seed=257),
    "1024x7 p0.6": dict(kind="random", n=1024, r=7, p=0.6, seed=1024),
    "313x2 p0.8": dict(kind="random", n=313, r=2, p=0.8, seed=313),
    # :65-80: stale rows past count, then an empty graph
    "count 40 of 64": dict(kind="random", n=64, r=3, p=0.2, count=40),
    "empty, start -1": dict(kind="random", n=64, r=3, p=0.2, count=0, start=-1),
    "start -1": dict(kind="random", n=64, r=3, p=0.2, start=-1),
    "start past count": dict(kind="random", n=64, r=3, p=0.2, count=30, start=45),
    "ids past cap": dict(kind="random", n=200, r=5, p=0.4, high=260, count=180, seed=5),
    "islands": dict(kind="islands", n=160, r=4, seed=7, start=3),
    "2000-level chain": dict(kind="chain", levels=2000, r=4, seed=9),
}


@pytest.mark.parametrize("name", list(BFS_CASES))
def test_bfs_strategies_match_jax(name):
    adj, count, start = _graph(BFS_CASES[name])
    jarr, parr = _mk_jax(adj, count, start), _mk(adj, count, start)
    want = np.asarray(jbuild._reachable_scatter(jarr))
    np.testing.assert_array_equal(np.asarray(jbuild._reachable_csr(jarr)), want)
    np.testing.assert_array_equal(build._reachable_scatter(parr).numpy(), want)
    np.testing.assert_array_equal(build._reachable_csr(parr).numpy(), want)
    if name == "2000-level chain":
        assert want.all()
    if start < 0 or start >= count:
        assert not want.any()


@pytest.mark.parametrize("side", ["csr", "scatter"])
@pytest.mark.parametrize("name", ["257x4 p0.3", "count 40 of 64", "islands", "2000-level chain"])
def test_reachable_on_device_picks_by_capacity_as_jax(monkeypatch, name, side):
    """With ``_CSR_BFS_MIN_CAP`` at the capacity a CPU adjacency takes the
    CSR pull-BFS, one above it the scatter BFS; both equal JAX's
    ``reachable_on_device``."""
    adj, count, start = _graph(BFS_CASES[name])
    cap = adj.shape[0]
    monkeypatch.setattr(build, "_CSR_BFS_MIN_CAP", cap if side == "csr" else cap + 1)
    taken = []
    for fn in ("reachable_csr_plain", "reachable_scatter_plain"):
        real = getattr(rc, fn)
        monkeypatch.setattr(rc, fn, lambda *a, real=real, fn=fn: taken.append(fn) or real(*a))
    got = build.reachable_on_device(_mk(adj, count, start))
    assert taken == [f"reachable_{side}_plain"]
    want = np.asarray(jbuild.reachable_on_device(_mk_jax(adj, count, start)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_reachable_on_device_default_threshold_is_jax_default():
    assert build._CSR_BFS_MIN_CAP == rc.CSR_BFS_MIN_CAP == jbuild._CSR_BFS_MIN_CAP == 300_000
    assert rc.reachable(torch.zeros((3, 2), dtype=torch.int32), 3, 0).tolist() == [
        True, False, False]


def _cut(adj, victims):
    adj = adj.copy()
    adj[np.isin(adj, victims)] = INVALID_ID
    return adj


REPAIR_CASES = {
    # 30 orphans as JAX's test_chain_repair_fixes_random_orphans: one round
    "400x6, 30 cut": dict(n=400, r=6, cut=30, seed=1),
    # the start's last slot empty: no edge to re-home
    "400x6, 30 cut, start's last slot -1": dict(n=400, r=6, cut=30, seed=2, empty_last=True),
    # stale rows past count, a start other than 0
    "count 300 of 400, start 17": dict(n=400, r=6, cut=25, seed=3, count=300, start=17),
    # more than 4,096 orphans: two rounds
    "6000x4, 4500 cut": dict(n=6000, r=4, cut=4500, seed=4),
    # a ring through every row: nothing to repair
    "healthy": dict(n=300, r=6, cut=0, seed=5, ring=True),
    # a start past count (below cap): every row below count is an orphan,
    # two rounds, the entry written into a stale row
    "6000x4, count 5000, start 5500": dict(n=6000, r=4, cut=0, seed=7, count=5000,
                                           start=5500),
    # a start past the table: JAX drops the entry write and every round
    # reads the clamped row cap - 1
    "6000x4, start past the table": dict(n=6000, r=4, cut=0, seed=8, start=6100),
}


def _repair_graph(case):
    rng = np.random.default_rng(case["seed"])
    n, count, start = case["n"], case.get("count", case["n"]), case.get("start", 0)
    adj = _rand_graph(rng, n, case["r"], 0.3, count)
    if start >= n:  # the last row's last slot, which every round re-homes
        adj[-1, -1] = 17
    pool = np.setdiff1d(np.arange(count), [start])
    adj = _cut(adj, rng.choice(pool, size=case["cut"], replace=False))
    if case.get("ring"):
        adj[:, 0] = (np.arange(n) + 1) % n
    if case.get("empty_last"):
        adj[start, -1] = INVALID_ID
    return adj, count, start


def _both_repairs(adj, count, start):
    want = jbuild.repair_orphans_device(_mk_jax(adj, count, start))
    got = build.repair_orphans_device(_mk(adj, count, start))
    return got.adjacency.numpy(), np.asarray(want.adjacency)


@pytest.mark.parametrize("name", list(REPAIR_CASES))
def test_repair_orphans_device_matches_jax(name):
    case = REPAIR_CASES[name]
    adj, count, start = _repair_graph(case)
    orphans = int((~build.reachable_on_device(_mk(adj, count, start))[:count]).sum())
    assert orphans >= case["cut"]
    if name.startswith("6000"):
        assert orphans > build._REPAIR_CHAIN_MAX
    got, want = _both_repairs(adj, count, start)
    np.testing.assert_array_equal(got, want)
    if start >= count:  # nothing is reachable from a start past count: all chained
        assert int((got[:count, -1] != adj[:count, -1]).sum()) > count // 2
        return
    repaired = _mk(got, count, start)
    assert bool(build.reachable_on_device(repaired)[:count].all())
    if case["cut"] == 0:
        np.testing.assert_array_equal(got, adj)


def test_repair_orphans_device_stops_at_256_rounds_as_jax(monkeypatch):
    """With 8 orphans a round, 2,300 orphans take more than 256 rounds:
    both packages chain the first 2,048 and leave the rest."""
    monkeypatch.setattr(build, "_REPAIR_CHAIN_MAX", 8)
    monkeypatch.setattr(jbuild, "_REPAIR_CHAIN_MAX", 8)
    rng = np.random.default_rng(6)
    n, r = 2333, 3  # a capacity no other test traces JAX's repair at
    adj = _cut(_rand_graph(rng, n, r, 0.3), rng.choice(np.arange(1, n), 2300, replace=False))
    got, want = _both_repairs(adj, n, 0)
    np.testing.assert_array_equal(got, want)
    left = int((~build.reachable_on_device(_mk(got, n, 0))).sum())
    assert 0 < left <= n - 1 - 256 * 8
    assert int((got != adj).sum()) > 2000


def test_repair_orphans_device_noop_without_start():
    adj = _rand_graph(np.random.default_rng(8), 50, 3, 0.5)
    arrays = _mk(adj, 0, -1)
    assert build.repair_orphans_device(arrays) is arrays
