"""The port's native host graph runtime (``native/``, its own copy of
``host_graph.cc``): the port's versions of ``test_native.py``, each
routine against the JAX package's ``native`` on the same graphs, and the
NumPy paths (the library disabled by monkeypatching ``native._load``)
against the C++ ones.  Integer outputs: tolerance none."""

import os

import numpy as np
import pytest

from pgvectorscale_tpu import native as jnative
from pgvectorscale_tpu_torch import native


def _random_adj(rng, n=200, r=8, p_valid=0.6):
    adj = rng.integers(0, n, size=(n, r)).astype(np.int32)
    adj[rng.random((n, r)) > p_valid] = -1
    return adj


@pytest.fixture
def numpy_path(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)


def test_native_library_builds():
    """g++ is present, so the library builds into the port's own
    (gitignored) build directory, not beside the JAX package's."""
    assert native.available(), "g++ toolchain present; library must build"
    libs = [f for f in os.listdir(native.BUILD_DIR) if f.endswith(".so")]
    assert libs and all(f.startswith("libpgvs_host_") for f in libs)
    assert os.path.dirname(native._lib._name) == str(native.BUILD_DIR)


def test_bfs_matches_python_and_jax(rng):
    from collections import deque

    adj = _random_adj(rng)
    n = adj.shape[0]
    seen = np.zeros(n, dtype=bool)
    seen[0] = True
    dq = deque([0])
    while dq:
        u = dq.popleft()
        for v in adj[u]:
            if v >= 0 and not seen[v]:
                seen[v] = True
                dq.append(int(v))
    got = native.bfs_reachable(adj, 0)
    np.testing.assert_array_equal(got, seen)
    np.testing.assert_array_equal(got, jnative.bfs_reachable(adj, 0))


def test_repair_orphans_connects_everything_as_jax(rng):
    n, r = 300, 6
    adj = _random_adj(rng, n=n, r=r, p_valid=0.3)
    adj[200:250] = -1  # disconnect a chunk entirely
    want = adj.copy()
    forced = native.repair_orphans_inplace(adj, 0)
    assert forced > 0
    assert native.bfs_reachable(adj, 0).all()
    assert jnative.repair_orphans_inplace(want, 0) == forced
    np.testing.assert_array_equal(adj, want)
    with pytest.raises(TypeError):
        native.repair_orphans_inplace(adj.astype(np.int64), 0)


def test_degrees(rng):
    adj = _random_adj(rng)
    np.testing.assert_array_equal(native.degrees(adj), (adj != -1).sum(axis=1))
    np.testing.assert_array_equal(
        native.in_degrees(adj), np.bincount(adj[adj >= 0], minlength=adj.shape[0]))


def test_csr_roundtrip(rng):
    adj = _random_adj(rng)
    indptr, indices = native.to_csr(adj)
    assert indptr[-1] == (adj != -1).sum()
    for i in range(adj.shape[0]):
        np.testing.assert_array_equal(indices[indptr[i] : indptr[i + 1]], adj[i][adj[i] != -1])


def test_numpy_paths_match_native(rng, numpy_path):
    adj = _random_adj(rng, n=257, r=5, p_valid=0.4)
    assert not native.available()
    want_csr = jnative.to_csr(adj)
    for start in (0, 17, -1):
        np.testing.assert_array_equal(native.bfs_reachable(adj, start),
                                      jnative.bfs_reachable(adj, start))
    np.testing.assert_array_equal(native.degrees(adj), jnative.degrees(adj))
    np.testing.assert_array_equal(native.in_degrees(adj), jnative.in_degrees(adj))
    for got, want in zip(native.to_csr(adj), want_csr):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        native.repair_orphans_inplace(adj, 0)
