"""The PyTorch port's wave build against the JAX package.

- Build steps on identical state: with small-integer vectors and L2, every
  distance is exact in float32 in any summation order, so one wave step
  (beam or brute candidates, exact re-measure, prune, backlinks, overflow
  prune) and finalize give the same adjacency as JAX's (tolerance: none).
- A whole port-built index passes the invariants (full reachability,
  degree <= r_max, deterministic rebuild), and its recall@10 is within
  0.02 of the JAX build's at the same seed.  The share of edges the two
  graphs share is printed, not asserted: float32 sums in XLA and torch
  can flip near-ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgvectorscale_tpu import DiskannIndex as JaxIndex
from pgvectorscale_tpu import IndexConfig as JaxConfig
from pgvectorscale_tpu import store as jstore
from pgvectorscale_tpu.config import DistanceType as JaxDistance
from pgvectorscale_tpu.graph import build as jbuild
from pgvectorscale_tpu_torch import DiskannIndex, ExactIndex, IndexConfig, from_jax_state
from pgvectorscale_tpu_torch.config import DistanceType, StorageLayout
from pgvectorscale_tpu_torch.graph import build
from pgvectorscale_tpu_torch.io.datasets import synthetic_corpus


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def integer_l2():
    """A JAX-built L2 index over 900 x 32 vectors with entries in -3..3,
    and its state carried into the port."""
    rng = np.random.default_rng(5)
    base = rng.integers(-3, 4, (900, 32)).astype(np.float32)
    jidx = JaxIndex.build(base, JaxConfig(num_dimensions=32, distance_type=JaxDistance.L2))
    host = jstore.to_host(jidx.arrays)
    pidx = from_jax_state(host, jidx.sbq_stats, jidx.config, device="cpu")
    return jidx, pidx


def _wave_kwargs(cfg, ctx_alphas, brute, n):
    return dict(
        search_list_size=cfg.search_list_size,
        max_iters=jbuild._build_max_iters(cfg.search_list_size),
        brute=brute,
        slice_rows=n,
        distance_type=cfg.distance_type,
        alphas=ctx_alphas,
        num_neighbors=cfg.num_neighbors,
        trunc_dims=cfg.dims_to_index,
        prune_use_codes=False,
        code_bits=cfg.dims_to_index * cfg.bits_per_dimension,
    )


@pytest.mark.parametrize("brute", [False, True])
def test_wave_step_and_finalize_match_jax(integer_l2, brute):
    """Re-inserting 128 rows as one wave, then finalize: equal adjacency."""
    jidx, pidx = integer_l2
    n = pidx.count
    wave = np.arange(300, 428, dtype=np.int32)
    cfg = jidx.config
    alphas = jbuild._alpha_schedule(cfg.max_alpha)
    kw = _wave_kwargs(cfg, alphas, brute, n)
    jarrays = jidx.arrays
    jsnap = jbuild._edge_codes_onepass(jarrays.codes, jarrays.adjacency)
    want = jbuild._wave_step_jit(
        jarrays, jnp.asarray(wave), jnp.asarray(n, jnp.int32),
        snap_adjacency=None if brute else jarrays.adjacency,
        snap_edge_codes=None if brute else jsnap,
        use_codes=True, labeled=False, **kw,
    )
    parrays = pidx.arrays
    kw["distance_type"] = DistanceType.L2
    got = build._wave_step(
        parrays, torch.from_numpy(wave), n,
        None if brute else parrays.adjacency.clone(), **kw,
    )
    np.testing.assert_array_equal(got.adjacency.numpy(), np.asarray(want.adjacency))
    assert int((got.adjacency[:n] != -1).sum(1).max()) > cfg.num_neighbors

    want_f = jbuild.finalize(want, jbuild.BuildContext(jidx.config))
    got_f = build.finalize(got, pidx._ctx)
    np.testing.assert_array_equal(got_f.adjacency.numpy(), np.asarray(want_f.adjacency))


def test_append_backlinks_matches_jax(rng):
    """Random reverse edges into partly full rows (none lands on row 0,
    slot 0; see the next test): equal rows and acceptance flags."""
    cap, r_max = 60, 6
    adj = np.full((cap, r_max), -1, np.int32)
    deg = rng.integers(1, r_max + 1, cap)
    for i in range(cap):
        adj[i, : deg[i]] = rng.choice(cap, deg[i], replace=False)
    dst = rng.integers(-1, cap, 300).astype(np.int32)
    src = rng.integers(-1, cap, 300).astype(np.int32)
    jadj, jacc = jbuild.append_backlinks(jnp.asarray(adj), jnp.asarray(dst), jnp.asarray(src))
    padj, pacc = build.append_backlinks(torch.from_numpy(adj), torch.from_numpy(dst),
                                        torch.from_numpy(src))
    np.testing.assert_array_equal(padj.numpy(), np.asarray(jadj))
    np.testing.assert_array_equal(pacc.numpy(), np.asarray(jacc))


def test_append_backlinks_writes_every_accepted_edge():
    """An accepted edge into row 0, slot 0 is written even when another
    edge of the batch does not fit.  (The JAX package's scatter rewrites
    flat index 0 with its old value for every non-fitting edge, so on
    the CPU it loses this edge while reporting it accepted.)"""
    adj = np.full((4, 3), -1, np.int32)
    adj[1, 0] = 2
    dst = np.array([0, 1, 2, 3, -1], np.int32)
    src = np.array([3, 3, 3, 1, 5], np.int32)
    padj, pacc = build.append_backlinks(torch.from_numpy(adj), torch.from_numpy(dst),
                                        torch.from_numpy(src))
    assert pacc.tolist() == [True, True, True, True, False]
    assert padj[0].tolist() == [3, -1, -1]
    assert padj[1].tolist() == [2, 3, -1]


def test_repair_orphans_matches_jax(integer_l2):
    """Cut every in-edge of 40 nodes: the chain repair makes the same
    edges as JAX's and leaves every node reachable."""
    jidx, pidx = integer_l2
    adj = np.asarray(jidx.arrays.adjacency).copy()
    cut = np.arange(100, 140)
    adj[np.isin(adj, cut)] = -1
    jarr = jidx.arrays._replace(adjacency=jnp.asarray(adj))
    parr = pidx.arrays._replace(adjacency=torch.from_numpy(adj))
    assert int((~build.reachable_on_device(parr)[: pidx.count]).sum()) >= 40
    want = jbuild.repair_orphans_device(jarr)
    got = build.repair_orphans_device(parr)
    np.testing.assert_array_equal(got.adjacency.numpy(), np.asarray(want.adjacency))
    assert bool(build.reachable_on_device(got)[: pidx.count].all())


def test_dedup_and_brute_candidates_match_jax(integer_l2, rng):
    jidx, pidx = integer_l2
    ids = rng.integers(-1, 50, (20, 30)).astype(np.int32)
    d = rng.integers(0, 5, (20, 30)).astype(np.float32)
    want = jbuild._dedup_candidates(jnp.asarray(ids), jnp.asarray(d))
    got = build._dedup_candidates(torch.from_numpy(ids), torch.from_numpy(d))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    nodes = np.arange(0, 64, dtype=np.int32)
    want = jbuild._brute_candidates(
        jidx.arrays, jnp.asarray(nodes), jnp.asarray(500, jnp.int32), slice_rows=600,
        num_candidates=101, use_codes=False, distance_type=JaxDistance.L2, trunc_dims=32,
    )
    got = build._brute_candidates(
        pidx.arrays, torch.from_numpy(nodes), 500, slice_rows=600, num_candidates=101,
        distance_type=DistanceType.L2, trunc_dims=32, use_codes=False,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _recall(ids, gt):
    return float(np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(ids, gt)]))


def test_port_build_invariants_and_recall_vs_jax():
    """2,000 x 64 cosine build, default config: full reachability,
    degree <= r_max, identical on rebuild, recall@10 within 0.02 of the
    JAX build's."""
    base, queries = synthetic_corpus("glove", 2000, 60, seed=3)
    base, queries = base[:, :64].copy(), queries[:, :64].copy()
    config = IndexConfig(num_dimensions=64)
    pidx = DiskannIndex.build(base, config, device="cpu")
    n = pidx.count
    assert n == 2000
    assert bool(build.reachable_on_device(pidx.arrays)[:n].all())
    deg = (pidx.arrays.adjacency[:n] != -1).sum(1)
    assert int(deg.max()) <= config.max_neighbors_during_build and int(deg.min()) > 0
    again = DiskannIndex.build(base, config, device="cpu")
    assert torch.equal(again.arrays.adjacency, pidx.arrays.adjacency)

    jidx = JaxIndex.build(base, JaxConfig(num_dimensions=64))
    gt = ExactIndex.build(base, config, device="cpu").search(queries, 10)[0].numpy()
    p_recall = _recall(pidx.search(queries, 10, device="cpu")[0].numpy(), gt)
    j_recall = _recall(jidx.search(queries, 10)[0], gt)
    ja = np.asarray(jidx.arrays.adjacency)[:n]
    pa = pidx.arrays.adjacency[:n].numpy()
    shared = sum(len(set(a[a >= 0]) & set(b[b >= 0])) for a, b in zip(ja, pa))
    print(f"recall@10 port {p_recall:.4f} jax {j_recall:.4f}; "
          f"edges shared with JAX {shared / max(int((ja >= 0).sum()), 1):.4f}")
    assert abs(p_recall - j_recall) <= 0.02
    assert p_recall >= 0.8


def test_build_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiskannIndex.build(np.ones((10, 8), np.float32))


def test_build_rejects_what_the_port_does_not_build():
    """Every vector tier builds (int8 too, empty or not); labels without
    label room, rows of the wrong width and an int8 plain index are
    refused, as the JAX package refuses them."""
    v = np.ones((10, 8), np.float32)
    for n in (10, 0):
        index = DiskannIndex.build(v[:n], IndexConfig(num_dimensions=8, vector_dtype="int8"),
                                   device="cpu")
        assert index.arrays.vectors.dtype == torch.int8 and index.count == n
    with pytest.raises(ValueError, match="max_labels_per_vector"):
        DiskannIndex.build(v, IndexConfig(num_dimensions=8), labels=[[1]] * 10, device="cpu")
    with pytest.raises(ValueError, match="num_dimensions"):
        DiskannIndex.build(v, IndexConfig(num_dimensions=9), device="cpu")
    with pytest.raises(ValueError, match="requires SBQ"):
        IndexConfig(num_dimensions=8, vector_dtype="int8", storage_layout=StorageLayout.PLAIN)
