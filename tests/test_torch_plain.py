"""Full-precision traversal, refinement and the build options of the port
against the JAX package: SBQ indexes built with ``build_distance="exact"``
and plain-storage indexes.

- Exact parity needs exact arithmetic: the vectors hold integers in -3..3
  and the distance is L2, so every distance is an integer in float32
  whatever the summation order, and the port's wave steps, refinement
  waves, whole builds with ``refine_passes=1`` and adds give JAX's
  adjacency exactly (tolerance: none).  Searches: ids equal, distances
  within 1e-5.
- The brute-force threshold is lowered to 256 rows in both packages, as in
  ``test_torch_lifecycle.py``, so 700-row builds and adds reach the
  full-precision beam waves.
- The JAX side writes reverse edges without its known row-0 fault
  (ROADMAP.md, "Faults found in the port against the reference"): its
  ``append_backlinks`` sends every non-fitting edge's no-op write to flat
  index 0, so a backlink into the empty row of the start node is lost,
  and every whole build starts with that row empty.  For this module
  ``graph.build.append_backlinks`` is replaced by the same function with
  non-fitting edges written out of range and dropped, which is what the
  port does (``test_torch_build.py::test_append_backlinks_writes_every_accepted_edge``);
  JAX's trace caches are cleared around the replacement.
- The port's versions of ``test_index.py``'s plain recall gate, plain
  Matryoshka test and refinement test hold against the port's
  ``ExactIndex``.
- Checkpoints of plain and "exact"-built indexes cross-load both ways
  with every saved array equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pgvectorscale_tpu.index as jindex_mod
from pgvectorscale_tpu import DiskannIndex as JaxIndex
from pgvectorscale_tpu import IndexConfig as JaxConfig
from pgvectorscale_tpu import QueryParams as JaxParams
from jax import lax

from pgvectorscale_tpu import store as jstore
from pgvectorscale_tpu.config import DistanceType as JaxDistance
from pgvectorscale_tpu.config import StorageLayout as JaxLayout
from pgvectorscale_tpu.graph import build as jbuild
from pgvectorscale_tpu.graph import search as jsearch
import pgvectorscale_tpu_torch.index as pindex_mod
from pgvectorscale_tpu_torch import DiskannIndex, ExactIndex, IndexConfig, QueryParams, from_jax_state
from pgvectorscale_tpu_torch.config import DistanceType, StorageLayout
from pgvectorscale_tpu_torch.graph import build, search

N, D, R, L = 700, 32, 16, 32
DEFAULT_THRESHOLD = build.BRUTE_CANDIDATE_THRESHOLD
PLAIN_INDEXED = 24  # the plain fixture indexes a prefix: traversal on 24 dims


def _append_backlinks_dropping_misfits(adjacency, edge_dst, edge_src):
    """JAX's ``append_backlinks`` with one change: edges that do not fit
    are written to an out-of-range index and dropped, instead of writing
    flat index 0's old value back over a fitting edge."""
    cap, r_max = adjacency.shape
    e = edge_dst.shape[0]
    valid = (edge_src != -1) & (edge_dst != -1) & (edge_src != edge_dst)
    dst = jnp.where(valid, edge_dst, jnp.int32(2**31 - 1))
    idx = jnp.arange(e, dtype=jnp.int32)
    s_dst, s_src, s_valid, order = lax.sort((dst, edge_src, valid, idx), num_keys=2)
    is_start = jnp.concatenate([jnp.ones((1,), jnp.bool_), s_dst[1:] != s_dst[:-1]])
    safe_dst = jnp.clip(s_dst, 0, cap - 1)
    rows = adjacency[safe_dst]
    already = jnp.any(rows == s_src[:, None], axis=1)
    s_valid = s_valid & ~already
    dup = jnp.concatenate([jnp.zeros((1,), jnp.bool_),
                           (s_dst[1:] == s_dst[:-1]) & (s_src[1:] == s_src[:-1])]) & s_valid
    s_valid = s_valid & ~dup
    grp = jnp.where(s_valid, 1, 0)
    run_prefix = jnp.cumsum(grp) - grp
    run_base = lax.associative_scan(jnp.maximum, jnp.where(is_start, run_prefix, 0))
    pos = jnp.sum(rows != -1, axis=1) + run_prefix - run_base
    fits = s_valid & (pos < r_max)
    write_idx = jnp.where(fits, safe_dst * r_max + jnp.clip(pos, 0, r_max - 1), cap * r_max)
    flat = adjacency.reshape(-1).at[write_idx].set(s_src, mode="drop")
    accepted = jnp.zeros((e,), jnp.bool_).at[order].set(fits | already | dup)
    return flat.reshape(cap, r_max), accepted


@pytest.fixture(autouse=True, scope="module")
def _setup():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jbuild, jindex_mod, build, pindex_mod):
            mp.setattr(mod, "BRUTE_CANDIDATE_THRESHOLD", 256)
        mp.setattr(jbuild, "append_backlinks", _append_backlinks_dropping_misfits)
        jax.clear_caches()
        yield
    jax.clear_caches()
    torch.set_num_threads(prev)


def test_backlink_writer_matches_the_port(rng):
    """The replacement writer equals the port's ``append_backlinks`` on
    random edges, with an edge into the empty row 0, slot 0 among them."""
    cap, r_max = 60, 6
    adj = np.full((cap, r_max), -1, np.int32)
    deg = rng.integers(1, r_max + 1, cap)
    for i in range(1, cap):
        adj[i, : deg[i]] = rng.choice(cap, deg[i], replace=False)
    dst = np.concatenate([[0], rng.integers(-1, cap, 299)]).astype(np.int32)
    src = rng.integers(-1, cap, 300).astype(np.int32)
    src[0] = 5
    want = jax.jit(_append_backlinks_dropping_misfits)(*map(jnp.asarray, (adj, dst, src)))
    got = build.append_backlinks(*map(torch.from_numpy, (adj, dst, src)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0][0, 0]) == 5


def _int_vectors(n, seed):
    return np.random.default_rng(seed).integers(-3, 4, (n, D)).astype(np.float32)


def _jax_config(mode):
    if mode == "plain":
        return JaxConfig(num_dimensions=D, distance_type=JaxDistance.L2, num_neighbors=R,
                         search_list_size=L, storage_layout=JaxLayout.PLAIN,
                         num_dimensions_to_index=PLAIN_INDEXED)
    return JaxConfig(num_dimensions=D, distance_type=JaxDistance.L2, num_neighbors=R,
                     search_list_size=L, build_distance=mode)


def _carry(jidx):
    return from_jax_state(jstore.to_host(jidx.arrays), jidx.sbq_stats, jidx.config,
                          external_ids=jidx.external_ids, device="cpu")


@pytest.fixture(scope="module")
def built():
    """JAX builds (refine_passes=1) of 700 integer vectors: an SBQ index
    built "exact" and a plain one, each with the port's copy."""
    base = _int_vectors(N, 5)
    out = {}
    for mode in ("exact", "plain"):
        jidx = JaxIndex.build(base, _jax_config(mode), refine_passes=1)
        out[mode] = (jidx, _carry(jidx))
    return base, out


def _assert_same_state(pidx, jidx):
    n = jidx.count
    host = jstore.to_host(jidx.arrays)
    assert pidx.count == n and pidx.arrays.default_start == int(host.default_start)
    np.testing.assert_array_equal(pidx.arrays.vectors[:n].numpy(), host.vectors[:n])
    np.testing.assert_array_equal(pidx.arrays.codes[:n].numpy().view(np.uint32), host.codes[:n])
    np.testing.assert_array_equal(pidx.arrays.adjacency[:n].numpy(), host.adjacency[:n])
    np.testing.assert_array_equal(pidx.external_ids, jidx.external_ids)


@pytest.mark.parametrize("jd,pd", [(JaxDistance.L2, DistanceType.L2),
                                   (JaxDistance.COSINE, DistanceType.COSINE),
                                   (JaxDistance.INNER_PRODUCT, DistanceType.INNER_PRODUCT)])
def test_candidate_distances_full_precision_match_jax(built, jd, pd):
    """Traversal's full-precision branch on a truncated prefix (24 of 32
    dims), with invalid ids among the candidates (tolerance: none)."""
    _, out = built
    jidx, pidx = out["exact"]
    rng = np.random.default_rng(1)
    qv = rng.integers(-3, 4, (20, PLAIN_INDEXED)).astype(np.float32)
    ids = rng.integers(-1, N, (20, 40)).astype(np.int32)
    want = jsearch._candidate_distances(
        jidx.arrays, jnp.asarray(qv), jnp.zeros((20, 0), jnp.uint32), jnp.asarray(ids),
        use_codes=False, distance_type=jd,
    )
    got = search._candidate_distances(
        pidx.arrays, torch.from_numpy(qv), torch.zeros((20, 0), dtype=torch.int32),
        torch.from_numpy(ids), use_codes=False, distance_type=pd,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["exact", "plain"])
def test_full_precision_wave_step_matches_jax(built, mode):
    """Re-inserting 128 rows as one searched wave over the live graph
    (full-precision traversal, prune and overflow prune), then finalize:
    equal adjacency, and the wave overflowed some row."""
    _, out = built
    jidx, pidx = out[mode]
    cfg = jidx.config
    wave = np.arange(300, 428, dtype=np.int32)
    kw = dict(
        search_list_size=L, max_iters=jbuild._build_max_iters(L), brute=False,
        slice_rows=N, alphas=jbuild._alpha_schedule(cfg.max_alpha), num_neighbors=R,
        trunc_dims=cfg.dims_to_index, prune_use_codes=False,
        code_bits=cfg.dims_to_index * cfg.bits_per_dimension,
    )
    want = jbuild._wave_step_jit(
        jidx.arrays, jnp.asarray(wave), jnp.asarray(N, jnp.int32), use_codes=False,
        labeled=False, distance_type=JaxDistance.L2, **kw,
    )
    got = build._wave_step(pidx.arrays, torch.from_numpy(wave), N, None, use_codes=False,
                           distance_type=DistanceType.L2, **kw)
    np.testing.assert_array_equal(got.adjacency.numpy(), np.asarray(want.adjacency))
    assert int((got.adjacency[:N] != -1).sum(1).max()) > R
    want_f = jbuild.finalize(want, jbuild.BuildContext(cfg))
    got_f = build.finalize(got, pidx._ctx)
    np.testing.assert_array_equal(got_f.adjacency.numpy(), np.asarray(want_f.adjacency))


@pytest.mark.parametrize("mode", ["exact-prune", "storage", "exact", "plain"])
def test_refine_wave_matches_jax(built, mode):
    """One refinement wave (n_existing=None, include_existing=True) of 200
    rows padded to 256 through ``insert_wave``: traversal on codes over a
    snapshot (exact-prune, storage) or in full precision over the live
    graph (exact, plain); equal adjacency."""
    _, out = built
    jidx, pidx = out["plain" if mode == "plain" else "exact"]
    jcfg = _jax_config(mode)
    pcfg = IndexConfig.from_dict(jcfg.to_dict())
    ids = np.full(256, -1, np.int32)
    ids[:200] = np.arange(150, 350)
    jarr = jidx.arrays
    snap = None if mode == "plain" else jbuild.build_wave_cache(jarr)
    want = jbuild.insert_wave(
        jarr, jbuild.BuildContext(jcfg), ids, n_existing=None, include_existing=True,
        snap_adjacency=jarr.adjacency, snap_edge_codes=snap,
    )
    got = build.insert_wave(
        pidx.arrays, build.BuildContext(pcfg), torch.from_numpy(ids), n_real=200,
        include_existing=True, snap_adjacency=pidx.arrays.adjacency.clone(),
    )
    np.testing.assert_array_equal(got.adjacency.numpy(), np.asarray(want.adjacency))
    assert not torch.equal(got.adjacency, pidx.arrays.adjacency)


@pytest.mark.parametrize("mode", ["exact", "plain"])
def test_build_with_refine_pass_matches_jax(built, mode):
    """The whole build with refine_passes=1 (brute seed wave, full-precision
    searched waves, finalize, one refinement pass, finalize): JAX's graph
    (tolerance: none); every row reachable."""
    base, out = built
    jidx, _ = out[mode]
    pidx = DiskannIndex.build(base, IndexConfig.from_dict(jidx.config.to_dict()),
                              refine_passes=1, device="cpu")
    np.testing.assert_array_equal(pidx.arrays.adjacency.numpy(),
                                  np.asarray(jidx.arrays.adjacency))
    if mode == "plain":
        assert pidx.arrays.codes.shape == (pidx.arrays.capacity, 0)
        assert pidx.sbq_stats.count == 0
    assert bool(build.reachable_on_device(pidx.arrays)[:N].all())


def test_build_options_match_jax(built):
    """initial_wave=128, max_wave=256 and a quantizer trained elsewhere
    (sbq_stats: no training pass) on an exact-prune build: JAX's codes
    and graph (encoding is elementwise, every distance an integer)."""
    _, out = built
    stats = out["exact"][0].sbq_stats  # trained on other rows
    base = _int_vectors(N, 6)
    cfg = _jax_config("exact-prune")
    kw = dict(initial_wave=128, max_wave=256)
    jidx = JaxIndex.build(base, cfg, sbq_stats=stats, **kw)
    pidx = DiskannIndex.build(base, IndexConfig.from_dict(cfg.to_dict()), sbq_stats=stats,
                              device="cpu", **kw)
    _assert_same_state(pidx, jidx)
    np.testing.assert_array_equal(pidx.sbq_stats.mean.numpy(), np.asarray(stats.mean))
    np.testing.assert_array_equal(pidx.sbq_stats.m2.numpy(), np.asarray(stats.m2))
    assert pidx.sbq_stats.count == int(stats.count)


@pytest.mark.parametrize("mode", ["exact", "plain"])
def test_add_matches_jax(built, tmp_path, mode):
    """add 300 rows (searched full-precision waves), delete 40, add 60
    (40 onto tombstones): JAX's state after each step."""
    _, out = built
    jidx0, _ = out[mode]
    jidx0.save(str(tmp_path / "j"))
    jidx = JaxIndex.load(str(tmp_path / "j"))  # a copy the test may change
    pidx = _carry(jidx)
    extra = _int_vectors(360, 7)
    np.testing.assert_array_equal(pidx.add(extra[:300]), jidx.add(extra[:300]))
    _assert_same_state(pidx, jidx)
    doomed = np.arange(10, 410, 10)
    jidx.delete(doomed)
    pidx.delete(doomed)
    np.testing.assert_array_equal(pidx.add(extra[300:]), jidx.add(extra[300:]))
    _assert_same_state(pidx, jidx)
    assert bool(build.reachable_on_device(pidx.arrays)[: pidx.count].all())


@pytest.mark.parametrize("mode", ["exact", "plain"])
def test_checkpoints_cross_load(built, tmp_path, mode):
    """A JAX save loads in the port and a port save in JAX, every saved
    array equal; both packages then search alike ("beam", "scored" and
    the default window; ids equal, distances within 1e-5)."""
    base, out = built
    jidx, pidx = out[mode]
    jidx.save(str(tmp_path / "j"))
    pidx.save(tmp_path / "p")
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "p.npz") as zp:
        assert sorted(zj.files) == sorted(zp.files)
        for f in zj.files:
            np.testing.assert_array_equal(zp[f], zj[f], err_msg=f)
    from_j = DiskannIndex.load(tmp_path / "j", device="cpu")
    from_p = JaxIndex.load(str(tmp_path / "p"))
    assert from_j.config == pidx.config and from_p.config == jidx.config
    queries = _int_vectors(30, 8)
    for strat in ("expand", "beam", "scored"):
        for rescore in (0, 100):
            jp = JaxParams(search_list_size=L, rescore=rescore, window_strategy=strat)
            pp = QueryParams(search_list_size=L, rescore=rescore, window_strategy=strat)
            jids, jd = from_p.search(queries, 10, jp)
            ids, d = from_j.search(queries, 10, pp, device="cpu")
            np.testing.assert_array_equal(ids.numpy(), jids)
            np.testing.assert_allclose(d.numpy(), jd, atol=1e-5, rtol=0)


def _recall(ids, gt):
    return float(np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(ids, gt)]))


@pytest.fixture
def default_threshold(monkeypatch):
    """The brute-force threshold at its default, as the JAX tests run."""
    for mod in (build, pindex_mod):
        monkeypatch.setattr(mod, "BRUTE_CANDIDATE_THRESHOLD", DEFAULT_THRESHOLD)


def test_recall_gate_plain(rng, default_threshold):
    """The port's ``test_index.py::test_recall_gate_plain``: 1,000 x 64 L2,
    plain storage, recall@10 >= 0.9 at the defaults."""
    n, d, q = 1000, 64, 50
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.L2,
                         storage_layout=StorageLayout.PLAIN)
    index = DiskannIndex.build(vectors, config, device="cpu")
    gt = ExactIndex.build(vectors, config, device="cpu").search(queries, 10)[0].numpy()
    recall = _recall(index.search(queries, 10, device="cpu")[0].numpy(), gt)
    assert recall >= 0.9, recall


def test_matryoshka_truncated_dims_plain(rng, default_threshold):
    """The port's ``test_index.py::test_matryoshka_truncated_dims_plain``:
    traversal on the indexed prefix, rescore on the full vector; without
    rescore the distances are the prefix's."""
    n, d, dt = 600, 64, 32
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    vectors[:, dt:] *= 0.05
    queries = rng.standard_normal((20, d)).astype(np.float32)
    queries[:, dt:] *= 0.05
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.L2,
                         storage_layout=StorageLayout.PLAIN, num_dimensions_to_index=dt)
    index = DiskannIndex.build(vectors, config, device="cpu")
    gt = ExactIndex.build(vectors, config, device="cpu").search(queries, 10)[0].numpy()
    ids, dists = index.search(queries, 10, device="cpu")
    assert _recall(ids.numpy(), gt) >= 0.9
    nid = int(ids[0, 0])
    np.testing.assert_allclose(float(dists[0, 0]),
                               float(((vectors[nid] - queries[0]) ** 2).sum()), rtol=1e-4)
    ids0, dists0 = index.search(queries, 5, QueryParams(rescore=0), device="cpu")
    nid0 = int(ids0[0, 0])
    np.testing.assert_allclose(float(dists0[0, 0]),
                               float(((vectors[nid0, :dt] - queries[0, :dt]) ** 2).sum()),
                               rtol=1e-4)


def test_refine_pass_preserves_quality(rng, default_threshold):
    """The port's ``test_index.py::test_refine_pass_preserves_quality``:
    a refinement pass keeps every row reachable and does not lower
    recall@10 by more than 0.005."""
    n, d, rank = 800, 64, 32
    basis = rng.standard_normal((rank, d)).astype(np.float32)
    vectors = rng.standard_normal((n, rank)).astype(np.float32) @ basis
    queries = rng.standard_normal((20, rank)).astype(np.float32) @ basis
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.COSINE,
                         num_neighbors=20, search_list_size=50)
    base = DiskannIndex.build(vectors, config, device="cpu")
    refined = DiskannIndex.build(vectors, config, refine_passes=1, device="cpu")
    assert bool(build.reachable_on_device(refined.arrays)[:n].all())
    assert not torch.equal(base.arrays.adjacency, refined.arrays.adjacency)
    gt = ExactIndex.build(vectors, config, device="cpu").search(queries, 10)[0].numpy()
    r0 = _recall(base.search(queries, 10, device="cpu")[0].numpy(), gt)
    r1 = _recall(refined.search(queries, 10, device="cpu")[0].numpy(), gt)
    assert r1 >= r0 - 0.005, (r0, r1)
