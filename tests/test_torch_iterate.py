"""The streaming iterator of the port (``graph/iterate.py``,
``DiskannIndex.search_iter``, ``SearchIterator``) against the JAX package.

The indexes are JAX builds carried to the port (``from_jax_state``), so
both packages traverse the same graph:

- an f32 SBQ index and an int8 SBQ index (cosine, 300 x 32 random rows),
  traversed on their codes (Hamming: integers), so ``init_state``,
  ``iter_step``, ``reseed`` and ``first_unseen`` give JAX's state and
  emissions exactly (tolerance: none);
- a plain L2 index of integer rows in -3..3, traversed in full precision:
  every distance an integer, exact too.

``SearchIterator`` streams (the rescore buffer over the exact distances)
return JAX's ids exactly and distances within 1e-5 (float32 sums in two
orders; every distance is at most 4 on the cosine indexes and an integer
on the L2 one).  The port's counterparts of
``tests/test_streaming.py::test_iterator_no_duplicates_full_scan`` and
``tests/test_aux.py::test_streaming_stats_populated`` hold, and the
label-filtered restart fallback streams JAX's ids.  The block-masked
expansion (``step_block``) equals a one-step-at-a-time run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgvectorscale_tpu import DiskannIndex as JaxIndex
from pgvectorscale_tpu import IndexConfig as JaxConfig
from pgvectorscale_tpu import QueryParams as JaxParams
from pgvectorscale_tpu import store as jstore
from pgvectorscale_tpu.config import DistanceType as JaxDistance
from pgvectorscale_tpu.config import StorageLayout as JaxLayout
from pgvectorscale_tpu.distance import preprocess_cosine as jpreprocess
from pgvectorscale_tpu.graph import iterate as jiterate
from pgvectorscale_tpu.graph.search import get_start_ids as jstart_ids
from pgvectorscale_tpu.ops import sbq as jsbq
from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig, QueryParams, from_jax_state
from pgvectorscale_tpu_torch.config import DistanceType
from pgvectorscale_tpu_torch.distance import preprocess_query
from pgvectorscale_tpu_torch.graph import iterate
from pgvectorscale_tpu_torch.graph.search import get_start_ids
from pgvectorscale_tpu_torch.ops import sbq

KINDS = ("f32", "int8", "plain")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _carry(jidx):
    return from_jax_state(jstore.to_host(jidx.arrays), jidx.sbq_stats, jidx.config,
                          external_ids=jidx.external_ids, device="cpu")


@pytest.fixture(scope="module")
def built():
    """kind -> (JAX index, its port copy, the rows)."""
    rng = np.random.default_rng(21)
    out = {}
    for kind in KINDS:
        if kind == "plain":
            rows = rng.integers(-3, 4, (300, 32)).astype(np.float32)
            cfg = JaxConfig(num_dimensions=32, distance_type=JaxDistance.L2,
                            num_neighbors=16, search_list_size=32,
                            storage_layout=JaxLayout.PLAIN)
        else:
            rows = rng.standard_normal((300, 32)).astype(np.float32)
            cfg = JaxConfig(num_dimensions=32, num_neighbors=16, search_list_size=32,
                            vector_dtype=kind)
        jidx = JaxIndex.build(rows, cfg)
        out[kind] = (jidx, _carry(jidx), rows)
    return out


def _query_forms(jidx, pidx, query):
    """(JAX qv, qc, start), (port qv, qc, start) for one raw query."""
    cfg = jidx.config
    jq = jnp.asarray(query[None, :])
    if cfg.distance_type == JaxDistance.COSINE:
        jq = jpreprocess(jq)
    jqv = jq[0, : cfg.dims_to_index]
    pqv = preprocess_query(torch.from_numpy(query[None, :]),
                           pidx.config.distance_type)[0, : cfg.dims_to_index]
    if cfg.uses_sbq:
        jqc = jsbq.encode(jqv[None, :], jidx.sbq_stats, cfg.bits_per_dimension)[0]
        pqc = sbq.encode(pqv[None, :], pidx.sbq_stats, cfg.bits_per_dimension)[0]
    else:
        jqc = jnp.zeros((0,), jnp.uint32)
        pqc = torch.zeros((0,), dtype=torch.int32)
    return ((jqv, jqc, jstart_ids(jidx.arrays, None, 1)[0]),
            (pqv, pqc, get_start_ids(pidx.arrays, 1)[0]))


def _assert_state(p, j):
    np.testing.assert_array_equal(p.visited.numpy(), np.asarray(j.visited))
    np.testing.assert_array_equal(p.emitted.numpy(), np.asarray(j.emitted))
    np.testing.assert_array_equal(p.vdist.numpy(), np.asarray(j.vdist))
    np.testing.assert_array_equal(p.beam_ids.numpy(), np.asarray(j.beam_ids))
    np.testing.assert_array_equal(p.beam_dists.numpy(), np.asarray(j.beam_dists))
    assert int(p.n_visits) == int(j.n_visits) and int(p.n_comps) == int(j.n_comps)


@pytest.mark.parametrize("kind", KINDS)
def test_iterate_steps_match_jax(built, kind):
    """init_state, four refills of 64 (the second capped by a visit budget
    of 20), first_unseen and reseed on the same arrays: JAX's state and
    emissions; then the same refills with ``step_block`` 1 and 5 give the
    same again."""
    jidx, pidx, rows = built[kind]
    (jqv, jqc, jst), (pqv, pqc, pst) = _query_forms(jidx, pidx, rows[7] + np.float32(0.5))
    kw_j = dict(distance_type=jidx.config.distance_type, use_codes=jidx.config.uses_sbq)
    kw_p = dict(distance_type=pidx.config.distance_type, use_codes=pidx.config.uses_sbq)
    js = jiterate.init_state(jidx.arrays, jqv, jqc, jst, frontier=64, **kw_j)
    ps = iterate.init_state(pidx.arrays, pqv, pqc, pst, frontier=64, **kw_p)
    _assert_state(ps, js)
    start = ps
    for budget in (256, 20, 256, 256):
        js, jids, jd = jiterate.iter_step(js, jidx.arrays, jqv, jqc, emit_n=64,
                                          visit_budget=budget, **kw_j)
        ps, ids, d = iterate.iter_step(ps, pidx.arrays, pqv, pqc, emit_n=64,
                                       visit_budget=budget, **kw_p)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        _assert_state(ps, js)
        assert iterate.first_unseen(ps, pidx.arrays) == int(
            jiterate.first_unseen(js, jidx.arrays))
    nid = iterate.first_unseen(ps, pidx.arrays)
    assert nid >= 0
    js = jiterate.reseed(js, jidx.arrays, jqv, jqc, jnp.asarray(nid, jnp.int32), **kw_j)
    ps = iterate.reseed(ps, pidx.arrays, pqv, pqc, nid, **kw_p)
    _assert_state(ps, js)
    for block in (1, 5):
        s = start
        for budget in (256, 20, 256, 256):
            s, ids, _ = iterate.iter_step(s, pidx.arrays, pqv, pqc, emit_n=64,
                                          visit_budget=budget, step_block=block, **kw_p)
        reseeded = iterate.reseed(s, pidx.arrays, pqv, pqc, nid, **kw_p)
        for a, b in zip(reseeded, ps):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_search_iterator_stream_matches_jax(built, kind):
    """The first 150 results of a stream at L=8, rescore 10 (the window
    grows past the first refill): JAX's ids, distances within 1e-5, the
    same total visits."""
    jidx, pidx, rows = built[kind]
    query = rows[3] + np.float32(0.25)
    jit = jidx.search_iter(query, JaxParams(search_list_size=8, rescore=10))
    pit = pidx.search_iter(query, QueryParams(search_list_size=8, rescore=10), device="cpu")
    jids, jd = jit.next_batch(150)
    ids, d = pit.next_batch(150)
    assert len(ids) == 150
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(d, jd, rtol=0, atol=1e-5)
    assert pit.total_visits == jit.total_visits
    assert pit.stats_count == jit.stats_count


def test_iterator_no_duplicates_full_scan():
    """The port's test_streaming.py counterpart (300 x 32, L2): streaming
    the whole index yields every row exactly once, in at most n visits."""
    rng = np.random.default_rng(0)
    n, d = 300, 32
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    index = DiskannIndex.build(
        vectors, IndexConfig(num_dimensions=d, distance_type=DistanceType.L2,
                             num_neighbors=16, search_list_size=32), device="cpu")
    it = index.search_iter(vectors[0], params=QueryParams(search_list_size=4, rescore=10),
                           device="cpu")
    got = [nid for nid, _ in it]
    assert len(got) == n, f"expected {n} results, got {len(got)}"
    assert len(set(got)) == n, "iterator yielded duplicate ids"
    assert 0 < it.total_visits <= n


def test_full_scan_skips_deleted_rows():
    """After deleting 30 of 300 rows, a full scan yields each of the other
    270 once, in at most 300 visits (deleted rows are traversed)."""
    rng = np.random.default_rng(1)
    vectors = rng.standard_normal((300, 24)).astype(np.float32)
    index = DiskannIndex.build(vectors, IndexConfig(num_dimensions=24, num_neighbors=12,
                                                    search_list_size=24), device="cpu")
    doomed = rng.choice(300, 30, replace=False)
    index.delete(doomed)
    it = index.search_iter(vectors[5], QueryParams(search_list_size=16, rescore=20),
                           device="cpu")
    got = [nid for nid, _ in it]
    assert sorted(got) == sorted(set(range(300)) - set(doomed.tolist()))
    assert it.total_visits <= 300


def test_streaming_stats_populated():
    """The port's test_aux.py counterpart: 400 low-rank rows, 48 wide."""
    rng = np.random.default_rng(5)
    basis = rng.standard_normal((24, 48)).astype(np.float32)
    vectors = rng.standard_normal((400, 24)).astype(np.float32) @ basis
    index = DiskannIndex.build(
        vectors, IndexConfig(num_dimensions=48, distance_type=DistanceType.L2,
                             num_neighbors=16, search_list_size=32), device="cpu")
    it = index.search_iter(vectors[0], QueryParams(search_list_size=32, rescore=20),
                           device="cpu")
    it.next_batch(10)
    assert it.max_distance > 0.0
    assert it.stats_count > 0


def test_labeled_restart_fallback_matches_jax():
    """A labeled index (12 labels, 1-2 a row): a stream filtered on one
    label re-runs the filtered search with a doubled L per refill, and
    yields JAX's ids and distances (within 1e-5) until exhausted; every
    row carries the label; ``total_visits`` is -1."""
    rng = np.random.default_rng(9)
    rows = rng.standard_normal((300, 32)).astype(np.float32)
    labels = [sorted(set(rng.integers(0, 12, 1 + i % 2).tolist())) for i in range(300)]
    jidx = JaxIndex.build(rows, JaxConfig(num_dimensions=32, num_neighbors=16,
                                          search_list_size=32, max_labels_per_vector=2),
                          labels=labels)
    pidx = _carry(jidx)
    query = rows[11] + np.float32(0.1)
    params = dict(search_list_size=8, rescore=10)
    jit = jidx.search_iter(query, JaxParams(**params), query_labels=[4])
    pit = pidx.search_iter(query, QueryParams(**params), query_labels=[4], device="cpu")
    jids, jd = jit.next_batch(300)
    ids, d = pit.next_batch(300)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(d, jd, rtol=0, atol=1e-5)
    assert len(ids) > 10 and all(4 in labels[i] for i in ids)
    assert pit.total_visits == -1 == jit.total_visits


def test_search_iter_defaults_to_the_card(built, monkeypatch):
    _, pidx, rows = built["f32"]
    with pytest.raises(ValueError, match="lives on cpu"):
        pidx.search_iter(rows[0], device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pidx.search_iter(rows[0])
