"""The port's "beam" and "scored" rescore windows against the JAX package.

- ``merge_sorted_into_window`` is the same bitonic network with the same
  stable candidate sort: with heavy ties (integer distances) every entry
  lands where it lands in JAX (tolerance: none).
- ``beam_search`` with ``window_n`` on a JAX-built graph carried with
  ``from_jax_state``: beam and window ids and distances equal for E = 1,
  2, 4 (Hamming distances are integers; tolerance: none).
- ``DiskannIndex.search`` with "beam" and "scored" at a rescore window
  wider than 2L+16: ids equal, distances within 1e-5 (float32 dot products
  summed in two orders).
- The port's version of ``test_index.py::test_window_strategies_equivalent_contract``:
  self-queries exact, no duplicate id in a row, recalls within 0.08 of
  "beam".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgvectorscale_tpu import DiskannIndex as JaxIndex
from pgvectorscale_tpu import IndexConfig as JaxConfig
from pgvectorscale_tpu import QueryParams as JaxParams
from pgvectorscale_tpu import store as jstore
from pgvectorscale_tpu.config import DistanceType as JaxDistance
from pgvectorscale_tpu.graph import search as jsearch
from pgvectorscale_tpu.index import _build_edge_codes
from pgvectorscale_tpu.ops import sbq as jsbq
from pgvectorscale_tpu_torch import DiskannIndex, ExactIndex, IndexConfig, QueryParams, from_jax_state
from pgvectorscale_tpu_torch.config import DistanceType
from pgvectorscale_tpu_torch.graph import search
from pgvectorscale_tpu_torch.io.datasets import synthetic_corpus


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def carried():
    """A JAX-built 1,200 x 64 cosine SBQ index, its queries, and the same
    state carried into the port."""
    base, queries = synthetic_corpus("glove", 1200, 40, seed=11)
    base, queries = base[:, :64].copy(), queries[:, :64].copy()
    jidx = JaxIndex.build(base, JaxConfig(num_dimensions=64))
    pidx = from_jax_state(
        jstore.to_host(jidx.arrays), jidx.sbq_stats, jidx.config, device="cpu"
    )
    return jidx, pidx, queries


@pytest.mark.parametrize("wl,e", [(24, 40), (64, 20), (5, 130)])
def test_merge_sorted_into_window_matches_jax(rng, wl, e):
    """Integer distances tie everywhere; windows narrower and wider than
    the candidate block, with INF padding in both."""
    q = 12
    win_d = np.sort(rng.integers(0, 6, (q, wl)).astype(np.float32), axis=1)
    win_d[:, wl - wl // 5 :] = np.inf
    win_ids = np.where(np.isinf(win_d), -1, rng.integers(0, 500, (q, wl))).astype(np.int32)
    cand_d = rng.integers(0, 6, (q, e)).astype(np.float32)
    cand_d[rng.random((q, e)) < 0.2] = np.inf
    cand_ids = rng.integers(0, 500, (q, e)).astype(np.int32)
    want = jax.jit(jsearch.merge_sorted_into_window)(
        *map(jnp.asarray, (win_d, win_ids, cand_d, cand_ids)))
    got = search.merge_sorted_into_window(*map(torch.from_numpy, (win_d, win_ids, cand_d, cand_ids)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("e", [1, 2, 4])
def test_beam_search_window_matches_jax(carried, e):
    """Beam, window, history and counters equal JAX's with window_n = 150
    (five times L; tolerance: none)."""
    jidx, pidx, queries = carried
    qv = np.asarray(jnp.asarray(queries) / jnp.linalg.norm(queries, axis=1, keepdims=True))
    jcodes = jsbq.encode(jnp.asarray(qv), jidx.sbq_stats, 2)
    q = qv.shape[0]
    start = np.zeros((q, 1), np.int32) + int(jidx.arrays.default_start)
    kw = dict(search_list_size=30, max_iters=61, expand_factor=e, window_n=150)
    want = jsearch.beam_search(
        jidx.arrays, jnp.asarray(qv), jcodes, jnp.zeros((q, 0), jnp.int32),
        jnp.asarray(start), distance_type=JaxDistance.COSINE, use_codes=True,
        filtered=False, edge_codes=_build_edge_codes(jidx.arrays), **kw,
    )
    got = search.beam_search(
        pidx.arrays, torch.from_numpy(np.asarray(jcodes).view(np.int32)),
        torch.from_numpy(start), **kw,
    )
    for name in ("beam_ids", "beam_dists", "window_ids", "window_dists", "hist_ids",
                 "n_visited", "n_dist_comps"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name
        )
    assert got.window_ids.shape == (q, 150)
    assert np.isfinite(got.window_dists.numpy()).sum(1).min() > 30


def test_beam_search_without_window_keeps_one_column(carried):
    jidx, pidx, _ = carried
    codes = pidx.arrays.codes[:8]
    res = search.beam_search(pidx.arrays, codes, search.get_start_ids(pidx.arrays, 8),
                             search_list_size=16, max_iters=40)
    assert res.window_ids.shape == (8, 1) and res.window_dists.shape == (8, 1)


@pytest.mark.parametrize("strategy", ["beam", "scored"])
@pytest.mark.parametrize("k,l,rescore", [(10, 32, 100), (5, 20, 80)])
def test_search_window_strategies_match_jax(carried, strategy, k, l, rescore):
    """Windows wider than 2L+16: equal ids, distances within 1e-5."""
    jidx, pidx, queries = carried
    jids, jd = jidx.search(queries, k, JaxParams(search_list_size=l, rescore=rescore,
                                                 window_strategy=strategy))
    ids, d = pidx.search(queries, k, QueryParams(search_list_size=l, rescore=rescore,
                                                 window_strategy=strategy), device="cpu")
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_allclose(d.numpy(), jd, atol=1e-5, rtol=0)


def _recall(ids, gt):
    return float(np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(ids, gt)]))


def test_window_strategies_equivalent_contract(rng):
    """Every strategy serves a rescore window larger than the beam:
    self-queries are exact, no result row holds an id twice (the scored
    window may; the query path dedups), and the recalls are within 0.08
    of "beam", which reaches 0.9."""
    n, d = 3000, 32
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((48, d)).astype(np.float32)
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.L2,
                         num_neighbors=16, search_list_size=32)
    index = DiskannIndex.build(vectors, config, device="cpu")
    gt = ExactIndex.build(vectors, config, device="cpu").search(queries, 10)[0].numpy()
    recalls = {}
    for strat in ("expand", "beam", "scored"):
        params = QueryParams(search_list_size=48, rescore=400, window_strategy=strat)
        ids, _ = index.search(vectors[:8], 1, params, device="cpu")
        assert ids[:, 0].tolist() == list(range(8))
        wide, _ = index.search(queries[:4], 40, params, device="cpu")
        for row in wide.numpy():
            live = row[row >= 0]
            assert len(set(live.tolist())) == len(live), (strat, row)
        recalls[strat] = _recall(index.search(queries, 10, params, device="cpu")[0].numpy(), gt)
    assert recalls["beam"] >= 0.9, recalls
    assert recalls["expand"] >= recalls["beam"] - 0.08, recalls
    assert recalls["scored"] >= recalls["beam"] - 0.08, recalls
