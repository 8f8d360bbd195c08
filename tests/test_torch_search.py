"""Parity of the PyTorch port's query path and RobustPrune with the JAX
package.

One JAX-built graph is carried into the port with ``from_jax_state`` and
searched by both packages.  Hamming distances are integers and the beam
merge is the same network, so beam ids and distances must be equal; the
final distances come from float32 dot products summed in different
orders, so they must agree within 1e-5 (ids equal).
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
from pgvectorscale_tpu.graph import prune as jprune
from pgvectorscale_tpu.graph import search as jsearch
from pgvectorscale_tpu.index import _build_edge_codes
from pgvectorscale_tpu.ops import sbq as jsbq
from pgvectorscale_tpu_torch import QueryParams, from_jax_state, store
from pgvectorscale_tpu_torch.config import DistanceType
from pgvectorscale_tpu_torch.graph import prune, search
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


def test_carried_state_is_equal(carried):
    jidx, pidx, _ = carried
    host = jstore.to_host(jidx.arrays)
    np.testing.assert_array_equal(pidx.arrays.codes.numpy().view(np.uint32), host.codes)
    np.testing.assert_array_equal(pidx.arrays.adjacency.numpy(), host.adjacency)
    np.testing.assert_array_equal(pidx.arrays.vectors.numpy(), host.vectors)
    assert pidx.count == int(host.count) and pidx.arrays.default_start == int(host.default_start)
    back = store.from_host(store.to_host(pidx.arrays), "cpu")
    for a, b in zip(back, pidx.arrays):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_merge_sorted_into_beam_matches_jax(rng):
    """Heavy ties (small integer distances): the same bitonic network
    puts every tie in the same place (tolerance: none)."""
    q, l, e = 16, 24, 40
    beam_d = np.sort(rng.integers(0, 6, (q, l)).astype(np.float32), axis=1)
    beam_d[:, -5:] = np.inf
    beam_ids = rng.integers(0, 500, (q, l)).astype(np.int32)
    beam_ids[:, -5:] = -1
    beam_vis = rng.random((q, l)) < 0.5
    cand_d = rng.integers(0, 6, (q, e)).astype(np.float32)
    cand_d[rng.random((q, e)) < 0.2] = np.inf
    cand_ids = rng.integers(0, 500, (q, e)).astype(np.int32)
    want = jsearch.merge_sorted_into_beam(*map(jnp.asarray, (beam_d, beam_ids, beam_vis, cand_d, cand_ids)))
    got = search.merge_sorted_into_beam(*map(torch.from_numpy, (beam_d, beam_ids, beam_vis, cand_d, cand_ids)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("e", [1, 2, 4])
def test_beam_search_matches_jax(carried, e):
    """Beam, visit history and counters equal JAX's for E = 1/2/4 (JAX over
    its edge-code cache, the port reading the codes through the adjacency;
    tolerance: none)."""
    jidx, pidx, queries = carried
    qv = np.asarray(jnp.asarray(queries) / jnp.linalg.norm(queries, axis=1, keepdims=True))
    jcodes = jsbq.encode(jnp.asarray(qv), jidx.sbq_stats, 2)
    q = qv.shape[0]
    start = np.zeros((q, 1), np.int32) + int(jidx.arrays.default_start)
    kw = dict(search_list_size=32, max_iters=64, expand_factor=e)
    want = jsearch.beam_search(
        jidx.arrays, jnp.asarray(qv), jcodes, jnp.zeros((q, 0), jnp.int32),
        jnp.asarray(start), distance_type=JaxDistance.COSINE, use_codes=True,
        filtered=False, edge_codes=_build_edge_codes(jidx.arrays), **kw,
    )
    got = search.beam_search(
        pidx.arrays, torch.from_numpy(np.asarray(jcodes).view(np.int32)),
        torch.from_numpy(start), **kw,
    )
    for name in ("beam_ids", "beam_dists", "beam_visited", "hist_ids", "hist_dists",
                 "n_visited", "n_dist_comps"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name
        )
    assert got.iters == int(want.iters)


@pytest.mark.parametrize(
    "k,l,rescore", [(5, 32, 16), (10, 100, 50), (10, 32, 100), (10, 40, 0)]
)
def test_search_matches_jax(carried, k, l, rescore):
    """DiskannIndex.search on the carried graph: equal ids, distances
    within 1e-5.  (10, 32, 100) widens the window with the expand path."""
    jidx, pidx, queries = carried
    jids, jd = jidx.search(queries, k, JaxParams(search_list_size=l, rescore=rescore))
    ids, d = pidx.search(queries, k, QueryParams(search_list_size=l, rescore=rescore),
                         device="cpu")
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_allclose(d.numpy(), jd, atol=1e-5, rtol=0)


def test_search_defaults_to_the_card(carried, monkeypatch):
    _, pidx, queries = carried
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pidx.search(queries, 5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_robust_prune_matches_jax(seed):
    """Identical input distance matrices give identical neighbour lists,
    with zero distances (duplicate vectors), the node itself, padding and
    occlusion ties among the candidates (tolerance: none)."""
    rng = np.random.default_rng(seed)
    b, c, r = 12, 40, 10
    node_ids = rng.integers(0, 1000, b).astype(np.int32)
    cand_ids = rng.integers(0, 1000, (b, c)).astype(np.int32)
    cand_ids[:, 0] = node_ids
    cand_ids[rng.random((b, c)) < 0.1] = -1
    cand_d = (rng.integers(0, 30, (b, c)) / 10.0).astype(np.float32)
    pts = rng.integers(0, 4, (b, c, 3)).astype(np.float32)
    pair = np.abs(pts[:, :, None, :] - pts[:, None, :, :]).sum(-1).astype(np.float32) / 3.0
    alphas = jprune.alpha_schedule(1.2)
    assert alphas == prune.alpha_schedule(1.2)
    want = jprune.robust_prune(
        jnp.asarray(node_ids), jnp.asarray(cand_ids), jnp.asarray(cand_d), jnp.asarray(pair),
        jnp.zeros((b, c, 0), jnp.int32), jnp.zeros((b, 0), jnp.int32),
        num_neighbors=r, alphas=alphas, labeled=False,
    )
    got = prune.robust_prune(
        torch.from_numpy(node_ids), torch.from_numpy(cand_ids), torch.from_numpy(cand_d),
        torch.from_numpy(pair), num_neighbors=r, alphas=alphas,
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_pairwise_distance_matrix_matches_jax(rng):
    """Full-precision pairwise distances within 1e-5 (float32 sums)."""
    v = rng.standard_normal((3, 20, 48)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    for jd, pd in ((JaxDistance.COSINE, DistanceType.COSINE), (JaxDistance.L2, DistanceType.L2)):
        want = np.asarray(jprune.pairwise_distance_matrix_full(jnp.asarray(v), jd))
        got = prune.pairwise_distance_matrix_full(torch.from_numpy(v), pd).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
