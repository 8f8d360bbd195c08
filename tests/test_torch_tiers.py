"""The 4- and 8-bit SBQ tiers of the port against the JAX package.

- Whole builds at 4 and 8 bits a dimension, L2 and cosine, exact-prune
  and storage: the port's quantizer statistics, codes, adjacency and
  search results equal JAX's (ids exactly, distances within 1e-5).  Exact
  parity needs exact arithmetic: every column of the corpus sums to zero
  (each row comes with its negation), so the mean is 0 and M2 a sum of
  exact squares in any order.  L2 rows hold integers in -3..3; cosine rows
  are unit vectors with four entries of +-0.5 (left as they are by the
  normalization), so every dot product is a multiple of 1/4.  As in
  ``test_torch_plain.py``, JAX's ``append_backlinks`` is replaced by the
  same function minus its row-0 fault, and the brute-force threshold is
  256 rows in both packages so the builds reach searched waves.
- A storage build at 8 bits over 520 dimensions (4,160 code bits: the
  prune's wide-code blocks) equals JAX's.
- ``from_jax_state`` of a 4-bit and of an 8-bit JAX index searches as
  JAX does.
- ``tests/test_sbq.py``'s 4-bit cases on the port
  (``test_high_fidelity_bits_raise_rescore_ceiling``,
  ``test_four_bit_index_builds_and_searches``).
- ``chip_smoke.py``'s strict-rank ceiling (phase 20) against a numpy strict
  rank, against ``benchmarks/suite.py``'s ``_sbq_ceiling`` on the same
  codes, and ordered as ``test_sbq.py`` claims: 4 bits at least 2.
"""

import importlib.util
import json
import os
import pathlib
import sys
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pgvectorscale_tpu.index as jindex_mod
from pgvectorscale_tpu import DiskannIndex as JaxIndex
from pgvectorscale_tpu import IndexConfig as JaxConfig
from pgvectorscale_tpu import QueryParams as JaxParams
from pgvectorscale_tpu import store as jstore
from pgvectorscale_tpu.config import DistanceType as JaxDistance
from pgvectorscale_tpu.graph import build as jbuild
from pgvectorscale_tpu.ops import sbq as jsbq
import pgvectorscale_tpu_torch.index as pindex_mod
from pgvectorscale_tpu_torch import DiskannIndex, ExactIndex, IndexConfig, QueryParams, from_jax_state
from pgvectorscale_tpu_torch.config import DistanceType
from pgvectorscale_tpu_torch.graph import build
from pgvectorscale_tpu_torch.ops import sbq
from pgvectorscale_tpu_torch.ops.hamming import hamming_distance_matrix
from test_torch_plain import _append_backlinks_dropping_misfits

ROOT = pathlib.Path(__file__).resolve().parent.parent
DEFAULT_THRESHOLD = build.BRUTE_CANDIDATE_THRESHOLD
N, R, L = 512, 16, 32
DIMS = {(4, "l2"): 24, (4, "cosine"): 40, (8, "l2"): 32, (8, "cosine"): 16}
CASES = [(bits, dist, mode) for bits in (4, 8) for dist in ("l2", "cosine")
         for mode in ("exact-prune", "storage")]
PARAMS = dict(search_list_size=L, rescore=64, expand=2)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


@pytest.fixture
def default_threshold(monkeypatch):
    """The brute-force threshold at its default, as the JAX tests run."""
    for mod in (build, pindex_mod):
        monkeypatch.setattr(mod, "BRUTE_CANDIDATE_THRESHOLD", DEFAULT_THRESHOLD)


def _rows(dist, n, d, rng):
    if dist == "l2":
        return rng.integers(-3, 4, (n, d)).astype(np.float32)
    x = np.zeros((n, d), np.float32)
    for row in x:
        row[rng.choice(d, 4, replace=False)] = rng.choice([-0.5, 0.5], 4)
    return x


def _corpus(bits, dist, seed):
    """N rows, each column summing to zero, and 24 queries."""
    rng = np.random.default_rng(seed)
    d = DIMS[bits, dist]
    half = _rows(dist, N // 2, d, rng)
    return np.concatenate([half, -half]), _rows(dist, 24, d, rng)


@pytest.fixture(scope="module")
def jax_builds():
    """JAX builds by (bits, distance, build mode), made on first use."""
    cache = {}

    def get(bits, dist, mode):
        if (bits, dist, mode) not in cache:
            base, queries = _corpus(bits, dist, bits)
            cfg = JaxConfig(num_dimensions=base.shape[1],
                            distance_type=JaxDistance.L2 if dist == "l2" else JaxDistance.COSINE,
                            num_neighbors=R, search_list_size=L, num_bits_per_dimension=bits,
                            build_distance=mode)
            cache[bits, dist, mode] = (base, queries, JaxIndex.build(base, cfg))
        return cache[bits, dist, mode]

    return get


def _assert_same_search(pidx, jidx, queries, params):
    want_ids, want_d = jidx.search(queries, 10, params=JaxParams(**params))
    got_ids, got_d = pidx.search(queries, 10, QueryParams(**params), device="cpu")
    np.testing.assert_array_equal(np.asarray(got_ids), np.asarray(want_ids))
    np.testing.assert_allclose(np.asarray(got_d), np.asarray(want_d), rtol=0, atol=1e-5)


@pytest.mark.parametrize("bits,dist,mode", CASES)
def test_whole_build_matches_jax(jax_builds, bits, dist, mode):
    """The port's build equals JAX's: statistics, codes (W words), the
    graph (tolerance: none) and a search through the expand window."""
    base, queries, jidx = jax_builds(bits, dist, mode)
    pidx = DiskannIndex.build(base, IndexConfig.from_dict(jidx.config.to_dict()), device="cpu")
    n, d = jidx.count, base.shape[1]
    host = jstore.to_host(jidx.arrays)
    assert pidx.config.bits_per_dimension == bits
    assert pidx.arrays.codes.shape[1] == sbq.num_code_words(d, bits) == d * bits // 32
    np.testing.assert_array_equal(pidx.sbq_stats.mean.numpy(), np.asarray(jidx.sbq_stats.mean))
    np.testing.assert_array_equal(pidx.sbq_stats.m2.numpy(), np.asarray(jidx.sbq_stats.m2))
    np.testing.assert_array_equal(pidx.arrays.codes[:n].numpy().view(np.uint32), host.codes[:n])
    np.testing.assert_array_equal(pidx.arrays.adjacency[:n].numpy(), host.adjacency[:n])
    assert pidx.arrays.default_start == int(host.default_start)
    assert bool(build.reachable_on_device(pidx.arrays)[:n].all())
    _assert_same_search(pidx, jidx, queries, PARAMS)


def test_wide_code_storage_build_matches_jax():
    """8 bits over 520 dims (4,160 code bits, 130 words): the storage
    prune's pair distances run in blocks of 4,096 bits; codes and graph
    equal JAX's."""
    rng = np.random.default_rng(9)
    half = rng.integers(-3, 4, (160, 520)).astype(np.float32)
    base = np.concatenate([half, -half])
    cfg = JaxConfig(num_dimensions=520, distance_type=JaxDistance.L2, num_neighbors=R,
                    search_list_size=L, num_bits_per_dimension=8, build_distance="storage")
    jidx = JaxIndex.build(base, cfg)
    pidx = DiskannIndex.build(base, IndexConfig.from_dict(cfg.to_dict()), device="cpu")
    host, n = jstore.to_host(jidx.arrays), jidx.count
    assert pidx.arrays.codes.shape[1] == 130
    np.testing.assert_array_equal(pidx.arrays.codes[:n].numpy().view(np.uint32), host.codes[:n])
    np.testing.assert_array_equal(pidx.arrays.adjacency[:n].numpy(), host.adjacency[:n])


@pytest.mark.parametrize("bits,dist,mode", [(4, "l2", "storage"), (8, "cosine", "exact-prune")])
def test_from_jax_state_searches_equal(jax_builds, bits, dist, mode):
    """A 4-bit (8-bit) JAX index carried into the port searches as JAX
    does, through the expand and the scored windows."""
    base, queries, jidx = jax_builds(bits, dist, mode)
    pidx = from_jax_state(jstore.to_host(jidx.arrays), jidx.sbq_stats, jidx.config,
                          external_ids=jidx.external_ids, device="cpu")
    assert pidx.config.bits_per_dimension == bits
    assert pidx.arrays.codes.shape[1] == base.shape[1] * bits // 32
    _assert_same_search(pidx, jidx, queries, PARAMS)
    _assert_same_search(pidx, jidx, queries, dict(search_list_size=L, rescore=100, expand=2,
                                                  window_strategy="scored", visit_factor=2.0))


def test_high_fidelity_bits_raise_rescore_ceiling(rng):
    """4-bit codes order candidates strictly better than 2-bit on the same
    corpus: the exact-rescore ceiling at a fixed window improves."""
    with pytest.raises(ValueError):
        IndexConfig(num_dimensions=16, num_bits_per_dimension=3)
    IndexConfig(num_dimensions=16, num_bits_per_dimension=4)
    IndexConfig(num_dimensions=16, num_bits_per_dimension=8)

    n, d, q, k, window = 4000, 48, 64, 10, 30
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    exact = np.einsum("nd,nd->n", vectors, vectors)[None, :] - 2.0 * queries @ vectors.T
    gt = np.argpartition(exact, k, axis=1)[:, :k]

    stats = sbq.train(torch.from_numpy(vectors))
    ceilings = {}
    for bits in (2, 4):
        cd = hamming_distance_matrix(sbq.encode(torch.from_numpy(queries), stats, bits),
                                     sbq.encode(torch.from_numpy(vectors), stats, bits)).numpy()
        top = np.argpartition(cd, window, axis=1)[:, :window]
        hits = 0
        for r in range(q):
            w = top[r]
            best = w[np.argpartition(exact[r][w], k)[:k]]
            hits += len(set(best) & set(gt[r]))
        ceilings[bits] = hits / (q * k)
    assert ceilings[4] > ceilings[2]


def test_four_bit_index_builds_and_searches(rng, default_threshold):
    """End-to-end smoke at bits=4: build, search, self-query exactness."""
    n, d, k = 400, 24, 5
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.L2, num_neighbors=16,
                         search_list_size=32, num_bits_per_dimension=4)
    index = DiskannIndex.build(vectors, config, device="cpu")
    assert index.arrays.codes.shape[1] == sbq.num_code_words(d, 4)
    ids, dists = index.search(vectors[:8], k, QueryParams(search_list_size=32, rescore=32),
                              device="cpu")
    np.testing.assert_array_equal(np.asarray(ids)[:, 0], np.arange(8))
    assert np.all(np.asarray(dists)[:, 0] < 1e-4)


@pytest.fixture(scope="module")
def ceiling_case():
    """3,000 x 32 standard-normal rows (L2), 40 queries, their exact
    top-10 (the port's ``ExactIndex``) and the quantizer statistics."""
    rng = np.random.default_rng(11)
    vectors = rng.standard_normal((3000, 32)).astype(np.float32)
    queries = rng.standard_normal((40, 32)).astype(np.float32)
    gt = ExactIndex.build(vectors, IndexConfig(num_dimensions=32, distance_type=DistanceType.L2),
                          device="cpu").search(queries, 10)[0]
    return vectors, queries, gt, sbq.train(torch.from_numpy(vectors))


def test_chip_smoke_ceiling_matches_numpy_and_the_suite(ceiling_case, capsys):
    """``chip_smoke.strict_ranks`` (in chunks of 16 queries) equals a numpy
    strict rank on the unpacked bits, and ``sbq_ceiling`` equals what
    ``benchmarks/suite.py``'s ``_sbq_ceiling`` prints on the same codes."""
    smoke = _load("chip_smoke_module", ROOT / "chip_smoke.py")
    vectors, queries, gt, stats = ceiling_case
    codes = sbq.encode(torch.from_numpy(vectors), stats, 4)
    qcodes = sbq.encode(torch.from_numpy(queries), stats, 4)
    ranks = smoke.strict_ranks(qcodes, codes, gt, chunk=16)

    def bits(c):
        return np.unpackbits(c.numpy().view(np.uint8), axis=1, bitorder="little").astype(np.int32)

    d = (bits(qcodes)[:, None, :] != bits(codes)[None, :, :]).sum(-1)
    gth = np.take_along_axis(d, gt.numpy().astype(np.int64), axis=1)
    np.testing.assert_array_equal(ranks.numpy(), (d[:, None, :] < gth[:, :, None]).sum(-1))

    rescores = [5, 30, 100]
    got = smoke.sbq_ceiling(ranks, rescores)
    # suite.py sets a default TPU compile-cache directory in the environment
    # and puts the repository on sys.path when imported: keep neither.
    with mock.patch.dict(os.environ), mock.patch.object(sys, "path", list(sys.path)):
        suite = _load("suite_module", ROOT / "benchmarks" / "suite.py")
    jstats = jsbq.SbqStats(count=jnp.asarray(stats.count, jnp.int32),
                           mean=jnp.asarray(stats.mean.numpy()), m2=jnp.asarray(stats.m2.numpy()))
    index = types.SimpleNamespace(
        config=JaxConfig(num_dimensions=32, distance_type=JaxDistance.L2, num_bits_per_dimension=4),
        sbq_stats=jstats,
        arrays=types.SimpleNamespace(codes=jnp.asarray(codes.numpy().view(np.uint32))))
    capsys.readouterr()
    suite._sbq_ceiling(index, queries, gt.numpy(), rescores)
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["rescore"] for r in rows] == rescores
    for r in rows:
        assert r["ceiling"] == round(got[r["rescore"]], 4)


def test_chip_smoke_ceiling_four_bits_above_two(ceiling_case):
    """The strict-rank ceiling of 4-bit codes is at least the 2-bit one at
    every rescore, and above it at the narrowest."""
    smoke = _load("chip_smoke_module", ROOT / "chip_smoke.py")
    vectors, queries, gt, stats = ceiling_case
    ceil = {}
    for b in (2, 4):
        ranks = smoke.strict_ranks(sbq.encode(torch.from_numpy(queries), stats, b),
                                   sbq.encode(torch.from_numpy(vectors), stats, b), gt)
        ceil[b] = smoke.sbq_ceiling(ranks, [5, 30, 100, 300])
    assert all(ceil[4][r] >= ceil[2][r] for r in ceil[4])
    assert ceil[4][5] > ceil[2][5]
