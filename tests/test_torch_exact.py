"""The port's ``ExactIndex`` against the JAX package's.

- ``tests/test_exact.py``'s cases on the port (its 1-bit end-to-end
  case against the port's ``DiskannIndex`` and ``ExactIndex``).
- Tie order: a corpus of 40 distinct integer vectors, each repeated 50
  times, has ties at every rank.  After build, add and delete the port
  returns JAX's ids exactly (the lowest row id first among equal
  distances, as ``lax.top_k``) and its distances within 1e-5, for L2,
  cosine and inner product.
- ``k`` above the row count pads with -1 / +inf, deleted rows come back
  as -1 / +inf, and external ids follow JAX's defaults.
"""

import numpy as np
import pytest
import torch

from pgvectorscale_tpu import IndexConfig as JaxConfig
from pgvectorscale_tpu.config import DistanceType as JaxDistance
from pgvectorscale_tpu.exact import ExactIndex as JaxExact
from pgvectorscale_tpu_torch import DiskannIndex, DistanceType, ExactIndex, IndexConfig, QueryParams

DISTANCES = [(JaxDistance.L2, DistanceType.L2), (JaxDistance.COSINE, DistanceType.COSINE),
             (JaxDistance.INNER_PRODUCT, DistanceType.INNER_PRODUCT)]


def _lowrank(rng, n, q, d, rank=24):
    basis = rng.standard_normal((rank, d)).astype(np.float32)
    return (
        rng.standard_normal((n, rank)).astype(np.float32) @ basis,
        rng.standard_normal((q, rank)).astype(np.float32) @ basis,
    )


def _duplicated(seed, distinct=40, copies=50, d=16):
    """``distinct`` integer vectors in -3..3, the whole block repeated
    ``copies`` times: row i equals rows i + 40, i + 80, ..."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-3, 4, (distinct, d)).astype(np.float32)
    base[0] = 0.0  # a zero row: cosine leaves it as it is, in both packages
    return np.tile(base, (copies, 1)), rng.integers(-3, 4, (16, d)).astype(np.float32)


def _assert_same(pidx, jidx, queries, k):
    want_ids, want_d = jidx.search(queries, k)
    got_ids, got_d = pidx.search(queries, k)
    assert got_ids.dtype == torch.int32 and got_d.dtype == torch.float32
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(pidx.to_external(got_ids), jidx.to_external(want_ids))


def test_exact_index_is_exact(rng):
    n, d = 500, 32
    vectors, queries = _lowrank(rng, n, 10, d)
    index = ExactIndex.build(vectors, IndexConfig(num_dimensions=d, distance_type=DistanceType.L2),
                             device="cpu")
    ids, dists = (t.numpy() for t in index.search(queries, k=5))
    for r in range(10):
        true = np.argsort(((vectors - queries[r]) ** 2).sum(axis=1))[:5]
        np.testing.assert_array_equal(ids[r], true)

    # delete removes from results; k > live count pads with -1.
    index.delete(ids[0][:2])
    ids2, _ = index.search(queries[:1], k=n)
    returned = set(ids2[0][ids2[0] >= 0].tolist())
    assert not (returned & set(int(i) for i in ids[0][:2]))
    assert len(returned) == n - 2

    # add after delete; the duplicate is findable and the external ids hold.
    new = index.add(vectors[:1])
    ids3, d3 = index.search(vectors[:1], k=2)
    assert float(d3[0, 0]) < 1e-6
    found_ext = set(index.to_external(ids3)[0].tolist())
    assert index.external_ids[new[0]] in found_ext or 0 in found_ext


def test_exact_empty():
    index = ExactIndex(IndexConfig(num_dimensions=8), device="cpu")
    assert index.count == 0 and len(index.external_ids) == 0
    ids, dists = index.search(np.zeros((2, 8), np.float32), k=3)
    assert ids.shape == (2, 3) and bool((ids == -1).all()) and bool(torch.isinf(dists).all())


def test_one_bit_sbq_end_to_end(rng):
    """num_bits_per_dimension=1 through the port's whole stack, gated
    against the port's exact index."""
    n, d, q, k = 800, 128, 30, 10
    vectors, queries = _lowrank(rng, n, q, d, rank=24)
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.COSINE,
                         num_bits_per_dimension=1)
    assert config.bits_per_dimension == 1
    index = DiskannIndex.build(vectors, config, device="cpu")
    exact = ExactIndex.build(vectors, IndexConfig(num_dimensions=d,
                                                  distance_type=DistanceType.COSINE),
                             device="cpu")
    gt = exact.search(queries, k=k)[0].numpy()
    ids, _ = index.search(queries, k, QueryParams(search_list_size=100, rescore=100),
                          device="cpu")
    ids = np.asarray(ids)
    hits = sum(len(set(gt[r].tolist()) & set(int(i) for i in ids[r] if i >= 0))
               for r in range(q))
    assert hits / (q * k) >= 0.9


def test_high_dim_defaults_to_one_bit():
    assert IndexConfig(num_dimensions=960).bits_per_dimension == 1
    assert IndexConfig(num_dimensions=768).bits_per_dimension == 2


@pytest.mark.parametrize("jd,pd", DISTANCES)
def test_tie_order_matches_jax_after_add_and_delete(jd, pd):
    """Ids equal to JAX's on a corpus tied at every rank (lowest id first),
    distances within 1e-5, after build, add (default external ids
    continue from max + 1) and delete."""
    vectors, queries = _duplicated(3)
    d = vectors.shape[1]
    jidx = JaxExact.build(vectors[:1200], JaxConfig(num_dimensions=d, distance_type=jd))
    pidx = ExactIndex.build(vectors[:1200], IndexConfig(num_dimensions=d, distance_type=pd),
                            device="cpu")
    _assert_same(pidx, jidx, queries, 10)
    ext = np.arange(5000, 5800, dtype=np.int64)
    np.testing.assert_array_equal(pidx.add(vectors[1200:], external_ids=ext),
                                  jidx.add(vectors[1200:], external_ids=ext))
    np.testing.assert_array_equal(pidx.add(vectors[:40]), jidx.add(vectors[:40]))
    np.testing.assert_array_equal(pidx.external_ids, jidx.external_ids)
    assert pidx.external_ids[-1] == 5839
    doomed = np.concatenate([np.arange(0, 400, 3), np.arange(2000, 2040)]).astype(np.int32)
    pidx.delete(torch.from_numpy(doomed))
    jidx.delete(doomed)
    _assert_same(pidx, jidx, queries, 10)
    _assert_same(pidx, jidx, queries, 200)


@pytest.mark.parametrize("jd,pd", DISTANCES)
def test_padding_and_deleted_rows_match_jax(jd, pd):
    """k past the row count pads with -1 / +inf; when fewer live rows than
    k remain, the deleted rows come back as -1 / +inf, as in JAX."""
    vectors, queries = _duplicated(4, distinct=8, copies=3, d=8)
    cfg = dict(num_dimensions=8, distance_type=jd)
    jidx = JaxExact.build(vectors, JaxConfig(**cfg))
    pidx = ExactIndex.build(vectors, IndexConfig(**{**cfg, "distance_type": pd}), device="cpu")
    _assert_same(pidx, jidx, queries, 30)
    jidx.delete(np.arange(0, 20))
    pidx.delete(np.arange(0, 20))
    ids, dists = pidx.search(queries, 30)
    assert bool((ids[:, 4:] == -1).all()) and bool(torch.isinf(dists[:, 4:]).all())
    _assert_same(pidx, jidx, queries, 30)
    with pytest.raises(ValueError, match="out of range"):
        pidx.delete([24])
    with pytest.raises(ValueError, match="out of range"):
        pidx.delete(np.array([-1]))
    with pytest.raises(ValueError, match="num_dimensions"):
        pidx.add(np.zeros((2, 7), np.float32))


def test_tied_top10_lowest_id_first():
    """Every query's top 10 is tied (a plain ``torch.topk`` returns such
    ties in no fixed order): ids come lowest first, as JAX's."""
    vectors, queries = _duplicated(0)
    cfg = dict(num_dimensions=vectors.shape[1])
    jids, jd = JaxExact.build(vectors, JaxConfig(distance_type=JaxDistance.L2, **cfg)).search(
        queries, 10)
    pids, _ = ExactIndex.build(vectors, IndexConfig(distance_type=DistanceType.L2, **cfg),
                               device="cpu").search(queries, 10)
    np.testing.assert_array_equal(pids.numpy(), jids)
    # Every query's top 10 is tied, and ties come lowest id first.
    assert (jd == jd[:, :1]).all() and (np.diff(jids, axis=1) > 0).all()
