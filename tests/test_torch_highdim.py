"""High-dimension coverage of the port (``test_highdim.py``'s cases).

The reference exercises 4,000-16,000-dim SBQ indexes (reference:
pgvectorscale/src/access_method/build.rs:1854-1865) and caps plain storage
at 2,000 dims (build.rs:192-196).  At the JAX tests' 128-256 rows:

- Recall floors, as in the JAX tests (recall@10 >= 0.9 against the port's
  ``ops.bruteforce.brute_force_search``): 4,000-dim 1-bit SBQ, 16,000-dim
  SBQ (500-word codes: the chunked pairwise-Hamming prune and edge_gather's
  plain version at W=500), 2,000-dim plain, and a 4,000-dim index that
  indexes 1,024 dims and rescores on all of them.  The refusals of 16,001
  dims and of 2,001 plain dims.
- Ids against the JAX package where the build is deterministic: a
  16,000-dim storage build (every distance Hamming, L2) and a 2,000-dim
  plain build of integer vectors in -3..3 (every distance an integer in
  float32) give JAX's adjacency and search ids exactly (tolerance: none),
  with JAX's ``append_backlinks`` replaced by ``test_torch_plain.py``'s
  copy without its row-0 fault.
- The default (exact-prune) build at 16,000 dims past a lowered
  brute-force threshold gives JAX's graph and ids too (rank-32 rows: the
  full-precision sums agree to the bit there).
- ``brute_force_search`` equals the JAX package's (ids equal, distances
  within 1e-4 at 4,000 dims: float32 sums in two orders).
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
from pgvectorscale_tpu.config import StorageLayout as JaxLayout
from pgvectorscale_tpu.graph import build as jbuild
from pgvectorscale_tpu.ops.bruteforce import brute_force_search as jax_brute_force
from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig, QueryParams
from pgvectorscale_tpu_torch.config import DistanceType, StorageLayout
from pgvectorscale_tpu_torch.distance import preprocess_query
from pgvectorscale_tpu_torch.ops.bruteforce import brute_force_search
from test_torch_plain import _append_backlinks_dropping_misfits


@pytest.fixture(autouse=True, scope="module")
def _setup():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbuild, "append_backlinks", _append_backlinks_dropping_misfits)
        jax.clear_caches()
        yield
    jax.clear_caches()
    torch.set_num_threads(prev)


def _recall_at_k(index, vectors, queries, k, distance_type, params):
    dv = preprocess_query(torch.from_numpy(vectors), distance_type)
    dq = preprocess_query(torch.from_numpy(queries), distance_type)
    gt, _ = brute_force_search(dq, dv, torch.ones(len(vectors), dtype=torch.bool), k=k,
                               distance_type=distance_type)
    ids, _ = index.search(queries, k, params, device="cpu")
    hits = sum(len(set(gt[r].tolist()) & set(i for i in ids[r].tolist() if i >= 0))
               for r in range(queries.shape[0]))
    return hits / (queries.shape[0] * k)


def _lowrank(rng, n, q, d, rank=32):
    basis = rng.standard_normal((rank, d)).astype(np.float32)
    return (rng.standard_normal((n, rank)).astype(np.float32) @ basis,
            rng.standard_normal((q, rank)).astype(np.float32) @ basis)


def test_4000_dims_sbq(rng):
    """4,000-dim SBQ at the 1-bit default (dims >= 900)."""
    n, d, q, k = 256, 4000, 5, 10
    vectors, queries = _lowrank(rng, n, q, d)
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.L2)
    assert config.bits_per_dimension == 1 and config.num_code_words == 125
    index = DiskannIndex.build(vectors, config, device="cpu")
    recall = _recall_at_k(index, vectors, queries, k, DistanceType.L2,
                          QueryParams(search_list_size=100, rescore=100))
    assert recall >= 0.9, f"recall@10 = {recall}"


def test_16000_dims_sbq(rng):
    """The maximum dimension: 500-word codes."""
    n, d, q, k = 128, 16000, 3, 10
    vectors, queries = _lowrank(rng, n, q, d)
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.COSINE,
                         num_neighbors=16, search_list_size=32)
    assert config.num_code_words == 500
    index = DiskannIndex.build(vectors, config, device="cpu")
    recall = _recall_at_k(index, vectors, queries, k, DistanceType.COSINE,
                          QueryParams(search_list_size=50, rescore=100))
    assert recall >= 0.9, f"recall@10 = {recall}"


def test_16001_dims_rejected():
    with pytest.raises(ValueError, match="exceeds maximum"):
        IndexConfig(num_dimensions=16001)


def test_2000_dims_plain(rng):
    """Plain storage at its 2,000-dim cap: exact distances end to end."""
    n, d, q, k = 256, 2000, 5, 10
    vectors, queries = _lowrank(rng, n, q, d)
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.L2,
                         storage_layout=StorageLayout.PLAIN)
    index = DiskannIndex.build(vectors, config, device="cpu")
    recall = _recall_at_k(index, vectors, queries, k, DistanceType.L2,
                          QueryParams(search_list_size=100, rescore=0))
    assert recall >= 0.9, f"recall@10 = {recall}"


def test_2001_dims_plain_rejected():
    with pytest.raises(ValueError, match="plain storage"):
        IndexConfig(num_dimensions=2001, storage_layout=StorageLayout.PLAIN)


def test_4000_dims_truncated_sbq(rng):
    """Index 1,024 of 4,000 dims, rescore on the full vector."""
    n, d, q, k = 200, 4000, 5, 10
    vectors, queries = _lowrank(rng, n, q, d)
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.L2,
                         num_dimensions_to_index=1024)
    index = DiskannIndex.build(vectors, config, device="cpu")
    recall = _recall_at_k(index, vectors, queries, k, DistanceType.L2,
                          QueryParams(search_list_size=100, rescore=150))
    assert recall >= 0.9, f"recall@10 = {recall}"


@pytest.mark.parametrize("case", ["16000-storage", "2000-plain"])
def test_high_dim_builds_match_jax(case):
    """Deterministic builds in both packages: the same graph and search
    ids (rescore 0: the traversal's own distances)."""
    rng = np.random.default_rng(21)
    if case == "16000-storage":
        n, d = 128, 16000
        vectors = rng.standard_normal((n + 4, d)).astype(np.float32)
        kw = dict(num_dimensions=d, num_neighbors=16, search_list_size=32,
                  build_distance="storage")
        config = IndexConfig(distance_type=DistanceType.L2, **kw)
        jconfig = JaxConfig(distance_type=JaxDistance.L2, **kw)
        assert config.num_code_words == 500
    else:
        n, d = 256, 2000
        vectors = rng.integers(-3, 4, (n + 4, d)).astype(np.float32)
        config = IndexConfig(num_dimensions=d, distance_type=DistanceType.L2,
                             storage_layout=StorageLayout.PLAIN)
        jconfig = JaxConfig(num_dimensions=d, distance_type=JaxDistance.L2,
                            storage_layout=JaxLayout.PLAIN)
    base, queries = vectors[:n], vectors[n:]
    pidx = DiskannIndex.build(base, config, device="cpu")
    jidx = JaxIndex.build(base, jconfig)
    np.testing.assert_array_equal(pidx.arrays.adjacency[:n].numpy(),
                                  jstore.to_host(jidx.arrays).adjacency[:n])
    p_ids, p_d = pidx.search(queries, 10, QueryParams(search_list_size=40, rescore=0),
                             device="cpu")
    j_ids, j_d = jidx.search(queries, 10, JaxParams(search_list_size=40, rescore=0))
    np.testing.assert_array_equal(p_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(p_d.numpy(), np.asarray(j_d))


def test_16000_dim_searched_build_matches_jax(monkeypatch):
    """The default build (exact-prune: Hamming traversal on 500-word codes
    over the adjacency snapshot, full-precision re-measure and prune) past
    the brute-force threshold, lowered to 128 rows in both packages: 512
    rank-32 rows give JAX's graph and JAX's ids at the JAX test's search
    point.  Its recall there is printed, not held: with searched waves
    the point's beam covers a tenth of the rows."""
    import pgvectorscale_tpu.index as jindex_mod
    import pgvectorscale_tpu_torch.index as pindex_mod
    from pgvectorscale_tpu_torch import ExactIndex
    from pgvectorscale_tpu_torch.graph import build

    for mod in (jbuild, jindex_mod, build, pindex_mod):
        monkeypatch.setattr(mod, "BRUTE_CANDIDATE_THRESHOLD", 128)
    jax.clear_caches()
    rng = np.random.default_rng(18)
    vectors, queries = _lowrank(rng, 512, 32, 16000)
    kw = dict(num_dimensions=16000, num_neighbors=16, search_list_size=32)
    pidx = DiskannIndex.build(vectors, IndexConfig(distance_type=DistanceType.COSINE, **kw),
                              device="cpu", max_wave=256)
    jidx = JaxIndex.build(vectors, JaxConfig(distance_type=JaxDistance.COSINE, **kw),
                          max_wave=256)
    assert pidx.build_stats.num_waves == jidx.build_stats.num_waves == 2
    np.testing.assert_array_equal(pidx.arrays.adjacency[:512].numpy(),
                                  jstore.to_host(jidx.arrays).adjacency[:512])
    p_ids, _ = pidx.search(queries, 10, QueryParams(search_list_size=50, rescore=100),
                           device="cpu")
    j_ids, _ = jidx.search(queries, 10, JaxParams(search_list_size=50, rescore=100))
    np.testing.assert_array_equal(p_ids.numpy(), np.asarray(j_ids))
    gt = ExactIndex.build(vectors, IndexConfig(distance_type=DistanceType.COSINE, **kw),
                          device="cpu").search(queries, 10)[0].numpy()
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(p_ids.numpy(), gt)])
    print(f"16,000 dims, 512 rows, searched waves: recall@10 at L=50, rescore 100 "
          f"{recall:.4f} in both packages")
    jax.clear_caches()


def test_brute_force_search_matches_jax(rng):
    vectors, queries = _lowrank(rng, 300, 7, 4000)
    valid = np.ones(300, bool)
    valid[::9] = False
    for dt, jdt in ((DistanceType.L2, JaxDistance.L2),
                    (DistanceType.INNER_PRODUCT, JaxDistance.INNER_PRODUCT)):
        ids, d = brute_force_search(torch.from_numpy(queries), torch.from_numpy(vectors),
                                    torch.from_numpy(valid), k=12, distance_type=dt)
        j_ids, j_d = jax_brute_force(jnp.asarray(queries), jnp.asarray(vectors),
                                     jnp.asarray(valid), k=12, distance_type=jdt)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
        np.testing.assert_allclose(d.numpy(), np.asarray(j_d), rtol=1e-4, atol=1e-4)
        assert ids.dtype == torch.int32 and valid[ids.numpy()].all()
