"""The bf16 vector tier of the port against the JAX package.

- Ingest, add and tombstone-reusing add store the same bf16 bits as JAX
  (round to nearest even from the float32 rows; tolerance: none) on
  random, non-integer rows, and the codes are encoded from the float32
  rows in both.
- ``distance.row_distances`` on bf16 rows (gathered in bf16, converted to
  float32, dotted in float32) equals JAX's rescore to 1e-5 (float32 sums in
  two orders), and exactly on small integers, which bf16 holds exactly.
- A whole bf16 build of integer vectors (L2: every distance an integer)
  gives JAX's graph and search ids; the brute-force threshold is lowered
  to 256 rows and JAX's ``append_backlinks`` replaced by
  ``test_torch_plain.py``'s copy without its row-0 fault, as in
  ``test_torch_filtering.py``.
- bf16 checkpoints (vectors saved as their uint16 bit view) load both
  ways with every saved array equal.
- The filtered deployment of ``chip_smoke.py`` phase 11 (cohere 768,
  cosine, 2 bits, bf16, 1-2 labels a row with popularity 1/rank) at 320
  rows: stored bits, node labels and label table equal JAX's exactly;
  edges and filtered recall compared (recall within 0.02: float32 sums
  in XLA and torch can flip near-ties); on the carried JAX index the
  filtered searches return JAX's ids, distances within 1e-5.
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
from pgvectorscale_tpu import store as jstore
from pgvectorscale_tpu.config import DistanceType as JaxDistance
from pgvectorscale_tpu.graph import build as jbuild
import pgvectorscale_tpu_torch.index as pindex_mod
from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig, QueryParams, from_jax_state
from pgvectorscale_tpu_torch import store
from pgvectorscale_tpu_torch.config import DistanceType
from pgvectorscale_tpu_torch.distance import row_distances
from pgvectorscale_tpu_torch.graph import build
from pgvectorscale_tpu_torch.io.datasets import synthetic_corpus
from test_torch_plain import _append_backlinks_dropping_misfits

DISTANCES = [(JaxDistance.L2, DistanceType.L2), (JaxDistance.COSINE, DistanceType.COSINE),
             (JaxDistance.INNER_PRODUCT, DistanceType.INNER_PRODUCT)]


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


def _bits(pidx):
    return store.vectors_to_host(pidx.arrays.vectors)


def _jax_bits(jidx):
    return np.asarray(jstore.to_host(jidx.arrays).vectors).view(np.uint16)


def _carry(jidx):
    return from_jax_state(jstore.to_host(jidx.arrays), jidx.sbq_stats, jidx.config,
                          external_ids=jidx.external_ids, device="cpu")


def _assert_same_state(pidx, jidx):
    n = jidx.count
    host = jstore.to_host(jidx.arrays)
    assert pidx.arrays.vectors.dtype == torch.bfloat16 and pidx.count == n
    np.testing.assert_array_equal(_bits(pidx)[:n], _jax_bits(jidx)[:n])
    np.testing.assert_array_equal(pidx.arrays.codes[:n].numpy().view(np.uint32), host.codes[:n])
    np.testing.assert_array_equal(pidx.arrays.adjacency[:n].numpy(), host.adjacency[:n])
    np.testing.assert_array_equal(pidx.arrays.deleted[:n].numpy(), host.deleted[:n])
    np.testing.assert_array_equal(pidx.external_ids, jidx.external_ids)


@pytest.mark.parametrize("jd,pd", DISTANCES)
def test_bf16_ingest_matches_jax_bits(jd, pd):
    """200 x 48 random normal rows: the stored bf16 bits and the codes
    equal JAX's; the rows are the float32 rows rounded to nearest even."""
    base = np.random.default_rng(1).standard_normal((200, 48)).astype(np.float32) * 3.7
    kw = dict(num_dimensions=48, vector_dtype="bf16", build_distance="storage")
    jidx = JaxIndex.build(base, JaxConfig(distance_type=jd, **kw))
    pidx = DiskannIndex.build(base, IndexConfig(distance_type=pd, **kw), device="cpu")
    _assert_same_state(pidx, jidx)
    rows = torch.from_numpy(base)
    if pd == DistanceType.COSINE:
        rows = rows / rows.norm(dim=1, keepdim=True)
    assert pidx.arrays.vectors.dtype == torch.bfloat16
    assert (pidx.arrays.vectors[:200].float() != rows).any()  # really rounded
    assert torch.equal(pidx.arrays.vectors[:200], rows.to(torch.bfloat16))


@pytest.mark.parametrize("jd,pd", DISTANCES)
def test_row_distances_on_bf16_rows_match_jax(jd, pd):
    """The rescore's distances from 16 queries to 50 bf16 rows each,
    invalid ids among them: within 1e-5 of JAX's on random rows, equal on
    integer rows."""
    rng = np.random.default_rng(2)
    for vecs, tol in ((rng.standard_normal((300, 40)).astype(np.float32), 1e-5),
                      (rng.integers(-3, 4, (300, 40)).astype(np.float32), 0.0)):
        qv = rng.standard_normal((16, 40)).astype(np.float32)
        if tol == 0.0:
            qv = np.round(qv)
        ids = rng.integers(-1, 300, (16, 50)).astype(np.int32)
        jv = jnp.asarray(vecs).astype(jnp.bfloat16)
        want = jindex_mod._exact_batch_distances(
            jv, jnp.ones(300, jnp.float32), jnp.asarray(qv), jnp.asarray(ids), distance_type=jd)
        pv = torch.from_numpy(vecs).to(torch.bfloat16)
        got = row_distances(pv, torch.from_numpy(qv), torch.from_numpy(ids), pd)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def int_bf16():
    """A JAX bf16 build (exact-prune, L2) of 700 integer rows, and the rows."""
    base = np.random.default_rng(5).integers(-3, 4, (700, 32)).astype(np.float32)
    cfg = JaxConfig(num_dimensions=32, distance_type=JaxDistance.L2, num_neighbors=16,
                    search_list_size=32, vector_dtype="bf16")
    return JaxIndex.build(base, cfg), base


def test_bf16_build_and_search_match_jax(int_bf16):
    """The whole bf16 build (a brute-force and a searched wave, finalize):
    JAX's rows, codes and graph; searches at rescore 0 and 30 return
    JAX's ids, the distances equal (integers)."""
    jidx, base = int_bf16
    pidx = DiskannIndex.build(base, IndexConfig.from_dict(jidx.config.to_dict()),
                              device="cpu")
    _assert_same_state(pidx, jidx)
    queries = base[:30] + np.float32(1.0)
    for rescore in (0, 30):
        jids, jd = jidx.search(queries, 10, JaxParams(search_list_size=32, rescore=rescore))
        ids, d = pidx.search(queries, 10, QueryParams(search_list_size=32, rescore=rescore),
                             device="cpu")
        np.testing.assert_array_equal(ids.numpy(), jids)
        np.testing.assert_array_equal(d.numpy(), jd)


def test_add_into_bf16_index_matches_jax():
    """Storage build (Hamming traversal and prune, so the graph does not
    depend on float sums) of 400 random rows in bf16, carried to the port;
    then in both: delete 50, add 120 (50 onto tombstones, 70 fresh).  The
    stored bits, codes and graph equal JAX's after each step."""
    rng = np.random.default_rng(7)
    base = rng.standard_normal((520, 48)).astype(np.float32)
    cfg = JaxConfig(num_dimensions=48, vector_dtype="bf16", build_distance="storage")
    jidx = JaxIndex.build(base[:400], cfg)
    pidx = _carry(jidx)
    _assert_same_state(pidx, jidx)
    doomed = rng.choice(np.arange(1, 400), 50, replace=False)
    jidx.delete(doomed)
    pidx.delete(doomed)
    np.testing.assert_array_equal(pidx.add(base[400:]), jidx.add(base[400:]))
    _assert_same_state(pidx, jidx)
    assert bool(build.reachable_on_device(pidx.arrays)[: pidx.count].all())


def test_bf16_checkpoints_both_ways(int_bf16, tmp_path):
    """JAX save -> port load -> port save -> JAX load: the vectors travel
    as a uint16 bit view, every saved array equal at each hop, and the
    searches agree."""
    jidx, base = int_bf16
    jidx.save(str(tmp_path / "jax.npz"))
    pidx = DiskannIndex.load(tmp_path / "jax.npz", device="cpu")
    assert pidx.arrays.vectors.dtype == torch.bfloat16
    pidx.save(tmp_path / "port")
    with np.load(tmp_path / "jax.npz") as zj, np.load(tmp_path / "port.npz") as zp:
        assert zp["vectors"].dtype == np.uint16
        assert sorted(zj.files) == sorted(zp.files)
        for k in zj.files:
            assert zj[k].dtype == zp[k].dtype, k
            np.testing.assert_array_equal(zj[k], zp[k], err_msg=k)
    back = JaxIndex.load(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(_jax_bits(back), _jax_bits(jidx))
    jids, jd = back.search(base[:20], 5)
    ids, d = pidx.search(base[:20], 5, device="cpu")
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(d.numpy(), jd)


def _suite_labels(n, rng, n_labels=100):
    """benchmarks/suite.py run_filtered's labels: two draws with
    popularity 1/rank, kept as 1 or 2 distinct labels."""
    pop = 1.0 / np.arange(1, n_labels + 1)
    pop /= pop.sum()
    a, b = rng.choice(n_labels, size=n, p=pop), rng.choice(n_labels, size=n, p=pop)
    return [[int(x)] if x == y else [int(x), int(y)] for x, y in zip(a, b)], pop


def test_filtered_bf16_deployment_small_matches_jax():
    """chip_smoke.py phase 11's configuration at 320 rows (default
    threshold: brute-force waves)."""
    n, q = 320, 24
    vectors, queries = synthetic_corpus("cohere", n, q, seed=42)
    rng = np.random.default_rng(7)
    labels, pop = _suite_labels(n, rng)
    qlabels = [sorted(rng.choice(100, size=1 + i % 2, replace=False, p=pop).tolist())
               for i in range(q)]
    kw = dict(num_dimensions=768, num_bits_per_dimension=2, vector_dtype="bf16",
              max_labels_per_vector=2)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jbuild, jindex_mod, build, pindex_mod):
            mp.setattr(mod, "BRUTE_CANDIDATE_THRESHOLD", 4096)
        jidx = JaxIndex.build(vectors, JaxConfig(distance_type=JaxDistance.COSINE, **kw),
                              labels=labels)
        pidx = DiskannIndex.build(vectors, IndexConfig(distance_type=DistanceType.COSINE, **kw),
                                  labels=labels, device="cpu")
    host = jstore.to_host(jidx.arrays)
    np.testing.assert_array_equal(_bits(pidx)[:n], _jax_bits(jidx)[:n])
    for name in ("node_labels", "label_start_keys", "label_start_ids"):
        np.testing.assert_array_equal(getattr(pidx.arrays, name).numpy(), getattr(host, name))
    ja, pa = host.adjacency[:n], pidx.arrays.adjacency[:n].numpy()
    shared = sum(len(set(a[a >= 0]) & set(b[b >= 0])) for a, b in zip(ja, pa))
    share = shared / max(int((ja >= 0).sum()), 1)

    # Filtered exact top-10 over the float32 rows (the checker's own code).
    vn = vectors / np.linalg.norm(vectors, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    allowed = np.asarray([[bool(set(labels[i]) & set(ql)) for i in range(n)] for ql in qlabels])
    gt = np.argsort(np.where(allowed, -(qn @ vn.T), np.inf), axis=1, kind="stable")[:, :10]
    params = dict(search_list_size=50, rescore=50)
    jids, _ = jidx.search(queries, 10, JaxParams(**params), query_labels=qlabels)
    ids, _ = pidx.search(queries, 10, QueryParams(**params), query_labels=qlabels,
                         device="cpu")
    ids = ids.numpy()

    def recall(got):
        return np.mean([len(set(g) & set(t)) / 10 for g, t in zip(got, gt)])

    print(f"edges shared with JAX {share:.4f}; filtered recall@10 port "
          f"{recall(ids):.4f} jax {recall(jids):.4f}")
    assert abs(recall(ids) - recall(jids)) <= 0.02
    for row, ql in zip(ids, qlabels):
        assert all(set(labels[i]) & set(ql) for i in row if i >= 0)
    carried = _carry(jidx)
    cids, cd = carried.search(queries, 10, QueryParams(**params), query_labels=qlabels,
                              device="cpu")
    jd = jidx.search(queries, 10, JaxParams(**params), query_labels=qlabels)[1]
    np.testing.assert_array_equal(cids.numpy(), jids)
    np.testing.assert_allclose(cd.numpy(), jd, atol=1e-5, rtol=0)
