"""The int8 vector tier, ``merge_stats`` and the chunked ingest of the port
against the JAX package.

- ``quantize_rows`` is bit-equal to the JAX package's under ``jit``, the
  form its every ingest runs (XLA folds the division by 127 into a product
  with the float32 reciprocal), all-zero rows and round-half-even ties
  included; ``dequant_rows`` is bit-equal (one float32 product a value).
- The int8 rescore (``_exact_batch_distances``: the scale factored out of
  the sum, the query split into two bf16 halves, float32 accumulation)
  agrees with JAX's for L2, inner product and cosine within 1e-5 absolute
  on unit rows and 1e-6 relative on raw rows (float32 sums of exact
  products in two orders), with equal top-10 ids.
- Whole int8 builds give JAX's stored rows, scales, codes and graph
  exactly.  The rows hold integers in -3..3 beside one constant column of
  127, so every row's scale is exactly 1.0 and every L2 distance an integer
  in any summation order; the brute-force threshold is lowered to 256 rows
  (a brute-force and a searched wave) and JAX's ``append_backlinks``
  replaced by ``test_torch_plain.py``'s copy without its row-0 fault, as
  in ``test_torch_bf16.py``.  Searches return JAX's ids and distances.
- ``add``, ``delete``, the tombstone-reusing add and ``compact`` on an
  int8 storage index (Hamming build: no float sums in the graph) keep
  JAX's rows, scales, codes and graph exactly; checkpoints cross-load both
  ways with every saved array equal.
- ``merge_stats`` agrees with JAX on a chain of chunks within 1e-6
  relative; ``_ingest_chunked`` (chunk rows patched small, in the port
  only) agrees with JAX's ``_train_chunk_jit`` / ``_ingest_chunk_jit`` over
  the same chunk boundaries: statistics within 1e-6 relative (float32 sums
  in two orders), codes, rows and scales equal.  ``build`` takes the
  chunked path exactly when JAX's would, and a labeled build that takes it
  registers its label starts as JAX does.
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
from pgvectorscale_tpu.ops import sbq as jsbq
import pgvectorscale_tpu_torch.index as pindex_mod
from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig, QueryParams, from_jax_state
from pgvectorscale_tpu_torch import store
from pgvectorscale_tpu_torch.config import DistanceType
from pgvectorscale_tpu_torch.graph import build
from pgvectorscale_tpu_torch.ops import sbq
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


def _carry(jidx):
    return from_jax_state(jstore.to_host(jidx.arrays), jidx.sbq_stats, jidx.config,
                          external_ids=jidx.external_ids, device="cpu")


def _assert_same_state(pidx, jidx):
    n = jidx.count
    host = jstore.to_host(jidx.arrays)
    assert pidx.arrays.vectors.dtype == torch.int8 and pidx.count == n
    np.testing.assert_array_equal(pidx.arrays.vectors[:n].numpy(), host.vectors[:n])
    np.testing.assert_array_equal(pidx.arrays.vec_scales[:n].numpy(), host.vec_scales[:n])
    np.testing.assert_array_equal(pidx.arrays.codes[:n].numpy().view(np.uint32), host.codes[:n])
    np.testing.assert_array_equal(pidx.arrays.adjacency[:n].numpy(), host.adjacency[:n])
    np.testing.assert_array_equal(pidx.arrays.deleted[:n].numpy(), host.deleted[:n])
    np.testing.assert_array_equal(pidx.external_ids, jidx.external_ids)


@pytest.mark.parametrize("d", [48, 768])
def test_quantize_and_dequant_rows_match_jax(d):
    """Random rows, an all-zero row and rows whose quotients fall on .5:
    values and scales bit-equal to JAX's jitted ``quantize_rows``, the
    dequantized rows to JAX's ``dequant_rows``."""
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((64, d)).astype(np.float32) * 2.5
    rows[5] = 0.0
    # maxabs 127 -> scale exactly 1.0: the half-integers are ties.
    rows[6] = 0.0
    rows[6, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -126.5, 3.5]
    got_q, got_s = store.quantize_rows(torch.from_numpy(rows))
    want_q, want_s = jax.jit(jstore.quantize_rows)(jnp.asarray(rows))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert float(got_s[6]) == 1.0 and float(got_s[5]) == 1.0
    np.testing.assert_array_equal(got_q[6, :8].numpy(), [127, 0, 2, 2, 0, -2, -126, 4])
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    idx = rng.integers(0, 64, (7, 5))
    got = store.dequant_rows(got_q, got_s, torch.from_numpy(idx))
    want = jstore.dequant_rows(want_q, want_s, jnp.asarray(idx))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(store.dequant_rows(got_q, got_s, 5).numpy(), rows[5])


@pytest.mark.parametrize("jd,pd", DISTANCES)
def test_int8_rescore_matches_jax(jd, pd):
    """16 queries, 50 int8 rows each (invalid ids among them), on unit
    rows and queries (every distance within [-1, 4]): the split bf16
    rescore within 1e-5 absolute of JAX's; on raw standard-normal rows (L2
    distances up to ~110, where 1e-5 is about one float32 ulp) within 1e-6
    relative.  Top-10 ids equal in both."""
    rng = np.random.default_rng(4)
    raw = rng.standard_normal((300, 40)).astype(np.float32)
    raw_q = rng.standard_normal((16, 40)).astype(np.float32)
    ids = rng.integers(-1, 300, (16, 50)).astype(np.int32)
    unit = (raw / np.linalg.norm(raw, axis=1, keepdims=True),
            raw_q / np.linalg.norm(raw_q, axis=1, keepdims=True), dict(rtol=0, atol=1e-5))
    cases = [unit] if pd == DistanceType.COSINE else [unit, (raw, raw_q, dict(rtol=1e-6))]
    for rows, qv, tol in cases:
        q8, sc = jax.jit(jstore.quantize_rows)(jnp.asarray(rows))
        want = np.asarray(jindex_mod._exact_batch_distances(
            q8, sc, jnp.asarray(qv), jnp.asarray(ids), distance_type=jd))
        got = pindex_mod._exact_batch_distances(
            torch.from_numpy(np.array(q8)), torch.from_numpy(np.array(sc)),
            torch.from_numpy(qv), torch.from_numpy(ids), pd)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **tol)
        top = np.argsort(want, axis=1, kind="stable")[:, :10]
        np.testing.assert_array_equal(np.argsort(got.numpy(), axis=1, kind="stable")[:, :10],
                                      top)


def _int_rows(n, seed):
    """Integers in -3..3 beside a constant column of 127: each row's scale
    is exactly 1.0 and its int8 row equals it."""
    rows = np.random.default_rng(seed).integers(-3, 4, (n, 33)).astype(np.float32)
    rows[:, 32] = 127.0
    return rows


@pytest.fixture(scope="module")
def int8_l2():
    """A JAX int8 exact-prune build (L2) of 320 such rows, and the rows."""
    base = _int_rows(320, 5)
    cfg = JaxConfig(num_dimensions=33, distance_type=JaxDistance.L2, num_neighbors=16,
                    search_list_size=32, vector_dtype="int8")
    return JaxIndex.build(base, cfg), base


def test_int8_build_and_search_match_jax(int8_l2):
    """The whole int8 build (a brute-force and a searched wave, finalize):
    JAX's rows, scales, codes and graph; searches at rescore 0 and 30
    return JAX's ids and distances (integers)."""
    jidx, base = int8_l2
    pidx = DiskannIndex.build(base, IndexConfig.from_dict(jidx.config.to_dict()), device="cpu")
    _assert_same_state(pidx, jidx)
    assert float(pidx.arrays.vec_scales[:320].min()) == 1.0 == float(
        pidx.arrays.vec_scales[:320].max())
    queries = base[:30].copy()
    queries[:, :32] += np.float32(1.0)
    for rescore in (0, 30):
        jids, jd = jidx.search(queries, 10, JaxParams(search_list_size=32, rescore=rescore))
        ids, d = pidx.search(queries, 10, QueryParams(search_list_size=32, rescore=rescore),
                             device="cpu")
        np.testing.assert_array_equal(ids.numpy(), jids)
        np.testing.assert_array_equal(d.numpy(), jd)


def test_int8_add_delete_reuse_and_compact_match_jax():
    """An int8 storage build of 260 random rows (L2: the rows are quantized
    as given; cosine's normalization sums in two orders), carried to the
    port; then in both: delete 40, add 60 (40 onto tombstones, 20 fresh),
    delete 30, compact.  Rows, scales, codes and graph equal JAX's after each step;
    a reader's arrays are left as they were by the reuse add."""
    rng = np.random.default_rng(7)
    base = rng.standard_normal((320, 48)).astype(np.float32)
    cfg = JaxConfig(num_dimensions=48, vector_dtype="int8", build_distance="storage",
                    distance_type=JaxDistance.L2)
    jidx = JaxIndex.build(base[:260], cfg)
    pidx = _carry(jidx)
    _assert_same_state(pidx, jidx)
    doomed = rng.choice(np.arange(1, 260), 40, replace=False)
    jidx.delete(doomed)
    pidx.delete(doomed)
    held = pidx.arrays
    held_scales = held.vec_scales.clone()
    np.testing.assert_array_equal(pidx.add(base[260:]), jidx.add(base[260:]))
    assert torch.equal(held.vec_scales, held_scales) and pidx.arrays is not held
    _assert_same_state(pidx, jidx)
    assert bool(build.reachable_on_device(pidx.arrays)[: pidx.count].all())
    doomed = rng.choice(np.arange(1, 280), 30, replace=False)
    jidx.delete(doomed)
    pidx.delete(doomed)
    jc, pc = jidx.compact(), pidx.compact()
    assert pc.count == jc.count == 250
    _assert_same_state(pc, jc)


def test_int8_checkpoints_both_ways(int8_l2, tmp_path):
    """JAX save -> port load -> port save -> JAX load: int8 rows and their
    scales travel as saved, every saved array equal at each hop, and the
    searches agree."""
    jidx, base = int8_l2
    jidx.save(str(tmp_path / "jax.npz"))
    pidx = DiskannIndex.load(tmp_path / "jax.npz", device="cpu")
    assert pidx.arrays.vectors.dtype == torch.int8
    pidx.save(tmp_path / "port")
    with np.load(tmp_path / "jax.npz") as zj, np.load(tmp_path / "port.npz") as zp:
        assert zp["vectors"].dtype == np.int8
        assert sorted(zj.files) == sorted(zp.files)
        for k in zj.files:
            assert zj[k].dtype == zp[k].dtype, k
            np.testing.assert_array_equal(zj[k], zp[k], err_msg=k)
    back = JaxIndex.load(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(np.asarray(back.arrays.vec_scales),
                                  np.asarray(jidx.arrays.vec_scales))
    jids, jd = back.search(base[:20], 5)
    ids, d = pidx.search(base[:20], 5, device="cpu")
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(d.numpy(), jd)


def test_merge_stats_matches_jax():
    """Five chunks of different sizes merged into an empty start, one at
    a time, as the chunked ingest does: within 1e-6 relative of JAX."""
    rng = np.random.default_rng(11)
    sizes = (100, 37, 256, 1, 90)
    jst = jindex_mod._empty_stats(24)
    pst = sbq.empty_stats(24, "cpu")
    for c in sizes:
        x = (rng.standard_normal((c, 24)) * 3 + 1).astype(np.float32)
        jst = jsbq.merge_stats(jst, jsbq.train(jnp.asarray(x)))
        pst = sbq.merge_stats(pst, sbq.train(torch.from_numpy(x)))
    assert pst.count == int(jst.count) == sum(sizes)
    np.testing.assert_allclose(pst.mean.numpy(), np.asarray(jst.mean), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pst.m2.numpy(), np.asarray(jst.m2), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["int8", "f32"])
def test_ingest_chunked_matches_jax_chunk_steps(dtype, monkeypatch):
    """320 rows in chunks of 100 (the chunk rule patched in the port
    only): the port's ``_ingest_chunked`` against JAX's train and ingest
    steps over the same boundaries.  L2, so the rows are stored as given:
    cosine normalization sums in two orders and moves ~9% of the
    normalized values by one float32 ulp."""
    monkeypatch.setattr(pindex_mod, "_ingest_chunk_rows", lambda n, d: 100)
    vectors = np.random.default_rng(12).standard_normal((320, 48)).astype(np.float32) * 2
    kw = dict(num_dimensions=48, vector_dtype=dtype)
    jcfg = JaxConfig(distance_type=JaxDistance.L2, **kw)
    pcfg = IndexConfig(distance_type=DistanceType.L2, **kw)
    stats = jindex_mod._empty_stats(48)
    for i0 in range(0, 320, 100):
        stats = jindex_mod._train_chunk_jit(stats, jnp.asarray(vectors[i0 : i0 + 100]),
                                            config=jcfg)
    arrays = jstore.empty_arrays(jcfg, 1024)
    for i0 in range(0, 320, 100):
        arrays = jindex_mod._ingest_chunk_jit(
            arrays, jnp.asarray(vectors[i0 : i0 + 100]), stats, jnp.asarray(i0, jnp.int32),
            config=jcfg)
    parrays, pstats = pindex_mod._ingest_chunked(vectors, pcfg, 1024, None,
                                                 torch.device("cpu"))
    assert pstats.count == int(stats.count) == 320 and parrays.count == 320
    np.testing.assert_allclose(pstats.mean.numpy(), np.asarray(stats.mean), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(pstats.m2.numpy(), np.asarray(stats.m2), rtol=1e-6)
    host = jstore.to_host(arrays)
    np.testing.assert_array_equal(store.vectors_to_host(parrays.vectors), host.vectors)
    np.testing.assert_array_equal(parrays.vec_scales.numpy(), host.vec_scales)
    np.testing.assert_array_equal(parrays.codes.numpy().view(np.uint32), host.codes)


def test_build_takes_the_chunked_ingest_when_jax_does(monkeypatch):
    """With the limit set to 320 x 48 x 4 - 1 bytes, a host array of 320
    rows takes the chunked ingest, 319 rows or a tensor do not, as in the
    JAX package's rule."""
    calls = []
    real = pindex_mod._ingest_chunked
    monkeypatch.setattr(pindex_mod, "INGEST_CHUNK_BYTES", 320 * 48 * 4 - 1)
    monkeypatch.setattr(pindex_mod, "_ingest_chunked",
                        lambda *a: calls.append(a[0].shape[0]) or real(*a))
    vectors = np.random.default_rng(13).standard_normal((320, 48)).astype(np.float32)
    cfg = IndexConfig(num_dimensions=48, vector_dtype="int8", build_distance="storage")
    one = DiskannIndex.build(vectors, cfg, device="cpu")
    DiskannIndex.build(vectors[:319], cfg, device="cpu")
    DiskannIndex.build(torch.from_numpy(vectors), cfg, device="cpu")
    assert calls == [320]
    # One chunk of 1,024 rows holds them all: the same store as one shot.
    two = DiskannIndex.build(torch.from_numpy(vectors), cfg, device="cpu")
    assert torch.equal(one.arrays.vectors, two.arrays.vectors)
    assert torch.equal(one.arrays.codes, two.arrays.codes)


def test_labeled_int8_chunked_build_registers_label_starts(monkeypatch):
    """A labeled int8 build of 320 rows that takes the chunked ingest in
    both packages (three chunks in the port) keeps JAX's node labels,
    label table and rows."""
    rng = np.random.default_rng(14)
    vectors = rng.standard_normal((320, 64)).astype(np.float32)
    labels = [sorted(set(rng.integers(0, 12, 1 + i % 2).tolist())) for i in range(320)]
    for mod in (jindex_mod, pindex_mod):
        monkeypatch.setattr(mod, "INGEST_CHUNK_BYTES", 1024)
    monkeypatch.setattr(pindex_mod, "_ingest_chunk_rows", lambda n, d: 128)
    calls = []
    real = pindex_mod._ingest_chunked
    monkeypatch.setattr(pindex_mod, "_ingest_chunked",
                        lambda *a: calls.append(a[0].shape[0]) or real(*a))
    kw = dict(num_dimensions=64, vector_dtype="int8", build_distance="storage",
              max_labels_per_vector=2, distance_type=JaxDistance.L2)
    jidx = JaxIndex.build(vectors, JaxConfig(**kw), labels=labels)
    pidx = DiskannIndex.build(vectors, IndexConfig.from_dict(jidx.config.to_dict()),
                              labels=labels, device="cpu")
    assert calls == [320]
    host = jstore.to_host(jidx.arrays)
    for name in ("node_labels", "label_start_keys", "label_start_ids"):
        np.testing.assert_array_equal(getattr(pidx.arrays, name).numpy(), getattr(host, name))
    assert int((host.label_start_keys != np.iinfo(np.int32).max).sum()) == 12
    np.testing.assert_array_equal(pidx.arrays.vectors[:320].numpy(), host.vectors[:320])
