"""The port's index life cycle against the JAX package: add, delete,
compact, save and load.

- ``add`` into a JAX-built storage index carried across with
  ``from_jax_state`` gives JAX's stored vectors, codes, adjacency and ids exactly
  (tolerance: none), for a brute-force seed wave, a searched wave and a
  tombstone-reusing wave: in storage mode every distance the build sees is
  an integer.  The brute-force threshold is lowered to 256 rows in both
  packages, so a small index reaches all three.  No row 0 is deleted: the
  JAX package loses a backlink written into an empty row 0 (see
  ``test_torch_build.py::test_append_backlinks_writes_every_accepted_edge``).
- The checkpoints in ``tests/fixtures`` load in the port and reproduce
  ``expected.json`` (ids equal, distances within 1e-4, as
  ``test_upgrade.py``); a JAX save loads in the port and a port save in
  the JAX package, with every saved array equal, and both packages'
  searches agree (ids equal, distances within 1e-4: float32 dot products
  summed in two orders).
- An empty build followed by ``add``: the untrained quantizer's codes
  equal JAX's bit for bit and recall@10 is within 0.02 of JAX's.
"""

import json
import os
import sys

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
from pgvectorscale_tpu_torch import DiskannIndex, ExactIndex, IndexConfig, QueryParams, from_jax_state
from pgvectorscale_tpu_torch.graph import build
from pgvectorscale_tpu_torch.io.datasets import synthetic_corpus

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
if FIXTURES not in sys.path:
    sys.path.insert(0, FIXTURES)
from make_fixtures import fixture_data  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _recall(ids, gt):
    return float(np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(ids, gt)]))


def _assert_same_state(pidx, jidx):
    n = jidx.count
    host = jstore.to_host(jidx.arrays)
    assert pidx.count == n and pidx.arrays.default_start == int(host.default_start)
    np.testing.assert_array_equal(pidx.arrays.codes[:n].numpy().view(np.uint32), host.codes[:n])
    np.testing.assert_array_equal(pidx.arrays.vectors[:n].numpy(), host.vectors[:n])
    np.testing.assert_array_equal(pidx.arrays.adjacency[:n].numpy(), host.adjacency[:n])
    np.testing.assert_array_equal(pidx.arrays.deleted[:n].numpy(), host.deleted[:n])
    np.testing.assert_array_equal(pidx.external_ids, jidx.external_ids)
    assert pidx.arrays.capacity == jidx.arrays.capacity


def test_add_and_tombstone_reuse_match_jax(monkeypatch):
    """Build 200 rows (JAX), carry them across, then in both packages: add
    300 (brute-force seed wave), add 300 (searched wave), delete 60, add 50
    (onto tombstones, full-graph wave), add 100 (reuse 10, then 90 fresh).
    Equal state after every step."""
    for mod, name in ((jbuild, "BRUTE_CANDIDATE_THRESHOLD"),
                      (jindex_mod, "BRUTE_CANDIDATE_THRESHOLD"),
                      (build, "BRUTE_CANDIDATE_THRESHOLD"),
                      (pindex_mod, "BRUTE_CANDIDATE_THRESHOLD")):
        monkeypatch.setattr(mod, name, 256)
    base, _ = synthetic_corpus("glove", 950, 1, seed=8)
    base = base[:, :48].copy()
    jidx = JaxIndex.build(base[:200], JaxConfig(num_dimensions=48, distance_type=JaxDistance.L2,
                                                build_distance="storage"))
    pidx = from_jax_state(jstore.to_host(jidx.arrays), jidx.sbq_stats, jidx.config,
                          device="cpu")
    _assert_same_state(pidx, jidx)
    rng = np.random.default_rng(9)
    pos = 200
    for step in ("add", "add", "delete", "add", "add"):
        if step == "delete":
            doomed = rng.choice(np.arange(1, jidx.count), 60, replace=False)
            jidx.delete(doomed)
            pidx.delete(doomed)
        else:
            m = {200: 300, 500: 300, 800: 50, 850: 100}[pos]
            want = jidx.add(base[pos : pos + m])
            got = pidx.add(base[pos : pos + m])
            np.testing.assert_array_equal(got, want)
            pos += m
        _assert_same_state(pidx, jidx)
    assert pidx.num_deleted == 0 and pidx.count == 890
    assert bool(build.reachable_on_device(pidx.arrays)[: pidx.count].all())


def test_empty_build_then_add_vs_jax():
    """An empty index stays untrained: add encodes with the sign rule,
    codes equal JAX's bit for bit, every row is reachable, and recall@10
    is within 0.02 of JAX's."""
    base, queries = synthetic_corpus("glove", 1300, 40, seed=12)
    base, queries = base[:, :64].copy(), queries[:, :64].copy()
    config = IndexConfig(num_dimensions=64, build_distance="storage")
    pidx = DiskannIndex.build(np.zeros((0, 64), np.float32), config, device="cpu")
    assert pidx.count == 0 and pidx.sbq_stats.count == 0
    jidx = JaxIndex.build(np.zeros((0, 64), np.float32),
                          JaxConfig(num_dimensions=64, build_distance="storage"))
    for lo, hi in ((0, 700), (700, 1300)):
        np.testing.assert_array_equal(pidx.add(base[lo:hi]), jidx.add(base[lo:hi]))
    n = pidx.count
    np.testing.assert_array_equal(pidx.arrays.codes[:n].numpy().view(np.uint32),
                                  np.asarray(jidx.arrays.codes)[:n])
    assert bool(build.reachable_on_device(pidx.arrays)[:n].all())
    deg = (pidx.arrays.adjacency[:n] != -1).sum(1)
    assert int(deg.max()) <= config.max_neighbors_during_build
    gt = ExactIndex.build(base, config, device="cpu").search(queries, 10)[0].numpy()
    p_recall = _recall(pidx.search(queries, 10, device="cpu")[0].numpy(), gt)
    j_recall = _recall(jidx.search(queries, 10)[0], gt)
    print(f"empty build + add recall@10 port {p_recall:.4f} jax {j_recall:.4f}")
    assert abs(p_recall - j_recall) <= 0.02


@pytest.mark.parametrize("version", [1, 2, 3])
def test_fixture_checkpoints_load_and_search(version):
    """Every committed checkpoint version loads in the port and reproduces
    the recorded search results."""
    index = DiskannIndex.load(os.path.join(FIXTURES, f"checkpoint_v{version}.npz"),
                              device="cpu")
    assert index.count == 64
    _, queries = fixture_data()
    with open(os.path.join(FIXTURES, "expected.json")) as f:
        exp = json.load(f)
    ids, dists = index.search(
        queries, k=exp["k"], device="cpu",
        params=QueryParams(search_list_size=exp["search_list_size"], rescore=exp["rescore"]),
    )
    np.testing.assert_array_equal(ids.numpy(), np.asarray(exp["ids"]))
    np.testing.assert_allclose(dists.numpy(), np.asarray(exp["dists"]), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def churned():
    """A port-built storage index after deletes and a tombstone-reusing add
    with explicit external ids, and its queries."""
    base, queries = synthetic_corpus("glove", 900, 30, seed=21)
    base, queries = base[:, :32].copy(), queries[:, :32].copy()
    pidx = DiskannIndex.build(base[:800], IndexConfig(num_dimensions=32,
                                                      build_distance="storage"),
                              device="cpu")
    pidx.delete(np.arange(3, 800, 7))
    pidx.add(base[800:], external_ids=np.arange(5000, 5100))
    return pidx, queries


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_checkpoints_cross_load_both_ways(churned, tmp_path):
    """Port save -> JAX load -> JAX save -> port load: every saved array
    equal at each hop, and the two packages' searches agree."""
    pidx, queries = churned
    pidx.save(tmp_path / "port")
    jidx = JaxIndex.load(str(tmp_path / "port.npz"))
    jidx.save(str(tmp_path / "jax.npz"))
    port_z, jax_z = _npz(tmp_path / "port.npz"), _npz(tmp_path / "jax.npz")
    assert sorted(port_z) == sorted(jax_z)
    for k in port_z:
        assert port_z[k].dtype == jax_z[k].dtype, k
        np.testing.assert_array_equal(port_z[k], jax_z[k], err_msg=k)
    back = DiskannIndex.load(tmp_path / "jax.npz", device="cpu")
    back.save(tmp_path / "again")
    for k, v in _npz(tmp_path / "again.npz").items():
        np.testing.assert_array_equal(v, jax_z[k], err_msg=k)

    params = dict(search_list_size=40, rescore=20)
    j_ids, j_d = jidx.search(queries, 10, JaxParams(**params))
    for index in (pidx, back):
        ids, d = index.search(queries, 10, QueryParams(**params), device="cpu")
        np.testing.assert_array_equal(ids.numpy(), j_ids)
        np.testing.assert_allclose(d.numpy(), j_d, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(index.to_external(ids), jidx.to_external(j_ids))


def test_delete_and_compact(churned):
    """Deleted rows never come back from a search, delete_external finds
    rows by external id, and compact keeps the external ids of the live
    rows with every row reachable."""
    pidx, queries = churned
    before = pidx.num_deleted
    pidx.delete_external([5001, 5003, 11])
    assert pidx.num_deleted == before + 3
    for rescore in (0, 50):
        ids, _ = pidx.search(queries, 20, QueryParams(search_list_size=60, rescore=rescore),
                             device="cpu")
        found = ids.numpy()[ids.numpy() >= 0]
        assert not pidx._deleted_np[found].any()
        assert not np.isin(pidx.to_external(found), [5001, 5003, 11]).any()
    live = np.nonzero(~pidx._deleted_np[: pidx.count])[0]
    compacted = pidx.compact()
    assert compacted.count == pidx.num_live == len(live)
    np.testing.assert_array_equal(compacted.external_ids, pidx.external_ids[live])
    assert bool(build.reachable_on_device(compacted.arrays)[: compacted.count].all())
    ids, _ = compacted.search(queries, 5, device="cpu")
    assert (ids.numpy() >= 0).all()


@pytest.mark.parametrize("change", ["int8", "journal", "future", "magic"])
def test_load_refuses_what_the_port_does_not_read(tmp_path, change):
    """A newer version, a foreign file or vectors that are not of the
    checkpoint's tier (f32 rows under an int8 config) are refused
    (ValueError).  A journal beside the file is replayed: an empty one
    gives the plain load's index."""
    z = _npz(os.path.join(FIXTURES, "checkpoint_v3.npz"))
    cfg = json.loads(bytes(z["config"]).decode())
    err = None
    if change == "int8":
        cfg["vector_dtype"], err = "int8", ValueError
    elif change == "journal":
        os.makedirs(tmp_path / "ckpt.npz.journal")
    elif change == "future":
        z["version"], err = np.int64(4), ValueError
    else:
        z["magic"], err = np.int64(0x1234), ValueError
    z["config"] = np.frombuffer(json.dumps(cfg).encode(), dtype=np.uint8)
    np.savez_compressed(tmp_path / "ckpt.npz", **z)
    if err is None:
        got = DiskannIndex.load(tmp_path / "ckpt.npz", device="cpu")
        want = DiskannIndex.load(os.path.join(FIXTURES, "checkpoint_v3.npz"), device="cpu")
        assert got._journal is None and got.count == want.count == 64
        for f in got.arrays._fields:
            a, b = getattr(got.arrays, f), getattr(want.arrays, f)
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f
        np.testing.assert_array_equal(got.external_ids, want.external_ids)
        return
    with pytest.raises(err):
        DiskannIndex.load(tmp_path / "ckpt.npz", device="cpu")


def test_load_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiskannIndex.load(os.path.join(FIXTURES, "checkpoint_v3.npz"))


@pytest.fixture(scope="module")
def exact_built(tmp_path_factory):
    """A JAX-built 64 x 16 SBQ index with build_distance "exact" (full
    precision traversal), its queries and its checkpoint."""
    base, queries = synthetic_corpus("glove", 64, 12, seed=31)
    base, queries = base[:, :16].copy(), queries[:, :16].copy()
    jidx = JaxIndex.build(base, JaxConfig(num_dimensions=16, build_distance="exact"))
    path = str(tmp_path_factory.mktemp("exact") / "exact.npz")
    jidx.save(path)
    return jidx, queries, path


@pytest.mark.parametrize("via", ["from_jax_state", "load"])
def test_exact_built_index_searches_like_jax(exact_built, via):
    """The port carries (from_jax_state) or loads (the JAX package's
    save) an SBQ index built with build_distance "exact" and searches it
    as JAX does: at rescore 0 the distances are Hamming integers and equal
    exactly; at rescore 20 the ids are equal and the distances within 1e-5
    (float32 dot products summed in two orders).  ``add`` then inserts
    with full-precision traversal, as JAX's does (same ids, every row
    reachable; exact parity on integer vectors is in
    ``test_torch_plain.py``), and leaves the arrays it replaced as they
    were."""
    jidx, queries, path = exact_built
    if via == "load":
        pidx = DiskannIndex.load(path, device="cpu")
    else:
        pidx = from_jax_state(jstore.to_host(jidx.arrays), jidx.sbq_stats,
                              jidx.config, device="cpu")
    assert pidx.config.build_distance == "exact" and pidx.count == 64
    for rescore in (0, 20):
        j_ids, j_d = jidx.search(queries, 5, JaxParams(search_list_size=32, rescore=rescore))
        ids, d = pidx.search(queries, 5, QueryParams(search_list_size=32, rescore=rescore),
                             device="cpu")
        np.testing.assert_array_equal(ids.numpy(), j_ids)
        if rescore == 0:
            np.testing.assert_array_equal(d.numpy(), j_d)
        else:
            np.testing.assert_allclose(d.numpy(), j_d, atol=1e-5, rtol=0)
    arrays = pidx.arrays
    adjacency = arrays.adjacency.clone()
    want = JaxIndex.load(path).add(queries[:4])  # a copy: the fixture stays as built
    np.testing.assert_array_equal(pidx.add(queries[:4]), want)
    assert pidx.arrays is not arrays and pidx.count == 68 and arrays.count == 64
    assert torch.equal(arrays.adjacency, adjacency)
    assert bool(build.reachable_on_device(pidx.arrays)[:68].all())
