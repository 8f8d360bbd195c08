"""The port's mutation journal and crash recovery (``durability.py``), and
the journal's format against the JAX package's.

- The port's versions of ``test_durability.py``'s single-device tests: a
  CPU child process killed with SIGKILL after journaled mutations is
  recovered by ``load`` to bit-equal search results (ids and distances,
  tolerance none: the same code on the same inputs and thread count);
  ``save`` truncates the journal; ``auto_checkpoint_every`` bounds it; a
  plain ``load`` leaves the index detached; a corrupt record is refused.
- The records are byte-compatible: the same keys, dtypes and values from
  both packages' ``MutationJournal``.
- A journal written by the JAX package replays in the port to the JAX
  index's state, and the reverse: storage builds on L2 (every distance an
  integer), the brute-force threshold lowered to 256 rows in both
  packages, and JAX's ``append_backlinks`` replaced by
  ``test_torch_plain.py``'s copy without its row-0 fault, so both
  packages build the same graph from an empty one (tolerance: none).
- Write-ahead: an ``add`` that fails after validation leaves the index
  as it was and its record in the journal, as in the JAX package.
"""

import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import pgvectorscale_tpu.index as jindex_mod
from pgvectorscale_tpu import DiskannIndex as JaxIndex
from pgvectorscale_tpu import IndexConfig as JaxConfig
from pgvectorscale_tpu import durability as jdurability
from pgvectorscale_tpu import store as jstore
from pgvectorscale_tpu.config import DistanceType as JaxDistance
from pgvectorscale_tpu.graph import build as jbuild
import pgvectorscale_tpu_torch.index as pindex_mod
from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig, QueryParams
from pgvectorscale_tpu_torch import durability
from pgvectorscale_tpu_torch.config import DistanceType
from pgvectorscale_tpu_torch.graph import build
from pgvectorscale_tpu_torch.io.datasets import synthetic_corpus
from test_torch_plain import _append_backlinks_dropping_misfits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_D = 32
THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def _setup():
    prev = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jbuild, jindex_mod, build, pindex_mod):
            mp.setattr(mod, "BRUTE_CANDIDATE_THRESHOLD", 256)
        mp.setattr(jbuild, "append_backlinks", _append_backlinks_dropping_misfits)
        jax.clear_caches()
        yield
    jax.clear_caches()
    torch.set_num_threads(prev)


def _config():
    return IndexConfig(num_dimensions=_D, distance_type=DistanceType.L2,
                       num_neighbors=16, search_list_size=32)


def _corpus(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, _D)).astype(np.float32)


def _build(vectors):
    return DiskannIndex.build(vectors, _config(), device="cpu")


# Child workload: build -> enable_durability -> add -> delete -> add ->
# SIGKILL.  Seeded, so the parent can rebuild the expected state.
_CHILD = """
import os, signal, sys
import numpy as np
import torch
sys.path.insert(0, {repo!r})
torch.set_num_threads({threads})
from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig
from pgvectorscale_tpu_torch.config import DistanceType
from pgvectorscale_tpu_torch.graph import build
import pgvectorscale_tpu_torch.index as pindex_mod
build.BRUTE_CANDIDATE_THRESHOLD = pindex_mod.BRUTE_CANDIDATE_THRESHOLD = 256

vectors = np.random.default_rng(0).standard_normal((320, 32)).astype(np.float32)
config = IndexConfig(num_dimensions=32, distance_type=DistanceType.L2,
                     num_neighbors=16, search_list_size=32)
index = DiskannIndex.build(vectors[:200], config, device="cpu")
index.enable_durability({path!r})
index.add(vectors[200:280])
index.delete(np.arange(5, dtype=np.int32))
index.add(vectors[280:320])
sys.stdout.write("mutated\\n")
sys.stdout.flush()
os.kill(os.getpid(), signal.SIGKILL)  # crash WITHOUT saving
"""


def test_kill9_recovers_all_committed_mutations(tmp_path):
    """A child on the CPU builds, attaches a journal, adds (a searched wave
    past the lowered threshold), deletes, adds onto the tombstones, and is
    killed; ``load`` replays the three records to the state a
    straight-through run reaches, bit for bit."""
    path = str(tmp_path / "durable.npz")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(repo=ROOT, path=path, threads=THREADS)],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    assert "mutated" in proc.stdout
    assert len(os.listdir(path + ".journal")) == 3

    recovered = DiskannIndex.load(path, device="cpu")
    assert recovered._journal is None
    vectors = _corpus(320)
    expected = _build(vectors[:200])
    expected.add(vectors[200:280])
    expected.delete(np.arange(5, dtype=np.int32))
    expected.add(vectors[280:320])

    assert recovered.num_live == expected.num_live == 315
    np.testing.assert_array_equal(recovered.external_ids, expected.external_ids)
    for f in ("adjacency", "codes", "vectors", "deleted"):
        assert torch.equal(getattr(recovered.arrays, f), getattr(expected.arrays, f)), f
    params = QueryParams(search_list_size=48, rescore=64)
    qs = vectors[100:140]
    ids_r, d_r = recovered.search(qs, 10, params, device="cpu")
    ids_e, d_e = expected.search(qs, 10, params, device="cpu")
    assert torch.equal(ids_r, ids_e) and torch.equal(d_r, d_e)
    # The second add reused the five tombstones.
    assert recovered.num_deleted == 0
    np.testing.assert_array_equal(recovered.external_ids[:5], np.arange(280, 285))


def test_save_truncates_journal(tmp_path):
    path = str(tmp_path / "ck.npz")
    vectors = _corpus(200, seed=1)
    index = _build(vectors[:150])
    index.enable_durability(path)
    index.add(vectors[150:180])
    index.delete(np.arange(3, dtype=np.int32))
    assert len(index._journal) == 2
    index.checkpoint()
    assert len(index._journal) == 0
    index.add(vectors[180:200])  # journals afresh, replays on load
    assert len(index._journal) == 1
    loaded = DiskannIndex.load(path, device="cpu")
    assert loaded.num_live == index.num_live == 197
    other = str(tmp_path / "other.npz")
    index.save(other)  # another path leaves the journal alone
    assert len(index._journal) == 1


def test_auto_checkpoint_every_bounds_replay(tmp_path):
    path = str(tmp_path / "auto.npz")
    vectors = _corpus(300, seed=2)
    index = _build(vectors[:200])
    index.enable_durability(path, auto_checkpoint_every=30)
    index.add(vectors[200:220])  # 20 pending, below the bound
    assert len(index._journal) == 1
    index.add(vectors[220:240])  # 40 >= 30: consolidates
    assert len(index._journal) == 0
    assert index._dur_pending == 0
    assert DiskannIndex.load(path, device="cpu").num_live == 240


def test_journal_detached_after_plain_load(tmp_path):
    """``load`` replays but does not keep journaling; a new
    ``enable_durability`` consolidates and reattaches."""
    path = str(tmp_path / "plain.npz")
    vectors = _corpus(160, seed=3)
    index = _build(vectors[:150])
    index.enable_durability(path)
    index.add(vectors[150:])
    loaded = DiskannIndex.load(path, device="cpu")
    assert loaded._journal is None
    loaded.add(_corpus(4, seed=6))  # not journaled
    assert len(os.listdir(path + ".journal")) == 1
    loaded.enable_durability(path)
    assert len(loaded._journal) == 0  # consolidated into the checkpoint
    assert DiskannIndex.load(path, device="cpu").num_live == 164


def test_corrupt_journal_record_rejected(tmp_path):
    path = str(tmp_path / "bad.npz")
    index = _build(_corpus(150, seed=4))
    index.enable_durability(path)
    index.add(_corpus(8, seed=5))
    rec = os.path.join(path + ".journal", sorted(os.listdir(path + ".journal"))[0])
    with open(rec, "wb") as f:
        np.savez_compressed(f, magic=np.int64(0), op=np.frombuffer(b"add", dtype=np.uint8))
    with pytest.raises(ValueError, match="corrupt journal record"):
        DiskannIndex.load(path, device="cpu")


def test_checkpoint_needs_durability():
    with pytest.raises(ValueError, match="durability not enabled"):
        _build(_corpus(20, seed=7)).checkpoint()


def test_records_match_the_jax_package_byte_for_byte(tmp_path):
    """An add with labels and a delete, journaled by each package: the
    same file names, keys, dtypes and values."""
    from pgvectorscale_tpu.labels import make_label_array as jlabels
    from pgvectorscale_tpu_torch.labels import make_label_array

    rng = np.random.default_rng(8)
    vec = rng.standard_normal((5, 6)).astype(np.float32)
    ext = np.arange(40, 45)
    labels = [[3], None, [1, 7], [], [2]]
    np.testing.assert_array_equal(make_label_array(labels, 2), jlabels(labels, 2))
    recs = []
    for mod, make, name in ((durability, make_label_array, "port"),
                            (jdurability, jlabels, "jax")):
        j = mod.MutationJournal(str(tmp_path / f"{name}.npz"))
        j.append_add(vec, ext, make(labels, 2))
        j.append_add(vec[:2], ext[:2])
        j.append_delete(np.array([4, 1]))
        assert sorted(os.listdir(j.dir)) == [f"{i:09d}.npz" for i in (1, 2, 3)]
        recs.append(list(j.records()))
    for a, b in zip(*recs):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])


def _lifecycle(index, base):
    """add 300 (searched waves past the lowered threshold), delete 30 (not
    row 0), add 50 onto the tombstones."""
    index.add(base[200:500])
    index.delete(np.arange(7, 217, 7, dtype=np.int32))
    index.add(base[500:550])


def _assert_same(pidx, jidx):
    n = jidx.count
    host = jstore.to_host(jidx.arrays)
    assert pidx.count == n and pidx.arrays.default_start == int(host.default_start)
    np.testing.assert_array_equal(pidx.arrays.codes[:n].numpy().view(np.uint32), host.codes[:n])
    np.testing.assert_array_equal(pidx.arrays.adjacency[:n].numpy(), host.adjacency[:n])
    np.testing.assert_array_equal(pidx.arrays.deleted[:n].numpy(), host.deleted[:n])
    np.testing.assert_array_equal(pidx.external_ids, jidx.external_ids)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_replays_across_packages(tmp_path, writer):
    """One package builds 200 rows, attaches a journal and runs
    ``_lifecycle``; the other loads the checkpoint and replays the three
    records to the writer's state, and both search alike."""
    base, queries = synthetic_corpus("glove", 550, 16, seed=9)
    base, queries = base[:, :48].copy(), queries[:, :48].copy()
    kw = dict(num_dimensions=48, build_distance="storage")
    path = str(tmp_path / f"{writer}.npz")
    if writer == "jax":
        live = JaxIndex.build(base[:200], JaxConfig(distance_type=JaxDistance.L2, **kw))
    else:
        live = DiskannIndex.build(base[:200], IndexConfig(distance_type=DistanceType.L2, **kw),
                                  device="cpu")
    live.enable_durability(path)
    _lifecycle(live, base)
    assert len(live._journal) == 3
    if writer == "jax":
        jidx, pidx = live, DiskannIndex.load(path, device="cpu")
    else:
        jidx, pidx = JaxIndex.load(path), live
    _assert_same(pidx, jidx)
    assert jidx.num_deleted == pidx.num_deleted == 0
    assert bool(build.reachable_on_device(pidx.arrays)[: pidx.count].all())
    p_ids, _ = pidx.search(queries, 10, device="cpu")
    j_ids, _ = jidx.search(queries, 10)
    np.testing.assert_array_equal(p_ids.numpy(), np.asarray(j_ids))


def test_failed_add_keeps_its_record_as_in_jax(tmp_path, monkeypatch):
    """An add that fails after validation leaves the add's record in the
    journal in both packages, and the port's index keeps its arrays (the
    same object) and external ids; a bad add (wrong width) journals
    nothing."""
    base = _corpus(230, seed=10)
    pidx = _build(base[:200])
    jidx = JaxIndex.build(base[:200], JaxConfig(num_dimensions=_D,
                                                distance_type=JaxDistance.L2,
                                                num_neighbors=16, search_list_size=32))

    def boom(*a, **k):
        raise RuntimeError("injected")

    for idx, path in ((pidx, "port.npz"), (jidx, "jax.npz")):
        idx.enable_durability(str(tmp_path / path))
        with pytest.raises(ValueError):
            idx.add(base[:3, :5])
        assert len(idx._journal) == 0
    monkeypatch.setattr(pindex_mod, "insert_wave", boom)
    monkeypatch.setattr(jindex_mod, "insert_wave", boom)
    arrays, ext = pidx.arrays, pidx.external_ids
    for idx in (pidx, jidx):
        with pytest.raises(RuntimeError, match="injected"):
            idx.add(base[200:230])
        assert len(idx._journal) == 1
    assert pidx.arrays is arrays and pidx.external_ids is ext and pidx.count == 200
    monkeypatch.undo()
    # Replay applies the journaled add, in both packages.
    assert DiskannIndex.load(str(tmp_path / "port.npz"), device="cpu").count == 230
    assert JaxIndex.load(str(tmp_path / "jax.npz")).count == 230
