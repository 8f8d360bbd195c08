"""The port's snapshot-reader contract: ``add`` and ``delete`` publish new
state instead of writing the state a reader holds.

Port versions of the JAX package's contract tests
(``tests/test_streaming.py::test_slot_reuse_copy_on_write_external_ids``,
``::test_add_failure_leaves_index_unchanged`` and the single-device cases
of ``tests/test_concurrency.py``), held against the port's own earlier
state, on the CPU at 256-640 rows x 16-32 dims:

- a reader's ``external_ids`` and every tensor of its ``arrays`` stay
  bit-for-bit as they were after a ``delete`` and after an ``add`` that
  reuses tombstones;
- a failure in the middle of ``add`` (injected into the wave insert or
  the orphan repair) leaves ``index.arrays`` the very same object and the
  host mirrors equal, and a retry reuses the tombstones;
- writers serialized by a lock and concurrent readers: no crash, well-formed
  results, no lost update, no deleted row returned.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import pgvectorscale_tpu_torch.index as pindex_mod
from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig, QueryParams
from pgvectorscale_tpu_torch.config import DistanceType


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _config(d, **kw):
    return IndexConfig(num_dimensions=d, distance_type=DistanceType.L2,
                       num_neighbors=10, search_list_size=16, **kw)


def _clone_arrays(arrays):
    return [t.clone() if isinstance(t, torch.Tensor) else t for t in arrays]


def _assert_arrays_equal(arrays, saved):
    for name, a, b in zip(arrays._fields, arrays, saved):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
        else:
            assert a == b, name


def test_slot_reuse_copy_on_write_external_ids(rng):
    """A reader holding the pre-reuse ``external_ids`` keeps its original
    row -> external mapping; the writer sees the new one."""
    n, d = 256, 16
    index = DiskannIndex.build(rng.standard_normal((n, d)).astype(np.float32),
                               _config(d), device="cpu")
    snapshot = index.external_ids  # what a concurrent reader would hold
    before = snapshot.copy()
    index.delete(np.arange(0, 32, dtype=np.int32))
    ids = index.add(rng.standard_normal((32, d)).astype(np.float32),
                    external_ids=np.arange(n, n + 32, dtype=np.int64))
    np.testing.assert_array_equal(np.sort(ids), np.arange(32))
    np.testing.assert_array_equal(snapshot, before)
    assert (index.external_ids[:32] == np.arange(n, n + 32)).all()


def test_reader_arrays_unchanged_by_delete_and_reuse_add(rng):
    """Every tensor of a reader's ``arrays`` (vectors, codes, adjacency,
    tombstones) is unchanged after a ``delete`` and after an ``add`` that
    lands on tombstones and appends fresh rows; the index publishes new
    arrays each time."""
    n, d = 256, 16
    index = DiskannIndex.build(rng.standard_normal((n, d)).astype(np.float32),
                               _config(d), device="cpu")
    arrays, ext, mirror = index.arrays, index.external_ids, index._deleted_np
    saved = _clone_arrays(arrays)
    saved_ext, saved_mirror = ext.copy(), mirror.copy()

    index.delete(np.arange(5, 250, 9, dtype=np.int32))
    _assert_arrays_equal(arrays, saved)
    np.testing.assert_array_equal(mirror, saved_mirror)
    assert index.arrays is not arrays and index.num_deleted == 28

    arrays2 = index.arrays
    saved2 = _clone_arrays(arrays2)
    ids = index.add(rng.standard_normal((40, d)).astype(np.float32))
    assert np.isin(ids[:28], np.arange(5, 250, 9)).all() and (ids[28:] >= n).all()
    for a, s in ((arrays, saved), (arrays2, saved2)):
        _assert_arrays_equal(a, s)
    np.testing.assert_array_equal(ext, saved_ext)
    np.testing.assert_array_equal(mirror, saved_mirror)
    assert index.arrays is not arrays2 and index.num_deleted == 0
    assert index.count == n + 12


@pytest.mark.parametrize("fails", ["insert_wave", "repair_orphans"])
def test_add_failure_leaves_index_unchanged(rng, monkeypatch, fails):
    """A failure inside ``add`` (in a wave insert, or in the orphan repair
    after every wave) leaves the index at its pre-add state: the same
    arrays object with equal tensors, equal tombstone mirror and external
    ids.  A retry then recycles the tombstoned rows."""
    n, d = 200, 16
    index = DiskannIndex.build(rng.standard_normal((n, d)).astype(np.float32),
                               _config(d), device="cpu")
    dead = np.arange(0, 8, dtype=np.int32)
    index.delete(dead)
    arrays_before = index.arrays
    saved = _clone_arrays(arrays_before)
    ext_before = index.external_ids.copy()
    mirror_before = index._deleted_np.copy()

    def boom(*args, **kwargs):
        raise RuntimeError("injected failure")

    new = rng.standard_normal((12, d)).astype(np.float32)  # 8 reused, 4 fresh
    with monkeypatch.context() as mp:
        mp.setattr(pindex_mod, fails, boom)
        with pytest.raises(RuntimeError, match="injected failure"):
            index.add(new, external_ids=np.arange(n, n + 12, dtype=np.int64))

    assert index.arrays is arrays_before  # nothing published
    _assert_arrays_equal(index.arrays, saved)
    np.testing.assert_array_equal(index.external_ids, ext_before)
    np.testing.assert_array_equal(index._deleted_np, mirror_before)
    assert index.num_deleted == 8 and index.count == n

    ids = index.add(new, external_ids=np.arange(n, n + 12, dtype=np.int64))
    assert set(ids[:8].tolist()) == set(dead.tolist())
    np.testing.assert_array_equal(ids[8:], np.arange(n, n + 4))
    assert index.num_deleted == 0 and index.count == n + 4
    np.testing.assert_array_equal(index.to_external(ids), np.arange(n, n + 12))


D = 32
K = 10


@pytest.fixture(scope="module")
def base():
    rng = np.random.default_rng(99)
    vectors = rng.standard_normal((512, D)).astype(np.float32)
    config = IndexConfig(num_dimensions=D, distance_type=DistanceType.L2,
                         num_neighbors=16, search_list_size=32)
    return vectors, config


def test_interleaved_writers_and_readers(base):
    """Two writers serialized by a lock (add, then delete a slice of their
    previous batch) and two readers searching without it: no error, every
    result row finite and ascending, no lost update, and no deleted
    external id returned afterwards."""
    vectors, config = base
    rng = np.random.default_rng(7)
    index = DiskannIndex.build(vectors, config, device="cpu")
    write_lock = threading.Lock()
    stop = threading.Event()
    errors: list[BaseException] = []
    n_writers, batches, batch, ext_base = 2, 4, 64, 1_000_000

    def writer(widx: int):
        try:
            my_rng = np.random.default_rng(1000 + widx)
            for b in range(batches):
                vecs = my_rng.standard_normal((batch, D)).astype(np.float32)
                ext = ext_base * (widx + 1) + b * batch + np.arange(batch, dtype=np.int64)
                with write_lock:
                    index.add(vecs, external_ids=ext)
                if b > 0:
                    dead = (ext_base * (widx + 1) + (b - 1) * batch
                            + np.arange(0, batch, 4, dtype=np.int64))
                    with write_lock:
                        index.delete_external(dead)
        except BaseException as e:  # propagate to the main thread
            errors.append(e)

    queries = rng.standard_normal((16, D)).astype(np.float32)
    params = QueryParams(search_list_size=32, rescore=32)
    searches = [0]

    def reader():
        try:
            while not stop.is_set():
                ids, dists = index.search(queries, K, params, device="cpu")
                ids, dists = ids.numpy(), dists.numpy()
                for r in range(ids.shape[0]):
                    dr = dists[r][ids[r] >= 0]
                    assert np.all(np.isfinite(dr))
                    assert np.all(np.diff(dr) >= -1e-5)
                searches[0] += 1
        except BaseException as e:
            errors.append(e)

    writers = [threading.Thread(target=writer, args=(w,)) for w in range(n_writers)]
    readers = [threading.Thread(target=reader) for _ in range(2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often: more interleavings
    try:
        for t in readers + writers:
            t.start()
        for t in writers:
            t.join(timeout=600)
        stop.set()
        for t in readers:
            t.join(timeout=120)
    finally:
        stop.set()
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in readers + writers)
    assert not errors, errors
    assert searches[0] > 0

    inserted, deleted = set(), set()
    for w in range(n_writers):
        for b in range(batches):
            inserted.update(int(i) for i in ext_base * (w + 1) + b * batch + np.arange(batch))
            if b + 1 < batches:
                deleted.update(int(i) for i in
                               ext_base * (w + 1) + b * batch + np.arange(0, batch, 4))
    all_ext = index.external_ids
    assert len(all_ext) == len(set(all_ext.tolist()))
    live = ~index.arrays.deleted[: index.count].numpy()
    assert set(int(e) for e in all_ext[live]) & inserted == inserted - deleted
    ids, _ = index.search(queries, K, params, device="cpu")
    returned = set(int(e) for e in index.to_external(ids).ravel() if e >= 0)
    assert not returned & deleted


def test_search_during_add_sees_before_or_after(base):
    """Searches for a far-away cluster while it is added return finite,
    well-formed results; right after the add a search with L above the
    row count finds the new row as the nearest, at its exact distance."""
    vectors, config = base
    index = DiskannIndex.build(vectors, config, device="cpu")
    rng = np.random.default_rng(11)
    cluster = 100.0 + rng.standard_normal((32, D)).astype(np.float32) * 0.01
    probe = cluster[0:1]
    params = QueryParams(search_list_size=32, rescore=32)
    results, errors = [], []
    done = threading.Event()

    def reader():
        try:
            while not done.is_set():
                _, dists = index.search(probe, 1, params, device="cpu")
                results.append(float(dists[0, 0]))
        except BaseException as e:
            errors.append(e)

    t = threading.Thread(target=reader)
    t.start()
    try:
        index.add(cluster, external_ids=np.arange(5000, 5032, dtype=np.int64))
    finally:
        done.set()
        t.join(timeout=120)
    assert not t.is_alive()
    assert not errors, errors
    assert results and all(np.isfinite(d) for d in results)

    l = 1024
    assert index.count < l
    ids, dists = index.search(probe, 1, QueryParams(search_list_size=l, rescore=32),
                              device="cpu")
    assert int(index.to_external(ids)[0, 0]) == 5000
    assert float(dists[0, 0]) < 1.0
