"""The port's device mesh and multi-process modules (``parallel/mesh.py``,
``parallel/multihost.py``) against the JAX package's, on the CPU.

- ``tests/test_mesh.py``'s five cases on the port: a mesh of eight CPU
  positions; ``sharded_search`` and ``sharded_build_step`` equal to one
  device's search and wave step; the one-process world; the environment
  contract of ``initialize_from_env`` (``init_process_group`` stubbed).
- Each against the JAX package on its 8-device CPU mesh, over the same
  index state (``from_jax_state`` of a JAX index on integer rows, L2, so
  every distance is exact): search ids equal, distances within 1e-5, wave
  adjacency equal.  JAX's ``append_backlinks`` is replaced by
  ``test_torch_plain.py``'s copy without its row-0 fault (ROADMAP.md §3
  fault 1).
- Four ``gloo`` processes on the CPU, each owning one position of a
  ``global_mesh``, build the same 4-shard index (each its own shard) and
  search it; every process's all-gathered result equals the
  single-process 4-position index's.
- A mesh on the card without a card raises; nothing falls back to the
  CPU unless ``device="cpu"`` is named.
"""

import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgvectorscale_tpu import DiskannIndex as JaxIndex
from pgvectorscale_tpu import IndexConfig as JaxConfig
from pgvectorscale_tpu.config import DistanceType as JaxDistance
from pgvectorscale_tpu.graph import build as jbuild
from pgvectorscale_tpu.graph.prune import alpha_schedule as jax_alpha_schedule
from pgvectorscale_tpu.ops import sbq as jsbq
from pgvectorscale_tpu import store as jstore
from pgvectorscale_tpu.parallel import mesh as jmesh
from pgvectorscale_tpu_torch import IndexConfig, QueryParams, ShardedDiskannIndex, from_jax_state
from pgvectorscale_tpu_torch.config import DistanceType
from pgvectorscale_tpu_torch.graph.prune import alpha_schedule
from pgvectorscale_tpu_torch.graph.search import beam_search, get_start_ids
from pgvectorscale_tpu_torch.ops import sbq
from pgvectorscale_tpu_torch.parallel import multihost
from pgvectorscale_tpu_torch.parallel.mesh import (
    build_wave_step,
    make_mesh,
    replicate_arrays,
    run_on_positions,
    sharded_build_step,
    sharded_search,
)

from test_torch_plain import _append_backlinks_dropping_misfits

ROOT = Path(__file__).resolve().parent.parent
N, D, Q = 256, 32, 16


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


@pytest.fixture(scope="module")
def small_index():
    """A JAX index on integer rows (L2) and the port's index over the same
    state."""
    v = np.random.default_rng(3).integers(-3, 4, (N, D)).astype(np.float32)
    config = JaxConfig(num_dimensions=D, distance_type=JaxDistance.L2, num_neighbors=16,
                       search_list_size=32)
    jidx = JaxIndex.build(v, config)
    pidx = from_jax_state(jstore.to_host(jidx.arrays), jidx.sbq_stats, config, device="cpu")
    queries = np.random.default_rng(4).integers(-3, 4, (Q, D)).astype(np.float32)
    return jidx, pidx, queries


def test_mesh_has_8_positions(monkeypatch):
    """Eight CPU positions when asked for; the card's mesh raises without a
    card, in both modules."""
    mesh = make_mesh(8, device="cpu")
    assert mesh.size == 8 and mesh.devices.size == 8 and mesh.axis_names == ("q",)
    assert all(d == torch.device("cpu") for d in mesh.devices.ravel())
    assert mesh.local_positions() == list(range(8))
    assert make_mesh(device="cpu").size == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (make_mesh, multihost.global_mesh, multihost.hybrid_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def test_sharded_search_matches_single_device(small_index):
    """Queries split over 8 positions, the arrays replicated: the port's
    result equals its single-device beam search and the JAX package's
    ``sharded_search``."""
    jidx, pidx, queries = small_index
    config = pidx.config
    kw = dict(search_list_size=16, max_iters=32, distance_type=config.distance_type,
              use_codes=True, filtered=False)
    qv = torch.from_numpy(queries)
    qc = sbq.encode(qv, pidx.sbq_stats, config.bits_per_dimension)
    starts = get_start_ids(pidx.arrays, Q)
    no_labels = torch.zeros((Q, 0), dtype=torch.int32)
    single = beam_search(pidx.arrays, qc, starts, search_list_size=16, max_iters=32,
                         query_vecs=qv, distance_type=config.distance_type)
    mesh_res = sharded_search(make_mesh(8, device="cpu"), pidx.arrays, qv, qc, no_labels,
                              starts, **kw)
    for f in ("beam_ids", "beam_dists", "beam_visited", "hist_ids", "n_visited",
              "n_dist_comps"):
        assert torch.equal(getattr(single, f), getattr(mesh_res, f)), f
    assert single.iters == mesh_res.iters

    jq = jnp.asarray(queries)
    jqc = jsbq.encode(jq, jidx.sbq_stats, jidx.config.bits_per_dimension)
    jstarts = jnp.broadcast_to(jidx.arrays.default_start[None, None], (Q, 1)).astype(jnp.int32)
    jres = jmesh.sharded_search(jmesh.make_mesh(8), jidx.arrays, jq, jqc,
                                jnp.zeros((Q, 0), jnp.int32), jstarts,
                                **{**kw, "distance_type": jidx.config.distance_type})
    np.testing.assert_array_equal(mesh_res.beam_ids.numpy(), np.asarray(jres.beam_ids))
    np.testing.assert_allclose(mesh_res.beam_dists.numpy(), np.asarray(jres.beam_dists),
                               atol=1e-5, rtol=0)


def test_sharded_build_step_matches_single_device(small_index):
    """A wave of 16 rows split over 8 positions, its writes made once on
    the first: the adjacency equals ``build_wave_step``'s and the JAX
    package's ``sharded_build_step``'s."""
    jidx, pidx, _ = small_index
    config = pidx.config
    wave = torch.arange(32, 48, dtype=torch.int32)
    single = build_wave_step(
        pidx.arrays, wave, search_list_size=config.search_list_size, max_iters=24,
        distance_type=config.distance_type, use_codes=config.build_traversal_uses_codes,
        prune_use_codes=config.build_prune_uses_codes,
        alphas=alpha_schedule(config.max_alpha), num_neighbors=config.num_neighbors,
        r_max=config.max_neighbors_during_build,
        code_bits=config.dims_to_index * config.bits_per_dimension,
    )
    sharded = sharded_build_step(make_mesh(8, device="cpu"), pidx.arrays, wave, config,
                                 max_iters=24)
    assert torch.equal(single.adjacency, sharded.adjacency)
    assert not torch.equal(single.adjacency, pidx.arrays.adjacency)
    jres = jmesh.sharded_build_step(jmesh.make_mesh(8), jidx.arrays,
                                    jnp.asarray(wave.numpy()), jidx.config, max_iters=24)
    np.testing.assert_array_equal(sharded.adjacency.numpy(), np.asarray(jres.adjacency))
    jsingle = jmesh.build_wave_step(
        jidx.arrays, jnp.asarray(wave.numpy()), search_list_size=config.search_list_size,
        max_iters=24, distance_type=jidx.config.distance_type,
        use_codes=config.build_traversal_uses_codes,
        prune_use_codes=config.build_prune_uses_codes,
        alphas=jax_alpha_schedule(config.max_alpha), num_neighbors=config.num_neighbors,
        r_max=config.max_neighbors_during_build,
        code_bits=config.dims_to_index * config.bits_per_dimension,
    )
    np.testing.assert_array_equal(single.adjacency.numpy(), np.asarray(jsingle.adjacency))


def test_replicas_and_positions(small_index):
    """One replica a distinct device (positions on the arrays' device share
    them); ``run_on_positions`` returns every position's result."""
    _, pidx, _ = small_index
    mesh = make_mesh(4, device="cpu")
    reps = replicate_arrays(pidx.arrays, mesh)
    assert len(reps) == 4 and all(r.adjacency is pidx.arrays.adjacency for r in reps)
    out = run_on_positions(list(mesh.devices.ravel()), lambda p: p * p, range(4))
    assert out == {0: 0, 1: 1, 2: 4, 3: 9}
    # Positions run in order in the calling thread; an exception in a
    # position is raised.
    seen = []
    caller = threading.get_ident()
    out = run_on_positions(list(mesh.devices.ravel()),
                           lambda p: seen.append(p) or threading.get_ident(), [2, 0, 3])
    assert seen == [2, 0, 3] and set(out.values()) == {caller}
    with pytest.raises(ZeroDivisionError):
        run_on_positions(list(mesh.devices.ravel()), lambda p: 1 // (p - 3), range(4))


def test_multihost_degenerate_single_process(monkeypatch):
    """At world size 1: ``initialize_from_env`` does nothing, ``global_mesh``
    spans this process's positions, ``hybrid_mesh`` is [1, local], and a
    sharded index built on the global mesh finds every query's own row."""
    monkeypatch.delenv(multihost.COORDINATOR_ENV, raising=False)
    assert multihost.initialize_from_env(device="cpu") is False
    assert multihost.world() == (0, 1)
    mesh = multihost.global_mesh(n_devices=8, device="cpu")
    assert mesh.devices.size == 8 and mesh.axis_names == ("n",)
    hy = multihost.hybrid_mesh(device="cpu")
    assert hy.axis_names == ("host", "q") and hy.devices.shape[0] == 1
    rng = np.random.default_rng(11)
    vectors = rng.standard_normal((512, 32)).astype(np.float32)
    config = IndexConfig(num_dimensions=32, distance_type=DistanceType.L2, num_neighbors=16,
                         search_list_size=32)
    index = ShardedDiskannIndex.build(vectors, config, mesh)
    ids, _ = index.search(vectors[:16], k=1, params=QueryParams(search_list_size=32,
                                                                 rescore=32))
    assert [int(i) for i in index.to_external(ids)[:, 0]] == list(range(16))


def test_multihost_initialize_env_contract(monkeypatch):
    """With the environment naming a world of 4, ``initialize_from_env``
    calls ``init_process_group`` once with exactly its values (``gloo`` on
    the CPU), and not again; without a card, the card's backend raises
    before any call."""
    calls = []
    monkeypatch.setenv(multihost.COORDINATOR_ENV, "10.0.0.1:8476")
    monkeypatch.setenv(multihost.NUM_PROCESSES_ENV, "4")
    monkeypatch.setenv(multihost.PROCESS_ID_ENV, "2")
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(multihost, "_INITIALIZED", False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize_from_env()
    assert calls == []
    assert multihost.initialize_from_env(device="cpu") is True
    assert calls == [dict(backend="gloo", init_method="tcp://10.0.0.1:8476", world_size=4,
                          rank=2)]
    assert multihost.initialize_from_env(device="cpu") is True
    assert len(calls) == 1


_CHILD = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
torch.set_num_threads(1)
from pgvectorscale_tpu_torch import IndexConfig, QueryParams, ShardedDiskannIndex
from pgvectorscale_tpu_torch.config import DistanceType
from pgvectorscale_tpu_torch.parallel import multihost

assert multihost.initialize_from_env(device="cpu")
rank, size = multihost.world()
mesh = multihost.global_mesh(device="cpu")
assert mesh.size == size == 4 and mesh.local_positions() == [rank]
vectors = np.random.default_rng(21).standard_normal((800, 32)).astype(np.float32)
queries = np.random.default_rng(22).standard_normal((24, 32)).astype(np.float32)
config = IndexConfig(num_dimensions=32, distance_type=DistanceType.L2, num_neighbors=16,
                     search_list_size=32)
index = ShardedDiskannIndex.build(vectors, config, mesh)
assert [s is not None for s in index.shards] == [p == rank for p in range(4)]
ids, dists = index.search(queries, 10, QueryParams(search_list_size=32, rescore=64))
try:
    index.add(vectors[:4])
    raise SystemExit("add did not refuse a world of processes")
except NotImplementedError:
    pass
np.savez({out!r} + f"/rank{{rank}}.npz", ids=ids.numpy(), dists=dists.numpy(),
         adjacency=index.shards[rank].adjacency.numpy())
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_gloo_four_processes_search_equals_one_process(tmp_path):
    """Four ``gloo`` processes, each building and searching only its own
    shard of the same 4-shard index, all-gather the shards' top-k: every
    process returns the single-process index's ids and distances, and
    each shard's graph is the single-process shard's."""
    port = _free_port()
    env_base = {k: v for k, v in os.environ.items() if not k.startswith("PGVS_TPU_")}
    procs = []
    for rank in range(4):
        env = dict(env_base, PGVS_TPU_COORDINATOR=f"localhost:{port}",
                   PGVS_TPU_PROCESS_ID=str(rank), PGVS_TPU_NUM_PROCESSES="4",
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CHILD.format(root=str(ROOT), out=str(tmp_path))],
            env=env, cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]

    vectors = np.random.default_rng(21).standard_normal((800, 32)).astype(np.float32)
    queries = np.random.default_rng(22).standard_normal((24, 32)).astype(np.float32)
    config = IndexConfig(num_dimensions=32, distance_type=DistanceType.L2, num_neighbors=16,
                         search_list_size=32)
    index = ShardedDiskannIndex.build(vectors, config, make_mesh(4, axis_name="n",
                                                                 device="cpu"))
    ids, dists = index.search(queries, 10, QueryParams(search_list_size=32, rescore=64))
    for rank in range(4):
        with np.load(tmp_path / f"rank{rank}.npz") as z:
            np.testing.assert_array_equal(z["ids"], ids.numpy())
            np.testing.assert_array_equal(z["dists"], dists.numpy())
            np.testing.assert_array_equal(z["adjacency"], index.shards[rank].adjacency.numpy())


def test_launch_counts_survive_threads():
    """The kernels' launch counters take one increment a launch from any
    number of host threads (readers may search at once): 16 threads x
    2,000 increments each, with a short switch interval, lose none."""
    from pgvectorscale_tpu_torch.ops import beam_search, edge_gather, hamming_matrix, prune_scan

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for mod in (edge_gather, hamming_matrix, beam_search, prune_scan):
            start = mod.launches

            def work():
                for _ in range(2000):
                    mod.count_launch()

            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert mod.launches - start == 16 * 2000
            mod.launches = start
    finally:
        sys.setswitchinterval(prev)
