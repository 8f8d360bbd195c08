"""The port's auxiliary surface against the JAX package's: build progress,
build stats and logging, search stats and the cost estimate, the debug
helpers, the profiler hook, the utils re-exports and the CLI.

- The port's versions of ``test_aux.py``'s ``test_build_progress_phases``,
  ``test_cost_estimate``, ``test_debug_helpers``, ``test_build_logging``,
  ``test_query_stats_debug_dump``, ``test_cli_bench_smoke`` (with
  ``--device cpu``) and ``test_profiler_trace``.
- ``last_search_stats`` of a JAX-built index carried across with
  ``from_jax_state`` equals the JAX package's on the same queries
  (integer counters: tolerance none), and so do ``estimate_query_cost``
  and the debug helpers' output.
- The CLI runs all seven commands in subprocesses on the CPU.
"""

import dataclasses
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pgvectorscale_tpu import DiskannIndex as JaxIndex
from pgvectorscale_tpu import IndexConfig as JaxConfig
from pgvectorscale_tpu import QueryParams as JaxParams
from pgvectorscale_tpu import debug as jdebug
from pgvectorscale_tpu import store as jstore
from pgvectorscale_tpu.config import DistanceType as JaxDistance
from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig, QueryParams, from_jax_state
from pgvectorscale_tpu_torch import debug
from pgvectorscale_tpu_torch.config import DistanceType
from pgvectorscale_tpu_torch.io.datasets import synthetic_corpus, write_fvecs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def small_index():
    """test_aux.py's fixture: 400 low-rank rows, 48 wide, L2, R=16, L=32,
    built by JAX and carried across."""
    rng = np.random.default_rng(5)
    basis = rng.standard_normal((24, 48)).astype(np.float32)
    vectors = rng.standard_normal((400, 24)).astype(np.float32) @ basis
    jidx = JaxIndex.build(vectors, JaxConfig(num_dimensions=48, distance_type=JaxDistance.L2,
                                             num_neighbors=16, search_list_size=32))
    pidx = from_jax_state(jstore.to_host(jidx.arrays), jidx.sbq_stats, jidx.config,
                          device="cpu")
    return pidx, jidx, vectors


def _small_config():
    return IndexConfig(num_dimensions=16, distance_type=DistanceType.L2,
                       num_neighbors=10, search_list_size=16)


def test_build_progress_phases(rng):
    vectors = rng.standard_normal((300, 16)).astype(np.float32)
    phases = []
    DiskannIndex.build(vectors, _small_config(), device="cpu",
                       progress_callback=lambda p, d, t: phases.append((p, d, t)))
    names = [p[0] for p in phases]
    # The reference's three phases (ambuildphasename, build.rs:1154-1166).
    assert {"training quantizer", "inserting tuples", "finalizing graph"} <= set(names)
    insert_progress = [p[1] for p in phases if p[0] == "inserting tuples"]
    assert insert_progress[-1] == 300
    assert insert_progress == sorted(insert_progress)


def test_build_stats_count_waves_like_jax(rng):
    """``build_stats``: the rows, JAX's wave count for the same build (the
    same wave schedule), re-pruned rows and the two phases' seconds; an
    empty build has stats too, and later adds count their waves."""
    vectors = rng.standard_normal((700, 16)).astype(np.float32)
    index = DiskannIndex.build(vectors[:600], _small_config(), device="cpu")
    jidx = JaxIndex.build(vectors[:600], JaxConfig(num_dimensions=16,
                                                   distance_type=JaxDistance.L2,
                                                   num_neighbors=10, search_list_size=16))
    st, jst = index.build_stats, jidx.build_stats
    assert (st.num_nodes, st.num_waves) == (jst.num_nodes, jst.num_waves) == (600, 2)
    assert st.num_prunes > 0 and st.insert_s > 0 and st.finalize_s > 0
    index.add(vectors[600:])
    jidx.add(vectors[600:])
    assert st.num_waves == jst.num_waves == 3
    empty = DiskannIndex.build(np.zeros((0, 16), np.float32), _small_config(), device="cpu")
    assert empty.build_stats.num_nodes == 0 and empty.build_stats.num_waves == 0


def test_last_search_stats_match_jax(small_index):
    pidx, jidx, vectors = small_index
    assert pidx.last_search_stats is None
    for params in (None, QueryParams(search_list_size=48, rescore=64)):
        jparams = None if params is None else JaxParams(search_list_size=48, rescore=64)
        p_ids, _ = pidx.search(vectors[:25], 10, params, device="cpu")
        j_ids, _ = jidx.search(vectors[:25], 10, jparams)
        np.testing.assert_array_equal(p_ids.numpy(), np.asarray(j_ids))
        got, want = pidx.last_search_stats, jidx.last_search_stats
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.num_queries == 25 and got.total_visits > 0
        est = pidx.estimate_query_cost(QueryParams(search_list_size=64))
        assert est == jidx.estimate_query_cost(JaxParams(search_list_size=64))
        assert est["basis"] == "measured"
    merged = got.merge(got)
    assert merged.num_queries == 50 and merged.iterations == got.iterations


def test_cost_estimate(rng):
    """A cold index answers from the model, as JAX's does."""
    vectors = rng.standard_normal((400, 16)).astype(np.float32)
    index = DiskannIndex.build(vectors, _small_config(), device="cpu")
    est = index.estimate_query_cost(QueryParams(search_list_size=32))
    assert est["basis"] == "model"
    assert est["expected_node_visits"] > 0
    assert est["expected_distance_comparisons"] >= est["expected_node_visits"]
    assert est["estimated_rows"] >= 1
    index.search(vectors[:4], 5, device="cpu")
    assert index.estimate_query_cost(QueryParams(search_list_size=32))["basis"] == "measured"


def test_debug_helpers(small_index):
    """The JAX package's output on the same graph."""
    pidx, jidx, _ = small_index
    assert debug.count_reachable_nodes(pidx) == jdebug.count_reachable_nodes(jidx) == pidx.count
    hist = debug.degree_histogram(pidx)
    assert hist == jdebug.degree_histogram(jidx) and hist["orphans"] == 0
    dot = debug.to_graphviz(pidx, max_nodes=20)
    assert dot == jdebug.to_graphviz(jidx, max_nodes=20)
    assert dot.startswith("digraph") and "->" in dot


def test_build_logging(rng, caplog):
    """Build parameters are noticed (build.rs:307-313) and the end of the
    build reported, in the JAX package's words."""
    vectors = rng.standard_normal((120, 16)).astype("float32")
    with caplog.at_level(logging.INFO, logger="pgvectorscale_tpu_torch"):
        DiskannIndex.build(vectors, _small_config(), device="cpu")
    assert "building index: 120 vectors" in caplog.text
    assert "index build complete" in caplog.text


def test_query_stats_debug_dump(small_index, caplog):
    """Opt-in per-query stats dump (amendscan debug1, scan.rs:439-476)."""
    pidx, _, vectors = small_index
    with caplog.at_level(logging.DEBUG, logger="pgvectorscale_tpu_torch"):
        pidx.search(vectors[:2], 3, device="cpu")
    assert "query stats" in caplog.text


def test_profiler_trace(tmp_path):
    """The trace context writes a torch.profiler trace into its directory
    and yields the profiler."""
    from pgvectorscale_tpu_torch.stats import profiler_trace

    logdir = tmp_path / "trace"
    with profiler_trace(str(logdir)) as prof:
        torch.ones((128, 128)) @ torch.ones((128, 128))
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    assert "aten::mm" in (logdir / files[0]).read_text()
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_utils_reexports():
    from pgvectorscale_tpu_torch import stats, utils
    from pgvectorscale_tpu_torch.io import datasets

    assert (utils.debug, utils.stats, utils.datasets) == (debug, stats, datasets)


def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "pgvectorscale_tpu_torch.cli", *args,
                        "--device", "cpu"],
                       capture_output=True, text=True, timeout=timeout, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    return r


def test_cli_bench_smoke(tmp_path):
    """The CLI end to end in subprocesses on the CPU: build, info, search
    (with a profile), add, delete, compact, info, bench."""
    base, queries = synthetic_corpus("glove", 300, 4, seed=1)
    bp, qp = str(tmp_path / "b.fvecs"), str(tmp_path / "q.fvecs")
    write_fvecs(bp, base)
    write_fvecs(qp, queries)
    idx = str(tmp_path / "i.npz")
    out = json.loads(_cli("build", bp, "-o", idx, "--distance", "cosine",
                          "--num-neighbors", "16", "--search-list-size", "32")
                     .stdout.strip().splitlines()[-1])
    assert out["built"] == 300
    info = json.loads(_cli("info", idx).stdout)
    assert info["reachable"] == info["count"] == 300 and info["degrees"]["orphans"] == 0
    prof = tmp_path / "prof"
    r = _cli("search", idx, qp, "-k", "3", "--show", "1", "--profile-dir", str(prof))
    first = json.loads(r.stdout.strip().splitlines()[0])
    assert len(first["ids"]) == 3 and len(os.listdir(prof)) == 1
    assert json.loads(r.stderr.strip().splitlines()[-1])["queries"] == 4
    out = json.loads(_cli("add", idx, qp).stdout)
    assert (out["added"], out["count"], out["external_ids"]) == (4, 304, [300, 301, 302, 303])
    out = json.loads(_cli("delete", idx, "3", "7").stdout)
    assert (out["count"], out["live"], out["tombstoned"]) == (304, 302, 2)
    out = json.loads(_cli("compact", idx).stdout)
    assert (out["before"], out["after"], out["reclaimed"]) == (304, 302, 2)
    info = json.loads(_cli("info", idx).stdout)
    assert info["reachable"] == info["count"] == 302 and info["degrees"]["orphans"] == 0
    lines = _cli("bench", "--corpus", "glove", "--n", "600", "--q", "20",
                 "--search-list-sizes", "32", "64").stdout.strip().splitlines()
    rows = [json.loads(ln) for ln in lines]
    assert [r["L"] for r in rows] == [32, 64] and rows[-1]["recall"] >= 0.8


def test_cli_defaults_to_the_card(monkeypatch):
    """Without ``--device`` the CLI runs on the card, and refuses without
    one."""
    from pgvectorscale_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bench", "--n", "10", "--q", "2"])
