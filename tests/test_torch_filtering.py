"""Label-filtered indexes in the port against the JAX package.

- Exact parity needs exact arithmetic, as in ``test_torch_plain.py``: the
  vectors hold integers in -3..3 and the distance is L2, so every distance
  is an integer in float32 whatever the summation order, and the port's
  labeled prune, start-node lookup, filtered beam search, labeled wave
  steps, whole labeled build, labeled add (tombstone reuse with start
  clearing) and compact give JAX's ids, adjacency, node labels and label
  table exactly (tolerance: none); search distances within 1e-5.
- The brute-force threshold is lowered to 256 rows in both packages, so
  700-row builds reach searched (two-pass, filtered) waves, and JAX's
  ``graph.build.append_backlinks`` is replaced for this module by
  ``test_torch_plain.py``'s copy without its row-0 fault (see there).
- The port's versions of ``test_filtering.py``'s eight scenarios run on a
  port-built cosine index, as the JAX package's run on its own.
- Labeled checkpoints load both ways and ``from_jax_state`` carries a
  labeled index, with every array equal and the same filtered results.
"""

import contextlib

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
from pgvectorscale_tpu.graph import prune as jprune
from pgvectorscale_tpu.graph import search as jsearch
from pgvectorscale_tpu.ops import sbq as jsbq
import pgvectorscale_tpu_torch.index as pindex_mod
from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig, QueryParams, from_jax_state
from pgvectorscale_tpu_torch.config import DistanceType
from pgvectorscale_tpu_torch.graph import build, prune, search
from pgvectorscale_tpu_torch.labels import LABEL_SENTINEL, make_label_array
from pgvectorscale_tpu_torch.store import lookup_label_starts
from test_torch_plain import _append_backlinks_dropping_misfits

N, D, R, L, LM = 700, 32, 16, 32, 2
DEFAULT_THRESHOLD = build.BRUTE_CANDIDATE_THRESHOLD


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


def _labels(n, seed, n_labels=8):
    """1-2 labels a row drawn with popularity 1/rank (the JAX suite's
    filtered workload, scaled down); every 23rd row has none."""
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, n_labels + 1)
    pop /= pop.sum()
    a, b = rng.choice(n_labels, n, p=pop), rng.choice(n_labels, n, p=pop)
    return [None if i % 23 == 0 else sorted({int(x), int(y)})
            for i, (x, y) in enumerate(zip(a, b))]


def _int_vectors(n, seed):
    return np.random.default_rng(seed).integers(-3, 4, (n, D)).astype(np.float32)


def _configs(**kw):
    kw = dict(num_dimensions=D, num_neighbors=R, search_list_size=L,
              max_labels_per_vector=LM, **kw)
    return (JaxConfig(distance_type=JaxDistance.L2, **kw),
            IndexConfig(distance_type=DistanceType.L2, **kw))


def _carry(jidx):
    return from_jax_state(jstore.to_host(jidx.arrays), jidx.sbq_stats, jidx.config,
                          external_ids=jidx.external_ids, device="cpu")


def _assert_same_state(pidx, jidx):
    n = jidx.count
    host = jstore.to_host(jidx.arrays)
    assert pidx.count == n and pidx.arrays.default_start == int(host.default_start)
    for name in ("vectors", "adjacency", "node_labels", "deleted"):
        np.testing.assert_array_equal(getattr(pidx.arrays, name)[:n].numpy(),
                                      getattr(host, name)[:n], err_msg=name)
    np.testing.assert_array_equal(pidx.arrays.codes[:n].numpy().view(np.uint32),
                                  host.codes[:n])
    np.testing.assert_array_equal(pidx.arrays.label_start_keys.numpy(), host.label_start_keys)
    np.testing.assert_array_equal(pidx.arrays.label_start_ids.numpy(), host.label_start_ids)
    np.testing.assert_array_equal(pidx.external_ids, jidx.external_ids)


@pytest.fixture(scope="module")
def labeled():
    """A JAX build (exact-prune) of 700 labeled integer rows, its port
    copy, the rows and their labels."""
    base, labels = _int_vectors(N, 5), _labels(N, 6)
    jcfg, _ = _configs()
    jidx = JaxIndex.build(base, jcfg, labels=labels)
    return jidx, _carry(jidx), base, labels


def test_labeled_robust_prune_with_ties_matches_jax(rng):
    """Label-aware prune on small integer distances (ties everywhere),
    self and invalid ids among the candidates: equal neighbour lists."""
    b, c, lm = 12, 40, 2
    node_ids = rng.integers(0, 300, b).astype(np.int32)
    cand = rng.integers(-1, 300, (b, c)).astype(np.int32)
    cand[:, 3] = node_ids
    cd = rng.integers(0, 4, (b, c)).astype(np.float32)
    pair = rng.integers(0, 4, (b, c, c)).astype(np.float32)
    pair = np.minimum(pair, pair.transpose(0, 2, 1))
    cl = make_label_array([rng.choice(5, rng.integers(0, 3), replace=False)
                           for _ in range(b * c)], lm).reshape(b, c, lm)
    nl = make_label_array([rng.choice(5, rng.integers(1, 3), replace=False)
                           for _ in range(b)], lm)
    for alphas in ((1.0, 1.2), (1.0,)):
        want = jprune.robust_prune(*map(jnp.asarray, (node_ids, cand, cd, pair, cl, nl)),
                                   num_neighbors=8, alphas=alphas, labeled=True)
        got = prune.robust_prune(*map(torch.from_numpy, (node_ids, cand, cd, pair, cl, nl)),
                                 num_neighbors=8, alphas=alphas)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        unlabeled = prune.robust_prune(*map(torch.from_numpy, (node_ids, cand, cd, pair)),
                                       num_neighbors=8, alphas=alphas)
        assert not torch.equal(unlabeled[0], got[0])  # the gate changed something


def test_label_starts_and_start_ids_match_jax(labeled):
    """lookup_label_starts and get_start_ids over the built table, with
    unknown labels and empty query rows among the queries."""
    jidx, pidx, _, _ = labeled
    ql = make_label_array([[0], [3, 7], None, [7777], [1, 2], [5, 9999]], LM)
    want = jstore.lookup_label_starts(jidx.arrays, jnp.asarray(ql))
    got = lookup_label_starts(pidx.arrays, torch.from_numpy(ql))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[3] == -1).all() and got.numpy()[0, 0] >= 0
    want = jsearch.get_start_ids(jidx.arrays, jnp.asarray(ql), 6)
    got = search.get_start_ids(pidx.arrays, 6, torch.from_numpy(ql))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert search.get_start_ids(pidx.arrays, 6).shape == (6, 1)


@pytest.mark.parametrize("e", [1, 4])
def test_filtered_beam_search_matches_jax(labeled, e):
    """Filtered beam search from the default and label start nodes: beam,
    visit history and counters equal JAX's for E = 1 and 4; every beam
    entry past the start nodes carries a query label."""
    jidx, pidx, base, _ = labeled
    q = 24
    qv = base[:q] + 0.5
    jcodes = jsbq.encode(jnp.asarray(qv), jidx.sbq_stats, 2)
    ql = make_label_array([[i % 5] if i % 3 else [i % 5, 7] for i in range(q)], LM)
    kw = dict(search_list_size=L, max_iters=64, expand_factor=e)
    want = jsearch.beam_search(
        jidx.arrays, jnp.asarray(qv), jcodes, jnp.asarray(ql),
        jsearch.get_start_ids(jidx.arrays, jnp.asarray(ql), q),
        distance_type=JaxDistance.L2, use_codes=True, filtered=True, **kw,
    )
    pql = torch.from_numpy(ql)
    got = search.beam_search(
        pidx.arrays, torch.from_numpy(np.asarray(jcodes).view(np.int32)),
        search.get_start_ids(pidx.arrays, q, pql), query_labels=pql, **kw,
    )
    for name in ("beam_ids", "beam_dists", "beam_visited", "hist_ids", "hist_dists",
                 "n_visited", "n_dist_comps"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.iters == int(want.iters)


@pytest.mark.parametrize("brute", [True, False])
def test_labeled_wave_step_matches_jax(labeled, brute):
    """Re-inserting 128 labeled rows as one wave (brute force, or the
    unfiltered and the filtered beam search over a snapshot), then
    finalize: equal adjacency; the label table is the wave's input and
    stays equal."""
    jidx, pidx, _, _ = labeled
    cfg = jidx.config
    wave = np.arange(300, 428, dtype=np.int32)
    kw = dict(
        search_list_size=L, max_iters=jbuild._build_max_iters(L), brute=brute,
        slice_rows=N, alphas=jbuild._alpha_schedule(cfg.max_alpha), num_neighbors=R,
        trunc_dims=D, prune_use_codes=False, code_bits=D * 2, use_codes=True,
    )
    want = jbuild._wave_step_jit(
        jidx.arrays, jnp.asarray(wave), jnp.asarray(N, jnp.int32),
        snap_adjacency=None if brute else jidx.arrays.adjacency,
        snap_edge_codes=None if brute else jbuild._edge_codes_onepass(
            jidx.arrays.codes, jidx.arrays.adjacency),
        labeled=True, distance_type=JaxDistance.L2, **kw,
    )
    got = build._wave_step(
        pidx.arrays, torch.from_numpy(wave), N,
        None if brute else pidx.arrays.adjacency.clone(),
        distance_type=DistanceType.L2, **kw,
    )
    np.testing.assert_array_equal(got.adjacency.numpy(), np.asarray(want.adjacency))
    assert not torch.equal(got.adjacency, pidx.arrays.adjacency)
    want_f = jbuild.finalize(want, jbuild.BuildContext(cfg))
    got_f = build.finalize(got, pidx._ctx)
    np.testing.assert_array_equal(got_f.adjacency.numpy(), np.asarray(want_f.adjacency))
    np.testing.assert_array_equal(got_f.label_start_ids.numpy(),
                                  np.asarray(want_f.label_start_ids))


def test_labeled_build_matches_jax(labeled):
    """The whole labeled build (a brute-force wave, then a searched wave
    with its filtered pass, finalize): JAX's graph, node labels and label
    table; every row reachable; every label's start node carries it."""
    jidx, _, base, labels = labeled
    pidx = DiskannIndex.build(base, _configs()[1], labels=labels, device="cpu")
    _assert_same_state(pidx, jidx)
    assert bool(build.reachable_on_device(pidx.arrays)[:N].all())
    keys, ids = pidx.arrays.label_start_keys.numpy(), pidx.arrays.label_start_ids.numpy()
    real = keys != LABEL_SENTINEL
    assert sorted(keys[real].tolist()) == sorted({x for ls in labels if ls for x in ls})
    for k, i in zip(keys[real], ids[real]):
        assert k in labels[i]


def test_labeled_search_matches_jax(labeled):
    """DiskannIndex.search with 1- and 2-label filters, unknown labels
    and a wider max_label_width: equal ids, distances within 1e-5."""
    jidx, pidx, base, _ = labeled
    queries = base[100:140] + 0.25
    ql = [[i % 8] if i % 4 else [i % 8, (i + 3) % 8] for i in range(40)]
    ql[5], ql[6] = [4242], None
    for params, width in (((32, 16), None), ((32, 100), None), ((48, 40), 3)):
        jids, jd = jidx.search(queries, 10, JaxParams(*params), query_labels=ql,
                               max_label_width=width)
        ids, d = pidx.search(queries, 10, QueryParams(*params), query_labels=ql,
                             max_label_width=width, device="cpu")
        np.testing.assert_array_equal(ids.numpy(), jids)
        np.testing.assert_allclose(d.numpy(), jd, atol=1e-5, rtol=0)
        assert (ids.numpy()[5:7] == -1).all()


def _label_reach(adjacency, node_labels, default_start, label_start, label):
    """Rows carrying ``label`` that a search filtered on it can reach:
    from the default start and the label's start node, through edges into
    rows that carry the label (a breadth-first search, numpy)."""
    has = (node_labels == label).any(axis=1)
    starts = [s for s in (default_start, label_start) if s >= 0]
    seen = np.zeros(len(adjacency), bool)
    seen[starts] = True
    front = np.asarray(starts)
    while len(front):
        nb = adjacency[front].reshape(-1)
        nb = nb[nb >= 0]
        nb = np.unique(nb[has[nb] & ~seen[nb]])
        seen[nb] = True
        front = nb
    return int((seen & has).sum())


def test_single_label_results_are_the_reachable_label_rows(labeled):
    """A search filtered on one label returns exactly min(k, reach) rows,
    reach being the label's rows reachable from the default and the
    label's start node through rows that carry it, in both packages with
    the same ids: the filter admits nothing else and the start lookup
    enters the label's subgraph.  With 30 labels over 700 rows some label
    has reach below k: label-aware pruning does not link every row of a
    rare label to its start node (the JAX package's graph; printed)."""
    _, _, base, _ = labeled
    jidx = JaxIndex.build(base, _configs()[0], labels=_labels(N, 6, n_labels=30))
    pidx = _carry(jidx)
    n = pidx.count
    adj = pidx.arrays.adjacency[:n].numpy()
    nl = pidx.arrays.node_labels[:n].numpy()
    starts = lookup_label_starts(pidx.arrays, torch.arange(30, dtype=torch.int32)[:, None])
    q = base[200:216] + np.float32(0.5)
    reach = {}
    for lab in range(30):
        ql = [[lab]] * len(q)
        jids, _ = jidx.search(q, 10, JaxParams(search_list_size=32, rescore=20), query_labels=ql)
        ids, _ = pidx.search(q, 10, QueryParams(search_list_size=32, rescore=20),
                             query_labels=ql, device="cpu")
        ids = ids.numpy()
        np.testing.assert_array_equal(ids, jids)
        reach[lab] = _label_reach(adj, nl, pidx.arrays.default_start, int(starts[lab, 0]), lab)
        assert ((ids >= 0).sum(axis=1) == min(10, reach[lab])).all(), lab
        assert all(lab in nl[i] for i in ids[ids >= 0])
    print(f"label rows reachable by a single-label search: {reach}")
    assert min(reach.values()) < 10


def _suite_labels(n):
    """benchmarks/suite.py ``run_filtered``'s label draw: 100 labels with
    popularity 1/rank, two draws a row from default_rng(7), kept as 1 or
    2 distinct labels in draw order."""
    rng = np.random.default_rng(7)
    pop = 1.0 / np.arange(1, 101)
    pop /= pop.sum()
    a, b = rng.choice(100, n, p=pop), rng.choice(100, n, p=pop)
    return [[int(x)] if x == y else [int(x), int(y)] for x, y in zip(a, b)]


def test_reach_under_the_suite_label_law_matches_jax():
    """Each package builds its own index of 1,500 integer rows under the
    filtered deployment's label law (100 labels, 1/rank): equal state, and
    for each of the 100 labels the same reach from each package's own
    arrays and the same ids for a search filtered on it.  Labels whose
    reach is below their row count (label-aware pruning leaving rows
    unlinked from the label's start node) are printed; there are some."""
    n = 1500
    base, labels = _int_vectors(n, 11), _suite_labels(n)
    jcfg, pcfg = _configs()
    jidx = JaxIndex.build(base, jcfg, labels=labels)
    pidx = DiskannIndex.build(base, pcfg, labels=labels, device="cpu")
    _assert_same_state(pidx, jidx)
    host = jstore.to_host(jidx.arrays)
    jstarts = np.asarray(jstore.lookup_label_starts(
        jidx.arrays, jnp.arange(100, dtype=jnp.int32)[:, None]))
    pstarts = lookup_label_starts(pidx.arrays, torch.arange(100, dtype=torch.int32)[:, None])
    padj, pnl = pidx.arrays.adjacency[:n].numpy(), pidx.arrays.node_labels[:n].numpy()
    q = base[:8] + np.float32(0.5)
    rows, reach, fragmented = np.zeros(100, int), {}, {}
    for ls in labels:
        rows[ls] += 1
    for lab in np.flatnonzero(rows):
        want = _label_reach(host.adjacency[:n], host.node_labels[:n],
                            int(host.default_start), int(jstarts[lab, 0]), lab)
        reach[lab] = _label_reach(padj, pnl, pidx.arrays.default_start,
                                  int(pstarts[lab, 0]), lab)
        assert reach[lab] == want, lab
        if reach[lab] < rows[lab]:
            fragmented[int(lab)] = (int(rows[lab]), reach[lab])
        ql = [[int(lab)]] * len(q)
        jids, _ = jidx.search(q, 10, JaxParams(search_list_size=32, rescore=20),
                              query_labels=ql)
        ids, _ = pidx.search(q, 10, QueryParams(search_list_size=32, rescore=20),
                             query_labels=ql, device="cpu")
        np.testing.assert_array_equal(ids.numpy(), jids)
        assert ((ids.numpy() >= 0).sum(axis=1) == min(10, reach[lab])).all(), lab
    print(f"{len(reach)} labels; (rows, reach) where reach < rows: {fragmented}")
    assert fragmented  # the JAX package's graph leaves rare labels' rows unlinked


def test_labeled_add_with_reuse_matches_jax(labeled):
    """In both packages: delete 60 rows, among them every label's start
    node that is not row 0, then add 100 labeled rows (60 onto the
    tombstones, whose start entries are cleared and re-registered; 40
    fresh, a searched wave), then an add without labels.  Equal state
    after every step."""
    jidx0, _, base, labels = labeled
    jidx = JaxIndex.build(base, jidx0.config, labels=labels)
    pidx = _carry(jidx)
    starts = np.asarray(jidx.arrays.label_start_ids)
    starts = np.unique(starts[starts > 0])
    rng = np.random.default_rng(3)
    others = rng.choice(np.setdiff1d(np.arange(1, N), starts), 60 - len(starts),
                        replace=False)
    doomed = np.concatenate([starts, others]).astype(np.int32)
    jidx.delete(doomed)
    pidx.delete(doomed)
    _assert_same_state(pidx, jidx)
    new = _int_vectors(140, 8)
    new_labels = _labels(140, 9, n_labels=11)  # labels 8-10 are new
    want = jidx.add(new[:100], labels=new_labels[:100])
    got = pidx.add(new[:100], labels=new_labels[:100])
    np.testing.assert_array_equal(got, want)
    assert sorted(got[:60].tolist()) == sorted(doomed.tolist())
    _assert_same_state(pidx, jidx)
    keys, ids = pidx.arrays.label_start_keys.numpy(), pidx.arrays.label_start_ids.numpy()
    for k, i in zip(keys, ids):
        if k != LABEL_SENTINEL:
            assert k in pidx.arrays.node_labels[i].tolist()
    np.testing.assert_array_equal(pidx.add(new[100:]), jidx.add(new[100:]))
    _assert_same_state(pidx, jidx)
    assert bool(build.reachable_on_device(pidx.arrays)[: pidx.count].all())


def test_add_validates_labels_before_any_work(labeled):
    """A row with too many labels, a label out of the smallint range, or
    labels for an unlabeled index raise ValueError and leave the index as
    it was."""
    _, pidx, base, _ = labeled
    arrays, ext = pidx.arrays, pidx.external_ids
    for bad in ([[1, 2, 3]], [[40000]]):
        with pytest.raises(ValueError):
            pidx.add(base[:1], labels=bad)
    assert pidx.arrays is arrays and pidx.external_ids is ext
    plain = DiskannIndex.build(base[:50], IndexConfig(num_dimensions=D), device="cpu")
    with pytest.raises(ValueError):
        plain.add(base[:1], labels=[[1]])
    with pytest.raises(ValueError):
        DiskannIndex.build(base[:50], IndexConfig(num_dimensions=D), labels=[[1]] * 50,
                           device="cpu")


def test_labeled_compact_matches_jax(labeled):
    """Delete 80 rows, compact in both packages: the same rebuilt graph,
    node labels (carried from the live rows), label table and external
    ids."""
    jidx0, _, base, labels = labeled
    jidx = JaxIndex.build(base, jidx0.config, labels=labels)
    pidx = _carry(jidx)
    doomed = np.random.default_rng(4).choice(np.arange(1, N), 80, replace=False)
    jidx.delete(doomed)
    pidx.delete(doomed)
    jc, pc = jidx.compact(), pidx.compact()
    _assert_same_state(pc, jc)
    live = np.setdiff1d(np.arange(N), doomed)
    np.testing.assert_array_equal(pc.arrays.node_labels[: len(live)].numpy(),
                                  make_label_array([labels[i] for i in live], LM))


def test_labeled_checkpoints_both_ways(labeled, tmp_path):
    """JAX save -> port load and port save -> JAX load: every saved array
    equal, and the same filtered search results."""
    jidx, pidx, base, _ = labeled
    jidx.save(str(tmp_path / "jax.npz"))
    pidx.save(tmp_path / "port")
    with np.load(tmp_path / "jax.npz") as zj, np.load(tmp_path / "port.npz") as zp:
        assert sorted(zj.files) == sorted(zp.files)
        for k in zj.files:
            assert zj[k].dtype == zp[k].dtype, k
            np.testing.assert_array_equal(zj[k], zp[k], err_msg=k)
    loaded = DiskannIndex.load(tmp_path / "jax.npz", device="cpu")
    back = JaxIndex.load(str(tmp_path / "port.npz"))
    _assert_same_state(loaded, jidx)
    ql = [[i % 8] for i in range(16)]
    jids, jd = back.search(base[:16], 5, query_labels=ql)
    for index in (loaded, pidx):
        ids, d = index.search(base[:16], 5, query_labels=ql, device="cpu")
        np.testing.assert_array_equal(ids.numpy(), jids)
        np.testing.assert_allclose(d.numpy(), jd, atol=1e-5, rtol=0)


def test_labeled_checkpoint_keeps_a_grown_label_table(tmp_path):
    """Past 1,024 distinct labels the table doubles (slots in ascending
    order, as JAX fills them); save -> load keeps its capacity, in both
    packages."""
    n = 1100
    base = _int_vectors(n, 12)
    labels = [[i] for i in range(n)]
    jcfg, pcfg = _configs(build_distance="storage")
    pidx = DiskannIndex.build(base, pcfg, labels=labels, device="cpu")
    assert pidx.arrays.label_start_keys.shape == (2048,)
    want = JaxIndex.build(base, jcfg, labels=labels)
    np.testing.assert_array_equal(pidx.arrays.label_start_keys.numpy(),
                                  np.asarray(want.arrays.label_start_keys))
    np.testing.assert_array_equal(pidx.arrays.label_start_ids.numpy(),
                                  np.asarray(want.arrays.label_start_ids))
    pidx.save(tmp_path / "grown")
    back = JaxIndex.load(str(tmp_path / "grown.npz"))
    assert back.arrays.label_start_keys.shape == (2048,)
    again = DiskannIndex.load(tmp_path / "grown", device="cpu")
    assert torch.equal(again.arrays.label_start_ids, pidx.arrays.label_start_ids)


def test_from_jax_state_carries_a_labeled_index(labeled):
    """The carried index holds JAX's node labels and label table, and its
    filtered searches equal JAX's at rescore 0 (Hamming distances, equal
    exactly)."""
    jidx, pidx, base, _ = labeled
    _assert_same_state(pidx, jidx)
    ql = [[i % 8, (i + 1) % 8] for i in range(20)]
    jids, jd = jidx.search(base[:20], 8, JaxParams(search_list_size=24, rescore=0),
                           query_labels=ql)
    ids, d = pidx.search(base[:20], 8, QueryParams(search_list_size=24, rescore=0),
                         query_labels=ql, device="cpu")
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(d.numpy(), jd)


# --- The port's versions of tests/test_filtering.py's scenarios -----------
# They build and add at the default brute-force threshold, as the JAX
# package's scenarios do.


@contextlib.contextmanager
def _default_threshold():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (build, pindex_mod):
            mp.setattr(mod, "BRUTE_CANDIDATE_THRESHOLD", DEFAULT_THRESHOLD)
        yield


@pytest.fixture(scope="module")
def scenario_index():
    """A port-built cosine index of 600 x 64 rows: class i % 4, every 10th
    row also label 100, every 17th row unlabeled (test_filtering.py's)."""
    rng = np.random.default_rng(11)
    n, d = 600, 64
    basis = rng.standard_normal((24, d)).astype(np.float32)
    vectors = rng.standard_normal((n, 24)).astype(np.float32) @ basis
    labels = [None if i % 17 == 0 else ([i % 4, 100] if i % 10 == 0 else [i % 4])
              for i in range(n)]
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.COSINE,
                         num_neighbors=20, search_list_size=50, max_labels_per_vector=2)
    with _default_threshold():
        index = DiskannIndex.build(vectors, config, labels=labels, device="cpu")
    return index, vectors, labels


def _label_set(labels, i):
    return set(labels[i] or [])


def _search(index, q, k, **kw):
    ids, dists = index.search(q, k, device="cpu", **kw)
    return ids.numpy(), dists.numpy()


def test_scenario_single_label_filter(scenario_index, rng):
    index, vectors, labels = scenario_index
    q = rng.standard_normal((10, vectors.shape[1])).astype(np.float32)
    ids, _ = _search(index, q, 10, query_labels=[[2]] * 10)
    assert (ids >= 0).all()
    assert all(2 in _label_set(labels, int(i)) for i in ids.reshape(-1))


def test_scenario_two_label_filter_is_union(scenario_index, rng):
    index, vectors, labels = scenario_index
    q = rng.standard_normal((10, vectors.shape[1])).astype(np.float32)
    ids, _ = _search(index, q, 10, query_labels=[[1, 100]] * 10)
    assert all(_label_set(labels, int(i)) & {1, 100} for i in ids.reshape(-1) if i >= 0)


def test_scenario_unlabeled_rows_match_no_filter(scenario_index, rng):
    index, vectors, labels = scenario_index
    null_rows = {i for i, lab in enumerate(labels) if not lab}
    q = rng.standard_normal((10, vectors.shape[1])).astype(np.float32)
    for target in ([0], [1, 2], [100]):
        ids, _ = _search(index, q, 20, query_labels=[target] * 10)
        assert not ({int(i) for i in ids.reshape(-1) if i >= 0} & null_rows)


def test_scenario_unknown_label_returns_nothing(scenario_index, rng):
    index, vectors, _ = scenario_index
    q = rng.standard_normal((3, vectors.shape[1])).astype(np.float32)
    ids, dists = _search(index, q, 5, query_labels=[[7777]] * 3)
    assert (ids == -1).all() and np.isinf(dists).all()


def test_scenario_rare_label_full_enumeration(scenario_index, rng):
    """A filter that matches few rows returns all of them: the label's
    start node enters its subgraph."""
    index, vectors, labels = scenario_index
    rare_rows = {i for i, lab in enumerate(labels) if lab and 100 in lab}
    q = rng.standard_normal((5, vectors.shape[1])).astype(np.float32)
    ids, _ = _search(index, q, len(rare_rows) + 5,
                     params=QueryParams(search_list_size=100, rescore=100),
                     query_labels=[[100]] * 5)
    for row in ids:
        assert {int(i) for i in row if i >= 0} == rare_rows


def test_scenario_label_update_via_delete_and_readd():
    rng2 = np.random.default_rng(3)
    n, d = 200, 32
    basis = rng2.standard_normal((16, d)).astype(np.float32)
    V = rng2.standard_normal((n, 16)).astype(np.float32) @ basis
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.L2, num_neighbors=12,
                         search_list_size=24, max_labels_per_vector=2)
    with _default_threshold():
        idx = DiskannIndex.build(V, config, labels=[[1]] * n, device="cpu")
        idx.delete(np.asarray([0], dtype=np.int32))
        new_id = idx.add(V[:1], labels=[[2]])[0]
    ids, _ = _search(idx, V[0], 1, query_labels=[[2]])
    assert ids[0, 0] == new_id
    ids, _ = _search(idx, V[0], n, query_labels=[[1]])
    assert new_id not in set(ids[0].tolist())


def test_scenario_filtered_recall_multi_label(scenario_index, rng):
    """Recall of a 2-label (union) filter against a filtered exact
    top-10 (numpy, float64) is at least 0.9, as in test_filtering.py."""
    index, vectors, labels = scenario_index
    q = rng.standard_normal((15, vectors.shape[1])).astype(np.float32)
    target = {0, 3}
    valid = np.asarray([bool(_label_set(labels, i) & target) for i in range(len(vectors))])
    vn = vectors / np.linalg.norm(vectors, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    d = np.where(valid[None, :], 1.0 - qn.astype(np.float64) @ vn.T, np.inf)
    gt = np.argsort(d, axis=1, kind="stable")[:, :10]
    ids, _ = _search(index, q, 10, params=QueryParams(search_list_size=100, rescore=150),
                     query_labels=[[0, 3]] * 15)
    hits = sum(len(set(gt[r]) & set(int(i) for i in ids[r] if i >= 0)) for r in range(15))
    assert hits / 150 >= 0.9


def test_scenario_label_start_cleared_on_slot_reuse(rng):
    n, d = 300, 16
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    labels = [[7] if i == 42 else [1] for i in range(n)]
    config = IndexConfig(num_dimensions=d, distance_type=DistanceType.L2, num_neighbors=10,
                         search_list_size=16, max_labels_per_vector=1)
    with _default_threshold():
        index = DiskannIndex.build(vectors, config, labels=labels, device="cpu")
        keys, ids = index.arrays.label_start_keys.numpy(), index.arrays.label_start_ids.numpy()
        assert ids[np.nonzero(keys == 7)[0][0]] == 42
        index.delete(np.asarray([42], dtype=np.int32))
        new_ids = index.add(rng.standard_normal((1, d)).astype(np.float32), labels=[[3]])
    assert new_ids.tolist() == [42]
    keys, ids = index.arrays.label_start_keys.numpy(), index.arrays.label_start_ids.numpy()
    lab7 = np.nonzero(keys == 7)[0]
    assert len(lab7) == 0 or ids[lab7[0]] != 42
    assert 3 in set(int(k) for k in keys if k != LABEL_SENTINEL)
    got, _ = _search(index, vectors[:2], 3,
                     params=QueryParams(search_list_size=16, rescore=8),
                     query_labels=[[3], [7]])
    assert 42 in set(int(i) for i in got[0] if i >= 0)
    assert all(int(i) == -1 for i in got[1])
