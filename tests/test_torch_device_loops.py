"""The two device loops of the main path on the CPU: the prune scan and
the beam search, as the kernels that replace them on the card run them.

- ``robust_prune`` is split into the candidates' sort (torch) and the
  scan (``ops.prune_scan``, its plain version on the CPU); together they
  equal the JAX package's ``robust_prune`` exactly, unlabeled and
  labeled, with zero-distance ties, padding, the node among its
  candidates, and one and two alpha rounds (tolerance: none).
- The beam-search kernel runs each query in its own block to its own
  end: ``beam_search_plain`` run one query at a time equals the batched
  loop on every SearchResult field, and the batch's ``iters`` is the
  largest of the queries' counts.  This holds the kernel's design on the
  CPU: a query with no work left is unchanged by further iterations.
- The batched loop equals the JAX package's ``beam_search`` on the same
  cases (``test_torch_search.py``'s carried graph; tolerance: none).

Inputs are made from numpy seeds and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgvectorscale_tpu.config import DistanceType as JaxDistance
from pgvectorscale_tpu.graph import prune as jprune
from pgvectorscale_tpu.graph import search as jsearch
from pgvectorscale_tpu.ops import sbq as jsbq
from pgvectorscale_tpu_torch.graph import prune, search
from pgvectorscale_tpu_torch.labels import LABEL_SENTINEL
from pgvectorscale_tpu_torch.ops import beam_search as bs
from pgvectorscale_tpu_torch.ops import prune_scan
from pgvectorscale_tpu_torch.store import GraphArrays
from test_torch_search import carried  # noqa: F401  (the shared JAX-built graph)

FIELDS = bs.RESULT_FIELDS


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _labels(rng, shape, values=5, empty=0.3):
    lab = rng.integers(0, values, shape).astype(np.int32)
    lab[rng.random(shape) < empty] = LABEL_SENTINEL
    return np.sort(lab, axis=-1)  # sentinel (INT32_MAX) last, as the index stores rows


def _prune_inputs(seed, b, c, lm):
    """Ties (distances in steps of 0.1 from 0, pair distances L1 over a
    4-step grid: many zeros), the node in column 0, ~10% padding."""
    rng = np.random.default_rng(seed)
    node_ids = rng.integers(0, 1000, b).astype(np.int32)
    cand_ids = rng.integers(0, 1000, (b, c)).astype(np.int32)
    cand_ids[:, 0] = node_ids
    cand_ids[rng.random((b, c)) < 0.1] = -1
    cand_d = (rng.integers(0, 30, (b, c)) / 10.0).astype(np.float32)
    pts = rng.integers(0, 4, (b, c, 3)).astype(np.float32)
    pair = np.abs(pts[:, :, None, :] - pts[:, None, :, :]).sum(-1).astype(np.float32) / 3.0
    return node_ids, cand_ids, cand_d, pair, _labels(rng, (b, c, lm)), _labels(rng, (b, lm))


# (lm, max_alpha, C, edge rows): the first four keep their earlier ids.
# Edge rows: row 0's node repeats one label, row 1's node labels are all
# sentinel, every other candidate of row 2 carries no label, row 3 has no
# valid candidate.  C=45 and C=70 are not multiples of 32 (the kernel's
# lane slots); max_alpha 1.5 gives three alpha rounds.
SPLIT_CASES = [
    pytest.param(0, 1.0, 48, False, id="1.0-0"),
    pytest.param(0, 1.2, 48, False, id="1.2-0"),
    pytest.param(2, 1.0, 48, False, id="1.0-2"),
    pytest.param(2, 1.2, 48, False, id="1.2-2"),
    pytest.param(2, 1.5, 45, True, id="three-rounds-edge-rows-c45"),
    pytest.param(3, 1.2, 70, True, id="edge-rows-c70-lm3"),
    pytest.param(0, 1.5, 70, True, id="three-rounds-c70"),
]


@pytest.mark.parametrize("lm,max_alpha,c,edge_rows", SPLIT_CASES)
def test_prune_scan_split_matches_jax(lm, max_alpha, c, edge_rows):
    """The torch sort + ``prune_scan``'s plain version equal JAX's
    ``robust_prune``: one alpha round at 1.0, two at 1.2, three at 1.5;
    labeled rows through the label gate, with repeated and all-sentinel
    labels (tolerance: none)."""
    b, r = 12, 10
    node_ids, cand_ids, cand_d, pair, cl, nl = _prune_inputs(3 + lm, b, c, lm)
    if edge_rows:
        if lm:
            nl[0] = nl[0, 0] if nl[0, 0] != LABEL_SENTINEL else 1
            nl[1] = LABEL_SENTINEL
            cl[2, ::2] = LABEL_SENTINEL
        cand_ids[3] = -1
    alphas = prune.alpha_schedule(max_alpha)
    assert len(alphas) == {1.0: 1, 1.2: 2, 1.5: 3}[max_alpha]
    want = jprune.robust_prune(
        *map(jnp.asarray, (node_ids, cand_ids, cand_d, pair, cl, nl)),
        num_neighbors=r, alphas=alphas, labeled=lm > 0,
    )
    t = [torch.from_numpy(a) for a in (node_ids, cand_ids, cand_d, pair)]
    labels = (torch.from_numpy(cl), torch.from_numpy(nl)) if lm else (None, None)
    before = prune_scan.launches
    got = prune.robust_prune(*t, *labels, num_neighbors=r, alphas=alphas)
    assert prune_scan.launches == before  # the CPU runs the plain scan
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # The node is never its own neighbour; padding never picked.
    ids = got[0].numpy()
    assert not (ids == node_ids[:, None]).any() and (ids >= -1).all()


def test_prune_scan_reads_pairs_through_the_order():
    """``prune_scan_plain`` on the unsorted pair matrix and the sort's
    order equals the scan on a matrix reordered beforehand (identity
    order): the kernel's way of reading it."""
    node_ids, cand_ids, cand_d, pair, cl, nl = map(torch.from_numpy, _prune_inputs(7, 8, 40, 2))
    order, ids, d, valid, tq = prune.sort_candidates(node_ids, cand_ids, cand_d)
    kw = dict(num_neighbors=12, alphas=prune.alpha_schedule(1.2))
    got = prune_scan.prune_scan_plain(order, pair, d, ids, valid, tq, cl, nl, **kw)
    o = order.long()
    sorted_pair = pair[torch.arange(8)[:, None, None], o[:, :, None], o[:, None, :]]
    sorted_labels = torch.gather(cl, 1, o[:, :, None].expand(-1, -1, cl.shape[-1]))
    ident = torch.arange(40, dtype=torch.int32).repeat(8, 1)
    want = prune_scan.prune_scan_plain(ident, sorted_pair.contiguous(), d, ids, valid, tq,
                                       sorted_labels.contiguous(), nl, **kw)
    assert torch.equal(got, want)
    assert int((got != prune_scan.UNSELECTED).sum(1).max()) <= 12


def _graph(seed, cap, w, r, q, s, lm, lq, word_values):
    """A random graph state (codes from [0, word_values): equal distances
    are common), its queries, start ids (a duplicate and ~25% INVALID_ID
    past the first column) and query labels."""
    rng = np.random.default_rng(seed)
    adjacency = rng.integers(0, cap, (cap, r)).astype(np.int32)
    adjacency[rng.random((cap, r)) < 0.23] = -1
    starts = rng.integers(0, cap, (q, s)).astype(np.int32)
    if s > 1:
        starts[:, 1:][rng.random((q, s - 1)) < 0.25] = -1
        starts[:, -1] = starts[:, 0]
    arrays = GraphArrays(
        vectors=torch.zeros((cap, 0)),
        codes=torch.from_numpy(rng.integers(0, word_values, (cap, w)).astype(np.int32)),
        adjacency=torch.from_numpy(adjacency), deleted=torch.zeros(cap, dtype=torch.bool),
        count=cap, default_start=0,
        node_labels=torch.from_numpy(_labels(rng, (cap, lm), 4, 0.25)),
        label_start_keys=torch.zeros(0, dtype=torch.int32),
        label_start_ids=torch.zeros(0, dtype=torch.int32), vec_scales=torch.ones(cap),
    )
    qc = torch.from_numpy(rng.integers(0, word_values, (q, w)).astype(np.int32))
    return arrays, qc, torch.from_numpy(starts), torch.from_numpy(_labels(rng, (q, lq), 4, 0.0))


# (graph arguments, search arguments): narrow rows (E*R <= 192) and wide
# ones, a window, a filtered search (1 and 2 labels), no history, and a
# visit budget that binds before the beam converges.
LOOP_CASES = [
    (dict(cap=600, w=2, r=17, s=1, lm=0, lq=0, word_values=16),
     dict(search_list_size=16, max_iters=60, expand_factor=2)),
    (dict(cap=600, w=2, r=65, s=1, lm=0, lq=0, word_values=16),
     dict(search_list_size=16, max_iters=60, expand_factor=4, window_n=40)),
    (dict(cap=600, w=3, r=33, s=2, lm=2, lq=1, word_values=8),
     dict(search_list_size=24, max_iters=60, expand_factor=2, window_n=30)),
    (dict(cap=600, w=3, r=65, s=3, lm=2, lq=2, word_values=8),
     dict(search_list_size=24, max_iters=60, expand_factor=4, track_hist=False)),
    (dict(cap=600, w=2, r=17, s=1, lm=0, lq=0, word_values=16),
     dict(search_list_size=32, max_iters=9, expand_factor=2)),
]


@pytest.mark.parametrize("graph,kw", LOOP_CASES)
def test_one_query_at_a_time_equals_the_batch(graph, kw):
    """Each query run alone to its own end gives its row of the batched
    loop's every field; the batch's iterations are the largest of the
    queries' own (tolerance: none)."""
    q = 10
    arrays, qc, starts, ql = _graph(11, q=q, **graph)
    kw = dict(dict(track_hist=True, window_n=0), **kw)
    batch = search.beam_search_plain(arrays, qc, starts, query_labels=ql, **kw)
    own = [search.beam_search_plain(arrays, qc[i : i + 1], starts[i : i + 1],
                                    query_labels=ql[i : i + 1], **kw) for i in range(q)]
    for f in FIELDS:
        assert torch.equal(torch.cat([getattr(r, f) for r in own]), getattr(batch, f)), f
    counts = [r.iters for r in own]
    assert batch.iters == max(counts)
    if kw["max_iters"] < 10:  # the budget binds: every query spends it
        assert (batch.n_visited == kw["max_iters"]).all()
    else:  # queries converge at different steps
        assert len(set(counts)) > 1
    # A query with no work left is unchanged: running past its own end,
    # to the batch's count, changes nothing.
    assert bs.results_equal(search.beam_search_codes(arrays, qc, starts, ql, **kw), batch) == []


def _jax_labels(pidx, jidx, seed, lm):
    """The carried graph with the same random labels on both sides."""
    cap = pidx.arrays.capacity
    nl = _labels(np.random.default_rng(seed), (cap, lm), 4, 0.25)
    return (pidx.arrays._replace(node_labels=torch.from_numpy(nl)),
            jidx.arrays._replace(node_labels=jnp.asarray(nl)))


# (search arguments, query label count): narrow with a window and a binding
# budget; wide and filtered without history; filtered on two labels.
JAX_CASES = [
    (dict(search_list_size=32, max_iters=20, expand_factor=2, window_n=80), 0),
    (dict(search_list_size=32, max_iters=64, expand_factor=4, track_hist=False), 1),
    (dict(search_list_size=24, max_iters=48, expand_factor=2, window_n=40), 2),
]


@pytest.mark.parametrize("kw,lq", JAX_CASES)
def test_batched_loop_matches_jax(carried, kw, lq):  # noqa: F811
    """``beam_search`` on the CPU (the plain loop) equals JAX's on the
    carried graph: every field and the iteration count (tolerance: none)."""
    jidx, pidx, queries = carried
    q = 16
    qv = np.asarray(jnp.asarray(queries[:q]) / jnp.linalg.norm(queries[:q], axis=1,
                                                               keepdims=True))
    jcodes = jsbq.encode(jnp.asarray(qv), jidx.sbq_stats, 2)
    rng = np.random.default_rng(5)
    ql = _labels(rng, (q, lq), 4, 0.0)
    starts = np.full((q, 1 + lq), int(jidx.arrays.default_start), np.int32)
    if lq:
        starts[:, 1:] = rng.integers(0, pidx.count, (q, lq))
    parrays, jarrays = _jax_labels(pidx, jidx, 13, 2) if lq else (pidx.arrays, jidx.arrays)
    kw = dict(dict(track_hist=True, window_n=0), **kw)
    want = jsearch.beam_search(
        jarrays, jnp.asarray(qv), jcodes, jnp.asarray(ql), jnp.asarray(starts),
        distance_type=JaxDistance.COSINE, use_codes=True, filtered=lq > 0, **kw,
    )
    got = search.beam_search(
        parrays, torch.from_numpy(np.asarray(jcodes).view(np.int32)), torch.from_numpy(starts),
        query_labels=torch.from_numpy(ql) if lq else None, **kw,
    )
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.iters == int(want.iters)


def _stress_arrays(pidx, jidx, kind):
    """The carried graph with the inputs the kernel's hashed dedup and sort
    find hardest, the same on both sides: "ties", every code word 0 (every
    neighbour of a query at the same distance, so the tie-break alone
    orders the candidates); "repeats", adjacency rows drawn from 64 ids
    with ~20% empty slots (each row repeats ids many times)."""
    if kind == "ties":
        return (pidx.arrays._replace(codes=torch.zeros_like(pidx.arrays.codes)),
                jidx.arrays._replace(codes=jnp.zeros_like(jidx.arrays.codes)))
    rng = np.random.default_rng(17)
    adj = rng.integers(0, 64, pidx.arrays.adjacency.shape).astype(np.int32)
    adj[rng.random(adj.shape) < 0.2] = -1
    return (pidx.arrays._replace(adjacency=torch.from_numpy(adj)),
            jidx.arrays._replace(adjacency=jnp.asarray(adj)))


# (input kind, search arguments): each kind in a narrow row (E*R = 130,
# ties by slot) with a window and in a wide one (E*R = 260, ties by id).
STRESS_CASES = [
    ("ties", dict(search_list_size=24, max_iters=40, expand_factor=2, window_n=60)),
    ("ties", dict(search_list_size=32, max_iters=64, expand_factor=4, track_hist=False)),
    ("repeats", dict(search_list_size=24, max_iters=40, expand_factor=2, window_n=60)),
    ("repeats", dict(search_list_size=32, max_iters=64, expand_factor=4)),
]


@pytest.mark.parametrize("kind,kw", STRESS_CASES)
def test_batched_loop_matches_jax_on_stress_inputs(carried, kind, kw):  # noqa: F811
    """The plain loop equals JAX's ``beam_search`` on every field at the
    inputs the card's kernel is held to the plain loop on (``CHECK_CASES``'
    equal code words and repeated ids), so JAX = plain = kernel holds
    there (tolerance: none)."""
    jidx, pidx, queries = carried
    q = 16
    qv = np.asarray(jnp.asarray(queries[:q]) / jnp.linalg.norm(queries[:q], axis=1,
                                                               keepdims=True))
    jcodes = jsbq.encode(jnp.asarray(qv), jidx.sbq_stats, 2)
    starts = np.full((q, 1), int(jidx.arrays.default_start), np.int32)
    parrays, jarrays = _stress_arrays(pidx, jidx, kind)
    assert pidx.arrays.max_degree * kw["expand_factor"] == (130 if kw["expand_factor"] == 2
                                                              else 260)
    kw = dict(dict(track_hist=True, window_n=0), **kw)
    want = jsearch.beam_search(
        jarrays, jnp.asarray(qv), jcodes, jnp.zeros((q, 0), jnp.int32), jnp.asarray(starts),
        distance_type=JaxDistance.COSINE, use_codes=True, filtered=False, **kw,
    )
    got = search.beam_search(
        parrays, torch.from_numpy(np.asarray(jcodes).view(np.int32)), torch.from_numpy(starts),
        **kw,
    )
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.iters == int(want.iters)
    if kind == "ties":  # every entry of a query's beam at one distance
        d = got.beam_dists
        assert bool(((d == d[:, :1]) | torch.isinf(d)).all())


def test_wrapper_rejects_a_sort_key_that_does_not_fit(monkeypatch):
    """The kernel's sort key holds the distance (up to 32 W) and the
    tie-break (the slot in a narrow row, the id in a wide one) in 32-bit
    fields: the widths the port meets fit, and the wrapper rejects, on the
    CPU, inputs whose key would not fit its fields."""
    bs.check_sort_key(48, 130, 2**31 - 1)  # narrow: the slot, whatever the cap
    bs.check_sort_key(2000, 260, bs.WIDE_ID_CAP)  # wide: ids above 2**20
    with pytest.raises(ValueError, match="sort key"):
        bs.check_sort_key(2**27, 130, 64)  # 32 W = 2**32
    kw = dict(search_list_size=16, max_iters=16)
    arrays, qc, starts, ql = bs.check_inputs(4, 2048, 16, 65)
    wide = bs.check_inputs(4, 512, 48, 65)
    monkeypatch.setattr(bs, "SORT_KEY_FIELD_BITS", 10)  # fields up to 1,023
    # W = 16 (distances up to 512) in a narrow row (slots below 130): fits.
    bs.beam_search_codes(arrays, qc, starts, ql, expand_factor=2, **kw)
    with pytest.raises(ValueError, match="sort key"):  # a wide row's ids up to 2,047
        bs.beam_search_codes(arrays, qc, starts, ql, expand_factor=4, **kw)
    with pytest.raises(ValueError, match="sort key"):  # W = 48: distances up to 1,536
        bs.beam_search_codes(*wide, expand_factor=2, **kw)
