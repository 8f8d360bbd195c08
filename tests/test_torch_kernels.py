"""The kernels' wrappers, and the kernels on the card.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed (``--noconftest`` skips the JAX setup in conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tests marked ``cuda`` decide inside a fixture whether a card is present
and skip without one.  On the card the kernel must equal its plain
version exactly (integer popcounts: tolerance none); the full-precision
kernels equal theirs exactly on integer rows under L2 and inner product
and within 1e-5 relative elsewhere (``ops.beam_search_full.results_close``).
"""

import os
import stat

import pytest
import torch

from pgvectorscale_tpu_torch.ops import (_build, beam_search, beam_search_full, edge_gather,
                                         hamming_matrix, iter_step, prune_scan, reachable)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _fake_nvcc(tmp_path, monkeypatch, body):
    """Put an ``nvcc`` on PATH that logs its start and end and runs ``body``
    with ``$out`` the library it is asked to write."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=$2; shift; done\n"
        f"echo start >> {tmp_path}/log\n"
        f"{body}\n"
        f"echo end >> {tmp_path}/log\n"
    )
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")


def test_build_starts_one_nvcc_per_source_together_and_reuses(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch,
               'sleep 0.5; echo "ptxas info: fake"; touch "$out"')
    names = ("edge_gather", "hamming_matrix")
    records = _build.build(names, build_dir=tmp_path / "libs")
    assert [r["name"] for r in records] == list(names)
    assert all(r["compiled"] and os.path.exists(r["library"]) for r in records)
    assert all(r["ptxas"] == ["ptxas info: fake"] for r in records)
    # Both started before either ended.
    assert (tmp_path / "log").read_text().split() == ["start", "start", "end", "end"]
    again = _build.build(names, build_dir=tmp_path / "libs")
    assert [r["library"] for r in again] == [r["library"] for r in records]
    assert not any(r["compiled"] for r in again)


def test_build_raises_on_an_nvcc_error_and_leaves_no_library(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, 'touch "$out"; echo "error: bad"; exit 2')
    with pytest.raises(RuntimeError, match="error: bad"):
        _build.build(("edge_gather",), build_dir=tmp_path / "libs")
    assert os.listdir(tmp_path / "libs") == []


def test_edge_gather_wrapper_rejects_bad_inputs():
    codes = torch.zeros((10, 3), dtype=torch.int32)
    adj = torch.zeros((10, 2), dtype=torch.int32)
    sel = torch.zeros((4, 2), dtype=torch.int32)
    qc = torch.zeros((4, 3), dtype=torch.int32)
    eg = edge_gather.hamming_edge_gather
    before = edge_gather.launches
    assert eg(codes, adj, sel, qc).shape == (4, 4)  # accepted
    assert edge_gather.launches == before  # the CPU takes the plain version
    with pytest.raises(TypeError):
        eg(codes.long(), adj, sel, qc)
    with pytest.raises(TypeError):
        eg(codes, adj.long(), sel, qc)
    with pytest.raises(ValueError):  # words differ
        eg(codes, adj, sel, qc[:, :2].contiguous())
    with pytest.raises(ValueError):  # cap differs
        eg(codes, adj[:9], sel, qc)
    with pytest.raises(ValueError):
        eg(codes, adj, sel[:3], qc)
    with pytest.raises(ValueError):
        eg(codes, adj, sel.t(), qc.t())
    with pytest.raises(ValueError):
        eg(codes[:0], adj[:0], sel, qc)
    with pytest.raises(ValueError):
        eg(codes.to("meta"), adj.to("meta"), sel.to("meta"), qc.to("meta"))


def test_hamming_matrix_wrapper_rejects_bad_inputs():
    qc = torch.zeros((4, 3), dtype=torch.int32)
    cc = torch.zeros((5, 3), dtype=torch.int32)
    before = hamming_matrix.launches
    assert hamming_matrix.hamming_matrix(qc, cc).shape == (4, 5)  # accepted
    assert hamming_matrix.launches == before  # the CPU takes the plain version
    with pytest.raises(TypeError):
        hamming_matrix.hamming_matrix(qc.long(), cc)
    with pytest.raises(ValueError):
        hamming_matrix.hamming_matrix(qc, cc[:, :2])
    with pytest.raises(ValueError):
        hamming_matrix.hamming_matrix(qc.t(), cc.t())
    with pytest.raises(ValueError):
        hamming_matrix.hamming_matrix(qc.to("meta"), cc.to("meta"))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "q,n,w,fill", hamming_matrix.CHECK_CASES,
    ids=["-".join(map(str, c if c[3] else c[:3])) for c in hamming_matrix.CHECK_CASES])
def test_hamming_matrix_kernel_matches_plain_on_card(cuda_device, q, n, w, fill):
    """On the card the kernel launches and equals its plain version at the
    storage build's shapes, the TPU kernel tests' shapes, ragged edges off
    the tile and the 8-word step, constant codes and misaligned tables."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    qc, cc, const = hamming_matrix.check_codes(q, n, w, fill, cuda_device, g)
    before = hamming_matrix.launches
    got = hamming_matrix.hamming_matrix(qc, cc)
    torch.cuda.synchronize()
    assert hamming_matrix.launches == before + 1
    assert torch.equal(got, hamming_matrix.hamming_matrix_plain(qc, cc))
    if const is not None:
        assert bool((got == const).all())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "q,e,r,w,offset", [(1024, 4, 65, 48, False), (256, 1, 65, 8, False),
                       (128, 2, 65, 16, False), (128, 2, 65, 32, False),
                       (128, 2, 65, 24, False),
                       # 4-byte loads: odd W, W % 4 != 0, and W past 4 chunks
                       # a lane at 32 lanes a neighbour.
                       (64, 3, 65, 1, False), (64, 2, 65, 25, False),
                       (64, 2, 65, 6, False), (32, 2, 7, 1001, False),
                       # 16-byte loads past 4 chunks a lane at 32 lanes.
                       (32, 2, 7, 1000, False)] + edge_gather.HIGH_DIM_CASES
)
def test_edge_gather_kernel_matches_plain_on_card(cuda_device, q, e, r, w, offset):
    """On the card the kernel launches and equals its plain version, with
    about a quarter of the edges invalid and out-of-range row ids; also at
    the code widths of 2,000-16,000-dim indexes (16 and 32 lanes a slot,
    more than one pass of a lane's loop), aligned and misaligned."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    codes, adj, sel, qc = edge_gather.check_tables(q, e, r, w, 4096, offset, 0.25,
                                                   cuda_device, g)
    before = edge_gather.launches
    got = edge_gather.hamming_edge_gather(codes, adj, sel, qc)
    torch.cuda.synchronize()
    assert edge_gather.launches == before + 1
    assert torch.equal(got, edge_gather.hamming_edge_gather_plain(codes, adj, sel, qc))


def test_check_tables_offset_views():
    """The high-dimension check inputs: contiguous tables, the "offset"
    ones 4 bytes past a 16-byte boundary (the kernel's 4-byte-load path)."""
    for q, e, r, w, offset in edge_gather.HIGH_DIM_CASES:
        codes, adj, sel, qc = edge_gather.check_tables(q, e, r, w, 256, offset, 0.25, "cpu")
        assert codes.is_contiguous() and qc.is_contiguous() and codes.shape == (256, w)
        assert (codes.data_ptr() % 16 == 4) == offset and (qc.data_ptr() % 16 == 4) == offset
        assert edge_gather.hamming_edge_gather(codes, adj, sel, qc).shape == (q, e * r)


@pytest.mark.cuda
def test_build_and_beam_search_on_card_match_cpu(cuda_device):
    """A small index built on the card passes the invariants, and the
    card's beam search over it (kernel), with a "scored" window of 200,
    equals the CPU's (plain version) exactly: Hamming distances are
    integers.  A "scored" search on the card launches the beam-search
    kernel and returns no id twice."""
    import numpy as np

    from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig, QueryParams
    from pgvectorscale_tpu_torch.graph.build import reachable_on_device
    from pgvectorscale_tpu_torch.graph import search
    from pgvectorscale_tpu_torch.io.datasets import synthetic_corpus

    base, queries = synthetic_corpus("glove", 6000, 64, seed=2)
    index = DiskannIndex.build(base, IndexConfig(num_dimensions=base.shape[1]))
    n = index.count
    assert bool(reachable_on_device(index.arrays)[:n].all())
    assert int((index.arrays.adjacency != -1).sum(1).max()) <= index.arrays.max_degree
    ids, dists = index.search(queries, 10)
    assert ids.shape == (64, 10) and bool(torch.isfinite(dists).all())
    before = beam_search.launches
    ids, dists = index.search(queries, 40, QueryParams(search_list_size=32, rescore=200,
                                                       window_strategy="scored"))
    assert beam_search.launches > before
    assert ids.shape == (64, 40) and bool(torch.isfinite(dists).all())
    assert all(len(set(row.tolist())) == 40 for row in ids.cpu())
    codes = index.arrays.codes[torch.arange(64, device=cuda_device) * 7]
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        arrays = index.arrays._replace(
            codes=index.arrays.codes.to(dev), adjacency=index.arrays.adjacency.to(dev),
            vectors=index.arrays.vectors.to(dev), deleted=index.arrays.deleted.to(dev),
        )
        res = search.beam_search(arrays, codes.to(dev), search.get_start_ids(arrays, 64),
                                 search_list_size=64, max_iters=112, expand_factor=4,
                                 window_n=200)
        results.append([t.cpu() for t in (res.beam_ids, res.beam_dists, res.hist_ids,
                                          res.window_ids, res.window_dists)])
    for a, b in zip(*results):
        assert torch.equal(a, b)
    assert np.isfinite(results[0][1].numpy()).any()


@pytest.mark.cuda
def test_storage_build_and_add_on_card(cuda_device):
    """A storage build (L2) on the card and an add into it launch the
    Hamming-matrix kernel in their seed waves and keep every row
    reachable; the same add into a CPU copy of the built index (plain
    versions) gives the same codes and adjacency: every distance of a
    storage build is an integer, and L2 encodes without normalizing."""
    from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig
    from pgvectorscale_tpu_torch.config import DistanceType
    from pgvectorscale_tpu_torch.graph.build import reachable_on_device
    from pgvectorscale_tpu_torch.io.datasets import synthetic_corpus
    from pgvectorscale_tpu_torch.ops import sbq

    base, _ = synthetic_corpus("glove", 6000, 8, seed=4)
    config = IndexConfig(num_dimensions=base.shape[1], build_distance="storage",
                         distance_type=DistanceType.L2)
    before = hamming_matrix.launches
    card = DiskannIndex.build(base[:2048], config, device=cuda_device)
    assert hamming_matrix.launches > before
    cpu = DiskannIndex(
        config, card.arrays._replace(**{f: getattr(card.arrays, f).cpu() for f in
                                        ("vectors", "codes", "adjacency", "deleted")}),
        sbq.SbqStats(card.sbq_stats.count, card.sbq_stats.mean.cpu(),
                     card.sbq_stats.m2.cpu()),
    )
    before = hamming_matrix.launches
    card.add(base[2048:])
    assert hamming_matrix.launches > before
    cpu.add(base[2048:])
    n = card.count
    assert bool(reachable_on_device(card.arrays)[:n].all())
    assert torch.equal(card.arrays.codes.cpu(), cpu.arrays.codes)
    assert torch.equal(card.arrays.adjacency.cpu(), cpu.arrays.adjacency)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["exact", "plain"])
def test_full_precision_build_and_add_on_card_match_cpu(cuda_device, mode, monkeypatch):
    """An SBQ build with build_distance "exact" and a plain build (L2,
    3,000 x 32 vectors of integers in -3..3, so every distance is an
    integer in any summation order) with ``refine_passes=1``, then an add
    of 1,000 rows: the card
    gives the CPU's graph exactly, launches no Hamming kernel in the build
    or the add (full-precision traversal, the full-precision beam-search
    kernel) but the prune kernel, and the "exact" index's search launches
    the beam-search kernel, the plain index's the full-precision one.  The
    brute-force threshold is lowered to 256 rows so the build and the add
    reach full-precision beam waves."""
    import numpy as np

    from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig, QueryParams
    from pgvectorscale_tpu_torch import index as index_mod
    from pgvectorscale_tpu_torch.config import DistanceType, StorageLayout
    from pgvectorscale_tpu_torch.graph import build
    from pgvectorscale_tpu_torch.graph.build import reachable_on_device

    for mod in (build, index_mod):
        monkeypatch.setattr(mod, "BRUTE_CANDIDATE_THRESHOLD", 256)
    base = np.random.default_rng(3).integers(-3, 4, (4000, 32)).astype(np.float32)
    kw = dict(storage_layout=StorageLayout.PLAIN) if mode == "plain" else dict(
        build_distance="exact")
    config = IndexConfig(num_dimensions=32, distance_type=DistanceType.L2,
                         num_neighbors=16, search_list_size=32, **kw)
    graphs = []
    for dev in (cuda_device, torch.device("cpu")):
        before = (edge_gather.launches, hamming_matrix.launches, beam_search.launches)
        pruned, full = prune_scan.launches, beam_search_full.launches
        index = DiskannIndex.build(base[:3000], config, device=dev, refine_passes=1)
        index.add(base[3000:])
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (edge_gather.launches, hamming_matrix.launches,
                    beam_search.launches) == before
            assert prune_scan.launches > pruned
            assert beam_search_full.launches > full
            n = index.count
            assert bool(reachable_on_device(index.arrays)[:n].all())
            ids, dists = index.search(base[:64], 10, QueryParams(search_list_size=32,
                                                                 rescore=50))
            assert ids[:, 0].tolist() == list(range(64))
            assert (beam_search.launches > before[2]) == (mode == "exact")
            full = beam_search_full.launches
            index.search(base[:64], 10, QueryParams(search_list_size=32, rescore=50))
            assert (beam_search_full.launches > full) == (mode == "plain")
        graphs.append(index.arrays.adjacency.cpu())
    assert torch.equal(graphs[0], graphs[1])


@pytest.mark.cuda
def test_labeled_bf16_build_and_filtered_search_on_card_match_cpu(cuda_device, monkeypatch):
    """A labeled bf16 exact-prune build (L2, 3,000 x 32 vectors of
    integers in -3..3: exact in bf16, every distance an integer) with the
    brute-force threshold lowered to 256 rows, so searched waves run
    their filtered pass, then a filtered search with 1- and 2-label
    queries: the card gives the CPU's graph, label table, ids and
    distances exactly, and the beam-search kernel launches in the build
    and in the search."""
    import numpy as np

    from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig, QueryParams
    from pgvectorscale_tpu_torch import index as index_mod
    from pgvectorscale_tpu_torch.config import DistanceType
    from pgvectorscale_tpu_torch.graph import build
    from pgvectorscale_tpu_torch.graph.build import reachable_on_device

    for mod in (build, index_mod):
        monkeypatch.setattr(mod, "BRUTE_CANDIDATE_THRESHOLD", 256)
    rng = np.random.default_rng(8)
    base = rng.integers(-3, 4, (3000, 32)).astype(np.float32)
    pop = 1.0 / np.arange(1, 13)
    pop /= pop.sum()
    draws = rng.choice(12, (3000, 2), p=pop)
    labels = [sorted({int(a), int(b)}) for a, b in draws]
    queries = base[:64] + np.float32(1.0)
    qlabels = [[i % 12] if i % 2 else [i % 12, (i + 5) % 12] for i in range(64)]
    config = IndexConfig(num_dimensions=32, distance_type=DistanceType.L2, num_neighbors=16,
                         search_list_size=32, max_labels_per_vector=2, vector_dtype="bf16")
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        before = beam_search.launches
        index = DiskannIndex.build(base, config, labels=labels, device=dev)
        mid = beam_search.launches
        ids, dists = index.search(queries, 10, QueryParams(search_list_size=32, rescore=50),
                                  query_labels=qlabels, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert mid > before and beam_search.launches > mid
            assert index.arrays.vectors.dtype == torch.bfloat16
            assert bool(reachable_on_device(index.arrays)[:3000].all())
        results.append([t.cpu() for t in (index.arrays.adjacency, index.arrays.node_labels,
                                          index.arrays.label_start_keys,
                                          index.arrays.label_start_ids, ids, dists)])
    for a, b in zip(*results):
        assert torch.equal(a, b)
    ids = results[0][4].numpy()
    assert (ids >= 0).all()
    for row, ql in zip(ids, qlabels):
        assert all(set(labels[i]) & set(ql) for i in row)


def _int8_card_index(cuda_device, n=3000):
    """An int8 SBQ index (cosine, 1 bit) of n "glove" rows built on the
    card, and a CPU copy of it (plain versions there)."""
    from pgvectorscale_tpu_torch import DiskannIndex, IndexConfig
    from pgvectorscale_tpu_torch.io.datasets import synthetic_corpus
    from pgvectorscale_tpu_torch.ops import sbq

    base, queries = synthetic_corpus("glove", n, 8, seed=6)
    config = IndexConfig(num_dimensions=base.shape[1], num_bits_per_dimension=1,
                         vector_dtype="int8")
    card = DiskannIndex.build(base, config, device=cuda_device)
    cpu = DiskannIndex(
        config, card.arrays._replace(**{f: v.cpu() for f, v in zip(card.arrays._fields,
                                                                     card.arrays)
                                        if isinstance(v, torch.Tensor)}),
        sbq.SbqStats(card.sbq_stats.count, card.sbq_stats.mean.cpu(),
                     card.sbq_stats.m2.cpu()),
    )
    return card, cpu, queries


@pytest.mark.cuda
def test_int8_rescore_on_card_matches_cpu(cuda_device):
    """The int8 rescore (scale factored out, split bf16 query, float32
    sums) on the card within 1e-5 of the CPU's, for L2, inner product and
    cosine on unit rows, 1,024 candidates a query."""
    from pgvectorscale_tpu_torch import index as index_mod
    from pgvectorscale_tpu_torch import store
    from pgvectorscale_tpu_torch.config import DistanceType

    g = torch.Generator().manual_seed(5)
    rows = torch.randn((5000, 96), generator=g)
    rows = rows / rows.norm(dim=1, keepdim=True)
    qv = torch.randn((64, 96), generator=g)
    qv = qv / qv.norm(dim=1, keepdim=True)
    ids = torch.randint(-1, 5000, (64, 1024), generator=g, dtype=torch.int32)
    q8, sc = store.quantize_rows(rows)
    for dt in (DistanceType.L2, DistanceType.INNER_PRODUCT, DistanceType.COSINE):
        want = index_mod._exact_batch_distances(q8, sc, qv, ids, dt)
        got = index_mod._exact_batch_distances(
            q8.to(cuda_device), sc.to(cuda_device), qv.to(cuda_device),
            ids.to(cuda_device), dt)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_iter_step_on_card_matches_cpu(cuda_device):
    """Three refills of ``iter_step`` on an int8 SBQ index: the card
    (the iterator kernel, one launch a refill, no edge_gather) emits the
    CPU's ids and distances and reaches the CPU's state exactly (Hamming
    distances are integers)."""
    from pgvectorscale_tpu_torch.distance import preprocess_query
    from pgvectorscale_tpu_torch.graph import iterate
    from pgvectorscale_tpu_torch.graph.search import get_start_ids
    from pgvectorscale_tpu_torch.ops import sbq

    card, cpu, queries = _int8_card_index(cuda_device)
    cfg = card.config
    kw = dict(distance_type=cfg.distance_type, use_codes=True)
    for qi in range(4):
        outs = []
        for index in (card, cpu):
            dev = index.device
            qv = preprocess_query(torch.from_numpy(queries[qi : qi + 1]).to(dev),
                                  cfg.distance_type)[0]
            qc = sbq.encode(qv[None], index.sbq_stats, cfg.bits_per_dimension)[0]
            state = iterate.init_state(index.arrays, qv, qc, get_start_ids(index.arrays, 1)[0],
                                       frontier=256, **kw)
            before = edge_gather.launches, iter_step.launches
            emitted = []
            for emit_n in (128, 256, 512):
                state, ids, d = iterate.iter_step(state, index.arrays, qv, qc, emit_n=emit_n,
                                                  visit_budget=4 * emit_n, **kw)
                emitted += [ids.cpu(), d.cpu()]
            if dev.type == "cuda":
                torch.cuda.synchronize()
                assert (edge_gather.launches, iter_step.launches) == (before[0], before[1] + 3)
                assert int(state.n_visits) > 0
            outs.append(emitted + [t.cpu() for t in state])
        for a, b in zip(*outs):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_block_masked_iter_step_equals_one_step_at_a_time(cuda_device):
    """On the card, the plain refill's blocks of 16 masked steps (the loop
    condition read once a block) equal refills read after every step, and
    the iterator kernel's refills."""
    from pgvectorscale_tpu_torch.distance import preprocess_query
    from pgvectorscale_tpu_torch.graph import iterate
    from pgvectorscale_tpu_torch.graph.search import get_start_ids
    from pgvectorscale_tpu_torch.ops import sbq

    card, _, queries = _int8_card_index(cuda_device)
    cfg = card.config
    kw = dict(distance_type=cfg.distance_type, use_codes=True)
    qv = preprocess_query(torch.from_numpy(queries[:1]).to(cuda_device), cfg.distance_type)[0]
    qc = sbq.encode(qv[None], card.sbq_stats, cfg.bits_per_dimension)[0]
    outs = []
    for block in (16, 1, None):
        state = iterate.init_state(card.arrays, qv, qc, get_start_ids(card.arrays, 1)[0],
                                   frontier=256, **kw)
        emitted = []
        for emit_n, budget in ((128, 512), (128, 37), (256, 1024)):
            if block is None:  # the kernel
                state, ids, d = iterate.iter_step(state, card.arrays, qv, qc, emit_n=emit_n,
                                                  visit_budget=budget, **kw)
            else:
                state, ids, d = iterate.iter_step_plain(state, card.arrays, qv, qc,
                                                        emit_n=emit_n, visit_budget=budget,
                                                        step_block=block, **kw)
            emitted += [ids, d]
        outs.append(emitted + list(state))
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


def test_beam_search_wrapper_rejects_bad_inputs():
    arrays, qc, starts, ql = beam_search.check_inputs(4, 64, 3, 5, s=2, lm=1, lq=1)
    kw = dict(search_list_size=8, max_iters=8, expand_factor=2)
    before = beam_search.launches
    res = beam_search.beam_search_codes(arrays, qc, starts, ql, **kw)  # accepted
    assert res.beam_ids.shape == (4, 8) and beam_search.launches == before  # plain on the CPU
    with pytest.raises(TypeError):
        beam_search.beam_search_codes(arrays, qc.long(), starts, ql, **kw)
    with pytest.raises(TypeError):
        beam_search.beam_search_codes(arrays._replace(adjacency=arrays.adjacency.long()),
                                      qc, starts, ql, **kw)
    with pytest.raises(ValueError):  # words differ
        beam_search.beam_search_codes(arrays, qc[:, :2].contiguous(), starts, ql, **kw)
    with pytest.raises(ValueError):  # query counts differ
        beam_search.beam_search_codes(arrays, qc, starts[:3], ql, **kw)
    with pytest.raises(ValueError):
        beam_search.beam_search_codes(arrays, qc, starts.t(), ql, **kw)
    with pytest.raises(ValueError):  # E > L
        beam_search.beam_search_codes(arrays, qc, starts, ql, search_list_size=2,
                                      max_iters=8, expand_factor=3)
    with pytest.raises(ValueError):
        meta = arrays._replace(codes=arrays.codes.to("meta"),
                               adjacency=arrays.adjacency.to("meta"),
                               node_labels=arrays.node_labels.to("meta"))
        beam_search.beam_search_codes(meta, qc.to("meta"), starts.to("meta"),
                                      ql.to("meta"), **kw)


def test_prune_scan_wrapper_rejects_bad_inputs():
    from pgvectorscale_tpu_torch.graph.prune import sort_candidates

    node, cand, cd, pair, cl, nl = prune_scan.check_inputs(3, 12, 2, "cpu")
    order, ids, d, valid, tq = sort_candidates(node, cand, cd)
    kw = dict(num_neighbors=4, alphas=(1.0, 1.2))
    before = prune_scan.launches
    sel = prune_scan.prune_scan(order, pair, d, ids, valid, tq, cl, nl, **kw)  # accepted
    assert sel.shape == (3, 12) and prune_scan.launches == before  # plain on the CPU
    assert int((sel != prune_scan.UNSELECTED).sum(1).max()) <= 4
    with pytest.raises(TypeError):
        prune_scan.prune_scan(order.long(), pair, d, ids, valid, tq, cl, nl, **kw)
    with pytest.raises(TypeError):
        prune_scan.prune_scan(order, pair.double(), d, ids, valid, tq, cl, nl, **kw)
    with pytest.raises(ValueError):  # pair matrix too narrow
        prune_scan.prune_scan(order, pair[:, :, :11].contiguous(), d, ids, valid, tq, cl, nl,
                              **kw)
    with pytest.raises(ValueError):  # labels without the node's
        prune_scan.prune_scan(order, pair, d, ids, valid, tq, cl, None, **kw)
    with pytest.raises(ValueError):
        prune_scan.prune_scan(order, pair.transpose(1, 2), d, ids, valid, tq, cl, nl, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("inputs,search", beam_search.CHECK_CASES)
def test_beam_search_kernel_matches_plain_on_card(cuda_device, inputs, search):
    """On the card the kernel launches once and every output (beam, visit
    history, counters, window, iterations) equals the plain loop's on the
    same inputs (tolerance: none)."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    arrays, qc, starts, ql = beam_search.check_inputs(**inputs, device=cuda_device,
                                                      generator=g)
    plain_kw = {k: v for k, v in search.items() if k != "shared_limit"}
    plain_kw.setdefault("track_hist", True)
    plain_kw.setdefault("window_n", 0)
    before = beam_search.launches
    got = beam_search.beam_search_codes(arrays, qc, starts, ql, **search)
    assert beam_search.launches == before + 1
    want = beam_search.beam_search_codes_plain(arrays, qc, starts, ql, **plain_kw)
    torch.cuda.synchronize()
    assert beam_search.results_equal(got, want) == []


@pytest.mark.cuda
@pytest.mark.parametrize("case", prune_scan.CHECK_CASES, ids=prune_scan.case_id)
def test_prune_scan_kernel_matches_plain_on_card(cuda_device, case):
    """On the card the kernel launches once and its picks equal the plain
    scan's exactly, and robust_prune on the card equals it on the CPU."""
    from pgvectorscale_tpu_torch.graph.prune import alpha_schedule, robust_prune, sort_candidates

    g = torch.Generator(device=cuda_device).manual_seed(9)
    inputs = prune_scan.case_inputs(case, cuda_device, g)
    node, cand, cd, pair, cl, nl = inputs
    order, ids, d, valid, tq = sort_candidates(node, cand, cd)
    kw = dict(num_neighbors=case["r"], alphas=alpha_schedule(case["max_alpha"]))
    before = prune_scan.launches
    got = prune_scan.prune_scan(order, pair, d, ids, valid, tq, cl, nl, **kw)
    assert prune_scan.launches == before + 1
    want = prune_scan.prune_scan_plain(order, pair, d, ids, valid, tq, cl, nl, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    card = robust_prune(*inputs, **kw)
    cpu = robust_prune(*[None if t is None else t.cpu() for t in inputs], **kw)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))


def test_beam_search_full_wrapper_takes_plain_on_cpu_and_rejects_bad_inputs():
    from pgvectorscale_tpu_torch.config import DistanceType

    arrays, qv, starts, ql = beam_search_full.check_inputs(4, 64, 8, 5, s=2, lm=1, lq=1)
    kw = dict(search_list_size=8, max_iters=8, expand_factor=2,
              distance_type=DistanceType.L2)
    before = beam_search_full.launches
    res = beam_search_full.beam_search_full(arrays, qv, starts, ql, **kw)  # accepted
    want = beam_search_full.beam_search_full_plain(arrays, qv, starts, ql, **kw)
    assert beam_search_full.results_equal(res, want) == []
    assert beam_search_full.launches == before  # plain on the CPU
    f = beam_search_full.beam_search_full
    with pytest.raises(TypeError):  # rows of another type
        f(arrays._replace(vectors=arrays.vectors.double()), qv, starts, ql, **kw)
    with pytest.raises(TypeError):
        f(arrays, qv.double(), starts, ql, **kw)
    with pytest.raises(TypeError):
        f(arrays._replace(adjacency=arrays.adjacency.long()), qv, starts, ql, **kw)
    with pytest.raises(ValueError):  # a prefix wider than the rows
        f(arrays, torch.zeros((4, 9)), starts, ql, **kw)
    with pytest.raises(ValueError):  # int8 rows without their scales
        f(arrays._replace(vectors=arrays.vectors.to(torch.int8), vec_scales=None), qv, starts,
          ql, **kw)
    with pytest.raises(ValueError):  # query counts differ
        f(arrays, qv[:3], starts, ql, **kw)
    with pytest.raises(ValueError):
        f(arrays, qv.t(), starts, ql, **kw)
    with pytest.raises(ValueError):  # E > L
        f(arrays, qv, starts, ql, **dict(kw, search_list_size=1))
    with pytest.raises(ValueError):
        meta = arrays._replace(vectors=arrays.vectors.to("meta"),
                               adjacency=arrays.adjacency.to("meta"),
                               node_labels=arrays.node_labels.to("meta"))
        f(meta, qv.to("meta"), starts.to("meta"), ql.to("meta"), **kw)


def test_iter_step_wrapper_takes_plain_on_cpu_and_rejects_bad_inputs():
    from pgvectorscale_tpu_torch.config import DistanceType
    from pgvectorscale_tpu_torch.graph import iterate
    from pgvectorscale_tpu_torch.graph.iterate import IterState

    arrays, qv, qc, starts = iter_step.check_inputs(256, 9, use_codes=True, w=4, s=2)
    kw = dict(distance_type=DistanceType.COSINE, use_codes=True)
    state = iterate.init_state(arrays, qv, qc, starts, frontier=64, **kw)
    before = iter_step.launches
    got = iterate.iter_step(state, arrays, qv, qc, emit_n=10, visit_budget=40, **kw)
    want = iterate.iter_step_plain(state, arrays, qv, qc, emit_n=10, visit_budget=40, **kw)
    assert iter_step.refill_differs(got, want, exact=True) == []
    assert iter_step.launches == before  # plain on the CPU
    f = iterate.iter_step
    with pytest.raises(ValueError):  # an empty window
        f(state, arrays, qv, qc, emit_n=0, visit_budget=40, **kw)
    with pytest.raises(ValueError):  # no kernel for the device
        meta = arrays._replace(adjacency=arrays.adjacency.to("meta"),
                               codes=arrays.codes.to("meta"))
        f(IterState(*(t.to("meta") for t in state)), meta, qv.to("meta"), qc.to("meta"),
          emit_n=10, visit_budget=40, **kw)
    with pytest.raises(TypeError):
        f(state._replace(beam_ids=state.beam_ids.long()), arrays, qv, qc, emit_n=10,
          visit_budget=40, **kw)
    with pytest.raises(ValueError):  # the query code's words
        f(state, arrays, qv, qc[:2], emit_n=10, visit_budget=40, **kw)
    with pytest.raises(ValueError):  # visited of another table
        f(state._replace(visited=state.visited[:100]), arrays, qv, qc, emit_n=10,
          visit_budget=40, **kw)
    full, fqv, fqc, fstarts = iter_step.check_inputs(256, 9, use_codes=False, d=8)
    fkw = dict(distance_type=DistanceType.L2, use_codes=False)
    fstate = iterate.init_state(full, fqv, fqc, fstarts, frontier=64, **fkw)
    with pytest.raises(TypeError):
        f(fstate, full, fqv.double(), fqc, emit_n=10, visit_budget=40, **fkw)
    with pytest.raises(ValueError):  # a prefix wider than the rows
        f(fstate, full, torch.zeros(9), fqc, emit_n=10, visit_budget=40, **fkw)


@pytest.mark.cuda
@pytest.mark.parametrize("inputs,search", beam_search_full.CHECK_CASES)
def test_beam_search_full_kernel_matches_plain_on_card(cuda_device, inputs, search):
    """On the card the full-precision kernel launches once and equals the
    plain loop: bit for bit on integer rows under L2 and inner product (f32,
    bf16), within 1e-5 relative (ids up to a near-tie) elsewhere."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    arrays, qv, starts, ql = beam_search_full.check_inputs(**inputs, device=cuda_device,
                                                           generator=g)
    plain_kw = {k: v for k, v in search.items() if k != "shared_limit"}
    plain_kw.setdefault("track_hist", True)
    plain_kw.setdefault("window_n", 0)
    before = beam_search_full.launches
    got = beam_search_full.beam_search_full(arrays, qv, starts, ql, **search)
    assert beam_search_full.launches == before + 1
    want = beam_search_full.beam_search_full_plain(arrays, qv, starts, ql, **plain_kw)
    torch.cuda.synchronize()
    if beam_search_full.exact_case(inputs, search):
        assert beam_search_full.results_equal(got, want) == []
    else:
        assert beam_search_full.results_close(got, want) == []


# CHECK_CASES on integer rows: the L2 search, the overlapping
# neighbourhoods, the state and memo in the scratch buffer beside the ring.
FULL_MEMO_CASES = (0, 14, 15)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FULL_MEMO_CASES)
def test_beam_search_full_rows_read_on_card(cuda_device, case):
    """The kernel's ``rows_read``: at most ``n_dist_comps`` and, while the
    memo has room, the distinct rows the plain loop scored."""
    inputs, search = beam_search_full.CHECK_CASES[case]
    assert beam_search_full.exact_case(inputs, search)
    g = torch.Generator(device=cuda_device).manual_seed(11 + case)
    arrays, qv, starts, ql = beam_search_full.check_inputs(**inputs, device=cuda_device,
                                                           generator=g)
    kw = dict(dict(track_hist=True, window_n=0), **search)
    rows_read = torch.zeros(qv.shape[0], dtype=torch.int32, device=cuda_device)
    out, _ = beam_search_full.launch(arrays, qv, starts, ql, rows_read=rows_read, **kw)
    plain_kw = {k: v for k, v in kw.items() if k != "shared_limit"}
    want, distinct = beam_search_full.distinct_scored_plain(arrays, qv, starts, ql, **plain_kw)
    torch.cuda.synchronize()
    assert torch.equal(out["n_dist_comps"], want.n_dist_comps)
    assert torch.equal(rows_read, distinct)
    assert bool((rows_read <= out["n_dist_comps"]).all())


@pytest.mark.cuda
def test_beam_search_full_ring_depth_changes_no_bit_on_card(cuda_device):
    """A batch above the SMs runs blocks of 256 threads with a shallow ring
    and a smaller memo, a batch within them blocks of 512 with the deepest
    ring and the largest memo: the same queries give the same outputs bit
    for bit, float rows under cosine included (the same code on the same
    row, the same float)."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    arrays, qv, starts, ql = beam_search_full.check_inputs(
        q=300, cap=8192, d=768, r=65, values=0, device=cuda_device, generator=g)
    kw = dict(search_list_size=64, max_iters=96, expand_factor=4, track_hist=True,
              window_n=100, distance_type=beam_search_full.DistanceType.COSINE)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert qv.shape[0] > sms
    batch, _ = beam_search_full.launch(arrays, qv, starts, ql, **kw)
    part, _ = beam_search_full.launch(arrays, qv[:64], starts[:64], ql[:64], **kw)
    torch.cuda.synchronize()
    for field, t in part.items():
        assert torch.equal(batch[field][:64], t), field


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(iter_step.CHECK_CASES)))
def test_iter_step_kernel_matches_plain_on_card(cuda_device, case):
    """On the card each refill is one launch of the iterator kernel and
    equals the plain refill (every state field, ids and distances bit for
    bit on the codes and integer rows under L2 and inner product; within
    1e-5 relative elsewhere), through a starvation reseed."""
    from pgvectorscale_tpu_torch.graph import iterate

    inputs, traversal = (dict(c) for c in iter_step.CHECK_CASES[case])
    g = torch.Generator(device=cuda_device).manual_seed(9 + case)
    arrays, qv, qc, starts = iter_step.check_inputs(**inputs, device=cuda_device, generator=g)
    kw = dict(distance_type=traversal["distance_type"], use_codes=inputs["use_codes"])
    exact = iter_step.exact_case(inputs, traversal)
    limit = traversal.get("shared_limit", _build.MAX_SHARED_BYTES)
    state = iterate.init_state(arrays, qv, qc, starts, frontier=traversal["frontier"], **kw)
    ours = plain = iter_step.previsit(state, traversal.get("previsit", 0), g)
    refills = list(traversal["refills"])
    for k, (emit_n, budget) in enumerate(refills + [refills[-1]]):
        if k == len(refills):
            nid = iterate.first_unseen(plain, arrays)
            ours = iterate.reseed(ours, arrays, qv, qc, nid, **kw)
            plain = iterate.reseed(plain, arrays, qv, qc, nid, **kw)
        before = iter_step.launches
        got = iterate.iter_step(ours, arrays, qv, qc, emit_n=emit_n, visit_budget=budget,
                                shared_limit=limit, **kw)
        assert iter_step.launches == before + 1
        want = iterate.iter_step_plain(plain, arrays, qv, qc, emit_n=emit_n,
                                       visit_budget=budget, **kw)
        torch.cuda.synchronize()
        assert iter_step.refill_differs(got, want, exact) == [], f"refill {k}"
        ours, plain = got[0], want[0]


def test_reachable_wrapper_takes_plain_on_cpu_and_rejects_bad_inputs():
    g = torch.Generator().manual_seed(4)
    adj, count, start = reachable.graph_case("islands", 300, 6, "cpu", g, count=250)
    before = reachable.launches
    got = reachable.reachable(adj, count, start)
    assert torch.equal(got, reachable.reachable_scatter_plain(adj, count, start))
    assert torch.equal(got, reachable.reachable_csr_plain(adj, count, start))
    assert torch.equal(reachable.reachable(adj, count, start, csr_min_cap=300), got)
    assert reachable.launches == before
    with pytest.raises(TypeError):
        reachable.reachable(adj.long(), count, start)
    with pytest.raises(ValueError):
        reachable.reachable(adj.t(), count, start)
    with pytest.raises(ValueError):
        reachable.reachable(adj[0], count, start)
    with pytest.raises(ValueError):
        reachable.reachable(adj, 301, start)


@pytest.mark.cuda
@pytest.mark.parametrize("case", reachable.CHECK_CASES, ids=reachable.case_id)
def test_reachable_kernel_matches_both_plain_versions_on_card(cuda_device, case):
    g = torch.Generator(device=cuda_device).manual_seed(case["cap"] + case["r"])
    adj, count, start = reachable.case_graph(case, cuda_device, g)
    before = reachable.launches
    got = reachable.reachable(adj, count, start)
    assert reachable.launches == before + 1
    assert torch.equal(got, reachable.reachable_scatter_plain(adj, count, start))
    assert torch.equal(got, reachable.reachable_csr_plain(adj, count, start))
    if case["kind"] == "chain" and not case.get("fan"):
        assert int(got.sum()) == case["levels"] + 1


@pytest.mark.cuda
def test_reachable_kernel_on_a_few_blocks_on_card(cuda_device):
    """A grid of 1 and of 3 blocks (each level's rows shared by fewer
    warps) gives the same set as the full grid."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    adj, count, start = reachable.graph_case("fan", 30_000, 65, cuda_device, g, levels=50,
                                             fan=60)
    want = reachable.reachable_scatter_plain(adj, count, start)
    for blocks in (1, 3, 0):
        got, head = reachable.launch(adj, count, start, max_blocks=blocks)
        assert torch.equal(got, want)
        levels = reachable.levels(head)
        assert levels["block"] >= 50 and levels["grid"] > 0


@pytest.mark.cuda
def test_bfs_and_device_repair_read_nothing_back_on_card(cuda_device):
    """``reachable_on_device`` and ``repair_orphans_device`` on the card
    make no host read (torch's sync debug mode raises on one), and the
    repair equals the CPU's bit for bit and leaves no orphan."""
    from pgvectorscale_tpu_torch.graph import build
    from pgvectorscale_tpu_torch.store import GraphArrays

    g = torch.Generator().manual_seed(12)
    adj, count, start = reachable.graph_case("random", 50_000, 65, "cpu", g)
    victims = torch.randperm(count - 1, generator=g)[:5_000] + 1
    hit = torch.zeros(count + 1, dtype=torch.bool)
    hit[victims] = True
    adj = torch.where(hit[torch.where(adj >= 0, adj, count).long()], -1, adj)
    adj[0, -1] = -1

    def arrays_on(dev):
        return GraphArrays(
            vectors=torch.zeros((count, 0), device=dev),
            codes=torch.zeros((count, 0), dtype=torch.int32, device=dev),
            adjacency=adj.to(dev), deleted=torch.zeros(count, dtype=torch.bool, device=dev),
            count=count, default_start=start,
            node_labels=torch.zeros((count, 0), dtype=torch.int32, device=dev),
            label_start_keys=torch.zeros(1, dtype=torch.int32, device=dev),
            label_start_ids=torch.zeros(1, dtype=torch.int32, device=dev),
            vec_scales=torch.ones(count, device=dev))

    card = arrays_on(cuda_device)
    reachable.reachable(card.adjacency, count, start)  # the kernel loaded before the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        seen = build.reachable_on_device(card)
        repaired = build.repair_orphans_device(card)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int((~seen).sum()) >= 5_000
    want = build.repair_orphans_device(arrays_on("cpu"))
    assert torch.equal(repaired.adjacency.cpu(), want.adjacency)
    assert bool(build.reachable_on_device(repaired).all())
