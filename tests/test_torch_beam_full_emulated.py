"""The full-precision beam-search kernel's own source, run on the CPU,
against the plain loop.

``csrc/beam_search_full.cu`` (with ``csrc/rowdist.cuh``) is compiled by g++
against ``tests/cuda_emu/cuda_emu.h`` (each CUDA thread a fiber on one host
thread, switched at ``__syncthreads`` and the warp-wide steps) and its C
interface is called on CPU tensors.  On rows of integers in -3..3 under L2
and inner product, in f32 and bf16, every output (beam, distances, visited
flags, history, counters, window, iterations) must equal
``beam_search_full_plain``'s bit for bit (tolerance: none; the sums of
small integers are exact in any order).  On int8 rows and under cosine,
distances within 1e-5 relative and ids equal except where a near-tie
within that tolerance swapped them (``results_close``).

The cases are ``CHECK_CASES`` cut to a few queries (the card runs them at
full batch in ``tests/test_torch_kernels.py``): narrow and wide rows
(E*R on both sides of 192), R = 65, windows, 1 and 2 labels, no history,
a visit budget that binds, the scratch buffer with the prefix in shared
memory, the prefix read from device memory, both in device memory, a
Matryoshka prefix, a row stride that rules out 16-byte loads and the
ring, heavy ties, neighbourhoods that overlap (the memo hits), the state
in the scratch buffer beside the ring.  The emulation lands a lane's
cp.async copies only at its wait, so a row read before it reads what the
slot held before.  Every
case also checks the rows read (the kernel's ``rows_read``): at most
``n_dist_comps``, and on integer rows the distinct rows the plain loop
scored (``distinct_scored_plain``), as the memo has room at this size.
The kernel built with a 16-entry memo (``-DPGVS_FULL_MEMO=16``) fills it
and must still equal the plain loop bit for bit, reading more rows; the
kernel run without the ring on 16-byte rows (each miss read by
``warp_row_distance``'s 16-byte loads) must too.  The plan's choices at
the 768-wide search are held too.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from pgvectorscale_tpu_torch.graph.search import SearchResult
from pgvectorscale_tpu_torch.ops import _build
from pgvectorscale_tpu_torch.ops import beam_search_full as bsf

EMU_HEADER = Path(__file__).resolve().parent / "cuda_emu" / "cuda_emu.h"
QUERIES = 2


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def emulated_source(src: str, kernel: str = "") -> str:
    """A source of csrc/ with the emulation's header and launch in place of
    the CUDA runtime's (``kernel``: the kernel's name, whose launch lines
    become ``emu_launch`` calls)."""
    out = src.replace("#include <cuda_runtime.h>", f'#include "{EMU_HEADER}"')
    out = out.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = emu_block->smem;")
    if kernel:
        out = re.sub(rf"{kernel}<([^>]*)><<<([^,]+), kThreads, smem, stream>>>\(p\);",
                     rf"emu_launch({kernel}<\1>, p, \2, kThreads, smem);", out)
    return out


def build_emulated(tmp: Path, name: str, kernel: str, defines=()) -> Path:
    """``csrc/<name>.cu`` and every shared header, emulated and compiled
    by g++ into a library in ``tmp``."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to build the emulated kernel")
    for header in _build.CSRC.glob("*.cuh"):
        (tmp / header.name).write_text(emulated_source(header.read_text()))
    kernel_src = emulated_source((_build.CSRC / f"{name}.cu").read_text(), kernel)
    assert kernel_src.count("emu_launch(") == 1, "the kernel's launch line changed"
    src = tmp / f"{name}_emu.cpp"
    src.write_text(kernel_src)
    lib = tmp / f"lib{name}_emu.so"
    cmd = ["g++", "-std=c++20", "-O1", "-fPIC", "-shared", *defines, "-o", str(lib), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    return lib


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel built for the CPU: a bound library."""
    lib = build_emulated(tmp_path_factory.mktemp("beam_full_emu"), "beam_search_full",
                         "beam_search_full_kernel")
    return bsf.bind(ctypes.CDLL(str(lib)))


TINY_MEMO = 16


@pytest.fixture(scope="module")
def emulated_tiny_memo(tmp_path_factory):
    """The kernel built for the CPU with a memo of TINY_MEMO entries."""
    lib = build_emulated(tmp_path_factory.mktemp("beam_full_emu_tiny"), "beam_search_full",
                         "beam_search_full_kernel", defines=(f"-DPGVS_FULL_MEMO={TINY_MEMO}",))
    return bsf.bind(ctypes.CDLL(str(lib)))


def run_emulated(lib, arrays, qv, starts, ql, *, shared_limit=_build.MAX_SHARED_BYTES,
                 vec=None, sms=132, **search):
    """The C interface on CPU tensors, placed by ``bsf.plan`` as on an H100
    (132 SMs: the few queries take a query alone's plan, blocks of 512
    threads; ``sms`` 1: a batch's, blocks of 256): a SearchResult, the rows
    each query read, and the plan (``vec`` False: as for rows off 16
    bytes, without the ring)."""
    q, s = starts.shape
    l, h, e = search["search_list_size"], search["max_iters"], search["expand_factor"]
    track_hist, window_n = search["track_hist"], search["window_n"]
    vecs = arrays.vectors
    cap, d = vecs.shape
    dt = qv.shape[1]
    r = arrays.adjacency.shape[1]
    lq = ql.shape[1]
    lm = arrays.node_labels.shape[1] if lq else 0
    i32, f32 = dict(dtype=torch.int32), dict(dtype=torch.float32)
    h_cap, wn = (h if track_hist else 1), max(window_n, 1)
    out = dict(beam_ids=torch.empty((q, l), **i32), beam_dists=torch.empty((q, l), **f32),
               beam_visited=torch.empty((q, l), dtype=torch.bool),
               hist_ids=torch.empty((q, h_cap), **i32), hist_dists=torch.empty((q, h_cap), **f32),
               n_visited=torch.empty(q, **i32), n_dist_comps=torch.empty(q, **i32),
               window_ids=torch.empty((q, wn), **i32), window_dists=torch.empty((q, wn), **f32))
    iters, rows_read = torch.empty(q, **i32), torch.full((q,), -1, **i32)
    where = bsf.plan(lib, q=q, sms=sms, l=l, window_n=window_n, e=e, r=r, dt=dt,
                     dtype=vecs.dtype, vec=bsf.rows_vectorizable(vecs) if vec is None else vec,
                     shared_limit=shared_limit)
    buf = None if where["state_shared"] else torch.empty(q * where["state_bytes"],
                                                         dtype=torch.uint8)
    int8 = vecs.dtype == torch.int8
    err = lib.pgvs_beam_search_full(
        vecs.data_ptr(), arrays.vec_scales.data_ptr() if int8 else None,
        arrays.adjacency.data_ptr(), arrays.node_labels.data_ptr() if lq else None,
        qv.data_ptr(), starts.data_ptr(), ql.data_ptr(),
        *(out[f].data_ptr() for f in bsf.RESULT_FIELDS), iters.data_ptr(), rows_read.data_ptr(),
        None if buf is None else buf.data_ptr(), q, cap, d, dt, bsf.ROW_DTYPES[vecs.dtype],
        int(search["distance_type"]), r, lm, s, lq, l, h, int(track_hist), e, window_n,
        int(where["query_shared"]), where["slots"], where["memo_log2"], where["threads"], 0,
        None)
    assert err == 0
    return SearchResult(iters=int(iters.max()), **out), rows_read, where


# Besides CHECK_CASES: E*R = 520 (a wide row over two expansion passes)
# with ties (values 1) under L2, f32.
EXTRA_CASES = [
    (dict(q=2, cap=2048, d=16, r=65, values=1, invalid_share=0.0),
     dict(search_list_size=64, max_iters=96, expand_factor=8,
          distance_type=bsf.DistanceType.L2)),
]


@pytest.mark.parametrize("case", range(len(bsf.CHECK_CASES) + len(EXTRA_CASES)))
def test_emulated_kernel_matches_plain(emulated, case):
    inputs, search = (dict(c) for c in (bsf.CHECK_CASES + EXTRA_CASES)[case])
    inputs["q"] = QUERIES
    limit = search.pop("shared_limit", _build.MAX_SHARED_BYTES)
    search = dict(dict(track_hist=True, window_n=0), **search)
    g = torch.Generator().manual_seed(41 + case)
    arrays, qv, starts, ql = bsf.check_inputs(**inputs, generator=g)
    want, distinct = bsf.distinct_scored_plain(arrays, qv, starts, ql, **search)
    got, rows_read, where = run_emulated(emulated, arrays, qv, starts, ql, shared_limit=limit,
                                         **search)
    if limit < _build.MAX_SHARED_BYTES:
        assert (where["state_shared"], where["query_shared"]) != (True, True)
    if bsf.exact_case(inputs, search):
        assert bsf.results_equal(got, want) == []
        assert torch.equal(rows_read, distinct)  # the memo has room at this size
    else:
        assert bsf.results_close(got, want) == []
    assert bool((rows_read <= got.n_dist_comps).all())
    assert want.iters > 1


def _case(case: int):
    inputs, search = (dict(c) for c in (bsf.CHECK_CASES + EXTRA_CASES)[case])
    inputs["q"] = QUERIES
    limit = search.pop("shared_limit", _build.MAX_SHARED_BYTES)
    search = dict(dict(track_hist=True, window_n=0), **search)
    g = torch.Generator().manual_seed(41 + case)
    return inputs, search, limit, bsf.check_inputs(**inputs, generator=g)


# Integer-row cases: the search shape (L2), the overlapping neighbourhoods
# (most survivors repeat), the state and memo in the scratch buffer.
MEMO_CASES = (0, 14, 15)


@pytest.mark.parametrize("case", MEMO_CASES)
def test_emulated_kernel_with_a_full_memo_matches_plain(emulated_tiny_memo, case):
    inputs, search, limit, (arrays, qv, starts, ql) = _case(case)
    assert bsf.exact_case(inputs, search)
    want, distinct = bsf.distinct_scored_plain(arrays, qv, starts, ql, **search)
    got, rows_read, where = run_emulated(emulated_tiny_memo, arrays, qv, starts, ql,
                                         shared_limit=limit, sms=1, **search)
    assert emulated_tiny_memo.pgvs_beam_search_full_memo_entries() == TINY_MEMO
    assert where["memo_log2"] == TINY_MEMO.bit_length() - 1
    assert where["slots"] > 0 and where["threads"] == bsf.BATCH_THREADS
    assert bsf.results_equal(got, want) == []
    # The memo fills: rows come back after it is full and are read again.
    assert bool((rows_read > distinct).all())
    assert bool((rows_read <= got.n_dist_comps).all())


@pytest.mark.parametrize("case", MEMO_CASES)
def test_emulated_kernel_without_the_ring_matches_plain(emulated, case):
    inputs, search, limit, (arrays, qv, starts, ql) = _case(case)
    assert bsf.rows_vectorizable(arrays.vectors)
    want, distinct = bsf.distinct_scored_plain(arrays, qv, starts, ql, **search)
    got, rows_read, where = run_emulated(emulated, arrays, qv, starts, ql, shared_limit=limit,
                                         vec=False, **search)
    assert where["slots"] == 0 and where["threads"] == bsf.ALONE_THREADS
    assert bsf.results_equal(got, want) == []
    assert torch.equal(rows_read, distinct)


def test_plan_at_the_768_wide_search(emulated):
    """The plan at the 768-wide f32 search: for a batch within the SMs
    blocks of ALONE_THREADS, the largest memo and the deepest ring up to
    RING_SLOTS_ALONE beside the state and the prefix; above, blocks of
    BATCH_THREADS, RING_SLOTS_BATCH and a memo with which BATCH_BLOCKS
    blocks fit an SM; a shallower ring where the state would not fit beside
    it; none for rows off 16 bytes."""
    kw = dict(sms=132, l=100, window_n=0, e=4, r=65, dt=768, dtype=torch.float32, vec=True,
              shared_limit=_build.MAX_SHARED_BYTES)
    query = emulated.pgvs_beam_search_full_query_bytes(768)
    most = emulated.pgvs_beam_search_full_memo_entries().bit_length() - 1

    def ring(k, threads):
        return emulated.pgvs_beam_search_full_ring_bytes(k, 768, 0, threads)

    alone = bsf.plan(emulated, q=1, **kw)
    batch = bsf.plan(emulated, q=1024, **kw)
    state = alone["state_bytes"]
    assert alone["threads"] == bsf.ALONE_THREADS and alone["memo_log2"] == most
    assert 1 <= alone["slots"] <= bsf.RING_SLOTS_ALONE
    assert ring(alone["slots"], bsf.ALONE_THREADS) + state + query <= _build.MAX_SHARED_BYTES
    assert (alone["slots"] == bsf.RING_SLOTS_ALONE or ring(alone["slots"] + 1, bsf.ALONE_THREADS)
            + state + query > _build.MAX_SHARED_BYTES)
    assert alone["state_shared"] and alone["query_shared"]
    assert batch["threads"] == bsf.BATCH_THREADS and batch["slots"] == bsf.RING_SLOTS_BATCH
    assert batch["memo_log2"] == 12 and batch["state_shared"] and batch["query_shared"]
    per_block = ring(batch["slots"], bsf.BATCH_THREADS) + batch["state_bytes"] + query
    assert bsf.BATCH_BLOCKS * (per_block + bsf.BLOCK_RESERVED_BYTES) <= bsf.SM_SHARED_BYTES
    kw256 = dict(kw, threads=256)
    for limit, depth in ((ring(2, 256) + state + query, 2),
                         (ring(2, 256) + state + query - 16, 1)):
        tight = bsf.plan(emulated, q=1, **dict(kw256, shared_limit=limit))
        assert tight["slots"] == depth and tight["state_shared"] and tight["query_shared"]
    assert bsf.plan(emulated, q=1, **dict(kw, vec=False))["slots"] == 0
    scratch = bsf.plan(emulated, q=1, **dict(kw256, shared_limit=ring(2, 256)))
    assert scratch["slots"] == 2 and not scratch["state_shared"]
    forced = bsf.plan(emulated, q=1024, **dict(kw, slots=2, memo_log2=10, threads=512))
    assert (forced["slots"], forced["memo_log2"], forced["threads"]) == (2, 10, 512)
