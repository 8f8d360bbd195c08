"""The beam-search kernel's own source, run on the CPU, against the plain loop.

``csrc/beam_search.cu`` is compiled by g++ against ``tests/cuda_emu/cuda_emu.h``,
which emulates the CUDA features it uses (each CUDA thread a fiber on one
host thread, switched at ``__syncthreads`` and at the warp-wide steps), and
its C interface is called on CPU tensors.  Every output (beam, distances, visited
flags, history, counters, window, iterations) must equal
``beam_search_plain``'s bit for bit (tolerance: none), at both block sizes
the launch picks between (forced with ``-DPGVS_BEAM_THREADS``), in shared
memory and in the scratch buffer.  The card runs the same cases at full
batch in ``tests/test_torch_kernels.py`` (``ops.beam_search.CHECK_CASES``).

The cases are ``CHECK_CASES`` cut to a few queries: narrow and wide rows,
every code word equal (the tie-break alone orders), 64 slots (rows full of
repeated ids), windows, 1 and 2 labels, the scratch buffer, W = 1 and 500,
E*R above the kernel's 512-slot pass.
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
from pgvectorscale_tpu_torch.ops import beam_search as bs

EMU_HEADER = Path(__file__).resolve().parent / "cuda_emu" / "cuda_emu.h"
QUERIES = 2


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def emulated_source(src: str) -> str:
    """A source of csrc/ with the emulation's header and launch in place of
    the CUDA runtime's."""
    out = src.replace("#include <cuda_runtime.h>", f'#include "{EMU_HEADER}"')
    out = out.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = emu_block->smem;")
    out = re.sub(
        r"beam_search_kernel<V, CPL, kScratch, (\d+)><<<q, \d+, smem, stream>>>\(p\);",
        r"emu_launch(beam_search_kernel<V, CPL, kScratch, \1>, p, q, \1, smem);", out)
    return out


@pytest.fixture(scope="module", params=[128, 256])
def emulated(request, tmp_path_factory):
    """The kernel built for the CPU at one block size: a bound library."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to build the emulated kernel")
    d = tmp_path_factory.mktemp(f"beam_emu{request.param}")
    (d / "hamming.cuh").write_text(emulated_source((_build.CSRC / "hamming.cuh").read_text()))
    kernel = emulated_source((_build.CSRC / "beam_search.cu").read_text())
    assert kernel.count("emu_launch(") == 2, "the kernel's launch lines changed"
    src = d / "beam_search_emu.cpp"
    src.write_text(kernel)
    lib = d / "libbeam_search_emu.so"
    cmd = ["g++", "-std=c++20", "-O1", "-pthread", "-fPIC", "-shared",
           f"-DPGVS_BEAM_THREADS={request.param}", "-o", str(lib), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    return bs.bind(ctypes.CDLL(str(lib)))


def run_emulated(lib, arrays, qc, starts, ql, *, search_list_size, max_iters, expand_factor,
                 track_hist, window_n, scratch):
    """The C interface on CPU tensors: a SearchResult."""
    q, s = starts.shape
    l, h, e = search_list_size, max_iters, expand_factor
    cap, w = arrays.codes.shape
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
    iters = torch.empty(q, **i32)
    state = lib.pgvs_beam_search_state_bytes(l, window_n, e, r)
    buf = torch.empty(q * state, dtype=torch.uint8) if scratch else None
    err = lib.pgvs_beam_search(
        arrays.codes.data_ptr(), arrays.adjacency.data_ptr(),
        arrays.node_labels.data_ptr() if lq else None, qc.data_ptr(), starts.data_ptr(),
        ql.data_ptr(), *(out[f].data_ptr() for f in bs.RESULT_FIELDS), iters.data_ptr(),
        None if buf is None else buf.data_ptr(), q, cap, w, r, lm, s, lq, l, h, int(track_hist),
        e, window_n, 0, None)
    assert err == 0
    return SearchResult(iters=int(iters.max()), **out)


# CHECK_CASES indices: narrow E=2; wide E=4; 4-valued words with a window;
# 2 labels with a window; the scratch buffer; W=1; W=500; every word equal
# (narrow, window; wide); 64 slots; E*R = 520 (two expansion passes, more
# keys than the register sort holds).  Ids above 2**20 (1M-slot tables) are
# left to the card.
CASES = [0, 1, 2, 5, 8, 9, 12, 13, 14, 15, 18]


@pytest.mark.parametrize("case", CASES)
def test_emulated_kernel_matches_plain(emulated, case):
    inputs, search = (dict(c) for c in bs.CHECK_CASES[case])
    inputs["q"] = QUERIES
    scratch = search.pop("shared_limit", None) == 0
    search = dict(dict(track_hist=True, window_n=0), **search)
    g = torch.Generator().manual_seed(31 + case)
    arrays, qc, starts, ql = bs.check_inputs(**inputs, generator=g)
    want = bs.beam_search_codes_plain(arrays, qc, starts, ql, **search)
    got = run_emulated(emulated, arrays, qc, starts, ql, scratch=scratch, **search)
    assert bs.results_equal(got, want) == []
    assert want.iters > 1
