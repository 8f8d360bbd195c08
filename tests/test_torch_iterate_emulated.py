"""The streaming iterator's kernel, its own source run on the CPU, against
the plain refill.

``csrc/iter_step.cu`` (with ``csrc/hamming.cuh`` and ``csrc/rowdist.cuh``)
is compiled by g++ against ``tests/cuda_emu/cuda_emu.h`` (each CUDA thread a
fiber on one host thread, switched at ``__syncthreads`` and the warp-wide
steps) and driven through ``graph.iterate.iter_step_kernel`` (the window
seed, ``ops.iter_step.launch``, the emitted rows) on CPU tensors with the
emulated library, as on the card.  Each case (``ops.iter_step.CHECK_CASES``,
visit budgets cut to ``BUDGET`` steps a refill) runs its refills and a
starvation reseed through the kernel and through ``iter_step_plain``: on
the codes and on integer rows under L2 and inner product (f32, bf16) every
state field and every emitted id and distance bit-equal (tolerance: none);
on int8 rows and under cosine the emitted rows and the frontier within
1e-5 relative, ids equal up to a near-tie and the same rows after it.  The
cases cover R = 65, 17 and 260 (more slots than the block has threads),
emit_n 10, 4,096, 5,000 and 9,000 over a deep scan's pending rows, the
state in the scratch buffer, a visit-budget cut, every code word equal
(ties everywhere), a frontier of mostly +inf entries, W % 4 != 0, a
Matryoshka prefix, a row stride that rules out 16-byte loads and the prefix
read from device memory.
"""

import ctypes

import pytest
import torch

from pgvectorscale_tpu_torch.graph import iterate
from pgvectorscale_tpu_torch.ops import _build
from pgvectorscale_tpu_torch.ops import iter_step as its
from test_torch_beam_full_emulated import build_emulated

# Visit budget a refill at most: the emulation takes a few ms a step.
BUDGET = 48


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel built for the CPU: a bound library."""
    lib = build_emulated(tmp_path_factory.mktemp("iter_emu"), "iter_step", "iter_step_kernel")
    return its.bind(ctypes.CDLL(str(lib)))


@pytest.mark.parametrize("case", range(len(its.CHECK_CASES)))
def test_emulated_refills_match_plain(emulated, case):
    inputs, traversal = (dict(c) for c in its.CHECK_CASES[case])
    g = torch.Generator().manual_seed(61 + case)
    arrays, qv, qc, starts = its.check_inputs(**inputs, generator=g)
    use_codes, dist = inputs["use_codes"], traversal["distance_type"]
    kw = dict(distance_type=dist, use_codes=use_codes)
    exact = its.exact_case(inputs, traversal)
    state = iterate.init_state(arrays, qv, qc, starts, frontier=traversal["frontier"], **kw)
    ours = plain = its.previsit(state, traversal.get("previsit", 0), g)
    refills = list(traversal["refills"])
    limit = traversal.get("shared_limit", _build.MAX_SHARED_BYTES)
    for k, (emit_n, budget) in enumerate(refills + [refills[-1]]):
        if k == len(refills):  # a starvation restart, then one more refill
            nid = iterate.first_unseen(plain, arrays)
            assert nid >= 0
            ours = iterate.reseed(ours, arrays, qv, qc, nid, **kw)
            plain = iterate.reseed(plain, arrays, qv, qc, nid, **kw)
        budget = min(budget, BUDGET)
        got = iterate.iter_step_kernel(ours, arrays, qv, qc, emit_n=emit_n,
                                       visit_budget=budget, shared_limit=limit, lib=emulated,
                                       device_args=(0, None), **kw)
        assert int(got[0].n_visits) - int(ours.n_visits) <= budget
        want = iterate.iter_step_plain(plain, arrays, qv, qc, emit_n=emit_n,
                                       visit_budget=budget, **kw)
        assert its.refill_differs(got, want, exact) == [], f"refill {k}"
        ours, plain = got[0], want[0]
    assert int(plain.n_visits) > 0
