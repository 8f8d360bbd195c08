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
cases cover R = 65, 17, 1 and 260 (more slots than the block has threads),
emit_n 10, 4,096, 5,000 and 9,000 over a deep scan's pending rows, the
state in the scratch buffer, a visit-budget cut, every code word equal
(ties everywhere), a frontier of mostly +inf entries, frontiers of 100
entries, W % 4 != 0, a Matryoshka prefix, a row stride that rules out
16-byte loads and the prefix read from device memory.  The emulation lands
a lane's cp.async copies only at its wait, so a row read ahead and read
before that wait reads what its buffer held before.

The kernel is also built with each of its test hooks and held to the plain
refill at a few cases: ``PGVS_ITER_COLLIDE`` puts every id at the same
place of the frontier's set and the row's table (every insert and lookup
walks the ids before it), ``PGVS_ITER_SPEC_MISS`` loads the next node's
slots ahead and never uses them (every step reads its row again), and
``PGVS_ITER_SET_SLACK=4`` makes the frontier's set anew every few steps
(the kept set, its tombstones and the spare all in use).
"""

import ctypes
from concurrent.futures import ThreadPoolExecutor

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


# The test hooks' builds and the cases each runs: for the colliding ids the
# narrow frontiers (each probe walks every id before it: R = 17, R = 1 and
# frontiers of 100 on the codes and in full precision); for the slots never
# used and the sets made anew, codes, codes with 90% of the slots empty or
# the state in the scratch buffer (the tables in device memory), full
# precision, and the widest windows.
HOOKS = {"collide": "PGVS_ITER_COLLIDE=1", "miss": "PGVS_ITER_SPEC_MISS=1",
         "rebuild": "PGVS_ITER_SET_SLACK=4"}
HOOK_CASES = [("collide", 7), ("collide", 16), ("collide", 17), ("collide", 18),
              ("miss", 0), ("miss", 3), ("miss", 15), ("miss", 18),
              ("rebuild", 0), ("rebuild", 5), ("rebuild", 14), ("rebuild", 17)]


@pytest.fixture(scope="module")
def emulated_hooks(tmp_path_factory):
    """The kernel built for the CPU with each of HOOKS (the builds at once):
    name -> library."""
    def build(item):
        name, define = item
        return name, build_emulated(tmp_path_factory.mktemp(f"iter_emu_{name}"), "iter_step",
                                    "iter_step_kernel", defines=(f"-D{define}",))

    with ThreadPoolExecutor(len(HOOKS)) as pool:
        return {name: its.bind(ctypes.CDLL(str(lib))) for name, lib in pool.map(build, HOOKS.items())}


@pytest.mark.parametrize("case", range(len(its.CHECK_CASES)))
def test_emulated_refills_match_plain(emulated, case):
    run_case(emulated, case)


@pytest.mark.parametrize("hook,case", HOOK_CASES)
def test_emulated_hooks_match_plain(emulated_hooks, hook, case):
    run_case(emulated_hooks[hook], case)


def run_case(lib, case):
    """A CHECK_CASES case's refills and reseed through ``lib`` and through
    the plain refill, compared after each."""
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
                                       visit_budget=budget, shared_limit=limit, lib=lib,
                                       device_args=(0, None), **kw)
        assert int(got[0].n_visits) - int(ours.n_visits) <= budget
        want = iterate.iter_step_plain(plain, arrays, qv, qc, emit_n=emit_n,
                                       visit_budget=budget, **kw)
        assert its.refill_differs(got, want, exact) == [], f"refill {k}"
        ours, plain = got[0], want[0]
    assert int(plain.n_visits) > 0
