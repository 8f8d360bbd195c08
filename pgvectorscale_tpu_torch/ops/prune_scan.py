"""RobustPrune's dependent scan, one launch per prune.

Replaces the JAX package's ``lax.fori_loop`` over n_alphas x C steps in
``robust_prune`` (pgvectorscale_tpu/graph/prune.py:157), a device loop and
not a Pallas kernel; the port ran it as a Python loop of ~9 launches a
step.  The caller (``graph.prune.robust_prune``) sorts the candidates
(distance, then id distance for zero distances) and hands over the sorted
``dists``, ``cand_ids``, ``valid`` and ``tie_q`` with the sort's ``order``;
the pair distances [B, C, C] and the candidates' labels stay unsorted and
are read through ``order``.  With i the picker and j a later candidate in
sorted order, the occlusion factor is

    factor(i, j) = num / max(pd, eps)               pd >= eps
                 = tie_q[j] / max(|id_i - id_j|, 1)  pd < eps, num < eps
                 = BIG                               pd < eps, num >= eps

(``num = dists[j]``, ``pd = pair_dists[b, order[i], order[j]]``), gated on
a labeled index by ``labels.contains_intersection`` (picked i occludes j
only if labels_j ∩ node_labels ⊆ labels_i).  For each alpha and i in order,
i is picked iff fewer than R are picked, i is not, its factor f[i] <= alpha
and it is valid; a pick raises f[j] to max(f[j], factor(i, j)) for every
gated j > i.  The result is ``sel`` i32[B, C]: each candidate's pick rank,
``UNSELECTED`` for the rest.

Bound on an H100: a row's picks are a chain, each waiting on one read of
the picked candidate's pair row from device memory; bytes: those rows (C
floats each, at most B x R x C x 4) and the [B, C] inputs and output.
The kernel (``csrc/prune_scan.cu``) runs one warp a row, several rows a
block, so a wave's rows run in one round: position j in lane j % 32, the
next pick found by one ballot a 32 positions, the picked row copied whole
into shared memory by ``cp.async`` (and the next pick's row speculatively
beside it), the label gate one AND a pair on bitmasks built once a row.
The factor is computed with the plain version's f32 operations in its
order (no fast math), so ``sel`` is bit-equal.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain PyTorch version below.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np
import torch

from ..labels import pairwise_contains_intersection
from . import _build

F32_EPS = float(np.finfo(np.float32).eps)
BIG = 3.0e38
UNSELECTED = 2**31 - 1

launches = 0
_launch_lock = threading.Lock()


def count_launch() -> None:
    global launches
    with _launch_lock:
        launches += 1


def prune_scan_plain(
    order: torch.Tensor,  # i32/i64[B, C] the candidates' sort order
    pair_dists: torch.Tensor,  # f32[B, C, C] unsorted
    dists: torch.Tensor,  # f32[B, C] sorted (+inf where invalid)
    cand_ids: torch.Tensor,  # i32[B, C] sorted
    valid: torch.Tensor,  # bool[B, C] sorted
    tie_q: torch.Tensor,  # f32[B, C] sorted |cand - node|
    cand_labels: Optional[torch.Tensor] = None,  # i32[B, C, Lm] unsorted
    node_labels: Optional[torch.Tensor] = None,  # i32[B, Lm]
    *,
    num_neighbors: int,
    alphas: tuple[float, ...],
) -> torch.Tensor:
    """The plain version: the [B, C, C] factor matrix (and label gate) up
    front, then the scan as a Python loop of n_alphas x C steps of [B, C]
    tensor ops.  Returns ``sel`` i32[B, C]."""
    b, c = cand_ids.shape
    r = num_neighbors
    dev = cand_ids.device
    order = order.long()
    pair_dists = torch.gather(pair_dists, 1, order[:, :, None].expand(b, c, c))
    pair_dists = torch.gather(pair_dists, 2, order[:, None, :].expand(b, c, c))
    labeled = cand_labels is not None and cand_labels.shape[-1] > 0
    if labeled:
        cand_labels = torch.gather(
            cand_labels, 1, order[:, :, None].expand(-1, -1, cand_labels.shape[-1])
        )

    # factor[b, i, j] = get_factor(num=d(j, node), div=d(j, i))
    tie_pair = (cand_ids[:, :, None] - cand_ids[:, None, :]).abs().to(torch.float32)
    num = dists[:, None, :]
    tie_ratio = tie_q[:, None, :] / torch.clamp_min(tie_pair, 1.0)
    factor = torch.where(
        pair_dists < F32_EPS,
        torch.where(num < F32_EPS, tie_ratio, BIG),
        num / torch.clamp_min(pair_dists, F32_EPS),
    )
    del tie_pair, tie_ratio, pair_dists
    if labeled:
        # label_ok[b, i, j]: picked i may occlude j.
        label_ok = pairwise_contains_intersection(cand_labels, node_labels)

    alphas_t = torch.tensor(alphas, dtype=torch.float32, device=dev)
    col = torch.arange(c, device=dev)
    f = torch.where(valid, 0.0, BIG).to(torch.float32)
    sel = torch.full((b, c), UNSELECTED, dtype=torch.int32, device=dev)
    count = torch.zeros((b,), dtype=torch.int32, device=dev)
    for a in range(len(alphas)):
        alpha = alphas_t[a]
        for i in range(c):
            can_pick = (
                (count < r) & (sel[:, i] == UNSELECTED)
                & (f[:, i] <= alpha) & valid[:, i]
            )
            sel[:, i] = torch.where(can_pick, count, sel[:, i])
            count += can_pick
            upd = can_pick[:, None] & (col > i)[None, :]
            if labeled:
                upd &= label_ok[:, i, :]
            torch.where(upd, torch.maximum(f, factor[:, i, :]), f, out=f)
            f[:, i] = torch.where(can_pick, BIG, f[:, i])
    return sel


def _check(order, pair_dists, dists, cand_ids, valid, tie_q, cand_labels, node_labels):
    b, c = cand_ids.shape
    dev = cand_ids.device
    want = (("order", order, torch.int32, (b, c)), ("pair_dists", pair_dists, torch.float32, (b, c, c)),
            ("dists", dists, torch.float32, (b, c)), ("cand_ids", cand_ids, torch.int32, (b, c)),
            ("valid", valid, torch.bool, (b, c)), ("tie_q", tie_q, torch.float32, (b, c)))
    if cand_labels is not None:
        lm = cand_labels.shape[-1]
        want += (("cand_labels", cand_labels, torch.int32, (b, c, lm)),
                 ("node_labels", node_labels, torch.int32, (b, lm)))
    for name, t, dtype, shape in want:
        if t is None:
            raise ValueError(f"{name} is missing")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, cand_ids on {dev}")


def prune_scan(
    order: torch.Tensor,
    pair_dists: torch.Tensor,
    dists: torch.Tensor,
    cand_ids: torch.Tensor,
    valid: torch.Tensor,
    tie_q: torch.Tensor,
    cand_labels: Optional[torch.Tensor] = None,
    node_labels: Optional[torch.Tensor] = None,
    *,
    num_neighbors: int,
    alphas: tuple[float, ...],
) -> torch.Tensor:
    """``sel`` i32[B, C]: each sorted candidate's pick rank, UNSELECTED for
    the rest (arguments as ``prune_scan_plain``; ``order`` int32 here)."""
    if cand_labels is not None and cand_labels.shape[-1] == 0:
        cand_labels = node_labels = None
    _check(order, pair_dists, dists, cand_ids, valid, tie_q, cand_labels, node_labels)
    device = cand_ids.device
    if device.type == "cpu":
        return prune_scan_plain(order, pair_dists, dists, cand_ids, valid, tie_q, cand_labels,
                                node_labels, num_neighbors=num_neighbors, alphas=alphas)
    if device.type != "cuda":
        raise ValueError(f"no prune-scan kernel for device {device}")
    sel = launch(order, pair_dists, dists, cand_ids, valid, tie_q, cand_labels, node_labels,
                 num_neighbors=num_neighbors, alphas=alphas)
    if sel.numel():
        count_launch()
    return sel


def launch(order, pair_dists, dists, cand_ids, valid, tie_q, cand_labels, node_labels, *,
           num_neighbors: int, alphas: tuple[float, ...], lib=None) -> torch.Tensor:
    """The kernel on checked CUDA tensors, uncounted: ``sel``.  ``lib``: the
    ``bind`` of another build of the same C interface (default: this
    checkout's)."""
    device = cand_ids.device
    b, c = cand_ids.shape
    sel = torch.empty((b, c), dtype=torch.int32, device=device)
    if b * c == 0:
        return sel
    fn, smem_bytes = lib if lib is not None else bind(_build.load("prune_scan"))
    if smem_bytes(c) > _build.MAX_SHARED_BYTES:
        raise ValueError(f"{c} candidates need {smem_bytes(c)} B of shared memory a row, "
                         f"over the card's {_build.MAX_SHARED_BYTES}")
    alphas_t = _alphas_on(tuple(alphas), device)
    lm = 0 if cand_labels is None else cand_labels.shape[-1]
    err = fn(
        order.data_ptr(), pair_dists.data_ptr(), dists.data_ptr(), cand_ids.data_ptr(),
        valid.data_ptr(), tie_q.data_ptr(),
        None if cand_labels is None else cand_labels.data_ptr(),
        None if node_labels is None else node_labels.data_ptr(),
        alphas_t.data_ptr(), sel.data_ptr(), b, c, lm, len(alphas), num_neighbors,
        device.index if device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"prune-scan kernel launch failed: CUDA error {err}")
    return sel


# (alphas, device) -> the alphas as an f32 tensor on the device: a copy
# to the card waits for it, so each schedule is copied once.
_ALPHAS: dict = {}


def _alphas_on(alphas: tuple, device) -> torch.Tensor:
    key = (alphas, str(device))
    if key not in _ALPHAS:
        _ALPHAS[key] = torch.tensor(alphas, dtype=torch.float32, device=device)
    return _ALPHAS[key]


def bind(lib: ctypes.CDLL):
    """(launch function, shared-bytes function) of a loaded build of
    ``csrc/prune_scan.cu``, with their ctypes signatures set."""
    fn = lib.pgvs_prune_scan
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    smem = lib.pgvs_prune_scan_smem_bytes
    smem.argtypes = [ctypes.c_int]
    smem.restype = ctypes.c_int
    return fn, smem


def bound_bytes(b: int, c: int, picks: int, lm: int = 0) -> int:
    """Bytes the function must move from device memory: the pair row (C
    floats) of each of the ``picks`` picked candidates, the [B, C] inputs
    (order, dists, ids, tie_q, 4 bytes each; valid, 1 byte) and the output
    once, and on a labeled index the candidates' and nodes' labels."""
    return picks * c * 4 + b * c * (4 * 4 + 1 + 4) + (b * c + b) * lm * 4


def check_inputs(b: int, c: int, lm: int, device, generator=None, *, label_values: int = 6,
                 sentinel_share: float = 0.3, edge_rows: bool = False):
    """Random inputs of one kernel check, heavy in ties: (node_ids [B],
    cand_ids [B, C] with the node in column 0 and ~10% INVALID_ID, cand_dists
    [B, C] in steps of 0.1 from 0, pair_dists [B, C, C] as L1 distances
    over 3 of points on a 4-step grid (many zeros), and, for ``lm`` > 0,
    cand_labels [B, C, Lm] and node_labels [B, Lm] drawn from
    ``label_values`` labels with ``sentinel_share`` sentinel padding; else
    None, None).  ``edge_rows`` (B >= 4): row 0 has no valid candidate; on
    a labeled check row 1's node labels are all sentinel, every other
    candidate of row 2 carries none, and row 3's node repeats label 2."""
    kw = dict(device=device, generator=generator)
    node_ids = torch.randint(0, 4 * c, (b,), dtype=torch.int32, **kw)
    cand_ids = torch.randint(0, 4 * c, (b, c), dtype=torch.int32, **kw)
    cand_ids[:, 0] = node_ids
    cand_ids[torch.rand((b, c), **kw) < 0.1] = -1
    cand_dists = torch.randint(0, 30, (b, c), **kw).to(torch.float32) / 10.0
    pts = torch.randint(0, 4, (b, c, 3), **kw).to(torch.float32)
    pair = (pts[:, :, None, :] - pts[:, None, :, :]).abs().sum(-1) / 3.0
    if edge_rows:
        cand_ids[0] = -1
    if lm == 0:
        return node_ids, cand_ids, cand_dists, pair, None, None

    def labels(shape):
        lab = torch.randint(0, label_values, shape, dtype=torch.int32, **kw)
        lab[torch.rand(shape, **kw) < sentinel_share] = 2**31 - 1
        return lab

    cand_labels, node_labels = labels((b, c, lm)), labels((b, lm))
    if edge_rows:
        node_labels[1] = 2**31 - 1
        cand_labels[2, ::2] = 2**31 - 1
        node_labels[3] = 2
    return node_ids, cand_ids, cand_dists, pair, cand_labels, node_labels


# The cases the kernel is held to on the card (tests/test_torch_kernels.py)
# and, cut to a few rows, on the CPU through its emulated source
# (tests/test_torch_prune_emulated.py): the main path's C (40, 129, 166,
# 332), unlabeled and labeled, one to three alpha rounds, a degree bound
# that stops the scan early; then C around one slot of 32 lanes (1, 31,
# 32, 33), every register-slot count (C = 100 and 230 too), R = 1 and R
# reached in the first round, an all-invalid row, all-sentinel and
# repeated labels, 1 to 3 labels, C past the register path (f and order
# in shared memory), and 40 labels from 1,000 (the label masks' second
# word).
CHECK_CASES = [
    dict(b=64, c=40, lm=0, r=10, max_alpha=1.2),
    dict(b=64, c=166, lm=0, r=65, max_alpha=1.2),
    dict(b=64, c=166, lm=2, r=65, max_alpha=1.2),
    dict(b=64, c=332, lm=0, r=65, max_alpha=1.0),
    dict(b=64, c=332, lm=1, r=65, max_alpha=1.2),
    dict(b=32, c=332, lm=3, r=8, max_alpha=1.2),
    dict(b=64, c=1, lm=0, r=10, max_alpha=1.2),
    dict(b=64, c=31, lm=1, r=65, max_alpha=1.5, edge_rows=True),
    dict(b=64, c=32, lm=2, r=1, max_alpha=1.2, edge_rows=True),
    dict(b=64, c=33, lm=3, r=65, max_alpha=1.5, edge_rows=True),
    dict(b=64, c=100, lm=1, r=20, max_alpha=1.2, edge_rows=True),
    dict(b=64, c=129, lm=0, r=65, max_alpha=1.2, edge_rows=True),
    dict(b=64, c=129, lm=2, r=4, max_alpha=1.5, edge_rows=True),
    dict(b=32, c=230, lm=0, r=65, max_alpha=1.5),
    dict(b=32, c=353, lm=0, r=65, max_alpha=1.5, edge_rows=True),
    dict(b=16, c=1200, lm=2, r=65, max_alpha=1.2, edge_rows=True),
    dict(b=32, c=166, lm=40, r=65, max_alpha=1.2, label_values=1000, sentinel_share=0.05,
         edge_rows=True),
    dict(b=8, c=700, lm=40, r=65, max_alpha=1.5, label_values=1000, sentinel_share=0.05),
]


def case_inputs(case: dict, device, generator=None):
    """``check_inputs`` of one CHECK_CASES entry."""
    opts = {k: v for k, v in case.items() if k not in ("b", "c", "lm", "r", "max_alpha")}
    return check_inputs(case["b"], case["c"], case["lm"], device, generator, **opts)


def case_id(case: dict) -> str:
    return "-".join(f"{k}{v}" for k, v in case.items())
