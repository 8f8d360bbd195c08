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

Bound on an H100: the C steps of a round are a dependent chain; at most R
of them pick.  Bytes: the picked candidates' pair rows (C floats each, at
most B x R x C x 4) and the [B, C] inputs and output.  The kernel
(``csrc/prune_scan.cu``) runs one block a row with the scan's state in
shared memory; a step that picks nothing costs no barrier, a pick spreads
its row's update over the threads and ends in one barrier.  The factor
and the gate are computed on the fly with the plain version's f32
operations in its order (no fast math), so ``sel`` is bit-equal.

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
    b, c = cand_ids.shape
    sel = torch.empty((b, c), dtype=torch.int32, device=device)
    if b * c == 0:
        return sel
    fn, smem_bytes = _kernel()
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
    count_launch()
    return sel


# (alphas, device) -> the alphas as an f32 tensor on the device: a copy
# to the card waits for it, so each schedule is copied once.
_ALPHAS: dict = {}


def _alphas_on(alphas: tuple, device) -> torch.Tensor:
    key = (alphas, str(device))
    if key not in _ALPHAS:
        _ALPHAS[key] = torch.tensor(alphas, dtype=torch.float32, device=device)
    return _ALPHAS[key]


def _kernel():
    lib = _build.load("prune_scan")
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


def check_inputs(b: int, c: int, lm: int, device, generator=None):
    """Random inputs of one kernel check, heavy in ties: (node_ids [B],
    cand_ids [B, C] with the node in column 0 and ~10% INVALID_ID, cand_dists
    [B, C] in steps of 0.1 from 0, pair_dists [B, C, C] as L1 distances
    over 3 of points on a 4-step grid (many zeros), and, for ``lm`` > 0,
    cand_labels [B, C, Lm] and node_labels [B, Lm] drawn from 6 labels
    with ~30% sentinel padding; else None, None)."""
    kw = dict(device=device, generator=generator)
    node_ids = torch.randint(0, 4 * c, (b,), dtype=torch.int32, **kw)
    cand_ids = torch.randint(0, 4 * c, (b, c), dtype=torch.int32, **kw)
    cand_ids[:, 0] = node_ids
    cand_ids[torch.rand((b, c), **kw) < 0.1] = -1
    cand_dists = torch.randint(0, 30, (b, c), **kw).to(torch.float32) / 10.0
    pts = torch.randint(0, 4, (b, c, 3), **kw).to(torch.float32)
    pair = (pts[:, :, None, :] - pts[:, None, :, :]).abs().sum(-1) / 3.0
    if lm == 0:
        return node_ids, cand_ids, cand_dists, pair, None, None

    def labels(shape):
        lab = torch.randint(0, 6, shape, dtype=torch.int32, **kw)
        lab[torch.rand(shape, **kw) < 0.3] = 2**31 - 1
        return lab

    return node_ids, cand_ids, cand_dists, pair, labels((b, c, lm)), labels((b, lm))


# The cases the kernel is held to on the card (tests/test_torch_kernels.py):
# (B, C, Lm, R, max_alpha): unlabeled and labeled rows, one and two alpha
# rounds, a degree bound that stops the scan early.
CHECK_CASES = [(64, 40, 0, 10, 1.2), (64, 166, 0, 65, 1.2), (64, 166, 2, 65, 1.2),
               (64, 332, 0, 65, 1.0), (64, 332, 1, 65, 1.2), (32, 332, 3, 8, 1.2)]
