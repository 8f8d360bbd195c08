"""Vectorized RobustPrune (PyTorch port of ``graph/prune.py``).

The reference's alpha-occlusion prune (pgvectorscale graph/mod.rs:392-488),
batched over B nodes, with the JAX package's semantics:

- Candidates sort by distance; zero distances break ties by id distance
  ``|cand - node|`` (neighbor_with_distance.rs:45-95).
- Alpha rounds 1.0, x1.2 while <= max_alpha.  Within a round candidates
  are scanned in sorted order; picking candidate i raises every later
  candidate j's occlusion factor to max(factor_j, d(j, node) / d(j, i)),
  with the reference's zero-divisor rules; j is pickable iff its factor
  <= alpha.
- Label-aware (labeled indexes): picked i raises j's factor only if
  labels_i contains labels_j ∩ node_labels (graph/mod.rs:452-462).

The dependent scan is a Python loop of n_alphas * C steps, each a few
in-place ops on [B, C] tensors; the [B, C, C] factor matrix (and the
[B, C, C] label gate) is computed once up front.
"""

from __future__ import annotations

import numpy as np
import torch

from typing import Optional

from ..config import DistanceType
from ..labels import pairwise_contains_intersection
from ..ops.hamming import code_bits
from ..store import INVALID_ID

_F32_EPS = float(np.finfo(np.float32).eps)
_BIG = 3.0e38
_UNSELECTED = 2**31 - 1


def alpha_schedule(max_alpha: float) -> tuple[float, ...]:
    """Alpha rounds: 1.0, x1.2 while <= max_alpha (graph/mod.rs:416,484)."""
    alphas = []
    a = 1.0
    while a <= max_alpha:
        alphas.append(a)
        a *= 1.2
    return tuple(alphas)


def robust_prune(
    node_ids: torch.Tensor,  # i32[B]
    cand_ids: torch.Tensor,  # i32[B, C] (INVALID_ID padding; may hold node)
    cand_dists: torch.Tensor,  # f32[B, C] distance(candidate, node)
    pair_dists: torch.Tensor,  # f32[B, C, C] distance(candidate_i, candidate_j)
    cand_labels: Optional[torch.Tensor] = None,  # i32[B, C, Lm] (labeled)
    node_labels: Optional[torch.Tensor] = None,  # i32[B, Lm] (labeled)
    *,
    num_neighbors: int,
    alphas: tuple[float, ...],
) -> tuple[torch.Tensor, torch.Tensor]:
    """(neighbor_ids i32[B, R], neighbor_dists f32[B, R]) in selection
    order, INVALID_ID / +inf padded.  With ``cand_labels`` of width > 0
    the prune is label-aware."""
    b, c = cand_ids.shape
    r = num_neighbors
    dev = cand_ids.device

    valid = (cand_ids != INVALID_ID) & (cand_ids != node_ids[:, None])
    dists = torch.where(valid, cand_dists, torch.inf)
    tie_q = (cand_ids - node_ids[:, None]).abs().to(torch.float32)

    # Two-key stable sort (distance, then id distance for zero distances):
    # sort by the minor key first, then stably by the major key.
    tie_key = torch.where(dists <= _F32_EPS, tie_q, 0.0)
    order = torch.sort(tie_key, dim=1, stable=True).indices
    order = torch.gather(
        order, 1,
        torch.sort(torch.gather(dists, 1, order), dim=1, stable=True).indices,
    )
    cand_ids = torch.gather(cand_ids, 1, order)
    dists = torch.gather(dists, 1, order)
    valid = torch.gather(valid, 1, order)
    tie_q = torch.gather(tie_q, 1, order)
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
        pair_dists < _F32_EPS,
        torch.where(num < _F32_EPS, tie_ratio, _BIG),
        num / torch.clamp_min(pair_dists, _F32_EPS),
    )
    del tie_pair, tie_ratio, pair_dists
    if labeled:
        # label_ok[b, i, j]: picked i may occlude j.
        label_ok = pairwise_contains_intersection(cand_labels, node_labels)

    alphas_t = torch.tensor(alphas, dtype=torch.float32, device=dev)
    col = torch.arange(c, device=dev)
    f = torch.where(valid, 0.0, _BIG).to(torch.float32)
    sel = torch.full((b, c), _UNSELECTED, dtype=torch.int32, device=dev)
    count = torch.zeros((b,), dtype=torch.int32, device=dev)
    for a in range(len(alphas)):
        alpha = alphas_t[a]
        for i in range(c):
            can_pick = (
                (count < r) & (sel[:, i] == _UNSELECTED)
                & (f[:, i] <= alpha) & valid[:, i]
            )
            sel[:, i] = torch.where(can_pick, count, sel[:, i])
            count += can_pick
            upd = can_pick[:, None] & (col > i)[None, :]
            if labeled:
                upd &= label_ok[:, i, :]
            torch.where(upd, torch.maximum(f, factor[:, i, :]), f, out=f)
            f[:, i] = torch.where(can_pick, _BIG, f[:, i])

    out_ids = torch.where(sel != _UNSELECTED, cand_ids, INVALID_ID)
    out_d = torch.where(sel != _UNSELECTED, dists, torch.inf)
    order = torch.sort(sel, dim=1, stable=True).indices
    return (
        torch.gather(out_ids, 1, order)[:, :r],
        torch.gather(out_d, 1, order)[:, :r],
    )


def pairwise_hamming_mxu(bits: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances among candidates from their unpacked 0/1
    bits f32[B, C, Db]: hamming(a, b) = pop(a) + pop(b) - 2 * dot(a, b),
    one batched matrix product.  Sums of 0/1 in float32 are exact (below
    2**24), so the result is exact.  Returns f32[B, C, C]."""
    bits = bits.to(torch.float32)
    dots = torch.bmm(bits, bits.transpose(1, 2))
    pops = torch.sum(bits, dim=-1)
    # In place, so one [B, C, C] buffer sits beside the bits (the storage
    # build's peak); every term is an integer, exact in any order.
    return dots.mul_(-2.0).add_(pops[:, :, None]).add_(pops[:, None, :])


def unpack_code_bits(codes: torch.Tensor, num_bits: int) -> torch.Tensor:
    """int32[..., W] packed codes -> f32[..., num_bits] 0/1 bits, LSB
    first; the transient holds one byte a bit (``ops.hamming.code_bits``)."""
    return code_bits(codes)[..., :num_bits].to(torch.float32)


def pairwise_distance_matrix_full(
    vecs: torch.Tensor,  # f32[B, C, D]
    distance_type: DistanceType,
) -> torch.Tensor:
    """Pairwise full-precision distances among candidates, [B, C, C]
    (one batched f32 matrix product, no TF32)."""
    vecs = vecs.to(torch.float32)
    dots = torch.bmm(vecs, vecs.transpose(1, 2))
    if distance_type == DistanceType.INNER_PRODUCT:
        return -dots
    if distance_type == DistanceType.COSINE:
        return torch.clamp_min(1.0 - dots, 0.0)
    sq = torch.sum(vecs * vecs, dim=-1)
    return torch.clamp_min(sq[:, :, None] - 2.0 * dots + sq[:, None, :], 0.0)
