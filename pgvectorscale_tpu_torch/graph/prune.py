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

The candidates' sort stays here, in torch; the dependent scan of
n_alphas * C steps is ``ops.prune_scan``: one kernel launch per prune on
the card, which reads the pair distances and labels through the sort's
order, and on the CPU its plain version, a Python loop over [B, C]
tensors after the [B, C, C] factor matrix (and label gate) up front.
"""

from __future__ import annotations

import torch

from typing import Optional

from ..config import DistanceType
from ..ops.hamming import code_bits
from ..ops.prune_scan import F32_EPS as _F32_EPS
from ..ops.prune_scan import UNSELECTED, prune_scan
from ..store import INVALID_ID


def alpha_schedule(max_alpha: float) -> tuple[float, ...]:
    """Alpha rounds: 1.0, x1.2 while <= max_alpha (graph/mod.rs:416,484)."""
    alphas = []
    a = 1.0
    while a <= max_alpha:
        alphas.append(a)
        a *= 1.2
    return tuple(alphas)


def sort_candidates(
    node_ids: torch.Tensor,  # i32[B]
    cand_ids: torch.Tensor,  # i32[B, C]
    cand_dists: torch.Tensor,  # f32[B, C]
) -> tuple[torch.Tensor, ...]:
    """The candidates in prune order: (order i32[B, C], and sorted by it
    cand_ids, dists (+inf where invalid), valid (neither padding nor the
    node) and tie_q = |cand - node| as f32).  Two-key stable sort: by the
    minor key (id distance, for zero distances only) first, then stably
    by distance."""
    valid = (cand_ids != INVALID_ID) & (cand_ids != node_ids[:, None])
    dists = torch.where(valid, cand_dists, torch.inf)
    tie_q = (cand_ids - node_ids[:, None]).abs().to(torch.float32)
    tie_key = torch.where(dists <= _F32_EPS, tie_q, 0.0)
    order = torch.sort(tie_key, dim=1, stable=True).indices
    order = torch.gather(
        order, 1,
        torch.sort(torch.gather(dists, 1, order), dim=1, stable=True).indices,
    )
    return (order.to(torch.int32), *(torch.gather(t, 1, order)
                                      for t in (cand_ids, dists, valid, tie_q)))


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
    r = num_neighbors
    order, cand_ids, dists, valid, tie_q = sort_candidates(node_ids, cand_ids, cand_dists)
    # The scan reads the pair distances and the labels through ``order``.
    sel = prune_scan(order, pair_dists, dists, cand_ids, valid, tie_q, cand_labels,
                     node_labels, num_neighbors=r, alphas=alphas)

    out_ids = torch.where(sel != UNSELECTED, cand_ids, INVALID_ID)
    out_d = torch.where(sel != UNSELECTED, dists, torch.inf)
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
