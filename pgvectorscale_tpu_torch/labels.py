"""Label sets for filtered search (PyTorch port of ``labels.py``).

The reference stores a sorted, deduplicated ``Vec<i16>`` per node
(pgvectorscale labels/mod.rs); the index stores a fixed-width int32 row
per node, sorted and padded with ``LABEL_SENTINEL`` (INT32_MAX, outside
the smallint domain), so label tests are batched tensor comparisons:

- ``overlaps``              <-> LabelSet::overlaps (labels/mod.rs:124-142)
- ``contains_intersection`` <-> LabelSet::contains_intersection, "is
  a ∩ b ⊆ self" (labels/mod.rs:85-111), used by label-aware pruning
- ``array_overlap``         <-> smallint_array_overlap, the ``&&``
  operator (access_method/mod.rs:284-317)

NULL and empty label arrays are all-sentinel rows: empty sets, which
overlap nothing.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np
import torch

LABEL_SENTINEL = 2**31 - 1

# Labels are Postgres smallint (i16).
LABEL_MIN = -(2**15)
LABEL_MAX = 2**15 - 1


def make_label_array(
    label_sets: Sequence[Optional[Iterable[int]]],
    max_labels: int,
) -> np.ndarray:
    """Host side: per-vector label iterables (or None) -> int32[N,
    max_labels] sorted, deduplicated, sentinel-padded rows.  Raises
    ValueError for a label outside the smallint range or a row with more
    than ``max_labels`` labels."""
    n = len(label_sets)
    out = np.full((n, max_labels), LABEL_SENTINEL, dtype=np.int32)
    for row, labels in enumerate(label_sets):
        if labels is None:
            continue
        vals = sorted(set(int(v) for v in labels))
        for v in vals:
            if not (LABEL_MIN <= v <= LABEL_MAX):
                raise ValueError(
                    f"label {v} out of smallint range [{LABEL_MIN}, {LABEL_MAX}]"
                )
        if len(vals) > max_labels:
            raise ValueError(
                f"vector has {len(vals)} labels; index supports at most "
                f"{max_labels} (max_labels_per_vector)"
            )
        out[row, : len(vals)] = np.asarray(vals, dtype=np.int32)
    return out


def is_valid(labels: torch.Tensor) -> torch.Tensor:
    """Mask of real (non-padding) entries."""
    return labels != LABEL_SENTINEL


def is_empty(labels: torch.Tensor) -> torch.Tensor:
    """True where a label set (last axis) is empty."""
    return torch.all(labels == LABEL_SENTINEL, dim=-1)


def overlaps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Do the label sets share an element?  a: [..., La], b: [..., Lb]
    (leading axes broadcast) -> bool[...]."""
    eq = a[..., :, None] == b[..., None, :]
    valid = is_valid(a)[..., :, None] & is_valid(b)[..., None, :]
    return torch.any((eq & valid).flatten(-2), dim=-1)


def contains_intersection(
    self_labels: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
) -> torch.Tensor:
    """Is (a ∩ b) ⊆ self_labels?  Leading axes broadcast; the label axes
    may differ in width.  Vacuously true when a ∩ b is empty."""
    a_in_b = torch.any(
        (a[..., :, None] == b[..., None, :]) & is_valid(b)[..., None, :], dim=-1
    ) & is_valid(a)
    a_in_self = torch.any(
        (a[..., :, None] == self_labels[..., None, :])
        & is_valid(self_labels)[..., None, :],
        dim=-1,
    )
    return torch.all(~a_in_b | a_in_self, dim=-1)


def pairwise_contains_intersection(
    cand_labels: torch.Tensor,  # i32[B, C, Lm]
    node_labels: torch.Tensor,  # i32[B, Lm]
) -> torch.Tensor:
    """bool[B, C, C]: ``[b, i, j] = contains_intersection(cand_labels[b, i],
    cand_labels[b, j], node_labels[b])``, the prune's occlusion gate.

    The broadcast form holds [B, C, C, Lm, Lm] transients; this one loops
    over the Lm^2 label pairs and keeps every transient at [B, C, C]."""
    lm = cand_labels.shape[-1]
    # a_in_node[b, j, p]: label p of candidate j is a real label of the node.
    a_in_node = torch.any(
        (cand_labels[..., :, None] == node_labels[:, None, None, :])
        & is_valid(node_labels)[:, None, None, :],
        dim=-1,
    ) & is_valid(cand_labels)
    self_valid = is_valid(cand_labels)
    b, c = cand_labels.shape[:2]
    ok = torch.ones((b, c, c), dtype=torch.bool, device=cand_labels.device)
    for p in range(lm):
        a_p = cand_labels[:, None, :, p]  # label p of j, over i
        in_self = torch.zeros_like(ok)
        for q in range(lm):
            # label q of i (a real label) equals label p of j
            in_self |= (cand_labels[:, :, None, q] == a_p) & self_valid[:, :, None, q]
        ok &= in_self | ~a_in_node[:, None, :, p]
    return ok


def array_overlap(left: Sequence[int], right: Sequence[int]) -> bool:
    """Host-side ``&&`` operator (smallint_array_overlap)."""
    if len(left) <= 10 or len(right) <= 10:
        return any(x == y for x in left for y in right)
    return bool(set(left) & set(right))
