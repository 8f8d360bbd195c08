"""Exact (brute-force) nearest-neighbour search (the port's
``ops/bruteforce.py``).

The reference's seqscan ground truth for its accuracy scaffolds
(reference: pgvectorscale/src/access_method/build.rs:1717-1753,
``verify_index_accuracy``): one distance matrix and a top-k, on the
device of the tensors it is given.
"""

from __future__ import annotations

import torch

from ..config import DistanceType
from ..distance import distance_matrix

_QUERY_BLOCK = 1024  # queries per [block, N] distance matrix, at most
_BLOCK_ELEMS = 1 << 28  # [block, N] elements: a 1 GiB float32 matrix


def brute_force_search(
    queries: torch.Tensor,  # f32[Q, D]
    points: torch.Tensor,  # f32[N, D]
    valid: torch.Tensor,  # bool[N]: live (non-deleted) rows
    *,
    k: int,
    distance_type: DistanceType,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k: (ids i32[Q, k], dists f32[Q, k]) on the inputs' device.
    Ties keep the lowest id first (a stable sort, as ``lax.top_k``);
    invalid rows score +inf.  Queries go in blocks of at most 1,024, and
    of at most 2**28 distances, to bound the [Q, N] matrix and its sort."""
    block = max(1, min(_QUERY_BLOCK, _BLOCK_ELEMS // max(points.shape[0], 1)))
    ids, dists = [], []
    for i in range(0, queries.shape[0], block):
        d = distance_matrix(queries[i : i + block], points, distance_type)
        d = torch.where(valid[None, :], d, torch.inf)
        s, order = torch.sort(d, dim=1, stable=True)
        ids.append(order[:, :k].to(torch.int32))
        dists.append(s[:, :k])
    if not ids:
        return (torch.zeros((0, k), dtype=torch.int32, device=queries.device),
                torch.zeros((0, k), dtype=torch.float32, device=queries.device))
    return torch.cat(ids), torch.cat(dists)
