"""Full-precision distances (PyTorch port of ``pgvectorscale_tpu/distance.py``).

Same semantics as the reference's distance kernels
(pgvectorscale/src/access_method/distance/mod.rs):

- L2 skips the sqrt (distances only order results).
- Inner product is negated so that smaller is closer.
- Cosine assumes normalized vectors and returns ``max(0, 1 - dot)``.
- ``preprocess_cosine`` normalizes unless a row is ~zero or already has a
  norm within a length-scaled epsilon of 1.

Float32 matrix products run in full float32: the port never enables TF32
(``torch.backends.cuda.matmul.allow_tf32`` stays False), matching the JAX
package's ``Precision.HIGHEST``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import DistanceType

_F32_EPS = float(np.finfo(np.float32).eps)


def preprocess_cosine(vectors: torch.Tensor) -> torch.Tensor:
    """Normalize rows for cosine distance (distance/mod.rs:225-253).

    Rows whose squared norm is below f32 epsilon (zero vectors) or within
    ``eps * dims`` of 1.0 are left untouched."""
    vectors = vectors.to(torch.float32)
    dims = vectors.shape[-1]
    sq_norm = torch.sum(vectors * vectors, dim=-1, keepdim=True)
    adj_eps = _F32_EPS * dims
    is_zero = sq_norm < _F32_EPS
    is_unit = (sq_norm >= 1.0 - adj_eps) & (sq_norm <= 1.0 + adj_eps)
    skip = is_zero | is_unit
    denom = torch.where(skip, torch.ones_like(sq_norm), torch.sqrt(sq_norm))
    return torch.where(skip, vectors, vectors / denom)


def _from_dots(dots: torch.Tensor, distance_type: DistanceType) -> torch.Tensor:
    if distance_type == DistanceType.INNER_PRODUCT:
        return -dots
    return torch.clamp_min(1.0 - dots, 0.0)


def distance_matrix(
    queries: torch.Tensor,
    points: torch.Tensor,
    distance_type: DistanceType,
) -> torch.Tensor:
    """Batched distance matrix ``[Q, D] x [C, D] -> [Q, C]``."""
    queries = queries.to(torch.float32)
    points = points.to(torch.float32)
    dots = queries @ points.T
    if distance_type != DistanceType.L2:
        return _from_dots(dots, distance_type)
    q_sq = torch.sum(queries * queries, dim=-1, keepdim=True)
    c_sq = torch.sum(points * points, dim=-1)[None, :]
    return torch.clamp_min(q_sq - 2.0 * dots + c_sq, 0.0)


def pairwise_distance(
    a: torch.Tensor,
    b: torch.Tensor,
    distance_type: DistanceType,
) -> torch.Tensor:
    """Row-paired distance ``[N, D], [N, D] -> [N]``."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if distance_type == DistanceType.L2:
        diff = a - b
        return torch.clamp_min(torch.sum(diff * diff, dim=-1), 0.0)
    return _from_dots(torch.sum(a * b, dim=-1), distance_type)


def gathered_distances(
    rows: torch.Tensor,  # f32[Q, M, D] gathered candidate rows
    query_vecs: torch.Tensor,  # f32[Q, D]
    distance_type: DistanceType,
) -> torch.Tensor:
    """Distances from each query to its own gathered rows: ``[Q, M]``.

    The ``einsum("qmd,qd->qm")`` of the JAX package, written as one
    batched matrix-vector product."""
    if distance_type == DistanceType.L2:
        diff = rows - query_vecs[:, None, :]
        return torch.clamp_min(torch.sum(diff * diff, dim=-1), 0.0)
    dots = torch.bmm(rows, query_vecs[:, :, None])[..., 0]
    return _from_dots(dots, distance_type)


# Bytes of one chunk of gathered rows (twice that for L2, whose
# differences are a second tensor of the same size): ``row_distances``
# gathers at most this much at once.  Rows are independent, so the chunking
# changes no result.
GATHER_CHUNK_BYTES = 1 << 30


def row_distances(
    vectors: torch.Tensor,  # f32, bf16 or int8[cap, D]
    query_vecs: torch.Tensor,  # f32[Q, Dq], Dq <= D
    ids: torch.Tensor,  # i32[Q, M] (clamped at 0; callers mask)
    distance_type: DistanceType,
    scales: Optional[torch.Tensor] = None,  # f32[cap], the int8 tier's
) -> torch.Tensor:
    """Distances from each query to the rows ``vectors[ids]`` on their
    first ``Dq`` dims (the indexed prefix), ``[Q, M]``: the JAX package's
    gather and ``gathered_distances``, over chunks of queries.  bf16 and
    int8 rows are gathered in their storage dtype (fewer bytes read) and
    each chunk is converted to float32 (int8 rows times their ``scales``)
    before the dot; chunks are sized by the float32 rows they become."""
    q, m = ids.shape
    dq = query_vecs.shape[-1]
    table = vectors[:, :dq]
    safe = ids.clamp_min(0).long()

    def part(rows_ids, qv):
        rows = table[rows_ids].to(torch.float32)
        if table.dtype == torch.int8:
            rows = rows * scales[rows_ids][..., None]
        return gathered_distances(rows, qv, distance_type)

    if table.dtype == torch.int8 and scales is None:
        raise ValueError("int8 rows need their scales")
    per_query = m * dq * 4 * (2 if distance_type == DistanceType.L2 else 1)
    chunk = max(1, GATHER_CHUNK_BYTES // max(per_query, 1))
    if chunk >= q:
        return part(safe, query_vecs)
    return torch.cat([
        part(safe[i : i + chunk], query_vecs[i : i + chunk])
        for i in range(0, q, chunk)
    ])


def preprocess_query(
    query: torch.Tensor, distance_type: DistanceType
) -> torch.Tensor:
    """Cosine queries are normalized the same way ingested vectors are."""
    query = query.to(torch.float32)
    if distance_type == DistanceType.COSINE:
        return preprocess_cosine(query)
    return query
