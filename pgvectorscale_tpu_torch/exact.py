"""Exact (brute-force) index: the seqscan analog and the recall oracle
(PyTorch port of ``exact.py``).

The analog of the sequential scan Postgres falls back to when the diskann
index is unusable (cost_estimate.rs:6-50) and of the seqscan ground truth
the reference's tests compare against.  One distance matrix and a stable
sort per query block (``ops.bruteforce``), on the index's device: ties
keep the lowest row id first, as the JAX package's ``lax.top_k``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import IndexConfig
from .distance import preprocess_query
from .ops.bruteforce import brute_force_search


def _rows(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, dtype=np.float32))
    return x.to(device, torch.float32)


class ExactIndex:
    """Flat exact-search index with the core of DiskannIndex's surface
    (build / add / search / delete / to_external).  Rows are stored
    preprocessed (cosine rows normalized) on ``device``; ``None`` means
    the card."""

    def __init__(self, config: IndexConfig, device=None):
        from .index import resolve_device

        self.config = config
        self.device = resolve_device(device)
        self.vectors = torch.zeros((0, config.num_dimensions), dtype=torch.float32,
                                   device=self.device)
        self.deleted = torch.zeros((0,), dtype=torch.bool, device=self.device)
        self.external_ids = np.zeros((0,), dtype=np.int64)

    @classmethod
    def build(cls, vectors, config: Optional[IndexConfig] = None, *,
              external_ids=None, device=None) -> "ExactIndex":
        if config is None:
            config = IndexConfig(num_dimensions=np.shape(vectors)[1])
        index = cls(config, device=device)
        index.add(vectors, external_ids=external_ids)
        return index

    @property
    def count(self) -> int:
        return self.vectors.shape[0]

    def add(self, vectors, *, external_ids=None) -> np.ndarray:
        """Append rows [M, D]; returns their row ids (int32).  External ids
        default to max + 1 onwards."""
        rows = _rows(vectors, self.device)
        if rows.dim() != 2 or rows.shape[1] != self.config.num_dimensions:
            raise ValueError("vectors must be [M, num_dimensions]")
        m, n0 = rows.shape[0], self.count
        self.vectors = torch.cat([self.vectors,
                                  preprocess_query(rows, self.config.distance_type)])
        self.deleted = torch.cat([self.deleted, torch.zeros((m,), dtype=torch.bool,
                                                            device=self.device)])
        if external_ids is None:
            base = int(self.external_ids.max()) + 1 if len(self.external_ids) else 0
            external_ids = np.arange(base, base + m, dtype=np.int64)
        self.external_ids = np.concatenate(
            [self.external_ids, np.asarray(external_ids, dtype=np.int64)])
        return np.arange(n0, n0 + m, dtype=np.int32)

    def delete(self, ids) -> None:
        """Tombstone row ids (numpy or a tensor); raises on an id out of
        range."""
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        if len(ids) == 0:
            return
        if (ids < 0).any() or (ids >= self.count).any():
            raise ValueError("delete ids out of range")
        self.deleted[torch.from_numpy(ids).to(self.device)] = True

    def search(self, queries, k: int):
        """Exact top-k: (ids i32[Q, k], dists f32[Q, k]) on the index's
        device; -1 / +inf for deleted rows and past the index size."""
        qv = _rows(queries, self.device)
        qv = qv[None] if qv.dim() == 1 else qv
        q = qv.shape[0]
        if self.count == 0:
            return (torch.full((q, k), -1, dtype=torch.int32, device=self.device),
                    torch.full((q, k), float("inf"), device=self.device))
        qv = preprocess_query(qv, self.config.distance_type)
        kk = min(k, self.count)
        ids, dists = brute_force_search(qv, self.vectors, ~self.deleted, k=kk,
                                        distance_type=self.config.distance_type)
        if k > kk:
            ids = torch.nn.functional.pad(ids, (0, k - kk), value=-1)
            dists = torch.nn.functional.pad(dists, (0, k - kk), value=float("inf"))
        return torch.where(torch.isinf(dists), -1, ids), dists

    def to_external(self, ids) -> np.ndarray:
        """Row ids (numpy or a tensor) -> external ids, int64; -1 -> -1."""
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        ids = np.asarray(ids)
        out = np.full(ids.shape, -1, dtype=np.int64)
        mask = ids >= 0
        out[mask] = self.external_ids[ids[mask]]
        return out
