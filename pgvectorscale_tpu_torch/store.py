"""Flat tensor graph store (PyTorch port of ``pgvectorscale_tpu/store.py``).

Every index component is a flat, preallocated structure-of-arrays tensor
on one device:

- ``vectors``   f32[cap, D]   full-precision vectors (the rescore tier)
- ``codes``     i32[cap, W]   packed SBQ codes; each word is the int32 bit
                              view of the JAX package's uint32 word
- ``adjacency`` i32[cap, R]   neighbor ids, ``-1`` padded
- ``deleted``   bool[cap]     tombstones

``count`` and ``default_start`` are host integers: the port runs eagerly,
so keeping them on the host saves a device read per use.  Labels and the
bf16/int8 vector tiers are not part of this slice of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import IndexConfig

INVALID_ID = -1
# The JAX package's empty label table, which every unlabeled checkpoint
# carries: LABEL_SENTINEL keys and INVALID_ID start nodes.
LABEL_SENTINEL = 2**31 - 1
LABEL_TABLE_CAPACITY = 1024


class GraphArrays(NamedTuple):
    vectors: torch.Tensor  # f32[cap, D]
    codes: torch.Tensor  # i32[cap, W]  (W == 0 for plain storage)
    adjacency: torch.Tensor  # i32[cap, R_max]
    deleted: torch.Tensor  # bool[cap]
    count: int  # live slots
    default_start: int  # INVALID_ID while the graph is empty

    @property
    def capacity(self) -> int:
        return self.adjacency.shape[0]

    @property
    def max_degree(self) -> int:
        return self.adjacency.shape[1]

    @property
    def device(self) -> torch.device:
        return self.adjacency.device


def empty_arrays(
    config: IndexConfig, capacity: int, device: torch.device
) -> GraphArrays:
    if config.vector_dtype != "f32" or config.has_labels:
        raise NotImplementedError(
            "the port stores f32 vectors without labels"
        )
    d = config.num_dimensions
    w = config.num_code_words if config.uses_sbq else 0
    r = config.max_neighbors_during_build
    return GraphArrays(
        vectors=torch.zeros((capacity, d), dtype=torch.float32, device=device),
        codes=torch.zeros((capacity, w), dtype=torch.int32, device=device),
        adjacency=torch.full(
            (capacity, r), INVALID_ID, dtype=torch.int32, device=device
        ),
        deleted=torch.zeros((capacity,), dtype=torch.bool, device=device),
        count=0,
        default_start=INVALID_ID,
    )


def grow(arrays: GraphArrays, new_capacity: int) -> GraphArrays:
    """The store with room for ``new_capacity`` rows (the analog of
    relation extension); new rows are empty."""
    pad = new_capacity - arrays.capacity
    if pad <= 0:
        return arrays

    def pad_rows(x: torch.Tensor, fill) -> torch.Tensor:
        return torch.cat([x, x.new_full((pad, *x.shape[1:]), fill)])

    return arrays._replace(
        vectors=pad_rows(arrays.vectors, 0),
        codes=pad_rows(arrays.codes, 0),
        adjacency=pad_rows(arrays.adjacency, INVALID_ID),
        deleted=pad_rows(arrays.deleted, False),
    )


def dequant_rows(vectors: torch.Tensor, idx) -> torch.Tensor:
    """Row gather in compute form (f32 tier: the rows themselves)."""
    return vectors[idx]


class HostArrays(NamedTuple):
    """Host (numpy) copy of the store, in the JAX package's field order."""

    vectors: np.ndarray
    codes: np.ndarray  # uint32
    adjacency: np.ndarray
    node_labels: np.ndarray
    deleted: np.ndarray
    count: np.ndarray
    default_start: np.ndarray
    label_start_keys: np.ndarray
    label_start_ids: np.ndarray
    vec_scales: np.ndarray


def to_host(arrays: GraphArrays) -> HostArrays:
    cap = arrays.capacity
    return HostArrays(
        vectors=arrays.vectors.cpu().numpy(),
        codes=arrays.codes.cpu().numpy().view(np.uint32),
        adjacency=arrays.adjacency.cpu().numpy(),
        node_labels=np.zeros((cap, 0), np.int32),
        deleted=arrays.deleted.cpu().numpy(),
        count=np.asarray(arrays.count, np.int32),
        default_start=np.asarray(arrays.default_start, np.int32),
        label_start_keys=np.full((LABEL_TABLE_CAPACITY,), LABEL_SENTINEL, np.int32),
        label_start_ids=np.full((LABEL_TABLE_CAPACITY,), INVALID_ID, np.int32),
        vec_scales=np.ones((cap,), np.float32),
    )


def from_host(host, device) -> GraphArrays:
    """Device store from host arrays in the JAX package's layout (its
    ``store.to_host`` output).  Codes arrive as uint32 and are carried as
    their int32 bit view."""
    if np.asarray(host.node_labels).shape[-1] != 0:
        raise NotImplementedError("labeled indexes are not ported yet")
    vectors = np.asarray(host.vectors)
    if vectors.dtype != np.float32:
        raise NotImplementedError("only the f32 vector tier is ported")
    codes = np.ascontiguousarray(np.asarray(host.codes, dtype=np.uint32))

    def dev(x, dtype):
        return torch.from_numpy(np.array(x, copy=True, order="C")).to(device, dtype)

    return GraphArrays(
        vectors=dev(vectors, torch.float32),
        codes=dev(codes.view(np.int32), torch.int32),
        adjacency=dev(np.asarray(host.adjacency, np.int32), torch.int32),
        deleted=dev(np.asarray(host.deleted, bool), torch.bool),
        count=int(host.count),
        default_start=int(host.default_start),
    )
