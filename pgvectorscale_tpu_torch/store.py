"""Flat tensor graph store (PyTorch port of ``pgvectorscale_tpu/store.py``).

Every index component is a flat, preallocated structure-of-arrays tensor
on one device:

- ``vectors``     f32 or bf16[cap, D]  full-precision vectors (the rescore
                                     tier); ``IndexConfig.vector_dtype``
                                     "bf16" halves them
- ``codes``       i32[cap, W]   packed SBQ codes; each word is the int32 bit
                                view of the JAX package's uint32 word
- ``adjacency``   i32[cap, R]   neighbor ids, ``-1`` padded
- ``deleted``     bool[cap]     tombstones
- ``node_labels`` i32[cap, Lm]  per-node label sets, LABEL_SENTINEL padded
                                (Lm == 0 when unlabeled)
- ``label_start_keys`` / ``label_start_ids`` i32[label_cap]: the per-label
  start nodes (graph/start_nodes.rs), LABEL_SENTINEL / INVALID_ID padded

``count`` and ``default_start`` are host integers: the port runs eagerly,
so keeping them on the host saves a device read per use.  The int8 vector
tier is not part of the port yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import IndexConfig
from .labels import LABEL_SENTINEL

INVALID_ID = -1
DEFAULT_LABEL_TABLE_CAPACITY = 1024


class GraphArrays(NamedTuple):
    vectors: torch.Tensor  # f32 or bf16[cap, D]
    codes: torch.Tensor  # i32[cap, W]  (W == 0 for plain storage)
    adjacency: torch.Tensor  # i32[cap, R_max]
    deleted: torch.Tensor  # bool[cap]
    count: int  # live slots
    default_start: int  # INVALID_ID while the graph is empty
    node_labels: torch.Tensor  # i32[cap, Lm]
    label_start_keys: torch.Tensor  # i32[label_cap]
    label_start_ids: torch.Tensor  # i32[label_cap]

    @property
    def capacity(self) -> int:
        return self.adjacency.shape[0]

    @property
    def max_degree(self) -> int:
        return self.adjacency.shape[1]

    @property
    def device(self) -> torch.device:
        return self.adjacency.device


VECTOR_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def vector_dtype(name: str) -> torch.dtype:
    """The storage dtype of a vector tier; the int8 tier is not ported."""
    if name not in VECTOR_DTYPES:
        raise NotImplementedError(f"the port stores f32 and bf16 vectors, not {name}")
    return VECTOR_DTYPES[name]


def empty_arrays(
    config: IndexConfig,
    capacity: int,
    device: torch.device,
) -> GraphArrays:
    d = config.num_dimensions
    w = config.num_code_words if config.uses_sbq else 0
    r = config.max_neighbors_during_build
    i32 = dict(dtype=torch.int32, device=device)
    return GraphArrays(
        vectors=torch.zeros(
            (capacity, d), dtype=vector_dtype(config.vector_dtype), device=device
        ),
        codes=torch.zeros((capacity, w), **i32),
        adjacency=torch.full((capacity, r), INVALID_ID, **i32),
        deleted=torch.zeros((capacity,), dtype=torch.bool, device=device),
        count=0,
        default_start=INVALID_ID,
        node_labels=torch.full(
            (capacity, config.max_labels_per_vector), LABEL_SENTINEL, **i32
        ),
        label_start_keys=torch.full((DEFAULT_LABEL_TABLE_CAPACITY,), LABEL_SENTINEL, **i32),
        label_start_ids=torch.full((DEFAULT_LABEL_TABLE_CAPACITY,), INVALID_ID, **i32),
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
        node_labels=pad_rows(arrays.node_labels, LABEL_SENTINEL),
    )


def dequant_rows(vectors: torch.Tensor, idx) -> torch.Tensor:
    """Row gather in compute form: the rows in their storage dtype (f32
    or bf16); callers convert to float32 where the JAX package does."""
    return vectors[idx]


def lookup_label_starts(arrays: GraphArrays, query_labels: torch.Tensor) -> torch.Tensor:
    """Per-label start nodes: i32[Q, Lq] labels -> i32[Q, Lq] node ids,
    INVALID_ID where the label has none (StartNodes::get_for_node,
    graph/start_nodes.rs:16-93).  At most one key matches; a max over the
    table picks it out."""
    eq = query_labels[:, :, None] == arrays.label_start_keys[None, None, :]
    ids = torch.where(eq, arrays.label_start_ids[None, None, :], INVALID_ID)
    return torch.amax(ids, dim=-1)


class HostArrays(NamedTuple):
    """Host (numpy) copy of the store, in the JAX package's field order.
    bf16 vectors are held as their uint16 bit view (numpy has no
    bfloat16)."""

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


def vectors_to_host(vectors: torch.Tensor) -> np.ndarray:
    """f32 rows as float32; bf16 rows as their uint16 bit view."""
    vectors = vectors.cpu()
    if vectors.dtype == torch.bfloat16:
        return vectors.view(torch.int16).numpy().view(np.uint16)
    return vectors.numpy()


def vectors_from_host(vectors, vector_dtype_name: str) -> torch.Tensor:
    """Host rows of the named tier -> a CPU tensor of its storage dtype.
    bf16 rows arrive as a 2-byte array (uint16 bit view, or the JAX
    package's ml_dtypes bfloat16) and are carried bit for bit, never
    through a float round trip."""
    dtype = vector_dtype(vector_dtype_name)
    vectors = np.ascontiguousarray(vectors)
    if dtype == torch.bfloat16:
        if vectors.dtype.itemsize != 2:
            raise ValueError(f"bf16 vectors must be 2-byte words, not {vectors.dtype}")
        return torch.from_numpy(vectors.view(np.int16).copy()).view(torch.bfloat16)
    if vectors.dtype != np.float32:
        raise ValueError(f"f32 vectors must be float32, not {vectors.dtype}")
    return torch.from_numpy(vectors.copy())


def to_host(arrays: GraphArrays) -> HostArrays:
    cap = arrays.capacity
    return HostArrays(
        vectors=vectors_to_host(arrays.vectors),
        codes=arrays.codes.cpu().numpy().view(np.uint32),
        adjacency=arrays.adjacency.cpu().numpy(),
        node_labels=arrays.node_labels.cpu().numpy(),
        deleted=arrays.deleted.cpu().numpy(),
        count=np.asarray(arrays.count, np.int32),
        default_start=np.asarray(arrays.default_start, np.int32),
        label_start_keys=arrays.label_start_keys.cpu().numpy(),
        label_start_ids=arrays.label_start_ids.cpu().numpy(),
        vec_scales=np.ones((cap,), np.float32),
    )


def from_host(host, device, vector_dtype_name: str = "f32") -> GraphArrays:
    """Device store from host arrays in the JAX package's layout (its
    ``store.to_host`` output, or the port's), of the tier named
    ``vector_dtype_name``.  Codes arrive as uint32 and are carried as
    their int32 bit view."""
    codes = np.ascontiguousarray(np.asarray(host.codes, dtype=np.uint32))

    def dev(x, dtype):
        return torch.from_numpy(np.array(x, copy=True, order="C")).to(device, dtype)

    return GraphArrays(
        vectors=vectors_from_host(np.asarray(host.vectors), vector_dtype_name).to(device),
        codes=dev(codes.view(np.int32), torch.int32),
        adjacency=dev(np.asarray(host.adjacency, np.int32), torch.int32),
        deleted=dev(np.asarray(host.deleted, bool), torch.bool),
        count=int(host.count),
        default_start=int(host.default_start),
        node_labels=dev(np.asarray(host.node_labels, np.int32), torch.int32),
        label_start_keys=dev(np.asarray(host.label_start_keys, np.int32), torch.int32),
        label_start_ids=dev(np.asarray(host.label_start_ids, np.int32), torch.int32),
    )
