"""Flat tensor graph store (PyTorch port of ``pgvectorscale_tpu/store.py``).

Every index component is a flat, preallocated structure-of-arrays tensor
on one device:

- ``vectors``     f32, bf16 or int8[cap, D]  full-precision vectors (the
                                     rescore tier); ``IndexConfig.vector_dtype``
                                     "bf16" halves them, "int8" quarters
                                     them (per-row symmetric scale)
- ``vec_scales``  f32[cap]      the int8 tier's per-row dequantization
                                scale (ones on every other tier)
- ``codes``       i32[cap, W]   packed SBQ codes; each word is the int32 bit
                                view of the JAX package's uint32 word
- ``adjacency``   i32[cap, R]   neighbor ids, ``-1`` padded
- ``deleted``     bool[cap]     tombstones
- ``node_labels`` i32[cap, Lm]  per-node label sets, LABEL_SENTINEL padded
                                (Lm == 0 when unlabeled)
- ``label_start_keys`` / ``label_start_ids`` i32[label_cap]: the per-label
  start nodes (graph/start_nodes.rs), LABEL_SENTINEL / INVALID_ID padded

``count`` and ``default_start`` are host integers: the port runs eagerly,
so keeping them on the host saves a device read per use.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import IndexConfig
from .labels import LABEL_SENTINEL

INVALID_ID = -1
DEFAULT_LABEL_TABLE_CAPACITY = 1024
_INV_127 = float(np.float32(1.0) / np.float32(127.0))  # exact in float32


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
    vec_scales: torch.Tensor  # f32[cap]: the int8 tier's row scales, else ones

    @property
    def capacity(self) -> int:
        return self.adjacency.shape[0]

    @property
    def max_degree(self) -> int:
        return self.adjacency.shape[1]

    @property
    def device(self) -> torch.device:
        return self.adjacency.device


VECTOR_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def vector_dtype(name: str) -> torch.dtype:
    """The storage dtype of a vector tier."""
    if name not in VECTOR_DTYPES:
        raise ValueError(f"vector_dtype must be one of {sorted(VECTOR_DTYPES)}, not {name}")
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
        vec_scales=torch.ones((capacity,), dtype=torch.float32, device=device),
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
        vec_scales=pad_rows(arrays.vec_scales, 1.0),
    )


def quantize_rows(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization (the int8 tier): scale =
    maxabs/127 (1.0 for an all-zero row, so it dequantizes exactly),
    value = round-half-even(x / scale) clipped to [-127, 127].  Returns
    (int8[N, D], f32[N]).  The JAX package quantizes under ``jit``, where
    XLA turns the division by the constant 127 into a product with its
    float32 reciprocal; the port takes the same product, so the scales
    are bit-equal to a JAX index's.  ``x / scale`` is a true division in
    both."""
    rows = rows.to(torch.float32)
    maxabs = torch.amax(torch.abs(rows), dim=-1)
    scale = torch.where(maxabs > 0, maxabs * _INV_127, torch.ones_like(maxabs))
    q = torch.clamp(torch.round(rows / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequant_rows(vectors: torch.Tensor, scales: torch.Tensor, idx) -> torch.Tensor:
    """Row gather in compute form: float32 rows times their scale for the
    int8 tier; the storage dtype (f32 or bf16) otherwise, which callers
    convert to float32 where the JAX package does.  ``idx`` is any
    leading-axis index (tensor, slice) valid for both tensors."""
    rows = vectors[idx]
    if vectors.dtype == torch.int8:
        return rows.to(torch.float32) * scales[idx][..., None]
    return rows


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
    bfloat16); int8 vectors as int8."""

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
    """f32 and int8 rows as they are; bf16 rows as their uint16 bit view."""
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
    if dtype == torch.int8:
        if vectors.dtype != np.int8:
            raise ValueError(f"int8 vectors must be int8, not {vectors.dtype}")
        return torch.from_numpy(vectors.copy())
    if vectors.dtype != np.float32:
        raise ValueError(f"f32 vectors must be float32, not {vectors.dtype}")
    return torch.from_numpy(vectors.copy())


def to_host(arrays: GraphArrays) -> HostArrays:
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
        vec_scales=arrays.vec_scales.cpu().numpy(),
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
        vec_scales=dev(np.asarray(host.vec_scales, np.float32), torch.float32),
    )
