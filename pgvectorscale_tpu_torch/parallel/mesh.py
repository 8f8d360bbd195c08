"""Device meshes (PyTorch port of ``parallel/mesh.py``).

The JAX package lays the index tensors on a ``jax.sharding.Mesh`` and lets
XLA place the work.  The port's ``Mesh`` is a list of positions, each a
``torch.device`` owned by one process; work is placed by hand:

- **Query data-parallelism** (``sharded_search``): the queries are split
  over the positions, the index arrays are replicated (one copy a
  distinct device), and the per-position results are concatenated on the
  first position's device.  Each query's result is the single-device
  call's.
- **Build wave parallelism** (``sharded_build_step``): a wave's beam
  searches and prunes are split over the positions; the row writes, the
  backlinks and the overflow prune run once, on the first position, so
  the wave produces one adjacency.

Positions run one after another in the calling thread, each under its
device (``run_on_positions``).  When the beam loop was a Python loop
(about 150 small launches a beam iteration), four host threads, one a
card, built a 1M-row index 3.2x slower than one thread did on one card:
PyTorch releases and retakes the interpreter lock around every launch
(``PERF.md`` §6).  Cards work at once in a world of processes, one a
card (``multihost``).

``make_mesh`` places position p on ``cuda:{p % device_count}``: four
positions on a one-card machine are four shards on that card.  On the CPU
(``device="cpu"``) every position is the CPU, the port's counterpart of
the JAX tests' eight virtual CPU devices.  Without a card, a mesh on the
card raises.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from ..config import DistanceType, IndexConfig
from ..graph.build import _prune_kw, _wave_commit, _wave_neighbours, _wave_step
from ..graph.prune import alpha_schedule
from ..graph.search import SearchResult, beam_search
from ..index import resolve_device
from ..store import GraphArrays


class Mesh:
    """The positions of a device mesh: ``devices``, a numpy object array
    of ``torch.device`` in the mesh's shape (``.size``, ``.ravel()``);
    ``axis_names``, one a dimension; ``ranks``, an int array of the same
    shape naming the process that owns each position (all 0 in a
    one-process world)."""

    def __init__(self, devices, axis_names: Sequence[str], ranks=None):
        given = np.asarray(devices, dtype=object)
        self.devices = np.empty(given.shape, dtype=object)
        for i, d in enumerate(given.flat):
            self.devices.flat[i] = torch.device(d)
        shape = given.shape
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-dimensional mesh")
        self.ranks = (np.zeros(shape, dtype=np.int64) if ranks is None
                      else np.asarray(ranks, dtype=np.int64).reshape(shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def local_positions(self) -> list[int]:
        """Flat positions this process owns, ascending."""
        from .multihost import world

        rank, _ = world()
        return [int(p) for p in np.nonzero(self.ranks.ravel() == rank)[0]]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices={[str(d) for d in self.devices.ravel()]}, "
                f"ranks={self.ranks.ravel().tolist()})")


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "q", device=None) -> Mesh:
    """A one-axis mesh of ``n_devices`` positions in this process.

    On the card (``device`` None or a CUDA device) position p is
    ``cuda:{p % torch.cuda.device_count()}`` and the default is one
    position a card; without a card it raises.  On the CPU
    (``device="cpu"``) every position is the CPU and the default is one."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        n = 1 if n_devices is None else n_devices
        devices = [torch.device("cpu")] * max(n, 0)
    elif dev.type == "cuda":
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        devices = [torch.device("cuda", p % count) for p in range(max(n, 0))]
    else:
        raise ValueError(f"no mesh on device type {dev.type!r}")
    if n < 1:
        raise ValueError(f"a mesh needs at least one position, not {n}")
    return Mesh(devices, (axis_name,))


def run_on_positions(devices: Sequence[torch.device], fn: Callable[[int], object],
                     positions: Iterable[int]) -> dict:
    """``{p: fn(p)}`` for each position, in order, each with its device
    current (a card's: ``torch.cuda.device``)."""
    out = {}
    for p in positions:
        dev = torch.device(devices[p])
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            out[p] = fn(p)
    return out


def arrays_to(arrays: GraphArrays, device) -> GraphArrays:
    """``arrays`` with every tensor on ``device`` (the same tensors when
    they are there already)."""
    return arrays._replace(**{f: v.to(device) for f, v in zip(arrays._fields, arrays)
                              if isinstance(v, torch.Tensor)})


def replicate_arrays(arrays: GraphArrays, mesh: Mesh) -> list[GraphArrays]:
    """One replica of every index tensor a position: a copy a distinct
    device; positions on the arrays' own device share the arrays."""
    copies: dict = {}
    out = []
    for dev in mesh.devices.ravel():
        key = str(dev)
        if key not in copies:
            copies[key] = arrays_to(arrays, dev)
        out.append(copies[key])
    return out


def _split_rows(x: torch.Tensor, parts: int) -> list[torch.Tensor]:
    return list(torch.tensor_split(x, parts))


def sharded_search(
    mesh: Mesh,
    arrays: GraphArrays,
    query_vecs: torch.Tensor,  # f32[Q, Dt] (indexed prefix; read by full-precision traversal)
    query_codes: torch.Tensor,  # i32[Q, W]
    query_labels: torch.Tensor,  # i32[Q, Lq] (Lq == 0 when unfiltered)
    start_ids: torch.Tensor,  # i32[Q, S]
    *,
    search_list_size: int,
    max_iters: int,
    distance_type: DistanceType,
    use_codes: bool,
    filtered: bool,
) -> SearchResult:
    """Batched beam search with the queries split over the mesh's
    positions and the index arrays replicated.  Returns one
    ``SearchResult`` on the first position's device; each query's rows
    equal the single-device search's, and ``iters`` is the largest of
    the positions' (the whole batch's)."""
    positions = range(mesh.size)
    devices = list(mesh.devices.ravel())
    replicas = replicate_arrays(arrays, mesh)
    parts = [_split_rows(t, mesh.size) for t in (query_vecs, query_codes, query_labels,
                                                 start_ids)]

    def one(p):
        dev = devices[p]
        qv, qc, ql, st = (part[p].to(dev) for part in parts)
        if st.shape[0] == 0:
            return None
        return beam_search(
            replicas[p], qc, st,
            search_list_size=search_list_size, max_iters=max_iters,
            query_vecs=qv, use_codes=use_codes, distance_type=distance_type,
            query_labels=ql if filtered else None,
        )

    results = run_on_positions(devices, one, positions)
    done = [results[p] for p in positions if results[p] is not None]
    first = devices[0]
    fields = {f: torch.cat([getattr(r, f).to(first) for r in done])
              for f in SearchResult._fields if f != "iters"}
    return SearchResult(**fields, iters=max(r.iters for r in done))


def build_wave_step(
    arrays: GraphArrays,
    wave_ids: torch.Tensor,  # i32[B] already-stored rows to insert
    *,
    search_list_size: int,
    max_iters: int,
    distance_type: DistanceType,
    use_codes: bool,
    prune_use_codes: Optional[bool] = None,
    alphas: tuple,
    num_neighbors: int,
    r_max: int,
    code_bits: int,
    trunc_dims: int = 0,
) -> GraphArrays:
    """One searched build wave (search, prune, row writes, backlinks and
    the overflow prune) over the live adjacency: the unit that
    ``sharded_build_step`` splits over a mesh.  ``r_max`` is the
    adjacency's width, which ``arrays`` carries."""
    return _wave_step(arrays, wave_ids, 0, arrays.adjacency if use_codes else None,
                      **_wave_kw(arrays, search_list_size, max_iters, distance_type,
                                 use_codes, prune_use_codes, alphas, num_neighbors,
                                 code_bits, trunc_dims))


def _wave_kw(arrays, search_list_size, max_iters, distance_type, use_codes,
             prune_use_codes, alphas, num_neighbors, code_bits, trunc_dims) -> dict:
    return dict(
        search_list_size=search_list_size, max_iters=max_iters, brute=False, slice_rows=1,
        distance_type=distance_type, alphas=tuple(alphas), num_neighbors=num_neighbors,
        trunc_dims=trunc_dims if trunc_dims > 0 else arrays.vectors.shape[1],
        prune_use_codes=use_codes if prune_use_codes is None else prune_use_codes,
        code_bits=code_bits, use_codes=use_codes,
    )


def sharded_build_step(
    mesh: Mesh,
    arrays: GraphArrays,
    wave_ids: torch.Tensor,
    config: IndexConfig,
    *,
    max_iters: Optional[int] = None,
) -> GraphArrays:
    """One build wave with the wave's rows split over the mesh: each
    position searches and prunes its rows against its replica, then the
    first position writes the rows, the backlinks and the overflow prune
    for the whole wave.  Returns the arrays on the first position's
    device, equal to ``build_wave_step``'s."""
    l = config.search_list_size
    devices = list(mesh.devices.ravel())
    replicas = replicate_arrays(arrays, mesh)
    kw = _wave_kw(arrays, l, max_iters or (l + l // 2 + 16), config.distance_type,
                  config.build_traversal_uses_codes, config.build_prune_uses_codes,
                  alpha_schedule(config.max_alpha), config.num_neighbors,
                  config.dims_to_index * config.bits_per_dimension, config.dims_to_index)
    parts = _split_rows(wave_ids, mesh.size)

    def one(p):
        rep = replicas[p]
        ids = parts[p].to(devices[p])
        if ids.shape[0] == 0:
            return None
        return _wave_neighbours(rep, ids, 0, rep.adjacency if kw["use_codes"] else None, **kw)

    results = run_on_positions(devices, one, range(mesh.size))
    first = replicas[0]
    nbr_ids = torch.cat([results[p].to(first.device) for p in range(mesh.size)
                         if results[p] is not None])
    return _wave_commit(first, wave_ids.to(first.device), nbr_ids, **_prune_kw(kw))
