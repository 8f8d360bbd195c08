"""Multi-process execution on ``torch.distributed`` (PyTorch port of
``parallel/multihost.py``).

The JAX package joins a multi-host world with ``jax.distributed`` and
lets XLA route the collectives.  The port joins one with
``torch.distributed.init_process_group`` over TCP, from the same
environment variables, and names the collective itself: a
``ShardedDiskannIndex`` on a ``global_mesh`` builds and searches only the
shards at its own process's positions, and a search exchanges each
shard's top-k ids and distances with one ``all_gather`` (the only data
that crosses processes).  Every process runs the same program on the same
inputs (the JAX package's SPMD contract) and gets the same results.

Run one process a card on each host (each seeing its card as ``cuda:0``
through ``CUDA_VISIBLE_DEVICES``, or all cards of a host in one process):

    PGVS_TPU_COORDINATOR=10.0.0.1:8476 \\
    PGVS_TPU_PROCESS_ID=0 PGVS_TPU_NUM_PROCESSES=4 \\
    python your_serving_script.py

    # inside the script
    from pgvectorscale_tpu_torch.parallel import multihost
    multihost.initialize_from_env()      # init_process_group, nccl
    mesh = multihost.global_mesh()       # every process's positions
    index = ShardedDiskannIndex.build(vectors, config, mesh)

On the CPU pass ``device="cpu"`` to both (the ``gloo`` backend).  At world
size 1 ``initialize_from_env`` does nothing and ``global_mesh`` is this
process's mesh.  Every process must own the same number of positions.
``add``, ``delete``, ``save`` and ``load`` of an index that spans
processes raise ``NotImplementedError``: they need every shard's rows in
one process, which the JAX package cannot give either.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..index import resolve_device
from .mesh import Mesh

_INITIALIZED = False

COORDINATOR_ENV = "PGVS_TPU_COORDINATOR"
PROCESS_ID_ENV = "PGVS_TPU_PROCESS_ID"
NUM_PROCESSES_ENV = "PGVS_TPU_NUM_PROCESSES"


def initialize_from_env(device=None) -> bool:
    """Join the multi-process world that the PGVS_TPU_* variables describe
    (coordinator ``host:port``, this process's id, the world size) with
    ``torch.distributed.init_process_group`` over ``tcp://``: the
    ``nccl`` backend when ``device`` is the card (the default; it raises
    without one), ``gloo`` on the CPU.  Returns True when a world of more
    than one process was joined, False when the variables say one
    process.  Idempotent; a failure to join raises."""
    global _INITIALIZED
    coordinator = os.environ.get(COORDINATOR_ENV)
    num = int(os.environ.get(NUM_PROCESSES_ENV, "1"))
    if coordinator is None or num <= 1:
        return False
    if _INITIALIZED:
        return True
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None else 0)
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}",
        world_size=num,
        rank=int(os.environ.get(PROCESS_ID_ENV, "0")),
    )
    _INITIALIZED = True
    return True


def world() -> tuple[int, int]:
    """(process id, number of processes): (0, 1) outside a world."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_devices(dev: torch.device) -> list[torch.device]:
    if dev.type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def global_mesh(axis_name: str = "n", n_devices: Optional[int] = None, device=None) -> Mesh:
    """One-axis mesh over every position of every process, in process
    order, so shard p's work stays in the process that owns it.  Each
    process contributes its devices (the CPU: one position; the card:
    every card it sees).  At world size 1 it is this process's mesh, with
    ``n_devices`` positions when given (on the CPU, all of them the CPU;
    on the card, ``cuda:{p % device_count}``)."""
    dev = resolve_device(device)
    local = _local_devices(dev)
    rank, size = world()
    if size == 1:
        n = len(local) if n_devices is None else n_devices
        devices = [local[p % len(local)] for p in range(n)]
        ranks = [0] * n
    else:
        devices = [d for _ in range(size) for d in local]
        ranks = [r for r in range(size) for _ in local]
        if n_devices is not None:
            devices, ranks = devices[:n_devices], ranks[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one position")
    return Mesh(devices, (axis_name,), ranks)


def hybrid_mesh(ici_axis: str = "q", dcn_axis: str = "host", device=None) -> Mesh:
    """Two-axis mesh [processes, positions of a process]: processes on the
    slow axis, each process's devices on the fast one.  A [1, local] mesh
    at world size 1."""
    dev = resolve_device(device)
    local = _local_devices(dev)
    _, size = world()
    devices = np.empty((size, len(local)), dtype=object)
    for r in range(size):
        devices[r, :] = local
    ranks = np.repeat(np.arange(size)[:, None], len(local), axis=1)
    return Mesh(devices, (dcn_axis, ici_axis), ranks)
