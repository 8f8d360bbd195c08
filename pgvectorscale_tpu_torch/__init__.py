"""pgvectorscale_tpu_torch: the StreamingDiskANN index on PyTorch and CUDA.

A port of ``pgvectorscale_tpu`` (JAX) to PyTorch, with the TPU's Pallas
kernels rewritten by hand for NVIDIA Hopper.  It imports nothing of the
JAX package.  Entry points run on ``torch.device("cuda")`` unless the
caller names another device; ``ShardedDiskannIndex`` runs on the devices
of its mesh (``parallel.mesh.make_mesh``, ``parallel.multihost``).
"""

from .config import DistanceType, IndexConfig, QueryParams, StorageLayout
from .exact import ExactIndex
from .index import DiskannIndex, SearchIterator, from_jax_state
from .models import create_index
from .parallel.sharded import ShardedDiskannIndex

__all__ = [
    "DiskannIndex",
    "DistanceType",
    "ExactIndex",
    "IndexConfig",
    "QueryParams",
    "SearchIterator",
    "ShardedDiskannIndex",
    "StorageLayout",
    "create_index",
    "from_jax_state",
]
