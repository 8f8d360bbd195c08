"""Index model families (the port's ``models``).

The framework's "models" are its index types:

- ``DiskannIndex``         the single-device index (SBQ or plain storage)
- ``ShardedDiskannIndex``  the row-sharded index over a device mesh
- ``SearchIterator``       the streaming relaxed-order query surface

``create_index`` picks the family from the mesh.
"""

from ..index import DiskannIndex, SearchIterator
from ..parallel.sharded import ShardedDiskannIndex


def create_index(vectors, config, *, mesh=None, labels=None, **kw):
    """Build the right index family: sharded over ``mesh`` when it has
    more than one position, else one device's index (on the mesh's one
    device unless ``device`` is given)."""
    if mesh is not None and mesh.devices.size > 1:
        return ShardedDiskannIndex.build(vectors, config, mesh, labels=labels, **kw)
    if mesh is not None:
        kw.setdefault("device", mesh.devices.ravel()[0])
    return DiskannIndex.build(vectors, config, labels=labels, **kw)


__all__ = [
    "DiskannIndex",
    "SearchIterator",
    "ShardedDiskannIndex",
    "create_index",
]
