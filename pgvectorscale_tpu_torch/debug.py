"""Graph debugging helpers (the port's copy of the JAX package's
``debug.py``).

Analog of the reference's debug utilities (reference:
pgvectorscale/src/access_method/graph/debugging.rs:12-50 and
``debug_count_reachable_nodes`` / ``debug_print_graph``,
graph/mod.rs:537-567).  Each reads the index's adjacency to the host once
and works there through the native runtime.
"""

from __future__ import annotations

import numpy as np

from . import native
from .store import INVALID_ID


def _host_adjacency(index) -> np.ndarray:
    """int32[count, R] adjacency of ``index`` on the host."""
    return np.ascontiguousarray(
        index.arrays.adjacency[: index.count].cpu().numpy(), dtype=np.int32)


def count_reachable_nodes(index) -> int:
    """Nodes reachable from the default start (the reference's
    connectivity gate)."""
    if index.count == 0:
        return 0
    return int(native.bfs_reachable(_host_adjacency(index),
                                    int(index.arrays.default_start)).sum())


def degree_histogram(index) -> dict:
    if index.count == 0:
        return {"out_min": 0, "out_mean": 0.0, "out_max": 0, "orphans": 0}
    adj = _host_adjacency(index)
    deg = native.degrees(adj)
    indeg = native.in_degrees(adj)
    return {
        "out_min": int(deg.min()),
        "out_mean": float(deg.mean()),
        "out_max": int(deg.max()),
        "in_min": int(indeg.min()),
        "in_mean": float(indeg.mean()),
        "in_max": int(indeg.max()),
        "orphans": int((indeg == 0).sum()),
    }


def to_graphviz(index, max_nodes: int = 200) -> str:
    """DOT dump of the first ``max_nodes`` rows (debug_print_graph
    analog, graph/debugging.rs)."""
    n = min(index.count, max_nodes)
    adj = index.arrays.adjacency[:n].cpu().numpy()
    deleted = index.arrays.deleted[:n].cpu().numpy()
    start = int(index.arrays.default_start)
    lines = ["digraph diskann {"]
    for i in range(n):
        attrs = [f'label="{i}"']
        if i == start:
            attrs.append("shape=doublecircle")
        if deleted[i]:
            attrs.append("style=dashed")
        lines.append(f"  n{i} [{', '.join(attrs)}];")
        for v in adj[i]:
            if v != INVALID_ID and v < n:
                lines.append(f"  n{i} -> n{int(v)};")
    lines.append("}")
    return "\n".join(lines)
