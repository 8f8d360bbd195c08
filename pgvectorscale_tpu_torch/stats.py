"""Search and build statistics (the port's copy of the JAX package's
``stats.py``).

Analog of the reference's stats traits (reference:
pgvectorscale/src/access_method/stats.rs: ``StatsDistanceComparison``,
``StatsNodeRead``, ``StatsNodeVisit`` and the aggregates
``GreedySearchStats`` and ``WriteStats``, dumped at query end by
amendscan, scan.rs:439-476).  The counters are device tensors carried
through the search (``SearchResult.n_visited`` / ``n_dist_comps``) and
summarized on the host here, only when asked for.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time


@dataclasses.dataclass
class GreedySearchStats:
    """Per-batch search statistics (GreedySearchStats analog)."""

    num_queries: int = 0
    total_visits: int = 0
    total_distance_comparisons: int = 0
    iterations: int = 0

    @classmethod
    def from_search_result(cls, result) -> "GreedySearchStats":
        """From a ``graph.search.SearchResult`` (two device reads)."""
        return cls(
            num_queries=int(result.n_visited.shape[0]),
            total_visits=int(result.n_visited.sum()),
            total_distance_comparisons=int(result.n_dist_comps.sum()),
            iterations=int(result.iters),
        )

    def merge(self, other: "GreedySearchStats") -> "GreedySearchStats":
        return GreedySearchStats(
            num_queries=self.num_queries + other.num_queries,
            total_visits=self.total_visits + other.total_visits,
            total_distance_comparisons=(
                self.total_distance_comparisons + other.total_distance_comparisons
            ),
            iterations=max(self.iterations, other.iterations),
        )


@contextlib.contextmanager
def profiler_trace(logdir):
    """Profile a build or search region with ``torch.profiler`` (host
    activity, and the card's kernels and copies when a CUDA device is
    present) and write a Chrome trace into ``logdir``:

        with profiler_trace("/tmp/trace") as prof:
            index.search(queries, 10)

    Yields the profiler (``prof.key_averages()`` sums device time by
    kernel).  Also ``--profile-dir`` on the CLI's build and search."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(logdir, f"pgvs_trace_{os.getpid()}_{time.time_ns()}.json"))


@dataclasses.dataclass
class WriteStats:
    """Build timing and throughput (WriteStats analog, stats.rs:242-265).

    - ``num_waves``: wave steps (insert and refinement waves, and the
      waves of later adds); each wave batch-prunes every inserted node's
      candidate set.
    - ``num_prunes``: over-degree rows re-pruned in ``finalize`` (the
      finalize_index_build analog, build.rs:905-960).  In-wave overflow
      prunes are not counted.
    - ``insert_s`` / ``finalize_s``: wall-clock of the two phases.
    """

    started: float = dataclasses.field(default_factory=time.perf_counter)
    num_nodes: int = 0
    num_waves: int = 0
    num_prunes: int = 0
    insert_s: float = 0.0
    finalize_s: float = 0.0

    @property
    def elapsed_s(self) -> float:
        return time.perf_counter() - self.started

    @property
    def nodes_per_sec(self) -> float:
        e = self.elapsed_s
        return self.num_nodes / e if e > 0 else 0.0
