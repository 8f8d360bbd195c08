"""Command-line interface of the port (the JAX package's ``cli.py``, with
the same commands, arguments and JSON lines).

The operational surface: the analog of the reference's SQL DDL/DML
(``CREATE INDEX ... USING diskann``, ``SET diskann.*``,
``SELECT ... ORDER BY <=>``; reference: pgvectorscale README usage).

Commands:
  build   build an index from a .fvecs/.bvecs/.npy vector file
  search  query a saved index with vectors from a file
  add     insert vectors into a saved index (aminsert analog)
  delete  tombstone rows by external id (DELETE analog)
  compact rebuild without tombstoned rows (VACUUM FULL analog)
  info    print index metadata and graph statistics
  bench   recall/QPS sweep against brute-force ground truth

Every command takes ``--device`` (default ``cuda``; ``--device cpu`` runs
on the CPU).  Usage: python -m pgvectorscale_tpu_torch.cli <command> [options]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np


def _load_vectors(path: str, max_rows=None) -> np.ndarray:
    if path.endswith(".npy"):
        v = np.load(path)
        return v[:max_rows] if max_rows else v
    if path.endswith(".fvecs"):
        from .io.datasets import read_fvecs

        return read_fvecs(path, max_rows)
    if path.endswith(".bvecs"):
        from .io.datasets import read_bvecs

        return read_bvecs(path, max_rows)
    raise SystemExit(f"unsupported vector file: {path}")


def _maybe_profile(logdir):
    """A torch.profiler trace of the region into ``logdir``, if given."""
    if not logdir:
        return contextlib.nullcontext()
    from .stats import profiler_trace

    return profiler_trace(logdir)


def cmd_build(args) -> int:
    from . import DiskannIndex, DistanceType, IndexConfig, StorageLayout

    vectors = _load_vectors(args.vectors, args.max_rows)
    config = IndexConfig(
        num_dimensions=vectors.shape[1],
        distance_type=DistanceType[args.distance.upper()],
        storage_layout=StorageLayout.from_string(args.storage),
        num_neighbors=args.num_neighbors,
        search_list_size=args.search_list_size,
        max_alpha=args.max_alpha,
        num_dimensions_to_index=args.num_dimensions,
        num_bits_per_dimension=args.num_bits,
        vector_dtype=args.vector_dtype,
    )
    t0 = time.perf_counter()
    with _maybe_profile(args.profile_dir):
        index = DiskannIndex.build(
            vectors, config, refine_passes=args.refine_passes, device=args.device
        )
    dt = time.perf_counter() - t0
    index.save(args.output)
    print(json.dumps({
        "built": len(vectors),
        "seconds": round(dt, 2),
        "vectors_per_sec": round(len(vectors) / dt, 1),
        "output": args.output,
    }))
    return 0


def cmd_search(args) -> int:
    from . import DiskannIndex, QueryParams

    index = DiskannIndex.load(args.index, device=args.device)
    queries = _load_vectors(args.queries, args.max_rows)
    params = QueryParams(
        search_list_size=args.search_list_size,
        rescore=args.rescore,
        expand=args.expand,
        window_strategy=args.window_strategy,
    )
    t0 = time.perf_counter()
    with _maybe_profile(args.profile_dir):
        ids, dists = index.search(queries, k=args.k, params=params, device=args.device)
        ids, dists = ids.cpu().numpy(), dists.cpu().numpy()
    dt = time.perf_counter() - t0
    ext = index.to_external(ids)
    for row in range(min(len(queries), args.show)):
        print(json.dumps({
            "query": row,
            "ids": ext[row].tolist(),
            "distances": [round(float(d), 6) for d in dists[row]],
        }))
    print(json.dumps({
        "queries": len(queries),
        "seconds": round(dt, 3),
        "qps": round(len(queries) / dt, 1),
    }), file=sys.stderr)
    return 0


def cmd_add(args) -> int:
    """Insert vectors into a saved index (aminsert analog; tombstoned
    rows are recycled in place before the store grows)."""
    from . import DiskannIndex

    index = DiskannIndex.load(args.index, device=args.device)
    vectors = _load_vectors(args.vectors, args.max_rows)
    t0 = time.perf_counter()
    new_ids = index.add(vectors)
    dt = time.perf_counter() - t0
    index.save(args.output or args.index)
    print(json.dumps({
        "added": len(vectors),
        "seconds": round(dt, 2),
        "rows_per_sec": round(len(vectors) / dt, 1),
        "count": index.count,
        "live": index.num_live,
        "external_ids": [int(e) for e in index.external_ids[new_ids[:5]]],
    }))
    return 0


def cmd_delete(args) -> int:
    """Tombstone rows by external id (the DELETE + vacuum-tombstone
    analog; space is reclaimed by later adds or by compact)."""
    from . import DiskannIndex

    index = DiskannIndex.load(args.index, device=args.device)
    ext = np.asarray([int(x) for x in args.ids], dtype=np.int64)
    index.delete_external(ext)
    index.save(args.output or args.index)
    print(json.dumps({
        "deleted": len(ext),
        "count": index.count,
        "live": index.num_live,
        "tombstoned": index.num_deleted,
    }))
    return 0


def cmd_compact(args) -> int:
    """Rebuild without tombstoned rows (VACUUM FULL analog)."""
    from . import DiskannIndex

    index = DiskannIndex.load(args.index, device=args.device)
    before = index.count
    t0 = time.perf_counter()
    compacted = index.compact()
    dt = time.perf_counter() - t0
    compacted.save(args.output or args.index)
    print(json.dumps({
        "before": before,
        "after": compacted.count,
        "reclaimed": before - compacted.count,
        "seconds": round(dt, 2),
    }))
    return 0


def cmd_info(args) -> int:
    from . import DiskannIndex
    from .debug import count_reachable_nodes, degree_histogram

    index = DiskannIndex.load(args.index, device=args.device)
    print(json.dumps({
        "count": index.count,
        "live": index.num_live,
        "deleted": index.num_deleted,
        "config": index.config.to_dict(),
        "reachable": count_reachable_nodes(index),
        "degrees": degree_histogram(index),
    }, indent=2))
    return 0


def cmd_bench(args) -> int:
    import torch

    from . import DiskannIndex, DistanceType, IndexConfig, QueryParams
    from .distance import preprocess_query
    from .index import resolve_device
    from .io.datasets import synthetic_corpus
    from .ops.bruteforce import brute_force_search

    dev = resolve_device(args.device)
    vectors, queries = synthetic_corpus(args.corpus, args.n, args.q)
    dist = DistanceType[args.distance.upper()]
    config = IndexConfig(num_dimensions=vectors.shape[1], distance_type=dist)
    t0 = time.perf_counter()
    index = DiskannIndex.build(vectors, config, device=dev)
    build_s = time.perf_counter() - t0

    dv = preprocess_query(torch.from_numpy(np.ascontiguousarray(vectors)).to(dev), dist)
    dq = preprocess_query(torch.from_numpy(np.ascontiguousarray(queries)).to(dev), dist)
    gt, _ = brute_force_search(
        dq, dv, torch.ones(len(vectors), dtype=torch.bool, device=dev),
        k=args.k, distance_type=dist,
    )
    gt = gt.cpu().numpy()
    del dv, dq

    for l in args.search_list_sizes:
        params = QueryParams(search_list_size=l, rescore=args.rescore)
        index.search(queries, k=args.k, params=params, device=dev)  # warm-up
        t0 = time.perf_counter()
        ids, _ = index.search(queries, k=args.k, params=params, device=dev)
        ids = ids.cpu().numpy()
        dt = time.perf_counter() - t0
        hits = sum(
            len(set(gt[r]) & set(int(i) for i in ids[r] if i >= 0))
            for r in range(len(queries))
        )
        print(json.dumps({
            "L": l,
            "recall": round(hits / (len(queries) * args.k), 4),
            "qps": round(len(queries) / dt, 1),
            "build_s": round(build_s, 2),
        }))
    return 0


def main(argv=None) -> int:
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default="cuda",
                     help="torch device to run on (default: cuda; cpu for the CPU)")
    p = argparse.ArgumentParser(prog="pgvectorscale_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", parents=[dev], help="build an index")
    b.add_argument("vectors")
    b.add_argument("-o", "--output", required=True)
    b.add_argument("--distance", default="cosine",
                   choices=["cosine", "l2", "inner_product"])
    b.add_argument("--storage", default="memory_optimized")
    b.add_argument("--num-neighbors", type=int, default=50)
    b.add_argument("--search-list-size", type=int, default=100)
    b.add_argument("--max-alpha", type=float, default=1.2)
    b.add_argument("--num-dimensions", type=int, default=0)
    b.add_argument("--num-bits", type=int, default=0)
    b.add_argument("--max-rows", type=int, default=None)
    b.add_argument("--refine-passes", type=int, default=0,
                   help="extra graph-refinement sweeps (quality vs time)")
    b.add_argument("--vector-dtype", default="f32",
                   choices=["f32", "bf16", "int8"],
                   help="stored-vector tier dtype (bf16 halves device memory; "
                        "int8 quarters it with a per-row scale, SBQ only)")
    b.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the build here")
    b.set_defaults(fn=cmd_build)

    s = sub.add_parser("search", parents=[dev], help="query a saved index")
    s.add_argument("index")
    s.add_argument("queries")
    s.add_argument("-k", type=int, default=10)
    s.add_argument("--search-list-size", type=int, default=100)
    s.add_argument("--rescore", type=int, default=50)
    s.add_argument("--expand", type=int, default=4,
                   help="multi-frontier width E")
    s.add_argument("--window-strategy", choices=("expand", "beam", "scored"),
                   default="expand",
                   help="how a rescore window larger than L is served: "
                        "'expand' caps the beam at ~2L + 1-hop window "
                        "expansion (fast); 'beam' widens the beam itself "
                        "(strongest recall); 'scored' keeps the beam at L "
                        "and buffers the best window-size scored "
                        "candidates (wide-beam recall, narrow-beam cost)")
    s.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the search here")
    s.add_argument("--show", type=int, default=10)
    s.add_argument("--max-rows", type=int, default=None)
    s.set_defaults(fn=cmd_search)

    a = sub.add_parser("add", parents=[dev], help="insert vectors into a saved index")
    a.add_argument("index")
    a.add_argument("vectors")
    a.add_argument("-o", "--output", default=None,
                   help="write here instead of overwriting the index")
    a.add_argument("--max-rows", type=int, default=None)
    a.set_defaults(fn=cmd_add)

    dl = sub.add_parser("delete", parents=[dev], help="tombstone rows by external id")
    dl.add_argument("index")
    dl.add_argument("ids", nargs="+", help="external ids to delete")
    dl.add_argument("-o", "--output", default=None)
    dl.set_defaults(fn=cmd_delete)

    c = sub.add_parser("compact", parents=[dev], help="rebuild without tombstoned rows")
    c.add_argument("index")
    c.add_argument("-o", "--output", default=None)
    c.set_defaults(fn=cmd_compact)

    i = sub.add_parser("info", parents=[dev], help="index metadata and graph stats")
    i.add_argument("index")
    i.set_defaults(fn=cmd_info)

    be = sub.add_parser("bench", parents=[dev],
                        help="recall/QPS sweep (synthetic corpus)")
    be.add_argument("--corpus", default="cohere",
                    choices=["sift", "glove", "cohere", "gauss"])
    be.add_argument("--n", type=int, default=100_000)
    be.add_argument("--q", type=int, default=1000)
    be.add_argument("-k", type=int, default=10)
    be.add_argument("--distance", default="cosine",
                    choices=["cosine", "l2", "inner_product"])
    be.add_argument("--rescore", type=int, default=50)
    be.add_argument("--search-list-sizes", type=int, nargs="+",
                    default=[50, 100, 200])
    be.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
