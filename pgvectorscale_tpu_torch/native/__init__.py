"""Native host graph runtime (C++ via ctypes; the port's copy of the JAX
package's ``native/``).

``host_graph.cc`` is compiled at first use by ``g++ -O3 -shared -fPIC
-std=c++17`` into ``native/_build/`` (listed in ``.gitignore``), named by a
hash of the source and the flags, written to a temporary file and renamed
into place, so concurrent processes never load a partial library.  Every
entry point but ``repair_orphans_inplace`` has a NumPy path for hosts
without a toolchain (``graph/build.py`` keeps the NumPy repair).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "host_graph.cc"
BUILD_DIR = _HERE / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _build_library() -> Optional[Path]:
    """The library for the current source and flags, compiled if missing;
    None when there is no working ``g++``."""
    digest = hashlib.sha256(_SRC.read_bytes() + "\0".join(CXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libpgvs_host_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
    except (subprocess.SubprocessError, OSError):
        return None
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        path = _build_library()
        try:
            lib = ctypes.CDLL(str(path)) if path is not None else None
        except OSError:
            lib = None
        if lib is None:
            _lib_failed = True
            return None
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.pgvs_bfs_reachable.argtypes = [
            i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, u8p,
        ]
        lib.pgvs_bfs_reachable.restype = None
        lib.pgvs_repair_orphans.argtypes = [
            i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ]
        lib.pgvs_repair_orphans.restype = ctypes.c_int64
        lib.pgvs_degrees.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64, i32p]
        lib.pgvs_degrees.restype = None
        lib.pgvs_in_degrees.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64, i32p]
        lib.pgvs_in_degrees.restype = None
        lib.pgvs_to_csr.argtypes = [
            i32p, ctypes.c_int64, ctypes.c_int64, i64p,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.pgvs_to_csr.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def bfs_reachable(adj: np.ndarray, start: int) -> np.ndarray:
    """bool[n] reachability from ``start`` over int32[n, r] adjacency;
    neighbour ids outside [0, n) are skipped."""
    adj = np.ascontiguousarray(adj, dtype=np.int32)
    n, r = adj.shape
    lib = _load()
    if lib is not None:
        seen = np.zeros(n, dtype=np.uint8)
        lib.pgvs_bfs_reachable(adj, n, r, np.int32(start), seen)
        return seen.astype(bool)
    seen = np.zeros(n, dtype=bool)  # NumPy path: frontier BFS
    if start < 0 or start >= n:
        return seen
    seen[start] = True
    frontier = np.asarray([start])
    while frontier.size:
        nbrs = adj[frontier].reshape(-1)
        nbrs = nbrs[(nbrs >= 0) & (nbrs < n)]
        new = np.unique(nbrs[~seen[nbrs]])
        if new.size == 0:
            break
        seen[new] = True
        frontier = new
    return seen


def repair_orphans_inplace(adj: np.ndarray, start: int) -> int:
    """Force-connect unreachable nodes; mutates ``adj``.  Returns the number
    of forced edges.  Needs the native library (``graph/build.py`` falls
    back to its NumPy repair without it)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    # The mutation must land in the caller's buffer: ascontiguousarray
    # would copy (and drop the repairs) for other input, so refuse it.
    if adj.dtype != np.int32 or not adj.flags.c_contiguous:
        raise TypeError("repair_orphans_inplace requires a C-contiguous int32 array")
    n, r = adj.shape
    return int(lib.pgvs_repair_orphans(adj, n, r, np.int32(start)))


def degrees(adj: np.ndarray) -> np.ndarray:
    adj = np.ascontiguousarray(adj, dtype=np.int32)
    n, r = adj.shape
    lib = _load()
    if lib is not None:
        out = np.zeros(n, dtype=np.int32)
        lib.pgvs_degrees(adj, n, r, out)
        return out
    return (adj != -1).sum(axis=1).astype(np.int32)


def in_degrees(adj: np.ndarray) -> np.ndarray:
    adj = np.ascontiguousarray(adj, dtype=np.int32)
    n, r = adj.shape
    lib = _load()
    if lib is not None:
        out = np.zeros(n, dtype=np.int32)
        lib.pgvs_in_degrees(adj, n, r, out)
        return out
    valid = adj[(adj >= 0) & (adj < n)]
    return np.bincount(valid, minlength=n).astype(np.int32)


def to_csr(adj: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Padded adjacency -> (indptr int64[n+1], indices int32[e])."""
    adj = np.ascontiguousarray(adj, dtype=np.int32)
    n, r = adj.shape
    lib = _load()
    if lib is not None:
        indptr = np.zeros(n + 1, dtype=np.int64)
        e = lib.pgvs_to_csr(adj, n, r, indptr, None)
        indices = np.zeros(max(int(e), 1), dtype=np.int32)
        lib.pgvs_to_csr(adj, n, r, indptr,
                        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return indptr, indices[: int(e)]
    mask = adj != -1
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(mask.sum(axis=1), out=indptr[1:])
    return indptr, adj[mask].astype(np.int32)
