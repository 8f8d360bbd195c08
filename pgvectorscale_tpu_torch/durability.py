"""Checkpoint file helpers (the port's copy of the JAX package's
``durability.py`` helpers that ``save`` and ``load`` use).

The mutation journal and its replay are not ported yet.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np


def normalize_ckpt_path(path: str) -> str:
    """np.savez historically appended .npz to suffix-less paths; the atomic
    writer writes the exact path, so normalize once at every entry point."""
    path = os.fspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def atomic_write_npz(target: str, payload: dict) -> None:
    """Write ``payload`` as a compressed npz: a temporary file in the same
    directory, fsync, rename over ``target``, fsync the directory.  A crash
    mid-write leaves the previous file in place."""
    d = os.path.dirname(os.path.abspath(target)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, target)
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
