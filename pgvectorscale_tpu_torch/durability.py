"""Crash-consistent durability: an append-only host-side mutation journal
(the port's copy of the JAX package's ``durability.py``).

The reference gets durability from Postgres: every page write goes
through GenericXLog, so committed inserts and deletes survive a crash
(reference: pgvectorscale/src/util/page.rs:113-124,236-245).  Here the
index lives in device memory and ``save()`` is the only full checkpoint,
which is far too slow to run per mutation.

So ``add()``/``delete()`` append their already-validated host inputs to an
append-only journal BEFORE touching device state (the write-ahead rule).
Recovery replays the journal on top of the last checkpoint through the
normal ``add``/``delete``; replay is deterministic (the same inputs give
the same index).

On-disk layout for a checkpoint at ``foo.npz``:

    foo.npz              the base checkpoint (save())
    foo.npz.journal/     one numbered .npz record per committed mutation
        000000001.npz    {magic, op: add, vectors, external_ids[, labels]}
        000000002.npz    {magic, op: delete, ids}

Records are byte-compatible with the JAX package's (the same magic, ``op``
bytes, key names and dtypes: ``vectors`` float32, ``external_ids`` int64,
``ids`` int32, ``labels`` the padded int32 label array), so a journal
written by either package replays in the other.  Each record is written
tmp + fsync + rename, so a crash mid-append loses at most the record being
written, never a committed one.  ``checkpoint()`` (or any ``save()`` to
the journal's base path) truncates the journal; ``auto_checkpoint_every``
bounds the replay length.
"""

from __future__ import annotations

import os
import tempfile
from typing import Iterator, Optional

import numpy as np

_RECORD_MAGIC = 0x50475653  # "PGVS"


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


class DurableIndexMixin:
    """``enable_durability`` / ``checkpoint`` / auto-checkpoint for
    ``DiskannIndex``.  The host class provides ``save(path)``, which must
    truncate the journal when it saves to the durability path, and calls
    ``_after_durable_mutation(rows)`` after each committed mutation."""

    _journal: Optional["MutationJournal"] = None
    _dur_path: Optional[str] = None
    _dur_every: Optional[int] = None
    _dur_pending: int = 0

    def enable_durability(
        self, path, auto_checkpoint_every: Optional[int] = None
    ) -> None:
        """Attach a crash-consistent mutation journal (the GenericXLog
        analog, page.rs:113-124).  Writes a base checkpoint to ``path``
        now; every later add/delete journals its validated host inputs
        BEFORE it mutates device state, so a process crash loses nothing
        committed: ``load(path)`` replays the journal on top of the
        checkpoint.  ``auto_checkpoint_every``: consolidate into a full
        checkpoint after this many journaled rows (bounds the replay;
        None: only an explicit save()/checkpoint() consolidates)."""
        path = normalize_ckpt_path(path)
        self._dur_path = path
        self._dur_every = auto_checkpoint_every
        self._journal = MutationJournal(path)
        self.checkpoint()

    def checkpoint(self) -> None:
        """Write a full checkpoint to the durability path and truncate the
        journal (replay restarts from here)."""
        if self._dur_path is None:
            raise ValueError("durability not enabled (enable_durability)")
        self.save(self._dur_path)

    def _after_durable_mutation(self, rows: int) -> None:
        if self._journal is None:
            return
        self._dur_pending += rows
        if self._dur_every is not None and self._dur_pending >= self._dur_every:
            self.checkpoint()


class MutationJournal:
    """Append-only DML journal attached to a checkpoint path."""

    def __init__(self, checkpoint_path: str):
        self.dir = checkpoint_path + ".journal"
        os.makedirs(self.dir, exist_ok=True)
        self._next = self._scan_next()

    def _scan_next(self) -> int:
        mx = 0
        for name in os.listdir(self.dir):
            if name.endswith(".npz"):
                try:
                    mx = max(mx, int(name[:-4]))
                except ValueError:
                    continue
        return mx + 1

    def _append(self, payload: dict) -> None:
        payload = dict(payload, magic=np.int64(_RECORD_MAGIC))
        target = os.path.join(self.dir, f"{self._next:09d}.npz")
        atomic_write_npz(target, payload)
        self._next += 1

    def append_add(
        self,
        vectors: np.ndarray,
        external_ids: np.ndarray,
        label_arr: Optional[np.ndarray] = None,
    ) -> None:
        payload = {
            "op": np.frombuffer(b"add", dtype=np.uint8),
            "vectors": np.asarray(vectors, np.float32),
            "external_ids": np.asarray(external_ids, np.int64),
        }
        if label_arr is not None:
            payload["labels"] = np.asarray(label_arr)
        self._append(payload)

    def append_delete(self, ids: np.ndarray) -> None:
        self._append({
            "op": np.frombuffer(b"delete", dtype=np.uint8),
            "ids": np.asarray(ids, np.int32),
        })

    def records(self) -> Iterator[dict]:
        """Committed records in append order.  A torn record cannot exist
        (appends are atomic renames); stray tmp files from a crash
        mid-append are ignored."""
        names = sorted(n for n in os.listdir(self.dir) if n.endswith(".npz"))
        for name in names:
            with np.load(os.path.join(self.dir, name)) as z:
                if int(z["magic"]) != _RECORD_MAGIC:
                    raise ValueError(f"corrupt journal record {name!r} in {self.dir}")
                yield {k: z[k] for k in z.files}

    def __len__(self) -> int:
        return sum(1 for n in os.listdir(self.dir) if n.endswith(".npz"))

    def truncate(self) -> None:
        """Drop every record (called after a successful checkpoint)."""
        for name in os.listdir(self.dir):
            if name.endswith(".npz") or name.endswith(".tmp"):
                os.unlink(os.path.join(self.dir, name))
        self._next = 1
