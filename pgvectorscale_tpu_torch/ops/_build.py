"""Build and load the port's CUDA kernels.

Each kernel is one ``.cu`` file under ``csrc/`` with a plain ``extern "C"``
interface.  At first use it is compiled by ``nvcc`` into a shared library
and loaded with ``ctypes``; nothing includes PyTorch's headers, so a build
takes seconds.  Libraries land in ``csrc/_build/`` (listed in
``.gitignore``), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source, header or flag is
rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 300
# The shared memory one block may use on the build's target, sm_90a
# (232,448 bytes of the H100 SM's 256 KB).
MAX_SHARED_BYTES = 232_448

# name -> ctypes library, for this process; threads load under the lock.
_LOADED: dict = {}
_LOAD_LOCK = threading.Lock()


def find_nvcc() -> str:
    """nvcc from ``PATH``, else under ``CUDA_HOME`` / ``CUDA_PATH``, else
    under the toolkit's default prefix.  Raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
             "/usr/local/cuda"]
    for home in homes:
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the port's CUDA "
        "kernels need the CUDA toolkit"
    )


def _headers_bytes() -> bytes:
    """The names and contents of every ``csrc/*.cuh``, which a source may
    include: an edited header gives every library a new hash."""
    return b"".join(h.name.encode() + b"\0" + h.read_bytes()
                    for h in sorted(CSRC.glob("*.cuh")))


def build(names, build_dir: Path | None = None) -> list[dict]:
    """Compile ``csrc/<name>.cu`` for each name unless a library for the
    same source and flags exists: one nvcc process per missing source, all
    started together.  Returns one record per name with the library path,
    whether it was compiled now, the seconds that took and nvcc's
    ``-Xptxas -v`` lines."""
    build_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    records, running = [], []
    for name in names:
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + _headers_bytes() + "\0".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        lib = build_dir / f"lib{name}_{digest}.so"
        record = {"name": name, "library": str(lib), "compiled": False,
                  "seconds": 0.0, "ptxas": []}
        records.append(record)
        if lib.exists():
            continue
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = build_dir / f".{lib.name}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((record, src, tmp, lib, proc, time.perf_counter()))
    try:
        for record, src, tmp, lib, proc, t0 in running:
            output, _ = proc.communicate(
                timeout=max(NVCC_TIMEOUT_S - (time.perf_counter() - t0), 1)
            )
            record["seconds"] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src.name} (exit {proc.returncode}):\n"
                    f"{output}"
                )
            os.replace(tmp, lib)  # atomic: a reader never sees a partial library
            record["compiled"] = True
            record["ptxas"] = [ln for ln in output.splitlines()
                               if "ptxas" in ln or "spill" in ln]
    finally:
        for _, _, tmp, _, proc, _ in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return records


def load(name: str, build_dir: Path | None = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOAD_LOCK:
        if name not in _LOADED:
            _LOADED[name] = ctypes.CDLL(build([name], build_dir)[0]["library"])
        return _LOADED[name]
