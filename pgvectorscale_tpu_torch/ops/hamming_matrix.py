"""Dense Hamming distance matrix: the brute-force seed scan of storage builds.

Replaces the TPU kernel ``hamming_matrix_pallas`` / ``_hamming_tile_kernel``
(pgvectorscale_tpu/ops/pallas_hamming.py):

    out[q, n] = sum_w popcount(query_codes[q, w] ^ codes[n, w])    (int32)

Bound on an H100: operations, on the int8 tensor cores, as the popcount
dot pop(a) + pop(b) - 2 * dot(a, b) over 0/1 bits: Q*N*W*32*2 int8
operations at 1,979 TOP/s, about 0.052 ms at Q=4096, N=8192, W=48 (a
100k-row build's first wave).  This kernel runs on the CUDA cores, where an
SM executes 16 ``popc`` per clock against 64 32-bit XORs or adds, so its
own floor is Q*N*W / (132 * 16 * clock), about 0.39 ms at 1.98 GHz; the
Q*N*4 output bytes take 0.04 ms at 3.35 TB/s.  The kernel (``csrc/hamming_matrix.cu``) gives each
64 x 64 output tile a block, stages the tile's query and code rows in
shared memory 32 words at a time (any W up to 500 fits), keeps 16 sums per
thread in registers and masks the ragged edges itself; the TPU's 128 x 128
tile padding has no counterpart.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain PyTorch version, ``ops.hamming.hamming_distance_matrix``.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .hamming import hamming_distance_matrix

launches = 0

hamming_matrix_plain = hamming_distance_matrix


def _check(query_codes: torch.Tensor, codes: torch.Tensor) -> None:
    for name, t in (("query_codes", query_codes), ("codes", codes)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if codes.device != query_codes.device:
        raise ValueError(f"codes are on {codes.device}, query_codes on "
                         f"{query_codes.device}")
    if query_codes.shape[1] != codes.shape[1]:
        raise ValueError(
            f"query_codes have {query_codes.shape[1]} words, codes "
            f"{codes.shape[1]}"
        )


def hamming_matrix(query_codes: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """[Q, W] x [N, W] int32 codes -> [Q, N] int32 Hamming distances."""
    global launches
    _check(query_codes, codes)
    device = codes.device
    if device.type == "cpu":
        return hamming_matrix_plain(query_codes, codes)
    if device.type != "cuda":
        raise ValueError(f"no Hamming-matrix kernel for device {device}")
    q, w = query_codes.shape
    n = codes.shape[0]
    out = torch.empty((q, n), dtype=torch.int32, device=device)
    if q * n == 0:
        return out
    fn = _kernel()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(
        query_codes.data_ptr(), codes.data_ptr(), out.data_ptr(), q, n, w,
        device.index if device.index is not None else torch.cuda.current_device(),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"Hamming-matrix kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _kernel():
    lib = _build.load("hamming_matrix")
    fn = lib.pgvs_hamming_matrix
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def bound_bytes(q: int, n: int, w: int) -> int:
    """Bytes the function must move: both code tables read once, the
    output written once."""
    return (q * w + n * w + q * n) * 4
