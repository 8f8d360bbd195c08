"""Dense Hamming distance matrix: the brute-force seed scan of storage builds.

Replaces the TPU kernel ``hamming_matrix_pallas`` / ``_hamming_tile_kernel``
(pgvectorscale_tpu/ops/pallas_hamming.py):

    out[q, n] = sum_w popcount(query_codes[q, w] ^ codes[n, w])    (int32)

Over 0/1 bits the same matrix is the popcount-dot pop(a) + pop(b) -
2 * dot(a, b), K = 32 * W bits.  Bound on an H100: bytes, the Q*N*4 output
bytes, 0.041 ms at 3.35 TB/s at Q=4096, N=8192, W=48 (a 100k-row build's
first wave); the operations take 0.010 ms on the tensor cores' 1-bit path
at the rate ``microbench/mma_rates.cu`` measures, 5.11e15 bit pairs a
second (0.052 ms as an int8 product at the data sheet's 1,979 TOP/s).
The kernel (``csrc/hamming_matrix.cu``, one launch)
computes the dot on the tensor cores' 1-bit path, ``mma.sync m16n8k256
.b1 .and.popc`` on the packed words (8 times the bit pairs a second of
the int8 path, so its operations take a quarter of the output's time), and
is built around its stores: 64 x 128 output tiles, three blocks an SM,
the code rows staged in shared memory 64 words at a time with their bit
counts, and the tile written back in whole 16-byte chunks with streaming
stores.  It masks the ragged edges itself; the TPU's 128 x 128 tile
padding has no counterpart.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain PyTorch version, ``ops.hamming.hamming_distance_matrix``.
``expand_code_bits_plain`` writes the kernel's arithmetic out bit by bit
(0/1 bytes and row popcounts, for pop(a) + pop(b) - 2 * dot) for the tests
and the library yardstick; ``CHECK_CASES`` and ``check_codes`` are the
cases that the card tests and ``chip_smoke.py`` hold the kernel to.
``launches`` counts kernel launches (``count_launch``, under a lock:
readers may search from several host threads).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from .hamming import code_bits, hamming_distance_matrix

launches = 0
_launch_lock = threading.Lock()


def count_launch() -> None:
    global launches
    with _launch_lock:
        launches += 1

hamming_matrix_plain = hamming_distance_matrix


def expand_code_bits_plain(codes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int32 [R, W] codes -> (int8 [R, 32W] 0/1 bits, LSB first, int32 [R]
    popcounts)."""
    bits = code_bits(codes.contiguous()).view(torch.int8)
    return bits, bits.sum(dim=1, dtype=torch.int32)


# The cases the kernel is held to against its plain version, (q, n, w,
# fill): the storage build's shapes (a 100k-row build's seed wave, the first
# add into a 2,048-row index), the TPU kernel tests' shapes, a ragged wide
# one (16,000 dims at 1 bit); Q or N off the 64 x 128 tile; W = 1, 3, 5
# (4-byte copies; K off the 8-word step); constant codes, every distance 0
# or 32 * W ("zeros-ones": all-zero queries against all-one codes); tables
# that start 4 bytes past a 16-byte boundary ("offset").
CHECK_CASES = [
    (4096, 8192, 48, None), (4096, 6144, 48, None), (8, 16, 1, None),
    (100, 130, 8, None), (128, 256, 48, None), (333, 1000, 500, None),
    (1, 1, 1, None), (1, 300, 3, None), (63, 65, 5, None), (65, 129, 48, None),
    (129, 63, 3, None), (300, 1, 5, None), (129, 257, 1, None),
    (65, 129, 48, "zeros"), (63, 65, 5, "ones"), (129, 257, 3, "zeros-ones"),
    (65, 63, 48, "ones-zeros"), (129, 300, 48, "offset"),
]


def check_codes(q: int, n: int, w: int, fill, device, generator=None):
    """The query and code tables of a ``CHECK_CASES`` entry: random, or as
    ``fill`` says.  Returns (query_codes, codes, d): d is the distance every
    entry must have for constant codes, else None."""
    def rand(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32,
                             device=device, generator=generator)

    if fill is None:
        return rand(q, w), rand(n, w), None
    if fill == "offset":
        return rand(q * w + 1)[1:].view(q, w), rand(n * w + 1)[1:].view(n, w), None
    first, _, second = fill.partition("-")
    second = second or first
    const = {"zeros": 0, "ones": -1}
    return (torch.full((q, w), const[first], dtype=torch.int32, device=device),
            torch.full((n, w), const[second], dtype=torch.int32, device=device),
            0 if first == second else 32 * w)


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
    count_launch()
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
