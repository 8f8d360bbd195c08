"""Edge-gather Hamming distances: the beam step's inner loop.

Replaces the TPU kernel ``hamming_edge_gather_pallas`` /
``_edge_gather_kernel`` (pgvectorscale_tpu/ops/pallas_hamming.py).  The
TPU kernel reads a flat edge-code cache ``codes[adjacency]`` (R*W words a
node) because small per-row gathers are slow there; on the H100 the codes
table and the adjacency of a 100k-row index (19 MB and 26 MB) fit in the
50 MB L2, so the kernel reads the neighbour codes through the adjacency
and no cache exists.  For each query q, frontier slot e and neighbour r:

    nb = adjacency[clamp(sel[q, e], 0, cap - 1), r]    (clamped into [0, cap))
    out[q, e*R + r] = sum_w popcount(codes[nb, w] ^ query_codes[q, w])

An invalid edge (nb < 0) reads row 0, as the cache held it; callers mask
those slots.

Bound on an H100: bytes.  The least device-memory traffic is each distinct
frontier row's R adjacency entries, each distinct neighbour's code row,
the row ids and query codes read once and the output written once (about
20 MB at Q=1024, E=4, R=65, W=48 over 100k rows, so about 6 us at the H100
SXM's data-sheet 3.35 TB/s); the Q*E*R*W*4 bytes of code rows the lanes
read (51 MB there) come from L2 after a row's first read.
The kernel (``csrc/edge_gather.cu``) is flat over the Q*E*R neighbour
slots: G lanes a slot, each lane issuing all of its 16-byte code and query
loads before using them, a ``__shfl_xor_sync`` sum over the G lanes, and
contiguous output.  The TPU's 128-lane row padding and 0/1 segment-sum
matrix have no counterpart.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain PyTorch version below.  ``launches`` counts kernel launches
(``count_launch``, under a lock: readers may search from several host
threads).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from .hamming import popcount32

launches = 0
_launch_lock = threading.Lock()


def count_launch() -> None:
    global launches
    with _launch_lock:
        launches += 1


def hamming_edge_gather_plain(
    codes: torch.Tensor,  # i32[cap, W]
    adjacency: torch.Tensor,  # i32[cap, R]
    sel: torch.Tensor,  # i32[Q, E]
    query_codes: torch.Tensor,  # i32[Q, W]
) -> torch.Tensor:
    """The plain version: two gathers + XOR + SWAR popcount + sum over the
    words, f32[Q, E*R].  Row ids and neighbour ids are clamped into
    [0, cap) as the kernel does."""
    q, e = sel.shape
    cap, r = adjacency.shape
    nodes = sel.clamp(0, cap - 1).long()
    nbrs = adjacency[nodes].clamp(0, cap - 1).long()  # [Q, E, R]
    x = torch.bitwise_xor(codes[nbrs], query_codes[:, None, None, :])
    pops = torch.sum(popcount32(x), dim=-1, dtype=torch.int32)
    return pops.reshape(q, e * r).to(torch.float32)


def _check(codes, adjacency, sel, query_codes):
    for name, t in (("codes", codes), ("adjacency", adjacency), ("sel", sel),
                    ("query_codes", query_codes)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != codes.device:
            raise ValueError(f"{name} is on {t.device}, codes on {codes.device}")
    cap, w = codes.shape
    q = query_codes.shape[0]
    if cap == 0 or adjacency.shape[0] != cap:
        raise ValueError(f"codes has {cap} rows and adjacency "
                         f"{adjacency.shape[0]}: both need the same cap > 0")
    if w == 0 or adjacency.shape[1] == 0 or query_codes.shape[1] != w:
        raise ValueError(f"query_codes rows hold {query_codes.shape[1]} words, "
                         f"codes rows {w}, adjacency rows {adjacency.shape[1]}: "
                         "all need > 0 and the words must agree")
    if sel.shape[0] != q:
        raise ValueError(f"sel has {sel.shape[0]} rows, query_codes {q}")
    if sel.numel() * adjacency.shape[1] * 32 >= 2**31 or cap >= 2**31:
        raise ValueError("too many neighbour slots for one launch")


def hamming_edge_gather(
    codes: torch.Tensor,  # i32[cap, W]
    adjacency: torch.Tensor,  # i32[cap, R]
    sel: torch.Tensor,  # i32[Q, E] frontier node ids (clamped)
    query_codes: torch.Tensor,  # i32[Q, W]
) -> torch.Tensor:
    """f32[Q, E*R] Hamming distances from each query to the neighbours of
    its E frontier nodes."""
    _check(codes, adjacency, sel, query_codes)
    device = codes.device
    if device.type == "cpu":
        return hamming_edge_gather_plain(codes, adjacency, sel, query_codes)
    if device.type != "cuda":
        raise ValueError(f"no edge-gather kernel for device {device}")
    q, e = sel.shape
    cap, r = adjacency.shape
    out = torch.empty((q, e * r), dtype=torch.float32, device=device)
    if q * e == 0:
        return out
    fn = _kernel()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(
        codes.data_ptr(), adjacency.data_ptr(), sel.data_ptr(),
        query_codes.data_ptr(), out.data_ptr(), q, e, r, codes.shape[1], cap,
        device.index if device.index is not None else torch.cuda.current_device(),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"edge-gather kernel launch failed: CUDA error {err}")
    count_launch()
    return out


def _kernel():
    lib = _build.load("edge_gather")
    fn = lib.pgvs_edge_gather_hamming
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


# The high-dimension cases the kernel is held to on the card, (q, e, r, w,
# offset): the code widths of 2,000-, 3,072-, 4,000-, 8,000- and
# 16,000-dim indexes at the bits a dimension that IndexConfig picks (1 bit
# from 900 dims: 63, 96, 125, 250 and 500 words; 16 or 32 lanes a slot),
# R = 21 (num_neighbors 16), each with 16-byte aligned tables (16-byte
# loads where W % 4 == 0) and with tables that start 4 bytes past a
# 16-byte boundary ("offset": 4-byte loads; at W = 250 and 500 a lane
# takes more than one pass over its chunks).
HIGH_DIM_CASES = [(64, 2, 21, w, offset) for w in (63, 96, 125, 250, 500)
                  for offset in (False, True)]


def check_tables(q: int, e: int, r: int, w: int, cap: int, offset: bool, invalid_share: float,
                 device, generator=None):
    """Random inputs of one kernel check: (codes [cap, W], adjacency
    [cap, R] with ``invalid_share`` of the slots INVALID_ID, sel [Q, E]
    with an out-of-range id at each end, query_codes [Q, W]).  ``offset``
    starts both code tables 4 bytes past a 16-byte boundary."""
    def rand_i32(rows):
        if offset:
            return torch.randint(-2**31, 2**31 - 1, (rows * w + 1,), dtype=torch.int32,
                                 device=device, generator=generator)[1:].view(rows, w)
        return torch.randint(-2**31, 2**31 - 1, (rows, w), dtype=torch.int32,
                             device=device, generator=generator)

    codes = rand_i32(cap)
    adj = torch.randint(0, cap, (cap, r), dtype=torch.int32, device=device, generator=generator)
    adj[torch.rand((cap, r), device=device, generator=generator) < invalid_share] = -1
    sel = torch.randint(0, cap, (q, e), dtype=torch.int32, device=device, generator=generator)
    sel[0, 0], sel[-1, -1] = -5, cap + 7  # out-of-range row ids are clamped
    return codes, adj, sel, rand_i32(q)


def bound_bytes(q: int, e: int, r_max: int, w: int, sel_rows: int,
                nbr_rows: int) -> int:
    """Bytes the function must move from device memory: the R adjacency
    entries of each of the ``sel_rows`` distinct frontier rows, the code
    row of each of the ``nbr_rows`` distinct neighbours, the row ids and
    the query codes read once, the output written once."""
    return (sel_rows * r_max + nbr_rows * w + q * e + q * w + q * e * r_max) * 4


def l2_bytes(q: int, e: int, r_max: int, w: int) -> int:
    """Bytes of code rows the lanes read, every read counted (a row read
    again within a call comes from L2)."""
    return q * e * r_max * w * 4
