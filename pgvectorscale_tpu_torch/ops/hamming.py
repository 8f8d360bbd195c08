"""Hamming distance on packed SBQ codes (PyTorch port of ``ops/hamming.py``).

Codes are int32 words.  torch has no popcount, so the plain tensor path
counts bits with SWAR arithmetic on int32; every shift is followed by a
mask that clears the bits an arithmetic shift copies in from the sign.
"""

from __future__ import annotations

import torch


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each int32 word, as int32 in [0, 32]."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    # Each byte now holds its count (<= 8), so bit 31 is clear from here on.
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def code_bits(codes: torch.Tensor) -> torch.Tensor:
    """int32[..., W] packed codes -> uint8[..., 32 * W] 0/1 bits, LSB first.
    The words are little-endian, so their bytes in memory order, each
    unpacked LSB first, keep the bit order; the result holds one byte a
    bit.  The last dimension must be contiguous."""
    shifts = torch.arange(8, dtype=torch.uint8, device=codes.device)
    bits = (codes.view(torch.uint8)[..., None] >> shifts).bitwise_and_(1)
    return bits.reshape(*codes.shape[:-1], codes.shape[-1] * 32)


def hamming_distance_matrix(
    query_codes: torch.Tensor, codes: torch.Tensor
) -> torch.Tensor:
    """[Q, W] x [C, W] -> [Q, C] int32 Hamming distances."""
    x = torch.bitwise_xor(query_codes[:, None, :], codes[None, :, :])
    return torch.sum(popcount32(x), dim=-1, dtype=torch.int32)


def hamming_gather(
    query_codes: torch.Tensor,  # i32[Q, W]
    codes: torch.Tensor,  # i32[N, W]
    ids: torch.Tensor,  # i32[Q, R]; ids < 0 are clamped, callers mask
) -> torch.Tensor:
    """Distances from each query to its own candidate list: i32[Q, R]."""
    gathered = codes[ids.clamp_min(0).long()]  # [Q, R, W]
    x = torch.bitwise_xor(gathered, query_codes[:, None, :])
    return torch.sum(popcount32(x), dim=-1, dtype=torch.int32)


def hamming_pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-paired Hamming: i32[N, W], i32[N, W] -> i32[N]."""
    return torch.sum(popcount32(torch.bitwise_xor(a, b)), dim=-1, dtype=torch.int32)
