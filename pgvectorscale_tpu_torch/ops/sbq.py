"""Statistical Binary Quantization (PyTorch port of ``ops/sbq.py``).

The reference quantizer (pgvectorscale/src/access_method/sbq/quantize.rs):

- Training computes per-dimension mean and M2 (sum of squared deviations)
  in one batched pass.
- 1-bit: bit i set iff v[i] > mean[i].
- Multi-bit: thermometer code over z-score buckets in [-2, 2]; a NaN
  z-score (zero-variance dim) encodes as 0 ones.
- Untrained (count == 0): bit i set iff v[i] > 0.
- Bits are packed LSB-first into 32-bit words.

Words are carried as int32: torch has no popcount and its CPU build does
not shift uint32, so the port holds the same 32 bits in a signed word.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

WORD_BITS = 32


class SbqStats(NamedTuple):
    count: int  # training rows (0 = untrained)
    mean: torch.Tensor  # f32[D]
    m2: torch.Tensor  # f32[D]


def _f32(x: float, device) -> torch.Tensor:
    """A float32 divisor on the device.  A Python-scalar divisor lets the
    CUDA build multiply by its reciprocal, which can differ from a true
    division in the last bit and move a code past a bucket edge."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def num_code_words(dims: int, bits: int) -> int:
    return (dims * bits + WORD_BITS - 1) // WORD_BITS


def empty_stats(dims: int, device) -> SbqStats:
    z = torch.zeros((dims,), dtype=torch.float32, device=device)
    return SbqStats(count=0, mean=z, m2=z.clone())


def train(vectors: torch.Tensor) -> SbqStats:
    """Per-dimension mean / M2 over the training set.  Sums run in torch's
    order, not XLA's, so they may differ from the JAX package's in the
    last bits of float32."""
    vectors = vectors.to(torch.float32)
    count = vectors.shape[0]
    mean = torch.sum(vectors, dim=0) / _f32(count, vectors.device)
    centered = vectors - mean[None, :]
    m2 = torch.sum(centered * centered, dim=0)
    return SbqStats(count=int(count), mean=mean, m2=m2)


def merge_stats(a: SbqStats, b: SbqStats) -> SbqStats:
    """Chan's parallel merge of two (count, mean, M2) triples, in float32
    as in the JAX package (the chunked ingest's training pass)."""
    n = a.count + b.count
    dev = a.mean.device
    n_f = _f32(max(n, 1), dev)
    a_f, b_f = _f32(a.count, dev), _f32(b.count, dev)
    delta = b.mean - a.mean
    mean = a.mean + delta * (b_f / n_f)
    m2 = a.m2 + b.m2 + delta * delta * (a_f * b_f / n_f)
    return SbqStats(count=n, mean=mean, m2=m2)


def _pack_bits(bit_array: torch.Tensor, words: int) -> torch.Tensor:
    """Pack [N, num_bits] 0/1 into [N, words] int32 words, LSB-first.

    The weights are the int32 values of 1 << j (bit 31 weighs -2^31).  The
    bits of one word are distinct, so every partial sum stays inside int32
    and the total is the word's bit pattern read as a signed int32."""
    n, num_bits = bit_array.shape
    padded = words * WORD_BITS
    if padded != num_bits:
        bit_array = torch.nn.functional.pad(bit_array, (0, padded - num_bits))
    b = bit_array.reshape(n, words, WORD_BITS).to(torch.int32)
    weights = torch.tensor(
        [1 << j for j in range(WORD_BITS - 1)] + [-(1 << (WORD_BITS - 1))],
        dtype=torch.int32,
        device=bit_array.device,
    )
    return torch.sum(b * weights, dim=-1, dtype=torch.int32)


def encode(vectors: torch.Tensor, stats: SbqStats, bits: int) -> torch.Tensor:
    """Quantize [N, D] float vectors into [N, W] packed int32 codes."""
    vectors = vectors.to(torch.float32)
    n, dims = vectors.shape
    words = num_code_words(dims, bits)
    if stats.count <= 0:
        # Untrained fallback: bit at position i iff v > 0, whatever bits is
        # (quantize.rs:91-101 indexes by dimension).
        return _pack_bits((vectors > 0.0).to(torch.int32), words)
    if bits == 1:
        return _pack_bits((vectors > stats.mean[None, :]).to(torch.int32), words)
    variance = stats.m2 / _f32(max(stats.count, 1), vectors.device)
    std = torch.sqrt(variance)
    ranges = bits + 1
    z = (vectors - stats.mean[None, :]) / std[None, :]
    index = (z + 2.0) / _f32(4.0 / ranges, vectors.device)
    ones = torch.clamp_max(torch.floor(index), float(bits))
    ones = torch.where(index < 1.0, torch.zeros_like(ones), ones)
    # NaN (zero-variance dim, v == mean): Rust `NaN as usize` is 0.
    ones = torch.where(torch.isnan(index), torch.zeros_like(ones), ones)
    ones = ones.to(torch.int32)
    j = torch.arange(bits, dtype=torch.int32, device=vectors.device)
    bit_array = (j[None, None, :] < ones[:, :, None]).to(torch.int32)
    return _pack_bits(bit_array.reshape(n, dims * bits), words)
