"""The arithmetic of the port's tensor-core Hamming matrix against the JAX
package, on the CPU.

On the card ``ops.hamming_matrix`` computes pop(a) + pop(b) - 2 * dot(a, b),
the dot of the codes' 0/1 bits on the tensor cores.  Here that arithmetic
is written out bit by bit: ``expand_code_bits_plain`` must equal both
packages' ``unpack_code_bits``, and the popcount-dot over its bits must
equal the TPU kernel ``hamming_matrix_pallas`` (interpret mode), as must
the kernel's own form on the packed words, the dot as popc(a & b) summed
over the words.  All results are integers: tolerance none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgvectorscale_tpu.graph import prune as jprune
from pgvectorscale_tpu.ops.pallas_hamming import hamming_matrix_pallas
from pgvectorscale_tpu_torch.graph import prune
from pgvectorscale_tpu_torch.ops import hamming_matrix as hm
from pgvectorscale_tpu_torch.ops.hamming import popcount32


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _u32(rng, shape) -> np.ndarray:
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _i32(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.uint32).view(np.int32))


@pytest.mark.parametrize("w", [1, 3, 8, 48])
def test_expand_code_bits_plain_matches_both_unpacks(rng, w):
    """int8 bits equal the port's and JAX's unpack_code_bits at full width
    (32 * W bits, LSB first); the popcounts are the rows' bit sums."""
    codes = _u32(rng, (37, w))
    codes[0] = 0
    codes[1] = 0xFFFFFFFF
    bits, pops = hm.expand_code_bits_plain(_i32(codes))
    assert bits.dtype == torch.int8 and bits.shape == (37, 32 * w)
    assert pops.dtype == torch.int32 and pops.shape == (37,)
    want = np.asarray(jprune.unpack_code_bits(jnp.asarray(codes), 32 * w))
    np.testing.assert_array_equal(bits.numpy(), want)
    np.testing.assert_array_equal(prune.unpack_code_bits(_i32(codes), 32 * w).numpy(),
                                  bits.numpy())
    np.testing.assert_array_equal(pops.numpy(), want.sum(axis=1))
    assert pops[0] == 0 and pops[1] == 32 * w


_PALLAS_SHAPES = [(8, 16, 1), (100, 130, 8), (128, 256, 48), (37, 200, 13)]


@pytest.mark.parametrize("q,n,w", _PALLAS_SHAPES)
def test_popcount_dot_matches_pallas(rng, q, n, w):
    """pop(a) + pop(b) - 2 * a.b over the expanded bits equals the TPU
    kernel."""
    qc, cc = _u32(rng, (q, w)), _u32(rng, (n, w))
    want = np.asarray(hamming_matrix_pallas(jnp.asarray(qc), jnp.asarray(cc), interpret=True))
    a, pa = hm.expand_code_bits_plain(_i32(qc))
    b, pb = hm.expand_code_bits_plain(_i32(cc))
    got = pa[:, None] + pb[None, :] - 2 * (a.int() @ b.int().T)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("q,n,w", _PALLAS_SHAPES)
def test_packed_and_popcount_dot_matches_pallas(rng, q, n, w):
    """The kernel's own arithmetic on the packed int32 words: the row
    popcounts pa, pb and the dot as popc(a & b) summed over the words,
    pa + pb - 2 * dot, equals the TPU kernel."""
    qc, cc = _u32(rng, (q, w)), _u32(rng, (n, w))
    qc[0] = 0xFFFFFFFF
    want = np.asarray(hamming_matrix_pallas(jnp.asarray(qc), jnp.asarray(cc), interpret=True))
    a, b = _i32(qc), _i32(cc)
    pa = popcount32(a).sum(dim=1, dtype=torch.int32)
    pb = popcount32(b).sum(dim=1, dtype=torch.int32)
    dot = popcount32(a[:, None, :] & b[None, :, :]).sum(dim=-1, dtype=torch.int32)
    got = pa[:, None] + pb[None, :] - 2 * dot
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
