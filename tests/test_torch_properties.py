"""Property-based tests (hypothesis) of the port's quantizer and label
algebra, against set semantics and against the JAX package.

``tests/test_properties.py``'s cases on the port, with its settings
(``max_examples`` 25-40, no deadline).  On each draw the port's
``overlaps``, ``contains_intersection``, ``array_overlap``,
``hamming_pairwise`` and ``sbq.encode`` (bits 1, 2, 4 and 8, with the
same statistics) also equal JAX's (tolerance: none).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from pgvectorscale_tpu import labels as jlabels
from pgvectorscale_tpu.ops import hamming as jham
from pgvectorscale_tpu.ops import sbq as jsbq
from pgvectorscale_tpu_torch.labels import (
    LABEL_SENTINEL,
    array_overlap,
    contains_intersection,
    make_label_array,
    overlaps,
)
from pgvectorscale_tpu_torch.ops import sbq
from pgvectorscale_tpu_torch.ops.hamming import hamming_pairwise

label_sets = st.lists(
    st.integers(min_value=-(2**15), max_value=2**15 - 1),
    min_size=0,
    max_size=6,
)
float_rows = st.lists(
    st.lists(
        st.floats(min_value=-100, max_value=100, allow_nan=False,
                  allow_infinity=False, width=32),
        min_size=8, max_size=8,
    ),
    min_size=2, max_size=20,
)


def _stats_to_torch(stats) -> sbq.SbqStats:
    return sbq.SbqStats(count=int(np.asarray(stats.count)),
                        mean=torch.from_numpy(np.asarray(stats.mean).copy()),
                        m2=torch.from_numpy(np.asarray(stats.m2).copy()))


def _u32(codes: torch.Tensor) -> np.ndarray:
    return codes.numpy().view(np.uint32)


@settings(max_examples=40, deadline=None)
@given(a=label_sets, b=label_sets)
def test_overlaps_matches_set_semantics(a, b):
    arr = make_label_array([a, b], 8)
    np.testing.assert_array_equal(arr, jlabels.make_label_array([a, b], 8))
    got = bool(overlaps(torch.from_numpy(arr[0]), torch.from_numpy(arr[1])))
    assert got == bool(set(a) & set(b))
    assert got == bool(np.asarray(jlabels.overlaps(jnp.asarray(arr[0]), jnp.asarray(arr[1]))))


@settings(max_examples=40, deadline=None)
@given(s=label_sets, a=label_sets, b=label_sets)
def test_contains_intersection_matches_set_semantics(s, a, b):
    arr = make_label_array([s, a, b], 8)
    got = bool(contains_intersection(*(torch.from_numpy(r) for r in arr)))
    # Reference semantics: is (a ∩ b) ⊆ self (labels/mod.rs:85-111)?
    assert got == ((set(a) & set(b)) <= set(s))
    assert got == bool(np.asarray(jlabels.contains_intersection(*(jnp.asarray(r) for r in arr))))


@settings(max_examples=40, deadline=None)
@given(a=label_sets, b=label_sets)
def test_array_overlap_operator(a, b):
    got = array_overlap(a, b)
    assert got == bool(set(a) & set(b)) == jlabels.array_overlap(a, b)


@settings(max_examples=25, deadline=None)
@given(data=float_rows, bits=st.sampled_from([1, 2, 4, 8]))
def test_sbq_hamming_zero_iff_same_bucket(data, bits):
    """Identical vectors always encode identically (Hamming 0) and the
    code of any vector is deterministic; with JAX's statistics the codes
    equal JAX's."""
    v = np.asarray(data, dtype=np.float32)
    stats = sbq.train(torch.from_numpy(v))
    codes1 = sbq.encode(torch.from_numpy(v), stats, bits)
    codes2 = sbq.encode(torch.from_numpy(v), stats, bits)
    np.testing.assert_array_equal(codes1.numpy(), codes2.numpy())
    d = hamming_pairwise(codes1, codes2)
    assert d.dtype == torch.int32 and bool((d == 0).all())

    jstats = jsbq.train(jnp.asarray(v))
    jcodes = jsbq.encode(jnp.asarray(v), jstats, bits)
    got = sbq.encode(torch.from_numpy(v), _stats_to_torch(jstats), bits)
    np.testing.assert_array_equal(_u32(got), np.asarray(jcodes))
    # Row-paired distances between each row and the next, as JAX's.
    want = np.asarray(jham.hamming_pairwise(jcodes[:-1], jcodes[1:]))
    np.testing.assert_array_equal(hamming_pairwise(got[:-1], got[1:]).numpy(), want)


@settings(max_examples=25, deadline=None)
@given(
    n=st.integers(min_value=2, max_value=64),
    dims=st.integers(min_value=1, max_value=40),
    bits=st.sampled_from([1, 2, 4, 8]),
    seed=st.integers(min_value=0, max_value=2**31 - 1),
)
def test_sbq_thermometer_is_monotone_per_dim(n, dims, bits, seed):
    """Within a dimension, a larger value never gets fewer thermometer
    ones — the defining property of the unary code (quantize.rs:63-89)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, dims)).astype(np.float32)
    stats = sbq.train(torch.from_numpy(v))
    codes = _u32(sbq.encode(torch.from_numpy(v), stats, bits))
    total_bits = dims * bits
    unpacked = np.unpackbits(codes.view(np.uint8), axis=1, bitorder="little")[:, :total_bits]
    ones = unpacked.reshape(n, dims, bits).sum(axis=2)
    for dim in range(dims):
        order = np.argsort(v[:, dim], kind="stable")
        assert (np.diff(ones[order, dim]) >= 0).all(), f"thermometer not monotone in dim {dim}"


@settings(max_examples=25, deadline=None)
@given(
    n=st.integers(min_value=1, max_value=40),
    words=st.integers(min_value=1, max_value=12),
    seed=st.integers(min_value=0, max_value=2**31 - 1),
)
def test_hamming_pairwise_matches_jax(n, words, seed):
    """Random 32-bit words, sign bit included: the port's row-paired
    distances equal JAX's and a direct bit count."""
    rng = np.random.default_rng(seed)
    a, b = (rng.integers(0, 2**32, (n, words), dtype=np.uint64).astype(np.uint32)
            for _ in range(2))
    got = hamming_pairwise(torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32)))
    want = np.asarray(jham.hamming_pairwise(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got.numpy(), want)
    direct = np.unpackbits((a ^ b).view(np.uint8), axis=1).sum(axis=1)
    np.testing.assert_array_equal(got.numpy(), direct)


def test_make_label_array_sorts_and_dedups():
    arr = make_label_array([[5, -3, 5, 0]], 8)
    vals = [int(v) for v in arr[0] if v != LABEL_SENTINEL]
    assert vals == [-3, 0, 5]


def test_make_label_array_rejects_out_of_range():
    with pytest.raises(ValueError, match="smallint range"):
        make_label_array([[2**15]], 4)
    with pytest.raises(ValueError, match="at most"):
        make_label_array([[1, 2, 3]], 2)
