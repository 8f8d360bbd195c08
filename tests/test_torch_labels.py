"""The port's label-set algebra (``pgvectorscale_tpu_torch/labels.py``)
against the JAX package's ``labels.py``.

Every case of ``tests/test_labels.py`` runs against the port, and seeded
random batches of ``overlaps`` / ``contains_intersection`` (sentinel
padding, unequal widths, broadcast leading axes) equal JAX's exactly
(booleans; tolerance: none).  The prune's loop form,
``pairwise_contains_intersection``, equals JAX's broadcast form.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgvectorscale_tpu import labels as JL
from pgvectorscale_tpu_torch import labels as L
from pgvectorscale_tpu_torch import store


def sets_to_array(sets, width):
    return torch.from_numpy(L.make_label_array(sets, width))


def test_one_sentinel_definition():
    assert store.LABEL_SENTINEL is L.LABEL_SENTINEL
    assert L.LABEL_SENTINEL == int(JL.LABEL_SENTINEL)
    assert (L.LABEL_MIN, L.LABEL_MAX) == (JL.LABEL_MIN, JL.LABEL_MAX)


@pytest.mark.parametrize("sets,width", [
    ([[3, 1, 3, 2], None, []], 4),
    ([[-32768, 32767], [5], None], 2),
    ([[7, 7, 7]], 1),
    ([], 3),
])
def test_make_label_array_matches_jax(sets, width):
    got = L.make_label_array(sets, width)
    want = JL.make_label_array(sets, width)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sets,width", [
    ([[40000]], 2), ([[-40000]], 2), ([[1, 2, 3]], 2),
])
def test_make_label_array_refuses_like_jax(sets, width):
    for mod in (L, JL):
        with pytest.raises(ValueError):
            mod.make_label_array(sets, width)


@pytest.mark.parametrize(
    "a,b,want",
    [
        ([1, 2], [2, 3], True),
        ([1, 2], [3, 4], False),
        ([], [1], False),
        ([], [], False),
        ([5], [5], True),
        ([-3, 7], [7], True),
    ],
)
def test_overlaps(a, b, want):
    arr = sets_to_array([a, b], 4)
    assert bool(L.overlaps(arr[0], arr[1])) == want
    assert bool(L.overlaps(arr[1], arr[0])) == want


@pytest.mark.parametrize(
    "self_l,a,b,want",
    [
        ([2, 9], [1, 2], [2, 3], True),
        ([9], [1, 2], [2, 3], False),
        ([9], [1], [2], True),
        ([], [1], [2], True),
        ([1], [1, 2], [1, 2], False),
        ([1, 2], [1, 2], [1, 2], True),
        ([], [], [], True),
    ],
)
def test_contains_intersection(self_l, a, b, want):
    arrs = sets_to_array([self_l, a, b], 4)
    assert bool(L.contains_intersection(arrs[0], arrs[1], arrs[2])) == want


def test_contains_intersection_batch(rng):
    """Randomized cross-check against Python sets."""
    width = 5
    for _ in range(50):
        mk = lambda: rng.choice(10, size=rng.integers(0, width + 1), replace=False)
        s, a, b = mk(), mk(), mk()
        arrs = sets_to_array([s, a, b], width)
        want = (set(a) & set(b)) <= set(s)
        assert bool(L.contains_intersection(arrs[0], arrs[1], arrs[2])) == want


def test_array_overlap_operator():
    assert L.array_overlap([1, 2, 3], [3, 9])
    assert not L.array_overlap([1, 2], [4])
    big_a = list(range(100))
    assert L.array_overlap(big_a, list(range(99, 200)))
    assert not L.array_overlap(big_a, list(range(100, 200)))


def _random_label_rows(rng, n, width, n_labels=6, least=0):
    sets = [rng.choice(n_labels, size=rng.integers(least, width + 1), replace=False)
            for _ in range(n)]
    return L.make_label_array(sets, width)


@pytest.mark.parametrize("wa,wb,ws", [(3, 2, 1), (1, 4, 3), (2, 2, 2), (0, 2, 1)])
def test_random_batches_match_jax(rng, wa, wb, ws):
    """overlaps over [8, 1, wa] x [1, 5, wb] and contains_intersection over
    [8, 5, ws], [8, 1, wa], [1, 5, wb]: the port's bools equal JAX's."""
    a = _random_label_rows(rng, 8, wa).reshape(8, 1, wa)
    b = _random_label_rows(rng, 5, wb).reshape(1, 5, wb)
    s = _random_label_rows(rng, 40, ws).reshape(8, 5, ws)
    got = L.overlaps(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(JL.overlaps(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    got = L.contains_intersection(*map(torch.from_numpy, (s, a, b))).numpy()
    want = np.asarray(JL.contains_intersection(*map(jnp.asarray, (s, a, b))))
    np.testing.assert_array_equal(got, want)
    if wa:
        np.testing.assert_array_equal(L.is_empty(torch.from_numpy(a)).numpy(),
                                      np.asarray(JL.is_empty(jnp.asarray(a))))


@pytest.mark.parametrize("lm", [1, 2, 3])
def test_pairwise_gate_matches_jax_broadcast(rng, lm):
    """The prune's [B, C, C] gate, computed label pair by label pair,
    equals JAX's broadcast ``contains_intersection`` as ``robust_prune``
    calls it."""
    b, c = 4, 23
    cand = _random_label_rows(rng, b * c, lm, n_labels=4).reshape(b, c, lm)
    node = _random_label_rows(rng, b, lm, n_labels=4, least=1)
    got = L.pairwise_contains_intersection(torch.from_numpy(cand), torch.from_numpy(node))
    jc, jn = jnp.asarray(cand), jnp.asarray(node)
    want = JL.contains_intersection(jc[:, :, None, :], jc[:, None, :, :], jn[:, None, None, :])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.all() and got.any()
