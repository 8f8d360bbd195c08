"""Parity of the PyTorch port's SBQ, Hamming and edge-gather modules with
the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX side runs on the CPU as its own tests run it (Pallas in interpret
mode).  Integer results (codes, Hamming distances) must be equal; the
float statistics of ``train`` are equal on data whose sums are exact in
float32 and within 1e-6 relative otherwise (the two frameworks sum in
different orders).
"""

import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgvectorscale_tpu.ops import hamming as jham
from pgvectorscale_tpu.ops import sbq as jsbq
from pgvectorscale_tpu.ops.pallas_hamming import hamming_edge_gather_pallas
from pgvectorscale_tpu_torch.ops import edge_gather, hamming, sbq

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _u32_to_i32(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.uint32)).view(np.int32))


def _stats_to_torch(stats) -> sbq.SbqStats:
    return sbq.SbqStats(
        count=int(np.asarray(stats.count)),
        mean=torch.from_numpy(np.asarray(stats.mean).copy()),
        m2=torch.from_numpy(np.asarray(stats.m2).copy()),
    )


def _sbq_data(rng, n, dims):
    x = rng.standard_normal((n, dims)).astype(np.float32)
    x[:, 3] = 0.75  # zero-variance dim: NaN z-scores
    return x


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("dims", [31, 64, 100])
def test_encode_bit_exact(rng, bits, dims):
    """Codes equal the JAX package's uint32 words bit for bit (tolerance:
    none), with the same statistics, a zero-variance dim and a NaN."""
    x = _sbq_data(rng, 80, dims)
    stats = jsbq.train(jnp.asarray(x))
    q = rng.standard_normal((20, dims)).astype(np.float32)
    q[0, 5] = np.nan
    q[1, 3] = 0.75
    want = np.asarray(jsbq.encode(jnp.asarray(q), stats, bits))
    got = sbq.encode(torch.from_numpy(q), _stats_to_torch(stats), bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("bits", [1, 2])
def test_encode_untrained_bit_exact(rng, bits):
    q = rng.standard_normal((10, 40)).astype(np.float32)
    want = np.asarray(jsbq.encode(jnp.asarray(q), jsbq.SbqStats(
        count=jnp.zeros((), jnp.int32), mean=jnp.zeros((40,)), m2=jnp.zeros((40,))
    ), bits))
    got = sbq.encode(torch.from_numpy(q), sbq.empty_stats(40, "cpu"), bits)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_train_bit_exact_on_exact_sums(rng):
    """64 rows of multiples of 1/4: every sum is exact in float32 in any
    order, so the statistics and the codes are equal bit for bit."""
    x = (rng.integers(-16, 17, (64, 48)) / 4.0).astype(np.float32)
    x[:, 7] = 1.25  # zero-variance dim
    js = jsbq.train(jnp.asarray(x))
    ps = sbq.train(torch.from_numpy(x))
    assert ps.count == int(js.count) == 64
    np.testing.assert_array_equal(ps.mean.numpy(), np.asarray(js.mean))
    np.testing.assert_array_equal(ps.m2.numpy(), np.asarray(js.m2))
    for bits in (1, 2, 4, 8):
        np.testing.assert_array_equal(
            sbq.encode(torch.from_numpy(x), ps, bits).numpy().view(np.uint32),
            np.asarray(jsbq.encode(jnp.asarray(x), js, bits)),
        )


def test_train_close_on_random_data(rng):
    """Random data: statistics within 1e-6 relative (summation order)."""
    x = rng.standard_normal((300, 70)).astype(np.float32)
    js = jsbq.train(jnp.asarray(x))
    ps = sbq.train(torch.from_numpy(x))
    np.testing.assert_allclose(ps.mean.numpy(), np.asarray(js.mean), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ps.m2.numpy(), np.asarray(js.m2), rtol=1e-6)


def test_popcount32_matches_numpy(rng):
    x = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    want = np.array([bin(int(v)).count("1") for v in x])
    got = hamming.popcount32(_u32_to_i32(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_hamming_matrix_and_gather_match_jax(rng):
    qc = rng.integers(0, 2**32, (9, 6), dtype=np.uint64).astype(np.uint32)
    cc = rng.integers(0, 2**32, (40, 6), dtype=np.uint64).astype(np.uint32)
    ids = rng.integers(-1, 40, (9, 12)).astype(np.int32)
    np.testing.assert_array_equal(
        hamming.hamming_distance_matrix(_u32_to_i32(qc), _u32_to_i32(cc)).numpy(),
        np.asarray(jham.hamming_distance_matrix(jnp.asarray(qc), jnp.asarray(cc))),
    )
    np.testing.assert_array_equal(
        hamming.hamming_gather(_u32_to_i32(qc), _u32_to_i32(cc), torch.from_numpy(ids)).numpy(),
        np.asarray(jham.hamming_gather(jnp.asarray(qc), jnp.asarray(cc), jnp.asarray(ids))),
    )


@pytest.mark.parametrize("q,e,r,w", [(8, 1, 3, 1), (100, 2, 65, 8), (130, 4, 17, 8)])
def test_edge_gather_plain_matches_pallas(rng, q, e, r, w):
    """The plain version, reading the codes through the adjacency, equals
    the TPU kernel (interpret mode) over the edge-code cache
    ``codes[adjacency]`` built in numpy (invalid edges gather row 0), with
    about a quarter of the edges invalid (tolerance: none)."""
    cap = 500
    codes = rng.integers(0, 2**32, (cap, w), dtype=np.uint64).astype(np.uint32)
    adjacency = rng.integers(0, cap, (cap, r)).astype(np.int32)
    adjacency[rng.random((cap, r)) < 0.25] = -1
    sel = rng.integers(0, cap, (q, e)).astype(np.int32)
    qc = rng.integers(0, 2**32, (q, w), dtype=np.uint64).astype(np.uint32)
    edge = codes[np.maximum(adjacency, 0)].reshape(cap, r * w)
    want = np.asarray(hamming_edge_gather_pallas(
        jnp.asarray(edge), jnp.asarray(sel), jnp.asarray(qc), r_max=r, interpret=True
    ))
    before = edge_gather.launches
    got = edge_gather.hamming_edge_gather(
        _u32_to_i32(codes), torch.from_numpy(adjacency), torch.from_numpy(sel),
        _u32_to_i32(qc),
    )
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert edge_gather.launches == before  # the CPU takes the plain version


def test_port_imports_no_jax():
    """Neither the package (its CLI, native runtime, durability, stats,
    debug, brute-force, utils, mesh, sharded-index, multi-process and
    models modules included) nor the card scripts
    (chip_smoke.py, profile_main_path.py) name JAX or the JAX package, and
    importing them loads no JAX module."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|pgvectorscale_tpu)\b(?!_torch)", re.M)
    files = list((ROOT / "pgvectorscale_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "profile_main_path.py"]
    assert len(files) > 10
    pkg = ROOT / "pgvectorscale_tpu_torch"
    for rel in ("graph/iterate.py", "durability.py", "stats.py", "debug.py", "cli.py",
                "native/__init__.py", "ops/bruteforce.py", "utils/__init__.py",
                "parallel/mesh.py", "parallel/sharded.py", "parallel/multihost.py",
                "models/__init__.py"):
        assert pkg / rel in files, rel
    for f in files:
        assert not pat.search(f.read_text()), f"{f} imports JAX or the JAX package"
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, pgvectorscale_tpu_torch, pgvectorscale_tpu_torch.graph.iterate, "
         "pgvectorscale_tpu_torch.cli, pgvectorscale_tpu_torch.native, "
         "pgvectorscale_tpu_torch.debug, pgvectorscale_tpu_torch.stats, "
         "pgvectorscale_tpu_torch.durability, pgvectorscale_tpu_torch.ops.bruteforce, "
         "pgvectorscale_tpu_torch.utils, pgvectorscale_tpu_torch.parallel.mesh, "
         "pgvectorscale_tpu_torch.parallel.sharded, pgvectorscale_tpu_torch.parallel.multihost, "
         "pgvectorscale_tpu_torch.models, "
         "chip_smoke, profile_main_path; "
         "print(sorted(m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'jaxlib', 'pgvectorscale_tpu')))"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, check=True,
    )
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("dt", ["COSINE", "L2", "INNER_PRODUCT"])
def test_distance_functions_match_jax(rng, dt):
    """Full-precision distances within 1e-5 (float32 sums in two orders);
    cosine preprocessing leaves zero rows and unit rows as they are."""
    from pgvectorscale_tpu import distance as jdist
    from pgvectorscale_tpu.config import DistanceType as JaxDistance
    from pgvectorscale_tpu_torch import distance
    from pgvectorscale_tpu_torch.config import DistanceType

    a = rng.standard_normal((30, 24)).astype(np.float32)
    a[0] = 0.0
    a[1] /= np.linalg.norm(a[1])
    b = rng.standard_normal((30, 24)).astype(np.float32)
    jt, pt = JaxDistance[dt], DistanceType[dt]
    np.testing.assert_allclose(
        distance.preprocess_cosine(torch.from_numpy(a)).numpy(),
        np.asarray(jdist.preprocess_cosine(jnp.asarray(a))), rtol=1e-6, atol=1e-7,
    )
    np.testing.assert_array_equal(distance.preprocess_cosine(torch.from_numpy(a))[:2].numpy(), a[:2])
    np.testing.assert_allclose(
        distance.distance_matrix(torch.from_numpy(a), torch.from_numpy(b), pt).numpy(),
        np.asarray(jdist.distance_matrix(jnp.asarray(a), jnp.asarray(b), jt)), atol=1e-5, rtol=1e-6,
    )
    np.testing.assert_allclose(
        distance.pairwise_distance(torch.from_numpy(a), torch.from_numpy(b), pt).numpy(),
        np.asarray(jdist.pairwise_distance(jnp.asarray(a), jnp.asarray(b), jt)), atol=1e-5, rtol=1e-6,
    )
