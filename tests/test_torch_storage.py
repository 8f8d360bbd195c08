"""The port's storage build (``build_distance="storage"``) against the JAX
package.

In a storage build every distance the build sees is a Hamming distance
on the SBQ codes, an integer, so ties break the same way in both
packages: the Hamming matrix, the bit unpack, the popcount-dot pair
distances, one wave step (brute-force or searched) and finalize must
equal JAX's exactly (tolerance: none).  A whole port build is held to the
invariants, to determinism and to the JAX storage build's recall@10
within 0.02 (the two packages train the quantizer with float32 sums in
different orders, so codes at a bucket edge may differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgvectorscale_tpu import DiskannIndex as JaxIndex
from pgvectorscale_tpu import IndexConfig as JaxConfig
from pgvectorscale_tpu import store as jstore
from pgvectorscale_tpu.config import DistanceType as JaxDistance
from pgvectorscale_tpu.graph import build as jbuild
from pgvectorscale_tpu.graph import prune as jprune
from pgvectorscale_tpu.ops.pallas_hamming import hamming_matrix_pallas
from pgvectorscale_tpu_torch import DiskannIndex, ExactIndex, IndexConfig, from_jax_state
from pgvectorscale_tpu_torch.config import DistanceType
from pgvectorscale_tpu_torch.graph import build, prune
from pgvectorscale_tpu_torch.io.datasets import synthetic_corpus
from pgvectorscale_tpu_torch.ops import hamming_matrix


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


@pytest.fixture(scope="module")
def storage_l2():
    """A JAX-built storage-mode L2 index over 900 x 32 rows, and its state
    carried into the port."""
    rng = np.random.default_rng(6)
    base = rng.standard_normal((900, 32)).astype(np.float32)
    jidx = JaxIndex.build(base, JaxConfig(num_dimensions=32, distance_type=JaxDistance.L2,
                                          build_distance="storage"))
    pidx = from_jax_state(jstore.to_host(jidx.arrays), jidx.sbq_stats, jidx.config,
                          device="cpu")
    return jidx, pidx


@pytest.mark.parametrize("q,n,w", [(8, 16, 1), (100, 130, 8), (128, 256, 48), (37, 200, 13)])
def test_hamming_matrix_plain_matches_pallas(rng, q, n, w):
    """The plain version equals the TPU kernel (interpret mode) at the TPU
    kernel tests' shapes and a ragged one."""
    qc, cc = _u32(rng, (q, w)), _u32(rng, (n, w))
    want = np.asarray(hamming_matrix_pallas(jnp.asarray(qc), jnp.asarray(cc), interpret=True))
    before = hamming_matrix.launches
    got = hamming_matrix.hamming_matrix(_i32(qc), _i32(cc))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert hamming_matrix.launches == before  # the CPU takes the plain version


@pytest.mark.parametrize("w,bits", [(3, 70), (48, 1536), (130, 4150)])
def test_unpack_pairwise_and_pair_distances_match_jax(rng, w, bits):
    """unpack_code_bits, pairwise_hamming_mxu and the codes branch of
    candidate_pair_distances (chunked over words above 4,096 bits) equal
    JAX's; the pair distances also equal a direct XOR-popcount."""
    codes = _u32(rng, (6, 9, w))
    jbits = jprune.unpack_code_bits(jnp.asarray(codes), bits)
    pbits = prune.unpack_code_bits(_i32(codes), bits)
    np.testing.assert_array_equal(pbits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(prune.pairwise_hamming_mxu(pbits).numpy(),
                                  np.asarray(jprune.pairwise_hamming_mxu(jbits)))

    cap = 40
    table = _u32(rng, (cap, w))
    cand = rng.integers(-1, cap, (5, 12)).astype(np.int32)
    jarr = jstore.empty_arrays(JaxConfig(num_dimensions=bits), cap)._replace(
        codes=jnp.asarray(table))
    want = np.asarray(jbuild.candidate_pair_distances(
        jarr, jnp.asarray(cand), use_codes=True, code_bits=bits,
        distance_type=JaxDistance.COSINE, trunc_dims=bits))
    parr = build.GraphArrays(vectors=torch.zeros((cap, 1)), codes=_i32(table),
                             adjacency=torch.zeros((cap, 1), dtype=torch.int32),
                             deleted=torch.zeros(cap, dtype=torch.bool), count=cap,
                             default_start=0,
                             node_labels=torch.zeros((cap, 0), dtype=torch.int32),
                             label_start_keys=torch.zeros(0, dtype=torch.int32),
                             label_start_ids=torch.zeros(0, dtype=torch.int32),
                             vec_scales=torch.ones(cap))
    got = build.candidate_pair_distances(
        parr, torch.from_numpy(cand), use_codes=True, code_bits=bits,
        distance_type=DistanceType.COSINE, trunc_dims=bits)
    np.testing.assert_array_equal(got.numpy(), want)
    # Bits past code_bits are not part of the code.
    tbits = np.unpackbits(table.view(np.uint8), axis=-1, bitorder="little")[:, :bits]
    c = tbits[np.maximum(cand, 0)]
    direct = (c[:, :, None, :] != c[:, None, :, :]).sum(-1)
    np.testing.assert_array_equal(got.numpy(), direct)


def test_brute_candidates_on_codes_match_jax(storage_l2):
    """The codes branch of the seed scan: Hamming matrix, prefix mask and
    a stable sort keep JAX's lowest-id-first order among ties."""
    jidx, pidx = storage_l2
    nodes = np.arange(0, 64, dtype=np.int32)
    want = jbuild._brute_candidates(
        jidx.arrays, jnp.asarray(nodes), jnp.asarray(500, jnp.int32), slice_rows=600,
        num_candidates=101, use_codes=True, distance_type=JaxDistance.L2, trunc_dims=32,
    )
    got = build._brute_candidates(
        pidx.arrays, torch.from_numpy(nodes), 500, slice_rows=600, num_candidates=101,
        distance_type=DistanceType.L2, trunc_dims=32, use_codes=True,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("brute", [False, True])
def test_storage_wave_step_and_finalize_match_jax(storage_l2, brute):
    """Re-inserting 128 rows as one storage wave (Hamming candidates,
    Hamming prune, backlinks, overflow prune), then finalize: equal
    adjacency."""
    jidx, pidx = storage_l2
    n = pidx.count
    wave = np.arange(300, 428, dtype=np.int32)
    cfg = jidx.config
    code_bits = cfg.dims_to_index * cfg.bits_per_dimension
    kw = dict(
        search_list_size=cfg.search_list_size,
        max_iters=jbuild._build_max_iters(cfg.search_list_size),
        brute=brute, slice_rows=n, alphas=jbuild._alpha_schedule(cfg.max_alpha),
        num_neighbors=cfg.num_neighbors, trunc_dims=cfg.dims_to_index,
        prune_use_codes=True, code_bits=code_bits,
    )
    jarrays = jidx.arrays
    jsnap = jbuild._edge_codes_onepass(jarrays.codes, jarrays.adjacency)
    want = jbuild._wave_step_jit(
        jarrays, jnp.asarray(wave), jnp.asarray(n, jnp.int32),
        snap_adjacency=None if brute else jarrays.adjacency,
        snap_edge_codes=None if brute else jsnap,
        use_codes=True, labeled=False, distance_type=JaxDistance.L2, **kw,
    )
    parrays = pidx.arrays
    got = build._wave_step(
        parrays, torch.from_numpy(wave), n,
        None if brute else parrays.adjacency.clone(),
        distance_type=DistanceType.L2, **kw,
    )
    np.testing.assert_array_equal(got.adjacency.numpy(), np.asarray(want.adjacency))
    assert int((got.adjacency[:n] != -1).sum(1).max()) > cfg.num_neighbors

    want_f = jbuild.finalize(want, jbuild.BuildContext(jidx.config))
    got_f = build.finalize(got, pidx._ctx)
    np.testing.assert_array_equal(got_f.adjacency.numpy(), np.asarray(want_f.adjacency))


def _recall(ids, gt):
    return float(np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(ids, gt)]))


def test_storage_build_invariants_and_recall_vs_jax():
    """2,000 x 64 cosine storage build: full reachability, degree <= r_max,
    identical on rebuild, recall@10 within 0.02 of the JAX storage
    build's."""
    base, queries = synthetic_corpus("glove", 2000, 60, seed=3)
    base, queries = base[:, :64].copy(), queries[:, :64].copy()
    config = IndexConfig(num_dimensions=64, build_distance="storage")
    pidx = DiskannIndex.build(base, config, device="cpu")
    n = pidx.count
    assert n == 2000
    assert bool(build.reachable_on_device(pidx.arrays)[:n].all())
    deg = (pidx.arrays.adjacency[:n] != -1).sum(1)
    assert int(deg.max()) <= config.max_neighbors_during_build and int(deg.min()) > 0
    again = DiskannIndex.build(base, config, device="cpu")
    assert torch.equal(again.arrays.adjacency, pidx.arrays.adjacency)

    jidx = JaxIndex.build(base, JaxConfig(num_dimensions=64, build_distance="storage"))
    gt = ExactIndex.build(base, config, device="cpu").search(queries, 10)[0].numpy()
    p_recall = _recall(pidx.search(queries, 10, device="cpu")[0].numpy(), gt)
    j_recall = _recall(jidx.search(queries, 10)[0], gt)
    print(f"storage recall@10 port {p_recall:.4f} jax {j_recall:.4f}")
    assert abs(p_recall - j_recall) <= 0.02
    assert p_recall >= 0.8
