"""The port's engine planner: the H100 gates and their derivation.

The tier names and the requested-engine semantics are the reference's;
the budgets are Hopper's (runtime/flags.py). At the Tiny-ImageNet
configuration the gates must send the leaves to `streaming` and the
level-1 nodes to `resident`, so the main path runs all three kernels.
"""
import numpy as np
import pytest

from repro.kernels import plans as JPlans
from repro_torch.configs import paper_kmedoid
from repro_torch.core.simulate import partition
from repro_torch.kernels import plans as TPlans
from repro_torch.kernels import rules as TR
from repro_torch.runtime import flags


def test_default_budgets_are_derived_for_the_h100():
    assert flags.fused_vmem_mb() * 2 ** 20 == 232_448       # 227 KB
    assert flags.resident_l2_mb() == 25.0                   # half of 50 MB
    assert flags.fused_cache_mb() == 80 * 1024 / 2          # half of 80 GB
    assert flags.fused_cache_dtype() == "auto"


def test_full_size_configuration_tiers():
    cfg = paper_kmedoid.TINY_IMAGENET
    counts = np.bincount(
        partition(cfg.n, cfg.num_machines, cfg.seed),
        minlength=cfg.num_machines)
    n_leaf = int(counts.max())
    leaf = TPlans.select_engine(TR.DIST_MIN, n_leaf, n_leaf,
                                cfg.feature_dim,
                                replicas=cfg.num_machines)
    assert leaf.engine == "mega_stream" and leaf.dtype == "float32"
    assert leaf.loop_block_n == TPlans.LOOP_BLOCK_MAX
    bk = cfg.branching * cfg.k
    for lvl in range(1, 6):
        nodes = cfg.num_machines // cfg.branching ** lvl
        node = TPlans.select_engine(TR.DIST_MIN, bk, bk, cfg.feature_dim,
                                    replicas=nodes)
        assert node.engine == "mega_resident", lvl


def test_resident_gate_needs_the_l2_share(monkeypatch):
    assert TPlans.resident_fits(400, 400, 64, TR.DIST_MIN, replicas=16)
    monkeypatch.setenv(flags.RESIDENT_L2_MB_ENV, "9")
    assert not TPlans.resident_fits(400, 400, 64, TR.DIST_MIN, replicas=16)
    assert TPlans.fused_plan(400, 400, 64, TR.DIST_MIN,
                             replicas=16)["tier"] == "streaming"


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_resident_gate_counts_the_storage_itemsize(dtype, monkeypatch):
    """A level-1 node batch whose f32 matrices bust the L2 share fits it
    in bf16 or int8: the gate counts the storage the steps keep (with
    int8's row scales), as the reference's resident_fits does."""
    n, reps = 400, 16
    f32 = TPlans.cache_bytes(n, n, "float32", reps)
    stored = TPlans.cache_bytes(n, n, dtype, reps)
    assert stored < f32
    monkeypatch.setenv(flags.RESIDENT_L2_MB_ENV, str((f32 - 1) / 2 ** 20))
    assert not TPlans.resident_fits(n, n, 64, TR.DIST_MIN, replicas=reps)
    assert TPlans.resident_fits(n, n, 64, TR.DIST_MIN, replicas=reps,
                                dtype=dtype)
    monkeypatch.setenv(flags.RESIDENT_L2_MB_ENV, str((stored - 1) / 2 ** 20))
    assert not TPlans.resident_fits(n, n, 64, TR.DIST_MIN, replicas=reps,
                                    dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("shape", [(400, 400, 16), (1_000, 900, 4),
                                   (3_284, 3_284, 1), (64, 20_000, 2),
                                   (2_500, 2_500, 1)])
def test_resident_gate_admits_what_it_admitted_at_4_bytes(shape, dtype):
    """Every shape the gate admitted when it counted 4 B an entry is
    admitted at every storage."""
    n, c, reps = shape
    share = flags.resident_l2_mb() * 2 ** 20
    old = (TPlans._resident_need(n, c, 64, TR.DIST_MIN)
           <= flags.fused_vmem_mb() * 2 ** 20 and reps * n * c * 4 <= share)
    new = TPlans.resident_fits(n, c, 64, TR.DIST_MIN, replicas=reps,
                               dtype=dtype)
    assert new or not old
    if dtype == "float32":
        assert new == old


@pytest.mark.parametrize("dtype,span", [("float32", 128), ("bfloat16", 256),
                                        ("int8", 256)])
def test_loop_scratch_bytes_at_the_leaves(dtype, span):
    """The streaming loop's chunk partials at the Tiny-ImageNet leaves
    (32 × 3,284², chunks of 32 rows): 103 f32 rows of the spans' 3,328
    columns a greedy, 43.9 MB beside the cache."""
    got = TPlans.loop_scratch_bytes(3_284, 3_284, dtype, 32,
                                    TPlans.FUSED_BLOCK_N)
    assert got == 32 * 103 * -(-3_284 // span) * span * 4 == 43_876_352


def test_resident_gate_needs_shared_memory():
    # a state row + mask wider than 227 KB cannot be one block's
    assert not TPlans.resident_fits(40_000, 20_000, 64, TR.DIST_MIN)
    assert TPlans._resident_need(10, 10, None, TR.DIST_MIN) is None


def test_cache_ladder_and_memory_capped_regime(monkeypatch):
    monkeypatch.setenv(flags.FUSED_CACHE_MB_ENV, "1")
    monkeypatch.setenv(flags.RESIDENT_L2_MB_ENV, "0")
    # 1 MB: 600×600 f32 busts it, bf16 (0.69 MB) fits
    assert TPlans.fused_plan(600, 600, 8, TR.DOT_MAX)["dtype"] == "bfloat16"
    assert TPlans.fused_plan(2000, 2000, 8, TR.DOT_MAX) is None
    assert TPlans.select_engine(TR.DOT_MAX, 2000, 2000, 8).engine == "step"
    monkeypatch.setenv(flags.FUSED_CACHE_DTYPE_ENV, "int8")
    assert TPlans.fused_plan(100, 100, 8, TR.DOT_MAX)["dtype"] == "int8"


def test_loop_tier_falls_back_to_fused_when_the_mask_overflows():
    c = 60_000                      # 240 KB of mask > 227 KB
    plan = TPlans.fused_plan(64, c, 8, TR.DOT_MAX)
    assert plan["tier"] == "fused" and plan["loop_block_n"] == 0


@pytest.mark.parametrize("requested", ["auto", "mega", "fused", "step"])
@pytest.mark.parametrize("sampling,constrained",
                         [(False, False), (True, False), (False, True)])
def test_requested_engine_semantics_match_reference(requested, sampling,
                                                    constrained):
    """With both planners on a resident-admitting shape, the requested
    engine and the sampling/constraint flags resolve the same way."""
    from repro.kernels import rules as JR
    kw = dict(requested=requested, sampling=sampling,
              constrained=constrained)
    want = JPlans.select_engine(JR.DOT_MAX, 64, 64, 16, backend="ref", **kw)
    got = TPlans.select_engine(TR.DOT_MAX, 64, 64, 16, **kw)
    assert got.engine == want.engine


def test_unknown_engine_raises():
    with pytest.raises(ValueError):
        TPlans.select_engine(TR.DOT_MAX, 8, 8, 4, requested="turbo")


def test_bucket_len_matches_reference():
    for size, tile in [(1, 8), (9, 8), (300, 128), (4096, 256)]:
        assert TPlans.bucket_len(size, tile) == JPlans.bucket_len(size, tile)


# ---------------------------------------------------------------------------
# the stream filter: both tiers' gates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,tier", [
    (150, "kernel"), (2_048, "kernel"), (2_049, "kernel"),
    (4_097, "kernel"), (8_193, "kernel"), (16_384, "kernel"),
    (100_000, "kernel"),
    (463_552, "kernel"), (463_553, "global"),
    (1_000_000, "global")])
def test_stream_tier_from_rows(n, tier):
    """A feature level's row is cut over the 8 blocks of a cluster at
    every n; the shared-memory tier ends where a block's chunk no longer
    fits the H100's 227 KB a block (beyond 463,552 f32 rows)."""
    for rule in (TR.DIST_MIN, TR.DOT_MAX):
        assert TPlans.stream_smem_bytes(n, 256, rule) == (
            4 * TPlans.stream_chunk(n) + TPlans.STREAM_STATIC_BYTES)
        assert TPlans.stream_tier(n, 256, rule) == tier
        assert TPlans.stream_plan(n, 256, 64, rule)["tier"] == tier


@pytest.mark.parametrize("n", [150, 2_048, 16_384, 100_000])
def test_stream_tier_follows_the_byte_gate(n, monkeypatch):
    """The gate is read at call time (how the CUDA tests force the
    device-memory tier): a block's chunk exactly at STREAM_SMEM_BYTES
    stays on chip, a byte less sends the level rows to device memory."""
    b, rule = 70, TR.DIST_MIN
    need = TPlans.stream_smem_bytes(n, b, rule)
    monkeypatch.setattr(TPlans, "STREAM_SMEM_BYTES", need)
    assert TPlans.stream_tier(n, b, rule) == "kernel"
    monkeypatch.setattr(TPlans, "STREAM_SMEM_BYTES", need - 1)
    assert TPlans.stream_tier(n, b, rule) == "global"
    assert TPlans.stream_plan(n, b, 64, rule)["tier"] == "global"


@pytest.mark.parametrize("n", [1, 5, 8, 150, 16_384, 100_000, 463_553])
def test_stream_chunks_cover_the_row(n):
    """The gain's 8 chunks cover the row, each a multiple of 4 entries
    (16-byte loads), none wider than needed."""
    ch = TPlans.stream_chunk(n)
    assert ch % 4 == 0 and 8 * ch >= n and 8 * (ch - 4) < n


@pytest.mark.parametrize("words,tier", [
    (45, "kernel"), (1_290, "kernel"), (8_192, "kernel"),
    (57_780, "kernel"), (57_781, "global")])
def test_stream_bitmap_gate(words, tier):
    """A bitmap level's words, its B gains and flags in one block (one
    block a level, no cluster): kosarak's 1,290 words and 8,192 on chip,
    the device-memory tier beyond ~57,800 words at B = 256."""
    assert TPlans.stream_tier(words, 256, TR.BITS_OR) == tier
    assert TPlans.stream_smem_bytes(words, 256, TR.BITS_OR) == (
        4 * (words + 256 + 64) + TPlans.STREAM_BITS_STATIC_BYTES)


def test_stream_static_bytes_are_the_kernels():
    """The decision block's static shared memory beside its chunk: (8
    window arrivals, 8 warps) float64 warp sums, (2, 8) chunk sums and 8
    warp maxima."""
    assert TPlans.STREAM_STATIC_BYTES == 672
    assert TPlans.stream_smem_bytes(16_384, 256, TR.DIST_MIN) == (
        4 * 2_048 + 672)


@pytest.mark.parametrize("shape,onchip", [
    ((16, 128, 1_290), True),       # kcover's level 1 (645 KB a node)
    ((32, 128, 1_290), True),       # the dispatcher's 32 lanes
    ((4, 256, 2_048), True),        # kdom's level 1 (2 MiB a node)
    ((1, 1_000, 2_048), False),     # past 16 blocks' shared memory
])
def test_resident_bits_plan(shape, onchip):
    """The bitmap resident loop's node batches are all admitted by the
    resident gate (25 MB), up to nodes whose words exceed what 16 blocks'
    shared memory can hold, which its device-memory tier then runs. The
    tier and cluster of each (greedy_loop.resident_bits_plan) come from
    the kernel's own plan: test_torch_cuda.py::test_cuda_resident_bits_plan."""
    b, c, w = shape
    assert TPlans.select_engine(TR.BITS_OR, w, c,
                                replicas=b).engine == "mega_resident"
    assert (4 * c * w > 16 * TPlans.RESIDENT_BITS_SMEM_BYTES) != onchip
