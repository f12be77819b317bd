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
