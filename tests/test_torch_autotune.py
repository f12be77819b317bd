"""The port's measured-plan autotune cache and tuner, held against the
reference's (`tests/test_autotune.py`, `src/repro/kernels/plans.py`'s
cache, `src/repro/launch/autotune.py`).

Every test of the reference's file has its counterpart here (the
safety contract: a tuned entry wins only when its budget snapshot
matches the live knobs and its fields validate; a corrupt, stale,
version-bumped or malformed cache falls back to the static plan), and
the three port-side decisions are pinned: the key's last field is the
device type (a cuda entry never steers a CPU objective), the snapshot
holds the port's own knobs (a reference cache file is ignored), and an
entry is held to the live gates at the caller's replicas.
"""
import json

import numpy as np
import pytest
import torch

from repro.kernels import plans as JP
from repro.kernels import rules as JR
from repro.runtime import flags as JF

from repro_torch.core.functions import make_objective
from repro_torch.core.greedy import greedy
from repro_torch.data.synthetic import gen_images
from repro_torch.kernels import plans, rules
from repro_torch.launch import autotune
from repro_torch.runtime import flags

# f32 at 4,096² (64 MB) misses the 25 MB L2 share: the static plan
# streams; the int8 matrix (16 MB) is resident
KEY_KW = dict(n=4096, c=4096, d=64, device="cpu")


def _key(device="cpu"):
    return plans.autotune_key(rules.DOT_MAX, KEY_KW["n"], KEY_KW["c"],
                              KEY_KW["d"], device)


def _select(requested="auto", device="cpu", replicas=1):
    return plans.select_engine(rules.DOT_MAX, KEY_KW["n"], KEY_KW["c"],
                               KEY_KW["d"], requested=requested,
                               device=device, replicas=replicas)


def _entry(tier="resident", dtype="int8", bn=32, bl=0, budgets=None):
    return {"tier": tier, "block_n": bn, "loop_block_n": bl,
            "dtype": dtype,
            "budgets": budgets or plans.budget_snapshot()}


@pytest.fixture
def cache_path(tmp_path, monkeypatch):
    path = tmp_path / "at" / "plans.json"
    monkeypatch.setenv(flags.AUTOTUNE_CACHE_ENV, str(path))
    return path


def test_static_plan_of_the_key_shape():
    p = _select()
    assert (p.engine, p.tier, p.dtype) == ("mega_stream", "streaming",
                                           "float32")


def test_cache_off_by_default(monkeypatch):
    monkeypatch.delenv(flags.AUTOTUNE_CACHE_ENV, raising=False)
    assert flags.autotune_cache_path() is None
    assert plans.load_autotune_cache() == {}
    for off in ("", "0", "off", "none", "disabled"):
        monkeypatch.setenv(flags.AUTOTUNE_CACHE_ENV, off)
        assert flags.autotune_cache_path() is None


def test_round_trip_deterministic(cache_path):
    """save → select_engine returns the tuned plan; resaving identical
    entries produces identical bytes (sorted keys, atomic replace)."""
    plans.save_autotune_cache({_key(): _entry()})
    p = _select()
    assert (p.engine, p.tier, p.dtype) == ("mega_resident", "resident",
                                           "int8")
    blob = cache_path.read_bytes()
    plans.save_autotune_cache({_key(): _entry()})
    assert cache_path.read_bytes() == blob
    assert not cache_path.with_name("plans.json.tmp").exists()
    # merge keeps unrelated entries
    other = plans.autotune_key(rules.DIST_MIN, 256, 256, 32, "cpu")
    plans.save_autotune_cache({other: _entry(tier="streaming",
                                             dtype="float32", bn=32,
                                             bl=256)})
    assert set(plans.load_autotune_cache()) == {_key(), other}


def test_corrupt_cache_falls_back_without_crashing(cache_path):
    plans.save_autotune_cache({_key(): _entry()})
    assert _select().engine == "mega_resident"
    cache_path.write_text("{this is not json")
    p = _select()                          # the static plan takes over
    assert (p.engine, p.dtype) == ("mega_stream", "float32")


def test_version_mismatch_ignored(cache_path):
    cache_path.parent.mkdir(parents=True, exist_ok=True)
    cache_path.write_text(json.dumps(
        {"version": plans.AUTOTUNE_VERSION + 1,
         "entries": {_key(): _entry()}}))
    assert plans.load_autotune_cache() == {}
    assert _select().dtype == "float32"


@pytest.mark.parametrize("knob,value", [
    (flags.FUSED_VMEM_MB_ENV, "0.2"),
    (flags.FUSED_CACHE_MB_ENV, "20000"),
    (flags.RESIDENT_L2_MB_ENV, "24")])
def test_stale_budget_snapshot_ignored(cache_path, monkeypatch, knob, value):
    plans.save_autotune_cache({_key(): _entry()})
    assert _select().engine == "mega_resident"
    # the entry was measured under the default knobs; a live knob moved
    # on — the entry is ignored and the static plan takes over
    monkeypatch.setenv(knob, value)
    assert (_select().engine, _select().dtype) == ("mega_stream",
                                                   "float32")


@pytest.mark.parametrize("bad", [
    {"tier": "warp", "block_n": 1, "loop_block_n": 1, "dtype": "int8"},
    _entry(dtype="int4"),
    _entry(tier="streaming", bn=0, bl=0),          # no chunk
    _entry(tier="streaming", bn="x", bl=256),
    _entry(tier="streaming", bn=32, bl=0),         # no loop block
    _entry(tier="fused", bn=64),                   # not a ladder chunk
    _entry(tier="resident", dtype="uint32"),       # a bitmap storage
    "not-a-dict"], ids=lambda b: str(b)[:40])
def test_malformed_entries_ignored(cache_path, bad):
    if isinstance(bad, dict):
        bad = dict(bad, budgets=plans.budget_snapshot())
    plans.save_autotune_cache({_key(): bad})
    assert _select().dtype == "float32", bad


def test_forced_dtype_conflict_rejects_entry(cache_path, monkeypatch):
    plans.save_autotune_cache({_key(): _entry(dtype="int8")})
    monkeypatch.setenv(flags.FUSED_CACHE_DTYPE_ENV, "f32")
    assert _select().dtype == "float32"
    monkeypatch.setenv(flags.FUSED_CACHE_DTYPE_ENV, "int8")
    assert _select().dtype == "int8"


def test_tuned_step_entry_wins(cache_path):
    plans.save_autotune_cache(
        {_key(): {"tier": "step", "budgets": plans.budget_snapshot()}})
    assert _select().engine == "step"


def test_plan_override_outranks_cache(cache_path):
    plans.save_autotune_cache({_key(): _entry(dtype="int8")})
    with plans.plan_override({"tier": "streaming", "block_n": 16,
                              "loop_block_n": 256, "dtype": "float32"}):
        p = _select()
    assert (p.engine, p.dtype, p.block_n) == ("mega_stream", "float32", 16)
    assert _select().dtype == "int8"       # restored on exit


def test_tuner_end_to_end_preserves_selection(cache_path):
    """The real tuner on a tiny pool: writes a usable cache entry AND
    the greedy run under the tuned cache picks the same ids as the
    step engine (the tuner's identity gate, observed end to end)."""
    n, d, k = 64, 32, 4
    entries = autotune.tune(["facility"], [(n, d, k)], device="cpu",
                            reps=1, dtypes=("float32", "int8"),
                            blocks_per_tier=1, verbose=False)
    assert cache_path.exists() and len(entries) == 1
    (key, e), = entries.items()
    assert key.endswith("|cpu")
    assert e["budgets"] == plans.budget_snapshot()
    assert e["speedup"] >= 1.0             # the winner is never slower
    assert e["dispatches"] >= 1 and e["static_dispatches"] >= 1
    pay = torch.as_tensor(gen_images(n, d, classes=8, seed=0))
    ids = torch.arange(n)
    valid = torch.ones(n, dtype=torch.bool)
    obj = make_objective("facility", device="cpu")
    tuned = greedy(obj, ids, pay, valid, k, engine="auto")
    with plans.plan_override(dict(autotune.STEP_PLAN)):
        base = greedy(obj, ids, pay, valid, k, engine="auto")
    assert torch.equal(tuned.ids, base.ids)


# ---------------------------------------------------------------------------
# the port's own decisions
# ---------------------------------------------------------------------------

_KEY_SHAPES = [
    ("facility", 192, 192, 32), ("facility", 4096, 4096, 64),
    ("kmedoid", 3125, 3125, 12_288), ("kmedoid", 400, 400, 12_288),
    ("kmedoid", 3284, 3284, 12_288), ("coverage", 1290, 30_938, None),
    ("coverage", 16, 300, None)]


@pytest.mark.parametrize("name,n,c,d", _KEY_SHAPES)
def test_autotune_key_matches_reference_up_to_the_device(name, n, c, d):
    rule = {"facility": rules.DOT_MAX, "kmedoid": rules.DIST_MIN,
            "coverage": rules.BITS_OR}[name]
    jrule = {"facility": JR.DOT_MAX, "kmedoid": JR.DIST_MIN,
             "coverage": JR.BITS_OR}[name]
    for dev in ("cuda", "cpu"):
        got = plans.autotune_key(rule, n, c, d, dev)
        want = JP.autotune_key(jrule, n, c, d, "interpret")
        assert got.rsplit("|", 1) == [want.rsplit("|", 1)[0], dev]


def test_reference_cache_file_is_ignored(tmp_path, monkeypatch):
    """A file the reference's tuner wrote — even with an entry under the
    very key string the port looks up — carries the reference's budget
    snapshot, so the port takes its static plan, without a crash."""
    path = tmp_path / "reference.json"
    monkeypatch.setenv(JF.AUTOTUNE_CACHE_ENV, str(path))
    jentry = {"tier": "resident", "block_n": 0, "loop_block_n": 0,
              "dtype": "int8", "budgets": JP.budget_snapshot()}
    JP.save_autotune_cache({
        JP.autotune_key(JR.DOT_MAX, 4096, 4096, 64, "interpret"): jentry,
        JP.autotune_key(JR.DOT_MAX, 4096, 4096, 64, "cpu"): jentry,
        JP.autotune_key(JR.DOT_MAX, 4096, 4096, 64, "cuda"): jentry})
    monkeypatch.setenv(flags.AUTOTUNE_CACHE_ENV, str(path))
    assert _key() in plans.load_autotune_cache()
    assert plans._tuned_plan(rules.DOT_MAX, 4096, 4096, 64, "cpu") is None
    for dev in ("cpu", "cuda"):
        p = _select(device=dev)
        assert (p.engine, p.dtype) == ("mega_stream", "float32")


def test_live_gates_refuse_an_entry_at_stacked_replicas(cache_path):
    """A Tiny-ImageNet leaf tuned int8-resident alone (3,125² × 1 B =
    9.8 MB) is looked up by the 32 stacked leaves of a tree (313 MB, past
    the 25 MB L2 share): the entry is ignored there, the static plan
    stands, and the same entry is taken at replicas = 1."""
    n, d = 3125, 12_288
    key = plans.autotune_key(rules.DIST_MIN, n, n, d, "cuda")
    assert key == plans.autotune_key(rules.DIST_MIN, 3284, 3284, d, "cuda")
    plans.save_autotune_cache({key: _entry(dtype="int8")})
    one = plans.select_engine(rules.DIST_MIN, n, n, d, device="cuda")
    assert (one.engine, one.dtype) == ("mega_resident", "int8")
    stacked = plans.select_engine(rules.DIST_MIN, 3284, 3284, d,
                                  replicas=32, device="cuda")
    static = plans.fused_plan(3284, 3284, d=d, rule=rules.DIST_MIN,
                              replicas=32)
    assert (stacked.engine, stacked.tier, stacked.dtype) == (
        "mega_stream", static["tier"], static["dtype"])
    assert plans._tuned_plan(rules.DIST_MIN, 3284, 3284, d, "cuda",
                             replicas=32) is None


def test_cuda_entry_does_not_steer_a_cpu_objective(cache_path):
    plans.save_autotune_cache({_key("cuda"): _entry(dtype="int8")})
    assert _select(device="cuda").dtype == "int8"
    assert _select(device="cpu").dtype == "float32"
    obj = make_objective("facility", device="cpu")
    ground = torch.zeros((1, KEY_KW["n"], KEY_KW["d"]))
    state = obj.init_state(ground, torch.ones((1, KEY_KW["n"]),
                                              dtype=torch.bool))
    p = obj._plan(state, ground, "auto")
    assert (p.engine, p.dtype) == ("mega_stream", "float32")


def test_serve_plan_and_plan_tree_reach_the_cache(cache_path):
    """serve_plan and plan_tree plan through select_engine, so a tuned
    entry reaches both (a tuned 'step' entry takes a query off the
    batched path, and a tree's node stage off the resident loop)."""
    n, d = 512, 32
    assert plans.serve_plan(rules.DOT_MAX, n, n, d, device="cpu") is not None
    step = {"tier": "step", "budgets": plans.budget_snapshot()}
    plans.save_autotune_cache(
        {plans.autotune_key(rules.DOT_MAX, n, n, d, "cpu"): step})
    assert plans.serve_plan(rules.DOT_MAX, n, n, d, device="cpu") is None
    assert plans.serve_plan(rules.DOT_MAX, n, n, d,
                            device="cuda") is not None
    k = 200
    plans.save_autotune_cache(
        {plans.autotune_key(rules.DIST_MIN, 2 * k, 2 * k, 768, "cpu"): step})
    tp_cpu = plans.plan_tree(rules.DIST_MIN, 8192, 768, k, 32, device="cpu")
    tp_cuda = plans.plan_tree(rules.DIST_MIN, 8192, 768, k, 32,
                              device="cuda")
    assert tp_cuda.node_plan.engine == "mega_resident"
    assert tp_cpu.node_plan.engine == "step"


_CAND_SHAPES = [
    ("facility", 192, 32, 0), ("facility", 4096, 64, 0),
    ("kmedoid", 3125, 12_288, 0), ("kmedoid", 400, 12_288, 0),
    ("coverage", 30_938, 0, 41_270), ("coverage", 300, 0, 500)]


@pytest.mark.parametrize("name,n,d,universe", _CAND_SHAPES)
def test_every_candidate_passes_validation(cache_path, name, n, d,
                                           universe):
    obj = make_objective(name, universe=universe or n, device="cpu")
    rule = obj.rule
    nn, dd = (obj.words, None) if rule.is_bitmap else (n, d)
    cands = autotune.candidate_plans(rule, nn, n, dd, blocks_per_tier=3)
    assert cands[0] == autotune.STEP_PLAN
    static = plans.fused_plan(nn, n, d=dd, rule=rule)
    assert static in cands
    key = plans.autotune_key(rule, nn, n, dd, "cpu")
    for fp in cands:
        plans.save_autotune_cache(
            {key: dict(fp, budgets=plans.budget_snapshot())})
        assert plans._tuned_plan(rule, nn, n, dd, "cpu") == fp, fp
        p = plans.select_engine(rule, nn, n, dd, device="cpu")
        assert (p.tier or "step", p.dtype) == (fp["tier"], fp["dtype"])


def test_candidate_space_is_the_ports():
    """At a Tiny-ImageNet leaf the static ladder streams f32; the tuner
    also offers the bf16 and int8 resident loops (which fit the L2 share
    alone), and every cached storage's streaming and fused tiers at the
    chunk sizes of the ladder (32, 16, 8 rows)."""
    cands = autotune.candidate_plans(rules.DIST_MIN, 3125, 3125, 12_288,
                                     blocks_per_tier=3)
    tiers = {(c["tier"], c["dtype"]) for c in cands}
    assert ("resident", "float32") not in tiers
    assert {("resident", "bfloat16"), ("resident", "int8"),
            ("streaming", "float32"), ("fused", "int8")} <= tiers
    assert sorted({c["block_n"] for c in cands
                   if c["tier"] == "fused"}) == [8, 16, 32]
    assert plans.block_n_ladder("float32") == [32, 16, 8]
    # no resident loop for 32 stacked leaves
    stacked = autotune.candidate_plans(rules.DIST_MIN, 3284, 3284, 12_288,
                                       replicas=32)
    assert not [c for c in stacked if c["tier"] == "resident"]


def test_tuner_smoke_cli_writes_a_cache_select_engine_takes(tmp_path,
                                                            monkeypatch):
    out = tmp_path / "smoke.json"
    entries = autotune.main(["--smoke", "--device", "cpu",
                             "--out", str(out)])
    (key, e), = entries.items()
    assert key == plans.autotune_key(rules.DOT_MAX, 192, 192, 32, "cpu")
    monkeypatch.setenv(flags.AUTOTUNE_CACHE_ENV, str(out))
    p = plans.select_engine(rules.DOT_MAX, 192, 192, 32, device="cpu")
    assert ((p.tier or "step"), p.dtype) == (e["tier"], e["dtype"])


def test_tuner_bitmap_shape_keeps_the_selection(cache_path):
    entries = autotune.tune(["coverage"], [(300, 0, 6)], device="cpu",
                            universe=500, reps=1, verbose=False)
    (key, e), = entries.items()
    assert key.startswith("coverage|") and e["dtype"] in ("uint32",
                                                          "float32")
    obj = make_objective("coverage", universe=500, device="cpu")
    ids, pay, valid = autotune._pool("coverage", 300, 0, 500)
    tuned = greedy(obj, ids, pay, valid, 6)
    with plans.plan_override(dict(autotune.STEP_PLAN)):
        base = greedy(obj, ids, pay, valid, 6)
    assert torch.equal(tuned.ids, base.ids)
    assert np.isfinite(float(tuned.value))
