"""The streaming subsystem against the reference, on the CPU.

Both packages get the same numpy inputs; the reference runs on its `ref`
backend and, for the kernel bodies, in Pallas interpret mode:

  * the sieve filter (`ref.stream_sieve` / `ops.stream_filter`) against
    `repro.kernels.ops.stream_filter` over two chained batches — kmedoid,
    facility and kcover, with and without knapsack costs, and with the
    int8 ground forced: admits, counts, exponents and expired levels
    equal, rows, values and m within the reference test's own 1e-4
    (tests/test_streaming.py);
  * the pieces: `level_gains`, `sieve_admit`, `sieve_reanchor` (the first
    anchor moving the window down, a full-window jump), `num_levels`,
    `gen_stream`'s orders, the planner's gate;
  * whole runs: `stream_select` on every order of every objective,
    `SlidingSieve` expiry and query slot, `stream_select_continuous`
    with the port's `accumulate_one_level` merge, and a stream stopped
    in the reference and carried over by `convert.sieve_state_to_torch`
    — equal ids;
  * the int8-ground gains (B2q) against `gains_pallas(…, gscale=)` in
    interpret mode, and the step engine quantizing its ground once per
    greedy with the reference's selections.

On these inputs no admission of either package lies within rounding of
its threshold, so the selections must be equal outright (the P1 rule of
ROADMAP §C, a split allowed at a float64-proven tie, is not needed).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.functions import make_objective as j_make
from repro.core.greedy import greedy as j_greedy
from repro.data import synthetic as JSyn
from repro.kernels import ops as JOps
from repro.kernels import ref as JRef
from repro.kernels import rules as JR
from repro.kernels.pairwise import gains_pallas
from repro.streaming import (SieveStreamer as JStreamer,
                             SlidingSieve as JWindow,
                             stream_select as j_select,
                             stream_select_continuous as j_continuous)
from repro.streaming.sieve import num_levels as j_num_levels
from repro_torch import convert
from repro_torch.core.functions import make_objective as t_make
from repro_torch.core.greedy import greedy as t_greedy
from repro_torch.data import synthetic as TSyn
from repro_torch.kernels import counters, ops, plans
from repro_torch.kernels import ref as TRef
from repro_torch.kernels import rules as TR
from repro_torch.kernels import stream_filter as TS
from repro_torch.runtime import flags
from repro_torch.streaming import (SieveStreamer, SlidingSieve, num_levels,
                                   stream_select, stream_select_continuous)
from repro_torch.streaming import driver as t_driver

K = 8
UNIVERSE = 384
EPS_LOG = math.log1p(0.1)
RULES = {"kmedoid": (JR.DIST_MIN, TR.DIST_MIN),
         "facility": (JR.DOT_MAX, TR.DOT_MAX),
         "kcover": (JR.BITS_OR, TR.BITS_OR)}


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _objectives(name):
    if name == "kcover":
        return (j_make("kcover", universe=UNIVERSE, backend="ref"),
                t_make("kcover", universe=UNIVERSE, device="cpu"))
    return j_make(name, backend="ref"), t_make(name, device="cpu")


def _streams(name, order="shuffled", n=256, batch=64, seed=0):
    kw = dict(d=24, universe=UNIVERSE, batch=batch, order=order, seed=seed)
    return JSyn.gen_stream(name, n, **kw), TSyn.gen_stream(name, n, **kw)


def _valid_ids(sol):
    return _np(sol.ids)[_np(sol.valid)]


# ---------------------------------------------------------------------------
# the sieve filter, both packages, two chained batches
# ---------------------------------------------------------------------------


def _filter_inputs(name, seed=0, n=60, d=24, b=33, l=16, words=12):
    rng = np.random.default_rng(seed)
    if name == "kcover":
        ground = None
        row0 = np.zeros(words, np.uint32)
        batches = []
        for _ in range(2):
            x = rng.integers(0, 2 ** 32, (b, words), dtype=np.uint32)
            x &= rng.integers(0, 2 ** 32, (b, words), dtype=np.uint32)
            batches.append((x, rng.random(b) > 0.15))
    else:
        ground = rng.normal(size=(n, d)).astype(np.float32)
        row0 = (np.linalg.norm(ground, axis=1).astype(np.float32)
                if name == "kmedoid" else np.zeros(n, np.float32))
        batches = [((0.5 + i) * rng.normal(size=(b, d))).astype(np.float32)
                   for i in range(2)]
        batches = [(x, rng.random(b) > 0.15) for x in batches]
    costs = [rng.uniform(0.5, 2.0, b).astype(np.float32) for _ in range(2)]
    return ground, row0, batches, costs, l


@pytest.mark.parametrize("cost", [False, True])
@pytest.mark.parametrize("name,quant", [
    ("kmedoid", False), ("kmedoid", True), ("facility", False),
    ("facility", True), ("kcover", False)])
def test_stream_filter_matches_reference(name, quant, cost, monkeypatch):
    """Bitmaps have no int8 ground: kcover runs unquantized only."""
    if quant:
        monkeypatch.setenv("REPRO_FUSED_CACHE_DTYPE", "int8")
        monkeypatch.setenv(flags.FUSED_CACHE_DTYPE_ENV, "int8")
    jr, tr = RULES[name]
    ground, row0, batches, costs, l = _filter_inputs(name, seed=3)
    k, budget = 5, 4.0
    out = {}
    for pkg in ("ref", "port"):
        rows = np.tile(row0[None], (l, 1))
        values = np.zeros(l, np.float32)
        counts = np.zeros(l, np.int32)
        expos = np.arange(l, dtype=np.int32)
        m = np.float32(0.0)
        spent = np.zeros(l, np.float32)
        for (x, valid), c in zip(batches, costs):
            cost_kw = (dict(costs=c, spent=spent, budget=budget) if cost
                       else {})
            if pkg == "ref":
                res = JOps.stream_filter(
                    None if ground is None else jnp.asarray(ground),
                    jnp.asarray(x), jnp.asarray(rows), jnp.asarray(row0),
                    jnp.asarray(values), jnp.asarray(counts),
                    jnp.asarray(expos), jnp.asarray(m), jnp.asarray(valid),
                    k, EPS_LOG, jr, backend="ref",
                    **{a: jnp.asarray(v) for a, v in cost_kw.items()})
            else:
                res = ops.stream_filter(
                    None if ground is None else _t(ground),
                    convert.to_torch(x, "cpu"),
                    convert.to_torch(rows, "cpu"),
                    convert.to_torch(row0, "cpu"), _t(values), _t(counts),
                    _t(expos), _t(m), _t(valid), k, EPS_LOG, tr,
                    **{a: _t(v) for a, v in cost_kw.items()})
            res = [np.asarray(r if isinstance(r, jax.Array)
                              else r.numpy()) for r in res]
            rows, values, counts = res[0], res[1], res[2]
            expos, m = res[4], res[5]
            if cost:
                spent = res[7]
            out.setdefault(pkg, []).append(res)
    for r, t in zip(out["ref"], out["port"]):
        assert int(r[2].sum()) > 0                   # something admitted
        for i in (2, 3, 4, 6):                       # exact
            np.testing.assert_array_equal(r[i].astype(np.int64),
                                          t[i].astype(np.int64))
        rows_t = t[0].view(np.uint32) if name == "kcover" else t[0]
        np.testing.assert_allclose(r[0], rows_t, rtol=1e-4, atol=1e-4)
        for i in (1, 5):
            np.testing.assert_allclose(r[i], t[i], rtol=1e-4, atol=1e-4)
        if cost:
            np.testing.assert_allclose(r[7], t[7], rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("name", ["kmedoid", "facility"])
def test_stream_ground_is_what_the_filter_stores(name, dtype, monkeypatch):
    """ops.stream_ground alone decides the stream's ground storage: the
    int8 rung quantizes as quantize_ground, f32 stays; a CPU ground
    carries no norms. Handed to the filter with its scales it gives the
    bits of the filter quantizing itself, and norms passed beside a
    ground the call would quantize raise (they are not the rows the
    slab reads)."""
    monkeypatch.setenv(flags.FUSED_CACHE_DTYPE_ENV,
                       "int8" if dtype == "int8" else "f32")
    _, tr = RULES[name]
    ground, row0, batches, _, l = _filter_inputs(name, seed=4)
    g = _t(ground)
    stored, gscale, gnorm = ops.stream_ground(g, dtype, tr)
    assert gnorm is None
    if dtype == "int8":
        q, scale = ops.quantize_ground(g)
        assert torch.equal(stored, q)
        assert torch.equal(gscale, scale.reshape(-1))
    else:
        assert gscale is None and torch.equal(stored, g)
    x, valid = batches[0]

    def state():
        return (_t(np.tile(row0[None], (l, 1))), _t(row0),
                torch.zeros(l), torch.zeros(l, dtype=torch.int32),
                torch.arange(l, dtype=torch.int32), torch.zeros(()),
                _t(valid), 5, EPS_LOG, tr)

    want = ops.stream_filter(g, _t(x), *state())
    got = ops.stream_filter(stored, _t(x), *state(), gscale=gscale)
    assert int(want[2].sum()) > 0
    for w, o in zip(want, got):
        assert torch.equal(w, o)
    if dtype == "int8":
        with pytest.raises(ValueError, match="gnorm"):
            ops.stream_filter(g, _t(x), *state(), gnorm=TS.ground_norms(g))


@pytest.mark.parametrize("cost", [False, True])
@pytest.mark.parametrize("name", ["kmedoid", "facility", "kcover"])
def test_stream_filter_plain_matches_interpret_kernel(name, cost):
    """The plain version (canonical shapes, the CPU path of the kernel
    wrapper) against stream_filter_pallas in interpret mode, one
    batch."""
    jr, tr = RULES[name]
    ground, row0, batches, costs, l = _filter_inputs(name, seed=5)
    (x, valid), c = batches[0], costs[0]
    k = 5
    cost_j = (dict(costs=jnp.asarray(c), spent=jnp.zeros(l),
                   budget=jnp.float32(4.0)) if cost else {})
    want = JOps.stream_filter(
        None if ground is None else jnp.asarray(ground), jnp.asarray(x),
        jnp.tile(jnp.asarray(row0)[None], (l, 1)), jnp.asarray(row0),
        jnp.zeros(l), jnp.zeros(l, jnp.int32),
        jnp.arange(l, dtype=jnp.int32), jnp.float32(0.0), jnp.asarray(valid),
        k, EPS_LOG, jr, backend="interpret", **cost_j)
    r0 = convert.to_torch(row0, "cpu")
    cost_t = (dict(costs=_t(c)[None], spent=torch.zeros(1, l),
                   budget=4.0) if cost else {})
    got = TS.stream_filter(
        None if ground is None else _t(ground),
        convert.to_torch(x, "cpu")[None], r0.expand(1, l, -1).contiguous(),
        r0, torch.zeros(1, l), torch.zeros(1, l, dtype=torch.int32),
        torch.arange(l, dtype=torch.int32)[None], torch.zeros(1),
        _t(valid)[None], k, EPS_LOG, tr, **cost_t)
    got = [g[0].numpy() for g in got]
    want = [np.asarray(w) for w in want]
    for i in (2, 3, 4, 6):
        np.testing.assert_array_equal(want[i].astype(np.int64),
                                      got[i].astype(np.int64))
    rows_t = got[0].view(np.uint32) if name == "kcover" else got[0]
    np.testing.assert_allclose(want[0], rows_t, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(want[1], got[1], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(want[5], got[5], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["kmedoid", "facility", "kcover"])
def test_level_gains_matches_reference(name):
    jr, tr = RULES[name]
    rng = np.random.default_rng(1)
    if name == "kcover":
        rows = rng.integers(0, 2 ** 32, (8, 12), dtype=np.uint32)
        col = rng.integers(0, 2 ** 32, (1, 12), dtype=np.uint32)
    else:
        rows = rng.normal(size=(8, 50)).astype(np.float32)
        col = rng.normal(size=(1, 50)).astype(np.float32)
    want = np.asarray(JR.level_gains(jnp.asarray(rows), jnp.asarray(col),
                                     jr))
    got = TR.level_gains(convert.to_torch(rows, "cpu"),
                         convert.to_torch(col, "cpu"), tr).numpy()
    assert got.shape == want.shape == (8, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("cost", [False, True])
def test_sieve_admit_matches_reference(cost):
    rng = np.random.default_rng(2)
    l, k = 24, 5
    gains = rng.uniform(-0.1, 2.0, (l, 1)).astype(np.float32)
    gains[:3] = 0.0
    values = rng.uniform(0, 3, (l, 1)).astype(np.float32)
    counts = rng.integers(0, k + 1, (l, 1)).astype(np.int32)
    vgrid = np.exp(np.arange(l, dtype=np.float32)[:, None]
                   * np.float32(EPS_LOG)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if cost:
        spent = rng.uniform(0, 5, (l, 1)).astype(np.float32)
        kw_j = dict(cost=jnp.float32(1.25), spent=jnp.asarray(spent),
                    budget=jnp.float32(4.0))
        kw_t = dict(cost=torch.tensor(1.25), spent=_t(spent), budget=4.0)
    for ok in (True, False):
        want = np.asarray(JRef.sieve_admit(
            jnp.asarray(gains), jnp.asarray(values), jnp.asarray(counts),
            jnp.asarray(vgrid), jnp.bool_(ok), k, **kw_j))
        got = TRef.sieve_admit(_t(gains), _t(values), _t(counts), _t(vgrid),
                               torch.tensor(ok), k, **kw_t).numpy()
        np.testing.assert_array_equal(got, want)
        assert ok == bool(want.any())


@pytest.mark.parametrize("case", ["first_down", "slide", "full_jump",
                                  "all_invalid"])
def test_sieve_reanchor_matches_reference(case):
    """The first anchor may move the window DOWN (raw gains < 1); a
    later m slides it, refilling expired slots above the old top; a huge
    m jumps the whole window (every slot expires, refilled from low);
    invalid arrivals leave m alone."""
    rng = np.random.default_rng(4)
    l, n, b = 16, 10, 6
    rows = rng.normal(size=(l, n)).astype(np.float32)
    row0 = np.zeros((1, n), np.float32)
    values = rng.uniform(0, 1, (l, 1)).astype(np.float32)
    counts = rng.integers(0, 4, (l, 1)).astype(np.int32)
    expos = np.arange(l, dtype=np.int32)[:, None] + 3
    singles = {"first_down": 0.05, "slide": 2.5, "full_jump": 1e6,
               "all_invalid": 9.0}[case]
    singletons = (singles * rng.uniform(0.5, 1.0, (1, b))).astype(
        np.float32)
    bvalid = np.ones((1, b), np.float32)
    if case == "all_invalid":
        bvalid[:] = 0.0
    m_max = np.float32(0.0 if case == "first_down" else 1.0)
    want = JRef.sieve_reanchor(
        jnp.asarray(singletons), jnp.asarray(bvalid), jnp.asarray(rows),
        jnp.asarray(row0), jnp.asarray(values), jnp.asarray(counts),
        jnp.asarray(expos), jnp.asarray(m_max), EPS_LOG)
    got = TRef.sieve_reanchor(
        _t(singletons[0]), _t(bvalid[0]), _t(rows), _t(row0[0]),
        _t(values[:, 0]), _t(counts[:, 0]), _t(expos[:, 0]),
        torch.tensor(m_max), EPS_LOG)
    w = [np.asarray(x) for x in want]
    np.testing.assert_array_equal(got[0].numpy(), w[0])
    np.testing.assert_array_equal(got[1].numpy(), w[1][:, 0])
    np.testing.assert_array_equal(got[2].numpy(), w[2][:, 0])
    np.testing.assert_array_equal(got[3].numpy(), w[3][:, 0])
    np.testing.assert_array_equal(got[4].numpy(), w[4])
    np.testing.assert_array_equal(got[5].numpy(), w[5][:, 0])
    expired = int(w[5].sum())
    if case == "first_down":
        assert int(w[3].min()) < 3              # the window moved down
    if case == "full_jump":
        assert expired == l                     # every slot refilled
    if case == "all_invalid":
        assert expired == 0 and float(w[4]) == 1.0


def test_num_levels_matches_reference():
    for k in (1, 2, 5, 8, 64, 200, 1000):
        for eps in (0.01, 0.05, 0.1, 0.25, 0.5):
            assert num_levels(k, eps) == j_num_levels(k, eps)
            assert num_levels(k, eps) % 8 == 0
    assert num_levels(200, 0.1) == 72 and num_levels(64, 0.1) == 56


@pytest.mark.parametrize("name", ["kcover", "kmedoid", "facility"])
def test_gen_stream_matches_reference(name):
    for order in ("shuffled", "adversarial", "drift"):
        js, ts = _streams(name, order, n=96, batch=32, seed=1)
        np.testing.assert_array_equal(js.order, ts.order)
        np.testing.assert_array_equal(js.payloads, ts.payloads)
        for (ji, jp, jv), (ti, tp, tv) in zip(js, ts):
            np.testing.assert_array_equal(ji, ti.numpy())
            np.testing.assert_array_equal(jv, tv.numpy())
            tp = tp.numpy().view(np.uint32) if name == "kcover" \
                else tp.numpy()
            np.testing.assert_array_equal(jp, tp)


def test_singleton_proxy_chunks_match_one_shot(monkeypatch):
    x = JSyn.gen_images(70, 16, classes=4, seed=3)
    for name in ("kmedoid", "facility"):
        whole = TSyn._singleton_proxy(name, x)
        np.testing.assert_array_equal(whole,
                                      JSyn._singleton_proxy(name, x))
        monkeypatch.setattr(TSyn, "PROXY_CHUNK", 16)
        chunked = TSyn._singleton_proxy(name, x)
        monkeypatch.undo()
        np.testing.assert_allclose(chunked, whole, rtol=1e-5)


def test_stream_plan_gate(monkeypatch):
    """The kernel at the chip's shapes (the k-medoid stream: 16,384 and
    100,000 evaluation rows of 12,288 features, a level's row over a
    thread-block cluster; kosarak: 1,290 words), int8 under the forced
    rung, the global-memory tier beyond what a cluster's shared memory
    holds (the H100's 227 KB a block, 8 blocks)."""
    assert plans.STREAM_SMEM_BYTES == 232_448
    assert plans.stream_plan(16_384, 256, 12_288, TR.DIST_MIN) == {
        "tier": "kernel", "dtype": "float32"}
    assert plans.stream_plan(1_290, 256, None, TR.BITS_OR) == {
        "tier": "kernel", "dtype": "uint32"}
    monkeypatch.setenv(flags.FUSED_CACHE_DTYPE_ENV, "int8")
    assert plans.stream_plan(16_384, 256, 12_288, TR.DIST_MIN) == {
        "tier": "kernel", "dtype": "int8"}
    assert plans.stream_plan(1_290, 256, None, TR.BITS_OR)["dtype"] == \
        "uint32"
    assert plans.stream_plan(60_000, 256, 64, TR.DOT_MAX)["tier"] == \
        "kernel"
    assert plans.stream_plan(500_000, 256, 64, TR.DOT_MAX)["tier"] == \
        "global"
    assert plans.stream_plan(7_000, 256, None, TR.BITS_OR)["tier"] == \
        "kernel"
    assert plans.stream_plan(60_000, 256, None, TR.BITS_OR)["tier"] == \
        "global"
    monkeypatch.delenv(flags.FUSED_CACHE_DTYPE_ENV)
    assert plans.stream_plan(100_000, 256, 12_288, TR.DIST_MIN) == {
        "tier": "kernel", "dtype": "float32"}
    monkeypatch.setattr(plans, "STREAM_SMEM_BYTES", 50_000)
    assert plans.stream_plan(100_000, 256, 12_288, TR.DIST_MIN)["tier"] == \
        "global"


def test_plain_tier_gives_the_kernel_tier_selections(monkeypatch):
    """A stream squeezed onto the global-memory tier selects as on the
    kernel tier (on the CPU both run the plain version; the tier is
    reported; on the card the two tiers agree bit for bit,
    tests/test_torch_cuda.py)."""
    js, ts = _streams("facility", n=128, batch=32)
    obj = t_make("facility", device="cpu")
    full, info = stream_select_continuous(obj, ts, K, lanes=1,
                                          merge_every=2,
                                          ground=_t(ts.payloads))
    assert info["tier"] == "kernel"
    monkeypatch.setattr(plans, "STREAM_SMEM_BYTES", 100)
    squeezed, info = stream_select_continuous(obj, ts, K, lanes=1,
                                              merge_every=2,
                                              ground=_t(ts.payloads))
    assert info["tier"] == "global"
    assert torch.equal(full.ids, squeezed.ids)


@pytest.mark.parametrize("name", ["kmedoid", "facility", "kcover"])
def test_cpu_runs_the_plain_filter_at_any_size(name):
    """States beyond what shared memory holds (470,000 f32 evaluation
    rows, past a cluster of 8 blocks; 60,000 bitmap words) plan
    'global'; on the CPU ops.stream_filter still runs the plain version
    on them (a call, no launch), equal to the reference's oracle path."""
    jr, tr = RULES[name]
    ground, row0, batches, _, l = _filter_inputs(
        name, seed=6, n=470_000, d=4, b=16, l=8, words=60_000)
    n, b = row0.shape[0], batches[0][0].shape[0]
    d = None if ground is None else ground.shape[1]
    assert plans.stream_plan(n, b, d, tr)["tier"] == "global"
    x, valid = batches[0]
    k = 3
    state = (np.tile(row0[None], (l, 1)), row0, np.zeros(l, np.float32),
             np.zeros(l, np.int32), np.arange(l, dtype=np.int32),
             np.float32(0.0))
    want = JOps.stream_filter(
        None if ground is None else jnp.asarray(ground), jnp.asarray(x),
        *(jnp.asarray(v) for v in state), jnp.asarray(valid), k, EPS_LOG,
        jr, backend="ref")
    counters.reset()
    got = ops.stream_filter(
        None if ground is None else _t(ground), convert.to_torch(x, "cpu"),
        *(convert.to_torch(v, "cpu") for v in state[:2]),
        *(_t(v) for v in state[2:]), _t(valid), k, EPS_LOG, tr)
    tag = "stream_filter[coverage]" if name == "kcover" else "stream_filter"
    assert counters.snapshot()[tag] == {"calls": 1, "launches": 0}
    want = [_np(r) for r in want]
    got = [r.numpy() for r in got]
    assert int(want[2].sum()) > 0
    for i in (2, 3, 4, 6):
        np.testing.assert_array_equal(want[i].astype(np.int64),
                                      got[i].astype(np.int64))
    rows = got[0].view(np.uint32) if name == "kcover" else got[0]
    np.testing.assert_allclose(want[0], rows, rtol=1e-4, atol=1e-4)
    for i in (1, 5):
        np.testing.assert_allclose(want[i], got[i], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# whole streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", ["shuffled", "adversarial", "drift"])
@pytest.mark.parametrize("name", ["kcover", "kmedoid", "facility"])
def test_stream_select_matches_reference(name, order):
    js, ts = _streams(name, order)
    jo, to = _objectives(name)
    ground = None if name == "kcover" else js.payloads
    want = j_select(jo, js, K, ground=None if ground is None
                    else jnp.asarray(ground), backend="ref")
    counters.reset()
    got = stream_select(to, ts, K, ground=None if ground is None
                        else _t(ground))
    calls = counters.snapshot()
    tag = "stream_filter[coverage]" if name == "kcover" else "stream_filter"
    assert calls[tag]["calls"] == 4 and calls[tag]["launches"] == 0
    np.testing.assert_array_equal(_np(want.ids), got.ids.numpy())
    np.testing.assert_array_equal(_np(want.valid), got.valid.numpy())
    np.testing.assert_allclose(float(want.value), float(got.value),
                               rtol=1e-5)
    assert int(want.evals) == int(got.evals)


def test_window_expiry_and_query_slot_match_reference():
    """No element outside the last W arrivals appears in the window's
    answer, which equals the reference's batch after batch (ids, and the
    checkpoint slot it answers from)."""
    window, stride, batch = 64, 32, 16
    js, ts = _streams("facility", "drift", n=288, batch=batch, seed=7)
    jo, to = _objectives("facility")
    jwin = JWindow(JStreamer(jo, K, ground=jnp.asarray(js.payloads),
                             backend="ref"), window, stride)
    twin = SlidingSieve(SieveStreamer(to, K, ground=_t(ts.payloads)),
                        window, stride)
    jst, tst, arrived = None, twin.init(), []
    for (ji, jp, jv), (ti, tp, tv) in zip(js, ts):
        jst = jwin.init(jnp.asarray(jp)) if jst is None else jst
        jst = jwin.process_batch(jst, jnp.asarray(ji), jnp.asarray(jp),
                                 jnp.asarray(jv))
        tst = twin.process_batch(tst, ti, tp, tv)
        arrived.extend(ji.tolist())
        np.testing.assert_array_equal(np.asarray(jst.ages), tst.ages)
        want, got = jwin.query(jst), twin.query(tst)
        np.testing.assert_array_equal(_valid_ids(want),
                                      got.ids[got.valid].numpy())
        assert set(got.ids[got.valid].tolist()) <= set(arrived[-window:])


def test_window_roll_resets_a_slot_to_a_fresh_sieve():
    js, ts = _streams("facility", n=64, batch=16, seed=3)
    _, to = _objectives("facility")
    streamer = SieveStreamer(to, K, ground=_t(ts.payloads))
    win = SlidingSieve(streamer, 32, 16)
    ws = win.init()
    ids, pay, valid = next(iter(ts))
    valid = valid.clone()
    valid[8:] = False
    ws = win.process_batch(ws, ids, pay, valid)
    rolled = int(np.nonzero(ws.ages == 0)[0][0])
    fresh = streamer.init()
    for f in ("rows", "values", "counts", "expos", "m_max", "ids",
              "payloads"):
        assert torch.equal(getattr(ws.states, f)[rolled],
                           getattr(fresh, f)), f


@pytest.mark.parametrize("name", ["kcover", "facility"])
def test_process_batch_consumes_the_state(name):
    """A state handed to process_batch is consumed on every device: its
    id and payload slots are updated in place (on the card the kernel
    writes only the admitted rows) and become the new state's, each
    admitted id beside its own arrival's payload."""
    _, ts = _streams(name, n=128, batch=32, seed=4)
    _, to = _objectives(name)
    streamer = SieveStreamer(to, K, ground=None if name == "kcover"
                             else _t(ts.payloads))
    ids, pay, valid = next(iter(ts))
    old = streamer.init(pay)
    new = streamer.process_batch(old, ids, pay, valid)
    for f in ("ids", "payloads"):
        assert getattr(new, f).data_ptr() == getattr(old, f).data_ptr(), f
        assert torch.equal(getattr(new, f), getattr(old, f)), f
    slots = old.ids >= 0
    assert slots.any()
    row_of = {int(i): j for j, i in enumerate(ids.tolist())}
    rows = torch.as_tensor([row_of[int(i)] for i in old.ids[slots]])
    stored = TR.to_words(pay) if name == "kcover" else pay
    assert torch.equal(old.payloads[slots], stored[rows])


@pytest.mark.parametrize("name", ["kcover", "kmedoid", "facility"])
def test_continuous_matches_reference(name):
    """4 lanes, b = 2, a merge every 2 batches: the merged ids, every
    merge's value and the batch count equal the reference's (its merge
    is accumulate_levels under nested vmap; the port's runs
    accumulate_one_level level by level over the stacked lanes)."""
    js, ts = _streams(name, "drift", n=320, batch=64, seed=5)
    jo, to = _objectives(name)
    ground = None if name == "kcover" else js.payloads
    want, jinfo = j_continuous(jo, js, K, lanes=4, branching=2,
                               merge_every=2,
                               ground=None if ground is None
                               else jnp.asarray(ground), backend="ref")
    got, tinfo = stream_select_continuous(
        to, ts, K, lanes=4, branching=2, merge_every=2,
        ground=None if ground is None else _t(ground))
    np.testing.assert_array_equal(_np(want.ids), got.ids.numpy())
    np.testing.assert_allclose(jinfo["merges"], tinfo["merges"], rtol=1e-4)
    assert jinfo["batches"] == tinfo["batches"] == 5
    assert tinfo["tree"] == (4, 2, 2) and tinfo["tier"] == "kernel"
    assert all(b >= a for a, b in zip(tinfo["merges"], tinfo["merges"][1:]))


@pytest.mark.parametrize("name", ["kcover", "facility"])
def test_stream_stopped_in_reference_continues_in_port(name):
    """A stream stopped after two batches in the reference continues
    identically in both packages from the converted SieveState (and the
    window state converts with its ages)."""
    js, ts = _streams(name, n=256, batch=64, seed=9)
    jo, to = _objectives(name)
    ground = None if name == "kcover" else js.payloads
    jstr = JStreamer(jo, K, ground=None if ground is None
                     else jnp.asarray(ground), backend="ref")
    tstr = SieveStreamer(to, K, ground=None if ground is None
                         else _t(ground))
    jb, tb = list(js), list(ts)
    jst = jstr.init(jnp.asarray(jb[0][1]))
    for ids, pay, valid in jb[:2]:
        jst = jstr.process_batch(jst, jnp.asarray(ids), jnp.asarray(pay),
                                 jnp.asarray(valid))
    tst = convert.sieve_state_to_torch(jst, "cpu")
    for (ji, jp, jv), (ti, tp, tv) in zip(jb[2:], tb[2:]):
        jst = jstr.process_batch(jst, jnp.asarray(ji), jnp.asarray(jp),
                                 jnp.asarray(jv))
        tst = tstr.process_batch(tst, ti, tp, tv)
    back = convert.sieve_state_to_torch(jst, "cpu")
    for f in ("counts", "expos", "ids", "payloads", "evals"):
        assert torch.equal(getattr(tst, f), getattr(back, f)), f
    want, got = jstr.solution(jst), tstr.solution(tst)
    np.testing.assert_array_equal(_np(want.ids), got.ids.numpy())
    jwin = JWindow(jstr, 128, 64)
    wst = jwin.process_batch(jwin.init(), *(jnp.asarray(a) for a in jb[0]))
    tw = convert.window_state_to_torch(wst, "cpu")
    np.testing.assert_array_equal(tw.ages, np.asarray(wst.ages))
    assert tw.seen == 64 and tw.states.ids.shape[0] == 3


def test_unported_drivers_raise_naming_the_roadmap(tmp_path):
    """Since the fault-tolerance slice every driver option of the
    reference is ported: checkpointing writes steps, ``resume`` without
    a checkpoint runs the stream whole, a supervisor runs the merges.
    What still raises names what it needs: the supervised merge refuses
    a mesh, stream_select_distributed needs a TreeMesh."""
    from repro_torch.checkpoint import manager
    from repro_torch.runtime.supervisor import SelectionSupervisor
    _, ts = _streams("kcover", n=64)
    _, to = _objectives("kcover")
    plain = stream_select(to, ts, K)
    d = str(tmp_path / "ck")
    got = stream_select(to, ts, K, ckpt_dir=d, ckpt_every=1)
    assert manager.list_steps(d) == [1]
    assert torch.equal(got.ids, plain.ids)
    assert torch.equal(stream_select(to, ts, K, resume=True).ids, plain.ids)
    sol, info = stream_select_continuous(
        to, ts, K, supervisor=SelectionSupervisor(ckpt_dir=""))
    assert [e["kind"] for e in info["events"]] == ["merge"]
    with pytest.raises(ValueError, match="stacked"):
        t_driver.ContinuousSelector(to, K, mesh=object(),
                                    supervisor=SelectionSupervisor(""))
    # ported (tests/test_torch_distributed.py): it needs a TreeMesh
    with pytest.raises(TypeError, match="TreeMesh"):
        t_driver.stream_select_distributed(to, ts, K, None, ("x",))


@pytest.mark.parametrize("name", ["facility", "kmedoid", "kcover"])
def test_stream_checkpoint_resume_bitexact(tmp_path, name):
    """tests/test_streaming.py's resume test, in both packages: a stream
    stopped after two batches (checkpointed every batch) and resumed
    equals the whole run bit for bit (the port's value too, where the
    reference allows rtol 1e-6), and the reference's ids; a checkpoint
    the REFERENCE wrote resumes in the port to the same ids."""
    js, ts = _streams(name, n=192, batch=48)
    jo, to = _objectives(name)
    jg = None if name == "kcover" else jnp.asarray(js.payloads)
    tg = None if name == "kcover" else _t(ts.payloads)
    full = stream_select(to, ts, K, ground=tg)
    half = list(ts.batches())[:2]
    d = str(tmp_path / "t")
    stream_select(to, half, K, ground=tg, ckpt_dir=d, ckpt_every=1)
    resumed = stream_select(to, ts, K, ground=tg, ckpt_dir=d, resume=True)
    for f in ("ids", "payloads", "valid", "value", "evals"):
        assert torch.equal(getattr(resumed, f), getattr(full, f)), f
    want = j_select(jo, js, K, ground=jg, backend="ref")
    np.testing.assert_array_equal(full.ids.numpy(), _np(want.ids))
    jd = str(tmp_path / "j")
    j_select(jo, list(js.batches())[:2], K, ground=jg, backend="ref",
             ckpt_dir=jd, ckpt_every=1)
    crossed = stream_select(to, ts, K, ground=tg, ckpt_dir=jd, resume=True)
    np.testing.assert_array_equal(crossed.ids.numpy(), _np(want.ids))
    np.testing.assert_array_equal(crossed.valid.numpy(), _np(want.valid))
    np.testing.assert_allclose(float(crossed.value), float(want.value),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# the int8 ground of the per-step gains (B2q)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["kmedoid", "facility"])
def test_gains_int8_ground_plain_matches_interpret_kernel(name):
    jr, tr = RULES[name]
    n, c, d = 256, 128, 128
    x = JSyn.gen_images(n + c, d, classes=6, seed=12)
    g, cd = x[:n], x[n:]
    q, scale = ops.quantize_ground(_t(g))                     # (1, N)
    jq, jscale = JR.quantize_rows(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    deq = TR.dequant(q, scale)
    row = TR.update_row(deq, TR.empty_row(deq, torch.ones(n, dtype=bool),
                                          tr), deq[3], tr)
    want = np.asarray(gains_pallas(jq, jnp.asarray(row.numpy())[None],
                                   jnp.asarray(cd), jr, interpret=True,
                                   gscale=jscale))
    valid = torch.ones(1, c, dtype=torch.bool)
    got = ops.gains(q[None], row[None], _t(cd)[None], valid, tr,
                    gscale=scale[None])[0].numpy()
    assert got.shape == (c,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_step_engine_quantizes_once_and_matches_reference(monkeypatch):
    """Under a forced int8 rung the step engine quantizes its ground once
    per greedy (not per step) and selects as the reference's step
    engine; on small-integer features every entry is exact in both."""
    monkeypatch.setenv("REPRO_FUSED_CACHE_DTYPE", "int8")
    monkeypatch.setenv(flags.FUSED_CACHE_DTYPE_ENV, "int8")
    x = np.random.default_rng(8).integers(-3, 4, (96, 16)).astype(
        np.float32)
    calls = []
    real = ops.quantize_ground

    def counting(ground):
        calls.append(tuple(ground.shape))
        return real(ground)

    monkeypatch.setattr(ops, "quantize_ground", counting)
    for name in ("kmedoid", "facility"):
        jo, to = _objectives(name)
        calls.clear()
        want = j_greedy(jo, jnp.arange(96, dtype=jnp.int32),
                        jnp.asarray(x), jnp.ones(96, bool), 10,
                        engine="step")
        got = t_greedy(to, torch.arange(96), _t(x),
                       torch.ones(96, dtype=torch.bool), 10, engine="step")
        assert calls == [(1, 96, 16)]             # once for the greedy
        np.testing.assert_array_equal(_np(want.ids), got.ids.numpy())
        np.testing.assert_allclose(float(want.value), float(got.value),
                                   rtol=1e-5)
