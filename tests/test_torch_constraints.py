"""The port's constraints, its gains and fused-step kernel modules, and its
constrained and stochastic greedy, against the reference.

  * constraints (PartitionMatroid, Knapsack, Composite, KnapsackSpec and
    their conversion from the reference's objects): masks, states and
    bound costs equal to the reference's on the same numpy inputs — a
    knapsack budget tie is decided in f32 exactly as jnp decides it;
  * kernels B2 and B3: the plain versions the wrappers run on the CPU
    against `gains_pallas` / `fused_step_pallas` in interpret mode at
    tile-padded shapes. B3 is fed the same matrix: rows equal bit for
    bit, the pick equal, the gain within 1e-5 relative. B2 builds its
    matrix apart from XLA: each gain within the reordering bound
    4·√N·eps·|g| (kernels/parity.py) plus its column's summed entry
    differences (a gain part is 1-Lipschitz in the entry); bitmap gains
    are integers and must be equal;
  * constrained `greedy` (knapsack, partition matroid, both) and
    stochastic `greedy` (the reference's own draws injected as
    `cand_idx`) on the fused and step engines against the reference's
    `greedy` on its 'ref' backend: equal ids, valid and evals, values
    within 1e-5 (1e-4 where the reference's own engines differ: the
    kmedoid cache's expansion against the step engine's direct
    difference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import constraints as JC
from repro.core import greedy as JG
from repro.core.functions import make_objective as j_make
from repro.data.synthetic import gen_images, gen_kcover, pack_bitmaps
from repro.kernels import rules as JR
from repro.kernels.fused_step import fused_step_pallas
from repro.kernels.pairwise import gains_pallas
from repro_torch import convert
from repro_torch.core import constraints as TC
from repro_torch.core import greedy as TG
from repro_torch.core.functions import make_objective as t_make
from repro_torch.kernels import fused_step as TF
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise as TP
from repro_torch.kernels import parity
from repro_torch.kernels import rules as TR

FEATURE_RULES = {
    "kmedoid": (JR.DIST_MIN, TR.DIST_MIN),
    "facility": (JR.DOT_MAX, TR.DOT_MAX),
    "satcover": (JR.sat_sum(2.0), TR.sat_sum(2.0)),
    "graphcut": (JR.graph_cut(0.5), TR.graph_cut(0.5)),
    "mmr": (JR.mmr(0.3, 2.0), TR.mmr(0.3, 2.0)),
}


def _costs(n, seed, lo=0.5, hi=2.0):
    """The reference tests' cost recipe (tests/test_constraints.py)."""
    return np.random.default_rng(seed).uniform(lo, hi, n).astype(np.float32)


# ---------------------------------------------------------------------------
# constraints
# ---------------------------------------------------------------------------


def test_partition_matroid_matches_reference():
    rng = np.random.default_rng(0)
    b, n, c = 3, 40, 4
    cats = rng.integers(0, c, (b, n)).astype(np.int32)
    caps = np.array([2, 1, 3, 2], np.int32)
    jm = JC.PartitionMatroid(jnp.asarray(cats), jnp.asarray(caps))
    tm = TC.PartitionMatroid(torch.as_tensor(cats), torch.as_tensor(caps))
    jstate = jax.vmap(lambda cc: JC.PartitionMatroid(
        cc, jnp.asarray(caps)).init_state())(jnp.asarray(cats))
    tstate = tm.init_state()
    for _ in range(6):
        pick = rng.integers(0, n, b)
        want_mask = jax.vmap(lambda cc, s: JC.PartitionMatroid(
            cc, jnp.asarray(caps)).feasible_mask(s))(jnp.asarray(cats),
                                                     jstate)
        np.testing.assert_array_equal(tm.feasible_mask(tstate).numpy(),
                                      np.asarray(want_mask))
        jstate = jax.vmap(lambda cc, s, i: JC.PartitionMatroid(
            cc, jnp.asarray(caps)).update(s, i))(jnp.asarray(cats), jstate,
                                                 jnp.asarray(pick))
        tstate = tm.update(tstate, torch.as_tensor(pick))
        np.testing.assert_array_equal(tstate.numpy(), np.asarray(jstate))
    del jm


def test_uniform_matroid_matches_reference():
    want = JC.uniform_matroid(9, 4)
    got = TC.uniform_matroid(9, 4)
    np.testing.assert_array_equal(got.categories.numpy(),
                                  np.asarray(want.categories))
    np.testing.assert_array_equal(got.capacities.numpy(),
                                  np.asarray(want.capacities))


def test_knapsack_decides_budget_ties_as_reference():
    """spent + cost ≤ budget at and around exact ties, and at sums whose
    f32 rounding lands on the budget: the same mask as jnp."""
    budget = np.float32(100.0)
    spent = np.array([99.75, 99.0, 100.0 - 2 ** -17, 0.0, 97.3],
                     np.float32)
    base = budget - spent
    costs = np.stack([base, np.nextafter(base, np.float32(np.inf)),
                      np.nextafter(base, np.float32(0)),
                      base + np.float32(2 ** -20), np.full(5, 0.25,
                                                           np.float32)],
                     -1).astype(np.float32)
    got = TC.Knapsack(torch.as_tensor(costs),
                      torch.tensor(100.0)).feasible_mask(
                          torch.as_tensor(spent))
    for i in range(5):
        want = JC.Knapsack(jnp.asarray(costs[i]),
                           jnp.float32(100.0)).feasible_mask(
                               jnp.float32(spent[i]))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    # the tie cases do decide differently from the unrounded sum
    assert got[:, 0].all() and got[:, 2].all()


def test_knapsack_spent_accumulates_as_reference():
    costs = _costs(50, 4)
    picks = np.random.default_rng(5).integers(0, 50, 30)
    jk = JC.Knapsack(jnp.asarray(costs), jnp.float32(20.0))
    tk = TC.Knapsack(torch.as_tensor(costs)[None], torch.tensor(20.0))
    js, ts = jk.init_state(), tk.init_state()
    for p in picks:
        js = jk.update(js, jnp.int32(p))
        ts = tk.update(ts, torch.tensor([int(p)]))
        assert float(ts[0]) == float(js)
        np.testing.assert_array_equal(tk.feasible_mask(ts)[0].numpy(),
                                      np.asarray(jk.feasible_mask(js)))


def test_knapsack_spec_bind_matches_reference():
    costs = _costs(64, 1)
    ids = np.array([[3, -1, 60, 7], [0, 63, -1, -1]], np.int32)
    jspec = JC.KnapsackSpec(jnp.asarray(costs), 5.0)
    tspec = TC.KnapsackSpec(torch.as_tensor(costs), 5.0)
    got = tspec.bind(torch.as_tensor(ids, dtype=torch.int64))
    for i in range(2):
        want = jspec.bind(jnp.asarray(ids[i]))
        np.testing.assert_array_equal(got.costs[i].numpy(),
                                      np.asarray(want.costs))
        assert float(got.budget) == float(want.budget)


def test_composite_matches_reference():
    n = 30
    costs = _costs(n, 2)
    cats = (np.arange(n) % 3).astype(np.int32)
    caps = np.array([2, 2, 1], np.int32)
    jcon = JC.Composite((JC.Knapsack(jnp.asarray(costs), jnp.float32(4.0)),
                         JC.PartitionMatroid(jnp.asarray(cats),
                                             jnp.asarray(caps))))
    tcon = convert.constraint_to_torch(jcon, "cpu").lift()
    js, ts = jcon.init_state(), tcon.init_state()
    for p in (4, 7, 10, 2):
        np.testing.assert_array_equal(tcon.feasible_mask(ts)[0].numpy(),
                                      np.asarray(jcon.feasible_mask(js)))
        js = jcon.update(js, jnp.int32(p))
        ts = tcon.update(ts, torch.tensor([p]))
    assert float(ts[0][0]) == float(js[0])
    np.testing.assert_array_equal(ts[1][0].numpy(), np.asarray(js[1]))


def test_constraint_conversion_keeps_kind_and_values():
    costs = _costs(16, 3)
    spec = convert.constraint_to_torch(
        JC.KnapsackSpec(jnp.asarray(costs), 2.5), "cpu")
    assert isinstance(spec, TC.KnapsackSpec) and spec.budget == 2.5
    np.testing.assert_array_equal(spec.costs.numpy(), costs)
    pm = convert.constraint_to_torch(JC.uniform_matroid(5, 2), "cpu")
    assert isinstance(pm, TC.PartitionMatroid)
    assert pm.categories.dtype == torch.int64
    with pytest.raises(TypeError):
        convert.constraint_to_torch(object(), "cpu")


# ---------------------------------------------------------------------------
# kernel modules B2 and B3 against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


def _live_row(jr, g, seed):
    """A mid-run state row: the empty row with three elements folded."""
    row = JR.empty_row(jnp.asarray(g), jnp.ones(g.shape[0], bool), jr)
    for j in np.random.default_rng(seed).integers(0, g.shape[0], 3):
        row = JR.update_row(jnp.asarray(g), row, jnp.asarray(g[j]), jr)
    return np.array(row)


@pytest.mark.parametrize("name", sorted(FEATURE_RULES))
def test_gains_plain_matches_interpret_kernel(name):
    jr, tr = FEATURE_RULES[name]
    n, c, d = 256, 128, 128
    x = gen_images(n + c, d, classes=6, seed=11)
    g, cd = x[:n], x[n:]
    row = _live_row(jr, g, 1)
    valid = np.arange(c) % 7 != 3
    want = np.asarray(gains_pallas(jnp.asarray(g), jnp.asarray(row)[None],
                                   jnp.asarray(cd), jr, interpret=True))
    want = np.where(valid, want, -np.inf)
    got = ops.gains(torch.as_tensor(g)[None], torch.as_tensor(row)[None],
                    torch.as_tensor(cd)[None], torch.as_tensor(valid)[None],
                    tr)[0].numpy()
    np.testing.assert_array_equal(np.isfinite(got), valid)
    m_j = np.asarray(JR.pairwise_block(jnp.asarray(g), jnp.asarray(cd),
                                       jr.pairwise), np.float64)
    m_t = TP.pairwise_plain(torch.as_tensor(g), torch.as_tensor(cd),
                            tr.pairwise).double().numpy()
    tol = (parity.gain_rtol(n) * np.abs(want[valid])
           + np.abs(m_j - m_t).sum(0)[valid] + 1e-30)
    assert np.all(np.abs(got[valid] - want[valid]) <= tol)


def test_coverage_gains_plain_matches_interpret_kernel():
    rng = np.random.default_rng(3)
    c, w = 128, 512
    bits = rng.integers(0, 2 ** 32, (c, w), dtype=np.uint32)
    cov = rng.integers(0, 2 ** 32, w, dtype=np.uint32)
    valid = np.arange(c) % 3 != 0
    want = np.asarray(gains_pallas(jnp.zeros((8, 128), jnp.float32),
                                   jnp.asarray(cov)[None], jnp.asarray(bits),
                                   JR.BITS_OR, interpret=True))
    got = ops.gains(None, convert.to_torch(cov, "cpu")[None],
                    convert.to_torch(bits, "cpu")[None],
                    torch.as_tensor(valid)[None], TR.BITS_OR)[0].numpy()
    np.testing.assert_array_equal(got[valid], want[valid])
    assert np.all(np.isneginf(got[~valid]))


@pytest.mark.parametrize("prev", [-1, 37])
@pytest.mark.parametrize("name", sorted(FEATURE_RULES))
def test_fused_step_plain_matches_interpret_kernel(name, prev):
    jr, tr = FEATURE_RULES[name]
    n, c, d = 256, 128, 32
    x = gen_images(n + c, d, classes=6, seed=12)
    g, cd = x[:n], x[n:]
    mat = np.array(JR.matrix_block(jnp.asarray(g), jnp.asarray(cd), jr))
    row = _live_row(jr, g, 2)
    mask = (np.random.default_rng(4).random(c) > 0.25).astype(np.float32)
    w_row, w_best, w_gain = fused_step_pallas(
        jnp.asarray(mat), jnp.asarray(row), jnp.asarray(mask),
        jnp.int32(prev), jr, block_n=128, interpret=True)
    g_row, g_best, g_gain = TF.fused_step(
        torch.as_tensor(mat)[None], torch.as_tensor(row)[None],
        torch.as_tensor(mask)[None], torch.tensor([prev]), tr)
    np.testing.assert_array_equal(g_row[0].numpy(), np.asarray(w_row))
    assert int(g_best[0]) == int(w_best)
    np.testing.assert_allclose(float(g_gain[0]), float(w_gain), rtol=1e-5)


def test_fused_step_plain_all_masked_matches_interpret_kernel():
    n, c = 256, 128
    x = gen_images(n + c, 16, classes=4, seed=13)
    mat = np.array(JR.matrix_block(jnp.asarray(x[:n]), jnp.asarray(x[n:]),
                                     JR.DIST_MIN))
    row = np.linalg.norm(x[:n], axis=1).astype(np.float32)
    _, w_best, w_gain = fused_step_pallas(
        jnp.asarray(mat), jnp.asarray(row), jnp.zeros(c, jnp.float32),
        jnp.int32(-1), JR.DIST_MIN, block_n=256, interpret=True)
    _, g_best, g_gain = TF.fused_step(
        torch.as_tensor(mat)[None], torch.as_tensor(row)[None],
        torch.zeros(1, c), torch.tensor([-1]), TR.DIST_MIN)
    assert int(g_best[0]) == int(w_best) == 0
    assert float(g_gain[0]) == float(w_gain) == -np.inf


# ---------------------------------------------------------------------------
# constrained and stochastic greedy against the reference
# ---------------------------------------------------------------------------


def _pool(name, n=120, d=24, seed=2):
    if name == "kcover":
        bits = pack_bitmaps(gen_kcover(n, 256, seed=seed), 256)
        return np.arange(n, dtype=np.int32), bits, np.ones(n, bool)
    x = gen_images(n, d, classes=6, seed=seed)
    return np.arange(n, dtype=np.int32), x, (np.arange(n) % 11) != 0


def _objectives(name):
    kw = {"universe": 256} if name == "kcover" else {}
    return (j_make(name, backend="ref", **kw),
            t_make(name, device="cpu", **kw))


def _constraints(kind, n, seed=3):
    costs = _costs(n, seed)
    cats = (np.arange(n) % 4).astype(np.int32)
    caps = np.array([3, 1, 2, 2], np.int32)
    knap = JC.Knapsack(jnp.asarray(costs), jnp.float32(6.0))
    part = JC.PartitionMatroid(jnp.asarray(cats), jnp.asarray(caps))
    return {"knapsack": knap, "matroid": part,
            "composite": JC.Composite((knap, part))}[kind]


def _hold(got, want, name, engine):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert int(got.evals) == int(want.evals)
    tol = 1e-4 if name == "kmedoid" and engine != "step" else 1e-5
    assert abs(float(got.value) - float(want.value)) <= tol * max(
        1.0, abs(float(want.value)))


@pytest.mark.parametrize("kind", ["knapsack", "matroid", "composite"])
@pytest.mark.parametrize("engine", ["auto", "fused", "step"])
@pytest.mark.parametrize("name", ["kmedoid", "facility", "kcover"])
def test_constrained_greedy_matches_reference(name, engine, kind):
    ids, x, valid = _pool(name)
    jobj, tobj = _objectives(name)
    jcon = _constraints(kind, len(ids))
    want = JG.greedy(jobj, jnp.asarray(ids), jnp.asarray(x),
                     jnp.asarray(valid), 12, engine=engine, constraint=jcon)
    got = TG.greedy(tobj, torch.as_tensor(ids), convert.to_torch(x, "cpu"),
                    torch.as_tensor(valid), 12, engine=engine,
                    constraint=convert.constraint_to_torch(jcon, "cpu"))
    _hold(got, want, name, engine)
    if kind != "matroid":
        sel = got.ids.numpy()[got.valid.numpy()]
        assert _costs(len(ids), 3)[sel].sum() <= 6.0


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("engine", ["auto", "fused", "step"])
@pytest.mark.parametrize("name", ["kmedoid", "facility", "kcover"])
def test_stochastic_greedy_with_reference_draws(name, engine, constrained):
    """The reference's own draws (`_sample_candidates` of the key it is
    given), handed to the port as cand_idx: the same selections."""
    ids, x, valid = _pool(name, seed=5)
    jobj, tobj = _objectives(name)
    key = jax.random.PRNGKey(7)
    k, sample = 10, 24
    draws = np.array(JG._sample_candidates(key, k, len(ids), sample))
    jcon = _constraints("knapsack", len(ids)) if constrained else None
    want = JG.greedy(jobj, jnp.asarray(ids), jnp.asarray(x),
                     jnp.asarray(valid), k, sample=sample, key=key,
                     engine=engine, constraint=jcon)
    got = TG.greedy(tobj, torch.as_tensor(ids), convert.to_torch(x, "cpu"),
                    torch.as_tensor(valid), k, sample=sample,
                    cand_idx=torch.as_tensor(draws), engine=engine,
                    constraint=(None if jcon is None else
                                convert.constraint_to_torch(jcon, "cpu")))
    _hold(got, want, name, engine)


def test_sampled_engines_break_exact_ties_as_reference(monkeypatch):
    """Element 30 duplicates element 2, the best set of the pool, and
    both are drawn: the step engine keeps the copy first in sample order
    (30), the fused engine the lowest pool index (2) — in both packages,
    with the same draws handed to each."""
    sets = gen_kcover(40, 256, seed=6)
    sets[2] = np.arange(0, 256, 2)
    sets[30] = sets[2]
    bits = pack_bitmaps(sets, 256)
    ids = np.arange(40, dtype=np.int32)
    valid = np.ones(40, bool)
    draws = np.array([[30, 2] + list(range(3, 21))])
    monkeypatch.setattr(JG, "_sample_candidates",
                        lambda key, k, n, sample: jnp.asarray(draws))
    jobj, tobj = _objectives("kcover")
    for engine, first in (("step", 30), ("fused", 2)):
        want = JG.greedy(jobj, jnp.asarray(ids), jnp.asarray(bits),
                         jnp.asarray(valid), 1, sample=20,
                         key=jax.random.PRNGKey(0), engine=engine)
        got = TG.greedy(tobj, torch.as_tensor(ids),
                        convert.to_torch(bits, "cpu"),
                        torch.as_tensor(valid), 1, sample=20,
                        cand_idx=torch.as_tensor(draws), engine=engine)
        assert int(got.ids[0]) == int(want.ids[0]) == first


def test_greedy_draws_come_from_the_key():
    """Without cand_idx, the draws come from `key`: the same generator
    seed gives the same run, another seed another one."""
    ids, x, valid = _pool("facility", n=200, seed=8)
    tobj = t_make("facility", device="cpu")

    def run(seed):
        return TG.greedy(tobj, torch.as_tensor(ids), torch.as_tensor(x),
                         torch.as_tensor(valid), 8, sample=12,
                         key=torch.Generator().manual_seed(seed)).ids

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
