"""The port's single-device GreedyML stages against the reference's
`LevelDispatcher(mesh=None)`.

`shard_lanes`, `empty_lane_solutions`, `root_solution` and the level
gather (a reshape over the lane digits) against the reference's, then
whole trees at radices (2, 2) with a global knapsack (`KnapsackSpec`) for
kmedoid, facility and kcover, and with stochastic leaves and nodes, whose
draws are the reference's own (`_sample_candidates` of its per-lane keys,
handed to the port's dispatcher as its sampler).

The trees are walked in lockstep on the reference's path: every stage of
the port gets the reference's stacked lane state as input, so each
stage is held on identical inputs. A lane must come out equal (ids,
valid, evals; value within 1e-5) unless a float64 oracle shows the
difference was decided by rounding (ROADMAP §C P1): the lane's node
greedies split at a genuine tie (`test_torch_tree._tie`), or its
argmax{f(S), f(S_prev)} compared values within their rounding bound.
kcover's gains and values are integers: its lanes must be equal.

Also the port's own sampler: draws distinct within a step, in range,
repeatable from the seed, and different across lanes and stages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # image has no hypothesis
    from hypothesis_fallback import given, settings, strategies as st

from repro.core import constraints as JC
from repro.core import greedy as JG
from repro.core import greedyml as JGML
from repro.core.functions import make_objective as j_make
from repro.data.synthetic import gen_images, gen_kcover, pack_bitmaps
from repro.kernels import ops as JOps
from repro_torch import convert
from repro_torch.core import constraints as TC
from repro_torch.core import greedy as TG
from repro_torch.core import greedyml as TGML
from repro_torch.core.functions import make_objective as t_make
from test_torch_tree import EPS32, _entry_err, _tie

RADICES = (2, 2)
N, D, K, BUDGET = 128, 16, 6, 5.0


def _data(name, seed=0):
    if name == "kcover":
        return pack_bitmaps(gen_kcover(N, 192, seed=seed), 192)
    return gen_images(N, D, classes=6, seed=seed)


def _objectives(name):
    kw = {"universe": 192} if name == "kcover" else {}
    return (j_make(name, backend="ref", **kw),
            t_make(name, device="cpu", **kw))


def _aug(name, seed=9):
    """Extra node evaluation rows (the reference's augmentation) for the
    feature objectives: node grounds of 12 rows are full of exact ties."""
    return None if name == "kcover" else gen_images(32, D, classes=6,
                                                    seed=seed)


def _costs(seed=5):
    return np.random.default_rng(seed).uniform(0.5, 2.0, N).astype(
        np.float32)


def _np(sol):
    return {f: np.array(getattr(sol, f))
            for f in ("ids", "payloads", "valid", "value", "evals")}


def _to_port(sol):
    return TG.Solution(convert.to_torch(sol["ids"], "cpu"),
                       convert.to_torch(sol["payloads"], "cpu"),
                       convert.to_torch(sol["valid"], "cpu"),
                       convert.to_torch(sol["value"], "cpu"),
                       convert.to_torch(sol["evals"], "cpu"))


def _to_jax(sol):
    return JG.Solution(*(jnp.asarray(sol[f]) for f in
                         ("ids", "payloads", "valid", "value", "evals")))


def _reference_sampler(seed):
    """The reference's per-lane draws at every stage, as the port's
    sampler: lane l's key folds its machine id into the stage's key."""
    def draw(stage, lanes, k, n, sample):
        base = (JGML._leaf_key(seed) if stage == 0
                else JGML._level_key(seed, stage - 1))
        return torch.as_tensor(np.stack([
            np.asarray(JG._sample_candidates(jax.random.fold_in(base, mid),
                                             k, n, sample))
            for mid in range(lanes)]))
    return draw


# ---------------------------------------------------------------------------
# lane state and the level gather
# ---------------------------------------------------------------------------


def test_shard_lanes_and_lane_state_match_reference():
    x = gen_images(24, 5, classes=3, seed=1)
    ids = np.arange(24, dtype=np.int32)
    valid = np.arange(24) % 5 != 0
    want = JGML.shard_lanes(jnp.asarray(ids), jnp.asarray(x),
                            jnp.asarray(valid), 4)
    got = TGML.shard_lanes(torch.as_tensor(ids), torch.as_tensor(x),
                           torch.as_tensor(valid), 4)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        TGML.shard_lanes(torch.arange(10), torch.zeros(10, 2),
                         torch.ones(10, dtype=torch.bool), 4)
    we = _np(JGML.empty_lane_solutions(4, 3, jnp.asarray(x)))
    ge = TGML.empty_lane_solutions(4, 3, torch.as_tensor(x))
    for f, v in we.items():
        np.testing.assert_array_equal(getattr(ge, f).numpy(), v)
    root = TGML.root_solution(ge)
    assert root.ids.shape == (3,) and float(root.value) == 0.0


def _reference_gather(x, radices, lvl):
    """lax.all_gather over the level's named vmap axis, as the
    reference's LevelDispatcher nests it."""
    axes = [f"t{i}" for i in range(len(radices))]
    f = lambda v: lax.all_gather(v, axes[lvl], axis=0, tiled=True)
    for ax in axes:
        f = jax.vmap(f, axis_name=ax)
    grouped = x.reshape(tuple(reversed(radices)) + x.shape[1:])
    out = f(jnp.asarray(grouped))
    return np.asarray(out).reshape((x.shape[0],) + out.shape[len(radices):])


@pytest.mark.parametrize("radices", [(2, 2), (2, 3, 2), (4,), (3, 2)])
def test_level_gather_matches_reference_all_gather(radices):
    lanes = int(np.prod(radices))
    x = np.arange(lanes * 3 * 2, dtype=np.float32).reshape(lanes, 3, 2)
    ids = np.arange(lanes * 3).reshape(lanes, 3)
    for lvl in range(len(radices)):
        np.testing.assert_array_equal(
            TGML.gather_groups(torch.as_tensor(x), radices, lvl).numpy(),
            _reference_gather(x, radices, lvl))
        np.testing.assert_array_equal(
            TGML.gather_groups(torch.as_tensor(ids), radices, lvl).numpy(),
            _reference_gather(ids, radices, lvl))


def test_accumulate_one_level_returns_its_evaluation_set():
    """The round hands back the ground it scored on: each lane's union,
    then the augmentation rows."""
    obj = t_make("facility", device="cpu")
    x = torch.as_tensor(gen_images(16, 4, classes=2, seed=3))
    sols = TGML.empty_lane_solutions(4, 2, x)
    sols.ids[:] = torch.arange(8).reshape(4, 2)
    sols.payloads[:] = x[:8].reshape(4, 2, 4)
    sols.valid[:] = True
    aug = x[8:11]
    out, ground, gvalid = TGML.accumulate_one_level(obj, sols, 2, (2, 2), 1,
                                                    aug=aug)
    assert ground.shape == (4, 4 + 3, 4) and bool(gvalid.all())
    torch.testing.assert_close(ground[1, :2], x[2:4])     # lanes 1 and 3
    torch.testing.assert_close(ground[1, 2:4], x[6:8])
    torch.testing.assert_close(ground[0, 4:], aug)
    assert out.ids.shape == (4, 2)


# ---------------------------------------------------------------------------
# whole trees, lockstep on the reference's path
# ---------------------------------------------------------------------------


def _hold_greedy(name, want, got, ground, gvalid, pool, pool_ids):
    """One lane's greedy: equal (ids, valid, evals; value within the
    matrix rounding bound), or split at a float64-proven tie. Returns 1
    for a tie met, else 0."""
    if np.array_equal(want["ids"], got["ids"]):
        assert np.array_equal(want["valid"], got["valid"])
        assert int(want["evals"]) == int(got["evals"])
        tol = 0.0 if name == "kcover" else float(
            _entry_err(name, ground, pool).max()) + 4 * EPS32 * abs(
                float(want["value"])) + 1e-7
        assert abs(float(want["value"]) - float(got["value"])) <= tol
        return 0
    assert name != "kcover", (want["ids"], got["ids"])   # integer gains
    assert _tie(name, ground, gvalid, pool, None,
                want["ids"].astype(np.int64), got["ids"], pool_ids), (
                    want["ids"], got["ids"])
    return 1


def _lane(sol, i):
    return {f: v[i] for f, v in sol.items()}


def _reference_round(jd, sol, lvl, aug=None):
    """The reference's accumulation round (`accumulate_one_level`) in the
    nested vmap its LevelDispatcher runs, returning its pieces too:
    (node greedies, S_prev scores, round output), as numpy."""
    axes, radices = jd.tree_axes, jd.radices

    def body(s):
        ax = axes[lvl]
        u_ids, u_pay, u_val = (lax.all_gather(x, ax, axis=0, tiled=True)
                               for x in (s.ids, s.payloads, s.valid))
        ground, gvalid = u_pay, u_val
        if aug is not None:
            ground = jnp.concatenate([u_pay, aug], axis=0)
            gvalid = jnp.concatenate([u_val, jnp.ones(aug.shape[0], bool)])
        key = None
        if jd.sample_level:
            key = jax.random.fold_in(JGML._level_key(jd.seed, lvl),
                                     JGML._machine_flat_id(axes, radices))
        new = JG.greedy(jd.objective, u_ids, u_pay, u_val, jd.k,
                        ground=ground, ground_valid=gvalid,
                        sample=jd.sample_level, key=key,
                        engine=jd.node_engine,
                        constraint=(jd.constraint.bind(u_ids)
                                    if jd.constraint is not None else None))
        score = JG.replay_value(jd.objective, s.payloads, s.valid, ground,
                                gvalid)
        out = JG.select_better(new, JG.Solution(s.ids, s.payloads, s.valid,
                                                score, s.evals))
        return new, score, out

    f = body
    for ax in axes:
        f = jax.vmap(f, axis_name=ax)
    shape = tuple(reversed(radices))
    grouped = jax.tree.map(lambda x: x.reshape(shape + x.shape[1:]), sol)
    with JOps.fused_replicas(jd.lanes):
        new, score, out = jax.jit(f)(grouped)
    flat = lambda x: np.array(x).reshape((jd.lanes,) + x.shape[len(shape):])
    return ({f: flat(getattr(new, f)) for f in ("ids", "payloads", "valid",
                                                 "value", "evals")},
            flat(score),
            {f: flat(getattr(out, f)) for f in ("ids", "payloads", "valid",
                                                 "value", "evals")})


def _lockstep(name, data, jd, td, aug=None, hold=_hold_greedy):
    """Run both dispatchers stage by stage, both fed the reference's
    stage output. Each round is held piece by piece — the node greedies
    on the gathered unions, the S_prev replay scores, the argmax
    decisions — and the port's `level` must equal its pieces, the
    reference's `level` its own. ``aug`` (A, D): evaluation rows added
    to every node's ground set; `hold` holds one lane's greedy
    (`_hold_greedy`'s signature). Returns (ties met, the root state)."""
    lanes = jd.lanes
    ids = np.arange(N, dtype=np.int32)
    valid = np.ones(N, bool)
    jargs = JGML.shard_lanes(jnp.asarray(ids), jnp.asarray(data),
                             jnp.asarray(valid), lanes)
    targs = TGML.shard_lanes(torch.as_tensor(ids, dtype=torch.int64),
                             convert.to_torch(data, "cpu"),
                             torch.as_tensor(valid), lanes)
    want = _np(jd.leaves(*jargs))
    got = _np(td.leaves(*targs))
    pools = np.asarray(jargs[1])
    ties = sum(hold(name, _lane(want, i), _lane(got, i), pools[i],
                            np.ones(len(pools[i]), bool), pools[i],
                            np.asarray(jargs[0][i]))
               for i in range(lanes))
    for lvl in range(jd.num_levels):
        prev = want
        jaug = None if aug is None else jnp.asarray(aug)
        taug = None if aug is None else torch.as_tensor(aug)
        want = _np(jd.level(_to_jax(prev), lvl, jaug))
        tprev = _to_port(prev)
        got = _np(td.level(tprev, lvl, taug))
        u = {f: TGML.gather_groups(getattr(tprev, f), RADICES, lvl)
             for f in ("ids", "payloads", "valid")}
        ground, gvalid = u["payloads"], u["valid"]
        if aug is not None:
            ground = torch.cat([ground, taug.expand((lanes,) + taug.shape)],
                               1)
            gvalid = torch.cat([gvalid, torch.ones(lanes, len(aug),
                                                   dtype=torch.bool)], 1)
        uids, upay = u["ids"].numpy(), u["payloads"].numpy()
        grd, gval = ground.numpy(), gvalid.numpy()
        draws = td._draws(1 + lvl, uids.shape[1], td.sample_level)
        t_new = TG.greedy_batch(
            td.objective, u["ids"], u["payloads"], u["valid"], K,
            ground=ground, ground_valid=gvalid,
            sample=td.sample_level, cand_idx=draws,
            constraint=td.constraint.bind(u["ids"]) if td.constraint
            else None, engine=td.node_engine)
        t_score = TG.replay_value(td.objective, tprev.payloads,
                                  tprev.valid, ground, gvalid)
        # the port's level is its pieces
        t_out = _np(TG.select_better(t_new, TG.Solution(
            tprev.ids, tprev.payloads, tprev.valid, t_score, tprev.evals)))
        for f in ("ids", "valid", "evals", "value"):
            np.testing.assert_array_equal(got[f], t_out[f])
        # the reference's pieces, from its own round replayed in the
        # dispatcher's nested vmap (rounding, and so tie decisions, can
        # differ under another batching)
        j_new, j_score, j_out = _reference_round(jd, _to_jax(prev), lvl,
                                                 jaug)
        for f in ("ids", "valid", "evals"):
            np.testing.assert_array_equal(want[f], j_out[f])
        take_j = j_new["value"] >= j_score
        t_new = _np(t_new)
        t_score = t_score.numpy()
        for i in range(lanes):
            split = hold(name, _lane(j_new, i), _lane(t_new, i),
                                 grd[i], gval[i], upay[i], uids[i])
            ties += split
            if name == "kcover":
                assert float(j_score[i]) == float(t_score[i])
                tol = 0.0
            else:
                err = float(_entry_err(name, grd[i], upay[i]).max())
                tol = 2 * err + 8 * EPS32 * abs(float(j_score[i]))
            assert abs(float(j_score[i]) - float(t_score[i])) <= tol
            # after a split greedy the two S_new differ: nothing to hold
            if not split and take_j[i] != (t_new["value"][i] >= t_score[i]):
                assert abs(float(j_new["value"][i]) - float(j_score[i])) \
                    <= 2 * tol, f"lane {i}: the argmax is no tie"
                ties += 1
    return ties, want


@pytest.mark.parametrize("engine", ["auto", "step"])
@pytest.mark.parametrize("name", ["kmedoid", "facility", "kcover"])
def test_knapsack_tree_matches_reference(name, engine):
    data = _data(name)
    costs = _costs()
    jobj, tobj = _objectives(name)
    jd = JGML.LevelDispatcher(jobj, K, RADICES, engine=engine,
                              constraint=JC.KnapsackSpec(jnp.asarray(costs),
                                                         BUDGET))
    td = TGML.LevelDispatcher(tobj, K, RADICES, engine=engine,
                              constraint=TC.KnapsackSpec(
                                  torch.as_tensor(costs), BUDGET))
    _, root = _lockstep(name, data, jd, td, _aug(name))
    spent = TC.KnapsackSpec(torch.as_tensor(costs), BUDGET).spent(
        torch.as_tensor(root["ids"], dtype=torch.int64),
        torch.as_tensor(root["valid"]))
    assert bool((spent <= BUDGET).all())
    assert root["valid"][0].sum() >= 1


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("name", ["kmedoid", "facility", "kcover"])
def test_stochastic_tree_with_reference_draws(name, constrained):
    data = _data(name, seed=2)
    costs = _costs(7)
    jobj, tobj = _objectives(name)
    kw = dict(sample_leaf=12, sample_level=5, seed=11)
    jd = JGML.LevelDispatcher(
        jobj, K, RADICES, constraint=(JC.KnapsackSpec(jnp.asarray(costs),
                                                      BUDGET)
                                      if constrained else None), **kw)
    td = TGML.LevelDispatcher(
        tobj, K, RADICES, sampler=_reference_sampler(11),
        constraint=(TC.KnapsackSpec(torch.as_tensor(costs), BUDGET)
                    if constrained else None), **kw)
    _lockstep(name, data, jd, td, _aug(name))


def test_whole_tree_without_ties_matches_reference():
    """On data where the lockstep meets no tie, the port's own run (its
    stages fed its own outputs) gives the reference's lanes and root."""
    data = _data("facility", seed=4)
    costs = _costs(9)
    aug = _aug("facility")
    jobj, tobj = _objectives("facility")
    jd = JGML.LevelDispatcher(jobj, K, RADICES, constraint=JC.KnapsackSpec(
        jnp.asarray(costs), BUDGET))
    td = TGML.LevelDispatcher(tobj, K, RADICES, constraint=TC.KnapsackSpec(
        torch.as_tensor(costs), BUDGET))
    ties, want = _lockstep("facility", data, jd, td, aug)
    assert ties == 0
    ids, pay, val = TGML.shard_lanes(torch.arange(N), torch.as_tensor(data),
                                     torch.ones(N, dtype=torch.bool),
                                     td.lanes)
    sols = td.leaves(ids, pay, val)
    for lvl in range(td.num_levels):
        sols = td.level(sols, lvl, torch.as_tensor(aug))
    np.testing.assert_array_equal(sols.ids.numpy(), want["ids"])
    np.testing.assert_array_equal(sols.evals.numpy(), want["evals"])
    np.testing.assert_allclose(sols.value.numpy(), want["value"], rtol=1e-5)
    root = TGML.root_solution(sols)
    np.testing.assert_array_equal(root.ids.numpy(), want["ids"][0])


# ---------------------------------------------------------------------------
# the port's own sampler
# ---------------------------------------------------------------------------


@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(2, 300),
       frac=st.integers(1, 99))
@settings(max_examples=30, deadline=None)
def test_lane_sampler_draws(seed, n, frac):
    sample = max(1, min(n - 1, n * frac // 100))
    sampler = TGML.LaneSampler(seed)
    draws = sampler(0, 4, 5, n, sample)
    assert draws.shape == (4, 5, sample) and draws.dtype == torch.int64
    assert int(draws.min()) >= 0 and int(draws.max()) < n
    for lane in draws:
        for step in lane:
            assert len(set(step.tolist())) == sample        # no repeats
    assert torch.equal(draws, TGML.LaneSampler(seed)(0, 4, 5, n, sample))
    if n >= 20:                        # collisions: (1/20)^5 at worst
        assert not torch.equal(draws[0], draws[1])          # lanes differ
        assert not torch.equal(draws, sampler(1, 4, 5, n, sample))


def test_default_sampler_follows_the_dispatcher_seed():
    data = _data("facility", seed=3)
    tobj = t_make("facility", device="cpu")
    ids, pay, val = TGML.shard_lanes(torch.arange(N), torch.as_tensor(data),
                                     torch.ones(N, dtype=torch.bool), 4)

    def leaves(seed):
        d = TGML.LevelDispatcher(tobj, K, RADICES, sample_leaf=8, seed=seed)
        return d.leaves(ids, pay, val).ids

    assert torch.equal(leaves(1), leaves(1))
    assert not torch.equal(leaves(1), leaves(2))
