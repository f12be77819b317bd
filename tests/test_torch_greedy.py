"""The port's greedy (`greedy`, `greedy_batch`) across engines and against
the reference.

`greedy(engine=auto|mega|fused|step)` for kmedoid and facility: the
port's engines agree with each other and with the reference's same
engine on its 'ref' backend — same ids, valid and evals, values within
1e-5 (the step engine folds kmedoid winners with the direct difference,
the cached engines with the expansion, so step-vs-cached kmedoid values
are held at 1e-4, the reference's own tolerance for that gap). Also the
batched call (one call for B pools) against B single calls, the
objective protocol methods, and the reference's `Solution`/`RuleState`
carried into the port mid-run through repro_torch.convert.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import greedy as JG
from repro.core.functions import make_objective as j_make
from repro.data.synthetic import gen_images
from repro_torch import convert
from repro_torch.core import greedy as TG
from repro_torch.core.functions import make_objective as t_make
from repro_torch.core.objective import registry

ENGINES = ["auto", "mega", "fused", "step"]


def _pool(n=120, d=24, seed=2):
    x = gen_images(n, d, classes=6, seed=seed)
    valid = (np.arange(n) % 11) != 0
    return np.arange(n, dtype=np.int32), x, valid


def _j(name, engine, ids, x, valid, k, **kw):
    obj = j_make(name, backend="ref")
    return JG.greedy(obj, jnp.asarray(ids), jnp.asarray(x),
                     jnp.asarray(valid), k, engine=engine, **kw)


def _t(name, engine, ids, x, valid, k, **kw):
    obj = t_make(name, device="cpu")
    return TG.greedy(obj, torch.as_tensor(ids), torch.as_tensor(x),
                     torch.as_tensor(valid), k, engine=engine, **kw)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", ["kmedoid", "facility"])
def test_greedy_matches_reference_engine(name, engine):
    ids, x, valid = _pool()
    want = _j(name, engine, ids, x, valid, 10)
    got = _t(name, engine, ids, x, valid, 10)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert int(got.evals) == int(want.evals)
    tol = 1e-4 if name == "kmedoid" and engine != "step" else 1e-5
    assert abs(float(got.value) - float(want.value)) <= tol
    np.testing.assert_allclose(got.payloads.numpy(),
                               np.asarray(want.payloads))


@pytest.mark.parametrize("name", ["kmedoid", "facility"])
def test_engines_agree_in_the_port(name):
    ids, x, valid = _pool(seed=3)
    sols = {e: _t(name, e, ids, x, valid, 12) for e in ENGINES}
    for e in ENGINES[1:]:
        np.testing.assert_array_equal(sols[e].ids.numpy(),
                                      sols["auto"].ids.numpy())
        assert int(sols[e].evals) == int(sols["auto"].evals)
        assert abs(float(sols[e].value) - float(sols["auto"].value)) <= 1e-4


@pytest.mark.parametrize("name", ["kmedoid", "facility"])
def test_greedy_with_ground_override(name):
    """The accumulation-node call shape: an explicit evaluation set."""
    ids, x, valid = _pool(n=60, seed=4)
    g = gen_images(80, 24, classes=6, seed=5)
    gv = np.ones(80, bool)
    want = _j(name, "auto", ids, x, valid, 6, ground=jnp.asarray(g),
              ground_valid=jnp.asarray(gv))
    got = _t(name, "auto", ids, x, valid, 6, ground=g, ground_valid=gv)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert abs(float(got.value) - float(want.value)) <= 1e-4


@pytest.mark.parametrize("engine", ["mega", "fused", "step"])
def test_batched_greedy_equals_single_calls(engine):
    obj = t_make("facility", device="cpu")
    xs = np.stack([gen_images(50, 16, classes=5, seed=s) for s in range(3)])
    valid = np.ones((3, 50), bool)
    valid[1, 40:] = False
    ids = np.tile(np.arange(50), (3, 1))
    batch = TG.greedy_batch(obj, torch.as_tensor(ids), torch.as_tensor(xs),
                            torch.as_tensor(valid), 7, engine=engine)
    for i in range(3):
        one = TG.greedy(obj, torch.as_tensor(ids[i]), torch.as_tensor(xs[i]),
                        torch.as_tensor(valid[i]), 7, engine=engine)
        assert torch.equal(batch.ids[i], one.ids)
        assert int(batch.evals[i]) == int(one.evals)
        assert abs(float(batch.value[i]) - float(one.value)) <= 1e-6


@pytest.mark.parametrize("name", ["satcover", "graphcut", "mmr"])
def test_other_feature_objectives_match_reference(name):
    ids, x, valid = _pool(n=80, seed=6)
    want = _j(name, "auto", ids, x, valid, 8)
    got = _t(name, "auto", ids, x, valid, 8)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert abs(float(got.value) - float(want.value)) <= 1e-5


def test_coverage_matches_reference():
    from repro.data.synthetic import gen_kcover, pack_bitmaps
    sets = gen_kcover(100, 256, seed=1)
    bits = pack_bitmaps(sets, 256)
    ids = np.arange(100, dtype=np.int32)
    valid = np.ones(100, bool)
    jobj = j_make("kcover", universe=256, backend="ref")
    want = JG.greedy(jobj, jnp.asarray(ids), jnp.asarray(bits),
                     jnp.asarray(valid), 8)
    tobj = t_make("kcover", universe=256, device="cpu")
    got = TG.greedy(tobj, torch.as_tensor(ids),
                    convert.to_torch(bits, "cpu"), torch.as_tensor(valid), 8)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert float(got.value) == float(want.value)


def test_registry_matches_reference():
    from repro.core.objective import registry as j_registry
    assert registry() == j_registry()


def test_constraint_and_sampling_are_not_ported_yet():
    """Constrained and stochastic greedy run on one device (see
    tests/test_torch_constraints.py) and over a process group's ranks
    (tests/test_torch_distributed.py); a mesh that is not a TreeMesh is
    refused; a constrained sharded dispatcher builds and leaves its
    leaves unbound, as the reference's (tests/test_torch_shard.py)."""
    from repro_torch.core.constraints import KnapsackSpec
    from repro_torch.core.greedyml import LevelDispatcher
    obj = t_make("facility", device="cpu")
    spec = KnapsackSpec(torch.ones(30), 4.0)
    with pytest.raises(TypeError, match="TreeMesh"):
        LevelDispatcher(obj, 3, (2,), mesh=object(), constraint=spec,
                        sample_leaf=5)
    disp = LevelDispatcher(obj, 3, (2,), shard=2, constraint=spec)
    assert (disp.machines, disp.lanes) == (2, 4)
    ids, x, valid = _pool(n=32)
    leaves = disp.leaves(torch.as_tensor(ids).reshape(4, 8),
                         torch.as_tensor(x).reshape(4, 8, -1),
                         torch.as_tensor(valid).reshape(4, 8))
    assert float(spec.spent(leaves.ids[0], leaves.valid[0])) == float(
        leaves.valid[0].sum())                   # unit costs, unbound
    ids, x, valid = _pool(n=30)
    sol = _t("facility", "auto", ids, x, valid, 3, sample=5,
             constraint=spec.bind(torch.as_tensor(ids, dtype=torch.int64)))
    assert int(sol.valid.sum()) >= 1


def test_select_better_and_replay_value_match_reference():
    ids, x, valid = _pool(n=40, seed=7)
    jobj = j_make("kmedoid", backend="ref")
    a = _j("kmedoid", "auto", ids, x, valid, 5)
    b = _j("kmedoid", "auto", ids[::-1].copy(), x[::-1].copy(),
           valid[::-1].copy(), 5)
    want = JG.select_better(a, b)
    got = TG.select_better(convert.solution_to_torch(a, "cpu"),
                           convert.solution_to_torch(b, "cpu"))
    out = convert.solution_to_numpy(got)
    np.testing.assert_array_equal(out["ids"], np.asarray(want.ids))
    assert out["evals"] == int(want.evals)
    tobj = t_make("kmedoid", device="cpu")
    g = gen_images(30, 24, classes=6, seed=8)
    gv = np.ones(30, bool)
    want_v = JG.replay_value(jobj, a.payloads, a.valid, jnp.asarray(g),
                             jnp.asarray(gv))
    got_v = TG.replay_value(tobj, torch.as_tensor(np.array(a.payloads))[None],
                            torch.as_tensor(np.array(a.valid))[None],
                            torch.as_tensor(g)[None], torch.as_tensor(gv)[None])
    assert abs(float(got_v[0]) - float(want_v)) <= 1e-4


def test_state_carried_mid_run_continues_identically():
    """Three elements folded into a state by the reference, the state
    carried into the port with convert (and back, bit for bit): the next
    step's gains and winner agree in both packages."""
    ids, x, valid = _pool(n=70, seed=9)
    jobj = j_make("facility", backend="ref")
    tobj = t_make("facility", device="cpu")
    jstate = jobj.init_state(jnp.asarray(x), jnp.asarray(valid))
    for e in (3, 17, 40):
        jstate = jobj.update(jstate, jnp.asarray(x[e]))
    tstate = convert.state_to_torch(jstate, "cpu")
    tstate = tstate.__class__(tstate.ground[None], tstate.gvalid[None],
                              tstate.row[None], tstate.base[None],
                              tstate.n_eff[None])
    back = convert.state_to_numpy(tstate)
    np.testing.assert_array_equal(back["row"][0], np.asarray(jstate.row))
    cand = jnp.asarray(valid)
    jg = np.asarray(jobj.gains(jstate, jnp.asarray(x), cand))
    tg = tobj.gains(tstate, torch.as_tensor(x)[None],
                    torch.as_tensor(valid)[None])[0].numpy()
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-6)
    assert int(np.argmax(tg)) == int(np.argmax(jg))
