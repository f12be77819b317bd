"""The port's optimizers, schedules and gradient codecs
(`repro_torch/optim/`) held against the reference's (`src/repro/optim/`)
on the CPU.

AdamW and Adafactor take 3 steps from one state on the reference's
stacked parameter trees (every arch's smoke config has (R, d) norm
scales stacked over the layer period; jamba's period is 8, seamless has
an encoder stack), with the same numpy gradients (each layer at its own
scale), and the states agree leaf by leaf within 1e-6 of the leaf's
scale in the reference's layout (`convert.train_state_to_numpy`).
Adafactor's stacking matters: the same update with per-layer statistics
(every layer its own stack of one: unfactored norms, a per-layer update
clip) misses the reference by far more. The schedules agree within 1e-6
at every step; the keyless codecs bit for bit. The rest mirrors
`tests/test_optim.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.configs.base import OptimConfig as JOptimConfig
from repro.models import transformer as JT
from repro.optim import adafactor as JAF
from repro.optim import adamw as JAW
from repro.optim import compress as JC
from repro.optim import schedule as JS

from repro_torch import convert, optim
from repro_torch.configs import registry as TR
from repro_torch.configs.base import OptimConfig
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw, compress, schedule
from repro_torch.optim.tree import leaves, tree_map

ARCHS = ["smollm-135m", "jamba-v0.1-52b", "seamless-m4t-large-v2"]
TOL = 1e-6


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree, np.float64)}


def assert_trees_close(got, want, tol=TOL, what=""):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w), (what, sorted(set(g) ^ set(w))[:5])
    for k in w:
        assert g[k].shape == w[k].shape, (what, k, g[k].shape, w[k].shape)
        err = float(np.abs(g[k] - w[k]).max()) if w[k].size else 0.0
        assert err <= tol * max(1.0, float(np.abs(w[k]).max())), (
            what, k, err)


def max_rel_err(got, want) -> float:
    g, w = _flat(got), _flat(want)
    return max(float(np.abs(g[k] - w[k]).max())
               / max(1.0, float(np.abs(w[k]).max()))
               for k in w if w[k].size)


def _grads_np(params_np, seed):
    """Gradients of the parameters' shapes; a stacked leaf's repeat r
    scaled by (r + 1), so the layers' statistics differ."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        g = rng.standard_normal(a.shape).astype(np.float32)
        if "blocks" in path and a.ndim >= 1:
            g *= (1.0 + np.arange(a.shape[0], dtype=np.float32)).reshape(
                (-1,) + (1,) * (a.ndim - 1))
        return g

    return jax.tree_util.tree_map_with_path(
        lambda p, a: leaf(jax.tree_util.keystr(p), np.asarray(a)),
        params_np)


def _port(np_tree, cfg):
    """A stacked numpy tree → the port's per-layer tensors (mirror)."""
    return tree_map(lambda t: t.detach(),
                    convert.model_params_to_torch(np_tree, cfg, "cpu"))


def _run_both(arch, ocfg_kw, steps=3, grad_scale=1.0, period=None,
              resync=False):
    """Both packages from one state, `steps` updates with the same
    gradients; with `resync` each port step starts from the reference's
    state. Returns (port params, port state in the reference's layout,
    reference state)."""
    jcfg, tcfg = JR.smoke_config(arch), TR.smoke_config(arch)
    jocfg, tocfg = JOptimConfig(**ocfg_kw), OptimConfig(**ocfg_kw)
    jmod = JAF if jocfg.name == "adafactor" else JAW
    jp, _ = JT.init_params(jax.random.PRNGKey(0), jcfg)
    jp = jax.tree.map(np.asarray, jp)
    state = convert.train_state_to_torch(
        {"params": jp, "opt": jax.tree.map(np.asarray,
                                           jmod.init_opt_state(jp, jocfg))},
        tcfg, tocfg, "cpu")
    tp, topt = state["params"], state["opt"]
    if period is not None:
        tp["blocks"].period = period
        topt = optim.init_opt_state(tp, tocfg)
    jparams, jopt = jax.tree.map(jnp.asarray, jp), jmod.init_opt_state(
        jax.tree.map(jnp.asarray, jp), jocfg)
    for s in range(steps):
        if resync and s:
            st = convert.train_state_to_torch(
                jax.tree.map(np.asarray, {"params": jparams, "opt": jopt}),
                tcfg, tocfg, "cpu")
            tp, topt = st["params"], st["opt"]
        g = _grads_np(jp, seed=s + 1)
        lr = 1e-2 * (s + 1)
        jparams, jopt, jst = jmod.apply_updates(
            jparams, jax.tree.map(jnp.asarray, g), jopt, jocfg, lr,
            grad_scale=grad_scale)
        tp, topt, tst = optim.apply_updates(tp, leaves(_port(g, tcfg)),
                                            topt, tocfg, lr,
                                            grad_scale=grad_scale)
        np.testing.assert_allclose(float(tst["grad_norm"]),
                                   float(jst["grad_norm"]), rtol=1e-5)
    want = jax.tree.map(np.asarray, {"params": jparams, "opt": jopt})
    if period is not None:
        tp["blocks"].period = JT.period_of(jcfg)
        return tp, None, want
    got = convert.train_state_to_numpy({"params": tp, "opt": topt}, tcfg,
                                       tocfg)
    return tp, got, want


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_updates_match_reference_on_stacked_trees(arch, name):
    _, got, want = _run_both(arch, {"name": name})
    assert_trees_close(got, want, what=(arch, name))


def test_adafactor_needs_the_reference_stacking():
    """Per-layer statistics (each layer a stack of one: its (d,) scales
    unfactored, its own update clip) miss the reference by over 100×
    the tolerance; the stacked state meets it."""
    arch = "smollm-135m"
    cfg = TR.smoke_config(arch)
    _, got, want = _run_both(arch, {"name": "adafactor"})
    assert max_rel_err(got["params"], want["params"]) <= TOL
    tp, _, _ = _run_both(arch, {"name": "adafactor"},
                         period=cfg.num_layers)
    per_layer = convert.model_params_to_numpy(tp)
    assert max_rel_err(per_layer, want["params"]) > 100 * TOL


def test_adafactor_state_has_the_reference_shapes():
    jcfg, tcfg = JR.smoke_config("smollm-135m"), TR.smoke_config(
        "smollm-135m")
    ocfg = OptimConfig(name="adafactor")
    jp, jaxes = JT.init_params(jax.random.PRNGKey(0), jcfg)
    want = JAF.init_opt_state(jp, JOptimConfig(name="adafactor"))
    tp, taxes = TT.init_params(torch.Generator().manual_seed(0), tcfg)
    got = optim.init_opt_state(tp, ocfg)
    shapes = jax.tree.map(lambda a: tuple(a.shape), want["fac"])
    assert tree_map(lambda t: tuple(t.shape), got["fac"]) == shapes
    assert got["fac"]["blocks"]["pos0"]["norm1"]["scale"]["vr"].shape == (
        tcfg.num_layers,)
    assert "v" in got["fac"]["final_norm"]["scale"]
    assert optim.opt_state_axes(taxes, ocfg, tp)["fac"] == \
        JAF.opt_state_axes(jaxes, JOptimConfig(name="adafactor"))["fac"]


@pytest.mark.parametrize("kw", [
    {"moment_dtype": "bfloat16"},
    {"grad_clip": 1.0},
    {"grad_clip": 0.0, "weight_decay": 0.0},
])
def test_adamw_options_match_reference(kw):
    """bf16 moments; the global-norm clip with grad_scale folded in. A
    bf16 moment one f32 ulp from a bf16 rounding boundary (the
    reference's compiler contracts ``b1·m + (1 − b1)·g`` into an fma)
    can round to the neighbouring bf16 value, which the next step's
    update carries: with bf16 moments each step starts from the
    reference's state, the parameters held within 1e-6 of scale, the
    stored moments within one bf16 ulp."""
    bf16 = kw.get("moment_dtype") == "bfloat16"
    _, got, want = _run_both("smollm-135m", dict(kw, name="adamw"),
                             grad_scale=0.25, resync=bf16)
    assert_trees_close(got["params"], want["params"], what=kw)
    assert_trees_close(got["opt"], want["opt"], tol=2 ** -8 if bf16
                       else TOL, what=kw)


def test_master_copy_matches_reference():
    """bf16 parameters with an f32 master copy: 3 steps of a small
    gradient; the master moves below bf16's resolution as the
    reference's does."""
    kw = dict(master_dtype="float32", grad_clip=0.0, weight_decay=0.0)
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    jp = {"w": jnp.asarray(w, jnp.bfloat16)}
    tp = {"w": torch.from_numpy(w).to(torch.bfloat16)}
    jo = JAW.init_opt_state(jp, JOptimConfig(**kw))
    to = adamw.init_opt_state(tp, OptimConfig(**kw))
    assert to["master"]["w"].dtype == torch.float32
    for s in range(3):
        g = (rng.standard_normal((8, 4)) * 1e-4).astype(np.float32)
        jp, jo, _ = JAW.apply_updates(
            jp, {"w": jnp.asarray(g, jnp.bfloat16)}, jo, JOptimConfig(**kw),
            1e-3)
        tp, to, _ = adamw.apply_updates(
            tp, {"w": torch.from_numpy(g).to(torch.bfloat16)}, to,
            OptimConfig(**kw), 1e-3)
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(to["master"]["w"].numpy(),
                               np.asarray(jo["master"]["w"]), atol=1e-6)
    np.testing.assert_array_equal(
        tp["w"].float().numpy(), np.asarray(jp["w"], np.float32))


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant", "wsd"])
def test_schedules_match_reference(kind):
    ocfg = OptimConfig(lr=3e-4, warmup_steps=10, total_steps=100,
                       schedule=kind)
    jo = JOptimConfig(lr=3e-4, warmup_steps=10, total_steps=100,
                      schedule=kind)
    steps = np.arange(0, 101)
    got = np.asarray([float(schedule.learning_rate(ocfg, int(s)))
                      for s in steps])
    want = np.asarray([float(JS.learning_rate(jo, int(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * 3e-4)
    # a device tensor step (the train step's form) gives the same values
    t = schedule.learning_rate(ocfg, torch.tensor(57, dtype=torch.int32))
    assert t.dtype == torch.float32 and float(t) == got[57]


@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
def test_keyless_codecs_equal_reference_bit_for_bit(method):
    rng = np.random.default_rng(3)
    g = {"a": rng.standard_normal((37, 5)).astype(np.float32) * 3.0,
         "b": (rng.standard_normal(11) * 1e-3).astype(np.float32),
         "c": np.zeros(4, np.float32)}
    want = JC.decode(JC.encode(jax.tree.map(jnp.asarray, g), method),
                     method)
    enc = compress.encode({k: torch.from_numpy(v) for k, v in g.items()},
                          method)
    if method == "int8":
        jenc = JC.encode(jax.tree.map(jnp.asarray, g), "int8")
        for k in g:
            np.testing.assert_array_equal(enc[k][0].numpy(),
                                          np.asarray(jenc[k][0]))
            assert enc[k][1].numpy().tobytes() == \
                np.asarray(jenc[k][1]).tobytes()
    got = compress.decode(enc, method)
    for k in g:
        a = got[k].float().numpy() if method != "none" else got[k].numpy()
        b = np.asarray(want[k], np.float32)
        assert a.tobytes() == b.tobytes(), (method, k)


# ---- mirrors of tests/test_optim.py --------------------------------------


def test_adamw_converges_quadratic():
    ocfg = OptimConfig(lr=0.1, warmup_steps=1, total_steps=200,
                       schedule="constant", weight_decay=0.0, grad_clip=0.0)
    params = {"w": torch.tensor([3.0, -2.0, 5.0], requires_grad=True)}
    target = torch.ones(3)
    opt = adamw.init_opt_state(params, ocfg)
    for _ in range(150):
        loss = torch.sum((params["w"] - target) ** 2)
        g, = torch.autograd.grad(loss, [params["w"]])
        params, opt, _ = adamw.apply_updates(params, [g], opt, ocfg, 0.1)
    assert float(torch.sum((params["w"].detach() - target) ** 2)) < 1e-3


def test_grad_clip_bounds_update_norm():
    grads = {"a": torch.full((100,), 100.0)}
    clipped, norm = adamw.clip_by_global_norm(grads, 1.0)
    assert float(norm) > 999
    assert abs(float(adamw.global_norm(clipped)) - 1.0) < 1e-5


def test_moment_dtype_respected():
    ocfg = OptimConfig(moment_dtype="bfloat16")
    opt = adamw.init_opt_state({"w": torch.zeros((4, 4))}, ocfg)
    assert opt["m"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant", "wsd"])
def test_schedules_warmup_and_range(kind):
    ocfg = OptimConfig(lr=1.0, warmup_steps=10, total_steps=100,
                       schedule=kind)
    lrs = [float(schedule.learning_rate(ocfg, s)) for s in range(101)]
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1.0) < 1e-6
    assert all(0.0 <= lr <= 1.0 + 1e-6 for lr in lrs)
    if kind != "constant":
        assert lrs[-1] < 0.2


def test_compress_bf16_roundtrip():
    g = {"w": torch.linspace(-3, 3, 1000)}
    out = compress.decode(compress.encode(g, "bf16"), "bf16")
    assert float((out["w"] - g["w"]).abs().max()) < 0.02


def test_compress_int8_unbiased():
    """A keyed int8 codec rounds stochastically (a torch.Generator where
    the reference splits a jax.random key: ROADMAP §C D3): the mean of
    16 draws sits well within one quantization step."""
    g = {"w": torch.randn(2000, generator=torch.Generator().manual_seed(0))}
    outs = []
    for i in range(16):
        enc = compress.encode(g, "int8",
                              generator=torch.Generator().manual_seed(i))
        outs.append(compress.decode(enc, "int8")["w"])
    mean = torch.stack(outs).mean(0)
    scale = float(g["w"].abs().max()) / 127
    assert float((mean - g["w"]).abs().mean()) < 0.5 * scale
    keyless = compress.decode(compress.encode(g, "int8"), "int8")["w"]
    assert float((mean - g["w"]).abs().mean()) < float(
        (keyless - g["w"]).abs().mean())
