"""The port's train step (`repro_torch/launch/steps.py::make_train_step`)
against the reference's jitted one on the CPU: both packages start from
one state (the reference's, carried across by
`convert.train_state_to_torch`) and take 2 steps on the same numpy
batches; after each step the port's parameters and optimizer state, in
the reference's layout (`convert.train_state_to_numpy`), agree within
1e-5 of each leaf's scale and the losses within 1e-5. Cases: smollm-135m
with AdamW and with Adafactor, qwen3-moe-30b-a3b (the MoE aux losses in
the objective), and a one-device ("data", "model") mesh — microbatches
of one — under the bf16 and the keyless int8 gradient codecs. The
abstract state, the shardings and the microbatch count are held against
the reference's too.

Tolerance: `test_torch_models.hold` at 1e-5 — both packages' steps in
float64 (the reference under jax's x64 mode; every model, optimizer,
codec, schedule and step module's F32 patched in both) agree within
1e-9 of scale, and the float32 states within 1e-5 of each leaf's scale,
else the port's RMS error against the reference's float64 state at most
2.5× the reference's own. The fallback is needed: AdamW's first update
is lr·g/(|g| + eps), a sign, and where the smoke models' float32
gradients (which agree within 1e-4 of scale, test_torch_train.py) lie
near zero either package's rounding flips it. The metrics are held so
too, but the gradient norm: a scalar has no RMS to compare, and these
ill-conditioned random models carry a flipped sign of step 1 into step
2's gradient norm by up to 1% (the reference's own float32 run
0.05–0.03%); it is held within 1e-4 at step 1, from one state.

This file holds the unsharded cases; `test_torch_train_mesh.py` the
one-device mesh's and the shardings.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.configs.base import OptimConfig as JOptim
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import TrainConfig as JTrain
from repro.launch import mesh as JM
from repro.launch import steps as JSteps

from repro_torch import convert
from repro_torch.configs import registry as TR
from repro_torch.configs.base import OptimConfig, ShapeConfig, TrainConfig
from repro_torch.launch import mesh as TM
from repro_torch.launch import steps

from repro.optim import adafactor as JAF
from repro.optim import adamw as JAW
from repro.optim import compress as JC
from repro.optim import schedule as JS

from repro_torch.optim import adafactor as TAF
from repro_torch.optim import adamw as TAW
from repro_torch.optim import compress as TC
from repro_torch.optim import schedule as TS

from test_torch_models import (float64_port, float64_reference, hold,
                               jax_batch, np64, np_batch, port64_cfg,
                               torch_batch)
from test_torch_optim import _flat

TOL = 1e-5
BATCH, SEQ = 4, 16
CASES = {
    "adamw": ("smollm-135m", {"name": "adamw"}, None),
    "adafactor": ("smollm-135m", {"name": "adafactor"}, None),
    "moe": ("qwen3-moe-30b-a3b", {"name": "adamw"}, None),
    "mesh_bf16": ("smollm-135m", {"name": "adamw", "compress_grads": "bf16"},
                  "local"),
    "mesh_int8": ("smollm-135m", {"name": "adamw", "compress_grads": "int8"},
                  "local"),
}
UNSHARDED = ("adamw", "adafactor", "moe")


class _patched:
    """Every F32 of `mods` set to float64 inside the block."""

    def __init__(self, mods, f64):
        self.mods, self.f64 = mods, f64

    def __enter__(self):
        self.saved = [m.F32 for m in self.mods]
        for m in self.mods:
            m.F32 = self.f64

    def __exit__(self, *exc):
        for m, f in zip(self.mods, self.saved):
            m.F32 = f


def _initial(case):
    """The reference's initial state of the case (numpy, float32; drawn
    outside x64 mode, whose draws differ)."""
    arch, okw, _ = CASES[case]
    jstate, _ = JSteps.concrete_state(jax.random.PRNGKey(0),
                                      JR.smoke_config(arch), JOptim(**okw))
    return jax.tree.map(np.asarray, jstate)


def _run(case, state0, f64: bool, ref_states=None):
    """The reference's (``ref_states`` None) or the port's 2 steps from
    `state0`: [(state, metrics)] after each, numpy in the reference's
    layout. Under the int8 codec the port's second step starts from the
    reference's state (``ref_states``): a gradient's f32 error that
    crosses a rounding step of the quantizer moves that entry by a whole
    step (the port's f32 gradients carry 1–2.5× the reference's error,
    so 2–3× its flips), and Adam's sign-like first update carries it
    into step 2's gradients."""
    arch, okw, mesh_kind = CASES[case]
    okw = dict(okw, lr=3e-3, warmup_steps=2, total_steps=10)
    resync = okw.get("compress_grads") == "int8"
    port = ref_states is not None
    shape = (ShapeConfig if port else JShape)("t", "train", SEQ, BATCH)
    conv = np64 if f64 else (lambda t: t)
    out = []
    if not port:
        cfg, ocfg = JR.smoke_config(arch), JOptim(**okw)
        cfg = cfg.replace(dtype="float64") if f64 else cfg
        mesh = JM.make_local_mesh(1, 1) if mesh_kind else None
        assert JSteps.num_microbatches(shape, mesh, JTrain()) == (
            BATCH if mesh_kind else 1)
        fn = jax.jit(JSteps.make_train_step(cfg, ocfg, JTrain(), shape,
                                            mesh))
        state = conv(state0)
        for s in range(2):
            nb = np_batch(cfg, BATCH, SEQ, seed=10 + s, labels=True)
            state, m = fn(state, conv(nb) if f64 else jax_batch(nb))
            out.append((jax.tree.map(np.asarray, state),
                        {k: float(v) for k, v in m.items()}))
        return out
    cfg, ocfg = TR.smoke_config(arch), OptimConfig(**okw)
    cfg = port64_cfg(cfg) if f64 else cfg
    mesh = TM.make_local_mesh(1, 1, device="cpu") if mesh_kind else None
    assert steps.num_microbatches(shape, mesh, TrainConfig()) == (
        BATCH if mesh_kind else 1)
    fn = steps.make_train_step(cfg, ocfg, TrainConfig(), shape, mesh)
    state = convert.train_state_to_torch(conv(state0), cfg, ocfg, "cpu")
    for s in range(2):
        if resync and s:
            state = convert.train_state_to_torch(ref_states[s - 1][0], cfg,
                                                 ocfg, "cpu")
        nb = np_batch(cfg, BATCH, SEQ, seed=10 + s, labels=True)
        state, m = fn(state, torch_batch(
            nb, torch.float64 if f64 else torch.float32))
        out.append((convert.train_state_to_numpy(state, cfg, ocfg),
                    {k: float(v) for k, v in m.items()}))
    return out


def hold_case(case):
    """Both packages' 2 steps of `case`, f32 and f64, held leaf by leaf."""
    state0 = _initial(case)
    ref32 = _run(case, state0, False)
    port32 = _run(case, state0, False, ref32)
    with float64_reference(), _patched((JSteps, JAW, JAF, JC, JS),
                                       jnp.float64):
        ref64 = _run(case, state0, True)
    with float64_port(), _patched((steps, TAW, TAF, TC, TS), torch.float64):
        port64 = _run(case, state0, True, ref64)
    for s in range(2):
        (got, gm), (want, wm) = port32[s], ref32[s]
        (t64, tm64), (r64, rm64) = port64[s], ref64[s]
        assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == s + 1
        g, w, w64, g64 = _flat(got), _flat(want), _flat(r64), _flat(t64)
        assert sorted(g) == sorted(w) == sorted(w64) == sorted(g64)
        for k in w:
            if k.endswith("step"):
                continue
            hold(g[k], w[k], w64[k], g64[k], f"{case}:{s}:{k}", atol=TOL)
        for k in wm:
            if k == "grad_norm":
                # from one state (step 1) within 1e-4: int8 rounding
                # flips where the gradients' f32 errors cross a step;
                # step 2's is a gradient taken where Adam's sign-like
                # first update flipped, not compared as a scalar (the
                # state's leaves, held above, carry it)
                if s == 0:
                    np.testing.assert_allclose(gm[k], wm[k], rtol=1e-4,
                                               err_msg=case)
                continue
            hold(gm[k], wm[k], rm64[k], tm64[k], f"{case}:{s}:{k}",
                 atol=TOL)


@pytest.mark.parametrize("case", UNSHARDED)
def test_train_steps_match_reference(case):
    hold_case(case)
