"""The rules that hold a train step on the card against the CPU
(`repro_torch/optim/parity.py`, used by chip_smoke.py's train_parity and
tests/test_torch_cuda.py), checked here on the CPU for their power both
ways: the port's float32 AdamW step passes them against its own float64
step from the same state; faults of the size the card could bring fail
them. Each step starts both sides from one state, as the card's steps
start from the CPU's: a step carried on from its own state would carry
AdamW's sign flips (lr·g/(|g| + eps) where g lies near zero) into the
next gradient.

* `moments_error`: float32 against float64 moments within 1e-4 of each
  leaf's largest entry; a step whose products round their operands to
  TF32's 10-bit mantissa (emulated: every `einsum32` operand rounded in
  the forward) moves the moments by more.
* `update_error`: a float32 step's parameters against the update its own
  moments imply within 1e-6 (beyond one f32 spacing); a skipped update,
  one at twice the rate, and one that left out the weight decay fail it.
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import OptimConfig, ShapeConfig, TrainConfig
from repro_torch.launch import steps
from repro_torch.models import api, layers, mamba, moe, transformer
from repro_torch.optim import adafactor, adamw, compress, parity, schedule

TOL = 1e-4
ARCHS = ("smollm-135m", "qwen3-moe-30b-a3b", "mamba2-1.3b")
OCFG = OptimConfig(lr=3e-3, warmup_steps=2, total_steps=10)
SHAPE = ShapeConfig("t", "train", 32, 2)
F64_MODS = (layers, mamba, moe, transformer, steps, adamw, adafactor,
            compress, schedule)
EINSUM_MODS = (layers, mamba, moe, transformer)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, nearest), straight through in
    the backward."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


class _patched:
    """Attributes of modules replaced inside the block."""

    def __init__(self, mods, name, value):
        self.mods, self.name, self.value = mods, name, value

    def __enter__(self):
        self.saved = [getattr(m, self.name) for m in self.mods]
        for m in self.mods:
            setattr(m, self.name, self.value)

    def __exit__(self, *exc):
        for m, v in zip(self.mods, self.saved):
            setattr(m, self.name, v)


def _step(arch, state_np, s, f64=False, tf32=False):
    """(state before, state after, lr) of step ``s`` (its batch drawn
    from seed 1 + s) from the numpy state `state_np`, each state
    flattened in the reference's layout; the state after also as numpy
    (the next step's start)."""
    cfg = registry.smoke_config(arch)
    if f64:
        cfg = cfg.replace(dtype="float64")
    state = convert.train_state_to_torch(state_np, cfg, OCFG, "cpu")
    fn = steps.make_train_step(cfg, OCFG, TrainConfig(), SHAPE, None)
    einsum = layers.einsum32

    def rounded(eq, *xs):
        return einsum(eq, *(_tf32(x.to(torch.float32)) for x in xs))

    batch = api.synth_batch(torch.Generator().manual_seed(1 + s),
                            registry.smoke_config(arch), SHAPE)
    if f64:
        batch = {k: v.double() if v.is_floating_point() else v
                 for k, v in batch.items()}
    with _patched(F64_MODS, "F32", torch.float64 if f64 else torch.float32), \
            _patched(EINSUM_MODS, "einsum32", rounded if tf32 else einsum):
        state, metrics = fn(state, batch)
    after = convert.train_state_to_numpy(state, cfg, OCFG)
    return (parity.flatten(state_np), parity.flatten(after),
            float(metrics["lr"])), after


def _trajectory(arch):
    """The float64 steps' states before each of 2 steps (the float32
    steps start from each, as the card's steps start from the CPU's)
    and their results."""
    state, out = _state0(arch), []
    for s in range(2):
        start = state
        result, state = _step(arch, start, s, f64=True)
        out.append((start, result))
    return out


def _state0(arch):
    cfg = registry.smoke_config(arch)
    state, _ = steps.concrete_state(torch.Generator().manual_seed(0), cfg,
                                    OCFG, device="cpu")
    return convert.train_state_to_numpy(state, cfg, OCFG)


@pytest.mark.parametrize("arch", ARCHS)
def test_moments_rule_passes_float32_and_fails_tf32(arch):
    for s, (start, (_, want, _)) in enumerate(_trajectory(arch)):
        (_, got, _), _ = _step(arch, start, s)
        err, leaf = parity.moments_error(got, want)
        assert err <= TOL, (s, leaf, err)
        (_, got, _), _ = _step(arch, start, s, tf32=True)
        err, leaf = parity.moments_error(got, want)
        assert err > 10 * TOL, (s, leaf, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_update_rule_passes_the_step_and_fails_wrong_updates(arch):
    state = _state0(arch)
    for s in range(2):
        (before, after, lr), state = _step(arch, state, s)
        err, leaf = parity.update_error(before, after, OCFG, lr)
        assert err <= 1e-6, (leaf, err)
        params = [k for k in before if k.startswith("params/")]
        skipped = dict(after, **{k: before[k] for k in params})
        assert parity.update_error(before, skipped, OCFG, lr)[0] > 0.5
        doubled = dict(after, **{k: 2 * after[k] - before[k]
                                 for k in params})
        assert parity.update_error(before, doubled, OCFG, lr)[0] > 0.5
        no_decay = OptimConfig(lr=OCFG.lr, warmup_steps=2, total_steps=10,
                               weight_decay=0.0)
        assert parity.update_error(before, after, no_decay, lr)[0] > TOL


def test_moments_rule_compares_each_leaf_to_its_own_scale():
    """A leaf of small moments is held to its own largest entry: an error
    the old max(1, ·) scale would pass fails."""
    want = {"opt/step": np.asarray(1), "opt/m/w": np.full(4, 1e-4),
            "opt/v/w": np.full(4, 1e-8)}
    got = dict(want, **{"opt/m/w": want["opt/m/w"] * (1 + 1e-3)})
    err, leaf = parity.moments_error(got, want)
    assert leaf == "opt/m/w" and err == pytest.approx(1e-3)
    with pytest.raises(AssertionError):
        parity.moments_error(dict(got, **{"opt/step": np.asarray(2)}), want)
