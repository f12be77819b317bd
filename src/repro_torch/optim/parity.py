"""How an AdamW train step on the card is held against the same step on
the CPU (used by the CUDA tests and by chip_smoke.py).

Both devices start a step from one state; the states are compared in
the reference's layout (`convert.train_state_to_numpy`), flattened to
``"params/…"``, ``"opt/m/…"``, ``"opt/v/…"`` and ``"opt/step"``.

* The moments are linear (m) and quadratic (v) in the clipped gradient,
  so they carry its error unamplified: each moment leaf of the card is
  held to the CPU's within ``tol`` of that leaf's own largest entry
  (`moments_error`). A TF32 build's products move them by ~1e-3 of
  scale; the f32 builds' different summation orders by ~1e-6.
* The parameters' change is not held to the CPU's change: AdamW's first
  update is lr·g/(|g| + eps), a sign, and where a gradient entry lies
  near zero either device's rounding flips it (the port's CPU float32
  step against its float64 step misses there by far more than 1e-4 of
  the leaf's largest change). Each parameter leaf is instead held to the update
  its own moments imply (`update_error`): p0 − lr·(m̂/(√v̂ + eps) +
  wd·p0) in float64 from the card's state before the step and its
  moments after it. Each entry may miss it by one float32 spacing at
  that value (p is stored in float32: the subtraction rounds by half a
  spacing, and the update's own f32 rounding is ~1e-7 of lr·|u|, far
  under a spacing of p); beyond that the error must stay within ``tol``
  of the leaf's largest expected change. A skipped, doubled or
  mis-scheduled update fails it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.configs.base import OptimConfig


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested numpy state as {"a/b/c": float64 array}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree, np.float64)}


def _rel(got: np.ndarray, want: np.ndarray, scale: float) -> float:
    err = float(np.abs(got - want).max())
    return err / scale if scale > 0 else err


def moments_error(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]
                  ) -> Tuple[float, str]:
    """(largest |got − want| over the leaf's max |want|, its leaf) over
    the optimizer's moment leaves; the step counters must be equal."""
    assert sorted(got) == sorted(want)
    assert np.array_equal(got["opt/step"], want["opt/step"])
    worst = (0.0, "")
    for k, w in want.items():
        if k.startswith("opt/") and k != "opt/step" and w.size:
            worst = max(worst, (_rel(got[k], w, float(np.abs(w).max())), k))
    return worst


def update_error(before: Dict[str, np.ndarray],
                 after: Dict[str, np.ndarray], ocfg: OptimConfig,
                 lr: float) -> Tuple[float, str]:
    """(largest |p − p_expected| beyond one float32 spacing of
    p_expected, over the leaf's largest expected change; its leaf): each
    parameter after the step against AdamW's update from the state
    before it and the moments after it, in float64."""
    assert ocfg.name == "adamw" and not ocfg.master_dtype
    b1, b2 = ocfg.betas
    t = float(after["opt/step"])
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    worst = (0.0, "")
    for k, p0 in before.items():
        if not k.startswith("params/") or not p0.size:
            continue
        leaf = k[len("params/"):]
        m, v = after[f"opt/m/{leaf}"], after[f"opt/v/{leaf}"]
        upd = (m / bc1) / (np.sqrt(v / bc2) + ocfg.eps) + (
            ocfg.weight_decay * p0)
        want = p0 - lr * upd
        scale = float(np.abs(want - p0).max())
        spacing = np.spacing(np.abs(want).astype(np.float32))
        excess = np.maximum(np.abs(after[k] - want) - spacing, 0.0)
        err = float(excess.max())
        worst = max(worst, (err / scale if scale > 0 else err, k))
    return worst
