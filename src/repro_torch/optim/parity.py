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

Both rules reduce each leaf to (error, scale) maxima (`moments_parts`,
`update_parts`), so a sharded state is held shard by shard, each rank's
blocks beside the same blocks of the other state, and `worst` combines
them: the maxima of the whole leaves.

* Where a leaf's gradient is ill-conditioned (a bias whose per-token
  terms nearly cancel) two float32 steps that sum in other orders
  differ by more than 1e-4 of its scale, each as far from the exact
  step as the other. `yardstick_parts` / `yardstick_error` then hold a
  state against a float64 step from the same state
  (`test_torch_models.hold`'s rule): a leaf within ``tol`` of its scale
  passes; else its RMS error against the float64 step must stay within
  ``factor`` times a reference float32 step's own.
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


def worst(parts) -> Tuple[float, str]:
    """(largest error over scale, its leaf) of per-leaf (error, scale)
    maxima; ``parts`` a dict or a list of dicts (the shards of one state,
    combined by their maxima)."""
    if isinstance(parts, dict):
        parts = [parts]
    err: Dict[str, float] = {}
    scale: Dict[str, float] = {}
    for p in parts:
        for k, (e, s) in p.items():
            err[k] = max(err.get(k, 0.0), e)
            scale[k] = max(scale.get(k, 0.0), s)
    out = (0.0, "")
    for k in sorted(err):
        out = max(out, (err[k] / scale[k] if scale[k] > 0 else err[k], k))
    return out


def moments_parts(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]
                  ) -> Dict[str, Tuple[float, float]]:
    """{leaf: (max |got − want|, max |want|)} over the optimizer's moment
    leaves; the step counters must be equal."""
    assert sorted(got) == sorted(want)
    assert np.array_equal(got["opt/step"], want["opt/step"])
    return {k: (float(np.abs(got[k] - w).max()), float(np.abs(w).max()))
            for k, w in want.items()
            if k.startswith("opt/") and k != "opt/step" and w.size}


def moments_error(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]
                  ) -> Tuple[float, str]:
    """(largest |got − want| over the leaf's max |want|, its leaf) over
    the optimizer's moment leaves; the step counters must be equal."""
    return worst(moments_parts(got, want))


def yardstick_parts(got: Dict[str, np.ndarray], want64: Dict[str, np.ndarray]
                    ) -> Dict[str, Tuple[float, float, float, int]]:
    """{leaf: (max |got − want64|, max |want64|, Σ (got − want64)², n)}
    over the optimizer's moment leaves (blocks of a sharded state
    allowed: `combine` sums them). numpy arrays or float64 tensors (on
    the card: no host copy)."""
    out = {}
    for k, w in want64.items():
        n = int(np.prod(w.shape))
        if k.startswith("opt/") and k != "opt/step" and n:
            d = got[k] - w
            out[k] = (float(abs(d).max()), float(abs(w).max()),
                      float((d * d).sum()), n)
    return out


def combine(parts) -> Dict[str, Tuple[float, float, float, int]]:
    """The shards' `yardstick_parts` of one state as the whole leaves'."""
    out: Dict[str, Tuple[float, float, float, int]] = {}
    for p in parts:
        for k, (e, s, sq, n) in p.items():
            e0, s0, sq0, n0 = out.get(k, (0.0, 0.0, 0.0, 0))
            out[k] = (max(e0, e), max(s0, s), sq0 + sq, n0 + n)
    return out


def yardstick_error(got, ref32, tol: float, factor: float = 2.5
                    ) -> Tuple[float, str]:
    """(worst ratio, its leaf) of `got`'s whole-leaf `yardstick_parts`
    against a reference float32 step's (``ref32``), both measured from
    one float64 step: 0 where the leaf is within ``tol`` of its scale,
    else its RMS error over ``factor`` times the reference's. At most 1
    passes."""
    out = (0.0, "")
    for k, (e, s, sq, n) in sorted(got.items()):
        if e <= tol * s:
            continue
        _, _, sq1, n1 = ref32[k]
        rms, rms1 = np.sqrt(sq / n), np.sqrt(sq1 / n1)
        ratio = rms / (factor * rms1) if rms1 > 0 else np.inf
        out = max(out, (float(ratio), k))
    return out


def update_parts(before: Dict[str, np.ndarray],
                 after: Dict[str, np.ndarray], ocfg: OptimConfig,
                 lr: float) -> Dict[str, Tuple[float, float]]:
    """{leaf: (largest |p − p_expected| beyond one float32 spacing of
    p_expected, largest expected change)}: each parameter after the step
    against AdamW's update from the state before it and the moments
    after it, in float64. The leaves may be shards (a rank's blocks of
    a sharded state): the update is elementwise."""
    assert ocfg.name == "adamw" and not ocfg.master_dtype
    b1, b2 = ocfg.betas
    t = float(after["opt/step"])
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    out = {}
    for k, p0 in before.items():
        if not k.startswith("params/") or not p0.size:
            continue
        leaf = k[len("params/"):]
        m, v = after[f"opt/m/{leaf}"], after[f"opt/v/{leaf}"]
        upd = (m / bc1) / (np.sqrt(v / bc2) + ocfg.eps) + (
            ocfg.weight_decay * p0)
        want = p0 - lr * upd
        spacing = np.spacing(np.abs(want).astype(np.float32))
        excess = np.maximum(np.abs(after[k] - want) - spacing, 0.0)
        out[k] = (float(excess.max()), float(np.abs(want - p0).max()))
    return out


def update_error(before: Dict[str, np.ndarray],
                 after: Dict[str, np.ndarray], ocfg: OptimConfig,
                 lr: float) -> Tuple[float, str]:
    """(largest |p − p_expected| beyond one float32 spacing of
    p_expected, over the leaf's largest expected change; its leaf): each
    parameter after the step against AdamW's update from the state
    before it and the moments after it, in float64."""
    return worst(update_parts(before, after, ocfg, lr))
