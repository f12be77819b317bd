"""Elastic scaling: change the device pool between checkpoints (answers
`src/repro/runtime/elastic.py`).

Checkpoints hold whole arrays, so rescaling is `restore_resharded` onto
the new device mesh. `plan_new_mesh` and `plan_degraded_tree` are pure
and equal the reference's on every input.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.checkpoint.reshard import restore_resharded


def rescale(ckpt_dir: str, example_tree, axes_tree, new_mesh,
            step: Optional[int] = None) -> Tuple[Any, dict]:
    """Restore the latest checkpoint onto `new_mesh` (a
    torch.distributed DeviceMesh with named dimensions)."""
    return restore_resharded(ckpt_dir, example_tree, axes_tree, new_mesh,
                             step=step)


def plan_new_mesh(current_data: int, current_model: int,
                  healthy_devices: int) -> Tuple[int, int]:
    """The largest power-of-two data axis that fits the healthy pool,
    the model axis kept."""
    model = current_model
    data = max(1, healthy_devices // model)
    p = 1
    while p * 2 <= data:
        p *= 2
    return p, model


def plan_degraded_tree(survivors: int, b: int) -> Tuple[int, int]:
    """The accumulation tree after losing lanes: the largest full b-ary
    tree over the survivors, ``(lanes', levels')`` with lanes' = b^levels'
    ≤ survivors. Every survivor's solution becomes leaf input
    (checkpoint/reshard.py::reshard_solutions); the dropped partition
    costs only the Barbosa et al. (1502.02606) / Lucic et al.
    (1605.09619) expected-quality term. survivors < b degrades to one
    lane (levels' = 0): its greedy over the pooled solutions is the
    root."""
    if survivors < 1:
        raise ValueError("no surviving lanes — nothing to re-plan")
    if b < 2:
        raise ValueError(f"branching must be ≥ 2, got {b}")
    lanes, levels = 1, 0
    while lanes * b <= survivors:
        lanes *= b
        levels += 1
    return lanes, levels
