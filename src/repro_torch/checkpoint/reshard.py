"""Elastic re-sharding (answers `src/repro/checkpoint/reshard.py`):
restore a checkpoint onto a different device mesh, and map surviving
per-lane GreedyML solutions onto a re-planned (smaller) accumulation
tree after a lane loss.

Checkpoints hold whole arrays, so resharding is resolving fresh specs
against the NEW mesh (sharding/axes.py) and distributing each restored
leaf under them.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import manager
from repro_torch.sharding.axes import (DEFAULT_PARAM_RULES, AxisRules,
                                       tree_shardings)


def restore_resharded(ckpt_dir: str, example_tree, axes_tree, mesh,
                      step: Optional[int] = None,
                      rules: AxisRules = DEFAULT_PARAM_RULES):
    """Restore onto `mesh` (a DeviceMesh with named dims) using the
    logical `axes_tree`: every leaf a DTensor under its resolved
    placements."""
    shardings = tree_shardings(axes_tree, example_tree, mesh, rules)
    return manager.restore(ckpt_dir, example_tree, step=step,
                           shardings=shardings)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def reshard_solutions(lane_sols, survivors: Sequence[int], new_lanes: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Map surviving per-lane solutions onto a smaller tree's leaf pools
    (the degraded-tree recovery path).

    ``lane_sols``: stacked per-lane state with ids (lanes, k), payloads
    (lanes, k, …) and valid (lanes, k) — a Solution, or the raw leaf
    pools. ``survivors``: the rows still alive. Each of the
    ``new_lanes`` leaves receives ⌈s/new_lanes⌉ survivor rows
    round-robin, concatenated into one pool of width P =
    ⌈s/new_lanes⌉·k, padded with id −1, zero payloads, invalid.
    Returns host-side (pool_ids int64, pool_payloads, pool_valid)
    stacked (new_lanes, P, …)."""
    survivors = list(survivors)
    if not survivors:
        raise ValueError("no surviving lanes to reshard")
    if new_lanes < 1 or new_lanes > len(survivors):
        raise ValueError(f"new_lanes={new_lanes} must be in "
                         f"[1, {len(survivors)}]")
    ids = _host(lane_sols.ids)[survivors]                # (s, k)
    pay = _host(lane_sols.payloads)[survivors]           # (s, k, …)
    val = _host(lane_sols.valid)[survivors]              # (s, k)
    s, k = ids.shape
    per = math.ceil(s / new_lanes)
    pool = per * k
    pool_ids = np.full((new_lanes, pool), -1, np.int64)
    pool_pay = np.zeros((new_lanes, pool) + pay.shape[2:], pay.dtype)
    pool_val = np.zeros((new_lanes, pool), bool)
    for j in range(s):
        lane, slot = j % new_lanes, j // new_lanes
        sl = slice(slot * k, (slot + 1) * k)
        pool_ids[lane, sl] = ids[j]
        pool_pay[lane, sl] = pay[j]
        pool_val[lane, sl] = val[j]
    return pool_ids, pool_pay, pool_val
