"""Fault tolerance: failure injection + checkpoint/restart supervision
(answers `src/repro/runtime/fault.py`).

``Supervisor.run`` drives a step function with periodic checkpoints; a
``WorkerFailure`` (injected in tests; a deployment maps a lost worker
here) restores the latest checkpoint and replays. Only WorkerFailure is
caught: a kernel's build or launch error, or a CUDA error, propagates.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint import manager


class WorkerFailure(RuntimeError):
    """A lost worker (simulated by the injectors)."""


@dataclasses.dataclass
class FailureInjector:
    """Raises WorkerFailure the first time each configured step is reached."""

    fail_at_steps: tuple = ()
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise WorkerFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class Supervisor:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 10
    injector: Optional[FailureInjector] = None
    events: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def run(self, state, step_fn: Callable, num_steps: int,
            save_extra: Optional[Callable] = None):
        """state: a tree of tensors; step_fn(state, step) → (state,
        metrics). Returns (state, steps done).

        ``max_restarts`` bounds restarts PER RECOVERY EPISODE (between
        two successful checkpoints): a checkpoint is progress, so later
        independent failures get a fresh budget. A failure before the
        first checkpoint cold-restarts from the caller's initial
        ``state`` (logged as ``cold_restart``)."""
        initial = state
        state, step = self._restore_or(state)
        restarts = 0
        while step < num_steps:
            try:
                if self.injector is not None:
                    self.injector.check(step)
                state, metrics = step_fn(state, step)
                step += 1
                if step % self.ckpt_every == 0 or step == num_steps:
                    extra = {"metrics": {k: float(v) for k, v in
                                         (metrics or {}).items()}}
                    if save_extra:
                        extra.update(save_extra(state, step))
                    manager.save(self.ckpt_dir, step, state, extra=extra,
                                 keep=self.keep)
                    self.events.append({"kind": "checkpoint", "step": step})
                    restarts = 0          # progress → fresh retry budget
            except WorkerFailure as e:
                restarts += 1
                self.events.append({"kind": "failure", "step": step,
                                    "error": str(e)})
                if restarts > self.max_restarts:
                    raise
                state, step = self._restore_or((initial, 0), force=True)
                self.events.append({"kind": "restart", "step": step})
        return state, step

    def _restore_or(self, default, force: bool = False):
        last = manager.latest_step(self.ckpt_dir)
        if last is None:
            state, step = (default if isinstance(default, tuple)
                           else (default, 0))
            if force:
                # failure before the first checkpoint: restart from the
                # caller's initial state instead of refusing to recover
                self.events.append({"kind": "cold_restart", "step": step})
            return state, step
        example = default[0] if isinstance(default, tuple) else default
        state, manifest = manager.restore(self.ckpt_dir, example, step=last)
        return state, manifest["step"]
