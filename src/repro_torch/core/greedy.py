"""Vectorized Greedy, batched (answers `src/repro/core/greedy.py`).

Every step evaluates all candidate gains and takes a masked first-argmax
— identical selections to the reference. `greedy_batch` runs B greedies
at once (the leaves of a level, or its nodes) so the kernels launch once
for the whole batch; `greedy` is the one-pool entry point.

Engines, resolved once per invocation by `plans.select_engine`:
  * 'auto'  — megakernel when the tier gate admits it; fused when the
              cache fits; per-step otherwise
  * 'mega'  — the whole-greedy loop kernels (2 launches streaming,
              1 resident)
  * 'fused' — cached matrix + one fused step per selection
  * 'step'  — recompute-per-step
All make identical selections. The fused and per-step engines run on the
CPU only in this slice (their kernels are not ported; CUDA tensors
raise). ``constraint=`` and ``sample=`` raise NotImplementedError: the
constraints module is the next slice.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import plans
from repro_torch.kernels import rules as R

F32 = torch.float32


@dataclasses.dataclass
class Solution:
    """Fixed-shape solution(s); a leading batch dim when batched."""
    ids: torch.Tensor          # (…, k) int64 global element ids (-1 = empty)
    payloads: torch.Tensor     # (…, k, D|W) element payloads
    valid: torch.Tensor        # (…, k) bool
    value: torch.Tensor        # (…,) f32 objective value on the eval set
    evals: torch.Tensor        # (…,) int64 marginal-gain evaluations

    @property
    def k(self) -> int:
        return self.ids.shape[-1]

    def map(self, fn) -> "Solution":
        return Solution(*(fn(getattr(self, f.name))
                          for f in dataclasses.fields(self)))


def _on(objective, x, dtype=None):
    return torch.as_tensor(x, device=objective.device, dtype=dtype)


def _gather_rows(x, idx):
    """x (B, n, …) rows at idx (B, k) → (B, k, …)."""
    shape = idx.shape + x.shape[2:]
    flat = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, flat)


def greedy(objective, ids, payloads, valid, k: int, ground=None,
           ground_valid=None, sample: int = 0, key=None, constraint=None,
           engine: str = "auto") -> Solution:
    """Select ≤ k elements of ONE pool maximizing the objective, on the
    objective's device. ids/payloads/valid: (n, …); ground/ground_valid
    override the evaluation set (default: the pool itself)."""
    def batch(x):
        return None if x is None else _on(objective, x).unsqueeze(0)

    sol = greedy_batch(objective, batch(ids), batch(payloads),
                       batch(valid), k, ground=batch(ground),
                       ground_valid=batch(ground_valid), sample=sample,
                       key=key, constraint=constraint, engine=engine)
    return sol.map(lambda x: x[0])


def greedy_batch(objective, ids, payloads, valid, k: int, ground=None,
                 ground_valid=None, sample: int = 0, key=None,
                 constraint=None, engine: str = "auto") -> Solution:
    """B greedies at once: ids/valid (B, n), payloads (B, n, D|W),
    ground (B, N, D) / ground_valid (B, N) optional."""
    if constraint is not None:
        raise NotImplementedError("constrained greedy waits for the port "
                                  "of core/constraints.py")
    if 0 < sample < ids.shape[-1]:
        raise NotImplementedError("stochastic greedy waits for the port "
                                  "of core/constraints.py")
    del key
    ids = _on(objective, ids, torch.int64)
    payloads = _on(objective, payloads)
    valid = _on(objective, valid, torch.bool)
    if ground is None:
        ground, ground_valid = payloads, valid
    else:
        ground = _on(objective, ground)
        ground_valid = _on(objective, ground_valid, torch.bool)
    state = objective.init_state(ground, ground_valid)
    plan = plans.select_engine(
        objective.rule, *objective.plan_dims(state, payloads),
        requested=engine, replicas=ids.shape[0])

    if plan.engine in ("mega_stream", "mega_resident"):
        mega = objective.megakernel_loop(state, payloads, valid, k,
                                         plan=plan)
        if mega is not None:
            return _finalize_mega(objective, mega, ids, payloads, valid, k)
    cache = None
    if plan.engine == "fused":
        cache = objective.prepare(state, payloads, valid, plan=plan)
    if cache is not None:
        return _greedy_fused(objective, state, cache, ids, payloads, valid,
                             k)
    return _greedy_step(objective, state, ids, payloads, valid, k)


def _emit(ids, payloads, best, accept):
    """(ids (B,), payloads (B, …), accept (B,)) of one step's winners."""
    out_ids = torch.where(accept, ids.gather(1, best[:, None])[:, 0],
                          torch.full_like(best, -1))
    pay = _gather_rows(payloads, best[:, None])[:, 0]
    keep = accept.reshape(accept.shape + (1,) * (pay.dim() - 1))
    return out_ids, torch.where(keep, pay, torch.zeros_like(pay))


def _finish(objective, state, steps, evals) -> Solution:
    out_ids, out_pay, out_valid = (torch.stack(x, 1) for x in zip(*steps))
    return Solution(out_ids, out_pay, out_valid, objective.value(state),
                    evals)


def _greedy_step(objective, state, ids, payloads, valid, k) -> Solution:
    """Recompute-per-step engine: gains of all candidates, first argmax,
    accept if finite and > 0, fold the winner with the direct-difference
    column (rules.update_row)."""
    b, n = ids.shape
    selected = torch.zeros((b, n), dtype=torch.bool, device=ids.device)
    evals = torch.zeros(b, dtype=torch.int64, device=ids.device)
    steps = []
    for _ in range(k):
        cand_valid = valid & ~selected
        g = objective.gains(state, payloads, cand_valid)
        best, gain = R.masked_argmax(g, torch.ones_like(g))
        accept = torch.isfinite(gain) & (gain > 0)
        payload = _gather_rows(payloads, best[:, None])[:, 0]
        new_row = objective.update(state, payload).row
        keep = accept.unsqueeze(-1)
        state = dataclasses.replace(
            state, row=torch.where(keep, new_row, state.row))
        selected = selected | (torch.nn.functional.one_hot(best, n).bool()
                               & keep)
        evals = evals + cand_valid.sum(-1)
        steps.append(_emit(ids, payloads, best, accept) + (accept,))
    if not steps:
        return _empty(objective, state, payloads, evals)
    return _finish(objective, state, steps, evals)


def _greedy_fused(objective, state, cache, ids, payloads, valid,
                  k) -> Solution:
    """Cached-matrix engine: one fused step (deferred winner fold +
    masked gains + first argmax) per selection, then the final flush."""
    b, n = ids.shape
    selected = torch.zeros((b, n), dtype=torch.bool, device=ids.device)
    evals = torch.zeros(b, dtype=torch.int64, device=ids.device)
    prev = torch.full((b,), -1, dtype=torch.int64, device=ids.device)
    steps = []
    for _ in range(k):
        cand_mask = valid & ~selected
        state, best, gain = objective.fused_step(state, cache, cand_mask,
                                                 prev)
        accept = torch.isfinite(gain) & (gain > 0)
        selected = selected | (torch.nn.functional.one_hot(best, n).bool()
                               & accept.unsqueeze(-1))
        prev = torch.where(accept, best, torch.full_like(best, -1))
        evals = evals + cand_mask.sum(-1)
        steps.append(_emit(ids, payloads, best, accept) + (accept,))
    state = objective.flush_pending(state, cache, prev)
    if not steps:
        return _empty(objective, state, payloads, evals)
    return _finish(objective, state, steps, evals)


def _empty(objective, state, payloads, evals) -> Solution:
    b = payloads.shape[0]
    dev = payloads.device
    return Solution(torch.zeros((b, 0), dtype=torch.int64, device=dev),
                    payloads[:, :0], torch.zeros((b, 0), dtype=torch.bool,
                                                 device=dev),
                    objective.value(state), evals)


def _finalize_mega(objective, mega, ids, payloads, valid, k) -> Solution:
    """Assemble Solutions from the loop kernels' per-step outputs; evals
    reproduces the per-step count (each step evaluates every valid,
    unselected candidate)."""
    state, bests, _gains = mega
    ok = bests >= 0
    safe = torch.clamp(bests, min=0)
    out_ids = torch.where(ok, ids.gather(1, safe), torch.full_like(safe, -1))
    pay = _gather_rows(payloads, safe)
    keep = ok.reshape(ok.shape + (1,) * (pay.dim() - 2))
    out_pay = torch.where(keep, pay, torch.zeros_like(pay))
    total = valid.sum(-1, keepdim=True)
    okl = ok.to(torch.int64)
    accepted_before = torch.cumsum(okl, -1) - okl
    evals = (total - accepted_before).sum(-1)
    return Solution(out_ids, out_pay, ok, objective.value(state), evals)


def replay_value(objective, payloads, valid, ground, ground_valid):
    """f(S) of existing solutions (B, k, …) on (new) ground sets
    (B, N, …): one pairwise launch folds all k elements of all B
    solutions (Algorithm 3.1, line 15)."""
    state = objective.init_state(ground, ground_valid)
    return objective.value(objective.replay_batch(state, payloads, valid))


def select_better(a: Solution, b: Solution) -> Solution:
    """Elementwise argmax{f(a), f(b)} over (batched) solutions; evals
    chain (a.evals + b.evals)."""
    take_a = a.value >= b.value

    def pick(x, y):
        t = take_a.reshape(take_a.shape + (1,) * (x.dim() - take_a.dim()))
        return torch.where(t, x, y)

    return Solution(pick(a.ids, b.ids), pick(a.payloads, b.payloads),
                    pick(a.valid, b.valid), pick(a.value, b.value),
                    a.evals + b.evals)
