"""Vectorized Greedy, batched (answers `src/repro/core/greedy.py`).

Every step evaluates all candidate gains and takes a masked first-argmax
— identical selections to the reference. `greedy_batch` runs B greedies
at once (the leaves of a level, or its nodes) so the kernels launch once
for the whole batch; `greedy` is the one-pool entry point.

Engines, resolved once per invocation by `plans.select_engine`:
  * 'auto'  — megakernel when the tier gate admits it and neither a
              constraint nor sampling is active; fused when the cache
              fits and sampling is off; per-step otherwise
  * 'mega'  — the whole-greedy loop kernels (2 launches streaming,
              1 resident); fused under a constraint or sampling
  * 'fused' — cached matrix + one fused_step launch per selection
  * 'step'  — one gains launch per selection, no cache
All make identical selections, except on EXACT gain ties under
sampling, where the step engine keeps the candidate first in sample
order and the fused engine the lowest pool index (as in the reference).

``constraint=``: a pool-bound constraint of core/constraints.py with the
batch's leading dimension (B, n) — infeasible candidates are masked each
step, the state updates on acceptance, all on the device.
``sample=s`` (0 < s < n): stochastic greedy — each step evaluates a
uniform s-subset of the pool drawn without replacement
(`_sample_candidates`); the draws come from ``key`` (a torch.Generator,
drawn from greedy after greedy) or are handed in whole as ``cand_idx``
(B, k, s).
torch's generators do not reproduce JAX's PRNG stream: the reference's
draws can be passed as ``cand_idx``. The k-step loops make no host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.constraints import select_state
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


def _payloads_on(objective, x):
    """Pool payloads on the objective's device; bitmap words as int32
    (rules.to_words: a no-op for words already narrowed, as
    run_tree_dense and the dispatcher's lanes hold them)."""
    if objective.rule.is_bitmap:
        return R.to_words(x).to(objective.device)
    return _on(objective, x)


def _gather_rows(x, idx):
    """x (B, n, …) rows at idx (B, k) → (B, k, …)."""
    shape = idx.shape + x.shape[2:]
    flat = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, flat)


def greedy(objective, ids, payloads, valid, k: int, ground=None,
           ground_valid=None, sample: int = 0, key=None, constraint=None,
           engine: str = "auto", cand_idx=None) -> Solution:
    """Select ≤ k elements of ONE pool maximizing the objective, on the
    objective's device. ids/payloads/valid: (n, …); ground/ground_valid
    override the evaluation set (default: the pool itself); constraint:
    pool-bound, unbatched; cand_idx: (k, sample) draws."""
    def batch(x):
        return None if x is None else _on(objective, x).unsqueeze(0)

    sol = greedy_batch(objective, batch(ids), batch(payloads),
                       batch(valid), k, ground=batch(ground),
                       ground_valid=batch(ground_valid), sample=sample,
                       key=key, constraint=(None if constraint is None
                                            else constraint.lift()),
                       engine=engine, cand_idx=batch(cand_idx))
    return sol.map(lambda x: x[0])


def _sample_candidates(generator: Optional[torch.Generator], k: int, n: int,
                       sample: int) -> torch.Tensor:
    """(k, sample) stochastic-greedy draws of one pool: each step a
    uniform `sample`-subset of range(n) WITHOUT replacement (the paper's
    uniform s-subset), in random order — the `sample` largest of n
    uniform keys. Drawn on the generator's device (the CPU by default)."""
    dev = generator.device if generator is not None else "cpu"
    keys = torch.rand((k, n), generator=generator, device=dev)
    return keys.topk(sample, dim=-1).indices


def greedy_batch(objective, ids, payloads, valid, k: int, ground=None,
                 ground_valid=None, sample: int = 0,
                 key: Optional[torch.Generator] = None, constraint=None,
                 engine: str = "auto", cand_idx=None) -> Solution:
    """B greedies at once: ids/valid (B, n), payloads (B, n, D|W),
    ground (B, N, D) / ground_valid (B, N) optional, constraint with
    leading dim B, cand_idx (B, k, sample) optional."""
    ids = _on(objective, ids, torch.int64)
    payloads = _payloads_on(objective, payloads)
    valid = _on(objective, valid, torch.bool)
    b, n = ids.shape
    if ground is None:
        ground, ground_valid = payloads, valid
    else:
        ground = _payloads_on(objective, ground)
        ground_valid = _on(objective, ground_valid, torch.bool)
    sampling = 0 < sample < n
    if sampling:
        if cand_idx is None:
            cand_idx = torch.stack([_sample_candidates(key, k, n, sample)
                                    for _ in range(b)])
        cand_idx = _on(objective, cand_idx, torch.int64)
        if tuple(cand_idx.shape) != (b, k, sample):
            raise ValueError(f"cand_idx: shape {tuple(cand_idx.shape)}, "
                             f"expected {(b, k, sample)}")
    else:
        cand_idx = None
    state = objective.init_state(ground, ground_valid)
    plan = plans.select_engine(
        objective.rule, *objective.plan_dims(state, payloads),
        requested=engine, sampling=sampling,
        constrained=constraint is not None, replicas=b,
        device=objective.device.type)

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
                             k, constraint, cand_idx)
    return _greedy_step(objective, state, ids, payloads, valid, k,
                        constraint, cand_idx)


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


def _accept_constraint(constraint, cstate, best, accept):
    if constraint is None:
        return cstate
    return select_state(accept, constraint.update(cstate, best), cstate)


def _greedy_step(objective, state, ids, payloads, valid, k, constraint=None,
                 cand_idx=None) -> Solution:
    """Recompute-per-step engine: gains of all candidates (or of the
    step's sample, first argmax in sample order), accept if finite and
    > 0, fold the winner with the direct-difference column
    (rules.update_row). The ground is prepared once, before the first
    step (RuleObjective.prepare_ground: int8 under a forced int8 rung,
    its 'dist' norms)."""
    b, n = ids.shape
    state = objective.prepare_ground(state)
    selected = torch.zeros((b, n), dtype=torch.bool, device=ids.device)
    evals = torch.zeros(b, dtype=torch.int64, device=ids.device)
    cstate = constraint.init_state() if constraint is not None else None
    steps = []
    for s in range(k):
        cand_valid = valid & ~selected
        if constraint is not None:
            cand_valid = cand_valid & constraint.feasible_mask(cstate)
        if cand_idx is not None:
            idx = cand_idx[:, s]
            sub_valid = cand_valid.gather(1, idx)
            g = objective.gains(state, _gather_rows(payloads, idx),
                                sub_valid)
            local, gain = R.masked_argmax(g, torch.ones_like(g))
            best = idx.gather(1, local[:, None])[:, 0]
            n_evals = sub_valid.sum(-1)
        else:
            g = objective.gains(state, payloads, cand_valid)
            best, gain = R.masked_argmax(g, torch.ones_like(g))
            n_evals = cand_valid.sum(-1)
        accept = torch.isfinite(gain) & (gain > 0)
        payload = _gather_rows(payloads, best[:, None])[:, 0]
        new_row = objective.update(state, payload).row
        keep = accept.unsqueeze(-1)
        state = dataclasses.replace(
            state, row=torch.where(keep, new_row, state.row))
        selected = selected | (torch.nn.functional.one_hot(best, n).bool()
                               & keep)
        cstate = _accept_constraint(constraint, cstate, best, accept)
        evals = evals + n_evals
        steps.append(_emit(ids, payloads, best, accept) + (accept,))
    if not steps:
        return _empty(objective, state, payloads, evals)
    return _finish(objective, state, steps, evals)


def _greedy_fused(objective, state, cache, ids, payloads, valid, k,
                  constraint=None, cand_idx=None) -> Solution:
    """Cached-matrix engine: one fused step (deferred winner fold +
    masked gains + first argmax) per selection, then the final flush.
    Under sampling the step's mask keeps only its sample (argmax: lowest
    pool index)."""
    b, n = ids.shape
    selected = torch.zeros((b, n), dtype=torch.bool, device=ids.device)
    evals = torch.zeros(b, dtype=torch.int64, device=ids.device)
    prev = torch.full((b,), -1, dtype=torch.int64, device=ids.device)
    cstate = constraint.init_state() if constraint is not None else None
    steps = []
    for s in range(k):
        cand_mask = valid & ~selected
        if constraint is not None:
            cand_mask = cand_mask & constraint.feasible_mask(cstate)
        if cand_idx is not None:
            idx = cand_idx[:, s]
            in_sample = torch.zeros_like(cand_mask).scatter(1, idx, True)
            step_mask = cand_mask & in_sample
            n_evals = cand_mask.gather(1, idx).sum(-1)
        else:
            step_mask = cand_mask
            n_evals = cand_mask.sum(-1)
        state, best, gain = objective.fused_step(state, cache, step_mask,
                                                 prev)
        accept = torch.isfinite(gain) & (gain > 0)
        selected = selected | (torch.nn.functional.one_hot(best, n).bool()
                               & accept.unsqueeze(-1))
        cstate = _accept_constraint(constraint, cstate, best, accept)
        prev = torch.where(accept, best, torch.full_like(best, -1))
        evals = evals + n_evals
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
    # rejected steps' payloads zeroed in place: (B, k, D) is 315 MB at the
    # Tiny-ImageNet leaves, and a where() would hold it three times
    pay = _gather_rows(payloads, safe)
    out_pay = pay.masked_fill_(~ok.reshape(ok.shape + (1,) * (pay.dim() - 2)),
                               0)
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
