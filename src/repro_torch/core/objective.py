"""The objective protocol in PyTorch (answers `src/repro/core/objective.py`).

One generic `RuleObjective` implements the engine interface from a
single `KernelRule`. Every method works on a batch of B greedies — the
leaves of a tree level, or its nodes — so the kernels behind it run
once per level, where the reference vmapped one greedy:

  init_state(ground, ground_valid)         → RuleState of EMPTY solutions
  value(state)                             → (B,) f(S) on each eval set
  gains(state, cands, cand_valid)          → (B, C) normalized gains
                                             (the gains kernel)
  prepare_ground(state)                    → state with its ground as
                                             the gains read it, once per
                                             greedy (the step engine):
                                             int8 beside it under a
                                             forced int8 rung, and its
                                             'dist' norms
  update(state, payload)                   → state after one element each
  plan_dims(state, cands)                  → (n, c, d) for select_engine
  prepare(state, cands, cand_valid[, plan]) → (matrix, EnginePlan) | None
  fused_step(state, cache, cand_mask, prev) → (state, best, gain)
                                             (the fused_step kernel)
  flush_pending(state, cache, prev)        → state
  megakernel_loop(state, cands, cand_valid, k[, plan])
                                           → (state, bests, gains) | None
  replay_batch(state, payloads, valid)     → state

The batched serving path (`megakernel_loop_batched`) waits for the
serving slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops, plans
from repro_torch.kernels import rules as R
from repro_torch.kernels.plans import EnginePlan
from repro_torch.kernels.rules import KernelRule
from repro_torch.runtime import flags
from repro_torch.runtime.device import DeviceLike, resolve_device

F32 = torch.float32


@dataclasses.dataclass
class RuleState:
    """Selection state of B greedies. ground/gvalid are None for bitmap
    rules; `base` is the value offset (k-medoid's L({e0}) term, 0
    elsewhere); `n_eff` the valid-ground normalizer (1 for bitmaps);
    `gquant` the ground's int8 storage (q (B, N, D), scale (B, 1, N))
    when the step engine runs under a forced int8 rung, else None;
    `gnorm` the stored ground's (B, N) 'dist' norms, which the step
    engine takes once per greedy for the gains kernel, else None."""
    ground: Optional[torch.Tensor]    # (B, N, D) evaluation features
    gvalid: Optional[torch.Tensor]    # (B, N) bool
    row: torch.Tensor                 # (B, N) f32 | (B, W) int32 words
    base: torch.Tensor                # (B,) f32
    n_eff: torch.Tensor               # (B,) f32
    gquant: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    gnorm: Optional[torch.Tensor] = None


class RuleObjective:
    """A submodular objective defined entirely by its KernelRule, bound to
    the device its tensors live on."""

    def __init__(self, rule: KernelRule, *, name: Optional[str] = None,
                 words: int = 0, device: DeviceLike = None):
        if rule.is_bitmap and words <= 0:
            raise ValueError("bitmap rules need a universe size")
        self.rule = rule
        self.name = name or rule.name
        self.words = words
        self.device = resolve_device(device)

    # -- state ---------------------------------------------------------------

    def init_state(self, ground, ground_valid) -> RuleState:
        batch = tuple(ground_valid.shape[:-1])
        if self.rule.is_bitmap:
            row = R.empty_row(None, None, self.rule, words=self.words,
                              batch=batch, device=self.device)
            return RuleState(None, None, row,
                             torch.zeros(batch, dtype=F32,
                                         device=self.device),
                             torch.ones(batch, dtype=F32,
                                        device=self.device))
        row = R.empty_row(ground, ground_valid, self.rule)
        n_eff = torch.clamp(ground_valid.to(F32).sum(-1), min=1.0)
        base = (row.sum(-1) / n_eff if self.rule.fold == "min"
                else torch.zeros_like(n_eff))
        return RuleState(ground, ground_valid, row, base, n_eff)

    def value(self, state: RuleState):
        if self.rule.is_bitmap:
            return R.popcount(state.row).sum(-1).to(F32)
        zero = torch.zeros_like(state.row)
        if self.rule.fold == "sum":
            t = torch.clamp(state.row, max=self.rule.cap)
            w = (self.rule.lam * torch.clamp(state.row, max=R.BIG)
                 + (1.0 - self.rule.lam)
                 * (t - t * t / (2.0 * self.rule.cap)))
            return torch.where(state.gvalid, w, zero).sum(-1) / state.n_eff
        tot = torch.where(state.gvalid, state.row, zero).sum(-1)
        if self.rule.fold == "min":
            return state.base - tot / state.n_eff
        return tot / state.n_eff

    # -- per-step engine -----------------------------------------------------

    def prepare_ground(self, state: RuleState) -> RuleState:
        """The ground as the per-step gains read it, held beside the
        state once per greedy — its rows do not change over the steps:
        under REPRO_TORCH_FUSED_CACHE_DTYPE=int8 per-row-quantized, as in
        the reference (1 byte an entry; at the stochastic Tiny-ImageNet
        leaves quantizing every step would re-read 4.9 GB of f32), and
        for a 'dist' rule the stored rows' norms (`ops.gains_norms`,
        which the kernel would otherwise take every step). Bitmap rules
        leave the state as it is."""
        if self.rule.is_bitmap:
            return state
        if state.gquant is None and flags.fused_cache_dtype() == "int8":
            state = dataclasses.replace(
                state, gquant=ops.quantize_ground(state.ground))
        if state.gnorm is None and self.rule.pairwise == "dist":
            g, gs = (state.gquant if state.gquant is not None
                     else (state.ground, None))
            state = dataclasses.replace(state, gnorm=ops.gains_norms(g, gs))
        return state

    def gains(self, state: RuleState, cands, cand_valid):
        if state.gquant is not None:
            raw = ops.gains(state.gquant[0], state.row, cands, cand_valid,
                            self.rule, gscale=state.gquant[1],
                            gnorm=state.gnorm)
        else:
            raw = ops.gains(state.ground, state.row, cands, cand_valid,
                            self.rule, gnorm=state.gnorm)
        return torch.where(torch.isfinite(raw),
                           raw / state.n_eff.unsqueeze(-1), raw)

    def update(self, state: RuleState, payload) -> RuleState:
        row = R.update_row(state.ground, state.row, payload, self.rule)
        return dataclasses.replace(state, row=row)

    # -- planning ------------------------------------------------------------

    def plan_dims(self, state: RuleState, cands
                  ) -> Tuple[int, int, Optional[int]]:
        """(ground rows, candidates, feature dim); bitmap rules plan over
        universe WORDS with no feature dim."""
        if self.rule.is_bitmap:
            return state.row.shape[-1], cands.shape[-2], None
        return (state.ground.shape[-2], cands.shape[-2],
                state.ground.shape[-1])

    def _plan(self, state, cands, requested: str, sampling: bool = False,
              constrained: bool = False) -> EnginePlan:
        n, c, d = self.plan_dims(state, cands)
        return plans.select_engine(self.rule, n, c, d, requested=requested,
                                   sampling=sampling,
                                   constrained=constrained,
                                   replicas=state.row.shape[0])

    # -- fused cached-matrix engine ------------------------------------------

    def prepare(self, state: RuleState, cands, cand_valid,
                plan: Optional[EnginePlan] = None):
        """The cached matrices + the plan every step consumes; None in
        the memory-capped regime."""
        del cand_valid
        if plan is None:
            plan = self._plan(state, cands, "fused")
        if not plan.cached:
            return None
        mat = ops.pairwise_matrix(state.ground, cands, self.rule,
                                  dtype=plan.dtype)
        return mat, plan

    def fused_step(self, state: RuleState, cache, cand_mask, prev):
        mat, plan = cache
        row, best, gain = ops.fused_step(mat, state.row, cand_mask, prev,
                                         self.rule, plan=plan)
        return (dataclasses.replace(state, row=row), best,
                gain / state.n_eff)

    def flush_pending(self, state: RuleState, cache, prev) -> RuleState:
        row = ops.apply_column(cache[0], state.row, prev, self.rule)
        return dataclasses.replace(state, row=row)

    # -- whole-greedy megakernel ---------------------------------------------

    def megakernel_loop(self, state: RuleState, cands, cand_valid, k: int,
                        plan: Optional[EnginePlan] = None):
        """All k steps of all B greedies: 1 launch on the resident tier,
        2 (pairwise + loop) on the streaming tier; None when the planner
        refuses both."""
        if plan is None:
            plan = self._plan(state, cands, "mega")
        if plan.engine == "mega_resident":
            out = ops.greedy_loop_resident(state.ground, cands, state.row,
                                           cand_valid, k, self.rule,
                                           cache_dtype=plan.dtype)
        elif plan.engine == "mega_stream":
            mat = ops.pairwise_matrix(state.ground, cands, self.rule,
                                      dtype=plan.dtype)
            out = ops.greedy_loop(mat, state.row, cand_valid, k, self.rule,
                                  plan=plan)
        else:
            return None
        row, bests, gains = out
        return (dataclasses.replace(state, row=row), bests,
                gains / state.n_eff.unsqueeze(-1))

    # -- batched replay ------------------------------------------------------

    def replay_batch(self, state: RuleState, payloads, valid) -> RuleState:
        """All solution elements folded into a fresh state in ONE matrix
        pass (one pairwise launch for all B greedies)."""
        mat = ops.pairwise_matrix(state.ground, payloads, self.rule)
        row = ops.masked_col_reduce(mat, valid, state.row, self.rule)
        return dataclasses.replace(state, row=row)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[..., RuleObjective]] = {}
_ALIASES = {"kcover": "coverage", "kdom": "coverage",
            "facility_location": "facility"}

DEFAULT_SAT_CAP = 2.0
DEFAULT_GC_ALPHA = 0.5
DEFAULT_MMR_LAM = 0.5
DEFAULT_MMR_THETA = 2.0


def register(name: str, factory: Callable[..., RuleObjective]) -> None:
    """Register an objective factory."""
    _REGISTRY[name] = factory


def registry() -> Tuple[str, ...]:
    """Canonical registered objective names, sorted."""
    return tuple(sorted(_REGISTRY))


def _coverage_factory(universe: int = 0, device=None) -> RuleObjective:
    if universe <= 0:
        raise ValueError("coverage objectives need a universe size")
    return RuleObjective(R.BITS_OR, name="coverage",
                         words=(universe + 31) // 32, device=device)


def _kmedoid_factory(universe: int = 0, device=None) -> RuleObjective:
    return RuleObjective(R.DIST_MIN, name="kmedoid", device=device)


def _facility_factory(universe: int = 0, device=None) -> RuleObjective:
    return RuleObjective(R.DOT_MAX, name="facility", device=device)


def _satcover_factory(universe: int = 0, device=None,
                      cap: float = DEFAULT_SAT_CAP) -> RuleObjective:
    return RuleObjective(R.sat_sum(cap), name="satcover", device=device)


def _graphcut_factory(universe: int = 0, device=None,
                      alpha: float = DEFAULT_GC_ALPHA) -> RuleObjective:
    return RuleObjective(R.graph_cut(alpha), name="graphcut",
                         device=device)


def _mmr_factory(universe: int = 0, device=None,
                 lam: float = DEFAULT_MMR_LAM,
                 theta: float = DEFAULT_MMR_THETA) -> RuleObjective:
    return RuleObjective(R.mmr(lam, theta), name="mmr", device=device)


register("coverage", _coverage_factory)
register("kmedoid", _kmedoid_factory)
register("facility", _facility_factory)
register("satcover", _satcover_factory)
register("graphcut", _graphcut_factory)
register("mmr", _mmr_factory)


def make_objective(name: str, *, universe: int = 0,
                   device: DeviceLike = None, **params) -> RuleObjective:
    """Construct a registered objective on `device` (default: the CUDA
    device; raises without one). 'kcover'/'kdom' alias coverage,
    'facility_location' aliases facility."""
    key = _ALIASES.get(name, name)
    if key not in _REGISTRY:
        raise KeyError(name)
    return _REGISTRY[key](universe=universe, device=device, **params)
