"""Single-device GreedyML accumulation tree T(m, L, b) (answers
`src/repro/core/simulate.py`: `partition`, `global_value`,
`run_tree_dense`, `run_greedy_dense`, and the lazy engine's
`SparseCoverage`, `DenseMedoid`, `lazy_greedy`, `run_tree_lazy`,
`run_greedy_lazy`).

Two engines with the same tree semantics. The DENSE engine is the
paper's algorithm on the kernels, below. The LAZY engine is the paper's
own implementation: Minoux's lazy greedy over a `heapq` of (−gain, e,
stamp), counting every marginal it evaluates — the function calls of
the paper's Fig. 4/5 and Table 3 (`per_node_evals`, `evals_total`,
`evals_critical` on the id-0 chain, `comm_elements`), exactly the
reference's counts. `SparseCoverage` keeps the reference's adjacency
lists on the host (a marginal is a gather of ~15 entries: a launch
would cost more than the work); `DenseMedoid` keeps its ground and
min-distance row as torch tensors on its device (the card unless the
caller names one), each marginal the direct difference ‖ground − x_e‖
(as the reference's, not the expansion of fault F0), the heap's first
fill in batches of candidates.

Where the reference vmapped greedy over the m leaves and over a level's
nodes, the port passes a batch dimension: every leaf greedy of a run is
one batched call (2 kernel launches on the streaming tier: pairwise +
loop), every level's node greedies one more (1 launch on the resident
tier), plus one pairwise launch per level that re-scores the same-id
child's solution S_prev for argmax{f(S), f(S_prev)}.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.functions import make_objective
from repro_torch.core.greedy import greedy, greedy_batch, replay_value, \
    select_better
from repro_torch.core.tree import AccumulationTree
from repro_torch.kernels import rules as R
from repro_torch.runtime.device import DeviceLike, resolve_device

F32 = torch.float32


@dataclasses.dataclass
class SimResult:
    value: float
    ids: np.ndarray                 # selected global element ids (≤ k)
    evals_total: int
    evals_critical: int             # id-0 chain (parallel-runtime proxy)
    per_node_evals: Dict[Tuple[int, int], int]
    comm_elements: int              # total solution elements communicated
    levels: int
    machines: int
    branching: int
    root_value: float = float("nan")  # f(S) on the root's own ground set


def partition(n: int, m: int, seed: int) -> np.ndarray:
    """The paper's random tape: each element iid uniform over machines."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, m, size=n)


def _kmedoid_global(x: torch.Tensor, ids: torch.Tensor,
                    chunk: int = 16_384) -> float:
    """k-medoid on the full set with the direct difference (as the
    reference's numpy loop), chunked over rows."""
    mind = torch.linalg.vector_norm(x, dim=1)          # d(·, e0)
    base = mind.mean()
    for e in ids.tolist():
        xe = x[e]
        for i in range(0, x.shape[0], chunk):
            d = torch.linalg.vector_norm(x[i:i + chunk] - xe, dim=1)
            mind[i:i + chunk] = torch.minimum(mind[i:i + chunk], d)
    return float(base - mind.mean())


def global_value(objective_name: str, data: Any, ids,
                 universe: int = 0, device: DeviceLike = None) -> float:
    """f(S) on the FULL ground set — the reporting convention. Bitmap
    data is scored in numpy; feature data in torch on the data's device
    (a tensor's own, else `device`)."""
    ids = np.asarray(torch.as_tensor(ids).cpu())
    ids = ids[ids >= 0]
    if objective_name in ("kcover", "kdom"):
        if isinstance(data, torch.Tensor):   # words: fetch the ids' rows only
            sel = torch.as_tensor(ids, dtype=torch.int64, device=data.device)
            data = R.to_words(data[sel]).cpu().numpy().view(np.uint32)
            ids = np.arange(len(ids))
        if not isinstance(data, (list, tuple)):     # adjacency lists stay
            data = np.asarray(data)
        if isinstance(data, np.ndarray) and data.dtype == np.uint32:
            cov = np.zeros(data.shape[1], np.uint32)
            for e in ids:
                cov |= data[e]
            return float(np.unpackbits(cov.view(np.uint8)).sum())
        covered = np.zeros(universe, bool)
        for e in ids:
            covered[data[e]] = True
        return float(covered.sum())
    dev = data.device if isinstance(data, torch.Tensor) \
        else resolve_device(device)
    x = torch.as_tensor(data, dtype=F32, device=dev)
    idx = torch.as_tensor(ids, dtype=torch.int64, device=dev)
    if objective_name == "kmedoid":
        return _kmedoid_global(x, idx)
    if objective_name == "facility":
        if idx.numel() == 0:
            return 0.0
        sims = x @ x[idx].T
        return float(torch.clamp(sims.amax(dim=1), min=0.0).mean())
    raise KeyError(objective_name)


def _payload_tensor(payloads, dev, bitmap: bool) -> torch.Tensor:
    """(n, …) payloads on `dev`. Bitmap words are narrowed to int32 where
    they enter (rules.to_words: a numpy uint32 array is reinterpreted,
    not copied, before its one copy to the device)."""
    if bitmap:
        return R.to_words(payloads).to(dev)
    if isinstance(payloads, torch.Tensor):
        return payloads.to(dev)
    return torch.as_tensor(np.asarray(payloads), device=dev)


def _pools(assign: np.ndarray, m: int):
    """Per-machine pools of element ids in ascending order, -1 padded —
    the reference's element loop, vectorized: (m, n_max) ids + valid."""
    n = assign.shape[0]
    counts = np.bincount(assign, minlength=m)
    n_max = int(counts.max()) if n else 0
    order = np.argsort(assign, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(n) - starts[assign[order]]
    pool_ids = np.full((m, n_max), -1, np.int64)
    pool_ids[assign[order], slot] = order
    return pool_ids, pool_ids >= 0


def run_tree_dense(objective_name: str, payloads, k: int,
                   tree: AccumulationTree, seed: int = 0, *,
                   universe: int = 0, augment: int = 0,
                   engine: str = "auto",
                   node_engine: Optional[str] = None,
                   drop_leaves: Sequence[int] = (),
                   device: DeviceLike = None,
                   on_level: Optional[Callable[[int], None]] = None
                   ) -> SimResult:
    """The GreedyML tree on one device. ``payloads``: (n, D) features or
    (n, W) uint32 bitmaps, numpy or a tensor (kept on its device).
    ``engine`` drives the leaf greedies, ``node_engine`` (default:
    inherit) the accumulation nodes; ``drop_leaves`` invalidates lost
    partitions. ``on_level(lvl)`` is called after each level is issued
    (0 = the leaves) — a hook for timing and launch counting."""
    node_engine = node_engine or engine
    obj = make_objective(objective_name, universe=universe, device=device)
    dev = obj.device
    pay_t = _payload_tensor(payloads, dev, obj.rule.is_bitmap)
    n = pay_t.shape[0]
    m, b, L = tree.m, tree.b, tree.num_levels
    assign = partition(n, m, seed)
    pool_ids, pool_valid = _pools(assign, m)
    for mi in drop_leaves:
        pool_valid[mi] = False          # lost partition → empty leaf
    ids_t = torch.as_tensor(pool_ids, device=dev)
    valid_t = torch.as_tensor(pool_valid, device=dev)
    pool_pay = pay_t[ids_t.clamp(min=0)]
    pool_pay[ids_t < 0] = 0
    rng = np.random.default_rng(seed + 1)

    sols = greedy_batch(obj, ids_t, pool_pay, valid_t, k, engine=engine)
    if on_level is not None:
        on_level(0)
    per_node: Dict[Tuple[int, int], int] = {
        (0, i): int(e) for i, e in enumerate(sols.evals.tolist())}
    comm = 0
    level_ids = list(range(m))
    root_value = float("nan")

    for lvl in range(1, L + 1):
        nodes = tree.nodes_at_level(lvl)
        rows = np.full((len(nodes), b), -1, np.int64)
        for r, nid in enumerate(nodes):
            for j, cid in enumerate(tree.children_of(lvl, nid)):
                rows[r, j] = level_ids.index(cid)
        rows_t = torch.as_tensor(rows, device=dev)
        have = (rows_t >= 0).unsqueeze(-1)                      # (R, b, 1)
        child = sols.map(lambda x: x[rows_t.clamp(min=0)])
        u_ids = torch.where(have, child.ids,
                            torch.full_like(child.ids, -1)).flatten(1)
        u_val = (child.valid & have).flatten(1)
        u_pay = torch.where(have.unsqueeze(-1), child.payloads,
                            torch.zeros_like(child.payloads)).flatten(1, 2)
        comm += int(u_val.sum())
        ground, gval = u_pay, u_val
        if augment > 0 and objective_name in ("kmedoid", "facility"):
            idx = rng.integers(0, n, size=(len(nodes), augment))
            aug = pay_t[torch.as_tensor(idx, device=dev)]
            ground = torch.cat([u_pay, aug], dim=1)
            gval = torch.cat([u_val, torch.ones(aug.shape[:2],
                                                dtype=torch.bool,
                                                device=dev)], dim=1)
        new_sols = greedy_batch(obj, u_ids, u_pay, u_val, k, ground=ground,
                                ground_valid=gval, engine=node_engine)
        # argmax{f(S), f(S_prev)} — S_prev is the same-id child's solution
        prev_rows = torch.as_tensor([level_ids.index(nid) for nid in nodes],
                                    device=dev)
        prev = sols.map(lambda x: x[prev_rows])
        prev.value = replay_value(obj, prev.payloads, prev.valid, ground,
                                  gval)
        sols = select_better(new_sols, prev)
        if on_level is not None:
            on_level(lvl)
        for nid, e in zip(nodes, new_sols.evals.tolist()):
            per_node[(lvl, nid)] = int(e)
        level_ids = nodes
        root_value = float(sols.value[0])

    final = sols.map(lambda x: x[0])
    evals_critical = sum(per_node[(lvl, 0)] for lvl in range(L + 1))
    ids_out = final.ids[final.valid].cpu().numpy()
    payload_data = pay_t if objective_name in ("kmedoid", "facility") \
        else payloads
    gval_ = global_value(objective_name, payload_data, ids_out, universe)
    return SimResult(gval_, ids_out, int(sum(per_node.values())),
                     int(evals_critical), per_node, comm, L, m, b,
                     root_value=root_value)


def run_greedy_dense(objective_name: str, payloads, k: int, *,
                     universe: int = 0, engine: str = "auto",
                     device: DeviceLike = None) -> SimResult:
    """Sequential Greedy baseline (one node, whole data)."""
    obj = make_objective(objective_name, universe=universe, device=device)
    pay_t = _payload_tensor(payloads, obj.device, obj.rule.is_bitmap)
    n = pay_t.shape[0]
    sol = greedy(obj, torch.arange(n, device=obj.device), pay_t,
                 torch.ones(n, dtype=torch.bool, device=obj.device), k,
                 engine=engine)
    ids_out = sol.ids[sol.valid].cpu().numpy()
    data = pay_t if objective_name in ("kmedoid", "facility") \
        else payloads
    gval = global_value(objective_name, data, ids_out, universe)
    ev = int(sol.evals)
    return SimResult(gval, ids_out, ev, ev, {(0, 0): ev}, 0, 0, 1, 1,
                     root_value=float(sol.value))


# ---------------------------------------------------------------------------
# the lazy engine (Minoux's lazy greedy; src/repro/core/simulate.py:237-373)
# ---------------------------------------------------------------------------


class SparseCoverage:
    """k-cover / k-dominating set over adjacency lists (the paper's
    representation), on the host as in the reference."""

    def __init__(self, sets: Sequence[np.ndarray], universe: int):
        self.sets = sets
        self.covered = np.zeros(universe, bool)
        self.total = 0

    def marginal(self, e: int) -> float:
        s = self.sets[e]
        return float(np.count_nonzero(~self.covered[s]))

    def add(self, e: int) -> None:
        s = self.sets[e]
        self.total += int(np.count_nonzero(~self.covered[s]))
        self.covered[s] = True

    def value(self) -> float:
        return float(self.total)


class DenseMedoid:
    """k-medoid over a LOCAL evaluation ground set (paper §6.4), its ground
    rows and min-distance row torch tensors on `device` (None: the data
    tensor's own device, else the card — `runtime/device.py`)."""

    # f32 bytes of one batch of the first fill's (C, N, D) differences
    FILL_BYTES = 2 ** 30

    def __init__(self, data, ground_idx, device: DeviceLike = None):
        dev = data.device if isinstance(data, torch.Tensor) and \
            device is None else resolve_device(device)
        self.data = torch.as_tensor(data, device=dev).to(F32)
        idx = torch.as_tensor(np.asarray(ground_idx, np.int64), device=dev)
        self.ground = self.data[idx]
        self.mind = torch.linalg.vector_norm(self.ground, dim=1)  # d(·, e0)
        self.base = float(self.mind.mean())

    def _dist(self, e: int) -> torch.Tensor:
        return torch.linalg.vector_norm(self.ground - self.data[e], dim=1)

    def marginal(self, e: int) -> float:
        return float(torch.clamp(self.mind - self._dist(e), min=0.0).mean())

    def marginals(self, cands: Sequence[int]) -> List[float]:
        """`marginal` of every candidate, in batches: each row the same
        direct difference, reduced as `marginal` reduces it."""
        n, d = self.ground.shape
        step = max(1, self.FILL_BYTES // max(1, 4 * n * d))
        idx = torch.as_tensor(np.asarray(cands, np.int64),
                              device=self.data.device)
        out: List[float] = []
        for i in range(0, len(cands), step):
            x = self.data[idx[i:i + step]]
            dist = torch.linalg.vector_norm(self.ground - x[:, None], dim=2)
            out.extend(torch.clamp(self.mind - dist, min=0.0).mean(1)
                       .tolist())
        return out

    def add(self, e: int) -> None:
        self.mind = torch.minimum(self.mind, self._dist(e))

    def value(self) -> float:
        return self.base - float(self.mind.mean())


def lazy_greedy(state, candidates: Sequence[int], k: int
                ) -> Tuple[List[int], float, int]:
    """Minoux's accelerated greedy → (selected, value, evals): a heap of
    (−gain, e, stamp), an entry re-evaluated when popped stale, accepted
    when fresh and > 0 — `heapq`'s order and ties, as the reference."""
    candidates = list(candidates)
    fill = (state.marginals(candidates) if hasattr(state, "marginals")
            else [state.marginal(e) for e in candidates])
    heap = [(-g, e, 0) for g, e in zip(fill, candidates)]
    evals = len(heap)
    heapq.heapify(heap)
    selected: List[int] = []
    stamp = 0
    while heap and len(selected) < k:
        neg, e, st = heapq.heappop(heap)
        if st == stamp:
            if -neg <= 0:
                break
            state.add(e)
            selected.append(e)
            stamp += 1
        else:
            g = state.marginal(e)
            evals += 1
            heapq.heappush(heap, (-g, e, stamp))
    return selected, state.value(), evals


def _lazy_state(objective_name: str, data, universe: int):
    """The per-node state factory: adjacency lists for coverage, the
    (n, D) tensor for k-medoid."""
    if objective_name in ("kcover", "kdom"):
        return lambda ground_idx: SparseCoverage(data, universe)
    return lambda ground_idx: DenseMedoid(data, ground_idx)


def run_tree_lazy(objective_name: str, data: Any, k: int,
                  tree: AccumulationTree, seed: int = 0, *,
                  universe: int = 0, augment: int = 0,
                  device: DeviceLike = None) -> SimResult:
    """The tree on the lazy engine. ``data``: a list of adjacency arrays
    (kcover, kdom; host only) or (n, D) features (kmedoid: numpy or a
    tensor, placed once on `device` — a tensor's own by default)."""
    n = len(data)
    m, b, L = tree.m, tree.b, tree.num_levels
    assign = partition(n, m, seed)
    rng = np.random.default_rng(seed + 1)
    if objective_name not in ("kcover", "kdom"):
        data = _medoid_data(data, device)
    make_state = _lazy_state(objective_name, data, universe)

    per_node: Dict[Tuple[int, int], int] = {}
    comm = 0
    sols: Dict[int, Tuple[List[int], float]] = {}
    for mi in range(m):
        cand = np.nonzero(assign == mi)[0]
        sel, val, ev = lazy_greedy(make_state(cand), cand.tolist(), k)
        sols[mi] = (sel, val)
        per_node[(0, mi)] = ev

    for lvl in range(1, L + 1):
        new_sols: Dict[int, Tuple[List[int], float]] = {}
        for nid in tree.nodes_at_level(lvl):
            union: List[int] = []
            for cid in tree.children_of(lvl, nid):
                union.extend(sols[cid][0])
                comm += len(sols[cid][0])
            ground = np.asarray(union, np.int64)
            if augment > 0 and objective_name == "kmedoid":
                ground = np.concatenate(
                    [ground, rng.integers(0, n, size=augment)])
            sel, val, ev = lazy_greedy(make_state(ground), union, k)
            per_node[(lvl, nid)] = ev
            # argmax{f(S), f(S_prev)} with S_prev the same-id child's
            prev_sel, _ = sols[nid]
            st2 = make_state(ground)
            for e in prev_sel:
                st2.add(e)
            prev_val = st2.value()
            new_sols[nid] = ((sel, val) if val >= prev_val
                             else (prev_sel, prev_val))
        sols = new_sols

    sel, val = sols[0]
    evals_critical = sum(per_node[(lvl, 0)] for lvl in range(L + 1))
    gval = global_value(objective_name, data, np.asarray(sel, np.int64),
                        universe)
    return SimResult(gval, np.asarray(sel), int(sum(per_node.values())),
                     int(evals_critical), per_node, comm, L, m, b,
                     root_value=float(val))


def run_greedy_lazy(objective_name: str, data: Any, k: int, *,
                    universe: int = 0,
                    device: DeviceLike = None) -> SimResult:
    """The sequential lazy Greedy over the whole data (one node)."""
    n = len(data)
    if objective_name in ("kcover", "kdom"):
        st = SparseCoverage(data, universe)
    else:
        data = _medoid_data(data, device)
        st = DenseMedoid(data, np.arange(n))
    sel, val, ev = lazy_greedy(st, list(range(n)), k)
    gval = global_value(objective_name, data, np.asarray(sel, np.int64),
                        universe)
    return SimResult(gval, np.asarray(sel), ev, ev, {(0, 0): ev},
                     0, 0, 1, 1, root_value=float(val))


def _medoid_data(data, device: DeviceLike) -> torch.Tensor:
    """k-medoid features as one f32 tensor: a tensor stays on its device
    unless `device` names another; numpy goes to `device` (the card by
    default)."""
    if isinstance(data, torch.Tensor):
        return data.to(resolve_device(device) if device is not None
                       else data.device, F32)
    return torch.as_tensor(np.asarray(data), dtype=F32,
                           device=resolve_device(device))
