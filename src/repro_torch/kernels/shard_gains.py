"""The sharded leaf tier: one greedy's ground set split over cooperating
lanes (answers `src/repro/kernels/shard_gains.py`: `resolve_tile_c` :72,
`pad_pool` :87, `shard_greedy` :106, `shard_greedy_distributed` :188,
`shard_greedy_sim` :212).

The cached tiers hold a greedy's whole pool on one device; this tier
holds 1/p of it a lane and no (N, C) matrix. The protocol is the
reference's (:17-31). Every step, for each of the ``n_s / tile_c``
candidate tiles:

  1. gather every lane's (tile_c, d) candidate slice and its
     valid-and-unselected mask: the (p·tile_c, d) tile every lane of the
     machine sees;
  2. ONE `ops.gains` launch of that tile against each lane's own
     (n_s, d) ground and (n_s,) state row → (p·tile_c,) partial sums;
  3. sum the partials over the machine's p lanes;
  4. keep a running first-max argmax in the global, lane-major pool
     order (the order of solo ``greedy``'s argmax).

The winner's payload and id reach every lane by an owner-masked sum, and
every lane folds the winner into its own row (`rules.update_row`, plain
torch as in the step engine); accept iff the gain is finite and > 0.
`n_eff`, `base` and the final value are sums of the lanes' terms.

Every sum over lanes runs in LANE ORDER, on every placement (`_lane_sum`):
stacked lanes add their rows one by one, and ranks gather the small
(p, …) partials and add them the same way — not `all_reduce`, whose
ring order is gloo's own. A lane's own plain-torch reductions (its empty
row's norms, the winner's column, its row sums) run on its (1, …) slice
(`_per_lane`), the shape a rank runs them at, and the gains kernel's
sums do not depend on the batch. So stacked lanes and ranks give the
same bits.

Two placements of the lanes share `shard_greedy`:
  * stacked (`_StackedLanes`): (machines·p, n_s, …) on one device, lane
    = machine·p + shard digit; ONE gains launch a (step, tile) serves
    every lane of every machine. `ops.gains` reads (B, C, d) candidates,
    so the machine's gathered tile is copied once a lane:
    4·lanes·p·tile_c·d bytes a tile (at 16 lanes, p = 4, tile_c = 512,
    d = 12,288: 1.6 GB), beside the gather's own 4·lanes·tile_c·d.
  * ranks (`_RankLanes`): this rank's (1, n_s, …) lane over its
    `TreeMesh.shard_group`, the same launches on every rank.

Launches a leaf greedy: ``k · n_s / tile_c`` gains (`gains`, or
`gains[int8]` under REPRO_TORCH_FUSED_CACHE_DTYPE=int8, where each
lane's ground is quantized once a greedy, as `RuleObjective.
prepare_ground` does for the step engine), plus ONE `gains_norms` for a
'dist' rule (the lanes' grounds do not change over the greedy); nothing
else launches. Evals are counted as the reference counts them.

Selections equal solo ``greedy(engine='step')``'s except where float
summation order decides (raw gains are a sum of p f32 partials, not one
reduction): the reference's tests use margin-robust pools for this.

Feature rules only: sharding a bitmap rule's ground would shard its
universe words, the payload itself (`plans.shard_plan` returns None).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops, plans
from repro_torch.kernels import rules as R
from repro_torch.runtime import flags

F32 = torch.float32
_BIG_IDX = 2 ** 30


def resolve_tile_c(rule: R.KernelRule, n: int, d: int, lanes: int,
                   tile_c: int = 0) -> int:
    """Candidates a lane contributes to each gathered tile: the caller's
    choice, else `plans.shard_plan`'s, else the least tile (the gate
    refusing every tile means the caller is past the modeled budget
    already: run anyway, with the smallest working set)."""
    if tile_c:
        return int(tile_c)
    sp = plans.shard_plan(rule, n, d, lanes)
    if sp is not None:
        return int(sp["tile_c"])
    return plans.SHARD_TILE_MIN


def pad_pool(ids, payloads, valid, lanes: int, tile_c: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pad a flat (n, …) pool so every lane's shard is whole tiles:
    n → lanes · ceil(n / lanes / tile_c) · tile_c. Padding rows are
    invalid (id −1, zero payload) and never win a step."""
    n = ids.shape[0]
    n_s = -(-(-(-n // lanes)) // tile_c) * tile_c
    pad = n_s * lanes - n
    if pad == 0:
        return ids, payloads, valid
    return (torch.cat([ids, torch.full((pad,), -1, dtype=ids.dtype,
                                       device=ids.device)]),
            torch.cat([payloads, payloads.new_zeros((pad,)
                                                    + payloads.shape[1:])]),
            torch.cat([valid, valid.new_zeros((pad,))]))


def lane_tile(rule: R.KernelRule, n_l: int, d: int, lanes: int,
              tile_c: int = 0) -> Tuple[int, int]:
    """(tile_c, n_s) of lanes that each hold n_l elements of a pool split
    over `lanes`: `resolve_tile_c`, at most n_l, and the lane length
    padded to whole tiles (`pad_lanes`)."""
    tile = max(1, min(resolve_tile_c(rule, n_l * lanes, d, lanes, tile_c),
                      n_l))
    return tile, -(-n_l // tile) * tile


def pad_lanes(ids, payloads, valid, n_s: int):
    """Stacked (L, n_l, …) lanes padded at their ends to n_s rows (id −1,
    zero payload, invalid): each lane keeps its order, so the global
    lane-major order of the valid elements — and the argmax's — holds."""
    pad = n_s - ids.shape[1]
    if pad == 0:
        return ids, payloads, valid
    lanes = ids.shape[0]
    return (torch.cat([ids, ids.new_full((lanes, pad), -1)], 1),
            torch.cat([payloads, payloads.new_zeros(
                (lanes, pad) + payloads.shape[2:])], 1),
            torch.cat([valid, valid.new_zeros((lanes, pad))], 1))


def _per_lane(fn, *xs):
    """fn over each lane's (1, …) slice, concatenated: a lane's plain-torch
    reductions then run at the shape a rank runs them at, so the bits do
    not depend on how many lanes are stacked."""
    return torch.cat([fn(*(x[i:i + 1] for x in xs))
                      for i in range(xs[0].shape[0])])


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """(M, p, …) → (M, …): the p lanes' terms added in lane order."""
    out = x[:, 0]
    for j in range(1, x.shape[1]):
        out = out + x[:, j]
    return out


class _StackedLanes:
    """Lanes stacked on one device: (M·p, …) lane tensors, lane =
    machine·p + shard digit; machine tensors are (M, …)."""

    def __init__(self, lanes: int, p: int, device):
        self.p = p
        self.machines = lanes // p
        self.digit = torch.arange(lanes, device=device) % p

    def gather(self, x):
        """(L, a, …) lane slices → (M, p·a, …) machine tiles."""
        return x.reshape((self.machines, self.p * x.shape[1])
                         + tuple(x.shape[2:]))

    def sum(self, x):
        """(L, …) lane terms → (M, …) machine sums, in lane order."""
        return _lane_sum(x.reshape((self.machines, self.p)
                                   + tuple(x.shape[1:])))

    def to_lanes(self, x):
        """(M, …) machine tensors → (L, …), each machine's p lanes alike."""
        return x.repeat_interleave(self.p, dim=0)


class _RankLanes:
    """This rank's lane over its `TreeMesh.shard_group`: lane and machine
    tensors are both (1, …)."""

    def __init__(self, mesh, device):
        self.mesh = mesh
        self.p = mesh.shard
        self.digit = torch.tensor([mesh.shard_digit], device=device)

    def gather(self, x):
        return self.mesh.shard_gather(x[0]).unsqueeze(0)

    def sum(self, x):
        parts = self.mesh.shard_gather(x)               # (p, …)
        return _lane_sum(parts.unsqueeze(0))

    def to_lanes(self, x):
        return x


def shard_greedy(objective, ids, payloads, valid, k: int, *, lanes: int,
                 tile_c: int = 0, mesh=None):
    """The sharded greedy over lane shards whose length n_s is whole
    tiles of `tile_c` (callers pad: `pad_pool`, `pad_lanes`).

    ``mesh=None``: ids/valid (L, n_s), payloads (L, n_s, d) are L =
    machines·`lanes` stacked lanes, machine-major, each machine's
    `lanes` shards one pool; ``mesh`` a `launch/mesh.py::TreeMesh` with
    ``shard == lanes``: (1, n_s, …), this rank's shard. Returns the
    lanes' Solution, stacked (L, …) — every lane of a machine holds the
    machine's global Solution (over a mesh, the rank's (1, …))."""
    from repro_torch.core.greedy import Solution      # core imports kernels

    rule = objective.rule
    assert not rule.is_bitmap, \
        "the sharded tier is feature-rule only (plans.shard_plan gates it)"
    n_lanes, n_s, d = payloads.shape
    dev = payloads.device
    tile_c = max(1, min(resolve_tile_c(rule, n_s * lanes, d, lanes, tile_c),
                        n_s))
    if n_s % tile_c:
        raise ValueError(f"lane shards of {n_s} rows are not whole tiles "
                         f"of {tile_c}: pad them (pad_pool, pad_lanes)")
    ntiles = n_s // tile_c
    comm = (_StackedLanes(n_lanes, lanes, dev) if mesh is None
            else _RankLanes(mesh, dev))
    if mesh is not None and (mesh.shard != lanes or n_lanes != 1):
        raise ValueError(f"over a mesh of shard {mesh.shard} a rank holds "
                         f"one lane of {lanes}; got {n_lanes} lanes")
    ids = ids.to(torch.int64)
    payloads = payloads.to(F32)

    # the empty solution, with RuleObjective.init_state's normalizers
    # rebuilt from lane sums
    row = _per_lane(lambda p, v: R.empty_row(p, v, rule), payloads, valid)
    n_eff = torch.clamp(comm.sum(valid.to(F32).sum(-1)), min=1.0)
    base = (comm.sum(_per_lane(lambda r: r.sum(-1), row)) / n_eff
            if rule.fold == "min" else torch.zeros_like(n_eff))
    # the ground as the gains kernel reads it, once a greedy (as
    # RuleObjective.prepare_ground): int8 under a forced int8 rung, and
    # a 'dist' rule's norms
    ground, gscale = payloads, None
    if flags.fused_cache_dtype() == "int8":
        ground, gscale = ops.quantize_ground(payloads)
    gnorm = (ops.gains_norms(ground, gscale) if rule.pairwise == "dist"
             else None)

    src = torch.arange(lanes * tile_c, device=dev)
    ones = torch.ones((n_lanes, lanes * tile_c), dtype=torch.bool,
                      device=dev)
    selected = torch.zeros((n_lanes, n_s), dtype=torch.bool, device=dev)
    n_mach = n_lanes // lanes if mesh is None else 1
    evals = torch.zeros(n_mach, dtype=torch.int64, device=dev)
    steps = []
    for _ in range(k):
        cand_mask = valid & ~selected
        evals = evals + comm.sum(cand_mask.sum(-1))
        best_gain = torch.full((n_mach,), float("-inf"), device=dev)
        best_gidx = torch.full((n_mach,), _BIG_IDX, dtype=torch.int64,
                               device=dev)
        for t in range(ntiles):
            sl = slice(t * tile_c, (t + 1) * tile_c)
            tile_pay = comm.gather(payloads[:, sl])          # (M, p·tc, d)
            tile_mask = comm.gather(cand_mask[:, sl])        # (M, p·tc)
            raw = ops.gains(ground, row, comm.to_lanes(tile_pay), ones,
                            rule, gscale=gscale, gnorm=gnorm)
            raw = comm.sum(raw)
            g = torch.where(tile_mask, raw / n_eff.unsqueeze(-1),
                            torch.full_like(raw, float("-inf")))
            # the global pool index of each gathered candidate
            gidx = (src // tile_c) * n_s + t * tile_c + src % tile_c
            mx = g.amax(-1)
            first = torch.where(g == mx.unsqueeze(-1), gidx,
                                torch.full_like(gidx, _BIG_IDX)).amin(-1)
            better = (mx > best_gain) | ((mx == best_gain)
                                         & (first < best_gidx))
            best_gain = torch.where(better, mx, best_gain)
            best_gidx = torch.where(better, first, best_gidx)
        # the winner's payload and id: an owner-masked sum over the lanes
        local_i = comm.to_lanes(best_gidx) - comm.digit * n_s
        own = (local_i >= 0) & (local_i < n_s)
        safe = local_i.clamp(0, n_s - 1)
        mine = payloads.gather(1, safe.view(-1, 1, 1).expand(-1, 1, d))[:, 0]
        wpay = comm.sum(torch.where(own.unsqueeze(-1), mine,
                                    torch.zeros_like(mine)))
        wid = comm.sum(torch.where(own, ids.gather(1, safe[:, None])[:, 0],
                                   torch.zeros_like(safe)))
        accept = torch.isfinite(best_gain) & (best_gain > 0)
        acc_l = comm.to_lanes(accept)
        new_row = _per_lane(lambda g, r, w: R.update_row(g, r, w, rule),
                            payloads, row, comm.to_lanes(wpay))
        row = torch.where(acc_l.unsqueeze(-1), new_row, row)
        selected = selected | (torch.nn.functional.one_hot(safe, n_s).bool()
                               & (own & acc_l).unsqueeze(-1))
        steps.append((torch.where(accept, wid, torch.full_like(wid, -1)),
                      torch.where(accept.unsqueeze(-1), wpay,
                                  torch.zeros_like(wpay)), accept))
    tot = comm.sum(_per_lane(
        lambda r, v: torch.where(v, r, torch.zeros_like(r)).sum(-1),
        row, valid))
    value = base - tot / n_eff if rule.fold == "min" else tot / n_eff
    if steps:
        out_ids, out_pay, out_valid = (torch.stack(x, 1)
                                       for x in zip(*steps))
    else:
        out_ids = torch.zeros((n_mach, 0), dtype=torch.int64, device=dev)
        out_pay = payloads.new_zeros((n_mach, 0, d))
        out_valid = torch.zeros((n_mach, 0), dtype=torch.bool, device=dev)
    sol = Solution(out_ids, out_pay, out_valid, value, evals)
    return sol.map(comm.to_lanes)


def shard_greedy_sim(objective, ids, payloads, valid, k: int, lanes: int,
                     tile_c: int = 0):
    """`shard_greedy_distributed` on one device: the flat (n, …) pool
    padded (`pad_pool`) and cut into `lanes` stacked shards, the lanes'
    collectives a reshape and a sum in lane order — the ranks' bits.
    Returns the global Solution (unbatched)."""
    ids, payloads, valid = _flat_pool(objective, ids, payloads, valid)
    tile_c = resolve_tile_c(objective.rule, ids.shape[0], payloads.shape[1],
                            lanes, tile_c)
    ids, payloads, valid = pad_pool(ids, payloads, valid, lanes, tile_c)
    n_s = ids.shape[0] // lanes
    shp = lambda x: x.reshape((lanes, n_s) + tuple(x.shape[1:]))
    sol = shard_greedy(objective, shp(ids), shp(payloads), shp(valid), k,
                       lanes=lanes, tile_c=tile_c)
    return sol.map(lambda x: x[0])


def shard_greedy_distributed(objective, ids, payloads, valid, k: int, mesh,
                             tile_c: int = 0):
    """One sharded greedy over the `mesh.shard` ranks of this rank's
    shard group (`launch/mesh.py::make_tree_mesh(…, shard=p)`): every
    rank passes the same flat (n, …) pool, as the reference's shard_map
    does, keeps its padded shard (block `mesh.shard_digit`), and gets the
    global Solution (unbatched), the same on every rank of the group."""
    ids, payloads, valid = _flat_pool(objective, ids, payloads, valid)
    lanes = mesh.shard
    tile_c = resolve_tile_c(objective.rule, ids.shape[0], payloads.shape[1],
                            lanes, tile_c)
    ids, payloads, valid = pad_pool(ids, payloads, valid, lanes, tile_c)
    n_s = ids.shape[0] // lanes
    blk = slice(mesh.shard_digit * n_s, (mesh.shard_digit + 1) * n_s)
    sol = shard_greedy(objective, ids[blk][None], payloads[blk][None],
                       valid[blk][None], k, lanes=lanes, tile_c=tile_c,
                       mesh=mesh)
    return sol.map(lambda x: x[0])


def _flat_pool(objective, ids, payloads, valid):
    dev = objective.device
    return (torch.as_tensor(ids, device=dev).to(torch.int64),
            torch.as_tensor(payloads, device=dev).to(F32),
            torch.as_tensor(valid, device=dev).to(torch.bool))
