"""Measured engine autotuning (answers `src/repro/launch/autotune.py`).

The static planner (kernels/plans.py) picks a tier from closed-form
budget math and a storage ladder (f32 → bf16 → int8, each rung only when
the one above busts the cache budget), so it never chooses a narrower
storage for speed: at a Tiny-ImageNet leaf (3,125 images) the f32 matrix
(39 MB) misses the 25 MB L2 share and the planner streams it (pairwise +
loop, two launches), though the bf16 or int8 matrix fits and the
resident loop would run the whole greedy in one dispatch.

This tuner measures instead. For each (objective, shape) it enumerates
every plan the port's gates admit (`candidate_plans`): the step engine;
the resident loop in each storage `resident_fits` admits; the streaming
loop and the fused step in each storage whose cache fits the budget, at
the chunk sizes the planner hands the CUDA wrappers
(`plans.block_n_ladder`: 32, 16, 8 ground rows a chunk of the gain sum,
as `kernels/fused_step.py::fused_step` and
`kernels/greedy_loop.py::greedy_loop` take them); a bitmap rule's words
(uint32) only, its streaming tier under `fused_plan`'s gate. It times
each through the real `greedy(…, engine="auto")` under
`plans.plan_override` (cache build included; one warm-up, then the best
of `reps`, by `time.perf_counter()` around a call that ends in a device
synchronize), counts its dispatches (`_dispatches`: the launch
counters' delta over one greedy, launches on the card, calls on the
CPU) and persists the winner to the JSON cache that `select_engine`
consults (REPRO_TORCH_AUTOTUNE_CACHE, or ``--out``). Every entry records
the port's budget snapshot, and its key the device type it was measured
on.

Which candidates can change bits: any storage but f32 (bf16 and int8
round the matrix), and any chunk size but the static plan's (a chunk
size fixes the order of the gain sum's f32 additions, so 16 or 8 rows
sum in another order than 32). The step, resident and the static
chunk's f32 tiers give the static plan's gains. The identity gate
catches what matters: a candidate whose greedy selects other ids than
the static plan's is rejected, however fast.

    PYTHONPATH=src python -m repro_torch.launch.autotune --smoke \\
        --out .autotune/plans.json
    REPRO_TORCH_AUTOTUNE_CACHE=.autotune/plans.json \\
        PYTHONPATH=src python -m repro_torch.launch.autotune \\
        --objective facility --objective kmedoid --n 1024 --d 64 --k 16

``--device`` (default ``cuda``; ``cpu`` tunes the plain path, whose
entries never steer the card) places the pools and the greedies.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.greedy import greedy
from repro_torch.core.objective import make_objective, registry
from repro_torch.data.synthetic import gen_images, gen_kcover, pack_bitmaps
from repro_torch.kernels import counters, plans
from repro_torch.kernels.rules import to_words
from repro_torch.runtime.device import resolve_device

FEATURE_DTYPES = plans.FEATURE_DTYPES
STEP_PLAN = {"tier": "step", "block_n": 0, "loop_block_n": 0,
             "dtype": "float32"}


def _pool(name, n, d, universe=0, seed=0, device=None):
    """The candidate pool, its own evaluation ground, in the objective's
    payload representation (numpy generated on the host, as the
    reference's), on `device`."""
    dev = torch.device(device) if device is not None else None
    if make_objective(name, universe=universe or n,
                      device="cpu").rule.is_bitmap:
        u = universe or n
        pay = to_words(pack_bitmaps(gen_kcover(n, u, seed=seed), u)).to(dev)
    else:
        pay = torch.as_tensor(gen_images(n, d, classes=8, seed=seed),
                              device=dev)
    return (torch.arange(n, device=dev),
            pay, torch.ones(n, dtype=torch.bool, device=dev))


def candidate_plans(rule, n, c, d, *, dtypes=None, blocks_per_tier=2,
                    replicas=1):
    """Every plan the port's gates admit for `replicas` (n, c, d)
    greedies (`plans.tier_admits`): the step engine, then tier × storage
    × chunk size — including rungs the static ladder never reaches (it
    stops at the first storage whose cache fits the budget, so it never
    tries an int8 resident loop while the f32 cache streams)."""
    bitmap = rule.is_bitmap
    forced = plans.forced_dtype()
    cands = [dict(STEP_PLAN)]
    for dtype in (("uint32",) if bitmap else (dtypes or FEATURE_DTYPES)):
        if forced is not None and not bitmap and dtype != forced:
            continue                # select_engine would reject the entry
        admits = {t: plans.tier_admits(rule, n, c, d, t, dtype, replicas)
                  for t in ("resident", "streaming", "fused")}
        if bitmap:
            cands += [{"tier": t, "block_n": 0, "loop_block_n": 0,
                       "dtype": dtype} for t, ok in admits.items() if ok]
            continue
        bn0 = plans.fused_block_n(dtype)
        ladder = plans.block_n_ladder(dtype)[:max(1, blocks_per_tier)]
        if admits["resident"]:
            cands.append({"tier": "resident", "block_n": bn0,
                          "loop_block_n": 0, "dtype": dtype})
        if admits["streaming"]:
            bl = plans.loop_block_n(c, dtype)
            cands += [{"tier": "streaming", "block_n": bn,
                       "loop_block_n": bl, "dtype": dtype} for bn in ladder]
        if admits["fused"]:
            cands += [{"tier": "fused", "block_n": bn, "loop_block_n": 0,
                       "dtype": dtype} for bn in ladder]
    return cands


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _greedy(obj, ids, pay, valid, k, fp):
    """One greedy under the forced plan, ended by a device synchronize."""
    with plans.plan_override(fp):
        sol = greedy(obj, ids, pay, valid, k, engine="auto")
    _sync(obj.device)
    return sol


def _dispatches(obj, ids, pay, valid, k, fp) -> int:
    """Dispatches one greedy under this plan takes: the launch counters'
    delta (launches on the card, calls on the CPU, where nothing
    launches) — the port's stand-in for the reference's jaxpr count."""
    before = counters.snapshot()
    _greedy(obj, ids, pay, valid, k, fp)
    return counters.dispatches(before, counters.snapshot(), obj.device)


def _measure(obj, ids, pay, valid, k, fp, reps):
    """(best wall seconds of `reps`, the solution, dispatches) for one
    forced plan; the counted warm-up run comes first."""
    disp = _dispatches(obj, ids, pay, valid, k, fp)
    best, sol = float("inf"), None
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        sol = _greedy(obj, ids, pay, valid, k, fp)
        best = min(best, time.perf_counter() - t0)
    return best, sol, disp


def _fmt(fp):
    return (f"{fp['tier']:9s} dtype={fp['dtype']:8s} "
            f"bn={fp['block_n']:3d} bl={fp['loop_block_n']:3d}")


def tune_one(name, n, d, k, *, universe=0, device=None, reps=2,
             dtypes=None, blocks_per_tier=2, seed=0, verbose=True,
             log=None):
    """Tune one (objective, shape): time the static plan and every
    admitted candidate, reject candidates that change the selected ids,
    and return (key, winner entry). The pool is its own candidate set,
    so c = n. ``log``: a list that gets one row per plan timed (tier,
    dtype, block_n, loop_block_n, ms, dispatches, same ids)."""
    dev = resolve_device(device)
    obj = make_objective(name, universe=universe or n, device=dev)
    rule = obj.rule
    ids, pay, valid = _pool(name, n, d, universe, seed=seed, device=dev)
    # planner dims as objective.plan_dims derives them: bitmap rules plan
    # over universe WORDS (pay is (C, W)) with no feature dim
    nn, c, dd = ((pay.shape[1], n, None) if rule.is_bitmap
                 else (n, n, d))
    fp_static = plans.fused_plan(nn, c, d=dd, rule=rule) or dict(STEP_PLAN)
    t_static, sol_static, d_static = _measure(obj, ids, pay, valid, k,
                                              fp_static, reps)
    base_ids = sol_static.ids.cpu()

    def record(kind, fp, t, disp, same):
        if log is not None:
            log.append(dict(fp, kind=kind, ms=t * 1e3, dispatches=disp,
                            same_ids=same))
        if verbose:
            mark = "" if same else "  REJECTED: selection differs"
            print(f"  {kind:7s} {_fmt(fp)} {t * 1e3:9.2f} ms "
                  f"{disp:4d} dispatches{mark}", flush=True)

    if verbose:
        print(f"{name} n={nn} c={c} d={dd} k={k} [{dev.type}]", flush=True)
    record("static", fp_static, t_static, d_static, True)
    best_fp, best_t, best_d = fp_static, t_static, d_static
    for fp in candidate_plans(rule, nn, c, dd, dtypes=dtypes,
                              blocks_per_tier=blocks_per_tier):
        if fp == fp_static:
            continue
        t, sol, disp = _measure(obj, ids, pay, valid, k, fp, reps)
        same = bool(torch.equal(sol.ids.cpu(), base_ids))
        record("cand", fp, t, disp, same)
        if same and t < best_t:
            best_fp, best_t, best_d = fp, t, disp
    entry = dict(best_fp,
                 budgets=plans.budget_snapshot(),
                 wall_s=round(best_t, 6),
                 static_tier=fp_static["tier"],
                 static_dtype=fp_static["dtype"],
                 static_wall_s=round(t_static, 6),
                 speedup=round(t_static / max(best_t, 1e-9), 3),
                 shape={"n": nn, "c": c, "d": dd or 0, "k": k},
                 dispatches=best_d, static_dispatches=d_static)
    key = plans.autotune_key(rule, nn, c, dd, dev.type)
    if verbose:
        print(f"  winner  {_fmt(best_fp)} {best_t * 1e3:9.2f} ms "
              f"({entry['speedup']}x vs static)", flush=True)
    return key, entry


def tune(objectives, shapes, *, device=None, reps=2, dtypes=None,
         blocks_per_tier=2, universe=0, out=None, verbose=True):
    """Tune the (objective × shape) grid and persist the winners to the
    measured-plan cache (REPRO_TORCH_AUTOTUNE_CACHE, or `out`). Returns
    the entries written."""
    entries = {}
    for name in objectives:
        for (n, d, k) in shapes:
            key, entry = tune_one(name, n, d, k, universe=universe,
                                  device=device, reps=reps, dtypes=dtypes,
                                  blocks_per_tier=blocks_per_tier,
                                  verbose=verbose)
            entries[key] = entry
    path = plans.save_autotune_cache(entries, path=out)
    if verbose:
        print(f"wrote {len(entries)} tuned plan(s) -> {path}", flush=True)
    return entries


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--objective", action="append", default=[],
                    choices=sorted(registry()),
                    help="objective(s) to tune (repeatable)")
    ap.add_argument("--n", type=int, default=1024,
                    help="pool size (ground = candidates)")
    ap.add_argument("--d", type=int, default=64, help="feature dim")
    ap.add_argument("--k", type=int, default=16, help="solution size")
    ap.add_argument("--universe", type=int, default=0,
                    help="bitmap universe (coverage; default n)")
    ap.add_argument("--device", default="cuda",
                    help="device to measure on (cpu: the plain path)")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--blocks-per-tier", type=int, default=2,
                    help="chunk sizes tried per tier and storage")
    ap.add_argument("--dtypes", default="",
                    help="comma list limiting the storages tried")
    ap.add_argument("--out", default=None,
                    help="cache path (default: REPRO_TORCH_AUTOTUNE_CACHE)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny grid: facility @ n=192 d=32 k=6, f32 and "
                         "int8, 1 rep")
    args = ap.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)
    dtypes = tuple(s for s in args.dtypes.split(",") if s) or None
    if args.smoke:
        return tune(args.objective or ["facility"], [(192, 32, 6)],
                    device=device, reps=1,
                    dtypes=dtypes or ("float32", "int8"),
                    blocks_per_tier=1, out=args.out)
    return tune(args.objective or ["facility", "kmedoid"],
                [(args.n, args.d, args.k)], device=device, reps=args.reps,
                dtypes=dtypes, blocks_per_tier=args.blocks_per_tier,
                universe=args.universe, out=args.out)


if __name__ == "__main__":
    main()
