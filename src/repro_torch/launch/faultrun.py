"""Fault-tolerant distributed selection driver (answers
`src/repro/launch/faultrun.py`).

    PYTHONPATH=src python -m repro_torch.launch.faultrun --objective kcover \\
        --n 512 --k 8 --lanes 8 --branching 2 --fail-level 1 --fail-lane 3

Runs the supervised level-by-level GreedyML runtime
(runtime/supervisor.py::SelectionSupervisor over
core/greedyml.py::LevelDispatcher) with deterministic failure injection
and prints the recovery log. Modes:

  * default          — a clean supervised run (it still checkpoints)
  * --fail-level L --fail-lane W
                     — ONE transient failure at level L on lane W: the
                       level-replay path (bit-identical recovery)
  * --permanent      — the lane instead fails EVERY attempt from level L
                       on: the degraded-tree path
  * --stream         — supervise the continuous streaming driver's merges
                       instead (transient replay + lane_reset)
  * --mesh           — every stage over --lanes spawned gloo ranks, one
                       lane a rank (launch/spawn.py); default is the
                       stacked lanes on one device

``--device`` (default ``cuda``; ``cpu`` runs the plain path) places the
objective, and over ``--mesh`` every rank. ``--smoke`` runs the
acceptance suite — replay bit-identity against the failure-free run, the
degraded tree's ≥ 0.95× band, a supervised streaming pass — and exits
non-zero on any violation.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np

SPAWN_DEADLINE = 300.0       # seconds the --mesh ranks may run


def _build(args):
    from repro_torch.core.functions import make_objective
    from repro_torch.data import synthetic

    if args.objective == "kcover":
        sets = synthetic.gen_kcover(args.n, args.universe, seed=args.seed)
        pay = synthetic.pack_bitmaps(sets, args.universe)
        obj = make_objective("kcover", universe=args.universe,
                             device=args.device)
    else:
        pay = synthetic.gen_images(args.n, args.d, seed=args.seed)
        obj = make_objective(args.objective, device=args.device)
    return obj, np.arange(args.n), pay, np.ones(args.n, bool)


def _injector(spec):
    from repro_torch.runtime.supervisor import LaneFailureInjector
    if spec is None:
        return None
    kind, level, lane = spec
    if kind == "dead":
        return LaneFailureInjector(dead={lane: level})
    return LaneFailureInjector(fail_at=((level, lane),))


def _select(args, ckpt_dir, spec, max_restarts, mesh=None):
    from repro_torch.runtime.supervisor import SelectionSupervisor
    sup = SelectionSupervisor(ckpt_dir=ckpt_dir, injector=_injector(spec),
                              max_restarts=max_restarts)
    obj, ids, pay, valid = _build(args)
    t0 = time.time()
    sol, info = sup.select(obj, ids, pay, valid, args.k, lanes=args.lanes,
                           branching=args.branching, mesh=mesh)
    info["wall_s"] = time.time() - t0
    return sol, info


def _rank_select(rank, args, ckpt_dir, spec, max_restarts):
    """One rank of a --mesh run: its lane of the supervised tree; returns
    the root (on every rank) and the log, on the CPU."""
    from repro_torch.launch.mesh import make_machine_mesh
    device = None if args.device == "cuda" else args.device
    mesh = make_machine_mesh(args.lanes, args.branching or args.lanes,
                             device=device)
    args.device = str(mesh.device)
    sol, info = _select(args, ckpt_dir, spec, max_restarts, mesh=mesh)
    return sol.map(lambda x: x.cpu()), info


def _supervised(args, ckpt_dir, spec=None, max_restarts=None):
    """A supervised selection: stacked, or over --lanes spawned ranks
    (rank 0's root and log; every rank returns the same root)."""
    mr = args.max_restarts if max_restarts is None else max_restarts
    if not args.mesh:
        return _select(args, ckpt_dir, spec, mr)
    from repro_torch.launch.spawn import run_ranks
    if args.device == "cuda":
        from repro_torch.kernels import build
        for name in build.SOURCES:  # built once here, not raced by ranks
            build.load(name)
    t0 = time.time()
    out = run_ranks(_rank_select, args.lanes,
                    args=(args, ckpt_dir, spec, mr), timeout=SPAWN_DEADLINE)
    sol, info = out[0]
    for other, _ in out[1:]:
        if not bool((other.ids == sol.ids).all()):
            raise RuntimeError("the ranks returned different roots")
    info["wall_s"] = time.time() - t0
    return sol, info


def _print_events(events):
    for ev in events:
        kw = {k: v for k, v in ev.items() if k not in ("kind", "time")}
        print(f"  [{ev['kind']:>12s}] " + " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in kw.items()))


def _spec(args):
    if args.fail_level < 0:
        return None
    return ("dead" if args.permanent else "transient", args.fail_level,
            args.fail_lane)


def run(args) -> int:
    if args.stream:
        return _run_stream(args, _injector(_spec(args)))
    with tempfile.TemporaryDirectory() as d:
        sol, info = _supervised(args, args.ckpt_dir or d, _spec(args))
    mode = "mesh" if args.mesh else "stacked"
    print(f"faultrun[{mode}] {args.objective} n={args.n} k={args.k} "
          f"tree={info['tree']} final={info['final_tree']} "
          f"degraded={info['degraded']} f={float(sol.value):.3f} "
          f"[{info['wall_s']:.1f}s]")
    _print_events(info["events"])
    return 0


def _stream_objective(args, st):
    import torch
    from repro_torch.core.functions import make_objective
    if args.objective == "kcover":
        return make_objective("kcover", universe=args.universe,
                              device=args.device), None
    return (make_objective(args.objective, device=args.device),
            torch.as_tensor(st.payloads))


def _run_stream(args, injector) -> int:
    from repro_torch.data.synthetic import gen_stream
    from repro_torch.runtime.supervisor import SelectionSupervisor
    from repro_torch.streaming.driver import stream_select_continuous

    st = gen_stream(args.objective, args.n, d=args.d,
                    universe=args.universe, batch=args.batch, seed=args.seed)
    obj, ground = _stream_objective(args, st)
    with tempfile.TemporaryDirectory() as d:
        sup = SelectionSupervisor(ckpt_dir=args.ckpt_dir or d,
                                  injector=injector,
                                  max_restarts=args.max_restarts)
        t0 = time.time()
        sol, info = stream_select_continuous(
            obj, st, args.k, lanes=args.lanes,
            branching=args.branching or args.lanes,
            merge_every=args.merge_every, ground=ground, supervisor=sup)
        dt = time.time() - t0
    print(f"faultrun[stream] {args.objective} n={args.n} k={args.k} "
          f"lanes={args.lanes} f={float(sol.value):.3f} "
          f"merges={info['merges']} [{dt:.1f}s]")
    _print_events(info["events"])
    return 0


def _same(a, b) -> bool:
    return bool((a.ids.cpu() == b.ids.cpu()).all())


def smoke(args) -> int:
    """Acceptance: replay bit-identity, the degraded band, supervised
    streaming. Returns non-zero on any violation."""
    from repro_torch.core.functions import make_objective
    from repro_torch.data.synthetic import gen_stream
    from repro_torch.runtime.supervisor import (LaneFailureInjector,
                                                SelectionSupervisor)
    from repro_torch.streaming.driver import stream_select_continuous

    args.objective, args.n, args.universe = "kcover", 512, 512
    args.k, args.seed = 8, 2
    rc = 0
    fail_lane = args.lanes - 1

    with tempfile.TemporaryDirectory() as d0:
        clean, cinfo = _supervised(args, d0)
    print(f"clean     f={float(clean.value):.3f} tree={cinfo['tree']}")

    # --- transient failure at level 1 → level replay, bit-identical ------
    with tempfile.TemporaryDirectory() as d1:
        sol, info = _supervised(args, d1, ("transient", 1, fail_lane))
    kinds = [e["kind"] for e in info["events"]]
    same = _same(sol, clean)
    ok = (same and float(sol.value) == float(clean.value)
          and "failure" in kinds and "restore" in kinds)
    print(f"replay    f={float(sol.value):.3f} bit-identical={same}")
    if not ok:
        print("FAIL: replay path not bit-identical to failure-free run")
        _print_events(info["events"])
        rc |= 1

    # --- permanent lane loss → degraded tree, ≥ 0.95× quality band -------
    with tempfile.TemporaryDirectory() as d2:
        sol, info = _supervised(args, d2, ("dead", 1, fail_lane),
                                max_restarts=1)
    kinds = [e["kind"] for e in info["events"]]
    ratio = float(sol.value) / float(clean.value)
    print(f"degraded  f={float(sol.value):.3f} ratio={ratio:.4f} "
          f"final_tree={info['final_tree']}")
    if not (info["degraded"] and "reshard" in kinds and ratio >= 0.95):
        print("FAIL: degraded-tree run outside the 0.95 quality band "
              "or no reshard event")
        _print_events(info["events"])
        rc |= 1

    # --- supervised streaming: a transient merge failure replays ---------
    st = gen_stream("kcover", 256, universe=384, batch=64, seed=args.seed)
    obj = make_objective("kcover", universe=384, device=args.device)
    sref, _ = stream_select_continuous(obj, st, args.k, lanes=4,
                                       merge_every=2)
    with tempfile.TemporaryDirectory() as d3:
        sup = SelectionSupervisor(ckpt_dir=d3,
                                  injector=LaneFailureInjector(
                                      fail_at=((1, 1),)))
        ssol, sinfo = stream_select_continuous(obj, st, args.k, lanes=4,
                                               merge_every=2,
                                               supervisor=sup)
    skinds = [e["kind"] for e in sinfo["events"]]
    sok = _same(ssol, sref) and "failure" in skinds and "restart" in skinds
    print(f"stream    f={float(ssol.value):.3f} replay-identical={sok}")
    if not sok:
        print("FAIL: supervised streaming replay diverged")
        _print_events(sinfo["events"])
        rc |= 1
    print("fault smoke", "FAILED" if rc else "OK")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--objective", default="kcover",
                    choices=["facility", "kmedoid", "kcover"])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--d", type=int, default=24)
    ap.add_argument("--universe", type=int, default=512)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--branching", type=int, default=2)
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", action="store_true")
    ap.add_argument("--fail-level", type=int, default=-1)
    ap.add_argument("--fail-lane", type=int, default=0)
    ap.add_argument("--permanent", action="store_true")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--stream", action="store_true")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--merge-every", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        from repro_torch.runtime.device import resolve_device
        resolve_device(None)          # raises when there is no card
    if args.smoke:
        return smoke(args)
    return run(args)


if __name__ == "__main__":
    raise SystemExit(main())
