"""Streaming selection driver, the online counterpart of summarize.py
(answers `src/repro/launch/stream.py`).

    PYTHONPATH=src python -m repro_torch.launch.stream --objective facility \\
        --n 2048 --batch 128 --k 32 --order drift --compare

Runs the sieve-streaming engine (`repro_torch.streaming`) over a
deterministic synthetic arrival stream (`data/synthetic.py::gen_stream`).
Modes:

  * default        — one sieve over the whole stream (``--ckpt-dir`` /
                     ``--ckpt-every`` / ``--resume``: checkpoint and
                     resume it)
  * --continuous   — `--lanes` stacked lane sieves with a GreedyML tree
                     merge every `--merge-every` batches, one device
  * --distributed  — the same continuous mode over `--lanes` spawned gloo
                     ranks (launch/spawn.py::run_ranks, a deadline), one
                     lane a rank, each on ``--device``: it replaces the
                     reference's shard_map over forced host devices
  * --window W     — a sliding-window summary of the last W arrivals

``--device`` (default ``cuda``; ``cpu`` runs the plain path) places the
objective, the evaluation set and the sieves; without a GPU, ``cuda``
raises. ``--smoke`` runs a tiny instance through single, window and
continuous (with a checkpoint/resume round trip) and exits non-zero on a
quality or resume mismatch.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

import numpy as np

SPAWN_DEADLINE = 300.0       # seconds the --distributed ranks may run


def _device(args):
    from repro_torch.runtime.device import resolve_device
    return resolve_device(None if args.device == "cuda" else args.device)


def _make(args):
    """(host stream, the stream on the device, objective, evaluation
    ground) of the configured instance."""
    import torch
    from repro_torch.core.functions import make_objective
    from repro_torch.data.synthetic import gen_stream
    from repro_torch.kernels.rules import to_words

    dev = _device(args)
    st = gen_stream(args.objective, args.n, d=args.d,
                    universe=args.universe, batch=args.batch,
                    order=args.order, seed=args.seed)
    if args.objective in ("kcover", "kdom"):
        obj = make_objective("kcover", universe=args.universe, device=dev)
        ground = None
        pay = to_words(st.payloads).to(dev)
    else:
        obj = make_objective(args.objective, device=dev)
        ground = pay = torch.as_tensor(st.payloads, device=dev)
    return st, dataclasses.replace(st, payloads=pay), obj, ground


def _ids(sol):
    return sol.ids[sol.valid].cpu().numpy()


def _sync(obj) -> None:
    import torch
    if obj.device.type == "cuda":
        torch.cuda.synchronize(obj.device)


def _rank_stream(rank, args):
    """One rank of --distributed: its lane of every batch, merged over
    the ranks → (the root, the same on every rank, on the CPU; info; the
    rank's stream seconds, ended by a device synchronize)."""
    from repro_torch.launch.mesh import make_machine_mesh
    from repro_torch.streaming import stream_select_distributed
    device = None if args.device == "cuda" else args.device
    mesh = make_machine_mesh(args.lanes, args.lanes, device=device)
    args.device = str(mesh.device)
    _, dst, obj, ground = _make(args)
    t0 = time.perf_counter()
    sol, info = stream_select_distributed(
        obj, dst, args.k, mesh, merge_every=args.merge_every, eps=args.eps,
        ground=ground)
    _sync(obj)
    return sol.map(lambda x: x.cpu()), info, time.perf_counter() - t0


def _distributed(args):
    from repro_torch.launch.spawn import run_ranks
    if args.device == "cuda":
        from repro_torch.kernels import build
        for name in build.SOURCES:   # built once here, not raced by ranks
            build.load(name)
    out = run_ranks(_rank_stream, args.lanes, args=(args,),
                    timeout=SPAWN_DEADLINE)
    sol, info, _ = out[0]
    for other, _, _ in out[1:]:
        if not bool((other.ids == sol.ids).all()):
            raise RuntimeError("the ranks returned different roots")
    return sol, info, max(wall for _, _, wall in out)


def select(args, dst, obj, ground):
    """(Solution, info, mode, seconds) of one run of the configured mode
    over `_make`'s device stream, objective and ground; the seconds end
    in a device synchronize (for --distributed, the slowest rank's
    stream, its spawn left out)."""
    from repro_torch.streaming import (SieveStreamer, SlidingSieve,
                                       stream_select,
                                       stream_select_continuous)
    info = {}
    t0 = time.perf_counter()
    if args.window:
        streamer = SieveStreamer(obj, args.k, args.eps, ground=ground)
        win = SlidingSieve(streamer, args.window,
                           args.stride or args.window // 2)
        wstate = win.init()
        for ids, pay, valid in dst:
            wstate = win.process_batch(wstate, ids, pay, valid)
        sol = win.query(wstate)
        mode = f"window[{args.window}/{win.stride}]"
    elif args.distributed:
        sol, info, wall = _distributed(args)
        mode = f"distributed[{args.lanes} lanes]"
        return sol, info, mode, wall
    elif args.continuous:
        sol, info = stream_select_continuous(
            obj, dst, args.k, lanes=args.lanes,
            merge_every=args.merge_every, eps=args.eps, ground=ground)
        mode = f"continuous[{args.lanes} lanes]"
    else:
        sol = stream_select(obj, dst, args.k, eps=args.eps, ground=ground,
                            ckpt_dir=args.ckpt_dir,
                            ckpt_every=args.ckpt_every, resume=args.resume)
        mode = "single"
    _sync(obj)
    return sol, info, mode, time.perf_counter() - t0


def _global(args, st, ids) -> float:
    from repro_torch.core.simulate import global_value
    name = args.objective if args.objective != "kdom" else "kcover"
    return global_value(name, st.payloads, ids, args.universe,
                        device="cpu")


def run(args) -> int:
    st, dst, obj, ground = _make(args)
    sol, info, mode, dt = select(args, dst, obj, ground)
    ids = _ids(sol)
    gv = _global(args, st, ids)
    rate = st.n / max(dt, 1e-9)
    print(f"stream[{mode}] {args.objective} n={st.n} k={args.k} "
          f"f={gv:.3f} |S|={len(ids)} arrivals/s={rate:.0f} "
          f"[{dt:.1f}s] {info.get('merges', '')}", flush=True)
    if args.compare:
        import torch
        from repro_torch.core.greedy import greedy
        g = greedy(obj, torch.arange(st.n, device=obj.device), dst.payloads,
                   torch.ones(st.n, dtype=torch.bool, device=obj.device),
                   args.k)
        ggv = _global(args, st, _ids(g))
        print(f"offline greedy f={ggv:.3f}  sieve/greedy = {gv / ggv:.4f}",
              flush=True)
        if gv < (0.5 - args.eps) * ggv:
            print("FAIL: below the (1/2 - eps) sieve bound")
            return 1
    return 0


def smoke(args) -> int:
    """Tiny end-to-end pass across the subsystem."""
    from repro_torch.streaming import stream_select
    args.n, args.batch, args.k = 256, 64, 8
    args.d, args.universe = 24, 384
    rc = 0
    for objective in ("facility", "kcover"):
        args.objective = objective
        args.compare = True
        for setup in ("single", "window", "continuous"):
            a = argparse.Namespace(**vars(args))
            a.window = 128 if setup == "window" else 0
            a.stride = 64
            a.continuous = setup == "continuous"
            a.distributed = False
            a.lanes, a.merge_every = 4, 2
            rc |= run(a)
    # checkpoint/resume round trip: half the stream, checkpoint, resume
    _, dst, obj, ground = _make(args)
    with tempfile.TemporaryDirectory() as d:
        full = stream_select(obj, dst, args.k, ground=ground)
        half = list(dst.batches())[: dst.n // args.batch // 2]
        stream_select(obj, half, args.k, ground=ground, ckpt_dir=d,
                      ckpt_every=1)
        resumed = stream_select(obj, dst, args.k, ground=ground,
                                ckpt_dir=d, resume=True)
        if not np.array_equal(_ids(full), _ids(resumed)):
            print("FAIL: checkpoint resume diverged")
            rc |= 1
        else:
            print("checkpoint resume OK")
    print("stream smoke", "FAILED" if rc else "OK", flush=True)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--objective", default="facility",
                    choices=["facility", "kmedoid", "kcover"])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--universe", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--eps", type=float, default=0.1)
    ap.add_argument("--order", default="shuffled",
                    choices=["shuffled", "adversarial", "drift"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--continuous", action="store_true")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--merge-every", type=int, default=4)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--stride", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    _device(args)                    # raises for cuda without a card
    if args.smoke:
        return smoke(args)
    return run(args)


if __name__ == "__main__":
    raise SystemExit(main())
