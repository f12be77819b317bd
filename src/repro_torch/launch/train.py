"""End-to-end training driver (answers `src/repro/launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 200 --smoke --data-selection greedyml:facility [--device cpu]

Pipeline: synthesize the corpus → (optional) GreedyML coreset selection
on the device → supervised train loop with checkpointing, failure
recovery and straggler monitoring. ``--smoke`` shrinks the arch to its
reduced config; ``--device`` (default ``cuda``; ``cpu`` runs here)
places the model, the batches and the selection; without a GPU,
``cuda`` raises. ``--mesh local`` trains on a one-device
("data", "model") mesh (microbatches of one, as the reference's local
mesh gives); ``single`` and ``multi`` raise (ROADMAP item 10c).

The weights are drawn from a `torch.Generator` seeded with ``--seed``
(the reference's come from ``jax.random``, which torch cannot
reproduce); the corpus, the coreset and the batches are the reference's.
The train step updates its state in place, as the reference donates its
state to the jitted step: a failure is recovered from the latest
checkpoint (a failure before the first one would restart from the
state as it then stands). Without ``--ckpt-dir`` the checkpoints go to
a fresh temporary directory, removed when the run ends: a run then
never resumes from another run's checkpoints, as it would from the
reference's fixed default directory.

``main`` returns the run: the final state, the step reached, the
supervisor's events, the loss at every step run and the coreset.
"""
from __future__ import annotations

import argparse
import contextlib
import tempfile
import time

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import OptimConfig, ShapeConfig, TrainConfig
from repro_torch.data import pipeline, selection, synthetic
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.fault import FailureInjector, Supervisor
from repro_torch.runtime.straggler import StragglerMonitor


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    choices=sorted(registry.ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--global-batch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "local", "single", "multi"])
    ap.add_argument("--data-selection", default="none",
                    help="'greedyml:facility', 'randgreedi:kmedoid', …")
    ap.add_argument("--selection-k", type=int, default=256)
    ap.add_argument("--corpus-docs", type=int, default=512)
    ap.add_argument("--ckpt-dir", default=None,
                    help="resume from and save to this directory "
                         "(default: a fresh temporary one)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject WorkerFailure at these steps (testing)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with contextlib.ExitStack() as stack:
        if args.ckpt_dir is None:
            args.ckpt_dir = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="repro_train_"))
        return _run(args)


def _run(args) -> dict:
    dev = resolve_device(None if args.device == "cuda" else args.device)

    cfg = (registry.smoke_config(args.arch) if args.smoke
           else registry.get_arch(args.arch))
    seq = args.seq or (64 if args.smoke else 4096)
    gb = args.global_batch or (8 if args.smoke else 256)
    shape = ShapeConfig("train", "train", seq, gb)
    ocfg = OptimConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                       total_steps=args.steps)
    tcfg = TrainConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       data_selection=args.data_selection,
                       selection_k=args.selection_k, seed=args.seed)

    mesh = None
    if args.mesh == "local":
        mesh = make_local_mesh(device=dev)
    elif args.mesh in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=args.mesh == "multi")

    # ---- corpus + GreedyML data selection --------------------------------
    toks = synthetic.gen_tokens(args.corpus_docs, seq + 1, cfg.vocab_size,
                                seed=args.seed)
    ds = pipeline.TokenDataset(toks, seed=args.seed)
    sel = None
    if args.data_selection != "none":
        emb = selection.embed_documents(toks[:, :seq], seed=args.seed)
        # one rank: the single-device tree on the device (mesh=None). The
        # reference hands its local mesh to select_coreset, which then
        # runs its distributed driver over that one device instead.
        sel = selection.select_coreset(
            emb, args.selection_k, spec=args.data_selection, mesh=None,
            seed=args.seed, device=dev)
        ds.selected = sel
        print(f"[data-selection] {args.data_selection}: kept {len(sel)} of "
              f"{args.corpus_docs} documents", flush=True)

    # ---- build step -------------------------------------------------------
    state, _ = steps.concrete_state(
        torch.Generator(device=dev).manual_seed(args.seed), cfg, ocfg)
    step_fn = steps.make_train_step(cfg, ocfg, tcfg, shape, mesh)

    monitor = StragglerMonitor()
    injector = FailureInjector(tuple(args.fail_at)) if args.fail_at else None
    sup = Supervisor(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     injector=injector)
    losses = {}

    def one_step(st, step):
        t0 = time.perf_counter()
        batch = pipeline.place(ds.batch(step, gb), mesh, dev)
        st, metrics = step_fn(st, batch)
        loss = float(metrics["loss"])           # waits for the device
        dt = time.perf_counter() - t0
        monitor.observe(step, dt)
        losses[step] = loss
        if step % 10 == 0:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1e3:7.1f} ms",
                  flush=True)
        return st, {"loss": loss}

    state, final_step = sup.run(state, one_step, args.steps)
    print(f"done at step {final_step}; events: "
          f"{[e['kind'] for e in sup.events]}", flush=True)
    return {"state": state, "step": final_step, "events": sup.events,
            "losses": losses, "selected": sel, "cfg": cfg,
            "straggler_actions": monitor.actions, "device": str(dev)}


if __name__ == "__main__":
    main()
