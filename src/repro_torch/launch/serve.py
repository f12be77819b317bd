"""Batched MODEL serving driver: prefill a batch of prompts, then decode
tokens (answers `src/repro/launch/serve.py`). For serving SELECTION
queries see `repro_torch.launch.qserve`.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --smoke --prompt-len 64 --gen 16 --batch 4 [--device cpu]

Random weights (``--seed``) and a random prompt batch (``--seed`` + 1).
``--device`` (default ``cuda``; ``cpu`` runs here) places the model;
without a GPU, ``cuda`` raises. ``--temperature 0`` decodes the argmax;
a positive temperature samples from a torch.Generator seeded with
``--seed`` + 2 (the reference draws from jax.random, which torch cannot
reproduce). ``--warmup N`` runs N untimed prefill + decode rounds first.
``--layers L`` cuts the model's depth to L layers at its full width.
Times end in a device synchronize (CUDA events on the card).

``main`` returns the run (config, parameters, prompt batch, tokens,
every step's logits, times); ``teacher_forced(run)`` holds its tokens
against one forward over prompt + generation.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import steps
from repro_torch.models import api, transformer as T
from repro_torch.runtime.device import resolve_device


class _Clock:
    """Milliseconds between start() and stop(), ended by a synchronize:
    CUDA events on the card, the host clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            t1.synchronize()
            return self._t0.elapsed_time(t1)
        return (time.perf_counter() - self._t0) * 1e3


def _next_token(logits, temperature: float, gen: torch.Generator):
    if temperature > 0:
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)
    return torch.argmax(logits, dim=-1)[:, None]


def _generate(prefill, decode, params, batch, n_gen: int,
              temperature: float, gen: torch.Generator, clock: _Clock):
    """(tokens (B, n_gen), their logits (B, n_gen, V), prefill ms,
    decode ms)."""
    clock.start()
    logits, cache = prefill(params, batch)
    t_prefill = clock.stop()
    toks = _next_token(logits, temperature, gen)
    out, step_logits = [toks], [logits]
    clock.start()
    for _ in range(n_gen - 1):
        logits, cache = decode(params, cache, {"tokens": toks})
        toks = _next_token(logits, temperature, gen)
        out.append(toks)
        step_logits.append(logits)
    t_decode = clock.stop()
    return (torch.cat(out, dim=1), torch.stack(step_logits, dim=1),
            t_prefill, t_decode)


def teacher_forced(run: dict, margin: float = 0.05) -> dict:
    """One forward over a run's prompt + generated tokens (all but the
    last): at every generated position its argmax should be the token
    the run took. Counts the positions where it is not, and of those the
    ones where the forward's top-2 logits lie within ``margin`` (a
    rounding-order tie); the largest |forward − decode| logit; the
    forward's summed aux values (MoE)."""
    batch, toks = run["batch"], run["tokens"]
    s = batch["tokens"].shape[1]
    full = dict(batch, tokens=torch.cat([batch["tokens"], toks[:, :-1]], 1))
    with torch.inference_mode():
        logits, aux = T.forward(run["params"], full, run["cfg"])
        logits = logits[:, s - 1:]                     # (B, n, V)
        top2 = logits.topk(2, dim=-1).values
        miss = logits.argmax(-1) != toks
        near = miss & (top2[..., 0] - top2[..., 1] <= margin)
        diff = (logits - run["logits"]).abs().max()
    return {"positions": toks.numel(), "mismatches": int(miss.sum()),
            "within_margin": int(near.sum()),
            "max_logit_diff": float(diff),
            "aux": {k: float(v) for k, v in aux.items()}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    choices=sorted(registry.ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warmup", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.gen < 1:
        ap.error("--gen must be at least 1")
    dev = resolve_device(None if args.device == "cuda" else args.device)

    cfg = (registry.smoke_config(args.arch) if args.smoke
           else registry.get_arch(args.arch))
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    shape = ShapeConfig("serve", "prefill", args.prompt_len, args.batch)
    max_len = args.prompt_len + args.gen
    prefill = steps.make_prefill_step(cfg, None, max_len=max_len)
    decode = steps.make_decode_step(cfg, None)
    clock = _Clock(dev)
    with torch.inference_mode():
        params, _ = T.init_params(
            torch.Generator(device=dev).manual_seed(args.seed), cfg)
        batch = api.synth_batch(
            torch.Generator(device=dev).manual_seed(args.seed + 1), cfg,
            shape)
        sampler = torch.Generator(device=dev)
        for _ in range(args.warmup):
            _generate(prefill, decode, params, batch, min(args.gen, 2),
                      args.temperature, sampler, clock)
        sampler.manual_seed(args.seed + 2)
        gen, logits, t_prefill, t_decode = _generate(
            prefill, decode, params, batch, args.gen, args.temperature,
            sampler, clock)

    steps_run = args.gen - 1
    tok_s = steps_run * args.batch / max(t_decode / 1e3, 1e-9)
    print(f"prefill {args.batch}×{args.prompt_len} in {t_prefill:.1f} ms; "
          f"decode {steps_run} steps in {t_decode:.1f} ms "
          f"({tok_s:.1f} tok/s)")
    print("sample generations (token ids):")
    for row in gen[: min(4, args.batch)].tolist():
        print("  ", row)
    return {"cfg": cfg, "params": params, "batch": batch, "tokens": gen,
            "logits": logits, "prefill_ms": t_prefill, "decode_ms": t_decode,
            "decode_steps": steps_run, "tok_per_s": tok_s,
            "device": str(dev)}


if __name__ == "__main__":
    main()
