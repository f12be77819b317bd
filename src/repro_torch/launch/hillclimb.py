"""Perf hillclimbing harness (answers `src/repro/launch/hillclimb.py`).

Each experiment = (cell, variant-transform). For every variant the dry
run (`launch/dryrun.py`: the step traced on the meta device over a fake
world of 256 ranks) re-runs the full pass (memory) and the 1×/2×-period
probes (flops / collective bytes / bytes accessed fits), and all three
roofline terms are reported next to the baseline. Variants are opt-in
config/profile flags so baselines stay paper-faithful.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \
        --exp smollm_dp_only [--out results/hillclimb_torch]
    PYTHONPATH=src python -m repro_torch.launch.hillclimb \
        --table results/dryrun_torch     # the sweep's table

``HW`` is the card the port runs on, from its datasheet: NVIDIA H100
SXM5 80GB at 700 W — 989.4e12 dense bf16 tensor FLOP/s, 3.35e12 B/s of
HBM3, and 50e9 B/s of link a GPU (one 400 Gb/s NDR port; each 16-rank
mesh dim crosses 8-GPU nodes). The reference's ``HW`` is a TPU's.
The technique experiments run GreedyML on ``--device`` (the card by
default; 'cpu' the plain path).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import dryrun as DR
from repro_torch.sharding import axes as AX

HW = {"flops": 989.4e12, "hbm": 3.35e12, "link": 50e9}


def run_lm_variant(arch, shape_name, mesh, devices, cfg_fn=None,
                   profile="default", remat=None, micro_per_dev=1):
    """Full pass (memory) + probe fits for a (possibly transformed) cfg."""
    AX.use_profile(profile)
    try:
        cfg, ocfg = DR._cell_cfgs(arch)
        if cfg_fn is not None:
            cfg = cfg_fn(cfg)
        shape = registry.get_shape(shape_name)
        rm = remat or DR._remat(cfg)
        return DR.lm_record(cfg, ocfg, shape, mesh, devices, rm,
                            tcfg=TrainConfig(
                                microbatch_per_device=micro_per_dev))
    finally:
        AX.use_profile("default")


def terms(rec):
    est = rec["estimated"]
    return {
        "mem_gib": rec["per_device"]["memory"]["total_bytes"] / 2 ** 30,
        "t_compute": max(est["flops"], 0.0) / HW["flops"],
        "t_memory": max(est["bytes_accessed"], 0.0) / HW["hbm"],
        "t_collective": max(est["collective_moved_bytes"], 0.0) / HW["link"],
    }


def memory_floor(rec) -> float:
    """The memory term of a fused step: its arguments read once and its
    outputs written once, over HW's HBM rate (the kernels' bound rule).
    ``terms``' t_memory, from every eager op's inputs and outputs, is the
    unfused upper bound."""
    m = rec["per_device"]["memory"]
    return (m["argument_bytes"] + m["output_bytes"]) / HW["hbm"]


def _lead(t) -> str:
    return max(t, key=t.get).removeprefix("t_")


def sweep_table(dryrun_dir: str) -> str:
    """The sweep's records in `dryrun_dir` as a markdown table, a row a
    cell: memory a device (GB) on each mesh, the single mesh's estimated
    flops and collective bytes, the three terms on ``HW`` (memory from
    the fused floor to the unfused bound), the term that leads under
    each, and the seconds; then the cells that failed."""
    recs = {}
    for fname in sorted(os.listdir(dryrun_dir)):
        if fname.endswith(".json"):
            with open(os.path.join(dryrun_dir, fname)) as f:
                rec = json.load(f)
            recs.setdefault(f"{rec['arch']}:{rec['shape']}", {})[
                rec["mesh"]] = rec
    rows = ["| cell | mem a device, single / multi (GB) | flops a device "
            "| collective GB | compute s | memory s, fused floor – "
            "unfused | collective s | leads, floor / unfused "
            "| seconds single / multi |", "|" + "---|" * 9]
    failed = []
    for cell, by_mesh in sorted(recs.items()):
        mem = " / ".join(
            f"{by_mesh[m]['per_device']['memory']['total_bytes'] / 1e9:.1f}"
            if by_mesh.get(m, {}).get("ok") else
            ("fails" if m in by_mesh else "—") for m in ("single", "multi"))
        secs = " / ".join(f"{by_mesh[m]['seconds']}" if m in by_mesh
                          else "—" for m in ("single", "multi"))
        failed += [f"{cell} {m}: {r['error'][:160]}"
                   for m, r in sorted(by_mesh.items()) if not r["ok"]]
        rec = by_mesh.get("single")
        if not (rec and rec["ok"] and "estimated" in rec):
            continue
        t = terms(rec)
        floor = memory_floor(rec)
        unfused = dict(t, t_memory=t["t_memory"])
        fused = dict(t, t_memory=floor)
        del unfused["mem_gib"], fused["mem_gib"]
        est = rec["estimated"]
        rows.append(
            f"| {cell} | {mem} | {est['flops']:.3g} "
            f"| {est['collective_moved_bytes'] / 1e9:.3g} "
            f"| {t['t_compute']:.3g} | {floor:.3g} – {t['t_memory']:.3g} "
            f"| {t['t_collective']:.3g} | {_lead(fused)} / {_lead(unfused)} "
            f"| {secs} |")
    return "\n".join(rows + [""] + [f"- FAILED {f}" for f in failed])


def report(name, rec):
    t = terms(rec)
    dom = max(("t_compute", "t_memory", "t_collective"), key=t.get)
    print(f"{name:42s} mem={t['mem_gib']:7.2f}GiB "
          f"compute={t['t_compute']:8.3f}s memory={t['t_memory']:8.3f}s "
          f"collective={t['t_collective']:8.3f}s  dominant={dom}",
          flush=True)
    return t


def _single_mesh():
    return DR.production_mesh("single")


def _technique_rec(device, name="greedyml-facility"):
    res = DR.run_technique(name, "single", device)
    return {"devices": 256, "per_device": DR._per_device(res),
            "estimated": DR.technique_estimate(res)}


EXPERIMENTS = {}


def exp(name):
    def deco(fn):
        EXPERIMENTS[name] = fn
        return fn
    return deco


@exp("llama4_token_exchange")
def llama4_token_exchange(device="cuda"):
    """Hypothesis: the baseline's collective term is dominated by per-layer
    FSDP all-gathers of expert weights (2 GB/layer/microbatch per device);
    constraining the dispatched tokens' embed dim onto the weights' 'data'
    shards turns weight movement into token movement (~3 MB/layer) + an
    f-dim partial-sum all-reduce. Predicted: collective term ↓ ≥ 10×."""
    mesh = _single_mesh()
    base = run_lm_variant("llama4-maverick-400b-a17b", "train_4k", mesh, 256)
    report("llama4 train_4k BASELINE", base)

    def flip(cfg):
        return cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                   token_exchange=True))
    var = run_lm_variant("llama4-maverick-400b-a17b", "train_4k", mesh, 256,
                         cfg_fn=flip)
    report("llama4 train_4k +token_exchange", var)
    return {"baseline": base, "token_exchange": var}


@exp("llama4_iter2_bf16ar")
def llama4_iter2_bf16ar(device="cuda"):
    """Iteration 2. Hypothesis: after token-exchange the residual collective
    is the f32 partial-sum all-reduce of the two expert activations
    (2 × 1.7 GB/layer). bf16 accumulation for those einsums halves both the
    AR bytes and the h-tensor HBM traffic. Predicted: collective ↓ ~2×,
    memory ↓ ~1.3×."""
    mesh = _single_mesh()

    def flip(cfg):
        return cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                   token_exchange=True))
    var = run_lm_variant("llama4-maverick-400b-a17b", "train_4k", mesh, 256,
                         cfg_fn=flip)
    report("llama4 train_4k token_exchange+bf16AR", var)
    return {"token_exchange_bf16ar": var}


@exp("smollm_dp_only")
def smollm_dp_only(device="cuda"):
    """Hypothesis: smollm-135m wastes the model axis (9 heads & tiny dims
    don't shard 16-way → replicated attention = 16× redundant compute).
    Folding the model axis into the batch (dp_only profile: 256-way DP,
    1 seq/device) removes all TP replication. Predicted: compute term
    ↓ ~5–10×, collective term changes shape (no TP all-reduces; FSDP
    gathers over a 256-way axis)."""
    mesh = _single_mesh()
    base = run_lm_variant("smollm-135m", "train_4k", mesh, 256)
    report("smollm train_4k BASELINE", base)
    var = run_lm_variant("smollm-135m", "train_4k", mesh, 256,
                         profile="dp_only")
    report("smollm train_4k +dp_only", var)
    return {"baseline": base, "dp_only": var}


@exp("smollm_dp_only_micro4")
def smollm_dp_only_micro4(device="cuda"):
    """Follow-up: with 256-way DP each device has exactly 1 sequence, so
    there is no microbatch loop left (n_micro=1) — FSDP weights are
    gathered once per step instead of 16×. Predicted: collective ↓ ~16×
    vs dp_only-with-16-micro."""
    mesh = _single_mesh()
    var = run_lm_variant("smollm-135m", "train_4k", mesh, 256,
                         profile="dp_only", micro_per_dev=1)
    report("smollm train_4k dp_only micro=1", var)
    return {"dp_only_micro1": var}


@exp("smollm_iter2_no_remat")
def smollm_iter2_no_remat(device="cuda"):
    """Iteration 2 (after dp_only). Hypothesis: a 135M model at 1 seq/device
    needs no activation checkpointing — remat='none' removes the recompute
    pass (compute −25%) and its re-read traffic (memory ↓). Predicted:
    compute ↓ ~1.3×, memory ↓ ~1.2×, small activation-memory increase."""
    mesh = _single_mesh()
    var = run_lm_variant("smollm-135m", "train_4k", mesh, 256,
                         profile="dp_only", remat="none")
    report("smollm train_4k dp_only+no_remat", var)
    return {"dp_only_no_remat": var}


def _facility_variant(device, label: str, **change):
    """The facility cell under `change` to its TECHNIQUE_CELLS entry,
    restored after."""
    old = DR.TECHNIQUE_CELLS["greedyml-facility"]
    DR.TECHNIQUE_CELLS["greedyml-facility"] = dict(old, **change)
    try:
        rec = _technique_rec(device)
        report(label, rec)
        return rec
    finally:
        DR.TECHNIQUE_CELLS["greedyml-facility"] = old


@exp("facility_bf16")
def facility_bf16(device="cuda"):
    """Hypothesis: the selection step is memory-term-bound on the ground-set
    payload reads (f32). bf16 payloads halve the bytes term at negligible
    quality cost (gains reduce in f32 anyway). Predicted: memory ↓ 2×."""
    rec_b = _technique_rec(device)
    report("greedyml-facility BASELINE", rec_b)
    rec_v = _facility_variant(
        device, "greedyml-facility +bf16 payloads", dtype="bfloat16")
    return {"baseline": rec_b, "bf16": rec_v}


@exp("facility_stochastic")
def facility_stochastic(device="cuda"):
    """Iteration 2 (facility). Hypothesis: the selection step is
    memory-term-bound on the per-step re-scan of the hoisted leaf similarity
    matrix (k × n/m·n/m reads). Stochastic greedy (Mirzasoleiman et al.
    2015) samples s=64 candidates per step — (1−1/e−ε) guarantee with
    s ≈ (n/k)ln(1/ε) — cutting the leaf gains reads by n/(m·s) = 64×.
    Measured quality on this instance: 0.997 of exact (see
    tests/test_core_properties.py). Predicted: memory term ↓ ≫5×."""
    rec_b = _technique_rec(device)
    report("greedyml-facility BASELINE", rec_b)
    rec_v = _facility_variant(
        device, "greedyml-facility +stochastic(s=64)", sample=64)
    return {"baseline": rec_b, "stochastic": rec_v}


@exp("facility_stochastic_levels")
def facility_stochastic_levels(device="cuda"):
    """Iteration 3 (facility). After leaf sampling, the remaining memory
    term is the EXACT accumulation-node greedies re-scanning their b·k=4096
    union similarity rows every step. Sample there too (s=64; the union is
    already a pre-screened high-quality pool, so quality risk is lower than
    at leaves). Predicted: memory ↓ another ~3×."""
    rec_v = _facility_variant(
        device, "greedyml-facility +stochastic(leaf+level)", sample=64,
        sample_level=64)
    return {"stochastic_levels": rec_v}


def run_experiment(name: str, device="cuda"):
    """One experiment in a fake world of 256 ranks (its own group); the
    technique experiments run GreedyML on `device`."""
    with DR.fake_world(256):
        return EXPERIMENTS[name](device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", default="all",
                    choices=["all"] + sorted(EXPERIMENTS))
    ap.add_argument("--out", default="results/hillclimb_torch")
    ap.add_argument("--device", default="cuda",
                    help="the technique experiments' device")
    ap.add_argument("--list", action="store_true",
                    help="print the experiments' names and stop")
    ap.add_argument("--table", metavar="DRYRUN_DIR",
                    help="print the sweep table of a dry run's records "
                         "and stop")
    args = ap.parse_args(argv)
    if args.list:
        print("\n".join(sorted(EXPERIMENTS)))
        return {}
    if args.table:
        print(sweep_table(args.table))
        return {}
    os.makedirs(args.out, exist_ok=True)
    names = sorted(EXPERIMENTS) if args.exp == "all" else [args.exp]
    results = {}
    for name in names:
        print(f"\n### {name}: {EXPERIMENTS[name].__doc__.splitlines()[0]}",
              flush=True)
        t0 = time.time()
        try:
            out = run_experiment(name, args.device)
        except Exception as e:  # noqa: BLE001 — record, go on
            out = {"error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"### {name} FAILED: {out['error'][:200]}", flush=True)
        out["seconds"] = round(time.time() - t0, 1)
        with open(os.path.join(args.out, f"{name}.json"), "w") as f:
            json.dump(out, f, indent=1, default=str)
        print(f"### {name} done in {time.time()-t0:.0f}s", flush=True)
        results[name] = out
    return results


if __name__ == "__main__":
    main()
