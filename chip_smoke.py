#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of GreedyML (src/repro_torch) on one GPU.

    python3 chip_smoke.py [--n 100000] [--seed 13]

Phases, each printing one JSON line; a failed phase raises and the
script exits non-zero:

  build      compile the six CUDA sources (one nvcc per source, in
             parallel) and report their register/shared-memory use
  data       draw the Tiny-ImageNet-shaped k-medoid data on the card
             (n × 12,288 f32, the gen_images mixture recipe)
  parity     every kernel against its plain PyTorch version on the card,
             at the runs' own shapes, for every feature rule: pairwise
             and the loops at the first leaf's pool and a level's 16
             node pools (there pairwise == the resident kernel's build
             bit for bit, and pairwise[bf16] by the float64 rule);
             then (line `parity_steps`) fused_step at the
             knapsack run's leaf (32 × 3,125²) and node (32 × 400²)
             shapes, gains at the stochastic run's leaf shape (32 ×
             3,125 ground rows × 72 sampled candidates), with a TF32
             build rejected; each also bit for bit against the design
             it replaced (fused_step's row blocks, gains' 64×64 tile:
             `vs_earlier_design`, `vs_64x64_build`, differing = 0)
  reference  small trees through the kernels against the same trees
             through the plain CPU path: run_tree_dense on small-integer
             facility data; then (line `reference_dispatch`)
             LevelDispatcher trees with a knapsack (costs in quarters)
             and with stochastic leaves — equal ids, values and spent
  run        run_tree_dense('kmedoid', …) with k = 200, m = 32, b = 2
             (L = 5), per-level wall time and launches, root value and
             its global re-scoring
  knapsack   LevelDispatcher over 32 lanes of 3,125 permuted images, a
             KnapsackSpec of uniform(0.5, 2) costs and budget 100: every
             stage on the fused engine (pairwise + 200 fused_step
             launches), spent ≤ budget at the root and every lane
  stochastic the same lanes without a constraint, sample_leaf = 72 (the
             paper's ε = 0.01 subset): leaves on the step engine (200
             gains launches, 1 gains_norms: the ground's norms once),
             nodes on the resident loop
  timing     each kernel at its path's shape beside its bound, its
             plain version and a one-call PyTorch yardstick (line
             `timing_steps` for fused_step and gains, with fused_step
             at the node shape, gains' once-a-greedy norms pass and the
             step engine's row update)

The memory-capped cache tiers (bf16 and int8 cached matrices, the
planner's storage ladder), between the phases above:

  parity_quant  (after parity_steps) the seven variants at the runs'
                shapes — leaf level 32 × 3,284², node level 16 × 400²,
                knapsack leaf 32 × 3,125² and node 32 × 400² — for
                kmedoid and facility, bit for bit against what runs the
                same arithmetic: pairwise[bf16] against the f32 kernel
                rounded, the chunked int8 cache against quantize_rows on
                the CPU, fused_step and the streaming loop against the
                f32 kernel on the dequantized cache, the resident
                scratch against round_resident of its f32 build; and
                against their plain versions (kernels/parity.py)
  run_bf16      (after run) run_tree_dense('kmedoid', …) with the bf16
  run_int8      / int8 rung forced (every level in that storage) and
                with REPRO_TORCH_FUSED_CACHE_MB = 1,024 / 512 (the
                planner's pick for the leaves; nodes f32): per level the
                engine, dtype and each variant's launches, the leaf
                stage's allocation beyond the pools held to the planned
                cache bytes (≤ 1.05× + one int8 chunk's f32), the root
                beside the f32 run's
  knapsack_bf16 (after knapsack) the knapsack lanes with the rung
  knapsack_int8 forced: every stage fused, k fused_step[bf16|int8]
                launches a stage, spent ≤ budget everywhere
  timing_quant  (after timing_steps) each variant at its path's shape
                beside its bound (the storage's own bytes), its plain
                version and, for pairwise[bf16], torch.cdist to bf16

Then the coverage problems, after the k-medoid tensors are freed:

  data_kcover       the KOSARAK k-cover bitmaps (990,002 sets over 41,270
                    items, gen_kcover + pack_bitmaps on the host, 5.1 GB
                    of 32-bit words placed on the card)
  parity_coverage   the four bitmap kernels against their plain versions
                    at the kcover runs' shapes, equal bit for bit: gains
                    (32 × 2,227 × 1,290), fused_step (leaf 32 × 30,938 ×
                    1,290, node 32 × 128 × 1,290), the streaming loop
                    (the first leaf level), the resident loop (every
                    level's 16, 8, 4, 2, 1 nodes and the stochastic
                    run's 32 lanes)
  kcover_run        run_tree_dense('kcover', …) at KOSARAK, T(32, 2):
                    1 streaming-loop launch at the leaves, 1 resident
                    launch per level, 0 pairwise; the leaf cache bytes
  kcover_knapsack   LevelDispatcher over 32 lanes, KnapsackSpec of
                    uniform(0.5, 2) costs, budget 40: 64 fused_step
                    launches a stage, spent ≤ budget everywhere
  kcover_stochastic the same lanes, sample_leaf 2,227: 64 gains launches
                    at the leaves, resident nodes
  kdom_run          run_tree_dense('kdom', …) at the reference's kdom
                    configuration (65,536 road-graph neighbourhoods),
                    after the streaming loop at its first leaf level
                    (8 × 8,355 × 2,048, k = 128) and the resident loop
                    at its levels' 4, 2, 1 nodes (× 256 × 2,048) are
                    held bit for bit against their plain versions
  timing_coverage   each bitmap kernel at its path's shape beside its
                    bytes bound and its plain version; the resident
                    loop also at other candidates per block

Streaming (sieve streaming: one stream-filter launch a batch for all
levels of all stacked sieves), beside the k-medoid phases:

  parity_stream        (after parity_quant) the stream filter at the
                       k-medoid stream's shape (72 levels × 16,384
                       evaluation rows × 256 arrivals × 12,288), three
                       chained batches fed the plain version's state,
                       kmedoid and facility, with and without costs:
                       the slab by the float64 pairwise rule, the
                       decisions by parity.compare_stream (ties
                       counted); the int8-ground variant bit for bit
                       against the f32 kernel on the dequantized
                       ground; the int8-ground gains at the stochastic
                       leaf shape, bit for bit and by the float64 rule
  parity_stream_global the stream filter beyond one block's shared
                       memory: kmedoid against all 100,000 images (72 ×
                       100,000 × 256 × 12,288, a level's row over a
                       cluster of 8 blocks), three chained batches by
                       the float64 slab rule and parity.compare_stream,
                       and the device-memory tier (forced) bit for bit
                       equal to it; bitmaps at 8,192 words (262,144
                       items), three batches bit for bit on both tiers
  reference_stream     (after reference_dispatch) small-integer facility
                       streams, kernel path == CPU path: stream_select,
                       a SlidingSieve, 4 continuous lanes
  stochastic_int8      (after stochastic) the stochastic lanes under the
                       int8 rung: 200 gains[int8] launches at the leaves
  stream_kmedoid       stream_select('kmedoid') over all 100,000 images
                       against all 100,000 (a cluster of 8 a level), k =
                       200, B = 256: 391 batches, one stream_filter and
                       one scatter_slots launch each; the summary's
                       digest (value, a hash of the sorted ids); then
                       (line `stream_idle`) the device's busy share and
                       the host's gap a batch over 20 traced batches
  stream_kmedoid_int8  the same stream, int8 ground, against 16,384 of
                       the images (the shared-memory tier); each value
                       on its evaluation set ≥ (½ − ε) of the `run`
                       root's there
  timing_stream        (after timing_quant) the stream filter per batch
                       (f32, int8 at 16,384 rows; f32 at 100,000 rows;
                       bitmaps at 8,192 words) and the int8-ground gains
                       beside their bounds and plain versions; each
                       filter row with its slab / decision split
                       (torch.profiler), CUDA launches a batch, admitted
                       count, and the feature rows' time on the
                       device-memory tier (forced)

and after timing_coverage, on the kosarak bitmaps:

  parity_stream_coverage  the bitmap stream filter bit for bit (one
                          sieve, knapsack, the window's 5 checkpoints,
                          4 continuous lanes) and the slot update
  stream_kcover           stream_select over all 990,002 sets, k = 64,
                          B = 256: 3,868 launches; ≥ (½ − ε) of
                          kcover_run's root; then its `stream_idle`
  stream_kcover_knapsack  costs uniform(0.5, 2), budget 40: spent ≤ 40
                          at every level
  window_kcover           window 262,144, stride 65,536: no expired id
  continuous_kcover       4 lanes, b = 2, a merge every 256 batches on
                          the resident bitmap loop; merges never drop;
                          then the same stream traced: its device time
                          and busy share
  timing_stream_coverage  the bitmap stream filter per batch (split,
                          launches, admitted, both tiers)

(`reference_dispatch` also runs small coverage trees, kernel path
against CPU path; every stream phase prints its summary's digest.) Then the card's name and power limit (nvidia-smi),
the {"kernels": …} line (twenty kernels), and as the last line
{"ok": true, "device": {…}}. The script
needs the repository's src/ beside it and a CUDA device; without either
it exits non-zero before printing any result. Imports nothing of JAX or
of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): fp32 outside the
# tensor cores — the kernels avoid TF32 — and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

REPLACES = {
    "pairwise": "src/repro/kernels/pairwise.py:53",
    "greedy_loop": "src/repro/kernels/greedy_loop.py:131",
    "greedy_loop_resident": "src/repro/kernels/greedy_loop.py:246",
    "fused_step": "src/repro/kernels/fused_step.py:88",
    "gains": "src/repro/kernels/pairwise.py:109",
    "gains[coverage]": "src/repro/kernels/pairwise.py:109 (_gains_kernel "
                       ":81, bitmap branch, grid :130-140)",
    "fused_step[coverage]": "src/repro/kernels/fused_step.py:88 "
                            "(_step_body :42, uint32 row)",
    "greedy_loop[coverage]": "src/repro/kernels/greedy_loop.py:131 "
                             "(_stream_body :54, uint32 words)",
    "greedy_loop_resident[coverage]": "src/repro/kernels/greedy_loop.py:246 "
                                      "(_resident_kernel :187, bits branch)",
    "pairwise[bf16]": "src/repro/kernels/pairwise.py:53 (_kernel :45, "
                      "out_dtype bfloat16)",
    "fused_step[bf16]": "src/repro/kernels/fused_step.py:88 (_kernel :71, "
                        "bf16 storage)",
    "fused_step[int8]": "src/repro/kernels/fused_step.py:88 "
                        "(_kernel_quant :77)",
    "greedy_loop[bf16]": "src/repro/kernels/greedy_loop.py:131 "
                         "(_stream_kernel :107, bf16 storage)",
    "greedy_loop[int8]": "src/repro/kernels/greedy_loop.py:131 "
                         "(_stream_kernel_quant :116)",
    "greedy_loop_resident[bf16]": "src/repro/kernels/greedy_loop.py:246 "
                                  "(_resident_kernel :187, bf16 rounding "
                                  ":207-208)",
    "greedy_loop_resident[int8]": "src/repro/kernels/greedy_loop.py:246 "
                                  "(_resident_kernel :187, int8 rounding "
                                  ":196-206)",
    "stream_filter": "src/repro/kernels/stream_filter.py:138 (_kernel "
                     ":118, _body :53)",
    "stream_filter[int8]": "src/repro/kernels/stream_filter.py:138 "
                           "(_kernel :118, int8 ground :120-125)",
    "stream_filter[coverage]": "src/repro/kernels/stream_filter.py:138 "
                               "(_body :53, bits rule)",
    "gains[int8]": "src/repro/kernels/pairwise.py:109 "
                   "(_gains_kernel_quant :93)",
}
SOURCES = {
    "pairwise": "src/repro_torch/csrc/pairwise.cu",
    "greedy_loop": "src/repro_torch/csrc/greedy_loop.cu",
    "greedy_loop_resident": "src/repro_torch/csrc/greedy_loop_resident.cu",
    "fused_step": "src/repro_torch/csrc/fused_step.cu",
    "gains": "src/repro_torch/csrc/gains.cu",
    "gains[coverage]": "src/repro_torch/csrc/gains.cu",
    "fused_step[coverage]": "src/repro_torch/csrc/fused_step.cu",
    "greedy_loop[coverage]": "src/repro_torch/csrc/greedy_loop.cu",
    "greedy_loop_resident[coverage]": "src/repro_torch/csrc/greedy_loop.cu",
    "pairwise[bf16]": "src/repro_torch/csrc/pairwise.cu",
    "fused_step[bf16]": "src/repro_torch/csrc/fused_step.cu",
    "fused_step[int8]": "src/repro_torch/csrc/fused_step.cu",
    "greedy_loop[bf16]": "src/repro_torch/csrc/greedy_loop.cu",
    "greedy_loop[int8]": "src/repro_torch/csrc/greedy_loop.cu",
    "greedy_loop_resident[bf16]":
        "src/repro_torch/csrc/greedy_loop_resident.cu",
    "greedy_loop_resident[int8]":
        "src/repro_torch/csrc/greedy_loop_resident.cu",
    "stream_filter": "src/repro_torch/csrc/stream_filter.cu",
    "stream_filter[int8]": "src/repro_torch/csrc/stream_filter.cu",
    "stream_filter[coverage]": "src/repro_torch/csrc/stream_filter.cu",
    "gains[int8]": "src/repro_torch/csrc/gains.cu",
}
# the knapsack run's budget (costs uniform(0.5, 2): ~80 of k = 200 fit)
BUDGET = 100.0
# the kcover knapsack run's budget (~32 of k = 64 fit)
BUDGET_KCOVER = 40.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the operations at fp32 peak
    and the compulsory bytes at HBM peak."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes
            else (t_bytes, "bytes"))


def on_chip_bytes(torch) -> float:
    """L2 plus every SM's shared memory of device 0 (H100 SXM: 50 MB +
    132 × 228 KB where torch does not report them)."""
    props = torch.cuda.get_device_properties(0)
    l2 = getattr(props, "L2_cache_size", 50 * 2 ** 20)
    smem = getattr(props, "shared_memory_per_multiprocessor", 228 * 2 ** 10)
    return float(l2 + props.multi_processor_count * smem)


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over `reps` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def smi_under_load(torch, fn, calls: int) -> str:
    """The card's SM clock and power draw (nvidia-smi) read while `calls`
    enqueued calls of fn run."""
    for _ in range(calls):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.cuda.synchronize()
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=100_000,
                   help="images (Tiny-ImageNet: 100,000)")
    p.add_argument("--seed", type=int, default=13)
    p.add_argument("--reps", type=int, default=3,
                   help="timed repetitions per kernel")
    return p.parse_args(argv)


def sample_size(pool: int, k: int, eps: float = 0.01) -> int:
    """Stochastic greedy's subset size ⌈(n/k)·ln(1/ε)⌉ (Mirzasoleiman et
    al. 2015) for a pool of n elements."""
    return math.ceil(pool / k * math.log(1.0 / eps))


def lane_pools(torch, x, lanes: int, seed: int):
    """The dispatcher runs' lanes: the elements permuted with the seed and
    cut into `lanes` contiguous pools (shard_lanes) → ids, payloads,
    valid on the card. Where `lanes` does not divide n, the permutation
    is padded at its end with invalid slots (id −1, zero payload)."""
    from repro_torch.core.greedyml import shard_lanes
    n = x.shape[0]
    n_pad = -(-n // lanes) * lanes
    perm = np.full(n_pad, -1, np.int64)
    perm[:n] = np.random.default_rng(seed).permutation(n)
    perm = torch.as_tensor(perm, device=x.device)
    pay = x[perm.clamp(min=0)]
    pay[perm < 0] = 0
    return shard_lanes(perm, pay, perm >= 0, lanes)


def knapsack_costs(n: int, seed: int) -> np.ndarray:
    """Per-image costs by global id: the recipe of the reference's
    constraint tests (uniform(0.5, 2.0) from the seed), f32."""
    return np.random.default_rng(seed).uniform(0.5, 2.0, n).astype(
        np.float32)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    for name in build.SOURCES:
        build.load(name)
    report = {}
    for name in build.SOURCES:
        lines = [ln.strip() for ln in build.ptxas_report(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        report[name] = lines
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled_in_this_run": build.BUILD_SECONDS is not None,
          "ptxas": report})


def leaf_pools(torch, x, m: int, seed: int):
    """The run's padded leaf pools, as run_tree_dense builds them."""
    from repro_torch.core.simulate import _pools, partition
    ids, valid = _pools(partition(x.shape[0], m, seed), m)
    ids_t = torch.as_tensor(ids, device=x.device)
    pay = x[ids_t.clamp(min=0)]
    pay[ids_t < 0] = 0
    return ids_t, pay, torch.as_tensor(valid, device=x.device)


def node_pools(torch, x, nodes: int, size: int, seed: int):
    """`nodes` pools of `size` distinct random images: a level's node
    shape (ground = pool = b·k)."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    idx = torch.stack([torch.randperm(x.shape[0], generator=gen,
                                      device=x.device)[:size]
                       for _ in range(nodes)])
    return x[idx].contiguous()


def _pairwise_parity(torch, P, parity, g, c, discriminate: bool):
    """The pairwise kernel in both modes against its plain version, under
    kernels/parity.py's float64 rule. With `discriminate`, also show that
    the rule rejects the plain version with TF32 products and the plain
    version with 16 features dropped."""
    out = {}
    for mode in ("dot", "dist"):
        got = P.pairwise(g, c, mode)
        plain = P.pairwise_plain(g, c, mode)
        exact = parity.exact_matrix(g, c, mode)
        stats = parity.pairwise_stats(got, plain, exact, mode)
        assert parity.pairwise_holds(stats), (
            f"pairwise {mode} {tuple(g.shape)}: {stats}")
        stats["max_abs_diff"] = float((got - plain).abs().max())
        del got
        if discriminate:
            keep = torch.ones(g.shape[-1], dtype=torch.bool, device=g.device)
            keep[g.shape[-1] // 2:g.shape[-1] // 2 + 16] = False
            bad = {"drop16": P.pairwise_plain(g[..., keep].contiguous(),
                                              c[..., keep].contiguous(),
                                              mode)}
            if g.is_cuda:               # TF32 exists only on the card
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    bad["tf32"] = P.pairwise_plain(g, c, mode)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
            for name, build in bad.items():
                bs = parity.pairwise_stats(build, plain, exact, mode)
                assert not parity.pairwise_holds(bs), (
                    f"the pairwise rule passes the {name} build: {bs}")
                stats[f"{name}_rms_ratio"] = bs["rms_ratio"]
                stats[f"{name}_max_ratio"] = bs["max_ratio"]
            del bad
        out[mode] = stats
        del plain, exact
    return out


def _fused_step_parity(torch, F, parity, R, rules, mat_of, b, n, seed):
    """fused_step against its plain version over the plain matrices of
    `b` greedies of `n` elements (mat_of(rule) builds them), a random
    feasible mask (80% of the candidates) and a random previous winner,
    for every rule; then a second step from the first step's outputs."""
    out = {}
    for name, rule in rules.items():
        mat, row = mat_of(rule)
        gen = torch.Generator(device=mat.device).manual_seed(seed)
        mask = (torch.rand(b, n, generator=gen, device=mat.device)
                > 0.2).float()
        prev = torch.randint(0, n, (b,), generator=gen, device=mat.device)
        kern = F.fused_step(mat, row, mask, prev, rule)
        plain = F.fused_step_plain(mat, row, mask, prev, rule)
        res = parity.compare_steps(kern, plain, mat, mask, rule,
                                   what=f"fused_step {name}")
        yard = parity.compare_exact(kern, F.fused_step(
            mat, row, mask, prev, rule, reference=True),
            f"fused_step {name} vs the earlier design")
        mask2 = mask.scatter(1, plain[1][:, None], 0.0)
        kern2 = F.fused_step(mat, plain[0], mask2, plain[1], rule)
        plain2 = F.fused_step_plain(mat, plain[0], mask2, plain[1], rule)
        res2 = parity.compare_steps(kern2, plain2, mat, mask2, rule,
                                    what=f"fused_step {name}, step 2")
        yard2 = parity.compare_exact(kern2, F.fused_step(
            mat, plain[0], mask2, plain[1], rule, reference=True),
            f"fused_step {name} vs the earlier design, step 2")
        res["max_gain_err"] = max(res["max_gain_err"], res2["max_gain_err"])
        res["ties"] += res2["ties"]
        res["vs_earlier_design"] = {
            "entries": yard["entries"] + yard2["entries"],
            "differing": yard["differing"] + yard2["differing"]}
        out[name] = res
        del mat, row
    return out


def _gains_parity(torch, P, parity, R, rules, ground, cands):
    """gains against its plain version under the float64 ratio rule, on a
    live state row (five pool elements folded in), every rule; for the
    path's rule also the plain version with TF32 products, which the
    rule must reject."""
    out = {}
    b, c = cands.shape[:2]
    valid = torch.ones(ground.shape[:2], dtype=torch.bool,
                       device=ground.device)
    cand_valid = torch.ones(b, c, dtype=torch.bool, device=ground.device)
    cand_valid[:, -1] = False
    for name, rule in rules.items():
        row = R.empty_row(ground, valid, rule)
        for j in range(5):
            row = R.update_row(ground, row,
                               ground[:, 97 * j % ground.shape[1]], rule)
        row = row.contiguous()
        gnorm = (P.ground_norms(ground) if rule.pairwise == "dist"
                 else None)
        got = P.gains(ground, row, cands, cand_valid, rule, gnorm=gnorm)
        plain = P.gains_plain(ground, row, cands, cand_valid, rule)
        exact = parity.exact_gains(ground, row, cands, rule)
        stats = parity.gains_stats(got, plain, exact)
        assert parity.pairwise_holds(stats), f"gains {name}: {stats}"
        fin = torch.isfinite(plain)
        stats["max_abs_diff"] = float((got[fin] - plain[fin]).abs().max())
        parity.compare_exact(got, P.gains(ground, row, cands, cand_valid,
                                          rule),
                             f"gains {name}: norms passed vs computed")
        yard = parity.compare_exact(got, P.gains(
            ground, row, cands, cand_valid, rule, reference=True),
            f"gains {name} vs the 64x64 build")
        stats["vs_64x64_build"] = {"entries": yard["entries"],
                                   "differing": yard["differing"]}
        if rule.fold == "min" and ground.is_cuda:   # TF32 only on the card
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = P.gains_plain(ground, row, cands, cand_valid, rule)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            bad = parity.gains_stats(tf32, plain, exact)
            assert not parity.pairwise_holds(bad), (
                f"the gains rule passes a TF32 build: {bad}")
            stats["tf32_rms_ratio"] = bad["rms_ratio"]
            stats["tf32_max_ratio"] = bad["max_ratio"]
        out[name] = stats
    return out


def phase_parity_steps(torch, x, cfg, pools):
    """The per-step kernels against their plain versions on the card
    (kernels/parity.py states the rules and their reasons):
      fused_step at the knapsack run's leaf shape (its 32 lanes of
                 3,125) and node shape (32 lanes of b·k = 400): the
                 folded rows equal bit for bit, the chosen gain within
                 4·√N·eps·|g|, the chosen column equal unless the plain
                 gains of both choices lie within that bound;
      gains      at the stochastic run's leaf shape (32 lanes of 3,125
                 ground rows, 72 sampled candidates each): error from a
                 float64 build ≤ 1.5× (RMS) / 2× (max) the plain f32
                 version's; a TF32 build must fail that rule."""
    from repro_torch.core.greedyml import LaneSampler
    from repro_torch.kernels import fused_step as F
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import parity
    from repro_torch.kernels import rules as R
    rules = {"kmedoid": R.DIST_MIN, "facility": R.DOT_MAX,
             "satcover": R.sat_sum(2.0), "graphcut": R.graph_cut(0.5),
             "mmr": R.mmr(0.5, 2.0)}
    seed = cfg.seed
    _, pay, valid = pools
    b, n, d = pay.shape
    lanes = b

    def leaf_mat(rule):
        return (P.pairwise_plain(pay, pay, rule.pairwise).contiguous(),
                R.empty_row(pay, valid, rule).contiguous())

    out = {"fused_step": {"leaf": _fused_step_parity(
        torch, F, parity, R, rules, leaf_mat, b, n, seed)}}
    sample = sample_size(n, cfg.k)
    idx = LaneSampler(seed)(0, lanes, 1, n, sample)[:, 0].to(x.device)
    cands = torch.gather(pay, 1, idx[..., None].expand(b, sample, d))
    out["gains"] = _gains_parity(torch, P, parity, R,
                                 {"kmedoid": R.DIST_MIN,
                                  "facility": R.DOT_MAX},
                                 pay, cands.contiguous())
    del cands
    bk = cfg.branching * cfg.k
    nodes = node_pools(torch, x, lanes, bk, seed + 2)
    nvalid = torch.ones(lanes, bk, dtype=torch.bool, device=x.device)

    def node_mat(rule):
        return (P.pairwise_plain(nodes, nodes, rule.pairwise).contiguous(),
                R.empty_row(nodes, nvalid, rule).contiguous())

    out["fused_step"]["node"] = _fused_step_parity(
        torch, F, parity, R, rules, node_mat, lanes, bk, seed)
    emit({"phase": "parity_steps", "fused_step_leaf_shape": [b, n, n],
          "fused_step_node_shape": [lanes, bk, bk],
          "gains_shape": [b, n, sample, d], **out})
    return {"fused_step": out["fused_step"]["leaf"]["kmedoid"]
            ["max_gain_err"],
            "gains": out["gains"]["kmedoid"]["max_abs_diff"]}


def phase_parity(torch, x, cfg, seed):
    """Each kernel against its plain version on the card
    (kernels/parity.py states the rules and their reasons):
      pairwise   at the first leaf's shape and at a level's node shape,
                 'dot' and 'dist' ('dist' in squared form: the square
                 root amplifies rounding near zero); the kernel's error
                 from a float64 build may be at most 1.5× (RMS) and 2×
                 (largest entry) the plain f32 version's. At the leaf
                 shape the phase also shows that this rule rejects
                 torch.matmul with TF32 and a build missing 16 features.
      loops      equal selections step for step, except at a genuine
                 tie; gains within the reordering bound 4·√N·eps·|g|,
                 rows within 4·eps·|r|. The streaming loop is fed the
                 plain matrix. The resident loop builds its own, which
                 the phase reads back: it must equal the pairwise
                 kernel's bit for bit (the pairwise kernel's 128×128
                 tile computes each entry as the resident build's
                 64×64 tile does), and its entry differences ΔM from
                 the plain matrix widen each compared gain by its
                 column's Σ_i ΔM[i, c] plus the summed row error.
      pairwise[bf16] at the node shape by the float64 rule (the leaf
                 shape's check is parity_quant's)."""
    from repro_torch.kernels import greedy_loop as L
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import parity
    from repro_torch.kernels import rules as R
    rules = {"kmedoid": R.DIST_MIN, "facility": R.DOT_MAX,
             "satcover": R.sat_sum(2.0), "graphcut": R.graph_cut(0.5),
             "mmr": R.mmr(0.5, 2.0)}
    out = {"pairwise": {}, "greedy_loop": {}, "greedy_loop_resident": {}}
    _, pay, valid = leaf_pools(torch, x, cfg.num_machines, seed)
    g = pay[:1].contiguous()                       # the first leaf
    v = valid[:1]
    del pay, valid
    n_leaf = g.shape[1]
    out["pairwise"]["leaf"] = _pairwise_parity(torch, P, parity, g, g,
                                               discriminate=True)
    for name, rule in rules.items():
        mat = P.pairwise_plain(g, g, rule.pairwise).contiguous()
        row = R.empty_row(g, v, rule).contiguous()
        mask = v.float().contiguous()
        kern = L.greedy_loop(mat, row, mask, cfg.k, rule)
        plain = L.greedy_loop_plain(mat, row, mask, cfg.k, rule)
        res = parity.compare_loops(kern, plain, rule,
                                   what=f"greedy_loop {name}")
        res["accepted"] = int((plain[1] >= 0).sum())
        out["greedy_loop"][name] = res
        del mat
    del g
    nodes = cfg.num_machines // cfg.branching
    bk = cfg.branching * cfg.k
    cd = node_pools(torch, x, nodes, bk, seed)
    out["pairwise"]["node"] = _pairwise_parity(torch, P, parity, cd, cd,
                                               discriminate=False)
    out["pairwise[bf16]"] = {"node": {
        mode: _bf16_pairwise_rule(torch, cd, mode)
        for mode in ("dot", "dist")}}
    equal_builds = 0
    for name, rule in rules.items():
        vv = torch.ones(nodes, bk, dtype=torch.bool, device=x.device)
        row = R.empty_row(cd, vv, rule).contiguous()
        mask = vv.float().contiguous()
        ctl = torch.tensor([[cfg.k, bk, bk]] * nodes, dtype=torch.int32,
                           device=x.device)
        built = torch.empty(nodes, bk, bk, device=x.device)
        kern = L.greedy_loop_resident(cd, cd, row, mask, ctl, cfg.k, rule,
                                      scratch=built)
        assert torch.equal(built, P.pairwise(cd, cd, rule.pairwise)), \
            f"resident {name}: its build is not the pairwise kernel's"
        equal_builds += 1
        plain = L.greedy_loop_resident_plain(cd, cd, row, mask, ctl, cfg.k,
                                             rule)
        diff = (built - L.resident_matrix(cd, cd, rule)).abs()
        res = parity.compare_loops(kern, plain, rule, entry_diff=diff,
                                   what=f"greedy_loop_resident {name}")
        res["max_entry_diff"] = float(diff.max())
        out["greedy_loop_resident"][name] = res
        del built, diff
    emit({"phase": "parity", "leaf_shape": [1, n_leaf, n_leaf, x.shape[1]],
          "node_shape": [nodes, bk, bk, x.shape[1]],
          "pairwise_equals_resident_build": {"rules": equal_builds,
                                             "bit_for_bit": True},
          **out})
    return {"pairwise": out["pairwise"]["leaf"]["dist"]["max_abs_diff"],
            "greedy_loop": out["greedy_loop"]["kmedoid"]["max_gain_err"],
            "greedy_loop_resident":
                out["greedy_loop_resident"]["kmedoid"]["max_gain_err"]}


def phase_reference(torch):
    """A small tree through the kernels against the same tree through
    the plain CPU path. On small-integer features the facility run is
    exact arithmetic on both paths (integer dot products, integer gain
    parts), so ids, values and counts must be EQUAL; leaves are forced
    onto the streaming tier (a 1 MB L2 share) so both loop kernels and
    the pairwise kernel run. The kmedoid run on real-valued data must
    match counts, and reports whether rounding split a tie."""
    from repro_torch.core.simulate import run_tree_dense
    from repro_torch.core.tree import AccumulationTree
    from repro_torch.data.synthetic import gen_images
    from repro_torch.kernels import counters
    from repro_torch.runtime import flags
    rng = np.random.default_rng(5)
    xi = rng.integers(-3, 4, (4096, 64)).astype(np.float32)
    old = os.environ.get(flags.RESIDENT_L2_MB_ENV)
    os.environ[flags.RESIDENT_L2_MB_ENV] = "1"
    try:
        counters.reset()
        gpu = run_tree_dense("facility", xi, 8, AccumulationTree(8, 2),
                             seed=3, device="cuda")
        launched = {n: c["launches"] for n, c in
                    counters.snapshot().items() if c["launches"]}
        cpu = run_tree_dense("facility", xi, 8, AccumulationTree(8, 2),
                             seed=3, device="cpu")
    finally:
        if old is None:
            del os.environ[flags.RESIDENT_L2_MB_ENV]
        else:
            os.environ[flags.RESIDENT_L2_MB_ENV] = old
    assert all(launched.get(n, 0) > 0 for n in
               ("pairwise", "greedy_loop", "greedy_loop_resident")), launched
    assert np.array_equal(gpu.ids, cpu.ids), (gpu.ids, cpu.ids)
    assert gpu.value == cpu.value and gpu.root_value == cpu.root_value
    assert gpu.per_node_evals == cpu.per_node_evals
    assert gpu.comm_elements == cpu.comm_elements
    xr = gen_images(2048, 64, classes=16, seed=7)
    gk = run_tree_dense("kmedoid", xr, 8, AccumulationTree(8, 2), seed=1,
                        device="cuda")
    ck = run_tree_dense("kmedoid", xr, 8, AccumulationTree(8, 2), seed=1,
                        device="cpu")
    assert gk.per_node_evals == ck.per_node_evals
    assert gk.comm_elements == ck.comm_elements
    assert np.isfinite(gk.value) and len(gk.ids) <= 8
    emit({"phase": "reference", "facility_integer": {
        "ids_equal": True, "value": gpu.value, "launches": launched},
        "kmedoid_small": {"ids_equal": bool(np.array_equal(gk.ids, ck.ids)),
                          "value_gpu": gk.value, "value_cpu": ck.value}})


def _dispatch_tree(torch, name, data, k, radices, device, universe=0, **kw):
    """A LevelDispatcher tree over contiguous lanes of `data` on
    `device` → the stacked lane state after the last level."""
    from repro_torch.core.functions import make_objective
    from repro_torch.core.greedyml import LevelDispatcher, shard_lanes
    from repro_torch.kernels.rules import to_words
    obj = make_objective(name, universe=universe, device=device)
    disp = LevelDispatcher(obj, k, radices, **kw)
    n = data.shape[0]
    pay = to_words(data) if obj.rule.is_bitmap else torch.as_tensor(data)
    ids, pay, val = shard_lanes(
        torch.arange(n, device=obj.device), pay.to(obj.device),
        torch.ones(n, dtype=torch.bool, device=obj.device), disp.lanes)
    sols = disp.leaves(ids, pay, val)
    for lvl in range(disp.num_levels):
        sols = disp.level(sols, lvl)
    return sols


def phase_reference_dispatch(torch, devices=("cuda", "cpu")):
    """LevelDispatcher trees through the kernels against the same trees
    through the plain CPU path, on small-integer facility data (integer
    dot products and gain parts: exact on both paths, so ties break
    alike): a knapsack tree whose costs are quarters (exact f32 sums) —
    fused engine, pairwise + fused_step kernels — and a stochastic tree
    whose draws come from CPU generators on both paths — step engine at
    the leaves (gains kernel), resident loop at the nodes. Ids, values
    and every lane's spent must be EQUAL. Then the same two trees on
    k-cover bitmaps (integer gains: exact everywhere), and
    run_tree_dense('kcover', …) with the leaves on the resident tier
    and, with a 10 KB L2 share, on the streaming tier — all four bitmap
    kernels against the CPU path."""
    from repro_torch.core.constraints import KnapsackSpec
    from repro_torch.core.simulate import run_tree_dense
    from repro_torch.core.tree import AccumulationTree
    from repro_torch.data.synthetic import gen_kcover, pack_bitmaps
    from repro_torch.kernels import counters
    from repro_torch.runtime import flags
    rng = np.random.default_rng(6)
    xi = rng.integers(-3, 4, (4096, 64)).astype(np.float32)
    costs = rng.integers(2, 9, 4096).astype(np.float32) / 4.0
    bits = pack_bitmaps(gen_kcover(4096, 2000, seed=8), 2000)
    out = {}
    cases = {"knapsack": ("facility", xi, dict(budget=6.0)),
             "stochastic": ("facility", xi, dict(sample_leaf=64, seed=4)),
             "kcover_knapsack": ("kcover", bits, dict(budget=6.0)),
             "kcover_stochastic": ("kcover", bits,
                                   dict(sample_leaf=64, seed=4))}
    wants = {"knapsack": ["fused_step"], "stochastic": ["gains"],
             "kcover_knapsack": ["fused_step[coverage]"],
             "kcover_stochastic": ["gains[coverage]",
                                   "greedy_loop_resident[coverage]"]}
    for case, (name, data, kw) in cases.items():
        runs = {}
        for dev in devices:
            spec = (KnapsackSpec(torch.as_tensor(costs, device=dev),
                                 kw["budget"]) if "budget" in kw else None)
            extra = {k: v for k, v in kw.items() if k != "budget"}
            counters.reset()
            sols = _dispatch_tree(torch, name, data, 8, (2, 2, 2), dev,
                                  universe=2000, constraint=spec, **extra)
            launched = {n: c["launches"] for n, c in
                        counters.snapshot().items() if c["launches"]}
            spent = (spec.spent(sols.ids, sols.valid).cpu().numpy()
                     if spec is not None else None)
            runs[dev] = (sols.map(lambda t: t.cpu()), spent, launched)
        (g, g_spent, launched), (c, c_spent, _) = (runs[d] for d in devices)
        assert torch.equal(g.ids, c.ids), (case, g.ids, c.ids)
        assert torch.equal(g.value, c.value), (case, g.value, c.value)
        assert torch.equal(g.evals, c.evals), case
        assert all(launched.get(w, 0) > 0 for w in wants[case]), (
            case, launched)
        assert launched.get("pairwise", 0) == 0 or name != "kcover"
        if g_spent is not None:
            assert np.array_equal(g_spent, c_spent), (g_spent, c_spent)
            assert (g_spent <= kw["budget"]).all(), g_spent
        out[case] = {"ids_equal": True, "root_ids": g.ids[0].tolist(),
                     "root_value": float(g.value[0]), "launches": launched,
                     "spent": None if g_spent is None else g_spent.tolist()}
    # run_tree_dense on bitmaps: resident leaves, then streaming leaves
    old = os.environ.get(flags.RESIDENT_L2_MB_ENV)
    for tier, l2 in (("resident", None), ("streaming", "0.01")):
        runs = {}
        try:
            if l2 is not None:
                os.environ[flags.RESIDENT_L2_MB_ENV] = l2
            for dev in devices:
                counters.reset()
                res = run_tree_dense("kcover", bits, 8, AccumulationTree(8, 2),
                                     seed=3, universe=2000, device=dev)
                runs[dev] = (res, {n: c["launches"] for n, c in
                                   counters.snapshot().items()
                                   if c["launches"]})
        finally:
            if old is None:
                os.environ.pop(flags.RESIDENT_L2_MB_ENV, None)
            else:
                os.environ[flags.RESIDENT_L2_MB_ENV] = old
        (g, launched), (c, _) = (runs[d] for d in devices)
        want = ["greedy_loop_resident[coverage]"] + (
            ["greedy_loop[coverage]"] if tier == "streaming" else [])
        assert all(launched.get(w, 0) > 0 for w in want), (tier, launched)
        assert "pairwise" not in launched, launched
        assert np.array_equal(g.ids, c.ids), (tier, g.ids, c.ids)
        assert g.value == c.value and g.root_value == c.root_value
        assert g.per_node_evals == c.per_node_evals
        out[f"kcover_tree_{tier}"] = {"ids_equal": True, "value": g.value,
                                      "launches": launched}
    emit({"phase": "reference_dispatch", **out})


def _level_hook(torch, levels):
    """on_level callback for run_tree_dense: per-level wall time and
    launches (counters reset after each level)."""
    from repro_torch.kernels import counters
    torch.cuda.synchronize()
    t_last = [time.perf_counter()]

    def on_level(lvl):
        torch.cuda.synchronize()
        now = time.perf_counter()
        levels.append({"level": lvl, "seconds": now - t_last[0],
                       "launches": {n: c["launches"] for n, c in
                                    counters.snapshot().items()
                                    if c["launches"]}})
        counters.reset()
        t_last[0] = time.perf_counter()
    return on_level


def phase_run(torch, x, cfg):
    from repro_torch.core.simulate import (global_value, partition,
                                           run_tree_dense)
    from repro_torch.core.tree import AccumulationTree
    from repro_torch.kernels import counters
    from repro_torch.kernels.plans import select_engine
    from repro_torch.kernels.rules import DIST_MIN
    tree = AccumulationTree(cfg.num_machines, cfg.branching)
    levels = []
    counters.reset()
    on_level = _level_hook(torch, levels)
    t0 = time.perf_counter()
    res = run_tree_dense("kmedoid", x, cfg.k, tree, seed=cfg.seed,
                         device=x.device, on_level=on_level)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = {}
    for lv in levels:
        for name, c in lv["launches"].items():
            totals[name] = totals.get(name, 0) + c
    # launches per level follow the tier the planner picks there: 2 for
    # a streaming stage (pairwise + loop), 1 for a resident one, plus one
    # replay pairwise per accumulation level (at full size: leaves
    # streaming, every node level resident)
    n_leaf = int(np.bincount(partition(x.shape[0], cfg.num_machines,
                                       cfg.seed)).max())
    for lv in levels:
        lvl = lv["level"]
        n_stage = n_leaf if lvl == 0 else cfg.branching * cfg.k
        reps_ = (cfg.num_machines if lvl == 0
                 else len(tree.nodes_at_level(lvl)))
        engine = select_engine(DIST_MIN, n_stage, n_stage, x.shape[1],
                               replicas=reps_).engine
        lv["engine"] = engine
        want = {"pairwise": int(lvl > 0), "greedy_loop": 0,
                "greedy_loop_resident": 0}
        if engine == "mega_stream":
            want["pairwise"] += 1
            want["greedy_loop"] = 1
        else:
            assert engine == "mega_resident", engine
            want["greedy_loop_resident"] = 1
        want = {n: v for n, v in want.items() if v}
        assert lv["launches"] == want, (lvl, lv["launches"], want)
    assert len(levels) == tree.num_levels + 1
    ids = np.asarray(res.ids)
    assert 0 < len(ids) <= cfg.k and len(set(ids.tolist())) == len(ids)
    assert ids.min() >= 0 and ids.max() < x.shape[0]
    assert np.isfinite(res.value) and np.isfinite(res.root_value)
    # the root ids re-scored on all n images, apart from the run
    t1 = time.perf_counter()
    rescored = global_value("kmedoid", x, ids)
    torch.cuda.synchronize()
    rescore_s = time.perf_counter() - t1
    assert rescored == res.value, (rescored, res.value)
    emit({"phase": "run", "n": x.shape[0], "d": x.shape[1], "k": cfg.k,
          "m": cfg.num_machines, "b": cfg.branching,
          "levels": levels, "wall_seconds": wall,
          "root_value": res.root_value, "global_value": res.value,
          "global_value_recomputed": rescored,
          "global_value_seconds": rescore_s,
          "root_ids": len(ids), "evals_total": res.evals_total,
          "evals_critical": res.evals_critical,
          "comm_elements": res.comm_elements})
    return totals, (ids, res.value, res.root_value)


def _run_dispatcher(torch, x, cfg, pools, expect, objective="kmedoid",
                    **kw):
    """One LevelDispatcher tree over the run's lanes, stage by stage:
    per-stage wall time (host clock around synchronized work), the
    engine the planner picks there and the launches per kernel, each
    held to `expect(stage, engine)`, and the caching allocator's
    device allocations, frees and retries. Returns (stage reports,
    launch totals, the final lane state)."""
    from repro_torch.core.functions import make_objective
    from repro_torch.core.greedyml import LevelDispatcher
    from repro_torch.kernels import counters
    from repro_torch.kernels.plans import select_engine
    obj = make_objective(objective, universe=cfg.universe, device=x.device)
    radices = (cfg.branching,) * round(math.log(cfg.num_machines,
                                                cfg.branching))
    disp = LevelDispatcher(obj, cfg.k, radices, **kw)
    ids, pay, valid = pools
    stages, totals = [], {}
    sols = None
    def allocator():
        # cudaMalloc/cudaFree calls (each a host sync) and retries after
        # freeing the cache: what the caching allocator made a stage wait
        st = torch.cuda.memory_stats()
        return [st.get(k, 0) for k in ("num_device_alloc", "num_device_free",
                                       "num_alloc_retries")]

    for stage in range(disp.num_levels + 1):
        torch.cuda.synchronize()
        counters.reset()
        mem0 = allocator()
        t0 = time.perf_counter()
        if stage == 0:
            sols = disp.leaves(ids, pay, valid)
            n, sample = pay.shape[1], disp.sample_leaf
        else:
            sols = disp.level(sols, stage - 1)
            n, sample = cfg.branching * cfg.k, disp.sample_level
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: c["launches"] for k, c in
                    counters.snapshot().items() if c["launches"]}
        dims = ((obj.words, n, None) if obj.rule.is_bitmap
                else (n, n, x.shape[1]))
        engine = select_engine(obj.rule, *dims,
                               sampling=0 < sample < n,
                               constrained=kw.get("constraint") is not None,
                               replicas=disp.lanes).engine
        assert launches == expect(stage, engine), (stage, engine, launches)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        stages.append({"stage": stage, "engine": engine, "seconds": secs,
                       "launches": launches,
                       "device_allocs_frees_retries": [
                           b - a for a, b in zip(mem0, allocator())]})
    return stages, totals, sols


def _report_root(torch, x, sols, k, objective="kmedoid", data=None,
                 universe=0):
    """Root ids checked and re-scored on all n elements (`data`: what
    global_value scores, default x)."""
    from repro_torch.core.simulate import global_value
    root = sols.map(lambda t: t[0])
    ids = root.ids[root.valid].cpu().numpy()
    assert 0 < len(ids) <= k and len(set(ids.tolist())) == len(ids)
    assert ids.min() >= 0 and ids.max() < x.shape[0]
    assert np.isfinite(float(root.value))
    t0 = time.perf_counter()
    gv = global_value(objective, x if data is None else data, ids,
                      universe=universe)
    torch.cuda.synchronize()
    return ids, {"accepted": len(ids), "root_value": float(root.value),
                 "global_value": gv,
                 "global_value_seconds": time.perf_counter() - t0,
                 "evals_root": int(root.evals)}


def phase_knapsack(torch, x, cfg, pools):
    """The constrained path: LevelDispatcher with a KnapsackSpec over the
    32 lanes. The constraint demotes every stage to the fused engine:
    one pairwise launch (the cache) + k fused_step launches per stage,
    plus the replay pairwise at each level."""
    from repro_torch.core.constraints import KnapsackSpec
    spec = KnapsackSpec(torch.as_tensor(knapsack_costs(x.shape[0], cfg.seed),
                                        device=x.device), BUDGET)

    def expect(stage, engine):
        assert engine == "fused", (stage, engine)
        return {"pairwise": 1 + (stage > 0), "fused_step": cfg.k}

    t0 = time.perf_counter()
    stages, totals, sols = _run_dispatcher(torch, x, cfg, pools, expect,
                                           constraint=spec)
    wall = time.perf_counter() - t0
    spent = spec.spent(sols.ids, sols.valid).cpu().numpy()
    assert (spent <= BUDGET).all(), spent
    ids, root = _report_root(torch, x, sols, cfg.k)
    assert len(ids) < cfg.k, "the budget did not bind"
    assert totals["fused_step"] == (len(stages)) * cfg.k
    emit({"phase": "knapsack", "lanes": int(sols.ids.shape[0]),
          "pool": int(pools[1].shape[1]), "k": cfg.k, "budget": BUDGET,
          "stages": stages, "wall_seconds": wall, **root,
          "spent_root": float(spent[0]), "spent_lanes": spent.tolist()})
    return totals


def phase_stochastic(torch, x, cfg, pools):
    """The stochastic path: sample_leaf = ⌈(n_l/k)·ln 100⌉ at the leaves
    (the per-step engine: one gains launch per step), nodes unsampled on
    the resident loop (+ the replay pairwise)."""
    sample = sample_size(pools[1].shape[1], cfg.k)

    def expect(stage, engine):
        if stage == 0:
            assert engine == "step", engine
            return {"gains": cfg.k, "gains_norms": 1}
        assert engine == "mega_resident", (stage, engine)
        return {"greedy_loop_resident": 1, "pairwise": 1}

    t0 = time.perf_counter()
    stages, totals, sols = _run_dispatcher(torch, x, cfg, pools, expect,
                                           sample_leaf=sample, seed=cfg.seed)
    wall = time.perf_counter() - t0
    _, root = _report_root(torch, x, sols, cfg.k)
    emit({"phase": "stochastic", "lanes": int(sols.ids.shape[0]),
          "pool": int(pools[1].shape[1]), "k": cfg.k,
          "sample_leaf": sample, "stages": stages, "wall_seconds": wall,
          **root})
    return totals


def phase_timing(torch, x, cfg, seed, reps):
    from repro_torch.kernels import greedy_loop as L
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import rules as R
    rule = R.DIST_MIN
    out = {}
    _, pay, valid = leaf_pools(torch, x, cfg.num_machines, seed)
    b, n, d = pay.shape
    flops = 2.0 * b * n * n * d + 4.0 * b * n * d + 4.0 * b * n * n
    nbytes = 4.0 * b * (2 * n * d + n * n)
    bms, by = bound(flops, nbytes)
    out["pairwise"] = {
        "shape": [b, n, n, d],
        "ms": cuda_ms(torch, lambda: P.pairwise(pay, pay, "dist"), reps),
        "plain_ms": cuda_ms(torch, lambda: P.pairwise_plain(pay, pay, "dist"),
                            reps),
        "library_ms": cuda_ms(torch, lambda: torch.cdist(
            pay, pay, compute_mode="use_mm_for_euclid_dist"), reps),
        "bound_ms": bms, "bound_by": by,
        # whether the fp32 pipes run at the clock of the 67 TFLOP/s peak
        "clock_and_power_under_load": smi_under_load(
            torch, lambda: P.pairwise(pay, pay, "dist"), 5)}
    # the 'dot' mode of the similarity rules at the same shape, beside
    # one batched torch.matmul (reported, not in the kernels line: the
    # main path's mode is 'dist')
    out["pairwise_dot"] = {
        "shape": [b, n, n, d],
        "ms": cuda_ms(torch, lambda: P.pairwise(pay, pay, "dot"), reps),
        "library_ms": cuda_ms(torch, lambda: torch.matmul(
            pay, pay.transpose(1, 2)), reps),
        "bound_ms": bound(2.0 * b * n * n * d, nbytes)[0]}
    mat = P.pairwise(pay, pay, "dist")
    row = R.empty_row(pay, valid, rule).contiguous()
    mask = valid.float().contiguous()
    del pay
    k = cfg.k
    flops = 3.0 * k * b * n * n
    # every step re-reads the caches; only what the chip holds (L2 plus
    # every SM's shared memory) could be kept from one step to the next
    cache = 4.0 * b * n * n
    nbytes = (k * cache - (k - 1) * min(cache, on_chip_bytes(torch))
              + 4.0 * 3 * b * n + 8.0 * b * k)
    bms, by = bound(flops, nbytes)
    out["greedy_loop"] = {
        "shape": [b, n, n, k],
        "ms": cuda_ms(torch, lambda: L.greedy_loop(mat, row, mask, k, rule),
                      reps),
        "plain_ms": cuda_ms(torch, lambda: L.greedy_loop_plain(
            mat, row, mask, k, rule), 1, warmup=0),
        "library_ms": None, "bound_ms": bms, "bound_by": by}
    del mat, row, mask
    nodes = cfg.num_machines // cfg.branching
    bk = cfg.branching * cfg.k
    cd = node_pools(torch, x, nodes, bk, seed + 1)
    vv = torch.ones(nodes, bk, dtype=torch.bool, device=x.device)
    row = R.empty_row(cd, vv, rule).contiguous()
    mask = vv.float().contiguous()
    ctl = torch.tensor([[k, bk, bk]] * nodes, dtype=torch.int32,
                       device=x.device)
    flops = (2.0 * nodes * bk * bk * d + 4.0 * nodes * bk * d
             + 3.0 * k * nodes * bk * bk)
    nbytes = 4.0 * nodes * (2 * bk * d + 3 * bk) + 12.0 * nodes * k
    bms, by = bound(flops, nbytes)
    out["greedy_loop_resident"] = {
        "shape": [nodes, bk, bk, d, k],
        "ms": cuda_ms(torch, lambda: L.greedy_loop_resident(
            cd, cd, row, mask, ctl, k, rule), reps),
        "plain_ms": cuda_ms(torch, lambda: L.greedy_loop_resident_plain(
            cd, cd, row, mask, ctl, k, rule), reps),
        "library_ms": None, "bound_ms": bms, "bound_by": by}
    emit({"phase": "timing", "peaks": {"fp32_flops": PEAK_FP32_FLOPS,
                                       "hbm_bytes": PEAK_HBM_BYTES},
          **out})
    return out


def _vs_global(torch, step, reps) -> dict:
    """fused_step at one shape beside its global tier, the earlier design
    (the parent's kernel): the global tier's CUDA-event ms a call, and
    each design's device ms a launch by torch.profiler (at the node
    shapes the host sets the event time, so only device time compares
    the kernels)."""
    def device_ms(fn):
        split = _kernel_split(torch, fn, 20)["kernel_split"]
        if not isinstance(split, dict):
            return split
        return {k: v["ms_per_launch"] for k, v in split.items()
                if "fused_step" in k}
    return {"global_ms": cuda_ms(torch, lambda: step(reference=True),
                                 20 * reps),
            "device_ms": device_ms(step),
            "global_device_ms": device_ms(lambda: step(reference=True))}


def phase_timing_steps(torch, x, cfg, pools, reps):
    """The per-step kernels at their paths' shapes: fused_step over the
    knapsack leaves' caches (32 × 3,125²), gains over the stochastic
    leaves (32 × 3,125 ground rows × 72 candidates × 12,288), each beside
    its bound, its plain version and — for gains — torch.cdist over the
    same pairs. No single PyTorch call folds a column, sums masked gain
    parts and takes an argmax, so fused_step has no library time."""
    from repro_torch.core.greedyml import LaneSampler
    from repro_torch.kernels import fused_step as F
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import rules as R
    rule = R.DIST_MIN
    _, pay, valid = pools
    b, n, d = pay.shape
    out = {}
    mat = P.pairwise(pay, pay, rule.pairwise)
    row = R.empty_row(pay, valid, rule).contiguous()
    mask = valid.float().contiguous()
    prev = torch.zeros(b, dtype=torch.int64, device=x.device)
    flops = 3.0 * b * n * n
    nbytes = 4.0 * b * n * n + 4.0 * 2 * b * n + 4.0 * b * n + 16.0 * b
    bms, by = bound(flops, nbytes)
    out["fused_step"] = {
        "shape": [b, n, n],
        "ms": cuda_ms(torch, lambda: F.fused_step(mat, row, mask, prev, rule),
                      20 * reps),
        **_vs_global(torch, lambda **kw: F.fused_step(
            mat, row, mask, prev, rule, **kw), reps),
        "plain_ms": cuda_ms(torch, lambda: F.fused_step_plain(
            mat, row, mask, prev, rule), reps),
        "library_ms": None, "bound_ms": bms, "bound_by": by}
    del mat
    # the knapsack node shape (reported, not in the kernels line): a
    # step's caches sit in L2, so launch and host costs dominate
    bk = cfg.branching * cfg.k
    nodes = node_pools(torch, x, b, bk, cfg.seed + 3)
    nmat = P.pairwise(nodes, nodes, rule.pairwise)
    nrow = R.empty_row(nodes, torch.ones(b, bk, dtype=torch.bool,
                                         device=x.device), rule).contiguous()
    nmask = torch.ones(b, bk, device=x.device)
    out["fused_step_node"] = {
        "shape": [b, bk, bk],
        "ms": cuda_ms(torch, lambda: F.fused_step(nmat, nrow, nmask, prev,
                                                  rule), 20 * reps),
        **_vs_global(torch, lambda **kw: F.fused_step(
            nmat, nrow, nmask, prev, rule, **kw), reps),
        "plain_ms": cuda_ms(torch, lambda: F.fused_step_plain(
            nmat, nrow, nmask, prev, rule), 20 * reps),
        "bound_ms": bound(3.0 * b * bk * bk,
                          4.0 * b * (bk * bk + 3 * bk) + 16.0 * b)[0]}
    del nodes, nmat
    c = sample_size(n, cfg.k)
    idx = LaneSampler(cfg.seed)(0, b, 1, n, c)[:, 0].to(x.device)
    cands = torch.gather(pay, 1, idx[..., None].expand(b, c, d)).contiguous()
    cv = torch.ones(b, c, dtype=torch.bool, device=x.device)
    # a step's work: the products, the candidates' norms and the gain
    # parts; the ground's norms are the greedy's, taken once (norms_ms)
    gnorm = P.ground_norms(pay)
    flops = 2.0 * b * n * c * d + 2.0 * b * c * d + 4.0 * b * n * c
    nbytes = 4.0 * (b * n * d + b * c * d + 2 * b * n + b * c)
    bms, by = bound(flops, nbytes)
    out["gains"] = {
        "shape": [b, n, c, d],
        "ms": cuda_ms(torch, lambda: P.gains(pay, row, cands, cv, rule,
                                             gnorm=gnorm), reps),
        "norms_ms": cuda_ms(torch, lambda: P.ground_norms(pay), reps),
        "plain_ms": cuda_ms(torch, lambda: P.gains_plain(pay, row, cands, cv,
                                                         rule), reps),
        "library_ms": cuda_ms(torch, lambda: torch.cdist(
            pay, cands, compute_mode="use_mm_for_euclid_dist"), reps),
        "bound_ms": bms, "bound_by": by}
    # the step engine's other per-step cost (reported): the winner's
    # direct-difference column folded into the rows, in plain torch
    out["update_row"] = {
        "shape": [b, n, d],
        "ms": cuda_ms(torch, lambda: R.update_row(pay, row, cands[:, 0],
                                                  rule), reps),
        "bound_ms": bound(3.0 * b * n * d, 4.0 * (b * n * d + 2 * b * n))[0]}
    emit({"phase": "timing_steps", **out})
    return out


def phase_timing_fused_global(torch, cfg, reps):
    """fused_step's global tier where the planner sends a step to it: the
    sequential Greedy over all n images (simulate.run_greedy_dense), one
    greedy whose f32 (n, n) cache (40,000 MB at n = 100,000) fits the
    budget but whose span partials fit no cluster's shared memory. The
    cache is random (the time does not depend on its values); the step
    is held to finite gains and a winner in range. Reported, not in the
    kernels line."""
    from repro_torch.kernels import fused_step as F
    from repro_torch.kernels import plans
    from repro_torch.kernels import rules as R
    n = cfg.n
    plan = plans.select_engine(R.DIST_MIN, n, n, cfg.feature_dim)
    assert plan.engine == "fused", plan
    assert not plans.fused_cluster_fits(plan.dtype, n, plan.block_n)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    mat = torch.rand((1, n, n), generator=gen, device=dev)
    row = torch.full((1, n), 2.0, device=dev)
    mask = torch.ones(1, n, device=dev)
    prev = torch.zeros(1, dtype=torch.int64, device=dev)
    rule = R.DIST_MIN
    _, best, gain = F.fused_step(mat, row, mask, prev, rule,
                                 block_n=plan.block_n)
    assert 0 <= int(best[0]) < n and bool(torch.isfinite(gain).all())
    ms = cuda_ms(torch, lambda: F.fused_step(mat, row, mask, prev, rule,
                                             block_n=plan.block_n), reps)
    bms, by = bound(3.0 * n * n, 4.0 * n * n + 4.0 * 4 * n + 16.0)
    # the step engine's work a step at the same size: the products alone
    step_bms = bound(2.0 * n * n * cfg.feature_dim, 4.0 * n * cfg.feature_dim)
    emit({"phase": "timing_fused_global", "shape": [1, n, n],
          "dtype": plan.dtype, "block_n": plan.block_n, "ms": ms,
          "bound_ms": bms, "bound_by": by,
          "step_engine_bound_ms": step_bms[0]})
    del mat
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the memory-capped cache tiers: bf16 and int8 cached matrices
# ---------------------------------------------------------------------------

QUANT = ("bfloat16", "int8")
TAG = {"float32": "", "bfloat16": "[bf16]", "int8": "[int8]"}
RUNG = {"bfloat16": "bf16", "int8": "int8"}
# REPRO_TORCH_FUSED_CACHE_MB under which the planner takes each rung for
# the Tiny-ImageNet leaves (32 × 3,284²: f32 1.38 GB, bf16 0.69 GB,
# int8 0.345 GB)
BUDGET_MB = {"bfloat16": 1024, "int8": 512}


@contextlib.contextmanager
def _env(**kv):
    """The environment variables `kv` set for the duration."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _rung_env(dtype: str) -> dict:
    return {"REPRO_TORCH_FUSED_CACHE_DTYPE": RUNG[dtype]}


def _quant_caches(torch, pay, rule):
    """The f32 kernel's (B, N, N) cache of `pay` and the bf16 and int8
    caches ops.pairwise_matrix builds on the card, each held bit for bit
    (kernels/parity.py): pairwise[bf16] against the f32 output rounded to
    bf16, the chunked int8 cache against quantize_rows of the whole f32
    output on the CPU. Returns (f32, {dtype: (matrix, scale)}, checks)."""
    from repro_torch.kernels import ops, parity
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import rules as R
    m32 = P.pairwise(pay, pay, rule.pairwise)
    bf = ops.pairwise_matrix(pay, pay, rule, "bfloat16")
    checks = {"pairwise[bf16]_vs_f32_rounded": parity.compare_exact(
        bf, m32.to(torch.bfloat16), "pairwise[bf16] vs the f32 kernel")}
    q = ops.pairwise_matrix(pay, pay, rule, "int8")
    checks["int8_cache_vs_cpu_quantize_rows"] = parity.compare_exact(
        (q.q.cpu(), q.scale.cpu()), R.quantize_rows(m32.cpu()),
        "the chunked int8 cache vs quantize_rows on the CPU")
    return m32, {"bfloat16": (bf, None), "int8": (q.q, q.scale)}, checks


def _bf16_pairwise_rule(torch, g, mode):
    """pairwise[bf16] against its plain version (the plain f32 build
    rounded to bf16) under the float64 ratio rule; returns the stats and
    the largest |kernel − plain|."""
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import parity
    got = P.pairwise(g, g, mode, out_dtype=torch.bfloat16).float()
    plain = P.pairwise_plain(g, g, mode).to(torch.bfloat16).float()
    stats = parity.pairwise_stats(got, plain,
                                  parity.exact_matrix(g, g, mode), mode)
    assert parity.pairwise_holds(stats), f"pairwise[bf16] {mode}: {stats}"
    stats["max_abs_diff"] = float((got - plain).abs().max())
    return stats


def phase_parity_quant(torch, x, cfg, pools):
    """The bf16/int8 variants on the card at the runs' own shapes, for
    kmedoid ('dist') and facility ('dot'), held bit for bit to what runs
    the same arithmetic and to their plain versions by the rules of
    kernels/parity.py:
      leaf level      (32 × 3,284², run_tree_dense's first level)
                      pairwise[bf16] == the f32 kernel rounded; the
                      chunked int8 cache == quantize_rows on the CPU;
                      greedy_loop[bf16|int8] == the f32 kernel over the
                      dequantized cache; vs plain: pairwise[bf16] by the
                      float64 rule (first leaf), loops by compare_loops
      node level      (16 × 400²) the resident loop under each rung: its
                      scratch == round_resident of the pairwise kernel's
                      f32 build; vs plain: compare_loops with the
                      measured entry differences
      knapsack leaf   (32 × 3,125²) and node (32 × 400²): the caches as
                      above, fused_step[bf16|int8] == the f32 kernel over
                      the dequantized cache, two steps; vs plain:
                      compare_steps
    Returns each variant's largest measured |kernel − plain|."""
    from repro_torch.kernels import fused_step as F
    from repro_torch.kernels import greedy_loop as L
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import parity
    from repro_torch.kernels import rules as R
    rules = {"kmedoid": R.DIST_MIN, "facility": R.DOT_MAX}
    errs = {}

    def err(name, value):
        errs[name] = max(errs.get(name, 0.0), float(value))

    out = {"leaf": {}, "node": {}, "knapsack_leaf": {}, "knapsack_node": {}}
    _, lpay, lvalid = leaf_pools(torch, x, cfg.num_machines, cfg.seed)
    b, n, _ = lpay.shape
    for name, rule in rules.items():
        res = {"pairwise[bf16]_plain": _bf16_pairwise_rule(
            torch, lpay[:1].contiguous(), rule.pairwise)}
        err("pairwise[bf16]", res["pairwise[bf16]_plain"]["max_abs_diff"])
        m32, caches, checks = _quant_caches(torch, lpay, rule)
        del m32
        res.update(checks)
        row = R.empty_row(lpay, lvalid, rule).contiguous()
        mask = lvalid.float().contiguous()
        for dt, (mat, scale) in caches.items():
            what = f"greedy_loop{TAG[dt]} {name}"
            got = L.greedy_loop(mat, row, mask, cfg.k, rule, scale=scale)
            f32 = L.greedy_loop(R.logical(mat, scale).contiguous(), row, mask,
                                cfg.k, rule)
            res[f"greedy_loop{TAG[dt]}_vs_f32_kernel"] = parity.compare_exact(
                got, f32, what + " vs the f32 kernel")
            del f32
            cmp = parity.compare_loops(got, L.greedy_loop_plain(
                mat, row, mask, cfg.k, rule, scale=scale), rule, what=what)
            cmp["accepted"] = int((got[1] >= 0).sum())
            res[f"greedy_loop{TAG[dt]}_plain"] = cmp
            err(f"greedy_loop{TAG[dt]}", cmp["max_gain_err"])
        out["leaf"][name] = res
        del caches
    del lpay, lvalid
    nodes = cfg.num_machines // cfg.branching
    bk = cfg.branching * cfg.k
    cd = node_pools(torch, x, nodes, bk, cfg.seed + 4)
    vv = torch.ones(nodes, bk, dtype=torch.bool, device=x.device)
    ctl = torch.tensor([[cfg.k, bk, bk]] * nodes, dtype=torch.int32,
                       device=x.device)
    for name, rule in rules.items():
        row = R.empty_row(cd, vv, rule).contiguous()
        mask = vv.float().contiguous()
        built32 = P.pairwise(cd, cd, rule.pairwise)
        res = {}
        for dt in QUANT:
            what = f"greedy_loop_resident{TAG[dt]} {name}"
            built = torch.empty(nodes, bk, bk, device=x.device)
            got = L.greedy_loop_resident(cd, cd, row, mask, ctl, cfg.k, rule,
                                         cache_dtype=dt, scratch=built)
            res[f"resident{TAG[dt]}_scratch_vs_rounding"] = \
                parity.compare_exact(built, L.round_resident(built32, dt, ctl),
                                     what + ": scratch vs round_resident")
            diff = (built - L.resident_matrix(cd, cd, rule, ctl, dt)).abs()
            cmp = parity.compare_loops(got, L.greedy_loop_resident_plain(
                cd, cd, row, mask, ctl, cfg.k, rule, cache_dtype=dt), rule,
                entry_diff=diff, what=what)
            cmp["max_entry_diff"] = float(diff.max())
            res[f"resident{TAG[dt]}_plain"] = cmp
            err(f"greedy_loop_resident{TAG[dt]}", cmp["max_gain_err"])
            del built, diff
        out["node"][name] = res
    del cd
    _, kpay, kvalid = pools
    kn = node_pools(torch, x, kpay.shape[0], bk, cfg.seed + 5)
    for where, pay, valid in (
            ("knapsack_leaf", kpay, kvalid),
            ("knapsack_node", kn, torch.ones(kn.shape[:2], dtype=torch.bool,
                                             device=x.device))):
        bb, nn = pay.shape[:2]
        for name, rule in rules.items():
            m32, caches, res = _quant_caches(torch, pay, rule)
            del m32
            row = R.empty_row(pay, valid, rule).contiguous()
            gen = torch.Generator(device=x.device).manual_seed(cfg.seed)
            mask = (torch.rand(bb, nn, generator=gen, device=x.device)
                    > 0.2).float()
            prev = torch.randint(0, nn, (bb,), generator=gen,
                                 device=x.device)
            for dt, (mat, scale) in caches.items():
                what = f"fused_step{TAG[dt]} {name} {where}"
                logical = R.logical(mat, scale).contiguous()
                r, mk, pv, cmps, sames, yards = row, mask, prev, [], [], []
                for _ in range(2):
                    got = F.fused_step(mat, r, mk, pv, rule, scale=scale)
                    sames.append(parity.compare_exact(
                        got, F.fused_step(logical, r, mk, pv, rule),
                        what + " vs the f32 kernel"))
                    yards.append(parity.compare_exact(
                        got, F.fused_step(mat, r, mk, pv, rule, scale=scale,
                                          reference=True),
                        what + " vs the earlier design"))
                    plain = F.fused_step_plain(mat, r, mk, pv, rule,
                                               scale=scale)
                    cmps.append(parity.compare_steps(got, plain, logical, mk,
                                                     rule, what=what))
                    r, pv = plain[0], plain[1]
                    mk = mk.scatter(1, pv[:, None], 0.0)
                res[f"fused_step{TAG[dt]}_vs_f32_kernel"] = {
                    "entries": sum(s["entries"] for s in sames),
                    "differing": sum(s["differing"] for s in sames)}
                res[f"fused_step{TAG[dt]}_vs_earlier_design"] = {
                    "entries": sum(s["entries"] for s in yards),
                    "differing": sum(s["differing"] for s in yards)}
                res[f"fused_step{TAG[dt]}_plain"] = {
                    "max_gain_err": max(c["max_gain_err"] for c in cmps),
                    "ties": sum(c["ties"] for c in cmps)}
                err(f"fused_step{TAG[dt]}",
                    res[f"fused_step{TAG[dt]}_plain"]["max_gain_err"])
                del logical
            out[where][name] = res
            del caches
    del kn
    emit({"phase": "parity_quant", "leaf_shape": [b, n, n],
          "node_shape": [nodes, bk, bk],
          "knapsack_leaf_shape": list(kpay.shape[:2]) + [kpay.shape[1]],
          "knapsack_node_shape": [kpay.shape[0], bk, bk], **out})
    return errs


def _variant_launches(totals) -> dict:
    """The launches of the bf16/int8 variants among a run's totals."""
    return {k: v for k, v in totals.items() if "[bf16]" in k or "[int8]" in k}


def _add(into: dict, more: dict) -> None:
    for k, v in more.items():
        into[k] = into.get(k, 0) + v


def _quant_tree(torch, x, cfg, env: dict, f32_run):
    """run_tree_dense('kmedoid', …) under `env` (a forced rung or a
    cache budget): per level the engine and storage the planner picks
    there, the launches each variant's counter shows (asserted), the wall
    time; the leaf stage's device allocation beyond the pools held to
    the planned cache bytes (≤ 1.05× plus one int8 chunk's f32: no f32
    copy of a cache anywhere); the root beside the f32 run's."""
    from repro_torch.core.simulate import partition, run_tree_dense
    from repro_torch.core.tree import AccumulationTree
    from repro_torch.kernels import counters
    from repro_torch.kernels.plans import (cache_bytes, quant_chunk,
                                           select_engine)
    from repro_torch.kernels.rules import DIST_MIN
    tree = AccumulationTree(cfg.num_machines, cfg.branching)
    m, d = cfg.num_machines, x.shape[1]
    n_leaf = int(np.bincount(partition(x.shape[0], m, cfg.seed)).max())
    levels = []
    with _env(**env):
        plans = []
        for lvl in range(tree.num_levels + 1):
            n = n_leaf if lvl == 0 else cfg.branching * cfg.k
            reps = m if lvl == 0 else len(tree.nodes_at_level(lvl))
            plans.append((n, reps, select_engine(DIST_MIN, n, n, d,
                                                 replicas=reps)))
        leaf = plans[0][2]
        planned = cache_bytes(n_leaf, n_leaf, leaf.dtype, m)
        chunk = (quant_chunk(n_leaf, n_leaf) * n_leaf * n_leaf * 4
                 if leaf.dtype == "int8" else 0)
        pool_bytes = m * n_leaf * d * 4
        counters.reset()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        hook = _level_hook(torch, levels)
        peak = []

        def on_level(lvl):
            hook(lvl)
            if lvl == 0:
                peak.append(torch.cuda.max_memory_allocated() - base)

        t0 = time.perf_counter()
        res = run_tree_dense("kmedoid", x, cfg.k, tree, seed=cfg.seed,
                             device=x.device, on_level=on_level)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    totals = {}
    for lv, (n, reps, plan) in zip(levels, plans):
        tag = TAG[plan.dtype]
        want = {"pairwise": 1} if lv["level"] > 0 else {}
        if plan.engine == "mega_stream":
            build = ("pairwise" if plan.dtype == "int8"
                     else "pairwise" + tag)
            want[build] = want.get(build, 0) + (
                -(-reps // quant_chunk(n, n)) if plan.dtype == "int8" else 1)
            want["greedy_loop" + tag] = 1
        else:
            assert plan.engine == "mega_resident", plan.engine
            want["greedy_loop_resident" + tag] = 1
        assert lv["launches"] == want, (lv["level"], lv["launches"], want)
        lv["engine"], lv["dtype"] = plan.engine, plan.dtype
        _add(totals, lv["launches"])
    extra = peak[0] - pool_bytes
    assert planned <= extra <= 1.05 * planned + chunk, (
        extra, planned, chunk)
    ids = np.asarray(res.ids)
    assert 0 < len(ids) <= cfg.k and len(set(ids.tolist())) == len(ids)
    assert np.isfinite(res.value) and np.isfinite(res.root_value)
    f32_ids, f32_value, f32_root = f32_run
    return {"env": env, "levels": levels, "wall_seconds": wall,
            "leaf_cache_bytes_planned": planned,
            "leaf_chunk_f32_bytes": chunk,
            "leaf_stage_bytes_beyond_pools": int(extra),
            "root_value": res.root_value, "global_value": res.value,
            "f32_root_value": f32_root, "f32_global_value": f32_value,
            "global_value_rel_diff": abs(res.value - f32_value)
            / abs(f32_value),
            "root_ids": len(ids),
            "root_ids_shared_with_f32": len(set(ids.tolist())
                                            & set(f32_ids.tolist()))}, totals


def phase_run_quant(torch, x, cfg, dtype: str, f32_run):
    """run_tree_dense('kmedoid', …) at the full configuration with the
    caches stored as `dtype`, the two ways a user reaches that rung: the
    rung forced (REPRO_TORCH_FUSED_CACHE_DTYPE: leaves streaming and
    nodes resident, all in `dtype`), and the memory a job has
    (REPRO_TORCH_FUSED_CACHE_MB = BUDGET_MB[dtype]: the planner picks
    `dtype` for the leaves and keeps the nodes f32). Returns the
    variants' launches."""
    from repro_torch.kernels.plans import select_engine
    from repro_torch.kernels.rules import DIST_MIN
    from repro_torch.core.simulate import partition
    n_leaf = int(np.bincount(partition(x.shape[0], cfg.num_machines,
                                       cfg.seed)).max())
    budget = {"REPRO_TORCH_FUSED_CACHE_MB": BUDGET_MB[dtype]}
    with _env(**budget):
        leaf = select_engine(DIST_MIN, n_leaf, n_leaf, x.shape[1],
                             replicas=cfg.num_machines)
    assert (leaf.engine, leaf.dtype) == ("mega_stream", dtype), leaf
    forced, totals = _quant_tree(torch, x, cfg, _rung_env(dtype), f32_run)
    assert all(v["dtype"] == dtype for v in forced["levels"])
    by_budget, more = _quant_tree(torch, x, cfg, budget, f32_run)
    assert [v["dtype"] for v in by_budget["levels"]] == (
        [dtype] + ["float32"] * (len(by_budget["levels"]) - 1))
    _add(totals, more)
    emit({"phase": f"run_{RUNG[dtype]}", "n": x.shape[0], "d": x.shape[1],
          "k": cfg.k, "m": cfg.num_machines, "b": cfg.branching,
          "forced": forced, "budget": by_budget})
    return _variant_launches(totals)


def phase_knapsack_quant(torch, x, cfg, pools, dtype: str):
    """The knapsack lanes (budget 100) with the rung forced: every stage
    fused over a `dtype` cache — its build (one pairwise[bf16] launch, or
    the int8 chunks' f32 pairwise launches) + k fused_step[`dtype`]
    launches, plus the replay pairwise at each level — spent ≤ budget at
    the root and every lane, the constraint binding."""
    from repro_torch.core.constraints import KnapsackSpec
    from repro_torch.kernels.plans import quant_chunk
    spec = KnapsackSpec(torch.as_tensor(knapsack_costs(x.shape[0], cfg.seed),
                                        device=x.device), BUDGET)
    tag = TAG[dtype]
    lanes, n_leaf = pools[1].shape[:2]

    def expect(stage, engine):
        assert engine == "fused", (stage, engine)
        n = n_leaf if stage == 0 else cfg.branching * cfg.k
        want = {"fused_step" + tag: cfg.k}
        if dtype == "int8":
            want["pairwise"] = -(-lanes // quant_chunk(n, n)) + (stage > 0)
        else:
            want["pairwise" + tag] = 1
            if stage > 0:
                want["pairwise"] = 1
        return want

    t0 = time.perf_counter()
    with _env(**_rung_env(dtype)):
        stages, totals, sols = _run_dispatcher(torch, x, cfg, pools, expect,
                                               constraint=spec)
    wall = time.perf_counter() - t0
    spent = spec.spent(sols.ids, sols.valid).cpu().numpy()
    assert (spent <= BUDGET).all(), spent
    ids, root = _report_root(torch, x, sols, cfg.k)
    assert len(ids) < cfg.k, "the budget did not bind"
    assert totals["fused_step" + tag] == len(stages) * cfg.k
    emit({"phase": f"knapsack_{RUNG[dtype]}", "lanes": int(lanes),
          "pool": int(n_leaf), "k": cfg.k, "budget": BUDGET,
          "stages": stages, "wall_seconds": wall, **root,
          "spent_root": float(spent[0]), "spent_lanes": spent.tolist()})
    return _variant_launches(totals)


def phase_timing_quant(torch, x, cfg, pools, reps):
    """Each bf16/int8 variant at its path's shape beside its plain
    version and its bound, the storage's own bytes: pairwise[bf16] and
    the streaming loops at the leaf level (32 × 3,284²; the loop re-reads
    its caches every step less what L2 and shared memory hold),
    fused_step at the knapsack leaf (32 × 3,125²) and node (32 × 400²),
    the resident loops at a level-1 node batch (16 × 400²).
    pairwise[bf16] beside
    torch.cdist(…).to(torch.bfloat16); no single PyTorch call computes
    the others."""
    from repro_torch.kernels import fused_step as F
    from repro_torch.kernels import greedy_loop as L
    from repro_torch.kernels import ops
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import rules as R
    rule = R.DIST_MIN
    k = cfg.k
    out = {}
    _, pay, valid = leaf_pools(torch, x, cfg.num_machines, cfg.seed)
    b, n, d = pay.shape
    bf16 = torch.bfloat16
    bms, by = bound(2.0 * b * n * n * d + 4.0 * b * n * d + 4.0 * b * n * n,
                    4.0 * b * 2 * n * d + 2.0 * b * n * n)
    out["pairwise[bf16]"] = {
        "shape": [b, n, n, d],
        "ms": cuda_ms(torch, lambda: P.pairwise(pay, pay, "dist",
                                                out_dtype=bf16), reps),
        "plain_ms": cuda_ms(torch, lambda: P.pairwise_plain(
            pay, pay, "dist").to(bf16), reps),
        "library_ms": cuda_ms(torch, lambda: torch.cdist(
            pay, pay, compute_mode="use_mm_for_euclid_dist").to(bf16), reps),
        "bound_ms": bms, "bound_by": by}
    row = R.empty_row(pay, valid, rule).contiguous()
    mask = valid.float().contiguous()
    for dt in QUANT:
        mat = ops.pairwise_matrix(pay, pay, rule, dt)
        mat, scale = (mat.q, mat.scale) if dt == "int8" else (mat, None)
        # an int8 entry costs one more operation: its rescale
        ops_entry = 4.0 if dt == "int8" else 3.0
        cache = (mat.element_size() * b * n * n
                 + (4.0 * b * n if dt == "int8" else 0.0))
        nbytes = (k * cache - (k - 1) * min(cache, on_chip_bytes(torch))
                  + 4.0 * 3 * b * n + 8.0 * b * k)
        bms, by = bound(ops_entry * k * b * n * n, nbytes)
        out[f"greedy_loop{TAG[dt]}"] = {
            "shape": [b, n, n, k], "cache_bytes": cache,
            "ms": cuda_ms(torch, lambda: L.greedy_loop(
                mat, row, mask, k, rule, scale=scale), reps),
            "plain_ms": cuda_ms(torch, lambda: L.greedy_loop_plain(
                mat, row, mask, k, rule, scale=scale), 1, warmup=0),
            "library_ms": None, "bound_ms": bms, "bound_by": by}
        del mat, scale
    del pay, valid, row, mask
    _, kpay, kvalid = pools
    b, n, _ = kpay.shape
    row = R.empty_row(kpay, kvalid, rule).contiguous()
    mask = kvalid.float().contiguous()
    prev = torch.zeros(b, dtype=torch.int64, device=x.device)
    for dt in QUANT:
        mat = ops.pairwise_matrix(kpay, kpay, rule, dt)
        mat, scale = (mat.q, mat.scale) if dt == "int8" else (mat, None)
        ops_entry = 4.0 if dt == "int8" else 3.0
        nbytes = (mat.element_size() * b * n * n
                  + (4.0 * b * n if dt == "int8" else 0.0)
                  + 4.0 * 2 * b * n + 4.0 * b * n + 16.0 * b)
        bms, by = bound(ops_entry * b * n * n, nbytes)
        out[f"fused_step{TAG[dt]}"] = {
            "shape": [b, n, n],
            "ms": cuda_ms(torch, lambda: F.fused_step(
                mat, row, mask, prev, rule, scale=scale), 20 * reps),
            **_vs_global(torch, lambda **kw: F.fused_step(
                mat, row, mask, prev, rule, scale=scale, **kw), reps),
            "plain_ms": cuda_ms(torch, lambda: F.fused_step_plain(
                mat, row, mask, prev, rule, scale=scale), reps),
            "library_ms": None, "bound_ms": bms, "bound_by": by}
        del mat, scale
    # the knapsack node shape (timing_steps' nodes): caches in L2
    bk = cfg.branching * k
    kn = node_pools(torch, x, b, bk, cfg.seed + 3)
    nrow = R.empty_row(kn, torch.ones(b, bk, dtype=torch.bool,
                                      device=x.device), rule).contiguous()
    nmask = torch.ones(b, bk, device=x.device)
    for dt in QUANT:
        mat = ops.pairwise_matrix(kn, kn, rule, dt)
        mat, scale = (mat.q, mat.scale) if dt == "int8" else (mat, None)
        ops_entry = 4.0 if dt == "int8" else 3.0
        nbytes = (mat.element_size() * b * bk * bk
                  + (4.0 * b * bk if dt == "int8" else 0.0)
                  + 4.0 * 3 * b * bk + 16.0 * b)
        out[f"fused_step{TAG[dt]}_node"] = {
            "shape": [b, bk, bk],
            "ms": cuda_ms(torch, lambda: F.fused_step(
                mat, nrow, nmask, prev, rule, scale=scale), 20 * reps),
            **_vs_global(torch, lambda **kw: F.fused_step(
                mat, nrow, nmask, prev, rule, scale=scale, **kw), reps),
            "plain_ms": cuda_ms(torch, lambda: F.fused_step_plain(
                mat, nrow, nmask, prev, rule, scale=scale), 20 * reps),
            "bound_ms": bound(ops_entry * b * bk * bk, nbytes)[0]}
        del mat, scale
    del kn
    nodes = cfg.num_machines // cfg.branching
    d = x.shape[1]
    cd = node_pools(torch, x, nodes, bk, cfg.seed + 1)
    vv = torch.ones(nodes, bk, dtype=torch.bool, device=x.device)
    nrow = R.empty_row(cd, vv, rule).contiguous()
    nmask = vv.float().contiguous()
    ctl = torch.tensor([[k, bk, bk]] * nodes, dtype=torch.int32,
                       device=x.device)
    nbytes = 4.0 * nodes * (2 * bk * d + 3 * bk) + 12.0 * nodes * k
    for dt in QUANT:
        # the rounding: bf16 one operation an entry; int8 the absmax, the
        # division, the rounding and the rescale
        rnd = 1.0 if dt == "bfloat16" else 4.0
        flops = (2.0 * nodes * bk * bk * d + 4.0 * nodes * bk * d
                 + rnd * nodes * bk * bk + 3.0 * k * nodes * bk * bk)
        bms, by = bound(flops, nbytes)
        out[f"greedy_loop_resident{TAG[dt]}"] = {
            "shape": [nodes, bk, bk, d, k],
            "ms": cuda_ms(torch, lambda: L.greedy_loop_resident(
                cd, cd, nrow, nmask, ctl, k, rule, cache_dtype=dt), reps),
            "plain_ms": cuda_ms(torch, lambda: L.greedy_loop_resident_plain(
                cd, cd, nrow, nmask, ctl, k, rule, cache_dtype=dt), reps),
            "library_ms": None, "bound_ms": bms, "bound_by": by}
    emit({"phase": "timing_quant", **out})
    return out


# ---------------------------------------------------------------------------
# the coverage problems (the bitmap rule)
# ---------------------------------------------------------------------------


def random_words(torch, shape, seed: int, device):
    """Sparse random 32-bit words (each bit set with probability 1/8),
    every 5th word with bit 31 set, as the port's int32 words."""
    from repro_torch.kernels.rules import to_words
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
    for _ in range(2):
        a &= rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
    a.reshape(-1)[::5] |= np.uint32(2 ** 31)
    return to_words(a).to(device)


def phase_data_kcover(torch, cfg, avg_size: float, dev):
    """The KOSARAK bitmaps: gen_kcover + pack_bitmaps on the host (the
    reference's recipe, from the seed), then the words placed on the
    card once as int32 (rules.to_words reinterprets, no host copy)."""
    from repro_torch.data.synthetic import gen_kcover, pack_bitmaps
    from repro_torch.kernels.rules import to_words
    t0 = time.perf_counter()
    sets = gen_kcover(cfg.n, cfg.universe, seed=cfg.seed, avg_size=avg_size)
    t_gen = time.perf_counter() - t0
    sizes = np.fromiter((len(x) for x in sets), np.int64, len(sets))
    bits = pack_bitmaps(sets, cfg.universe)
    del sets
    t_pack = time.perf_counter() - t0 - t_gen
    words = to_words(bits).to(dev)
    torch.cuda.synchronize()
    # the largest item is 41,269: bit 31 of its word holds items ≡ 31 mod 32
    top = int((words < 0).sum())
    emit({"phase": "data_kcover", "n": cfg.n, "universe": cfg.universe,
          "words": int(bits.shape[1]), "avg_size": avg_size,
          "mean_items": float(sizes.mean()), "max_items": int(sizes.max()),
          "gigabytes": bits.nbytes / 1e9, "words_with_bit31": top,
          "gen_seconds": t_gen, "pack_seconds": t_pack,
          "seconds": time.perf_counter() - t0})
    return bits, words


def phase_parity_coverage(torch, words, cfg, pools):
    """The four bitmap kernels against their plain versions on the card,
    at the kcover runs' shapes, by kernels/parity.py's exact rule (rows,
    bests and raw gains equal bit for bit; gains are integers):
      gains        32 lanes × 2,227 sampled candidates × W words, a
                   random live row
      fused_step   the knapsack leaves (32 lanes × 30,938 × W) and a
                   node shape (32 × 128 × W), random rows, 80% masks, a
                   random previous winner, two steps
      greedy_loop  the first leaf level of run_tree_dense (32 padded
                   pools), k steps from a random row
      resident     every level's nodes (16, 8, 4, 2, 1) and the
                   stochastic run's 32 lanes, of b·k sets each
    Random rows and node sets hold words with bit 31 set. Returns each
    kernel's largest measured |kernel − plain| over its checks."""
    from repro_torch.core.greedyml import LaneSampler
    from repro_torch.kernels import fused_step as F
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import parity
    from repro_torch.kernels import rules as R
    rule = R.BITS_OR
    dev = words.device
    w = words.shape[1]
    k = cfg.k
    out = {}
    _, lpay, lvalid = pools
    b, n, _ = lpay.shape
    sample = sample_size(n, k)
    idx = LaneSampler(cfg.seed)(0, b, 1, n, sample)[:, 0].to(dev)
    cands = torch.gather(lpay, 1, idx[..., None].expand(b, sample, w))
    row = random_words(torch, (b, w), cfg.seed, dev)
    cv = torch.gather(lvalid, 1, idx)
    got = P.gains(None, row, cands, cv, rule)
    out["gains"] = parity.compare_exact(got, P.gains_plain(
        None, row, cands, cv, rule), "gains[coverage]")
    out["gains"]["shape"] = [b, sample, w]
    del cands, got

    def steps(mat, row, what):
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        c = mat.shape[-1]
        mask = (torch.rand(b, c, generator=gen, device=dev) > 0.2).float()
        prev = torch.randint(0, c, (b,), generator=gen, device=dev)
        plain = F.fused_step_plain(mat, row, mask, prev, rule)
        res = parity.compare_exact(F.fused_step_bits(mat, row, mask, prev,
                                                     rule), plain, what)
        mask2 = mask.scatter(1, plain[1][:, None], 0.0)
        plain2 = F.fused_step_plain(mat, plain[0], mask2, plain[1], rule)
        res2 = parity.compare_exact(F.fused_step_bits(
            mat, plain[0], mask2, plain[1], rule), plain2, what + ", step 2")
        return {"entries": res["entries"] + res2["entries"],
                "differing": res["differing"] + res2["differing"],
                "max_abs_err": max(res["max_abs_err"], res2["max_abs_err"]),
                "shape": [b, w, c]}

    out["fused_step"] = {"leaf": steps(lpay.transpose(1, 2), row,
                                       "fused_step[coverage] leaf")}
    bk = cfg.branching * k
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    pick = torch.randint(0, words.shape[0], (b, bk), generator=gen,
                         device=dev)
    nodes = words[pick]
    nodes[:, ::7] |= random_words(torch, (b, (bk + 6) // 7, w), 3, dev)
    out["fused_step"]["node"] = steps(nodes.transpose(1, 2), row,
                                      "fused_step[coverage] node")
    del nodes
    out["greedy_loop"] = _leaf_loop_parity(torch, words, cfg)
    del pick
    # the resident loop over every level's nodes, and the 32 lanes the
    # stochastic run's node stages batch
    out["greedy_loop_resident"] = {
        str(nn): _resident_coverage_parity(torch, words, nn, bk, k,
                                           cfg.seed + 10 + nn)
        for nn in sorted(set(_level_nodes(cfg)) | {b}, reverse=True)}
    emit({"phase": "parity_coverage", "rule": "exact (bit for bit)", **out})
    return _max_errs(out)


def _level_nodes(cfg) -> list:
    """The node count of each level above the leaves of cfg's tree."""
    from repro_torch.core.tree import AccumulationTree
    tree = AccumulationTree(cfg.num_machines, cfg.branching)
    return [len(tree.nodes_at_level(lvl))
            for lvl in range(1, tree.num_levels + 1)]


def _max_errs(results) -> dict:
    """{kernel[coverage]: the largest max_abs_err} over nested results
    of parity.compare_exact."""
    def worst(r):
        if "max_abs_err" in r:
            return r["max_abs_err"]
        return max(worst(v) for v in r.values() if isinstance(v, dict))
    return {f"{name}[coverage]": worst(r) for name, r in results.items()}


def _leaf_loop_parity(torch, words, cfg):
    """The bitmap streaming loop against its plain version over the first
    leaf level of run_tree_dense (its padded pools, read in place), k
    steps from a random row with bit-31 words."""
    from repro_torch.kernels import greedy_loop as L
    from repro_torch.kernels import parity
    from repro_torch.kernels import rules as R
    ids, pay, valid = leaf_pools(torch, words, cfg.num_machines, cfg.seed)
    b, n, w = pay.shape
    mat = pay.transpose(1, 2)
    row = random_words(torch, (b, w), cfg.seed + 2, words.device)
    mask = valid.float()
    res = parity.compare_exact(
        L.greedy_loop_bits(mat, row, mask, cfg.k, R.BITS_OR),
        L.greedy_loop_plain(mat, row, mask, cfg.k, R.BITS_OR),
        "greedy_loop[coverage]")
    res["shape"] = [b, w, n, cfg.k]
    return res


def _resident_coverage_parity(torch, words, nodes: int, bk: int, k: int,
                              seed: int):
    """The bitmap resident loop against its plain version over `nodes`
    nodes of bk sets drawn from the data (every 7th set OR'ed with
    random words holding bit 31), k steps from an empty row; odd nodes
    freeze at kq = k/2 (ctl), the others run all k steps."""
    from repro_torch.kernels import greedy_loop as L
    from repro_torch.kernels import parity
    from repro_torch.kernels import rules as R
    dev = words.device
    w = words.shape[1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    cd = words[torch.randint(0, words.shape[0], (nodes, bk), generator=gen,
                             device=dev)]
    cd[:, ::7] |= random_words(torch, (nodes, (bk + 6) // 7, w), seed, dev)
    row = torch.zeros(nodes, w, dtype=R.WORD_DTYPE, device=dev)
    mask = torch.ones(nodes, bk, device=dev)
    ctl = torch.tensor([[k if i % 2 == 0 else k // 2, w, bk]
                        for i in range(nodes)], dtype=torch.int32,
                       device=dev)
    res = parity.compare_exact(
        L.greedy_loop_resident(None, cd, row, mask, ctl, k, R.BITS_OR),
        L.greedy_loop_resident_plain(None, cd, row, mask, ctl, k,
                                     R.BITS_OR),
        f"greedy_loop_resident[coverage], {nodes} nodes")
    res["shape"] = [nodes, bk, w, k]
    return res


def _coverage_tree(torch, name, bits, words, cfg, phase: str):
    """run_tree_dense on bitmaps at a full configuration: the leaves on
    the streaming loop (1 launch), every level on the resident loop (1
    launch), no pairwise launch anywhere (a bitmap matrix is a view);
    the leaf stage's device allocation held to the planner's cache bytes
    (the pools the cache views, nothing copied)."""
    from repro_torch.core.simulate import global_value, partition, \
        run_tree_dense
    from repro_torch.core.tree import AccumulationTree
    from repro_torch.kernels import counters
    from repro_torch.kernels.plans import cache_bytes, select_engine
    from repro_torch.kernels.rules import BITS_OR
    from repro_torch.core.simulate import _pools
    tree = AccumulationTree(cfg.num_machines, cfg.branching)
    w = words.shape[1]
    # the host's share of the leaf stage: the random tape and the pools
    # (a stable argsort of n ids), as run_tree_dense builds them
    t0 = time.perf_counter()
    pool_ids, _ = _pools(partition(cfg.n, cfg.num_machines, cfg.seed),
                         cfg.num_machines)
    host_pools_s = time.perf_counter() - t0
    n_leaf = pool_ids.shape[1]
    leaf_bytes = cache_bytes(w, n_leaf, "uint32", cfg.num_machines)
    levels = []
    counters.reset()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hook = _level_hook(torch, levels)
    peak = []

    def on_level(lvl):
        hook(lvl)
        if lvl == 0:
            peak.append(torch.cuda.max_memory_allocated() - base)

    t0 = time.perf_counter()
    res = run_tree_dense(name, words, cfg.k, tree, seed=cfg.seed,
                         universe=cfg.universe, device=words.device,
                         on_level=on_level)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = {}
    for lv in levels:
        lvl = lv["level"]
        n_stage = n_leaf if lvl == 0 else cfg.branching * cfg.k
        reps = (cfg.num_machines if lvl == 0
                else len(tree.nodes_at_level(lvl)))
        engine = select_engine(BITS_OR, w, n_stage, replicas=reps).engine
        lv["engine"] = engine
        want = ({"greedy_loop[coverage]": 1} if lvl == 0
                else {"greedy_loop_resident[coverage]": 1})
        assert engine == ("mega_stream" if lvl == 0 else "mega_resident"), (
            lvl, engine)
        assert lv["launches"] == want, (lvl, lv["launches"], want)
        for k, v in lv["launches"].items():
            totals[k] = totals.get(k, 0) + v
    assert len(levels) == tree.num_levels + 1
    ids = np.asarray(res.ids)
    assert 0 < len(ids) <= cfg.k and len(set(ids.tolist())) == len(ids)
    assert ids.min() >= 0 and ids.max() < cfg.n
    # coverage's value does not depend on the ground set: the root's
    # value IS the coverage of its ids over the whole universe
    t1 = time.perf_counter()
    rescored = global_value(name, bits, ids)
    rescore_s = time.perf_counter() - t1
    assert rescored == res.value == res.root_value, (
        rescored, res.value, res.root_value)
    # the leaf stage allocated the pools (the cache) and small outputs:
    # no copy of the cache
    assert leaf_bytes <= peak[0] < 1.05 * leaf_bytes, (peak, leaf_bytes)
    emit({"phase": phase, "n": cfg.n, "universe": cfg.universe, "words": w,
          "k": cfg.k, "m": cfg.num_machines, "b": cfg.branching,
          "leaf_pool": n_leaf, "leaf_cache_bytes_planned": leaf_bytes,
          "leaf_stage_bytes_allocated": int(peak[0]),
          "host_pools_seconds": host_pools_s,
          "levels": levels, "wall_seconds": wall,
          "root_value": res.root_value, "global_value": res.value,
          "global_value_recomputed": rescored,
          "global_value_seconds": rescore_s, "root_ids": len(ids),
          "evals_total": res.evals_total,
          "comm_elements": res.comm_elements})
    return totals, res.root_value


def phase_kcover_knapsack(torch, words, cfg, pools):
    """The constrained coverage path: LevelDispatcher with a KnapsackSpec
    of uniform(0.5, 2) costs by global id over the 32 lanes, budget 40.
    Every stage runs the fused engine: k fused_step launches over the
    candidates' words read in place, no pairwise launch."""
    from repro_torch.core.constraints import KnapsackSpec
    spec = KnapsackSpec(torch.as_tensor(knapsack_costs(cfg.n, cfg.seed),
                                        device=words.device), BUDGET_KCOVER)

    def expect(stage, engine):
        assert engine == "fused", (stage, engine)
        return {"fused_step[coverage]": cfg.k}

    t0 = time.perf_counter()
    stages, totals, sols = _run_dispatcher(
        torch, words, cfg, pools, expect, objective="kcover",
        constraint=spec)
    wall = time.perf_counter() - t0
    spent = spec.spent(sols.ids, sols.valid).cpu().numpy()
    assert (spent <= BUDGET_KCOVER).all(), spent
    ids, root = _report_root(torch, words, sols, cfg.k, "kcover")
    assert len(ids) < cfg.k, "the budget did not bind"
    assert totals["fused_step[coverage]"] == len(stages) * cfg.k
    emit({"phase": "kcover_knapsack", "lanes": int(sols.ids.shape[0]),
          "pool": int(pools[1].shape[1]), "k": cfg.k,
          "budget": BUDGET_KCOVER, "stages": stages, "wall_seconds": wall,
          **root, "spent_root": float(spent[0]),
          "spent_lanes": spent.tolist()})
    return totals


def phase_kcover_stochastic(torch, words, cfg, pools):
    """The stochastic coverage path: sample_leaf = ⌈(n_l/k)·ln 100⌉ over
    the padded lane pools (2,227 at KOSARAK): the leaves on the per-step
    engine (k gains launches), the nodes unsampled on the resident loop."""
    from repro_torch.core.greedyml import LaneSampler
    sample = sample_size(pools[1].shape[1], cfg.k)
    # the host's share of the leaf stage: the default sampler's draws
    # (CPU generators, one per lane), apart from the run
    t0 = time.perf_counter()
    LaneSampler(cfg.seed)(0, pools[0].shape[0], cfg.k, pools[1].shape[1],
                          sample)
    draws_s = time.perf_counter() - t0

    def expect(stage, engine):
        if stage == 0:
            assert engine == "step", engine
            return {"gains[coverage]": cfg.k}
        assert engine == "mega_resident", (stage, engine)
        return {"greedy_loop_resident[coverage]": 1}

    t0 = time.perf_counter()
    stages, totals, sols = _run_dispatcher(
        torch, words, cfg, pools, expect, objective="kcover",
        sample_leaf=sample, seed=cfg.seed)
    wall = time.perf_counter() - t0
    _, root = _report_root(torch, words, sols, cfg.k, "kcover")
    emit({"phase": "kcover_stochastic", "lanes": int(sols.ids.shape[0]),
          "pool": int(pools[1].shape[1]), "k": cfg.k,
          "sample_leaf": sample, "stages": stages, "wall_seconds": wall,
          "leaf_draws_seconds": draws_s, **root})
    return totals


def phase_kdom_run(torch, cfg, dev):
    """run_tree_dense('kdom', …) at the reference's kdom configuration:
    closed neighbourhoods of the road-like graph, packed over its
    vertices (W ≫ k: 2,048 words against k = 128)."""
    from repro_torch.data.synthetic import gen_graph_road, pack_bitmaps
    from repro_torch.kernels.rules import to_words
    t0 = time.perf_counter()
    bits = pack_bitmaps(gen_graph_road(cfg.n, seed=cfg.seed), cfg.universe)
    words = to_words(bits).to(dev)
    torch.cuda.synchronize()
    emit({"phase": "data_kdom", "n": cfg.n, "words": int(bits.shape[1]),
          "gigabytes": bits.nbytes / 1e9,
          "seconds": time.perf_counter() - t0})
    out = {"greedy_loop": _leaf_loop_parity(torch, words, cfg)}
    bk = cfg.branching * cfg.k
    out["greedy_loop_resident"] = {
        str(nn): _resident_coverage_parity(torch, words, nn, bk, cfg.k,
                                           cfg.seed + 10 + nn)
        for nn in _level_nodes(cfg)}
    emit({"phase": "parity_kdom", "rule": "exact (bit for bit)", **out})
    launches, _ = _coverage_tree(torch, "kdom", bits, words, cfg,
                                 "kdom_run")
    return launches, _max_errs(out)


def phase_timing_coverage(torch, words, cfg, pools, reps):
    """Each bitmap kernel at its path's shape beside its plain version
    and its bound: bytes over the HBM rate (a popcount pass does a few
    integer operations per word read, far below the card's integer
    rate). The streaming loop re-reads its caches every step, less what
    L2 and shared memory could hold; the resident loop reads its nodes'
    words once from device memory. No single PyTorch call computes a
    popcount gain, so there is no library time."""
    from repro_torch.core.greedyml import LaneSampler
    from repro_torch.kernels import fused_step as F
    from repro_torch.kernels import greedy_loop as L
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import rules as R
    from repro_torch.kernels.plans import BITS_RESIDENT_BLOCK_C
    rule = R.BITS_OR
    dev = words.device
    w = words.shape[1]
    k = cfg.k
    _, lpay, lvalid = pools
    b, n, _ = lpay.shape
    out = {}
    row = random_words(torch, (b, w), cfg.seed, dev)
    s = sample_size(n, k)
    idx = LaneSampler(cfg.seed)(0, b, 1, n, s)[:, 0].to(dev)
    cands = torch.gather(lpay, 1, idx[..., None].expand(b, s, w))
    cv = torch.ones(b, s, dtype=torch.bool, device=dev)
    nbytes = 4.0 * (b * s * w + b * w + b * s) + b * s
    out["gains[coverage]"] = {
        "shape": [b, s, w],
        "ms": cuda_ms(torch, lambda: P.gains(None, row, cands, cv, rule),
                      20 * reps),
        "plain_ms": cuda_ms(torch, lambda: P.gains_plain(None, row, cands,
                                                         cv, rule), reps),
        "library_ms": None, "bound_ms": nbytes / PEAK_HBM_BYTES * 1e3,
        "bound_by": "bytes"}
    del cands
    mat = lpay.transpose(1, 2)
    mask = lvalid.float()
    prev = torch.zeros(b, dtype=torch.int64, device=dev)
    nbytes = 4.0 * (b * n * w + 3 * b * w + b * n) + 16.0 * b
    out["fused_step[coverage]"] = {
        "shape": [b, w, n],
        "ms": cuda_ms(torch, lambda: F.fused_step_bits(mat, row, mask, prev,
                                                       rule), 10 * reps),
        "plain_ms": cuda_ms(torch, lambda: F.fused_step_plain(
            mat, row, mask, prev, rule), reps),
        "library_ms": None, "bound_ms": nbytes / PEAK_HBM_BYTES * 1e3,
        "bound_by": "bytes"}
    del mat, mask
    # the knapsack node shape (reported, not in the kernels line): 32
    # lanes of b·k = 128 sets, whose words sit in L2
    bk = cfg.branching * k
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 5)
    pick = torch.randint(0, words.shape[0], (b, bk), generator=gen,
                         device=dev)
    nmat = words[pick].transpose(1, 2)
    nmask = torch.ones(b, bk, device=dev)
    out["fused_step[coverage]_node"] = {
        "shape": [b, w, bk],
        "ms": cuda_ms(torch, lambda: F.fused_step_bits(nmat, row, nmask, prev,
                                                       rule), 20 * reps),
        "plain_ms": cuda_ms(torch, lambda: F.fused_step_plain(
            nmat, row, nmask, prev, rule), 20 * reps),
        "bound_ms": 4.0 * (b * bk * w + 3 * b * w + b * bk) / PEAK_HBM_BYTES
        * 1e3}
    del nmat
    ids, pay, valid = leaf_pools(torch, words, cfg.num_machines, cfg.seed)
    mat = pay.transpose(1, 2)
    bl, nl = pay.shape[:2]
    lrow = torch.zeros(bl, w, dtype=R.WORD_DTYPE, device=dev)
    mask = valid.float()
    cache = 4.0 * bl * nl * w
    nbytes = (k * cache - (k - 1) * min(cache, on_chip_bytes(torch))
              + 4.0 * (2 * bl * w + bl * nl) + 8.0 * bl * k)
    out["greedy_loop[coverage]"] = {
        "shape": [bl, w, nl, k],
        "ms": cuda_ms(torch, lambda: L.greedy_loop_bits(mat, lrow, mask, k,
                                                        rule), reps),
        "plain_ms": cuda_ms(torch, lambda: L.greedy_loop_plain(
            mat, lrow, mask, k, rule), 1, warmup=0),
        "library_ms": None, "bound_ms": nbytes / PEAK_HBM_BYTES * 1e3,
        "bound_by": "bytes"}
    del ids, pay, valid, mat, mask
    nn = cfg.num_machines // cfg.branching
    cd = words[pick[:nn]]
    rrow = torch.zeros(nn, w, dtype=R.WORD_DTYPE, device=dev)
    rmask = torch.ones(nn, bk, device=dev)
    ctl = torch.tensor([[k, w, bk]] * nn, dtype=torch.int32, device=dev)
    nbytes = 4.0 * (nn * bk * w + 2 * nn * w + nn * bk + 3 * nn) \
        + 8.0 * nn * k
    out["greedy_loop_resident[coverage]"] = {
        "shape": [nn, bk, w, k], "block_c": BITS_RESIDENT_BLOCK_C,
        "ms": cuda_ms(torch, lambda: L.greedy_loop_resident(
            None, cd, rrow, rmask, ctl, k, rule), 10 * reps),
        "plain_ms": cuda_ms(torch, lambda: L.greedy_loop_resident_plain(
            None, cd, rrow, rmask, ctl, k, rule), reps),
        "library_ms": None, "bound_ms": nbytes / PEAK_HBM_BYTES * 1e3,
        "bound_by": "bytes"}
    # the resident loop's candidates per block (bk = one block a node)
    # at the level-1 nodes and at the stochastic run's 32 lanes
    sweep = {}
    for args in ((cd, rrow, rmask, ctl),
                 (words[pick], torch.zeros_like(row),
                  torch.ones(b, bk, device=dev),
                  torch.tensor([[k, w, bk]] * b, dtype=torch.int32,
                               device=dev))):
        sweep[f"{args[0].shape[0]}x{bk}x{w}"] = {
            str(bc): cuda_ms(torch, lambda: L.greedy_loop_resident_bits(
                *args, k, rule, block_c=bc), 10 * reps)
            for bc in (4, 8, 16, 32, bk)}
    out["greedy_loop_resident[coverage]_block_c"] = sweep
    emit({"phase": "timing_coverage", **out})
    return out


# ---------------------------------------------------------------------------
# streaming: the sieve filter (B6) and the int8-ground gains (B2q)
# ---------------------------------------------------------------------------

# the evaluation set of the int8 k-medoid stream and of the stream
# filter's parity and timing at 16,384 rows: drawn from the stream with
# the seed (the f32 stream evaluates against all n images), a second row
# length for the decisions (2,048 entries a block against 12,500)
STREAM_EVAL = 16_384
# the wider bitmap parity shape: 8,192 words (262,144 items), held on
# both tiers (the device-memory tier forced)
GLOBAL_WORDS = 8_192
STREAM_EPS = 0.1
# arrivals a batch: at the k-medoid stream's 16,384 evaluation rows the
# batch's (N, B) f32 slab is 16.8 MB, within the half of the 50 MB L2
# that every level block re-reads it from
STREAM_BATCH = 256
# the kcover window: the last 262,144 arrivals, a checkpoint every 65,536
WINDOW, STRIDE = 262_144, 65_536
CONTINUOUS_LANES, MERGE_EVERY = 4, 256


def _stream_state(torch, rule, levels, row0, cost: bool, lanes: int = 1):
    """Empty canonical stream-filter state (rows, row0, values, counts,
    expos, m[, spent]) of `lanes` stacked sieves."""
    dev = row0.device
    st = (row0.expand(lanes, levels, row0.shape[0]).contiguous(), row0,
          torch.zeros(lanes, levels, device=dev),
          torch.zeros(lanes, levels, dtype=torch.int32, device=dev),
          torch.arange(levels, dtype=torch.int32, device=dev).expand(
              lanes, levels).contiguous(),
          torch.zeros(lanes, device=dev))
    return st + (torch.zeros(lanes, levels, device=dev),) if cost else st


def _next_state(out, row0, cost: bool):
    """The canonical state after a batch, from a filter's outputs."""
    return (out[0], row0, out[1], out[2], out[4], out[5]) + (
        (out[7],) if cost else ())


@contextlib.contextmanager
def _device_memory_tier():
    """The stream filter's device-memory tier (rows off chip), forced by
    squeezing plans.STREAM_SMEM_BYTES for the duration, as the CUDA
    tests do."""
    from repro_torch.kernels import plans
    old = plans.STREAM_SMEM_BYTES
    plans.STREAM_SMEM_BYTES = 64
    try:
        yield
    finally:
        plans.STREAM_SMEM_BYTES = old


def _cuda_events(torch, prof):
    """(kernel name, launches recorded, device µs) of each CUDA entry of a
    torch.profiler trace's key_averages."""
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        yield e.key.split("(")[0], e.count, us


def _kernel_split(torch, fn, calls: int = 10) -> dict:
    """Device time by CUDA kernel over `calls` calls of fn, from
    torch.profiler's key_averages: each kernel's mean ms a launch and the
    launches the trace recorded (it may miss a launch of the first call),
    and the CUDA launches of a call (all recorded launches over `calls`);
    "not measured" when the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for name, count, us in _cuda_events(torch, prof):
        for short in ("rt_row_norms", "rt_stream_slab", "rt_stream_singles",
                      "rt_stream_decide", "rt_stream_bits_prep",
                      "rt_stream_bits_level"):
            if short in name:
                name = short
        k = kernels.setdefault(name, {"launches_recorded": 0, "us": 0.0})
        k["launches_recorded"] += count
        k["us"] += us
    if not kernels or sum(k["us"] for k in kernels.values()) <= 0:
        return {"kernel_split": "not measured", "cuda_launches_per_call":
                "not measured"}
    launches = sum(k["launches_recorded"] for k in kernels.values())
    for k in kernels.values():
        k["ms_per_launch"] = k.pop("us") / 1e3 / max(k["launches_recorded"],
                                                     1)
    return {"kernel_split": kernels, "calls": calls,
            "cuda_launches_per_call": launches / calls}


def _digest(ids, value) -> dict:
    """A stream summary's value and a hash of its sorted ids: two trees
    run in one call give equal digests when their streams agree."""
    import hashlib
    srt = np.sort(np.asarray(ids, np.int64).reshape(-1))
    return {"value": float(value), "ids": int(srt.size),
            "ids_sha1": hashlib.sha1(srt.tobytes()).hexdigest()[:16]}


def _stream_eval_set(torch, x, seed: int):
    """STREAM_EVAL images of the stream drawn without replacement with
    the seed: the fixed evaluation set of the k-medoid stream."""
    ids = np.sort(np.random.default_rng(seed).choice(
        x.shape[0], STREAM_EVAL, replace=False))
    return x[torch.as_tensor(ids, device=x.device)].contiguous()


def _stream_batches(torch, data, n_batches: int, b: int, seed: int,
                    costs=None):
    """The first `n_batches` arrival batches of data shuffled with the
    seed: (ids, payloads, valid, costs or None)."""
    order = torch.as_tensor(np.random.default_rng(seed).permutation(
        data.shape[0])[:n_batches * b], device=data.device)
    out = []
    for i in range(n_batches):
        ids = order[i * b:(i + 1) * b]
        out.append((ids, data[ids].contiguous(),
                    torch.ones(b, dtype=torch.bool, device=data.device),
                    None if costs is None else costs[ids].contiguous()))
    return out


def phase_parity_stream(torch, x, cfg, pools):
    """B6 on feature rules at the k-medoid stream's shape (N = 16,384
    evaluation rows, B = 256 arrivals, L = 72 levels, D = 12,288), three
    chained batches fed the plain version's state on both sides, for
    kmedoid and facility, with and without knapsack costs (budget 100):
    the kernel's slab by the float64 pairwise rule, its decisions by
    parity.compare_stream (ties counted); the int8-ground variant bit
    for bit against the f32 kernel on the dequantized ground, and by
    compare_stream against the plain version there. Then B2q at the
    stochastic leaf shape (32 × 3,125 ground rows × 72 sampled
    candidates × 12,288): bit for bit against the f32 gains kernel on
    the dequantized ground, and the float64 ratio rule against its plain
    version. The slot update (scatter_slots) at the k-medoid stream's
    shape, (1, 72, 200, 12,288) f32 payload slots, over the same three
    batches: bit for bit against the reference's one-hot formula, and
    every filled slot's payload equal to its id's image. Returns each
    kernel's largest measured |kernel − plain|, and the filter state and
    the slots after the three batches for the timing phase."""
    from repro_torch.core.greedyml import LaneSampler
    from repro_torch.kernels import ops, parity
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import ref as TRef
    from repro_torch.kernels import rules as R
    from repro_torch.kernels import stream_filter as TS
    from repro_torch.streaming import num_levels
    k, b = cfg.k, STREAM_BATCH
    levels = num_levels(k, STREAM_EPS)
    eps_log = math.log1p(STREAM_EPS)
    ground = _stream_eval_set(torch, x, cfg.seed)
    n, d = ground.shape
    q, scale = ops.quantize_ground(ground)
    deq = R.dequant(q, scale).contiguous()
    gscale = scale.reshape(-1).contiguous()
    costs = torch.as_tensor(knapsack_costs(x.shape[0], cfg.seed),
                            device=x.device)
    batches = _stream_batches(torch, x, 4, b, cfg.seed + 1, costs)
    spare, batches = batches[3], batches[:3]    # the timing phase's batch
    errs = {"stream_filter": 0.0, "stream_filter[int8]": 0.0}
    out, timing_state = {}, None
    for name, rule in (("kmedoid", R.DIST_MIN), ("facility", R.DOT_MAX)):
        for cost in (False, True):
            res = {"f32": [], "int8": []}
            for tag, g_in in (("f32", ground), ("int8", deq)):
                row0 = R.empty_row(ground[None], torch.ones(
                    1, n, dtype=torch.bool, device=x.device), rule)[0]
                st = _stream_state(torch, rule, levels, row0.contiguous(),
                                   cost)
                first = (name, cost, tag) == ("kmedoid", False, "f32")
                if first:
                    slots = (torch.full((1, levels, k), -1,
                                        dtype=torch.int64, device=x.device),
                             torch.zeros(1, levels, k, d, device=x.device))
                    scatter = {"shape": [1, levels, k, d], "admitted": 0,
                               "entries": 0, "differing": 0}
                for bids, pay, valid, c in batches:
                    arr, bv = pay[None], valid[None]
                    kw = (dict(costs=c[None], spent=st[6], budget=BUDGET)
                          if cost else {})
                    mat_k = torch.empty(1, b, n, device=x.device)
                    if tag == "f32":
                        got = TS.stream_filter(ground, arr, *st[:6], bv, k,
                                               eps_log, rule, scratch=mat_k,
                                               **kw)
                    else:
                        got = TS.stream_filter(q, arr, *st[:6], bv, k,
                                               eps_log, rule, gscale=gscale,
                                               scratch=mat_k, **kw)
                        mat_f = torch.empty_like(mat_k)
                        f32 = TS.stream_filter(deq, arr, *st[:6], bv, k,
                                               eps_log, rule, scratch=mat_f,
                                               **kw)
                        same = parity.compare_exact(
                            got + (mat_k,), f32 + (mat_f,),
                            f"stream_filter[int8] {name}")
                        del f32, mat_f
                    plain = TS.stream_filter_plain(g_in, arr, *st[:6], bv, k,
                                                   eps_log, rule, **kw)
                    mat_p = TRef.pairwise(g_in, arr, rule)
                    mstats = parity.compare_pairwise(
                        mat_k.transpose(1, 2), mat_p, g_in[None], arr,
                        rule.pairwise, what=f"stream_filter slab {name}")
                    cmp = parity.compare_stream(
                        got, plain, mat_k, mat_p,
                        st[:6] + ((st[6],) if cost else (None,)), bv, k,
                        eps_log, rule, costs=c[None] if cost else None,
                        budget=BUDGET if cost else None,
                        what=f"stream_filter {name} {tag}")
                    cmp["slab_rms_ratio"] = mstats["rms_ratio"]
                    if tag == "int8":
                        cmp["vs_f32_kernel_differing"] = same["differing"]
                    res[tag].append(cmp)
                    key = "stream_filter" + ("[int8]" if tag == "int8"
                                             else "")
                    errs[key] = max(errs[key], cmp["max_value_err"],
                                    cmp["max_row_err"], cmp["max_m_err"])
                    if first:
                        sargs = (st[3], plain[6], plain[3], bids[None], arr,
                                 k)
                        want = TS.scatter_slots_plain(*slots, *sargs)
                        slots = TS.scatter_slots(*slots, *sargs)
                        r = parity.compare_exact(slots, want,
                                                 "scatter_slots kmedoid")
                        scatter["admitted"] += int(plain[3].sum())
                        scatter["entries"] += r["entries"]
                        scatter["differing"] += r["differing"]
                        scatter["max_abs_err"] = max(
                            scatter.get("max_abs_err", 0.0),
                            r["max_abs_err"])
                        del want
                    st = _next_state(plain, st[1], cost)
                    del got, plain, mat_k, mat_p
                if first:
                    timing_state = st
                    filled = slots[0] >= 0
                    assert bool(filled.any())
                    assert torch.equal(slots[1][filled],
                                       x[slots[0][filled]]), \
                        "scatter_slots: a slot's payload is not its image"
                    scatter["filled_slots"] = int(filled.sum())
            out[f"{name}{'_knapsack' if cost else ''}"] = res
    del q, scale, deq, gscale
    # B2q at the stochastic leaf shape
    _, pay, valid = pools
    lanes, nl, _ = pay.shape
    gq, gs = ops.quantize_ground(pay)
    gdeq = R.dequant(gq, gs).contiguous()
    sample = sample_size(nl, k)
    idx = LaneSampler(cfg.seed)(0, lanes, 1, nl, sample)[:, 0].to(x.device)
    cands = torch.gather(pay, 1, idx[..., None].expand(lanes, sample, d))
    cands = cands.contiguous()
    cv = torch.ones(lanes, sample, dtype=torch.bool, device=x.device)
    cv[:, -1] = False
    b2q = {}
    for name, rule in (("kmedoid", R.DIST_MIN), ("facility", R.DOT_MAX)):
        row = R.empty_row(gdeq, valid, rule)
        for j in range(5):
            row = R.update_row(gdeq, row, gdeq[:, 97 * j % nl], rule)
        row = row.contiguous()
        gnorm = P.ground_norms(gq, gs) if rule.pairwise == "dist" else None
        got = P.gains(gq, row, cands, cv, rule, gscale=gs, gnorm=gnorm)
        same = parity.compare_exact(got, P.gains(gdeq, row, cands, cv, rule),
                                    f"gains[int8] {name} vs the f32 kernel")
        yard = parity.compare_exact(got, P.gains(
            gq, row, cands, cv, rule, gscale=gs, reference=True),
            f"gains[int8] {name} vs the 64x64 build")
        plain = P.gains_plain(gq, row, cands, cv, rule, gs)
        stats = parity.compare_gains(got, plain, gdeq, row, cands, rule,
                                     what=f"gains[int8] {name}")
        fin = torch.isfinite(plain)
        stats["max_abs_diff"] = float((got[fin] - plain[fin]).abs().max())
        stats["vs_f32_kernel_differing"] = same["differing"]
        stats["vs_64x64_build_differing"] = yard["differing"]
        b2q[name] = stats
    errs["gains[int8]"] = b2q["kmedoid"]["max_abs_diff"]
    del gq, gs, gdeq, cands
    emit({"phase": "parity_stream", "shape": [1, levels, n, b, d],
          "k": k, "batches": len(batches), "budget": BUDGET,
          **{c: {t: {"ties": sum(r["ties"] + r["window_ties"] for r in v),
                     "decisions": sum(r["decisions"] for r in v),
                     "admitted": sum(r["admitted"] for r in v),
                     "max_value_err": max(r["max_value_err"] for r in v),
                     "max_row_err": max(r["max_row_err"] for r in v),
                     "max_m_err": max(r["max_m_err"] for r in v),
                     "slab_rms_ratio": max(r["slab_rms_ratio"] for r in v)}
                 for t, v in res.items()} for c, res in out.items()},
          "scatter_slots": scatter,
          "gains[int8]": {"shape": [lanes, nl, sample, d], **b2q}})
    return errs, (ground, timing_state, spare, slots)


def phase_parity_stream_global(torch, x, cfg, k_bits: int):
    """B6 at the shapes beyond one block's shared memory. Feature rules:
    the f32 k-medoid stream against all n images (72 levels × 100,000
    evaluation rows × 256 arrivals × 12,288: a level's 400 KB row over a
    cluster of 8 blocks), three chained batches fed the plain version's
    state, the slab by the float64 pairwise rule and the decisions by
    parity.compare_stream; the device-memory tier (forced) equal to it
    bit for bit. Bitmaps: GLOBAL_WORDS = 8,192 words (262,144 items,
    random sparse sets), k = `k_bits`, three chained batches, every
    output bit for bit against the plain version on the shared-memory
    tier and on the device-memory tier (forced). Returns each variant's
    largest measured |kernel − plain| and, for timing_stream, both
    states three batches in with a fourth batch each."""
    from repro_torch.kernels import counters, parity, plans
    from repro_torch.kernels import ref as TRef
    from repro_torch.kernels import rules as R
    from repro_torch.kernels import stream_filter as TS
    from repro_torch.streaming import num_levels
    k, b = cfg.k, STREAM_BATCH
    eps_log = math.log1p(STREAM_EPS)
    rule = R.DIST_MIN
    levels = num_levels(k, STREAM_EPS)
    n, d = x.shape
    dev = x.device
    assert plans.stream_tier(n, b, rule) == "kernel"
    row0 = R.empty_row(x[None], torch.ones(1, n, dtype=torch.bool,
                                           device=dev), rule)[0].contiguous()
    gnorm = TS.ground_norms(x)
    st = _stream_state(torch, rule, levels, row0, False)
    batches = _stream_batches(torch, x, 4, b, cfg.seed + 1)
    res, errs = [], {"stream_filter": 0.0, "stream_filter[coverage]": 0.0}
    tiers = {"entries": 0, "differing": 0}
    counters.reset()
    for _, pay, valid, _ in batches[:3]:
        arr, bv = pay[None], valid[None]
        mat_k = torch.empty(1, b, n, device=dev)
        got = TS.stream_filter(x, arr, *st[:6], bv, k, eps_log, rule,
                               scratch=mat_k, gnorm=gnorm)
        with _device_memory_tier():
            glob = TS.stream_filter(x, arr, *st[:6], bv, k, eps_log, rule,
                                    gnorm=gnorm)
        r = parity.compare_exact(glob, got, "stream_filter, device-memory "
                                 "tier vs a cluster of 8")
        tiers["entries"] += r["entries"]
        tiers["differing"] += r["differing"]
        del glob
        plain = TS.stream_filter_plain(x, arr, *st[:6], bv, k, eps_log,
                                       rule)
        mat_p = TRef.pairwise(x, arr, rule)
        mstats = parity.compare_pairwise(
            mat_k.transpose(1, 2), mat_p, x[None], arr, rule.pairwise,
            what="stream_filter slab, 100,000 rows")
        cmp = parity.compare_stream(got, plain, mat_k, mat_p,
                                    st[:6] + (None,), bv, k, eps_log, rule,
                                    what="stream_filter, 100,000 rows")
        cmp["slab_rms_ratio"] = mstats["rms_ratio"]
        res.append(cmp)
        errs["stream_filter"] = max(errs["stream_filter"],
                                    cmp["max_value_err"], cmp["max_row_err"],
                                    cmp["max_m_err"])
        st = _next_state(plain, row0, False)
        del got, plain, mat_k, mat_p
    assert counters.snapshot()["stream_filter"]["launches"] == 6
    # bitmaps at 8,192 words, on both tiers
    w, brule = GLOBAL_WORDS, R.BITS_OR
    blevels = num_levels(k_bits, STREAM_EPS)
    assert plans.stream_tier(w, b, brule) == "kernel"
    words = random_words(torch, (4 * b, w), cfg.seed + 5, dev)
    brow0 = torch.zeros(w, dtype=R.WORD_DTYPE, device=dev)
    bst = _stream_state(torch, brule, blevels, brow0, False)
    ball = torch.ones(1, b, dtype=torch.bool, device=dev)
    bits = {"entries": 0, "differing": 0, "admitted": 0}
    counters.reset()
    for i in range(3):
        arr = words[i * b:(i + 1) * b][None]
        plain = TS.stream_filter_plain(None, arr, *bst, ball, k_bits,
                                       eps_log, brule)
        for tier in ("kernel", "global"):
            with (_device_memory_tier() if tier == "global"
                  else contextlib.nullcontext()):
                assert plans.stream_tier(w, b, brule) == tier
                got = TS.stream_filter(None, arr, *bst, ball, k_bits,
                                       eps_log, brule)
            r = parity.compare_exact(got, plain, "stream_filter[coverage], "
                                     f"8,192 words, tier {tier}")
            bits["entries"] += r["entries"]
            bits["differing"] += r["differing"]
            errs["stream_filter[coverage]"] = max(
                errs["stream_filter[coverage]"], r["max_abs_err"])
        bits["admitted"] += int(plain[3].sum())
        bst = _next_state(plain, brow0, False)
    assert counters.snapshot()["stream_filter[coverage]"]["launches"] == 6
    assert bits["admitted"] > 0
    emit({"phase": "parity_stream_global",
          "kmedoid": {"shape": [1, levels, n, b, d], "k": k,
                      "tier": "kernel",
                      "batches": len(res),
                      "ties": sum(r["ties"] + r["window_ties"] for r in res),
                      "decisions": sum(r["decisions"] for r in res),
                      "admitted": sum(r["admitted"] for r in res),
                      "max_value_err": max(r["max_value_err"] for r in res),
                      "max_row_err": max(r["max_row_err"] for r in res),
                      "max_m_err": max(r["max_m_err"] for r in res),
                      "slab_rms_ratio": max(r["slab_rms_ratio"]
                                            for r in res),
                      "device_memory_tier_vs_cluster": {
                          **tiers, "rule": "exact (bit for bit)"}},
          "coverage": {"shape": [1, blevels, w, b], "k": k_bits,
                       "batches": 3, "tiers": ["kernel", "global"],
                       "rule": "exact (bit for bit)", **bits}})
    return errs, ((st, batches[3], gnorm),
                  (bst, words[3 * b:][None], k_bits))


def phase_reference_stream(torch, devices=("cuda", "cpu")):
    """Small-integer facility streams through the kernels against the
    same streams through the plain CPU path: every matrix entry and gain
    is an exact integer on both, so `stream_select` (4,096 arrivals
    against 1,024 evaluation rows, k = 16), a `SlidingSieve` (window
    1,024, stride 256) and a 4-lane `ContinuousSelector` (b = 2, a merge
    every 4 batches; its merge nodes on the resident loop) must give
    equal ids and values."""
    from repro_torch.core.functions import make_objective
    from repro_torch.data.synthetic import Stream
    from repro_torch.kernels import counters
    from repro_torch.streaming import (SieveStreamer, SlidingSieve,
                                       stream_select,
                                       stream_select_continuous)
    rng = np.random.default_rng(9)
    xi = rng.integers(-3, 4, (4096, 64)).astype(np.float32)
    order = rng.permutation(4096)
    evals = xi[np.sort(rng.choice(4096, 1024, replace=False))]
    runs = {}
    for dev in devices:
        obj = make_objective("facility", device=dev)
        data = torch.as_tensor(xi, device=dev)
        ground = torch.as_tensor(evals, device=dev)
        st = Stream(data, order, 256)
        counters.reset()
        one = stream_select(obj, st, 16, ground=ground)
        win = SlidingSieve(SieveStreamer(obj, 16, ground=ground), 1024, 256)
        ws = win.init()
        for ids, pay, valid in st:
            ws = win.process_batch(ws, ids, pay, valid)
        wsol = win.query(ws)
        cont, info = stream_select_continuous(obj, st, 16, lanes=4,
                                              branching=2, merge_every=4,
                                              ground=ground)
        launched = {n: c["launches"] for n, c in
                    counters.snapshot().items() if c["launches"]}
        runs[dev] = ([s.map(lambda t: t.cpu()) for s in (one, wsol, cont)],
                     info["merges"], launched)
    (g, g_merges, launched), (c, c_merges, _) = (runs[d] for d in devices)
    for what, a, b in zip(("stream_select", "window", "continuous"), g, c):
        assert torch.equal(a.ids, b.ids), (what, a.ids, b.ids)
        assert torch.equal(a.value, b.value), (what, a.value, b.value)
    assert g_merges == c_merges, (g_merges, c_merges)
    assert launched.get("stream_filter", 0) == 3 * 16, launched
    assert launched.get("greedy_loop_resident", 0) > 0, launched
    emit({"phase": "reference_stream", "ids_equal": True,
          "values": [float(s.value) for s in g], "merges": g_merges,
          "launches": launched})


def _stream_run(torch, name, data, cfg, k, ground=None, env=None,
                tier="kernel"):
    """stream_select(`name`) over all of `data` shuffled with the seed,
    B = 256: wall, arrivals/s, the plan (asserted on `tier`), the
    launches per variant (asserted: one
    stream filter and one slot update a batch), the summary's digest;
    every selected slot's payload is its arrival's row of `data`."""
    from repro_torch.core.functions import make_objective
    from repro_torch.data.synthetic import Stream
    from repro_torch.kernels import counters
    from repro_torch.streaming import SieveStreamer, stream_select
    b = STREAM_BATCH
    obj = make_objective(name, universe=cfg.universe, device=data.device)
    order = np.random.default_rng(cfg.seed).permutation(data.shape[0])
    n_batches = -(-data.shape[0] // b)
    with _env(**(env or {})):
        plan = SieveStreamer(obj, k, STREAM_EPS, ground=ground).plan(b)
        assert plan["tier"] == tier, plan
        counters.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = stream_select(obj, Stream(data, order, b), k,
                            eps=STREAM_EPS, ground=ground)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {n: c["launches"] for n, c in counters.snapshot().items()
                if c["launches"]}
    tag = {"uint32": "[coverage]", "int8": "[int8]"}.get(plan["dtype"], "")
    assert launches.get("stream_filter" + tag) == n_batches, (
        launches, n_batches)
    assert launches.get("scatter_slots") == n_batches, launches
    ids = sol.ids[sol.valid].cpu().numpy()
    assert 0 < len(ids) <= k and len(set(ids.tolist())) == len(ids)
    assert torch.equal(sol.payloads[sol.valid], data[sol.ids[sol.valid]]), \
        "a selected slot's payload is not its arrival's"
    return sol, ids, {"n": int(data.shape[0]), "batch": b,
                      "batches": n_batches, "k": k, "eps": STREAM_EPS,
                      "plan": plan, "wall_seconds": wall,
                      "arrivals_per_second": data.shape[0] / wall,
                      "launches": launches, "accepted": len(ids),
                      "best_level_value": float(sol.value),
                      "digest": _digest(ids, sol.value)}


def phase_stream_kmedoid(torch, x, cfg, ground, root_ids, dtype="float32",
                         f32_ratio=None):
    """stream_select('kmedoid') over all 100,000 images, shuffled with the
    seed: k = 200, ε = 0.1 (L = 72), B = 256 (391 batches, one
    stream_filter and one scatter_slots launch each). f32 evaluates
    against the whole stream (`ground` is x itself, the reference
    launcher's choice): a level's 400 KB row over a cluster of 8 blocks'
    shared memory. With dtype 'int8' the rung is forced against the
    16,384-image evaluation set (`ground`), 8 blocks a level:
    stream_filter[int8] launches. The stream's ids and the `run` tree
    root's ids scored on the evaluation set (replay_value: the
    objective's own value on that set); the stream must reach (½ − ε)
    of the root's value, which is at most OPT there. The int8 run
    reports its ratio to the root beside `f32_ratio`, the f32 stream's
    on its own set."""
    int8 = dtype == "int8"
    _, ids, rep = _stream_run(torch, "kmedoid", x, cfg, cfg.k,
                              ground=ground,
                              env=_rung_env(dtype) if int8 else None)
    t0 = time.perf_counter()
    gv = _value_on(torch, ground, x, ids)
    root_gv = _value_on(torch, ground, x, root_ids)
    assert gv >= (0.5 - STREAM_EPS) * root_gv, (gv, root_gv)
    emit({"phase": "stream_kmedoid" + ("_int8" if int8 else ""),
          "eval_set": int(ground.shape[0]),
          "eval_set_is_the_stream": ground is x,
          "d": int(x.shape[1]), **rep, "global_value_eval": gv,
          "root_global_value_eval": root_gv,
          "ratio_to_root": gv / root_gv,
          **({} if f32_ratio is None else {
              "f32_ratio_to_root_whole_stream": f32_ratio}),
          "global_value_seconds": time.perf_counter() - t0})
    return rep["launches"], gv / root_gv


def _value_on(torch, ground, x, ids) -> float:
    """The k-medoid value of the exemplars x[ids] scored on the
    evaluation set `ground` (the objective's f32 value, replay_value:
    every exemplar folded into the empty solution's rows in one pass)."""
    from repro_torch.core.functions import make_objective
    from repro_torch.core.greedy import replay_value
    obj = make_objective("kmedoid", device=ground.device)
    ex = x[torch.as_tensor(np.asarray(ids), device=x.device)][None]
    val = replay_value(obj, ex, torch.ones(ex.shape[:2], dtype=torch.bool,
                                           device=x.device),
                       ground[None], torch.ones(1, ground.shape[0],
                                                dtype=torch.bool,
                                                device=x.device))
    return float(val[0])


def phase_stochastic_int8(torch, x, cfg, pools):
    """The stochastic lanes (sample_leaf 72) under the forced int8 rung:
    the leaves on the step engine read their ground int8, quantized once
    per greedy (k gains[int8] launches, no f32 gains), the nodes on the
    resident loop's int8 rounding (+ the replay pairwise)."""
    sample = sample_size(pools[1].shape[1], cfg.k)

    def expect(stage, engine):
        if stage == 0:
            assert engine == "step", engine
            return {"gains[int8]": cfg.k, "gains_norms": 1}
        assert engine == "mega_resident", (stage, engine)
        return {"greedy_loop_resident[int8]": 1, "pairwise": 1}

    t0 = time.perf_counter()
    with _env(**_rung_env("int8")):
        stages, totals, sols = _run_dispatcher(
            torch, x, cfg, pools, expect, sample_leaf=sample, seed=cfg.seed)
    wall = time.perf_counter() - t0
    _, root = _report_root(torch, x, sols, cfg.k)
    emit({"phase": "stochastic_int8", "lanes": int(sols.ids.shape[0]),
          "pool": int(pools[1].shape[1]), "k": cfg.k,
          "sample_leaf": sample, "stages": stages, "wall_seconds": wall,
          **root})
    return _variant_launches(totals)


def _b6_bound(n, b, d, levels, decisions, admitted, itemsize=4.0):
    """(bound_ms, bound_by) of one feature stream-filter batch: the slab's
    2·N·B·D products (+ the norms) and this batch's live decisions'
    gain parts and folds (3 and 1 operations an entry); the ground
    (itemsize bytes an entry), the arrivals, the rows in and out."""
    flops = (2.0 * n * b * d + 4.0 * (n + b) * d + 3.0 * n * b
             + 3.0 * decisions * n + admitted * n)
    nbytes = itemsize * n * d + 4.0 * (b * d + 2 * levels * n + b)
    return bound(flops, nbytes)


def _feature_split(torch, run, slab, reps) -> dict:
    """A feature stream-filter batch's time split: the slab launch timed
    alone (CUDA events; with the arrivals' norm pass) and the device time
    of each of the batch's kernels (torch.profiler), with the CUDA
    launches a batch."""
    return {"slab_ms": cuda_ms(torch, slab, reps), **_kernel_split(torch, run)}


def phase_timing_stream(torch, x, cfg, pools, stream_inputs, reps,
                        global_inputs):
    """B6 f32 and int8 per batch at the 16,384-row evaluation set (a
    fourth batch against the state three batches in, so the window and
    the levels are live), the slot update that follows it (scatter_slots
    into the (1, 72, 200, 12,288) slots three batches in), and B2q at the
    stochastic leaf shape; then B6 f32 at the whole-stream shape (100,000
    evaluation rows) and on bitmaps at 8,192 words, from
    parity_stream_global's states. Each beside its bound (the work this
    batch's data needs: its live decisions, its admitted rows, counted
    along the plain version's path), its plain version and nothing a
    single library call computes; the feature rows with their slab /
    decision split, launches a batch and the device-memory tier's time.
    The ground's norms are computed once, as the streamer does."""
    from repro_torch.core.greedyml import LaneSampler
    from repro_torch.kernels import ops, parity
    from repro_torch.kernels import pairwise as P
    from repro_torch.kernels import ref as TRef
    from repro_torch.kernels import rules as R
    from repro_torch.kernels import stream_filter as TS
    ground, st, (sids, pay, valid, _), slots = stream_inputs
    rule = R.DIST_MIN
    k, eps_log = cfg.k, math.log1p(STREAM_EPS)
    n, d = ground.shape
    levels, b = st[0].shape[1], pay.shape[0]
    arr, bv = pay[None], valid[None]
    plain = TS.stream_filter_plain(ground, arr, *st[:6], bv, k, eps_log,
                                   rule)
    mat_k = torch.empty(1, b, n, device=x.device)
    got = TS.stream_filter(ground, arr, *st[:6], bv, k, eps_log, rule,
                           scratch=mat_k)
    cmp = parity.compare_stream(got, plain, mat_k,
                                TRef.pairwise(ground, arr, rule),
                                st[:6] + (None,), bv, k, eps_log, rule)
    q, scale = ops.quantize_ground(ground)
    gscale = scale.reshape(-1).contiguous()
    out = {}
    f32_gnorm = TS.ground_norms(ground)
    for tag, g, kw, item in (
            ("", ground, {"gnorm": f32_gnorm}, 4.0),
            ("[int8]", q, {"gscale": gscale,
                           "gnorm": TS.ground_norms(q, gscale)}, 1.0)):
        bms, by = _b6_bound(n, b, d, levels, cmp["decisions"],
                            cmp["admitted"], item)

        def run(g=g, kw=kw):
            return TS.stream_filter(g, arr, *st[:6], bv, k, eps_log, rule,
                                    **kw)

        def slab(g=g, kw=kw):
            return TS.stream_slab(g, arr, st[1], rule, **kw)

        out["stream_filter" + tag] = {
            "shape": [1, levels, n, b, d], "decisions": cmp["decisions"],
            "admitted": cmp["admitted"],
            "ms": cuda_ms(torch, run, reps),
            "plain_ms": cuda_ms(
                torch, lambda g=g, kw=kw: TS.stream_filter_plain(
                    g, arr, *st[:6], bv, k, eps_log, rule,
                    gscale=kw.get("gscale")), 1),
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            **_feature_split(torch, run, slab, reps)}
    f32 = out["stream_filter"]
    # the slab, the singletons and the window alone: the same call with
    # every arrival invalid, so no level makes a decision
    none = torch.zeros_like(bv)
    f32["no_live_decision_ms"] = cuda_ms(
        torch, lambda: TS.stream_filter(ground, arr, *st[:6], none, k,
                                        eps_log, rule, gnorm=f32_gnorm),
        reps)
    with _device_memory_tier():
        f32["device_memory_tier_ms"] = cuda_ms(
            torch, lambda: TS.stream_filter(ground, arr, *st[:6], bv, k,
                                            eps_log, rule, gnorm=f32_gnorm),
            reps)
    del q, scale, gscale
    # the slot update after this batch (repeated in place: the same rows
    # land in the same slots): the admitted rows read once an arrival
    # and written once a slot, expired levels' slots cleared
    sargs = (st[3], plain[6], plain[3], sids[None], arr, k)
    admitted = int(plain[3].sum())
    arrivals = int(plain[3].any(1).sum())
    expired = int(plain[6].sum())
    row_bytes = 4.0 * d + 8.0
    bms, by = bound(0.0, row_bytes * (arrivals + admitted + expired * k)
                    + levels * (b + 5.0))
    out["scatter_slots"] = {
        "shape": [1, levels, k, d], "admitted": admitted,
        "expired_levels": expired,
        "ms": cuda_ms(torch, lambda: TS.scatter_slots(*slots, *sargs), reps),
        "plain_ms": cuda_ms(torch, lambda: TS.scatter_slots_plain(
            *slots, *sargs), 3),
        "library_ms": None, "bound_ms": bms, "bound_by": by}
    del slots
    _, lpay, lvalid = pools
    lanes, nl, _ = lpay.shape
    gq, gs = ops.quantize_ground(lpay)
    row = R.empty_row(lpay, lvalid, rule).contiguous()
    c = sample_size(nl, k)
    idx = LaneSampler(cfg.seed)(0, lanes, 1, nl, c)[:, 0].to(x.device)
    cands = torch.gather(lpay, 1, idx[..., None].expand(lanes, c, d))
    cands = cands.contiguous()
    cv = torch.ones(lanes, c, dtype=torch.bool, device=x.device)
    gnorm, f32_gnorm = P.ground_norms(gq, gs), P.ground_norms(lpay)
    # as the f32 row: the ground's norms are the greedy's (norms_ms)
    flops = (2.0 * lanes * nl * c * d + 2.0 * lanes * c * d
             + 5.0 * lanes * nl * c)
    nbytes = (lanes * nl * d + 4.0 * (lanes * nl + lanes * c * d
                                      + 2 * lanes * nl + lanes * c))
    bms, by = bound(flops, nbytes)
    out["gains[int8]"] = {
        "shape": [lanes, nl, c, d],
        "ms": cuda_ms(torch, lambda: P.gains(gq, row, cands, cv, rule,
                                             gscale=gs, gnorm=gnorm), reps),
        "norms_ms": cuda_ms(torch, lambda: P.ground_norms(gq, gs), reps),
        "f32_kernel_ms": cuda_ms(torch, lambda: P.gains(
            lpay, row, cands, cv, rule, gnorm=f32_gnorm), reps),
        "plain_ms": cuda_ms(torch, lambda: P.gains_plain(
            gq, row, cands, cv, rule, gs), reps),
        "library_ms": None, "bound_ms": bms, "bound_by": by}
    del gq, gs, gnorm, f32_gnorm, row, cands
    out.update(_timing_stream_global(torch, x, cfg, global_inputs, reps))
    emit({"phase": "timing_stream", **out})
    return out


def _bits_row(torch, arr, st, bv, k, eps_log, levels, w, b, admitted, reps):
    """A bitmap stream-filter batch's timing row: ms on the planned tier
    and on the device-memory tier (forced), the singleton pass and the
    window alone (every arrival invalid), the kernels' split and
    launches a batch, beside the bytes bound and the plain version."""
    from repro_torch.kernels import plans
    from repro_torch.kernels import rules as R
    from repro_torch.kernels import stream_filter as TS

    def run(valid=bv):
        return TS.stream_filter(None, arr, *st, valid, k, eps_log, R.BITS_OR)

    nbytes = 4.0 * (b * w + 2 * levels * w + 2 * levels) + levels * b + b
    row = {"tier": plans.stream_tier(w, b, R.BITS_OR),
           "shape": [1, levels, w, b], "admitted": admitted,
           "ms": cuda_ms(torch, run, 20 * reps),
           "plain_ms": cuda_ms(torch, lambda: TS.stream_filter_plain(
               None, arr, *st, bv, k, eps_log, R.BITS_OR), 1),
           "library_ms": None, "bound_ms": nbytes / PEAK_HBM_BYTES * 1e3,
           "bound_by": "bytes",
           "no_live_decision_ms": cuda_ms(
               torch, lambda: run(torch.zeros_like(bv)), 20 * reps)}
    with _device_memory_tier():
        row["device_memory_tier_ms"] = cuda_ms(torch, run, 20 * reps)
    row.update(_kernel_split(torch, run))
    return row


def _timing_stream_global(torch, x, cfg, global_inputs, reps):
    """timing_stream's rows beyond one block's shared memory: B6 f32 per
    batch against all n evaluation rows (a level's row over a cluster of
    8; and with every arrival invalid: the slab, singletons and window
    alone), and on bitmaps at 8,192 words."""
    from repro_torch.kernels import parity, plans
    from repro_torch.kernels import ref as TRef
    from repro_torch.kernels import rules as R
    from repro_torch.kernels import stream_filter as TS
    (st, (_, pay, valid, _), gnorm), (bst, barr, k_bits) = global_inputs
    rule, k, eps_log = R.DIST_MIN, cfg.k, math.log1p(STREAM_EPS)
    n, d = x.shape
    levels, b = st[0].shape[1], pay.shape[0]
    arr, bv = pay[None], valid[None]
    plain = TS.stream_filter_plain(x, arr, *st[:6], bv, k, eps_log, rule)
    mat_k = torch.empty(1, b, n, device=x.device)
    got = TS.stream_filter(x, arr, *st[:6], bv, k, eps_log, rule,
                           scratch=mat_k, gnorm=gnorm)
    cmp = parity.compare_stream(got, plain, mat_k,
                                TRef.pairwise(x, arr, rule),
                                st[:6] + (None,), bv, k, eps_log, rule,
                                what="stream_filter, 100,000 rows")
    del got, plain, mat_k
    bms, by = _b6_bound(n, b, d, levels, cmp["decisions"], cmp["admitted"])

    def run(valid=bv):
        return TS.stream_filter(x, arr, *st[:6], valid, k, eps_log, rule,
                                gnorm=gnorm)

    out = {"stream_filter_100000": {
        "tier": plans.stream_tier(n, b, rule),
        "shape": [1, levels, n, b, d],
        "decisions": cmp["decisions"], "admitted": cmp["admitted"],
        "ms": cuda_ms(torch, run, reps),
        "no_live_decision_ms": cuda_ms(
            torch, lambda: run(torch.zeros_like(bv)), reps),
        "plain_ms": cuda_ms(torch, lambda: TS.stream_filter_plain(
            x, arr, *st[:6], bv, k, eps_log, rule), 1),
        "library_ms": None, "bound_ms": bms, "bound_by": by,
        **_feature_split(torch, run, lambda: TS.stream_slab(
            x, arr, st[1], rule, gnorm=gnorm), reps)}}
    with _device_memory_tier():
        out["stream_filter_100000"]["device_memory_tier_ms"] = cuda_ms(
            torch, run, reps)
    blevels, w = bst[0].shape[1], barr.shape[2]
    ball = torch.ones(1, b, dtype=torch.bool, device=x.device)
    bplain = TS.stream_filter_plain(None, barr, *bst, ball, k_bits, eps_log,
                                    R.BITS_OR)
    out["stream_filter[coverage]_8192"] = _bits_row(
        torch, barr, bst, ball, k_bits, eps_log, blevels, w, b,
        int(bplain[3].sum()), reps)
    return out


def phase_parity_stream_coverage(torch, words, cfg):
    """B6 on bitmaps at the kcover stream's shape (L = 56 levels, W =
    1,290 words, B = 256), three chained batches of shuffled sets, with
    and without knapsack costs (budget 40), then the window's 5 stacked
    checkpoints (one batch for all) and the continuous mode's 4 lanes
    (64 arrivals each): every output equal bit for bit to the plain
    version, and the slot update (scatter_slots) equal to the
    reference's one-hot formula. Returns the largest |kernel − plain|
    (0 when every bit agrees)."""
    from repro_torch.kernels import parity
    from repro_torch.kernels import rules as R
    from repro_torch.kernels import stream_filter as TS
    from repro_torch.streaming import num_levels
    k, b = cfg.k, STREAM_BATCH
    levels = num_levels(k, STREAM_EPS)
    eps_log = math.log1p(STREAM_EPS)
    w = words.shape[1]
    row0 = torch.zeros(w, dtype=R.WORD_DTYPE, device=words.device)
    costs = torch.as_tensor(knapsack_costs(cfg.n, cfg.seed),
                            device=words.device)
    batches = _stream_batches(torch, words, 3, b, cfg.seed + 1, costs)
    out, err = {}, 0.0
    for case, lanes, split in (("single", 1, 1), ("knapsack", 1, 1),
                               ("window", 1 + WINDOW // STRIDE, 1),
                               ("continuous", CONTINUOUS_LANES,
                                CONTINUOUS_LANES)):
        cost = case == "knapsack"
        st = _stream_state(torch, R.BITS_OR, levels, row0, cost, lanes)
        ids0 = torch.full((lanes, levels, k), -1, dtype=torch.int64,
                          device=words.device)
        pay0 = torch.zeros(lanes, levels, k, w, dtype=R.WORD_DTYPE,
                           device=words.device)
        res = {"entries": 0, "differing": 0, "admitted": 0}
        for ids, pay, valid, c in batches:
            arr = pay.reshape(split, b // split, w)
            bv = valid.reshape(split, -1)
            kw = (dict(costs=c[None], spent=st[6], budget=BUDGET_KCOVER)
                  if cost else {})
            got = TS.stream_filter(None, arr, *st[:6], bv, k, eps_log,
                                   R.BITS_OR, **kw)
            plain = TS.stream_filter_plain(None, arr, *st[:6], bv, k,
                                           eps_log, R.BITS_OR, **kw)
            r = parity.compare_exact(got, plain,
                                     f"stream_filter[coverage] {case}")
            bids = ids.reshape(split, -1)
            want = TS.scatter_slots_plain(ids0, pay0, st[3], plain[6],
                                          plain[3], bids, arr, k)
            ids0, pay0 = TS.scatter_slots(ids0, pay0, st[3], plain[6],
                                          plain[3], bids, arr, k)
            parity.compare_exact((ids0, pay0), want, f"scatter_slots {case}")
            res["entries"] += r["entries"]
            res["differing"] += r["differing"]
            res["admitted"] += int(plain[3].sum())
            err = max(err, r["max_abs_err"])
            st = _next_state(plain, row0, cost)
        res["shape"] = [lanes, levels, w, b // split]
        out[case] = res
    emit({"phase": "parity_stream_coverage", "rule": "exact (bit for bit)",
          **out})
    return {"stream_filter[coverage]": err}


def phase_stream_kcover(torch, words, cfg, root_value):
    """stream_select('kcover') over all 990,002 sets shuffled with the
    config seed: k = 64, ε = 0.1 (L = 56), B = 256 (3,868 batches, one
    stream_filter[coverage] launch each); the value must reach (½ − ε)
    of kcover_run's root value (for coverage the root value is the
    global value)."""
    from repro_torch.core.simulate import global_value
    sol, ids, rep = _stream_run(torch, "kcover", words, cfg, cfg.k)
    gv = global_value("kcover", words, ids)
    assert gv == float(sol.value), (gv, float(sol.value))
    assert gv >= (0.5 - STREAM_EPS) * root_value, (gv, root_value)
    emit({"phase": "stream_kcover", "universe": cfg.universe,
          "words": int(words.shape[1]), **rep, "global_value": gv,
          "root_value": root_value, "ratio_to_root": gv / root_value})
    return rep["launches"]


def _kcover_stream(torch, words, cfg):
    from repro_torch.data.synthetic import Stream
    order = np.random.default_rng(cfg.seed).permutation(words.shape[0])
    return Stream(words, order, STREAM_BATCH), order


def phase_stream_kcover_knapsack(torch, words, cfg):
    """Knapsack streaming over the same stream: a SieveStreamer with
    budget 40 and the kcover_knapsack costs (uniform(0.5, 2) by global
    id) per arrival, one stream_filter[coverage] launch a batch in cost
    mode; spent ≤ 40 at every level."""
    from repro_torch.core.functions import make_objective
    from repro_torch.kernels import counters
    from repro_torch.streaming import SieveStreamer
    obj = make_objective("kcover", universe=cfg.universe,
                         device=words.device)
    costs = torch.as_tensor(knapsack_costs(cfg.n, cfg.seed),
                            device=words.device)
    stream, _ = _kcover_stream(torch, words, cfg)
    streamer = SieveStreamer(obj, cfg.k, STREAM_EPS, budget=BUDGET_KCOVER)
    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = streamer.init()
    batches = 0
    for ids, pay, valid in stream:
        state = streamer.process_batch(state, ids, pay, valid,
                                       costs=costs[ids])
        batches += 1
    sol = streamer.solution(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c["launches"] for n, c in counters.snapshot().items()
                if c["launches"]}
    assert launches.get("stream_filter[coverage]") == batches, launches
    spent = state.spent.cpu().numpy()
    assert (spent <= BUDGET_KCOVER).all(), spent
    ids = sol.ids[sol.valid].cpu().numpy()
    sel_cost = float(costs[torch.as_tensor(ids, device=words.device)].sum())
    assert sel_cost <= BUDGET_KCOVER + 1e-4, sel_cost
    emit({"phase": "stream_kcover_knapsack", "budget": BUDGET_KCOVER,
          "batches": batches, "cost_mode_launches": batches,
          "wall_seconds": wall,
          "arrivals_per_second": cfg.n / wall, "launches": launches,
          "accepted": len(ids), "value": float(sol.value),
          "spent_best_level": sel_cost, "spent_max": float(spent.max()),
          "digest": _digest(ids, sol.value)})
    return launches


def phase_window_kcover(torch, words, cfg):
    """SlidingSieve over the kcover stream: window 262,144, stride 65,536
    (5 checkpoints, one stream_filter[coverage] launch a batch for all);
    at every stride boundary the query's ids all arrived within the last
    262,144 arrivals."""
    from repro_torch.core.functions import make_objective
    from repro_torch.kernels import counters
    from repro_torch.streaming import SieveStreamer, SlidingSieve
    obj = make_objective("kcover", universe=cfg.universe,
                         device=words.device)
    stream, order = _kcover_stream(torch, words, cfg)
    pos = np.empty(cfg.n, np.int64)
    pos[order] = np.arange(cfg.n)
    win = SlidingSieve(SieveStreamer(obj, cfg.k, STREAM_EPS), WINDOW, STRIDE)
    last = None
    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ws = win.init()
    batches, queries, values = 0, 0, []
    for ids, pay, valid in stream:
        ws = win.process_batch(ws, ids, pay, valid)
        batches += 1
        if ws.seen % STRIDE == 0 or ws.seen >= cfg.n:
            sol = win.query(ws)
            got = sol.ids[sol.valid].cpu().numpy()
            assert (pos[got] >= min(ws.seen, cfg.n) - WINDOW).all(), (
                ws.seen, pos[got].min())
            queries += 1
            values.append(float(sol.value))
            last = _digest(got, sol.value)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c["launches"] for n, c in counters.snapshot().items()
                if c["launches"]}
    assert launches.get("stream_filter[coverage]") == batches, launches
    emit({"phase": "window_kcover", "window": WINDOW, "stride": STRIDE,
          "checkpoints": win.n_ckpt, "batches": batches,
          "queries_checked": queries, "wall_seconds": wall,
          "arrivals_per_second": cfg.n / wall, "launches": launches,
          "query_values": values, "digest": last})
    return launches


def phase_continuous_kcover(torch, words, cfg):
    """stream_select_continuous over the kcover stream: 4 lanes, b = 2, a
    merge every 256 batches (15 merges + the tail's), one
    stream_filter[coverage] launch a batch for all lanes, the merge
    nodes on the resident bitmap loop; the merged values never
    decrease. Then the same stream again under torch.profiler: its
    device time, and that over the untraced wall (the busy share)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.functions import make_objective
    from repro_torch.kernels import counters
    from repro_torch.streaming import stream_select_continuous
    obj = make_objective("kcover", universe=cfg.universe,
                         device=words.device)
    stream, _ = _kcover_stream(torch, words, cfg)

    def run():
        return stream_select_continuous(
            obj, stream, cfg.k, lanes=CONTINUOUS_LANES, branching=2,
            merge_every=MERGE_EVERY, eps=STREAM_EPS)

    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol, info = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c["launches"] for n, c in counters.snapshot().items()
                if c["launches"]}
    assert launches.get("stream_filter[coverage]") == info["batches"]
    assert launches.get("greedy_loop_resident[coverage]", 0) >= len(
        info["merges"]), launches
    merges = info["merges"]
    assert all(b >= a for a, b in zip(merges, merges[1:])), merges
    assert info["tier"] == "kernel", info
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device_ms = sum(us for _, _, us in _cuda_events(torch, prof)) / 1e3
    seen = device_ms > 0
    emit({"phase": "continuous_kcover", "lanes": CONTINUOUS_LANES,
          "branching": 2, "merge_every": MERGE_EVERY, **info,
          "wall_seconds": wall, "arrivals_per_second": cfg.n / wall,
          "device_ms": device_ms if seen else "not measured",
          "busy_share": device_ms / (wall * 1e3) if seen else
          "not measured",
          "launches": launches, "value": float(sol.value),
          "digest": _digest(sol.ids[sol.valid].cpu().numpy(), sol.value)})
    return launches


def phase_timing_stream_coverage(torch, words, cfg, reps):
    """B6 on bitmaps per batch at the kcover stream's shape, from the
    state three batches in, beside its bound — the bytes it must move
    (the arrivals' words, the rows in and out) and its integer
    operations (a popcount pass a live arrival and admission), far below
    the card's integer rate — and its plain version; its admitted count,
    its kernels' split, and the device-memory tier's time (forced)."""
    from repro_torch.kernels import rules as R
    from repro_torch.kernels import stream_filter as TS
    from repro_torch.streaming import num_levels
    k, b = cfg.k, STREAM_BATCH
    levels = num_levels(k, STREAM_EPS)
    eps_log = math.log1p(STREAM_EPS)
    w = words.shape[1]
    row0 = torch.zeros(w, dtype=R.WORD_DTYPE, device=words.device)
    batches = _stream_batches(torch, words, 4, b, cfg.seed + 2)
    st = _stream_state(torch, R.BITS_OR, levels, row0, False)
    for _, pay, valid, _ in batches[:3]:
        st = _next_state(TS.stream_filter(None, pay[None], *st, valid[None],
                                          k, eps_log, R.BITS_OR), row0,
                         False)
    _, pay, valid, _ = batches[3]
    arr, bv = pay[None], valid[None]
    plain = TS.stream_filter_plain(None, arr, *st, bv, k, eps_log, R.BITS_OR)
    out = {"stream_filter[coverage]": _bits_row(
        torch, arr, st, bv, k, eps_log, levels, w, b, int(plain[3].sum()),
        reps)}
    emit({"phase": "timing_stream_coverage", **out})
    return out


def phase_stream_idle(torch, name, data, cfg, k, ground=None,
                      warm: int = 5, batches: int = 20):
    """The device's busy share in stream_select's loop: after `warm`
    batches, `batches` batches traced with torch.profiler (the device
    time of every kernel), then the next `batches` untraced on the host
    clock (ending in a synchronize; the trace's own host cost left out):
    the busy share is the traced device time a batch over the untraced
    wall a batch, the rest the host's gap."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.functions import make_objective
    from repro_torch.data.synthetic import Stream
    from repro_torch.streaming import SieveStreamer
    obj = make_objective(name, universe=cfg.universe, device=data.device)
    order = np.random.default_rng(cfg.seed).permutation(data.shape[0])
    it = iter(Stream(data, order, STREAM_BATCH))
    streamer = SieveStreamer(obj, k, STREAM_EPS, ground=ground)
    state = None
    for _ in range(warm):
        ids, pay, valid = next(it)
        if state is None:
            state = streamer.init(pay)
        state = streamer.process_batch(state, ids, pay, valid)
    traced = [next(it) for _ in range(batches)]
    timed = [next(it) for _ in range(batches)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for ids, pay, valid in traced:
            state = streamer.process_batch(state, ids, pay, valid)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ids, pay, valid in timed:
        state = streamer.process_batch(state, ids, pay, valid)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / batches
    busy, kernels = 0.0, {}
    for kernel, count, us in _cuda_events(torch, prof):
        busy += us / 1e3 / batches
        kernels[kernel[:48]] = {"launches_per_batch": count / batches,
                                "ms_per_batch": us / 1e3 / batches}
    seen = bool(kernels) and busy > 0
    emit({"phase": "stream_idle", "stream": name, "batches": batches,
          "wall_ms_per_batch": wall,
          "device_busy_ms_per_batch": busy if seen else "not measured",
          "busy_share": busy / wall if seen else "not measured",
          "host_gap_ms_per_batch": wall - busy if seen else "not measured",
          "kernel_split": kernels})


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.paper_kcover import KOSARAK, KOSARAK_AVG_SIZE
    from repro_torch.configs.paper_kdom import CONFIG as KDOM
    from repro_torch.configs.paper_kmedoid import TINY_IMAGENET
    from repro_torch.data.synthetic import gen_images_on
    from repro_torch.kernels import counters
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TINY_IMAGENET
    dev = torch.device("cuda")
    phase_build()
    t0 = time.perf_counter()
    x = gen_images_on(args.n, cfg.feature_dim, classes=20, seed=args.seed,
                      device=dev)
    torch.cuda.synchronize()
    emit({"phase": "data", "n": args.n, "d": cfg.feature_dim,
          "gigabytes": x.numel() * 4 / 1e9,
          "seconds": time.perf_counter() - t0})
    pools = lane_pools(torch, x, cfg.num_machines, cfg.seed)
    errs = phase_parity(torch, x, cfg, cfg.seed)
    errs.update(phase_parity_steps(torch, x, cfg, pools))
    errs.update(phase_parity_quant(torch, x, cfg, pools))
    stream_errs, stream_inputs = phase_parity_stream(torch, x, cfg, pools)
    errs.update(stream_errs)
    global_errs, global_inputs = phase_parity_stream_global(torch, x, cfg,
                                                            KOSARAK.k)
    phase_reference(torch)
    phase_reference_dispatch(torch)
    phase_reference_stream(torch)
    launches, f32_run = phase_run(torch, x, cfg)
    for dtype in QUANT:
        _add(launches, phase_run_quant(torch, x, cfg, dtype, f32_run))
    launches["fused_step"] = phase_knapsack(torch, x, cfg, pools)[
        "fused_step"]
    for dtype in QUANT:
        _add(launches, phase_knapsack_quant(torch, x, cfg, pools, dtype))
    launches["gains"] = phase_stochastic(torch, x, cfg, pools)["gains"]
    _add(launches, phase_stochastic_int8(torch, x, cfg, pools))
    stream_launches, stream_ratio = phase_stream_kmedoid(
        torch, x, cfg, x, f32_run[0])
    _add(launches, stream_launches)
    phase_stream_idle(torch, "kmedoid", x, cfg, cfg.k, ground=x)
    _add(launches, phase_stream_kmedoid(torch, x, cfg, stream_inputs[0],
                                        f32_run[0], "int8", stream_ratio)[0])
    times = phase_timing(torch, x, cfg, cfg.seed, args.reps)
    times.update(phase_timing_steps(torch, x, cfg, pools, args.reps))
    times.update(phase_timing_quant(torch, x, cfg, pools, args.reps))
    times.update(phase_timing_stream(torch, x, cfg, pools, stream_inputs,
                                     args.reps, global_inputs))
    # the coverage problems: the k-medoid tensors go first
    del x, pools, stream_inputs, global_inputs
    gc.collect()
    torch.cuda.empty_cache()
    phase_timing_fused_global(torch, cfg, args.reps)
    kc = KOSARAK
    bits, words = phase_data_kcover(torch, kc, KOSARAK_AVG_SIZE, dev)
    kpools = lane_pools(torch, words, kc.num_machines, kc.seed)
    errs.update(phase_parity_coverage(torch, words, kc, kpools))
    tree_launches, kcover_root = _coverage_tree(torch, "kcover", bits, words,
                                                kc, "kcover_run")
    launches.update(tree_launches)
    launches["fused_step[coverage]"] = phase_kcover_knapsack(
        torch, words, kc, kpools)["fused_step[coverage]"]
    launches["gains[coverage]"] = phase_kcover_stochastic(
        torch, words, kc, kpools)["gains[coverage]"]
    times.update(phase_timing_coverage(torch, words, kc, kpools, args.reps))
    del kpools
    errs.update(phase_parity_stream_coverage(torch, words, kc))
    _add(launches, phase_stream_kcover(torch, words, kc, kcover_root))
    phase_stream_idle(torch, "kcover", words, kc, kc.k)
    _add(launches, phase_stream_kcover_knapsack(torch, words, kc))
    _add(launches, phase_window_kcover(torch, words, kc))
    _add(launches, phase_continuous_kcover(torch, words, kc))
    times.update(phase_timing_stream_coverage(torch, words, kc, args.reps))
    del bits, words
    gc.collect()
    torch.cuda.empty_cache()
    _, kdom_errs = phase_kdom_run(torch, KDOM, dev)
    for name, err in [*kdom_errs.items(), *global_errs.items()]:
        errs[name] = max(errs[name], err)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    kernels = []
    for name in SOURCES:
        assert launches.get(name, 0) > 0, (name, launches)
        t = times[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": launches[name],
                        "max_abs_err": errs[name], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    counters.reset()
    print(smi.splitlines()[0], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
