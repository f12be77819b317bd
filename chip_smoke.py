#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of GreedyML (src/repro_torch) on one GPU.

    python3 chip_smoke.py [--n 100000] [--seed 13]

Phases, each printing one JSON line; a failed phase raises and the
script exits non-zero:

  build      compile the three CUDA kernels (one nvcc per source, in
             parallel) and report their register/shared-memory use
  data       draw the Tiny-ImageNet-shaped k-medoid data on the card
             (n × 12,288 f32, the gen_images mixture recipe)
  parity     every kernel against its plain PyTorch version on the card,
             at the run's own shapes (the first leaf's pool, a level's
             16 node pools), for every feature rule
  reference  a small tree through the kernels against the same tree
             through the plain CPU path
  run        the full main path: run_tree_dense('kmedoid', …) with
             k = 200, m = 32, b = 2 (L = 5), per-level wall time and
             launches, root value and its global re-scoring
  timing     each kernel at its main-path shape beside its bound, its
             plain version and a one-call PyTorch yardstick

Then the card's name and power limit (nvidia-smi), the {"kernels": …}
line, and as the last line {"ok": true, "device": {…}}. The script
needs the repository's src/ beside it and a CUDA device; without either
it exits non-zero before printing any result. Imports nothing of JAX or
of the JAX package.
"""
from __future__ import annotations

import argparse
import json
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
}
SOURCES = {
    "pairwise": "src/repro_torch/csrc/pairwise.cu",
    "greedy_loop": "src/repro_torch/csrc/greedy_loop.cu",
    "greedy_loop_resident": "src/repro_torch/csrc/greedy_loop_resident.cu",
}


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


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=100_000,
                   help="images (Tiny-ImageNet: 100,000)")
    p.add_argument("--seed", type=int, default=13)
    p.add_argument("--reps", type=int, default=3,
                   help="timed repetitions per kernel")
    return p.parse_args(argv)


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
                 kernel's bit for bit, and its entry differences ΔM from
                 the plain matrix widen each compared gain by its
                 column's Σ_i ΔM[i, c] plus the summed row error."""
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
        plain = L.greedy_loop_resident_plain(cd, cd, row, mask, ctl, cfg.k,
                                             rule)
        diff = (built - L.resident_matrix(cd, cd, rule)).abs()
        res = parity.compare_loops(kern, plain, rule, entry_diff=diff,
                                   what=f"greedy_loop_resident {name}")
        res["max_entry_diff"] = float(diff.max())
        out["greedy_loop_resident"][name] = res
        del built, diff
    emit({"phase": "parity", "leaf_shape": [1, n_leaf, n_leaf, x.shape[1]],
          "node_shape": [nodes, bk, bk, x.shape[1]], **out})
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
                    counters.snapshot().items()}
        cpu = run_tree_dense("facility", xi, 8, AccumulationTree(8, 2),
                             seed=3, device="cpu")
    finally:
        if old is None:
            del os.environ[flags.RESIDENT_L2_MB_ENV]
        else:
            os.environ[flags.RESIDENT_L2_MB_ENV] = old
    assert all(v > 0 for v in launched.values()), launched
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


def phase_run(torch, x, cfg):
    from repro_torch.core.simulate import (global_value, partition,
                                           run_tree_dense)
    from repro_torch.core.tree import AccumulationTree
    from repro_torch.kernels import counters
    from repro_torch.kernels.plans import select_engine
    from repro_torch.kernels.rules import DIST_MIN
    tree = AccumulationTree(cfg.num_machines, cfg.branching)
    levels = []
    torch.cuda.synchronize()
    t_last = [time.perf_counter()]

    def on_level(lvl):
        torch.cuda.synchronize()
        now = time.perf_counter()
        snap = {n: c["launches"] for n, c in counters.snapshot().items()}
        levels.append({"level": lvl, "seconds": now - t_last[0],
                       "launches": snap})
        counters.reset()
        t_last[0] = time.perf_counter()

    counters.reset()
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
        "bound_ms": bms, "bound_by": by}
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
    errs = phase_parity(torch, x, cfg, cfg.seed)
    phase_reference(torch)
    launches = phase_run(torch, x, cfg)
    times = phase_timing(torch, x, cfg, cfg.seed, args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    kernels = []
    for name in ("pairwise", "greedy_loop", "greedy_loop_resident"):
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
