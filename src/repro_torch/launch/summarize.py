"""Standalone GreedyML driver for the paper's own problems (answers
`src/repro/launch/summarize.py`).

    PYTHONPATH=src python -m repro_torch.launch.summarize \\
        --problem paper-kcover --machines 8 --branching 2 --compare

Runs GreedyML on a synthetic instance of the configured problem
(`configs/registry.py::PROBLEMS`) and optionally compares it against
RandGreedi and the sequential Greedy (quality and critical-path call
counts): the paper's Table 3 row for one dataset. ``--engine dense``
runs the tree on the kernels (`core/simulate.py::run_tree_dense`),
``lazy`` on Minoux's lazy greedy (`run_tree_lazy`; coverage on the
host). ``--device`` (default ``cuda``; ``cpu`` runs the plain path)
places the dense engine and the lazy k-medoid state; without a GPU,
``cuda`` raises. The printed lines keep the reference's format, so the
two CLIs' outputs compare line for line.
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def build_instance(pcfg):
    """(sparse, dense) data of a problem: adjacency lists and their
    packed bitmaps for coverage, the features twice for k-medoid and
    facility — the reference's generators, from the config's seed."""
    from repro_torch.data import synthetic
    if pcfg.objective == "kcover":
        sets = synthetic.gen_kcover(pcfg.n, pcfg.universe, seed=pcfg.seed)
        return sets, synthetic.pack_bitmaps(sets, pcfg.universe)
    if pcfg.objective == "kdom":
        sets = synthetic.gen_graph_road(pcfg.n, seed=pcfg.seed)
        return sets, synthetic.pack_bitmaps(sets, pcfg.universe)
    if pcfg.objective in ("kmedoid", "facility"):
        x = synthetic.gen_images(pcfg.n, pcfg.feature_dim, seed=pcfg.seed)
        return x, x
    raise KeyError(pcfg.objective)


def main(argv=None) -> None:
    from repro_torch.configs import registry

    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="paper-kcover",
                    choices=sorted(registry.PROBLEMS))
    ap.add_argument("--machines", type=int, default=0)
    ap.add_argument("--branching", type=int, default=0)
    ap.add_argument("--k", type=int, default=0)
    ap.add_argument("--engine", default="dense", choices=["dense", "lazy"])
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.core.simulate import (run_greedy_dense, run_greedy_lazy,
                                           run_tree_dense, run_tree_lazy)
    from repro_torch.core.tree import AccumulationTree, randgreedi_tree
    from repro_torch.runtime.device import resolve_device

    device = resolve_device(None if args.device == "cuda" else args.device)
    pcfg = registry.PROBLEMS[args.problem]
    if args.machines:
        pcfg = dataclasses.replace(pcfg, num_machines=args.machines)
    if args.branching:
        pcfg = dataclasses.replace(pcfg, branching=args.branching)
    if args.k:
        pcfg = dataclasses.replace(pcfg, k=args.k)

    sparse, dense = build_instance(pcfg)
    tree = AccumulationTree(pcfg.num_machines, pcfg.branching)
    dense_kw = dict(seed=pcfg.seed, universe=pcfg.universe,
                    augment=pcfg.augment, device=device)

    t0 = time.perf_counter()
    if args.engine == "dense":
        res = run_tree_dense(pcfg.objective, dense, pcfg.k, tree, **dense_kw)
    else:
        res = run_tree_lazy(pcfg.objective, sparse, pcfg.k, tree, **dense_kw)
    dt = time.perf_counter() - t0
    print(f"GreedyML  T(m={res.machines}, L={res.levels}, b={res.branching}) "
          f"f={res.value:.2f} crit-calls={res.evals_critical} "
          f"comm={res.comm_elements} [{dt:.1f}s]", flush=True)

    if args.compare:
        rg = (run_tree_dense if args.engine == "dense" else run_tree_lazy)(
            pcfg.objective, dense if args.engine == "dense" else sparse,
            pcfg.k, randgreedi_tree(pcfg.num_machines), **dense_kw)
        g = (run_greedy_dense(pcfg.objective, dense, pcfg.k,
                              universe=pcfg.universe, device=device)
             if args.engine == "dense" else
             run_greedy_lazy(pcfg.objective, sparse, pcfg.k,
                             universe=pcfg.universe, device=device))
        print(f"RandGreedi f={rg.value:.2f} crit-calls={rg.evals_critical} "
              f"comm={rg.comm_elements}")
        print(f"Greedy     f={g.value:.2f} calls={g.evals_total}")
        print(f"quality: GreedyML/Greedy = {res.value / g.value:.4f}, "
              f"RandGreedi/Greedy = {rg.value / g.value:.4f}", flush=True)


if __name__ == "__main__":
    main()
