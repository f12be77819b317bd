"""Quickstart on the PyTorch port: the paper's algorithm in a few lines.

Builds a max-k-cover instance, runs sequential Greedy, RandGreedi, and
GreedyML (accumulation tree m=8, b=2 → L=3), and compares quality and
critical-path work — the paper's Table 3 in miniature. The port's
counterpart of `examples/quickstart.py`, at its sizes by default.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

from repro_torch.core.simulate import run_greedy_lazy, run_tree_lazy
from repro_torch.core.tree import AccumulationTree, randgreedi_tree
from repro_torch.data import synthetic


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--universe", type=int, default=8192)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--m", type=int, default=8)
    args = ap.parse_args(argv)
    n, universe, k, m = args.n, args.universe, args.k, args.m

    print(f"max-{k}-cover: n={n} sets over a {universe}-item universe\n")
    sets = synthetic.gen_kcover(n, universe, seed=0, avg_size=12.0)

    greedy = run_greedy_lazy("kcover", sets, k, universe=universe,
                             device=args.device)
    print(f"Greedy      f={greedy.value:7.0f}  calls={greedy.evals_total:8d}  "
          f"(sequential baseline)")

    rg = run_tree_lazy("kcover", sets, k, randgreedi_tree(m), seed=1,
                       universe=universe, device=args.device)
    print(f"RandGreedi  f={rg.value:7.0f}  crit-path calls="
          f"{rg.evals_critical:8d}  (m={m}, single accumulation)")

    ml = run_tree_lazy("kcover", sets, k, AccumulationTree(m, 2), seed=1,
                       universe=universe, device=args.device)
    print(f"GreedyML    f={ml.value:7.0f}  crit-path calls="
          f"{ml.evals_critical:8d}  (m={m}, b=2, L={ml.levels})")

    print(f"\nquality: GreedyML/Greedy = {ml.value / greedy.value:.4f}, "
          f"GreedyML/RandGreedi = {ml.value / rg.value:.4f}")
    print(f"max elements on one accumulation node: "
          f"RandGreedi={m * k}, GreedyML={2 * k}  "
          f"(the paper's memory-bottleneck fix)")
    return {"greedy": greedy, "randgreedi": rg, "greedyml": ml}


if __name__ == "__main__":
    main()
