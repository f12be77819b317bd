"""Paper §6.4 in miniature on the PyTorch port: k-medoid exemplar
clustering speedup.

Shows why deeper accumulation trees beat RandGreedi on compute-heavy
objectives: the k-medoid accumulation cost is quadratic in node size
(k·m images at the RandGreedi root vs k·b at GreedyML interior nodes).
The port's counterpart of `examples/exemplar_clustering.py`, at its
sizes by default; the trees run on `--device` (the card by default).

    PYTHONPATH=src python examples_torch/exemplar_clustering.py
"""
import argparse
import time

from repro_torch.core.simulate import run_tree_dense
from repro_torch.core.tree import AccumulationTree, randgreedi_tree
from repro_torch.data import synthetic


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--d", type=int, default=512)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--m", type=int, default=32)
    ap.add_argument("--branching", type=int, nargs="+", default=[8, 4, 2])
    args = ap.parse_args(argv)
    n, d, k, m = args.n, args.d, args.k, args.m

    imgs = synthetic.gen_images(n, d, classes=24, seed=7)
    print(f"exemplar clustering: {n} images (d={d}), k={k}, m={m} "
          f"machines\n")

    t0 = time.time()
    rg = run_tree_dense("kmedoid", imgs, k, randgreedi_tree(m), seed=1,
                        device=args.device)
    t_rg = time.time() - t0
    print(f"RandGreedi (L=1,b={m}): f={rg.value:.4f} "
          f"crit-evals={rg.evals_critical:7d}  {t_rg:5.1f}s")

    out = {"randgreedi": rg, "greedyml": {}}
    for b in args.branching:
        tree = AccumulationTree(m, b)
        t0 = time.time()
        ml = run_tree_dense("kmedoid", imgs, k, tree, seed=1,
                            device=args.device)
        dt = time.time() - t0
        print(f"GreedyML  (L={tree.num_levels},b={b:2d}): f={ml.value:.4f} "
              f"crit-evals={ml.evals_critical:7d}  {dt:5.1f}s  "
              f"speedup {t_rg / dt:4.2f}×  quality {ml.value / rg.value:.4f}")
        out["greedyml"][b] = ml
    return out


if __name__ == "__main__":
    main()
