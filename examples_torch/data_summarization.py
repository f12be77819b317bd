"""Data summarization with the distributed GreedyML driver on the
PyTorch port.

Runs `greedyml_distributed` with one tree machine a rank of a
`torch.distributed` process group: selects k diverse exemplars from a
mixture-of-Gaussians image set with the k-medoid objective, then shows
the facility-location coreset used by the training pipeline. The port's
counterpart of `examples/data_summarization.py`, which forces 8 host
devices on one CPU: here 8 gloo ranks share the one card by default, or
``--backend nccl --ranks 4`` puts one rank on each of 4 cards. The
backend is the caller's choice; nothing switches it.

    PYTHONPATH=src python examples_torch/data_summarization.py
    PYTHONPATH=src python examples_torch/data_summarization.py \\
        --backend nccl --ranks 4
"""
import argparse
import hashlib

import numpy as np
import torch

from repro_torch.core.functions import make_objective
from repro_torch.core.greedy import greedy
from repro_torch.core.greedyml import greedyml_distributed
from repro_torch.core.simulate import global_value
from repro_torch.data import synthetic
from repro_torch.launch.mesh import local_block, make_machine_mesh
from repro_torch.launch.spawn import run_ranks

OBJECTIVES = ("kmedoid", "facility")


def ids_digest(ids) -> str:
    """sha1 of the sorted selected ids (int64): a root's fingerprint."""
    return hashlib.sha1(np.sort(np.asarray(ids, np.int64)).tobytes()
                        ).hexdigest()


def _rank(rank, imgs, k, ranks, device, backend):
    """One tree machine: its contiguous block of the images through
    greedyml_distributed for each objective; → the root (the same on
    every rank) and the mesh's axes."""
    # under NCCL run_ranks has made this rank's own card current, and the
    # mesh places the rank there itself (and checks the placement)
    mesh = make_machine_mesh(ranks, 2,
                             device=None if backend == "nccl" else device)
    out = {"axes": mesh.axis_names, "device": str(mesh.device)}
    block = torch.as_tensor(local_block(imgs, mesh)).to(mesh.device)
    n_l = block.shape[0]
    ids = torch.arange(mesh.lane * n_l, (mesh.lane + 1) * n_l,
                       device=mesh.device)
    valid = torch.ones(n_l, dtype=torch.bool, device=mesh.device)
    for name in OBJECTIVES:
        obj = make_objective(name, device=mesh.device)
        sol = greedyml_distributed(obj, ids, block, valid, k, mesh,
                                   tree_axes=mesh.level_names)
        out[name] = {"ids": sol.ids.cpu(), "valid": sol.valid.cpu(),
                     "value": float(sol.value)}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card) or 'cpu'; under NCCL each "
                         "rank takes its own card")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--ranks", type=int, default=8,
                    help="tree machines, one a rank (a power of 2)")
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--deadline", type=float, default=600.0,
                    help="seconds the ranks may take; then they are killed")
    args = ap.parse_args(argv)
    if args.backend == "nccl" and args.device != "cuda":
        raise ValueError("NCCL runs one rank on each card: pass --device "
                         f"cuda, not {args.device!r}")
    n, d, k = args.n, args.d, args.k

    print(f"k-medoid exemplar selection: {n} images, d={d}, k={k}")
    imgs = synthetic.gen_images(n, d, classes=16, seed=3)

    res = run_ranks(_rank, args.ranks,
                    args=(imgs, k, args.ranks, args.device, args.backend),
                    backend=args.backend, timeout=args.deadline)
    for r, got in enumerate(res):             # machine 0's root everywhere
        for name in OBJECTIVES:
            assert torch.equal(got[name]["ids"], res[0][name]["ids"]), (
                name, r)
            assert got[name]["value"] == res[0][name]["value"], (name, r)
    roots = {name: res[0][name] for name in OBJECTIVES}
    sel = roots["kmedoid"]["ids"][roots["kmedoid"]["valid"]].numpy()
    print(f"GreedyML over {args.ranks} ranks ({args.backend}; axes "
          f"{res[0]['axes']}): picked {len(sel)} exemplars")
    value = global_value("kmedoid", imgs, sel, device=args.device)
    print(f"  global k-medoid value: {value:.4f}")
    print(f"  root: f={roots['kmedoid']['value']!r} "
          f"ids sha1={ids_digest(sel)}")

    obj = make_objective("kmedoid", device=args.device)
    ref = greedy(obj, np.arange(n), imgs, np.ones(n, bool), k)
    ref_sel = ref.ids[ref.valid].cpu().numpy()
    seq_value = global_value("kmedoid", imgs, ref_sel, device=args.device)
    print(f"  sequential Greedy     : {seq_value:.4f}")

    # facility-location coreset (what --data-selection greedyml:facility
    # uses)
    sel_f = roots["facility"]["ids"][roots["facility"]["valid"]].numpy()
    coverage = global_value("facility", imgs, sel_f, device=args.device)
    print(f"facility-location coreset: {len(sel_f)} docs, "
          f"coverage={coverage:.4f}")
    print(f"  root: f={roots['facility']['value']!r} "
          f"ids sha1={ids_digest(sel_f)}")
    return {"roots": roots, "ranks": res, "value": value,
            "sequential_ids": ref_sel, "sequential_value": seq_value,
            "coverage": coverage, "images": imgs}


if __name__ == "__main__":
    main()
