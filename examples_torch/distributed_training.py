"""End-to-end driver example on the PyTorch port: train a reduced LM for
a few hundred steps with GreedyML coreset selection, checkpointing, and
an injected failure + recovery — the whole production loop on one card
(`--device cpu` on the CPU). The port's counterpart of
`examples/distributed_training.py`.

    PYTHONPATH=src python examples_torch/distributed_training.py [--arch ...]

Checkpoints go to ``--ckpt-dir`` (default: ``repro_torch_example_train``
under the temporary directory, emptied first and kept after the run).
"""
import argparse
import os
import shutil
import tempfile

from repro_torch.launch import train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=75,
                    help="the step at which a failure is injected")
    ap.add_argument("--selection-k", type=int, default=128)
    ap.add_argument("--corpus-docs", type=int, default=256)
    args = ap.parse_args(argv)

    ckpt = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                         "repro_torch_example_train")
    shutil.rmtree(ckpt, ignore_errors=True)

    out = train.main([
        "--arch", args.arch, "--smoke",
        "--steps", str(args.steps),
        "--ckpt-every", str(args.ckpt_every),
        "--ckpt-dir", ckpt,
        "--fail-at", str(args.fail_at),    # prove checkpoint/restart works
        "--data-selection", "greedyml:facility",
        "--selection-k", str(args.selection_k),
        "--corpus-docs", str(args.corpus_docs),
        "--lr", "1e-3",
        "--device", args.device,
    ])
    print("\nrecovered from the injected failure and finished — "
          "see checkpoints under", ckpt)
    out["ckpt_dir"] = ckpt
    return out


if __name__ == "__main__":
    main()
