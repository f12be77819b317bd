"""Surgical probe refresh (answers `src/repro/launch/reprobe.py`): re-run
the cost probes (flops / collective / bytes fits) of dry-run cells
already in their JSONs and merge them in — no full pass is re-run when
only the probe schema changed.

    PYTHONPATH=src python -m repro_torch.launch.reprobe \
        [--out results/dryrun_torch] [--only arch:shape] [--force]

The single-mesh cells are probed in one fake world of 256 ranks
(`launch/dryrun.py`); a technique cell re-runs its direct count on
``--device`` (the card by default).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import time

from repro_torch.launch import dryrun as DR


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--only", default="")
    ap.add_argument("--force", action="store_true",
                    help="re-probe even if bytes_accessed already present")
    ap.add_argument("--device", default="cuda",
                    help="the technique cells' device")
    args = ap.parse_args(argv)

    with DR.fake_world(DR.MESH_DEVICES["single"]):
        mesh = DR.production_mesh("single")
        for path in sorted(glob.glob(os.path.join(args.out,
                                                  "*__single.json"))):
            with open(path) as f:
                rec = json.load(f)
            if not rec.get("ok"):
                continue
            key = f"{rec['arch']}:{rec['shape']}"
            if args.only and args.only not in (rec["arch"], key):
                continue
            if (not args.force and
                    rec.get("estimated", {}).get("bytes_accessed")):
                continue
            t0 = time.time()
            try:
                if rec["arch"] in DR.TECHNIQUE_CELLS:
                    est = DR.technique_estimate(DR.run_technique(
                        rec["arch"], "single", args.device))
                else:
                    est = DR.probe_lm_cell(rec["arch"], rec["shape"], mesh,
                                           rec["devices"])
                rec["estimated"] = est
                rec["probe_s"] = round(time.time() - t0, 1)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"[re-probed] {key:45s} flops={est['flops']:.3e} "
                      f"bytes={est['bytes_accessed']:.3e} "
                      f"({rec['probe_s']:.0f}s)", flush=True)
            except Exception as e:  # noqa: BLE001
                print(f"[probe-fail] {key}: {e}", flush=True)


if __name__ == "__main__":
    main()
