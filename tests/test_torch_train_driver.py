"""The port's training CLI (`python -m repro_torch.launch.train`) end to
end on the CPU, mirroring `tests/test_system.py`'s
`test_train_driver_end_to_end`, `test_training_with_selected_coreset_
converges` and `test_adafactor_trains_too` with their assertions; and
what the CLI adds here: a run that failed at step 15 and resumed from its
step-10 checkpoint ends in the same state, bit for bit, as a run that
never failed; a checkpoint restores to the state it saved; the coreset
is the reference's; ``--mesh local`` trains, ``--mesh single`` refuses;
without ``--ckpt-dir`` a run checkpoints into a fresh temporary
directory and never resumes another run's state.
"""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data import selection as JSel

from repro_torch.checkpoint import manager
from repro_torch.configs import registry
from repro_torch.configs.base import OptimConfig, ShapeConfig, TrainConfig
from repro_torch.data import pipeline, selection, synthetic
from repro_torch.launch import steps, train
from repro_torch.models import api
from repro_torch.optim.tree import leaves

ROOT = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
CLI = ["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--steps",
       "30", "--ckpt-every", "10", "--data-selection", "greedyml:facility",
       "--selection-k", "64", "--corpus-docs", "128"]


def _arrays(ckpt_dir, step):
    with np.load(os.path.join(ckpt_dir, f"step_{step:08d}",
                              "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def test_train_driver_end_to_end(tmp_path):
    """corpus → GreedyML selection → train → ckpt → injected failure →
    recovery → completion; the resumed run's final checkpoint equals an
    unfailed run's bit for bit."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *CLI,
         "--fail-at", "15", "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, timeout=600, env=ENV, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "kept 64 of 128" in proc.stdout
    assert "done at step 30" in proc.stdout
    assert "'failure', 'restart'" in proc.stdout
    run = train.main([*CLI, "--ckpt-dir", str(tmp_path / "clean")])
    assert run["step"] == 30
    assert [e["kind"] for e in run["events"]] == ["checkpoint"] * 3
    failed, clean = _arrays(tmp_path / "ck", 30), _arrays(
        tmp_path / "clean", 30)
    assert sorted(failed) == sorted(clean)
    assert any(k.startswith("opt/m/blocks/") for k in clean)
    for k in clean:
        assert failed[k].tobytes() == clean[k].tobytes(), k
    # the clean run's state is its own last checkpoint
    state = run["state"]
    got, manifest = manager.restore(str(tmp_path / "clean"), state)
    assert manifest["step"] == 30
    assert len(leaves(got)) == len(leaves(state))
    for a, b in zip(leaves(got), leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got["opt"]["step"]) == 30
    assert got["params"]["blocks"].period == state["params"][
        "blocks"].period


def test_cli_without_ckpt_dir_starts_fresh_each_run(tmp_path, monkeypatch):
    """Two runs with no --ckpt-dir each train from step 0 (each fails at
    step 3 and recovers from its own step-2 checkpoint) and leave no
    directory behind."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
            "--steps", "4", "--ckpt-every", "2", "--fail-at", "3",
            "--seq", "16", "--global-batch", "2"]
    for _ in range(2):
        run = train.main(argv)
        assert run["step"] == 4 and sorted(run["losses"]) == [0, 1, 2, 3]
        kinds = [e["kind"] for e in run["events"]]
        assert kinds[kinds.index("failure") + 1] == "restart", kinds
    assert not list(tmp_path.iterdir())


def test_cli_coreset_is_the_references(capsys):
    """The driver's coreset (the single-device tree on the device) is
    the reference's on the same corpus and embeddings."""
    cfg = registry.smoke_config("smollm-135m")
    toks = synthetic.gen_tokens(128, 65, cfg.vocab_size, seed=0)
    emb = selection.embed_documents(toks[:, :64], seed=0)
    got = selection.select_coreset(emb, 64, spec="greedyml:facility",
                                   seed=0, device="cpu")
    want = JSel.select_coreset(emb, 64, spec="greedyml:facility", seed=0)
    np.testing.assert_array_equal(np.sort(got), np.sort(np.asarray(want)))


def test_local_mesh_trains_and_production_meshes_refuse(tmp_path):
    run = train.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                      "--steps", "2", "--global-batch", "2", "--seq", "16",
                      "--mesh", "local", "--ckpt-dir", str(tmp_path / "l")])
    assert run["step"] == 2 and all(np.isfinite(list(run["losses"].values())))
    for mesh in ("single", "multi"):
        with pytest.raises(NotImplementedError, match="10c"):
            train.main(["--smoke", "--device", "cpu", "--mesh", mesh,
                        "--ckpt-dir", str(tmp_path / mesh)])


def test_train_without_device_refuses_a_machine_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--steps", "1",
                    "--ckpt-dir", str(tmp_path / "x")])


def test_training_with_selected_coreset_converges():
    cfg = registry.smoke_config("smollm-135m")
    toks = synthetic.gen_tokens(64, 33, cfg.vocab_size, seed=0)
    emb = selection.embed_documents(toks[:, :32], seed=0)
    sel = selection.select_coreset(emb, 16, spec="greedyml:facility",
                                   machines=4, branching=2, device="cpu")
    ds = pipeline.TokenDataset(toks, seed=0, selected=sel)
    shape = ShapeConfig("t", "train", 32, 8)
    ocfg = OptimConfig(lr=3e-3, warmup_steps=3, total_steps=60,
                       schedule="constant", weight_decay=0.0)
    state, _ = steps.concrete_state(torch.Generator().manual_seed(0), cfg,
                                    ocfg)
    fn = steps.make_train_step(cfg, ocfg, TrainConfig(), shape, None)
    losses = []
    for step in range(40):
        state, metr = fn(state, pipeline.place(ds.batch(step, 8), None,
                                               "cpu"))
        losses.append(float(metr["loss"]))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_adafactor_trains_too():
    cfg = registry.smoke_config("smollm-135m")
    shape = ShapeConfig("t", "train", 32, 4)
    ocfg = OptimConfig(name="adafactor", lr=1e-2, warmup_steps=3,
                       total_steps=60, schedule="constant")
    state, _ = steps.concrete_state(torch.Generator().manual_seed(0), cfg,
                                    ocfg)
    fn = steps.make_train_step(cfg, ocfg, TrainConfig(), shape, None)
    batch = api.synth_batch(torch.Generator().manual_seed(1), cfg, shape)
    batch["labels"] = batch["tokens"]
    losses = []
    for _ in range(40):
        state, metr = fn(state, batch)
        losses.append(float(metr["loss"]))
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_train_step_no_nans(arch):
    """Mirrors `tests/test_archs_smoke.py::test_train_step_no_nans`: one
    step at every architecture's smoke config and smoke train shape."""
    cfg = registry.smoke_config(arch)
    shape = registry.smoke_shape("train_4k")
    ocfg = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state, _ = steps.concrete_state(torch.Generator().manual_seed(0), cfg,
                                    ocfg)
    fn = steps.make_train_step(cfg, ocfg, TrainConfig(), shape, None)
    batch = api.synth_batch(torch.Generator().manual_seed(0), cfg, shape)
    state, metrics = fn(state, batch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    for leaf in leaves(state["params"]):
        assert bool(torch.isfinite(leaf.float()).all())
