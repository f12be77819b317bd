"""The port's examples (`examples_torch/`) held against the reference's
functions on the same numpy data and seeds, each run through its
importable `main(argv)` at a small size on the CPU:

  * quickstart: Greedy, RandGreedi and GreedyML on the lazy engine —
    values, total and critical-path calls equal to
    `repro.core.simulate.run_greedy_lazy` / `run_tree_lazy`, exactly;
  * exemplar_clustering: RandGreedi and GreedyML at each branching on
    the dense engine against `run_tree_dense` on its `ref` backend —
    evals equal, the selections equal (then the values within the
    reference tests' 1e-5 relative) or split at a tie that float64
    proves (ROADMAP §C P1: `test_torch_tree._lockstep` walks the
    reference's tree and holds every node of the port's to it);
  * data_summarization: 4 gloo ranks over the tree (2, 2) against the
    reference's `greedyml_distributed` and sequential `greedy` in one
    JAX subprocess with 4 forced host devices, started with the file,
    by the same rule (the distributed tree is the simulated one over
    contiguous blocks, which the lockstep walks);
  * distributed_training: a few smoke steps with a failure injected and
    recovered from its checkpoint;
  * every example imports neither JAX nor the reference.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_tree as TT
from repro.core import simulate as JS
from repro.core.tree import AccumulationTree as JTree
from repro.core.tree import randgreedi_tree as j_randgreedi

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))         # examples_torch, a namespace package

from examples_torch import data_summarization as DS  # noqa: E402
from examples_torch import distributed_training as DT  # noqa: E402
from examples_torch import exemplar_clustering as EC  # noqa: E402
from examples_torch import quickstart as QS  # noqa: E402

EXAMPLES = ("quickstart", "exemplar_clustering", "data_summarization",
            "distributed_training")
SUMMARY = dict(n=256, d=16, k=8, ranks=4)
SPAWN_DEADLINE = 240

# the reference's data_summarization at SUMMARY's sizes over 4 host
# devices; its shard_map'ed functions jit-compiled (eager shard_map runs
# op by op)
REFERENCE_SNIPPET = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
import jax.experimental.shard_map as SM
import repro.core.greedyml as GML
_eager = SM.shard_map
SM.shard_map = GML.shard_map = lambda *a, **k: jax.jit(_eager(*a, **k))
from repro.core.functions import make_objective
from repro.core.greedy import greedy
from repro.core.greedyml import greedyml_distributed
from repro.core.simulate import global_value
from repro.data import synthetic
from repro.launch.mesh import make_machine_mesh

N, D, K = map(int, sys.argv[1:4])
imgs = synthetic.gen_images(N, D, classes=16, seed=3)
mesh = make_machine_mesh(4, 2)
ids = jnp.arange(N, dtype=jnp.int32)
out = {}
for name in ("kmedoid", "facility"):
    obj = make_objective(name, backend="ref")
    sol = greedyml_distributed(obj, ids, jnp.asarray(imgs), jnp.ones(N, bool),
                               K, mesh, tree_axes=("lvl0", "lvl1"))
    for f in ("ids", "valid", "value"):
        out[f"{name}_{f}"] = np.asarray(getattr(sol, f))
    sel = np.asarray(sol.ids)[np.asarray(sol.valid)]
    out[f"{name}_global"] = global_value(name, imgs, sel)
ref = greedy(make_objective("kmedoid", backend="ref"), ids, jnp.asarray(imgs),
             jnp.ones(N, bool), K)
sel = np.asarray(ref.ids)[np.asarray(ref.valid)]
out["greedy_ids"] = sel
out["greedy_global"] = global_value("kmedoid", imgs, sel)
np.savez(sys.argv[4], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def summary(tmp_path_factory):
    """The port's example on 4 gloo ranks beside the reference's drivers
    in a JAX subprocess; → (the example's result, the reference's)."""
    tmp = tmp_path_factory.mktemp("summary")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_SNIPPET, str(SUMMARY["n"]),
         str(SUMMARY["d"]), str(SUMMARY["k"]), str(tmp / "out.npz")],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        got = DS.main(["--device", "cpu", "--ranks", str(SUMMARY["ranks"]),
                       "--n", str(SUMMARY["n"]), "--d", str(SUMMARY["d"]),
                       "--k", str(SUMMARY["k"]),
                       "--deadline", str(SPAWN_DEADLINE)])
        out, err = ref.communicate(timeout=SPAWN_DEADLINE)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0 and "OK" in out, err[-3000:]
    return got, dict(np.load(tmp / "out.npz"))


def test_quickstart_matches_reference(capsys):
    n, universe, k, m = 512, 1024, 16, 8
    got = QS.main(["--device", "cpu", "--n", str(n), "--universe",
                   str(universe), "--k", str(k), "--m", str(m)])
    printed = capsys.readouterr().out
    from repro.data import synthetic
    sets = synthetic.gen_kcover(n, universe, seed=0, avg_size=12.0)
    want = {"greedy": JS.run_greedy_lazy("kcover", sets, k,
                                         universe=universe),
            "randgreedi": JS.run_tree_lazy("kcover", sets, k,
                                           j_randgreedi(m), seed=1,
                                           universe=universe),
            "greedyml": JS.run_tree_lazy("kcover", sets, k, JTree(m, 2),
                                         seed=1, universe=universe)}
    for name, w in want.items():
        g = got[name]
        assert g.value == w.value, name
        assert (g.evals_total, g.evals_critical, g.levels) == (
            w.evals_total, w.evals_critical, w.levels), name
        np.testing.assert_array_equal(np.sort(g.ids), np.sort(w.ids))
    ratio = want["greedyml"].value / want["greedy"].value
    assert f"GreedyML/Greedy = {ratio:.4f}" in printed


def test_exemplar_clustering_matches_reference(capsys):
    n, d, k, m = 256, 64, 8, 8
    # b = 8 over m = 8 machines is RandGreedi's tree again
    got = EC.main(["--device", "cpu", "--n", str(n), "--d", str(d), "--k",
                   str(k), "--m", str(m), "--branching", "4", "2"])
    printed = capsys.readouterr().out
    from repro.data import synthetic
    imgs = synthetic.gen_images(n, d, classes=24, seed=7)
    runs = [("randgreedi", got["randgreedi"], j_randgreedi(m))] + [
        (f"b={b}", got["greedyml"][b], JTree(m, b)) for b in (4, 2)]
    for name, g, tree in runs:
        w = JS.run_tree_dense("kmedoid", imgs, k, tree, seed=1,
                              backend="ref")
        assert g.evals_critical == w.evals_critical, name
        assert g.evals_total == w.evals_total, name
        assert g.per_node_evals == w.per_node_evals, name
        assert f"f={g.value:.4f}" in printed
        if np.array_equal(g.ids, np.asarray(w.ids, np.int64)):
            assert abs(g.value - w.value) <= 1e-5 * abs(w.value), name
        else:      # the runs split where the lockstep met a tie
            assert TT._lockstep("kmedoid", imgs, k, tree, seed=1) >= 1, (
                name, g.ids, w.ids)


@pytest.mark.parametrize("name", ["kmedoid", "facility"])
def test_data_summarization_roots_match_reference(summary, name,
                                                  monkeypatch):
    got, ref = summary
    root = got["roots"][name]
    printed = {"kmedoid": got["value"], "facility": got["coverage"]}[name]
    if np.array_equal(root["ids"].numpy(),
                      ref[f"{name}_ids"].astype(np.int64)):
        np.testing.assert_array_equal(root["valid"].numpy(),
                                      ref[f"{name}_valid"])
        want = float(ref[f"{name}_value"])
        assert abs(root["value"] - want) <= 1e-5 * abs(want)
        want = float(ref[f"{name}_global"])
        assert abs(printed - want) <= 1e-5 * abs(want)
        return
    # lane i holds block i: the simulated tree over contiguous pools
    n, m = SUMMARY["n"], SUMMARY["ranks"]
    monkeypatch.setattr(JS, "partition",
                        lambda n_, m_, seed: np.repeat(np.arange(m_),
                                                       n_ // m_))
    ties = TT._lockstep(name, got["images"], SUMMARY["k"], JTree(m, 2))
    assert ties >= 1, (root["ids"], ref[f"{name}_ids"])


def test_data_summarization_sequential_greedy_matches_reference(summary):
    got, ref = summary
    a = ref["greedy_ids"].astype(np.int64)
    b = got["sequential_ids"]
    if np.array_equal(a, b):
        want = float(ref["greedy_global"])
        assert abs(got["sequential_value"] - want) <= 1e-5 * abs(want)
        return
    x = got["images"]
    n = x.shape[0]
    assert TT._tie("kmedoid", x, np.ones(n, bool), x, np.ones(n, bool), a,
                   b, np.arange(n)), (a, b)


def test_data_summarization_every_rank_holds_the_stacked_root(summary):
    """Every rank's root is the port's stacked dispatcher's over the same
    contiguous blocks, bit for bit."""
    from repro_torch.core.functions import make_objective
    from repro_torch.core.greedyml import (LevelDispatcher, root_solution,
                                           shard_lanes)
    got, _ = summary
    x = torch.as_tensor(got["images"])
    n, m = x.shape[0], SUMMARY["ranks"]
    pools = shard_lanes(torch.arange(n), x, torch.ones(n, dtype=torch.bool),
                        m)
    assert len(got["ranks"]) == m
    for name in ("kmedoid", "facility"):
        disp = LevelDispatcher(make_objective(name, device="cpu"),
                               SUMMARY["k"], (2, 2))
        sols = disp.leaves(*pools)
        for lvl in range(disp.num_levels):
            sols = disp.level(sols, lvl)
        want = root_solution(sols)
        for res in got["ranks"]:
            assert res["device"] == "cpu"
            assert res["axes"] == ("lvl1", "lvl0")
            assert torch.equal(res[name]["ids"], want.ids)
            assert torch.equal(res[name]["valid"], want.valid)
            assert res[name]["value"] == float(want.value)


def test_data_summarization_backend_is_never_switched():
    with pytest.raises(ValueError, match="NCCL runs one rank on each card"):
        DS.main(["--backend", "nccl", "--device", "cpu", "--ranks", "4"])


def test_distributed_training_recovers_from_the_injected_failure(tmp_path,
                                                                  capsys):
    out = DT.main(["--device", "cpu", "--steps", "4", "--ckpt-every", "2",
                   "--fail-at", "3", "--selection-k", "8",
                   "--corpus-docs", "16", "--ckpt-dir",
                   str(tmp_path / "ckpt")])
    printed = capsys.readouterr().out
    kinds = [e["kind"] for e in out["events"]]
    assert out["step"] == 4
    assert "failure" in kinds and "restart" in kinds
    assert kinds.index("restart") > kinds.index("failure")
    assert len(out["selected"]) == 8
    assert "kept 8 of 16 documents" in printed
    assert "recovered from the injected failure" in printed
    assert any((tmp_path / "ckpt").iterdir())


def test_examples_import_no_jax_and_no_reference():
    code = ("import importlib, sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            f"for m in {EXAMPLES!r}:\n"
            "    importlib.import_module('examples_torch.' + m)\n"
            "bad = [n for n in sys.modules\n"
            "       if n.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)\b", re.M)
    for name in EXAMPLES:
        path = ROOT / "examples_torch" / f"{name}.py"
        assert not pattern.search(path.read_text()), path
