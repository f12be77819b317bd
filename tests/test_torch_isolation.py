"""The port stands alone, runs on the card by default, and keeps exact
copies of what it took from the reference.

  * importing every module of repro_torch, and chip_smoke.py, leaves
    `jax` and `repro` out of sys.modules (a fresh interpreter);
  * an entry point called with no `device` on a machine without CUDA
    raises instead of running on the CPU;
  * chip_smoke.py without a card — or alone in a directory — exits
    non-zero and prints no result;
  * the numpy data generators (arrival streams included), the tree
    structure and the configs are identical to the reference's;
  * the streaming package imports no JAX and streams on the card unless
    asked for the CPU.
"""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import paper_kmedoid as j_paper_kmedoid
from repro.core import tree as JTree
from repro.data import synthetic as JSyn
from repro_torch import convert
from repro_torch.configs import paper_kmedoid as t_paper_kmedoid
from repro_torch.core import tree as TTree
from repro_torch.data import synthetic as TSyn

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the no-device "
                    "behaviour is checked where there is none")


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE,
                          str(ROOT / "chip_smoke.py")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20           # every module was imported


def test_port_sources_name_no_jax_and_no_reference():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)\b", re.M)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    for path in files:
        assert not pattern.search(path.read_text()), path


def test_entry_points_without_device_raise_on_a_machine_without_cuda():
    _no_cuda()
    from repro_torch.core.functions import make_objective
    from repro_torch.core.simulate import run_greedy_dense, run_tree_dense
    from repro_torch.kernels import counters
    x = TSyn.gen_images(64, 8, classes=4, seed=0)
    counters.reset()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_objective("kmedoid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_tree_dense("kmedoid", x, 4, TTree.AccumulationTree(4, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_greedy_dense("facility", x, 4)
    assert all(c["calls"] == 0 for c in counters.snapshot().values())
    # an explicit CPU device runs the plain path
    assert run_greedy_dense("facility", x, 4, device="cpu").ids.size == 4


def test_chip_smoke_fails_without_a_card_and_prints_no_result(tmp_path):
    _no_cuda()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("seed", [0, 7])
def test_data_generators_are_identical_copies(seed):
    np.testing.assert_array_equal(TSyn.gen_images(50, 12, 5, seed),
                                  JSyn.gen_images(50, 12, 5, seed))
    ts = TSyn.gen_kcover(40, 300, seed=seed)
    js = JSyn.gen_kcover(40, 300, seed=seed)
    assert all(np.array_equal(a, b) for a, b in zip(ts, js))
    np.testing.assert_array_equal(TSyn.pack_bitmaps(ts, 300),
                                  JSyn.pack_bitmaps(js, 300))


def test_device_generator_follows_the_recipe():
    a = TSyn.gen_images_on(300, 32, classes=4, seed=3, device="cpu")
    b = TSyn.gen_images_on(300, 32, classes=4, seed=3, chunk=64,
                           device="cpu")
    assert torch.equal(a, b)                 # chunking does not change it
    torch.testing.assert_close(a.norm(dim=1), torch.ones(300))
    torch.testing.assert_close(a.mean(dim=1), torch.zeros(300), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("m,b", [(8, 2), (9, 3), (7, 2), (8, 8)])
def test_tree_structure_matches_reference(m, b):
    jt, tt = JTree.AccumulationTree(m, b), TTree.AccumulationTree(m, b)
    assert tt.num_levels == jt.num_levels
    assert tt.all_nodes() == jt.all_nodes()
    for lvl in range(1, jt.num_levels + 1):
        for nid in jt.nodes_at_level(lvl):
            assert tt.children_of(lvl, nid) == jt.children_of(lvl, nid)
    for i in range(m):
        assert TTree.level_of(i, b, jt.num_levels) == \
            JTree.level_of(i, b, jt.num_levels)
        assert TTree.parent(i, 1, b) == JTree.parent(i, 1, b)
    assert tt.cost_model(1000, 10, 1.0, "kmedoid") == \
        jt.cost_model(1000, 10, 1.0, "kmedoid")
    assert TTree.randgreedi_tree(m) == TTree.AccumulationTree(m, m)


def test_configs_match_reference():
    t, j = t_paper_kmedoid.CONFIG, j_paper_kmedoid.CONFIG
    for field in ("objective", "k", "n", "universe", "feature_dim",
                  "num_machines", "branching", "seed", "augment"):
        assert getattr(t, field) == getattr(j, field)
    full = t_paper_kmedoid.TINY_IMAGENET
    assert (full.n, full.feature_dim) == (100_000, 64 * 64 * 3)
    assert (full.k, full.num_machines, full.branching) == (j.k, j.num_machines,
                                                           j.branching)


def test_streaming_modules_stand_alone():
    """The streaming package (sieve, window, driver) imports neither jax
    nor the reference in a fresh interpreter, and its sources name
    neither."""
    mods = [PORT / "streaming" / f"{m}.py"
            for m in ("__init__", "sieve", "window", "driver")]
    assert all(p.exists() for p in mods)
    code = ("import sys\n"
            "import repro_torch.streaming, repro_torch.streaming.sieve\n"
            "import repro_torch.streaming.window\n"
            "import repro_torch.streaming.driver\n"
            "bad = [n for n in sys.modules\n"
            "       if n.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)\b", re.M)
    for path in mods:
        assert not pattern.search(path.read_text()), path


def test_streaming_without_device_raises_on_a_machine_without_cuda():
    _no_cuda()
    from repro_torch.core.functions import make_objective
    from repro_torch.streaming import stream_select
    st = TSyn.gen_stream("kcover", 64, universe=128, batch=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_select(make_objective("kcover", universe=128), st, 4)
    sol = stream_select(make_objective("kcover", universe=128,
                                       device="cpu"), st, 4)
    assert sol.ids.device.type == "cpu" and int(sol.valid.sum()) > 0


@pytest.mark.parametrize("order", ["shuffled", "adversarial", "drift"])
def test_stream_generator_is_an_identical_copy(order):
    for name in ("kcover", "facility"):
        t = TSyn.gen_stream(name, 80, d=8, universe=200, batch=16,
                            order=order, seed=2)
        j = JSyn.gen_stream(name, 80, d=8, universe=200, batch=16,
                            order=order, seed=2)
        np.testing.assert_array_equal(t.order, j.order)
        np.testing.assert_array_equal(t.payloads, j.payloads)


def test_convert_round_trips_words_and_ids():
    words = np.array([0, 1, 2 ** 32 - 1, 2 ** 31], np.uint32)
    t = convert.to_torch(words, "cpu")
    assert t.dtype == torch.int32                  # the port's word type
    assert t.tolist() == [0, 1, -1, -2 ** 31]      # the same bit patterns
    np.testing.assert_array_equal(convert.to_numpy(t, np.uint32), words)
    ids = np.array([3, -1], np.int32)
    np.testing.assert_array_equal(
        convert.to_numpy(convert.to_torch(ids, "cpu"), np.int32), ids)


FAULT_AND_SERVING = ["checkpoint/manager", "checkpoint/reshard",
                     "runtime/fault", "runtime/straggler", "runtime/elastic",
                     "runtime/supervisor", "sharding/axes",
                     "launch/faultrun", "serving/engine", "serving/metrics",
                     "serving/session"]


def test_fault_and_serving_modules_stand_alone():
    """The fault-tolerance and serving modules import neither jax nor the
    reference in a fresh interpreter, and their sources name neither."""
    paths = [PORT / f"{m}.py" for m in FAULT_AND_SERVING]
    assert all(p.exists() for p in paths)
    mods = ", ".join("repro_torch." + m.replace("/", ".")
                     for m in FAULT_AND_SERVING)
    code = (f"import sys\nimport {mods}\n"
            "bad = [n for n in sys.modules\n"
            "       if n.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)\b", re.M)
    for path in paths:
        assert not pattern.search(path.read_text()), path


def test_fault_and_serving_without_device_raise_on_a_machine_without_cuda():
    _no_cuda()
    from repro_torch.launch import faultrun
    from repro_torch.serving import QueryEngine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QueryEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        faultrun.main(["--n", "64", "--lanes", "2"])
    assert QueryEngine(device="cpu").device.type == "cpu"
