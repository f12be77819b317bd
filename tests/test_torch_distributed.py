"""Distributed GreedyML over `torch.distributed` process groups, on the
CPU with gloo, at world sizes 1, 2 and 4.

  * the level subgroups of launch/mesh.py equal `gather_groups`' rows
    (pure, no process group);
  * the mesh's errors: a world size that is not the tree's (also with
    ``shard`` > 1), no device without CUDA, and NCCL's two ranks on one device
    (checked on the placement function);
  * at world sizes 2 and 4 (spawned ranks, a FileStore rendezvous under
    the test's temporary directory, one spawn a world size with a
    deadline): `LevelDispatcher(mesh=…)` stage by stage,
    `greedyml_distributed`, `randgreedi_distributed`,
    `stream_select_distributed` and `select_coreset`'s mesh branch
    against the port's stacked `LevelDispatcher(mesh=None)` and
    `stream_select_continuous` on the same blocks — kcover bit for bit,
    the feature rules equal but at a float64-proven tie (ROADMAP §C P1);
    kcover, kmedoid and facility trees, a KnapsackSpec, augmentation rows,
    stochastic leaves and nodes under the reference's draws and under
    the port's own sampler; every rank holds the same root;
  * against the reference's own distributed drivers: a JAX subprocess
    with 4 forced host devices runs `greedyml_distributed`,
    `randgreedi_distributed`, `stream_select_distributed` and
    `select_coreset` on kcover bitmaps and small-integer facility data
    (exact arithmetic), held equal to the port's world size 4; and the
    reference's in-process 1-device mesh against the port's world size 1,
    with the seeds' threading (the same seed repeats, others differ).

The spawned ranks import this module: it imports no JAX at its top (the
reference's pieces are imported inside the parent's helpers).
"""
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import greedy as TG
from repro_torch.core import greedyml as TGML
from repro_torch.core.constraints import KnapsackSpec
from repro_torch.core.functions import make_objective
from repro_torch.data.synthetic import (Stream, gen_embeddings, gen_images,
                                        gen_kcover, gen_stream, pack_bitmaps)
from repro_torch.launch import mesh as TM
from repro_torch.launch.spawn import run_ranks

ROOT = Path(__file__).resolve().parent.parent
N, D, K, UNIVERSE, BUDGET = 128, 16, 6, 192, 5.0
S_UNIVERSE, S_K = 384, 8                  # the streams' (test_torch_stream)
FIELDS = ("ids", "payloads", "valid", "value", "evals")
SPAWN_DEADLINE = 240.0


# ---------------------------------------------------------------------------
# data, the same numpy arrays on both sides
# ---------------------------------------------------------------------------


def _data(name, seed=0):
    if name == "kcover":
        return pack_bitmaps(gen_kcover(N, UNIVERSE, seed=seed), UNIVERSE)
    if name == "facility_int":
        rng = np.random.default_rng(seed + 50)
        return rng.integers(-3, 4, (N, D)).astype(np.float32)
    return gen_images(N, D, classes=6, seed=seed)


def _rule(name):
    return "facility" if name == "facility_int" else name


def _aug(name, levels, seed=9):
    """Per-level node evaluation rows (L, A, D) for the feature rules."""
    if name == "kcover":
        return None
    if name == "facility_int":
        rng = np.random.default_rng(seed)
        return rng.integers(-3, 4, (levels, 8, D)).astype(np.float32)
    return np.stack([gen_images(32, D, classes=6, seed=seed + i)
                     for i in range(levels)])


def _costs(seed=5):
    return np.random.default_rng(seed).uniform(0.5, 2.0, N).astype(
        np.float32)


def _stream(name, lanes):
    """The continuous-mode test stream (test_torch_stream's shape): 320
    drifting arrivals in batches of 64."""
    if name == "facility_int":
        x = _data("facility_int", seed=3)[:96]
        return Stream(x, np.random.default_rng(4).permutation(96), 32)
    return gen_stream(name, 320, d=24, universe=S_UNIVERSE, batch=64,
                      order="drift", seed=5)


def _stream_ground(name):
    if name == "kcover":
        return None
    st = _stream(name, 1)
    return st.payloads[:48]


def _objective(name, universe=UNIVERSE):
    return make_objective(_rule(name), device="cpu",
                          **({"universe": universe} if name == "kcover"
                             else {}))


class TableSampler:
    """A sampler replaying fixed draws: stage → (lanes, k, sample)."""

    def __init__(self, table):
        self.table = {int(s): np.asarray(d) for s, d in table.items()}

    def __call__(self, stage, lanes, k, n, sample):
        d = self.table[stage]
        assert d.shape == (lanes, k, sample), (stage, d.shape)
        return torch.as_tensor(d)


# ---------------------------------------------------------------------------
# the rank side: every case of a world size in one spawn
# ---------------------------------------------------------------------------


def _np_sol(sol):
    return {f: getattr(sol, f).detach().cpu().numpy() for f in FIELDS}


def _dispatcher(case, radices, mesh=None):
    obj = _objective(case["name"])
    constraint = None
    if case.get("costs") is not None:
        constraint = KnapsackSpec(torch.as_tensor(case["costs"]), BUDGET)
    sampler = (TableSampler(case["draws"]) if case.get("draws") is not None
               else None)
    return TGML.LevelDispatcher(
        obj, K, radices, mesh=mesh, engine=case.get("engine", "auto"),
        sample_leaf=case.get("sample_leaf", 0),
        sample_level=case.get("sample_level", 0), seed=case.get("seed"),
        constraint=constraint, sampler=sampler)


def _block(x, mesh):
    return torch.as_tensor(TM.local_block(np.asarray(x), mesh))


def _rank_tree(case, mesh):
    """The dispatcher stage by stage (every stage's lane kept), its root,
    then the driver on the same block."""
    disp = _dispatcher(case, mesh.radices, mesh)
    data = case["data"]
    ids = _block(np.arange(N), mesh)
    pay = _block(data.view(np.int32) if data.dtype == np.uint32 else data,
                 mesh)
    val = torch.ones(ids.shape[0], dtype=torch.bool)
    stages = [disp.leaves(ids[None], pay[None], val[None])]
    aug = case.get("aug")
    for lvl in range(disp.num_levels):
        stages.append(disp.level(stages[-1], lvl,
                                 None if aug is None
                                 else torch.as_tensor(aug[lvl])))
    root = TGML.root_solution(stages[-1], mesh)
    drv = TGML.greedyml_distributed(
        disp.objective, ids, pay, val, K, mesh,
        tuple(reversed(mesh.axis_names)), augment=aug,
        sample_leaf=disp.sample_leaf, sample_level=disp.sample_level,
        engine=disp.engine, seed=case.get("seed"),
        constraint=disp.constraint, sampler=disp.sampler)
    return {"stages": [_np_sol(s) for s in stages], "root": _np_sol(root),
            "driver": _np_sol(drv)}


def _rank_randgreedi(case, mesh):
    disp = _dispatcher(case, mesh.radices, mesh)
    data = case["data"]
    pay = _block(data.view(np.int32) if data.dtype == np.uint32 else data,
                 mesh)
    ids = _block(np.arange(N), mesh)
    sol = TGML.randgreedi_distributed(
        disp.objective, ids, pay, torch.ones(ids.shape[0], dtype=torch.bool),
        K, mesh, augment=case.get("aug"))
    return {"root": _np_sol(sol)}


def _rank_stream(case, mesh):
    from repro_torch.streaming import stream_select_distributed
    name = case["name"]
    sol, info = stream_select_distributed(
        _objective(name, S_UNIVERSE), _stream(name, mesh.lanes), S_K, mesh,
        merge_every=case["merge_every"], ground=_stream_ground(name))
    return {"root": _np_sol(sol), "info": info}


def _rank_coreset(case, mesh):
    from repro_torch.data.selection import select_coreset
    return {"ids": select_coreset(TM.local_block(case["data"], mesh), K,
                                  case["spec"], mesh=mesh)}


RANK_CASES = {"tree": _rank_tree, "randgreedi": _rank_randgreedi,
              "stream": _rank_stream, "coreset": _rank_coreset}


def _world_rank(rank, radices, cases):
    mesh = TM.make_tree_mesh(radices, device="cpu")
    assert TGML.machine_flat_id(mesh) == rank
    out = {}
    for key, case in cases.items():
        t0 = time.perf_counter()
        out[key] = RANK_CASES[case["kind"]](case, mesh)
        out[key]["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# the parent side
# ---------------------------------------------------------------------------


def _reference_draws(seed, lanes, radices, sample_leaf, sample_level):
    """The reference's per-lane draws of every stage
    (test_torch_greedyml._reference_sampler) as a table."""
    from test_torch_greedyml import _reference_sampler
    draw = _reference_sampler(seed)
    table = {0: draw(0, lanes, K, N // lanes, sample_leaf).numpy()}
    for lvl, b in enumerate(radices):
        table[1 + lvl] = draw(1 + lvl, lanes, K, b * K, sample_level).numpy()
    return table


def _tree_cases(radices, with_reference_draws):
    levels = len(radices)
    lanes = math.prod(radices)
    cases = {}
    for name in ("kcover", "kmedoid", "facility", "facility_int"):
        cases[f"tree_{name}"] = {"kind": "tree", "name": name,
                                 "data": _data(name),
                                 "aug": _aug(name, levels)}
        cases[f"randgreedi_{name}"] = {"kind": "randgreedi", "name": name,
                                       "data": _data(name),
                                       "aug": _aug(name, 1)}
    cases["knapsack_facility"] = {"kind": "tree", "name": "facility",
                                  "data": _data("facility", 4),
                                  "aug": _aug("facility", levels),
                                  "costs": _costs(9)}
    cases["knapsack_kcover"] = {"kind": "tree", "name": "kcover",
                                "data": _data("kcover", 4),
                                "costs": _costs(9), "engine": "step"}
    for name in ("kcover", "kmedoid"):
        stoch = {"kind": "tree", "name": name, "data": _data(name, 2),
                 "aug": _aug(name, levels), "sample_leaf": 12,
                 "sample_level": 5, "seed": 11}
        if with_reference_draws:
            stoch["draws"] = _reference_draws(11, lanes, radices, 12, 5)
        cases[f"stochastic_{name}"] = stoch
    for name in ("kcover", "facility", "facility_int"):
        cases[f"stream_{name}"] = {"kind": "stream", "name": name,
                                   "merge_every": 2}
    return cases


def _stack(results, key, stage):
    """Stack every rank's (1, …) lane of one case's stage."""
    return {f: np.concatenate([r[key]["stages"][stage][f] for r in results])
            for f in FIELDS}


def _single(case, radices, stacked_in=None, stage=0):
    """The stacked dispatcher's stage `stage` over the same blocks: the
    leaves, or level stage-1 fed `stacked_in` (the distributed lanes of
    the stage before)."""
    disp = _dispatcher(case, radices)
    if stage == 0:
        data = case["data"]
        pay = torch.as_tensor(data.view(np.int32) if data.dtype == np.uint32
                              else data)
        ids, pay, val = TGML.shard_lanes(torch.arange(N), pay,
                                         torch.ones(N, dtype=torch.bool),
                                         disp.lanes)
        return _np_sol(disp.leaves(ids, pay, val)), pay
    sols = TG.Solution(*(torch.as_tensor(stacked_in[f]) for f in FIELDS))
    aug = case.get("aug")
    row = None if aug is None else torch.as_tensor(aug[stage - 1])
    return _np_sol(disp.level(sols, stage - 1, row)), sols


def _hold_lanes(name, want, got, grounds, pools, pool_ids):
    """Lane by lane: kcover bit for bit; a feature lane equal (ids,
    valid, evals; value within 1e-5) or split at a float64-proven tie.
    Returns the ties met."""
    if name == "kcover":
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        return 0
    from test_torch_tree import _tie
    ties = 0
    for i in range(want["ids"].shape[0]):
        if np.array_equal(want["ids"][i], got["ids"][i]):
            np.testing.assert_array_equal(want["valid"][i], got["valid"][i])
            assert int(want["evals"][i]) == int(got["evals"][i])
            np.testing.assert_allclose(got["value"][i], want["value"][i],
                                       rtol=1e-5, atol=1e-6)
            continue
        g, gv = grounds[i]
        assert _tie(_rule(name), g, gv, pools[i], None,
                    want["ids"][i].astype(np.int64), got["ids"][i],
                    pool_ids[i]), (i, want["ids"][i], got["ids"][i])
        ties += 1
    return ties


def _hold_tree(case, radices, results):
    """Every stage of the distributed tree against the stacked dispatcher
    fed the same input; the stages' root and the driver's on every rank
    equal rank 0's lane. Returns the ties met."""
    name = case["name"]
    want, pays = _single(case, radices)
    got = _stack(results, case["key"], 0)
    ties = _hold_lanes(name, want, got,
                       [(p, np.ones(len(p), bool)) for p in pays.numpy()],
                       pays.numpy(), np.arange(N).reshape(len(pays), -1))
    for lvl in range(len(radices)):
        want, sols = _single(case, radices, got, 1 + lvl)
        u_pay = TGML.gather_groups(sols.payloads, radices, lvl)
        u_val = TGML.gather_groups(sols.valid, radices, lvl)
        u_ids = TGML.gather_groups(sols.ids, radices, lvl).numpy()
        grounds = []
        for i in range(u_pay.shape[0]):
            g, gv = u_pay[i].numpy(), u_val[i].numpy()
            if case.get("aug") is not None:
                a = case["aug"][lvl]
                g = np.concatenate([g, a])
                gv = np.concatenate([gv, np.ones(len(a), bool)])
            grounds.append((g, gv))
        got = _stack(results, case["key"], 1 + lvl)
        ties += _hold_lanes(name, want, got, grounds, u_pay.numpy(), u_ids)
    for r in results:
        for f in FIELDS:
            np.testing.assert_array_equal(r[case["key"]]["root"][f],
                                          got[f][0], err_msg=f)
            np.testing.assert_array_equal(r[case["key"]]["driver"][f],
                                          got[f][0], err_msg=f)
    return ties


def _continuous(name, lanes):
    from repro_torch.streaming import stream_select_continuous
    g = _stream_ground(name)
    return stream_select_continuous(
        _objective(name, S_UNIVERSE), _stream(name, lanes), S_K,
        lanes=lanes, branching=2, merge_every=2,
        ground=None if g is None else torch.as_tensor(g))


# ------------------------------------------------- the reference, 4 devices

# The reference's drivers call shard_map eagerly, op by op (~15 s a
# stream batch on 4 host devices); the subprocess jit-compiles the same
# shard_map'ed functions instead, once a shape. On this data (bitmaps,
# small integers) every operation is exact, so the values are the eager
# ones.
REFERENCE_SNIPPET = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
import jax.experimental.shard_map as SM
import repro.core.greedyml as GML
_eager = SM.shard_map
SM.shard_map = GML.shard_map = lambda *a, **k: jax.jit(_eager(*a, **k))
from repro.core.functions import make_objective
from repro.core.greedyml import greedyml_distributed, randgreedi_distributed
from repro.data.selection import select_coreset
from repro.data.synthetic import Stream
from repro.launch.mesh import make_machine_mesh
from repro.streaming.driver import stream_select_distributed

inp = np.load(sys.argv[1])
mesh = make_machine_mesh(4, 2)
axes = ("lvl0", "lvl1")
out = {}
n = int(inp["n"])
ids = jnp.arange(n, dtype=jnp.int32)
valid = jnp.ones(n, bool)
for name in ("kcover", "facility"):
    kw = {"universe": int(inp["universe"])} if name == "kcover" else {}
    obj = make_objective(name, backend="ref", **kw)
    pay = jnp.asarray(inp[f"{name}_data"])
    aug = (jnp.asarray(inp[f"{name}_aug"]) if f"{name}_aug" in inp
           else None)
    s = greedyml_distributed(obj, ids, pay, valid, int(inp["k"]), mesh, axes,
                             augment=aug)
    r = randgreedi_distributed(obj, ids, pay, valid, int(inp["k"]), mesh,
                               axes, augment=None if aug is None
                               else aug[:1])
    sobj = make_objective(name, backend="ref",
                          **({"universe": int(inp["s_universe"])}
                             if name == "kcover" else {}))
    st = Stream(inp[f"{name}_stream"], inp[f"{name}_order"],
                int(inp[f"{name}_batch"]))
    g = (jnp.asarray(inp[f"{name}_ground"]) if f"{name}_ground" in inp
         else None)
    m, info = stream_select_distributed(sobj, st, int(inp["s_k"]), mesh,
                                        axes, merge_every=2, ground=g,
                                        backend="ref")
    for tag, sol in (("gml", s), ("rg", r), ("stream", m)):
        for f in ("ids", "valid", "value", "evals"):
            out[f"{name}_{tag}_{f}"] = np.asarray(getattr(sol, f))
    out[f"{name}_stream_merges"] = np.asarray(info["merges"])
for spec in ("greedyml:facility", "randgreedi:facility"):
    out[spec] = select_coreset(inp["coreset"], int(inp["k"]), spec,
                               mesh=mesh)
np.savez(sys.argv[2], **out)
print("OK")
"""


def _reference_inputs():
    inp = {"n": N, "k": K, "universe": UNIVERSE, "s_universe": S_UNIVERSE,
           "s_k": S_K, "coreset": _data("facility_int", 7)}
    for name, src in (("kcover", "kcover"), ("facility", "facility_int")):
        inp[f"{name}_data"] = _data(src)
        aug = _aug(src, 2)
        if aug is not None:
            inp[f"{name}_aug"] = aug
        st = _stream(src, 4)
        inp[f"{name}_stream"] = st.payloads
        inp[f"{name}_order"] = st.order
        inp[f"{name}_batch"] = st.batch
        g = _stream_ground(src)
        if g is not None:
            inp[f"{name}_ground"] = g
    return inp


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The reference subprocess (4 host devices) and the port's 4 ranks,
    side by side; → (port results by rank, cases, reference outputs)."""
    tmp = tmp_path_factory.mktemp("world4")
    np.savez(tmp / "in.npz", **_reference_inputs())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE_SNIPPET,
                            str(tmp / "in.npz"), str(tmp / "out.npz")],
                           env=env, cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        cases = _tree_cases((2, 2), with_reference_draws=True)
        for spec in ("greedyml:facility", "randgreedi:facility",
                     "greedy:facility"):
            cases[spec] = {"kind": "coreset", "spec": spec,
                           "data": _data("facility_int", 7)}
        cases["coreset_real"] = {"kind": "coreset",
                                 "spec": "greedyml:facility",
                                 "data": gen_embeddings(N, D, seed=3)}
        results = run_ranks(_world_rank, 4, args=((2, 2), cases),
                            timeout=SPAWN_DEADLINE, workdir=str(tmp))
        out, err = ref.communicate(timeout=SPAWN_DEADLINE)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0 and "OK" in out, err[-3000:]
    for key, case in cases.items():
        case["key"] = key
    return results, cases, dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world2")
    cases = _tree_cases((2,), with_reference_draws=False)
    results = run_ranks(_world_rank, 2, args=((2,), cases),
                        timeout=SPAWN_DEADLINE, workdir=str(tmp))
    for key, case in cases.items():
        case["key"] = key
    return results, cases


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """This process as a world of one rank (gloo, a FileStore)."""
    tmp = tmp_path_factory.mktemp("world1")
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'rdv'}",
                            world_size=1, rank=0)
    try:
        yield TM.make_tree_mesh((1,), device="cpu")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the level groups (pure)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("radices", [(2, 2), (4,), (2, 3), (1,)])
def test_level_groups_are_gather_groups_rows(radices):
    lanes = math.prod(radices)
    ids = torch.arange(lanes).unsqueeze(1)
    for lvl in range(len(radices)):
        rows = TGML.gather_groups(ids, radices, lvl)
        seen = []
        for lane in range(lanes):
            assert TM.level_ranks(radices, lvl, lane) == rows[lane].tolist()
        for group in TM.level_partition(radices, lvl):
            assert group == sorted(group)       # digit order = rank order
            seen += group
        assert sorted(seen) == list(range(lanes))    # each lane once
        assert TM.digits(lanes - 1, radices) == tuple(r - 1 for r in radices)


def test_nccl_placement_check():
    two_on_one = TM.rank_devices(2, 1)
    assert two_on_one == [torch.device("cuda", 0)] * 2
    with pytest.raises(ValueError, match="no two ranks on one device"):
        TM.check_devices("nccl", two_on_one)
    TM.check_devices("gloo", two_on_one)           # gloo shares a card
    TM.check_devices("nccl", TM.rank_devices(4, 4))
    two_hosts = TM.rank_devices(4, 2, local_world=2)
    assert two_hosts[3] == torch.device("cuda", 1)
    TM.check_devices("nccl", two_hosts, local_world=2)  # one card a rank
    with pytest.raises(ValueError, match="ranks 0 and 2 .* host 0"):
        TM.check_devices("nccl", two_hosts)             # one host: shared
    with pytest.raises(ValueError, match="ranks 2 and 3 .* host 1"):
        TM.check_devices("nccl", [torch.device("cuda", d)
                                  for d in (0, 1, 0, 0)], local_world=2)
    with pytest.raises(ValueError, match="NCCL needs CUDA"):
        TM.check_devices("nccl", [torch.device("cpu")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.rank_devices(2, 0)


def test_mesh_errors(world1):
    with pytest.raises(ValueError, match="1 ranks"):
        TM.make_tree_mesh((2,), device="cpu")
    with pytest.raises(ValueError, match="1 ranks"):
        TM.make_machine_mesh(4, 2, device="cpu")
    with pytest.raises(ValueError, match="m=b"):
        TM.make_machine_mesh(6, 2, device="cpu")
    # a shard > 1 mesh needs tree · shard ranks, and the dispatcher the
    # mesh's shard
    with pytest.raises(ValueError, match="1 ranks"):
        TM.make_tree_mesh((1,), shard=2, device="cpu")
    with pytest.raises(ValueError, match="1 ranks"):
        TM.make_tree_mesh((), shard=2, device="cpu")
    with pytest.raises(ValueError, match="shard"):
        TGML.LevelDispatcher(_objective("kcover"), K, (1,), mesh=world1,
                             shard=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.make_tree_mesh((1,))
    with pytest.raises(ValueError, match="mesh's tree"):
        TGML.LevelDispatcher(_objective("kcover"), K, (2,), mesh=world1)
    with pytest.raises(ValueError, match="tree_axes"):
        TGML.greedyml_distributed(_objective("kcover"), np.arange(4),
                                  _data("kcover")[:4], np.ones(4, bool), 2,
                                  world1, ("x",))
    m = world1
    assert (m.axis_names, m.shape, TM.mesh_devices(m)) == (
        ("lvl0",), {"lvl0": 1}, 1)
    assert TM.factor_tree_axes(m, m.axis_names) == ("lvl0",)


# ---------------------------------------------------------------------------
# world sizes 2 and 4 against the port's stacked lanes
# ---------------------------------------------------------------------------

TREES = ["tree_kcover", "tree_kmedoid", "tree_facility", "tree_facility_int",
         "knapsack_facility", "knapsack_kcover", "stochastic_kcover",
         "stochastic_kmedoid"]


@pytest.mark.parametrize("key", TREES)
def test_world4_tree_equals_stacked_lanes(world4, key):
    results, cases, _ = world4
    _hold_tree(cases[key], (2, 2), results)
    if cases[key].get("costs") is not None:
        root = results[0][key]["root"]
        spent = KnapsackSpec(torch.as_tensor(cases[key]["costs"]),
                             BUDGET).spent(torch.as_tensor(root["ids"]),
                                           torch.as_tensor(root["valid"]))
        assert float(spent) <= BUDGET


@pytest.mark.parametrize("key", TREES)
def test_world2_tree_equals_stacked_lanes(world2, key):
    results, cases = world2
    _hold_tree(cases[key], (2,), results)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["kcover", "kmedoid", "facility",
                                  "facility_int"])
def test_randgreedi_equals_one_level_over_every_lane(world4, world2, world,
                                                     name):
    results, cases = (world4[0], world4[1]) if world == 4 else world2
    case = cases[f"randgreedi_{name}"]
    want, _ = _single(case, (world,))
    want, _ = _single(case, (world,), want, 1)
    got = [r[case["key"]]["root"] for r in results]
    for g in got:
        for f in FIELDS:
            np.testing.assert_array_equal(g[f], got[0][f])
    _hold_lanes(name, {f: want[f][:1] for f in FIELDS},
                {f: got[0][f][None] for f in FIELDS}, [None], [None], [None])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["kcover", "facility", "facility_int"])
def test_stream_distributed_equals_continuous(world4, world2, world, name):
    """Merge for merge, stream_select_distributed over `world` ranks is
    stream_select_continuous over as many stacked lanes (b = 2)."""
    results = world4[0] if world == 4 else world2[0]
    want, info = _continuous(name, world)
    for r in results:
        got = r[f"stream_{name}"]
        assert got["info"]["batches"] == info["batches"]
        assert got["info"]["lanes"] == world
        if name == "facility":
            np.testing.assert_allclose(got["info"]["merges"],
                                       info["merges"], rtol=1e-5)
        else:
            assert got["info"]["merges"] == info["merges"]
        np.testing.assert_array_equal(got["root"]["ids"], want.ids.numpy())
        np.testing.assert_array_equal(got["root"]["valid"],
                                      want.valid.numpy())
    merges = results[0][f"stream_{name}"]["info"]["merges"]
    assert all(b >= a for a, b in zip(merges, merges[1:]))


def test_port_sampler_draws_alike_on_ranks_and_lanes(world2):
    """The default LaneSampler gives the distributed tree the stacked
    tree's draws: the world-2 stochastic trees (the port's own sampler,
    seed 11) were held stage by stage above; here every rank's leaf draws
    are row `rank` of the stacked draws."""
    results, cases = world2
    case = cases["stochastic_kcover"]
    assert case.get("draws") is None and case["seed"] == 11
    s = TGML.LaneSampler(11)
    full = s(0, 2, K, N // 2, 12)
    for rank in range(2):
        assert torch.equal(TGML._draws(s, 0, 2, K, N // 2, 12, None)[rank],
                           full[rank])
    leaves = _stack(results, "stochastic_kcover", 0)
    want, _ = _single(case, (2,))
    np.testing.assert_array_equal(leaves["ids"], want["ids"])


# ---------------------------------------------------------------------------
# against the reference's own distributed drivers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["kcover", "facility"])
@pytest.mark.parametrize("tag", ["gml", "rg", "stream"])
def test_world4_matches_reference_drivers(world4, name, tag):
    results, _, ref = world4
    src = "kcover" if name == "kcover" else "facility_int"
    key = {"gml": f"tree_{src}", "rg": f"randgreedi_{src}",
           "stream": f"stream_{src}"}[tag]
    for r in results:
        root = r[key]["driver" if tag == "gml" else "root"]
        for f in ("ids", "valid", "value", "evals"):
            np.testing.assert_array_equal(
                root[f], ref[f"{name}_{tag}_{f}"].astype(root[f].dtype),
                err_msg=f"{key} {f}")
        if tag == "stream":
            assert r[key]["info"]["merges"] == list(
                ref[f"{name}_stream_merges"])


@pytest.mark.parametrize("spec", ["greedyml:facility", "randgreedi:facility"])
def test_select_coreset_mesh_branch_matches_reference(world4, spec):
    results, _, ref = world4
    for r in results:
        np.testing.assert_array_equal(r[spec]["ids"], ref[spec])


def test_select_coreset_mesh_branch_equals_stacked_dispatcher(world4):
    """Every rank passes its block and gets the stacked dispatcher's root;
    'greedy' is the sequential Greedy over the whole pool."""
    results, cases, _ = world4
    for key, radices in (("greedyml:facility", (2, 2)),
                         ("randgreedi:facility", (4,)),
                         ("coreset_real", (2, 2))):
        x = cases[key]["data"]
        disp = TGML.LevelDispatcher(_objective("facility"), K, radices)
        ids, pay, val = TGML.shard_lanes(torch.arange(N), torch.as_tensor(x),
                                         torch.ones(N, dtype=torch.bool), 4)
        sols = disp.leaves(ids, pay, val)
        for lvl in range(disp.num_levels):
            sols = disp.level(sols, lvl)
        want = sols.ids[0][sols.valid[0]].numpy()
        for r in results:
            np.testing.assert_array_equal(r[key]["ids"], want)
    x = cases["greedy:facility"]["data"]
    want = TG.greedy(_objective("facility"), torch.arange(N),
                     torch.as_tensor(x), torch.ones(N, dtype=torch.bool), K)
    for r in results:
        np.testing.assert_array_equal(r["greedy:facility"]["ids"],
                                      want.ids[want.valid].numpy())


# ---------------------------------------------------------------------------
# world size 1, in this process, against the reference's 1-device mesh
# ---------------------------------------------------------------------------


def _jit_shard_map(monkeypatch):
    """As in REFERENCE_SNIPPET: the reference's shard_map'ed functions
    jit-compiled (exact data only)."""
    import jax
    import jax.experimental.shard_map as SM
    import repro.core.greedyml as GML
    eager = SM.shard_map
    jitted = lambda *a, **k: jax.jit(eager(*a, **k))
    monkeypatch.setattr(SM, "shard_map", jitted)
    monkeypatch.setattr(GML, "shard_map", jitted)


def _reference_mesh1(name, data, **kw):
    import jax
    import jax.numpy as jnp
    from repro.core.functions import make_objective as j_make
    from repro.core.greedyml import (greedyml_distributed as j_gml,
                                     randgreedi_distributed as j_rg)
    mesh = jax.make_mesh((1,), ("m",))
    obj = j_make(_rule(name), backend="ref",
                 **({"universe": UNIVERSE} if name == "kcover" else {}))
    args = (obj, jnp.arange(N, dtype=jnp.int32), jnp.asarray(data),
            jnp.ones(N, bool), K, mesh, ("m",))
    return j_gml(*args, **kw), j_rg(*args)


@pytest.mark.parametrize("name", ["kcover", "facility_int"])
def test_world1_matches_reference_one_device_mesh(world1, name,
                                                  monkeypatch):
    _jit_shard_map(monkeypatch)
    data = _data(name, 1)
    aug = _aug(name, 1)
    j_gml, j_rg = _reference_mesh1(
        name, data, augment=None if aug is None else __import__(
            "jax.numpy", fromlist=["asarray"]).asarray(aug))
    obj = _objective(name)
    pay = data.view(np.int32) if data.dtype == np.uint32 else data
    args = (obj, np.arange(N), pay, np.ones(N, bool), K, world1)
    t_gml = TGML.greedyml_distributed(*args, augment=aug)
    t_rg = TGML.randgreedi_distributed(*args)
    for want, got in ((j_gml, t_gml), (j_rg, t_rg)):
        for f in ("ids", "valid", "value", "evals"):
            np.testing.assert_array_equal(
                getattr(got, f).numpy(),
                np.asarray(getattr(want, f)).astype(
                    getattr(got, f).numpy().dtype), err_msg=f)


def test_world1_stream_matches_reference_one_device_mesh(world1,
                                                         monkeypatch):
    _jit_shard_map(monkeypatch)
    import jax
    import jax.numpy as jnp
    from repro.core.functions import make_objective as j_make
    from repro.data.synthetic import Stream as JStream
    from repro.streaming.driver import stream_select_distributed as j_sd
    from repro_torch.streaming import stream_select_distributed
    st = _stream("kcover", 1)
    want, jinfo = j_sd(j_make("kcover", universe=S_UNIVERSE, backend="ref"),
                       JStream(st.payloads, st.order, st.batch), S_K,
                       jax.make_mesh((1,), ("m",)), ("m",), merge_every=2,
                       backend="ref")
    got, info = stream_select_distributed(_objective("kcover", S_UNIVERSE), st,
                                          S_K, world1, merge_every=2)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert info["merges"] == jinfo["merges"]
    assert info["batches"] == jinfo["batches"] == 5


def test_world1_seed_threading(world1):
    """The counterpart of the reference's test_distributed_seed_threading:
    an explicit seed repeats, different seeds differ, and the stacked
    dispatcher with the same seed draws the same."""
    x = _data("facility", 6)[:96]
    obj = _objective("facility")
    args = (obj, np.arange(96), x, np.ones(96, bool), 6, world1)
    kw = dict(sample_leaf=24, sample_level=3)

    def ids(**more):
        return tuple(TGML.greedyml_distributed(*args, **kw, **more)
                     .ids.tolist())

    assert ids(seed=5) == ids(seed=5)
    assert len({ids(seed=s) for s in range(4)}) > 1
    disp = TGML.LevelDispatcher(obj, 6, (1,), seed=5, **kw)
    sols = disp.leaves(torch.arange(96)[None], torch.as_tensor(x)[None],
                       torch.ones(1, 96, dtype=torch.bool))
    sols = disp.level(sols, 0)
    assert tuple(sols.ids[0].tolist()) == ids(seed=5)
    rg = [TGML.randgreedi_distributed(*args, sample_leaf=24, seed=3).ids
          for _ in range(2)]
    assert torch.equal(rg[0], rg[1])


def test_world1_log_records_each_collective(world1):
    world1.log = []
    try:
        TGML.greedyml_distributed(_objective("kcover"), np.arange(N),
                                  _data("kcover").view(np.int32),
                                  np.ones(N, bool), K, world1)
        ops = [(r["op"], r["level"]) for r in world1.log]
        assert ops == [("all_gather", 0)] * 3 + [("broadcast", None)] * 5
        assert world1.log[1]["bytes"] == K * _data("kcover").shape[1] * 4
    finally:
        world1.log = None


def test_new_modules_stand_alone():
    """The mesh, the launcher, the distributed drivers and the coreset
    selection import neither JAX nor the reference (a fresh interpreter),
    and their sources name neither."""
    import re
    names = ["repro_torch.launch.mesh", "repro_torch.launch.spawn",
             "repro_torch.core.greedyml", "repro_torch.streaming.driver",
             "repro_torch.data.selection"]
    code = ("import importlib, sys\n"
            f"for m in {names!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [n for n in sys.modules\n"
            "       if n.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)\b", re.M)
    for m in names:
        path = ROOT / "src" / (m.replace(".", "/") + ".py")
        assert not pattern.search(path.read_text()), path
