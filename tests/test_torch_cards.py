"""One rank on each card under NCCL, rehearsed on the CPU (no card here):

  * `launch/spawn.py::rank_card` — the card run_ranks makes current in
    rank r before its NCCL group forms — is the mesh's default placement
    (`rank_devices`), checked by `check_devices`; run_ranks refuses an
    NCCL world it has no card for before it spawns anything;
  * chip_smoke.py's "cuda:rank" placement resolves rank r to card r and
    leaves the TreeMesh its default placement;
  * a rank's data made from its recipe equals the parent's (checksums);
  * `TreeMesh.log` marks each group's first collective, which
    `_levels_of` reports apart;
  * the whole `distributed_cards` phase over 4 gloo ranks on the CPU at
    small sizes: every driver's root on every rank equal to its stacked
    yardstick; without 4 cards the phase runs nothing and says so.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import SubmodularConfig
from repro_torch.core.functions import make_objective
from repro_torch.core.greedyml import greedyml_distributed
from repro_torch.data import synthetic as TSyn
from repro_torch.launch import mesh as TM
from repro_torch.launch.spawn import rank_card, run_ranks

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402


def _noop(rank):
    return rank


def test_rank_card_is_the_mesh_placement():
    for world in (1, 2, 4):
        devices = TM.rank_devices(world, 4)
        for r in range(world):
            assert rank_card("nccl", r, world, device_count=4) == \
                devices[r] == torch.device("cuda", r)
    assert rank_card("gloo", 3, 4, device_count=4) is None
    assert rank_card("GLOO", 0, 1, device_count=0) is None
    with pytest.raises(ValueError, match="no two ranks on one device"):
        rank_card("nccl", 1, 4, device_count=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rank_card("nccl", 0, 2, device_count=0)


def test_run_ranks_refuses_nccl_without_a_card_for_each_rank(tmp_path):
    if torch.cuda.device_count() >= 2:
        pytest.skip("this machine has the cards; the refusal is checked "
                    "where there are too few")
    with pytest.raises((RuntimeError, ValueError)):
        run_ranks(_noop, 2, backend="nccl", timeout=30,
                  workdir=str(tmp_path))
    assert list(tmp_path.iterdir()) == []      # nothing was spawned


def test_cuda_rank_placement_resolves_to_the_ranks_card(monkeypatch):
    made_current = []
    monkeypatch.setattr(torch.cuda, "set_device", made_current.append)
    for r in range(4):
        card, mesh_dev = C._rank_place(torch, r, "cuda:rank")
        assert card == torch.device("cuda", r) == TM.rank_devices(4, 4)[r]
        assert mesh_dev is None                 # the mesh places itself
        assert C._card_of(torch, "cuda:rank", r) == f"cuda:{r}"
    assert made_current == [torch.device("cuda", r) for r in range(4)]
    assert C._rank_place(torch, 2, "cpu") == (torch.device("cpu"),
                                               torch.device("cpu"))
    TM.check_devices("nccl", [C._rank_place(torch, r, "cuda:rank")[0]
                              for r in range(4)])


def test_rank_data_recipes_equal_the_generators():
    emb = C._make_data(torch, ("embeddings", 96, 8, 11), "cpu")
    assert torch.equal(emb, torch.as_tensor(TSyn.gen_embeddings(96, 8,
                                                                seed=11)))
    kdom = C._make_data(torch, ("kdom", 128, 128, 11), "cpu")
    want = TSyn.pack_bitmaps(TSyn.gen_graph_road(128, seed=11), 128)
    assert np.array_equal(kdom.numpy().view(np.uint32), want)
    kcov = C._make_data(torch, ("kcover", 200, 100, 3, 15.0), "cpu")
    want = TSyn.pack_bitmaps(TSyn.gen_kcover(200, 100, seed=3,
                                             avg_size=15.0), 100)
    assert np.array_equal(kcov.numpy().view(np.uint32), want)
    img = C._make_data(torch, ("images", 40, 12, 5, 13), "cpu")
    assert torch.equal(img, TSyn.gen_images_on(40, 12, classes=5, seed=13,
                                               device="cpu"))
    # a tensor handed to a rank is taken as it is; a recipe is made and
    # summed
    got, summed = C._rank_data(torch, emb, "cpu")
    assert got is emb and summed is None
    s = C._checksum(torch, emb)
    got, summed = C._rank_data(torch, ("embeddings", 96, 8, 11), "cpu")
    assert torch.equal(got, emb) and summed == s
    # the checksum sees one changed word, and a moved row
    assert C._checksum(torch, emb.clone()) == s
    bumped = emb.clone()
    bumped.view(torch.int32)[50, 3] += 1
    assert C._checksum(torch, bumped) != s
    assert C._checksum(torch, emb.flip(0)) != s
    assert C._checksum(torch, kcov, rows=7) == C._checksum(torch, kcov)


@pytest.fixture()
def world1(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_log_marks_each_groups_first_collective(world1):
    mesh = TM.make_tree_mesh((1,), device="cpu")
    obj = make_objective("facility", device="cpu")
    x = TSyn.gen_embeddings(32, 4, seed=1)
    args = (obj, np.arange(32), x, np.ones(32, bool), 4, mesh)
    mesh.log = []
    greedyml_distributed(*args)
    greedyml_distributed(*args)
    ops = [(r["op"], r["level"], r["first"]) for r in mesh.log]
    per_run = ([("all_gather", 0, False)] * 3
               + [("broadcast", None, False)] * 5)
    # at world size 1 the level's group is the world, whose first
    # collective is the first gather: the broadcasts reuse it
    assert ops == [("all_gather", 0, True)] + per_run[1:] + per_run
    levels = {d["level"]: d for d in C._levels_of(mesh.log)}
    assert levels[0]["calls"] == 6 and levels[0]["first_calls"] == 1
    assert levels["broadcast"]["first_calls"] == 0
    assert levels[0]["first_bytes"] == mesh.log[0]["bytes"]
    assert levels[0]["first_seconds"] == mesh.log[0]["seconds"]
    # RandGreedi's flat copy shares the record of groups used
    flat = mesh.flat()
    assert flat._used_groups is mesh._used_groups


def test_distributed_cards_phase_on_cpu_gloo(monkeypatch, capsys):
    km = SubmodularConfig(objective="kmedoid", k=6, n=600, feature_dim=48,
                          num_machines=32, branching=2, seed=13)
    kd = SubmodularConfig(objective="kdom", k=8, n=2048, universe=2048,
                          num_machines=8, branching=2, seed=11)
    kv = SubmodularConfig(objective="kcover", k=16, n=2000, universe=1000,
                          num_machines=8, branching=2, seed=3)
    monkeypatch.setattr(C, "STREAM_BATCH", 32)
    monkeypatch.setattr(C, "MERGE_EVERY", 8)
    C.phase_distributed_cards(torch, km, kd, kv, backend="gloo",
                              rank_dev="cpu", card="cpu", emb_n=512,
                              emb_d=16, coreset_k=8, shard_k=6,
                              deadline=240)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    drivers = {ln["driver"]: ln for ln in lines if "driver" in ln}
    assert list(drivers) == ["kmedoid", "kdom", "coreset", "stream",
                             "sharded"]
    for name in ("kmedoid", "kdom"):
        d = drivers[name]
        assert d["roots_equal_to_stacked"] and d["ranks"] == 4
        assert d["world_ops_equal"]
        assert d["radices"] == {"greedyml": [2, 2], "randgreedi": [4]}
        for r in range(4):
            st = d["ranks_greedyml"][str(r)]
            assert [s["stage"] for s in st["stages"]] == [0, 1, 2]
            assert [lv["level"] for lv in st["collectives"]] == [
                0, 1, "broadcast"]
    assert drivers["coreset"]["ids_equal_to_stacked"]
    assert drivers["coreset"]["selected"] == 8
    assert drivers["stream"]["equal_to_continuous"]
    assert drivers["stream"]["continuous_computed_here"]
    assert drivers["sharded"]["bit_for_bit_with_stacked"]
    assert lines[-1]["ran"] is True and lines[-1]["drivers"] == list(drivers)


def test_distributed_cards_phase_needs_four_cards(capsys):
    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("this machine has four cards; the phase runs there")
    cfg = SubmodularConfig(objective="kmedoid", k=2, n=8, feature_dim=2)
    assert C.phase_distributed_cards(torch, cfg, cfg, cfg) == {}
    (line,) = capsys.readouterr().out.splitlines()
    rec = json.loads(line)
    assert rec["phase"] == "distributed_cards" and rec["ran"] is False
    assert rec["cards"] == torch.cuda.device_count() and "4 cards" in \
        rec["why"]
