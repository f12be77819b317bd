"""The sharded train step on 4 gloo ranks of a (2, 2) ("data", "model")
mesh for the two architectures whose layers are not attention and a
dense MLP: the qwen3-moe smoke config (its experts on "model"; the
routing, dispatch and combine on the whole groups on every rank) under
AdamW for 2 steps, and mamba2-1.3b (d_inner, the SSM heads and the
conv channels on "model") for 1. Each is held as `test_torch_train_
shard.py` holds smollm-135m: against the port's one-device step with
the same microbatches and against the reference's step jitted with
`state_shardings` over 4 forced host devices, float32 and float64
(`test_torch_train_shard.hold_runs`), every rank gathering one state.
"""
import pytest

from test_torch_train_shard import hold_runs, world4_runs

CASES = {
    "moe": ("qwen3-moe-30b-a3b", {"name": "adamw"}, 2),
    "mamba": ("mamba2-1.3b", {"name": "adamw"}, 1),
}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return world4_runs(tmp_path_factory.mktemp("train_shard4_models"),
                       CASES, False)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_holds_one_device(world4, name):
    ranks, one, _, states0 = world4
    runs = ranks[0]["runs"]
    hold_runs(name, CASES[name][1], states0[name], runs[(name, False)],
              runs[(name, True)], one[(name, False)], one[(name, True)],
              "one-device")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_holds_reference(world4, name):
    ranks, _, reference, states0 = world4
    runs, ref = ranks[0]["runs"], reference["runs"]
    hold_runs(name, CASES[name][1], states0[name], runs[(name, False)],
              runs[(name, True)], ref[(name, False)], ref[(name, True)],
              "reference")


def test_every_rank_gathers_one_state(world4):
    ranks, _, _, _ = world4
    for key, d in ranks[0]["digests"].items():
        assert all(r["digests"][key] == d for r in ranks[1:]), key
