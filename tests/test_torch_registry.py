"""The port's config registry (`repro_torch/configs/registry.py`,
`configs/base.py` whole and the ten model configs) held field for field
against the reference's (`src/repro/configs/`)."""
import dataclasses

import pytest

from repro.configs import base as JB
from repro.configs import registry as JR

from repro_torch.configs import base as TB
from repro_torch.configs import registry as TR


def test_registry_names_are_the_references():
    assert list(TR.ARCHS) == list(JR.ARCHS)
    assert list(TR.PROBLEMS) == list(JR.PROBLEMS) == [
        "paper-kcover", "paper-kdom", "paper-kmedoid"]


@pytest.mark.parametrize("arch", list(JR.ARCHS))
def test_arch_config_equals_reference(arch):
    got, want = TR.get_arch(arch), JR.get_arch(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert got.mixer_pattern() == want.mixer_pattern()
    assert got.ffn_pattern() == want.ffn_pattern()
    assert (got.is_encdec, got.is_attention_free, got.is_subquadratic,
            got.resolved_head_dim) == (
        want.is_encdec, want.is_attention_free, want.is_subquadratic,
        want.resolved_head_dim)


@pytest.mark.parametrize("arch", list(JR.ARCHS))
def test_smoke_config_equals_reference(arch):
    got, want = TR.smoke_config(arch), JR.smoke_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


@pytest.mark.parametrize("name", list(JR.PROBLEMS))
def test_problem_config_equals_reference(name):
    assert (dataclasses.asdict(TR.PROBLEMS[name])
            == dataclasses.asdict(JR.PROBLEMS[name]))


def test_cells_and_skip_reasons_equal_reference():
    assert list(TR.cells(include_skipped=True)) == list(
        JR.cells(include_skipped=True))
    assert list(TR.cells()) == list(JR.cells())
    assert len(list(TR.cells(include_skipped=True))) == 40


@pytest.mark.parametrize("shape", [s.name for s in JB.SHAPES])
def test_shapes_equal_reference(shape):
    assert (dataclasses.asdict(TR.get_shape(shape))
            == dataclasses.asdict(JR.get_shape(shape)))
    assert (dataclasses.asdict(TR.smoke_shape(shape))
            == dataclasses.asdict(JR.smoke_shape(shape)))
    for arch in JR.ARCHS:
        assert TR.shape_skip_reason(TR.get_arch(arch), TR.get_shape(
            shape)) == JR.shape_skip_reason(JR.get_arch(arch),
                                            JR.get_shape(shape))


def test_base_dataclasses_equal_reference():
    assert [dataclasses.asdict(s) for s in TB.SHAPES] == [
        dataclasses.asdict(s) for s in JB.SHAPES]
    assert set(TB.SHAPES_BY_NAME) == set(JB.SHAPES_BY_NAME)
    for cls in ("MoEConfig", "SSMConfig", "FrontendConfig", "OptimConfig",
                "TrainConfig", "MeshConfig"):
        assert (dataclasses.asdict(getattr(TB, cls)())
                == dataclasses.asdict(getattr(JB, cls)())), cls
    for cls in ("ModelConfig", "ShapeConfig", "SubmodularConfig"):
        assert ([f.name for f in dataclasses.fields(getattr(TB, cls))]
                == [f.name for f in dataclasses.fields(getattr(JB, cls))])
    mesh = TB.MeshConfig()
    assert (mesh.num_devices, mesh.is_multi_pod) == (256, False)
    ssm = TB.SSMConfig()
    assert (ssm.d_inner(2048), ssm.n_heads(2048)) == (4096, 64)


def test_registry_errors_and_frozen_configs():
    with pytest.raises(KeyError, match="unknown --arch"):
        TR.get_arch("gpt-5")
    with pytest.raises(KeyError):
        TR.get_shape("train_1m")
    cfg = TR.get_arch("qwen2-7b")
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.d_model = 1
    with pytest.raises(AssertionError):
        TB.ModelConfig("x", "rnn", 1, 8, 1, 1, 8, 8)
    assert cfg.replace(num_layers=2).num_layers == 2


def test_full_shape_constants_are_not_registry_names():
    from repro_torch.configs.paper_kcover import KOSARAK
    from repro_torch.configs.paper_kmedoid import TINY_IMAGENET
    assert KOSARAK not in TR.PROBLEMS.values()
    assert TINY_IMAGENET not in TR.PROBLEMS.values()
    assert TR.PROBLEMS["paper-kmedoid"].num_machines == \
        TINY_IMAGENET.num_machines
