"""The port's train step on a one-device ("data", "model") mesh
(`launch/mesh.py::make_local_mesh`: microbatches of one, as the
reference's local mesh gives) under the bf16 and the keyless int8
gradient codecs, held against the reference's as
`test_torch_train_steps.py` holds the unsharded cases (the int8 case's
second step from the reference's state, see `_run` there); the int8
codec scales each stacked leaf of the reference as one tensor. Also the
abstract state, the state's and the batch's shardings over the mesh,
and the production meshes' refusal (ROADMAP item 10c).
"""
import jax
import pytest

from repro.configs import registry as JR
from repro.configs.base import OptimConfig as JOptim
from repro.launch import steps as JSteps

from repro_torch.configs import registry as TR
from repro_torch.configs.base import OptimConfig, ShapeConfig
from repro_torch.launch import mesh as TM
from repro_torch.launch import steps
from repro_torch.optim.tree import tree_map

from test_torch_train_steps import hold_case


@pytest.mark.parametrize("case", ["mesh_bf16", "mesh_int8"])
def test_mesh_train_steps_match_reference(case):
    hold_case(case)


def test_abstract_state_and_shardings_match_reference():
    cfg, jcfg = TR.smoke_config("smollm-135m"), JR.smoke_config(
        "smollm-135m")
    for name in ("adamw", "adafactor"):
        st, axes = steps.abstract_state(cfg, OptimConfig(name=name))
        jst, jaxes = JSteps.abstract_state(jcfg, JOptim(name=name))
        assert st["params"]["embed"]["tok"].is_meta
        if name == "adafactor":
            shapes = jax.tree.map(lambda a: tuple(a.shape), jst["opt"]["fac"])
            assert tree_map(lambda t: tuple(t.shape),
                            st["opt"]["fac"]) == shapes
            assert axes["opt"]["fac"] == jaxes["opt"]["fac"]
    mesh = TM.make_local_mesh(1, 1, device="cpu")
    assert isinstance(mesh, TM.LocalMesh)
    st, axes = steps.abstract_state(cfg, OptimConfig())
    sh = steps.state_shardings(axes, st, mesh)
    assert sh["params"]["blocks"]["0"]["attn"]["wq"].spec == ()
    specs, bsh = steps.batch_shardings(cfg, ShapeConfig("t", "train", 16, 4),
                                       mesh)
    assert set(bsh["batch"]) == {"tokens", "labels"}
    assert bsh["batch"]["tokens"].spec == ()


def test_production_meshes_raise():
    for multi in (False, True):
        with pytest.raises(NotImplementedError, match="10c"):
            TM.make_production_mesh(multi_pod=multi)
