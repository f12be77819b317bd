"""The sharded trainer's layouts at full size, with no devices: every
arch of the registry at its full config, on both production meshes —
the (16, 16) ("data", "model") mesh of 256 ranks and the (2, 16, 16)
("pod", "data", "model") mesh of 512 — gets from `steps.state_shardings`
the reference's `resolve_spec` of every parameter and optimizer leaf
(AdamW's moments, Adafactor's factored state), the reference resolving
over ``jax.sharding.AbstractMesh``. The port keeps one tensor a layer
where the reference stacks a period position's layers, so a block
leaf's reference spec is the port's behind the stack's unsharded
"layers" dim.

`launch/mesh.py::make_production_mesh` builds both meshes under a fake
process group (torch's ``"fake"`` backend over a ``FakeStore``: one
process playing one rank of the world, collectives no-ops) and refuses
any other world. On them qwen2.5-3b's state on the meta device gets,
rank by rank, the shard shapes the specs' arithmetic gives, and the
("data", "pod") entry of the multi-pod mesh splits data-major, pod-minor
as the reference's PartitionSpec does (a ``_StridedShard`` on "pod").
"""
import contextlib
import functools
import math

import jax
import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as JR
from repro.configs.base import OptimConfig as JOptim
from repro.launch import steps as JSteps
from repro.sharding import axes as JA

from repro_torch.configs import registry as TR
from repro_torch.configs.base import OptimConfig
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import steps
from repro_torch.optim.tree import stacked_leaves
from repro_torch.sharding import axes as TA

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _trim(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _ref_specs(tree, axes, mesh):
    specs = JA.tree_pspecs(axes, tree, mesh)
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k)
        else:
            out[path] = _trim(tuple(node))
    walk(specs, "")
    return out


def _port_flat(tree, path=""):
    out = {}
    for k, v in tree.items():
        p = f"{path}/{k}" if path else k
        if isinstance(v, dict):
            out.update(_port_flat(v, p))
        else:
            out[p] = v
    return out


@functools.lru_cache(maxsize=None)
def _port_state(arch: str, name: str):
    return steps.abstract_state(TR.get_arch(arch), OptimConfig(name=name))


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", sorted(TR.ARCHS))
def test_full_size_state_specs_equal_reference(arch, mesh_kind):
    shape, names = MESHES[mesh_kind]
    sizes = dict(zip(names, shape))
    jmesh = jax.sharding.AbstractMesh(shape, names)
    for name in ("adamw", "adafactor"):
        st, axes = _port_state(arch, name)
        jst, jaxes = JSteps.abstract_state(JR.get_arch(arch),
                                           JOptim(name=name))
        want = _ref_specs(jst, jaxes, jmesh)
        got = _port_flat(TA.tree_pspecs(axes, steps.as_dict(st), sizes))
        params = st["params"]
        layout = stacked_leaves(params)
        groups = [("params", "params")]
        if name == "adamw":
            groups += [("opt/m", "opt/m"), ("opt/v", "opt/v")]
        n = 0
        for port_key, ref_key in groups:
            for leaf in layout:
                for path in leaf.port_paths:
                    spec = got[f"{port_key}/{path}"]
                    if leaf.stacked:
                        spec = _trim((None,) + spec)
                    assert spec == want[f"{ref_key}/{leaf.path}"], (
                        arch, mesh_kind, name, port_key, path)
                    n += 1
        if name == "adafactor":
            fac = {k: v for k, v in got.items() if k.startswith("opt/fac")}
            assert fac == {k: v for k, v in want.items()
                           if k.startswith("opt/fac")}, (arch, mesh_kind)
            n += len(fac)
        assert n > 0


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """This process as rank `rank` of a fake process group of `world`."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _qwen_state():
    return steps.abstract_state(TR.get_arch("qwen2.5-3b"), OptimConfig())


@pytest.mark.parametrize("mesh_kind", list(MESHES))
def test_production_mesh_builds_under_a_fake_group(mesh_kind):
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, names = MESHES[mesh_kind]
    world = math.prod(shape)
    st, axes = _qwen_state()
    # ranks at the mesh's corners and inside it
    for rank in (0, 1, 17, world - 1):
        with fake_world(world, rank):
            mesh = TMESH.make_production_mesh(
                multi_pod=mesh_kind == "multi", device="cpu")
            assert tuple(mesh.shape) == shape
            assert tuple(mesh.mesh_dim_names) == names
            coord = dict(zip(names, mesh.get_coordinate()))
            sizes = TA.mesh_shape(mesh)
            sh = _port_flat(steps.state_shardings(axes, st, mesh))
            tensors = _port_flat(steps.as_dict(st))
            assert sh.keys() == tensors.keys()
            for key, s in sh.items():
                t = tensors[key]
                local, offset = compute_local_shape_and_global_offset(
                    t.shape, mesh, s.placements)
                want, want_off = [], []
                for d, size in enumerate(t.shape):
                    entry = s.spec[d] if d < len(s.spec) else None
                    axes_d = () if entry is None else (
                        (entry,) if isinstance(entry, str) else entry)
                    n = math.prod(sizes[a] for a in axes_d)
                    # the entry's axes major first: its block index
                    block = 0
                    for a in axes_d:
                        block = block * sizes[a] + coord[a]
                    want.append(size // n)
                    want_off.append(block * (size // n))
                assert tuple(local) == tuple(want), (key, s)
                assert tuple(offset) == tuple(want_off), (key, s, coord)
            wq = sh["params/blocks/0/attn/wq"]
            if mesh_kind == "multi":
                assert wq.spec[0] == ("data", "pod")
                assert "_StridedShard" in repr(wq.placements[0])
            else:
                assert wq.spec[0] == "data"


def test_production_meshes_raise_at_another_world():
    for multi in (False, True):
        with pytest.raises(ValueError, match="this process has 1"):
            TMESH.make_production_mesh(multi_pod=multi, device="cpu")
    with fake_world(4):
        with pytest.raises(ValueError, match=r"256 ranks; this process "
                                             r"has 4"):
            TMESH.make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match=r"512 ranks; this process "
                                             r"has 4"):
            TMESH.make_production_mesh(multi_pod=True, device="cpu")
