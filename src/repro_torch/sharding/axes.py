"""Logical-axis sharding, the slice that checkpoint resharding needs
(answers `src/repro/sharding/axes.py:20-48, 123-200`).

Tensors are annotated with *logical* axis names; a rules table maps each
logical name to a priority list of mesh axes. Resolution is
divisibility-aware: the first candidate mesh axis (or axis tuple) whose
size divides the dimension AND is not already used by another dim of
the same tensor wins; otherwise the dim is replicated. A resolved spec
is a tuple in the reference's PartitionSpec form (an entry per tensor
dim: None, an axis name, or a tuple of names; trailing Nones trimmed).

Where the reference builds NamedShardings, the port maps a spec to
`torch.distributed.tensor` placements over a `DeviceMesh` with named
dimensions: ``Shard(d)`` on each mesh dim that splits tensor dim d,
``Replicate()`` on the others (`placements`, `TensorSharding`).

A multi-axis entry keeps the reference's order: ``("data", "pod")``
splits a dim data-major, pod-minor. Where that order is not the mesh's
(the mesh is ("pod", "data", "model")), the earlier mesh dim takes a
``_StridedShard`` whose split factor is the later dims' size, so each
rank holds the rows the reference's device holds.

The model zoo's part (`:30-121, 160-278`): the activation rules, the
'default' and 'dp_only' profiles, ``ParamBuilder`` (parameters drawn
from a torch.Generator, each one's logical axes recorded so that a
trainer can shard them), ``unflatten_axes``, ``named_sharding`` and
``constrain``. Serving runs on one device and passes no mesh, where
``constrain`` returns its input; over a mesh of more than one device it
redistributes a DTensor to the act rules' placements (the reference's
``with_sharding_constraint``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[str, Tuple[str, ...]]
# logical axis name -> priority list of mesh-axis candidates
AxisRules = Tuple[Tuple[str, Tuple[MeshAxes, ...]], ...]
Spec = Tuple[Optional[MeshAxes], ...]

DEFAULT_PARAM_RULES: AxisRules = (
    ("vocab", (("model",), ("data", "pod"), ("data",))),
    ("embed", (("data", "pod"), ("data",))),  # FSDP dim of every weight
    ("embed_tp", (("model",),)),           # row-parallel input dim (down-proj)
    ("heads", (("model",),)),
    ("kv_heads", (("model",),)),
    ("head_dim", ()),
    ("mlp", (("model",),)),
    ("experts", (("model",),)),            # expert parallelism
    ("expert_mlp", ()),
    ("expert_embed", (("data", "pod"), ("data",))),  # FSDP inside experts
    ("dinner", (("model",),)),             # mamba d_inner / conv channels
    ("ssm_heads", (("model",),)),
    ("state", ()),
    ("conv", ()),
    ("layers", ()),                        # scan-stacked dim, never sharded
    ("frontend", ()),
    ("norm", ()),
)

DEFAULT_ACT_RULES: AxisRules = (
    ("layers", ()),                        # stacked caches carry this dim
    ("act_batch", (("pod", "data"), ("data",), ("pod",))),
    ("act_seq", (("data",), ("model",))),  # sequence parallel (long context)
    ("act_kv_seq", (("data",), ("model",))),
    ("act_heads", (("model",),)),
    ("act_kv_heads", (("model",),)),
    ("act_embed", ()),
    ("act_mlp", (("model",),)),
    ("act_experts", (("model",),)),
    ("act_vocab", (("model",), ("data",))),
    ("act_head_dim", ()),
    ("act_state", ()),
    ("act_expert_embed", (("data",),)),
)

# 'dp_only': pure data parallelism, the model axis joining the batch —
# the shape for small models where tensor parallelism only replicates
DP_ONLY_PARAM_RULES: AxisRules = tuple(
    (name, ((("data", "pod"), ("data",)) if name in
            ("embed", "expert_embed", "vocab") else ()))
    for name, _ in DEFAULT_PARAM_RULES)

DP_ONLY_ACT_RULES: AxisRules = (
    ("layers", ()),
    ("act_batch", (("pod", "data", "model"), ("data", "model"),
                   ("pod", "data"), ("data",))),
    ("act_seq", ()),
    ("act_kv_seq", (("data",), ("model",))),
    ("act_heads", ()),
    ("act_kv_heads", ()),
    ("act_embed", ()),
    ("act_mlp", ()),
    ("act_experts", ()),
    ("act_vocab", ()),
    ("act_head_dim", ()),
    ("act_state", ()),
    ("act_expert_embed", ()),
)

_PROFILES = {
    "default": (DEFAULT_PARAM_RULES, DEFAULT_ACT_RULES),
    "dp_only": (DP_ONLY_PARAM_RULES, DP_ONLY_ACT_RULES),
}
_CURRENT = ["default"]


def use_profile(name: str) -> None:
    if name not in _PROFILES:
        raise KeyError(f"unknown sharding profile {name!r}; known: "
                       f"{sorted(_PROFILES)}")
    _CURRENT[0] = name


def current_profile() -> str:
    return _CURRENT[0]


def current_param_rules() -> AxisRules:
    return _PROFILES[_CURRENT[0]][0]


def current_act_rules() -> AxisRules:
    return _PROFILES[_CURRENT[0]][1]


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh with named dims, or of a mapping
    (any object with a ``shape`` mapping, e.g. the reference's meshes)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _axes_tuple(axes: MeshAxes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def resolve_spec(logical: Sequence[Optional[str]], shape: Sequence[int],
                 mesh, rules: Optional[AxisRules] = None) -> Spec:
    """Per-dim logical names → a spec, divisibility-aware (the first free
    candidate whose size divides the dim and exceeds 1 wins).
    rules=None → the current profile's param rules."""
    rules = current_param_rules() if rules is None else rules
    if len(logical) != len(shape):
        raise ValueError(f"{tuple(logical)} names {len(logical)} dims of a "
                         f"{len(shape)}-dim shape {tuple(shape)}")
    sizes = mesh_shape(mesh)
    table: Dict[str, Tuple[MeshAxes, ...]] = dict(rules)
    used: set = set()
    out = []
    for name, dim in zip(logical, shape):
        choice: Optional[MeshAxes] = None
        if name is not None:
            if name not in table:
                raise KeyError(f"no sharding rule for logical axis {name!r}")
            for cand in table[name]:
                cand_t = _axes_tuple(cand)
                if not all(a in sizes for a in cand_t):
                    continue
                if any(a in used for a in cand_t):
                    continue
                size = math.prod(sizes[a] for a in cand_t)
                if dim % size == 0 and size > 1:
                    choice = cand_t if len(cand_t) > 1 else cand_t[0]
                    used.update(cand_t)
                    break
        out.append(choice)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _map2(fn, axes_tree, shaped_tree):
    """fn(axes, leaf) over parallel trees (dicts, lists) whose axes leaves
    are tuples of logical names."""
    if _is_axes(axes_tree):
        return fn(axes_tree, shaped_tree)
    if isinstance(axes_tree, dict):
        return {k: _map2(fn, axes_tree[k], shaped_tree[k])
                for k in axes_tree}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(_map2(fn, a, s)
                               for a, s in zip(axes_tree, shaped_tree))
    raise TypeError(f"no logical axes at a {type(axes_tree).__name__}")


def tree_pspecs(axes_tree: Any, shaped_tree: Any, mesh,
                rules: Optional[AxisRules] = None) -> Any:
    """A tree of specs from parallel trees of logical axes and shapes."""
    return _map2(lambda ax, leaf: resolve_spec(ax, leaf.shape, mesh, rules),
                 axes_tree, shaped_tree)


def placements(spec: Spec, mesh) -> tuple:
    """The DTensor placements of `spec` over `mesh`'s named dims:
    Shard(d) on each mesh dim that splits tensor dim d, Replicate()
    elsewhere. An entry of several axes splits its dim in the entry's
    order, major first: a pair whose minor axis comes first in the mesh
    gives that axis ``_StridedShard(d, split_factor=`` the major's
    size ``)``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    names = tuple(mesh.mesh_dim_names)
    sizes = mesh_shape(mesh)
    out = {a: Replicate() for a in names}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = _axes_tuple(entry)
        if list(axes) == sorted(axes, key=names.index):
            for a in axes:
                out[a] = Shard(d)
        elif len(axes) == 2:
            # (major, minor) with the minor axis first in the mesh: the
            # mesh's left-to-right split would make it major
            major, minor = axes
            out[minor] = _StridedShard(d, split_factor=sizes[major])
            out[major] = Shard(d)
        else:
            raise ValueError(f"no placements for {axes} out of the mesh's "
                             f"order {names}")
    return tuple(out[a] for a in names)


class TensorSharding:
    """A resolved spec over a DeviceMesh (the reference's NamedSharding):
    ``place(t)`` distributes a whole tensor by it
    (torch.distributed.tensor.distribute_tensor)."""

    def __init__(self, mesh, spec: Spec):
        self.mesh, self.spec = mesh, spec
        self.placements = placements(spec, mesh)

    def place(self, t):
        """The whole tensor `t`, which every rank holds alike, as a
        DTensor: each rank keeps its own shard (no collective)."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, self.mesh, list(self.placements),
                                 src_data_rank=None)

    def __repr__(self) -> str:
        return f"TensorSharding({self.spec}, {self.placements})"


def named_sharding(mesh, logical: Sequence[Optional[str]],
                   shape: Sequence[int],
                   rules: Optional[AxisRules] = None) -> TensorSharding:
    """The TensorSharding of a tensor of ``shape`` with per-dim logical
    names (the reference's NamedSharding of `resolve_spec`)."""
    return TensorSharding(mesh, resolve_spec(logical, shape, mesh, rules))


def tree_shardings(axes_tree, shaped_tree, mesh,
                   rules: Optional[AxisRules] = None):
    """A tree of TensorSharding (the reference's NamedSharding tree)."""
    return _map2(lambda ax, leaf: TensorSharding(
        mesh, resolve_spec(ax, leaf.shape, mesh, rules)),
        axes_tree, shaped_tree)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def spans(mesh) -> bool:
    """Whether `mesh` holds more than one device (a sharded path)."""
    return mesh is not None and math.prod(mesh_shape(mesh).values()) > 1


def is_device_mesh(mesh) -> bool:
    """Whether `mesh` is a torch DeviceMesh over a process group (the
    state on it is DTensors, even where it holds one device)."""
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


def full_tensor(t):
    """A DTensor's whole value on every rank (a collective: every rank
    calls it); any other tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def select0(t, i: int):
    """``t[i]``, a view of `t`'s storage, for a tensor whose dim 0 no
    mesh dim splits (a stack's layers). A DTensor's view is built from
    its local tensor, each split moved down one dim: torch 2.11's rule
    for ``select`` leaves a ``_StridedShard``'s dim where it was (the
    multi-pod FSDP split), which no later op can redistribute."""
    if not is_dtensor(t):
        return t[i]
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import Shard, _StridedShard
    moved = []
    for p in t.placements:
        if isinstance(p, _StridedShard):
            p = _StridedShard(p.dim - 1, split_factor=p.split_factor)
        elif isinstance(p, Shard):
            p = Shard(p.dim - 1)
        moved.append(p)
    local = t.to_local()[i]
    shape = tuple(t.shape[1:])
    stride = tuple(math.prod(shape[j + 1:]) for j in range(len(shape)))
    return DTensor.from_local(local, t.device_mesh, moved, run_check=False,
                              shape=shape, stride=stride)


def constrain(x: torch.Tensor, mesh, *logical: Optional[str],
              rules: Optional[AxisRules] = None) -> torch.Tensor:
    """The reference's with_sharding_constraint by logical activation
    axes (``rules``: the current profile's act rules by default): the
    input itself without a mesh or on a one-device mesh (the serving
    path); over a larger mesh a DTensor redistributed to the resolved
    placements (its values unchanged). A plain tensor there raises: it
    has left the sharded path."""
    if len(logical) != x.dim():
        raise ValueError(f"{logical} names {len(logical)} dims of a "
                         f"{x.dim()}-dim tensor")
    if not spans(mesh):
        return x
    if not is_dtensor(x):
        raise TypeError(f"constrain{tuple(logical)} over a mesh of "
                        f"{mesh_shape(mesh)} got a plain "
                        f"{type(x).__name__}: a value left the sharded "
                        "path")
    rules = current_act_rules() if rules is None else rules
    want = placements(resolve_spec(logical, x.shape, mesh, rules), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


_INITS = ("normal", "zeros", "ones", "uniform")


class ParamBuilder:
    """Creates parameters while recording their logical axes (the
    reference's ParamBuilder, `:220`). Draws come from ``generator``, a
    torch.Generator on ``device``, in creation order."""

    def __init__(self, generator: Optional[torch.Generator],
                 dtype: str = "float32", device=None):
        self.generator = generator
        self.dtype = getattr(torch, dtype)
        self.device = device
        self.axes: Dict[str, Any] = {}

    def param(self, name: str, shape: Tuple[int, ...],
              axes: Tuple[Optional[str], ...], init: str = "normal",
              scale: Optional[float] = None, dtype: Optional[str] = None):
        if len(shape) != len(axes):
            raise ValueError(f"{name}: shape {shape} but axes {axes}")
        if init not in _INITS:
            raise ValueError(f"{name}: unknown init {init!r}")
        dt = getattr(torch, dtype) if dtype else self.dtype
        self.axes[name] = tuple(axes)
        kw = dict(dtype=dt, device=self.device)
        if init == "zeros":
            return torch.zeros(shape, **kw)
        if init == "ones":
            return torch.ones(shape, **kw)
        if init == "normal":
            if scale is None:
                fan_in = shape[0] if len(shape) > 1 else max(shape[-1], 1)
                scale = 1.0 / math.sqrt(max(fan_in, 1))
            return torch.randn(shape, generator=self.generator,
                               **kw).mul_(scale)
        r = 1.0 if scale is None else scale
        return torch.empty(shape, **kw).uniform_(-r, r,
                                                 generator=self.generator)

    def custom(self, name: str, value: torch.Tensor,
               axes: Tuple[Optional[str], ...]):
        """Register a parameter with its own initial value (A_log,
        dt_bias)."""
        self.axes[name] = tuple(axes)
        return value.to(self.device)


def unflatten_axes(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{'a/b/c': axes} -> nested {'a': {'b': {'c': axes}}}."""
    out: Dict[str, Any] = {}
    for path, axes in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = axes
    return out
