"""Multi-pod dry run: trace EVERY (arch × shape × mesh) cell of the
registry on the meta device over a fake world of 256 or 512 ranks, and
record memory / FLOPs / collective bytes a device for the roofline
analysis (answers `src/repro/launch/dryrun.py`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both \
        [--only qwen2-7b:train_4k] [--out results/dryrun_torch] \
        [--no-probe] [--technique] [--device cuda|cpu]

The reference lowers and compiles each cell with XLA on 512 placeholder
host devices and reads the compiled program's ``memory_analysis``,
``cost_analysis`` and HLO collectives. The port has no compiler between
the step and the device, so its dry run RUNS the step — eagerly, as it
would run on a rank — on tensors that hold no data, and counts what one
rank does:

1. **Where it runs.** No device for the model cells (the reference's
   placeholder devices). This process joins torch's ``"fake"`` process
   group (collectives are no-ops) as rank 0 (``--rank`` picks another)
   of 256 ranks (the (16, 16) ("data", "model") mesh) or 512 (the
   (2, 16, 16) ("pod", "data", "model") mesh); each mesh kind gets its
   own group, destroyed after its cells. `launch/mesh.py::
   make_production_mesh` builds the mesh (CPU device type). A cell's
   state is `steps.abstract_state` on the meta device, placed by
   `steps.place_state` / `state_shardings` under `_cell_cfgs`
   (parameters in bf16; Adafactor with a bf16 gradient codec above 1e11
   parameters, AdamW otherwise; remat 'full' above 2e10 parameters,
   'block' otherwise); the batch (and a decode cell's cache) is placed
   by `steps.batch_shardings`; the step is `make_train_step`, or
   `make_prefill_step` or `make_decode_step` without autograd (as
   `launch/serve.py` runs them). A decode cell's cache
   index is the Python int ``seq_len − 1`` (the port's decode reads it
   on the host; attention reads the whole buffer under a mask whatever
   the index, as the reference's dynamic index does).
2. **Technique cells** (`TECHNIQUE_CELLS`, GreedyML itself) run ONE
   rank's shard of real data (seeded draws: facility 4,096 × 256 f32 on
   the single mesh; kcover 2,048 sets × 8,192 words) through
   `core/greedyml.py::greedyml_distributed` over the mesh's tree
   (`make_tree_mesh`: the mesh's axes as levels, innermost first, as
   the reference's `factor_tree_axes`), on the device the caller gives:
   the card by default (the kernels run), ``--device cpu`` the plain
   path (the reference lowers these cells with ``backend="ref"``). A
   fake group leaves a gather's outputs as ``torch.empty_like`` made
   them, so `StandInTreeMesh` fills every gathered part with this
   rank's own part, a stand-in for its peers. Rank 0 is the root of the
   tree, the most loaded rank; the reference's SPMD program is the same
   on every device.
3. **Counting, per device.** `CostMode`, a TorchDispatchMode, lets
   DTensor desugar each op first (it returns NotImplemented for a
   DTensor), so it counts the ops on this rank's local tensors (not
   the fake tensors of DTensor's shape propagation, which hold global
   shapes):
   products by ``torch.utils.flop_counter``'s registry at 2·M·N·K
   (``dot_flops``); an elementwise op one flop an output element, a
   reduction one an input element, transcendental functions apart, as
   XLA's HloCostAnalysis counts; ``bytes_accessed`` the bytes of each
   op's inputs and outputs (views none) — with no fusion, an upper
   bound on what a fused program moves. Collectives come from the
   ``_c10d_functional`` ops: the kind, the result bytes, the group's
   size and mesh dim, moved bytes ``_COLL_FACTOR[kind] · result ·
   (g−1)/g``; the technique cells add `TreeMesh.log`'s gathers and
   broadcasts. A kernel wrapper declares its call's flops and bytes
   (`kernels/counters.py`), and the mode leaves the ops inside a
   wrapper to that declaration, so the plain path and the kernel path
   count the same kernel work.
4. **Memory.** ``argument_bytes``: the local bytes of the state and
   the batch (and cache). ``temp_bytes``: the peak of the live local
   bytes the step allocates (every storage an op makes, held until
   freed) less what the outputs keep. ``output_bytes``, ``alias_bytes``
   (outputs in the inputs' storage: the state the train step updates
   in place) and ``total_bytes`` = argument + output + temp − alias, the
   reference's keys.
5. **Two passes, as in the reference.** The full pass traces the cell
   at full depth with one microbatch: ``per_device`` (memory, the
   counts, the collective schedule; ``flops_hlo_static`` is that pass's
   count, since nothing here counts a loop body once). ``hlo_bytes`` is
   null: there is no HLO text. The probes trace 1× and 2× the layer
   period; ``estimated`` fits them linearly to full depth, times
   ``n_micro``, plus the optimizer (the reference's formula). Technique
   cells are counted directly at their full k (``method`` says so);
   `probe_technique_cell` keeps the reference's quadratic fit in k.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import registry
from repro_torch.configs.base import OptimConfig, ShapeConfig, TrainConfig
from repro_torch.kernels import counters
from repro_torch.launch import mesh as M
from repro_torch.launch import steps
from repro_torch.models import api, transformer as T
from repro_torch.optim.tree import as_dict
from repro_torch.sharding.axes import (is_device_mesh, is_dtensor,
                                       tree_shardings)

# Per-device bytes moved ≈ factor × result bytes (ring algorithms).
_COLL_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}

MESH_DEVICES = {"single": 256, "multi": 512}


def moved_bytes(kind: str, result_bytes: float, group: int) -> float:
    """A collective's bytes moved a device (the reference's
    `parse_collectives` rule)."""
    eff = 1.0 if group <= 1 else (group - 1) / group
    return _COLL_FACTOR[kind] * result_bytes * eff


def summarize_collectives(records: Sequence[dict]) -> Dict[str, Any]:
    """Collective records ({'kind', 'result_bytes', 'group', …}) in the
    reference's `parse_collectives` layout, plus the records by mesh dim."""
    out = {"ops": {}, "moved_bytes": 0.0, "result_bytes": 0.0, "by_dim": {}}
    for r in records:
        moved = moved_bytes(r["kind"], r["result_bytes"], r["group"])
        rec = out["ops"].setdefault(r["kind"], {"count": 0,
                                                "result_bytes": 0.0,
                                                "moved_bytes": 0.0})
        rec["count"] += 1
        rec["result_bytes"] += r["result_bytes"]
        rec["moved_bytes"] += moved
        out["moved_bytes"] += moved
        out["result_bytes"] += r["result_bytes"]
        dim = str(r.get("dim"))
        out["by_dim"][dim] = out["by_dim"].get(dim, 0.0) + moved
    return out


# ---------------------------------------------------------------------------
# The counting mode
# ---------------------------------------------------------------------------

_A = torch.ops.aten
_REDUCTIONS = {getattr(_A, n) for n in (
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std",
    "var_mean", "std_mean", "logsumexp", "norm", "linalg_vector_norm",
    "cumsum", "cumprod", "argmax", "argmin", "any", "all", "nansum",
    "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data") if hasattr(_A, n)}
# XLA counts these as transcendentals, not flops
_TRANSCENDENTAL = {getattr(_A, n) for n in (
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh",
    "sigmoid", "rsqrt", "sqrt", "sin", "cos", "tan", "erf", "erfinv", "pow",
    "atan2") if hasattr(_A, n)}
_CONVERTS = {_A._to_copy, _A.copy_, _A.copy}
_FREE = {_A.empty, _A.empty_like, _A.empty_strided, _A.new_empty,
         _A.new_empty_strided, _A.lift_fresh}

_COLL_KINDS = {"all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_out": "all-gather",
               "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "broadcast": "collective-permute",
               "broadcast_": "collective-permute"}


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a tree of dicts, lists, tuples and modules (a
    module's parameters and buffers)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def mesh_groups(mesh) -> Dict[str, str]:
    """{process-group name: mesh dim name} of a DeviceMesh (empty
    otherwise)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        return {}
    return {mesh.get_group(i).group_name: name
            for i, name in enumerate(mesh.mesh_dim_names)}


class CostMode(TorchDispatchMode):
    """Counts what this rank does while it is active (module doc, 3–4):
    ``flops`` (all), ``dot_flops``, ``transcendentals``,
    ``bytes_accessed``, ``collectives`` (records), the live bytes of the
    storages allocated under it (``live``, ``peak``) and ``by_op``
    (flops by op). Kernel wrappers' declared costs are added by
    `add_declared` from two `counters.costs()` readings."""

    def __init__(self, groups: Optional[Dict[str, str]] = None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._dots = flop_registry
        self.groups = dict(groups or {})
        self.flops = self.dot_flops = self.transcendentals = 0.0
        self.bytes_accessed = 0.0
        self.kernel_flops = self.kernel_bytes = 0.0
        self.collectives: List[dict] = []
        self.by_op: Dict[str, float] = {}
        self.live = self.peak = 0
        self._held: Dict[int, int] = {}

    # ------------------------------------------------------------ memory
    def _track(self, outs) -> None:
        for t in outs:
            try:
                st = t.untyped_storage()
            except (NotImplementedError, RuntimeError):
                continue
            key = id(st)
            if key in self._held:
                continue
            size = st.nbytes()
            self._held[key] = size
            self.live += size
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    # ---------------------------------------------------------- counting
    def _collective(self, func, args, kwargs, outs) -> None:
        from torch.distributed.distributed_c10d import _resolve_process_group
        name = func._schema.name.split("::")[-1]
        kind = _COLL_KINDS.get(name)
        if kind is None:
            return
        gname = kwargs.get("group_name", args[-1])
        pg = _resolve_process_group(gname)
        self.collectives.append({
            "kind": kind, "result_bytes": float(sum(map(_nbytes, outs))),
            "group": pg.size(), "dim": self.groups.get(gname)})

    def _add(self, func, n: float) -> None:
        self.flops += n
        key = str(func.overloadpacket)
        self.by_op[key] = self.by_op.get(key, 0.0) + n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in outs) or any(
                issubclass(t, FakeTensor) for t in types):
            return out          # DTensor's shape propagation, not a rank's
        self._track(outs)
        ns = func.namespace
        if ns == "_c10d_functional":
            self._collective(func, args, kwargs, outs)
            return out
        if ns != "aten" or counters.inside() or func in _FREE:
            return out
        packet = func.overloadpacket
        ins = {id(t): t for t in _tensors((args, kwargs))}
        if not func.is_view:
            self.bytes_accessed += (sum(map(_nbytes, ins.values()))
                                    + sum(map(_nbytes, outs)))
        if packet in self._dots:
            n = float(self._dots[packet](*args, **kwargs, out_val=out))
            self.dot_flops += n
            self._add(func, n)
        elif packet in _REDUCTIONS:
            self._add(func, float(sum(t.numel() for t in ins.values())))
        elif packet in _TRANSCENDENTAL:
            self.transcendentals += float(sum(t.numel() for t in outs))
        elif torch.Tag.pointwise in func.tags or (
                packet in _CONVERTS and outs and ins and any(
                    t.dtype != outs[0].dtype for t in ins.values())):
            self._add(func, float(outs[0].numel() if outs else 0))
        return out

    def add_declared(self, before: Dict[str, dict],
                     after: Dict[str, dict]) -> None:
        """Add the kernel wrappers' declared costs between two
        `counters.costs()` readings."""
        for name, c in after.items():
            b = before.get(name, {"flops": 0.0, "bytes": 0.0})
            f, by = c["flops"] - b["flops"], c["bytes"] - b["bytes"]
            self.kernel_flops += f
            self.kernel_bytes += by
            self.flops += f
            self.bytes_accessed += by
            if f:
                self.by_op[f"kernel:{name}"] = (
                    self.by_op.get(f"kernel:{name}", 0.0) + f)

    def result(self) -> Dict[str, Any]:
        return {"flops": self.flops, "dot_flops": self.dot_flops,
                "transcendentals": self.transcendentals,
                "bytes_accessed": self.bytes_accessed,
                "kernel_flops": self.kernel_flops,
                "kernel_bytes": self.kernel_bytes,
                "collectives": summarize_collectives(self.collectives)}


def count(fn: Callable, *args, groups: Optional[Dict[str, str]] = None,
          **kwargs) -> Tuple[Any, CostMode]:
    """(fn(*args, **kwargs), the CostMode that counted it)."""
    before = counters.costs()
    with CostMode(groups) as mode:
        out = fn(*args, **kwargs)
    mode.add_declared(before, counters.costs())
    return out, mode


# ---------------------------------------------------------------------------
# Pure helpers (the reference's)
# ---------------------------------------------------------------------------


def _linfit(pts, r_full: int):
    p1, p2 = pts[0], pts[-1]
    r1, r2 = p1[0], p2[0]
    return tuple(v1 + (v2 - v1) / (r2 - r1) * (r_full - r1)
                 for v1, v2 in zip(p1[1:], p2[1:]))


def _quadfit(pts, r_full: int):
    import numpy as np
    rs = np.array([p[0] for p in pts], dtype=float)
    vander = np.vander(rs, 3)
    x = float(r_full)
    out = []
    for j in range(1, len(pts[0])):
        cs = np.linalg.solve(vander, np.array([p[j] for p in pts]))
        out.append(float(cs[0] * x * x + cs[1] * x + cs[2]))
    return tuple(out)


def _opt_flops_per_device(cfg, devices: int) -> float:
    # AdamW (~10 flops/param) + global-norm clip (~2) on sharded params
    return 12.0 * cfg.param_count() / devices


def _opt_bytes_per_device(cfg, devices: int) -> float:
    # the optimizer's state traffic (~14 bytes/param), the reference's
    return 14.0 * cfg.param_count() / devices


def _cell_cfgs(arch: str):
    cfg = registry.get_arch(arch).replace(param_dtype="bfloat16")
    big = cfg.param_count() > 1e11      # 400B-class: Adafactor (factored v)
    ocfg = OptimConfig(                 # + bf16 grad accumulation/reduction
        name=("adafactor" if big else "adamw"),
        compress_grads=("bf16" if big else "none"))
    return cfg, ocfg


def _remat(cfg) -> str:
    # >20B params: save-nothing remat (carry-only residuals)
    return "full" if cfg.param_count() > 2e10 else "block"


def _shrink(cfg, r: int):
    period = T.period_of(cfg)
    kw = {"num_layers": r * period}
    if cfg.encoder_layers:
        kw["encoder_layers"] = max(1, round(
            cfg.encoder_layers * r * period / cfg.num_layers))
    return cfg.replace(**kw)


def micro_shape(shape: ShapeConfig, mesh, tcfg: TrainConfig
                ) -> Tuple[ShapeConfig, int]:
    """(one microbatch's shape, n_micro) of a train cell; others as
    they are, 1."""
    if shape.kind != "train":
        return shape, 1
    n_micro = steps.num_microbatches(shape, mesh, tcfg)
    return ShapeConfig(shape.name, shape.kind, shape.seq_len,
                       max(shape.global_batch // n_micro, 1)), n_micro


# ---------------------------------------------------------------------------
# Fake worlds and the cells' inputs
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """This process as rank `rank` of a fake process group of `world`
    ranks (collectives are no-ops), destroyed after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _meta_like(spec, sharding):
    shape, dtype = spec
    t = torch.empty(shape, dtype=dtype, device="meta")
    return t if sharding is None else sharding.place(t)


def _place_group(specs, shardings):
    if isinstance(specs, dict):
        return {k: _place_group(v, None if shardings is None
                                else shardings[k]) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_place_group(v, None if shardings is None else shardings[i])
                for i, v in enumerate(specs)]
    return _meta_like(specs, shardings)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if is_dtensor(t) else t


def build_cell(cfg, ocfg, shape: ShapeConfig, mesh, remat: str):
    """(step, args): the cell's step and its inputs on the meta device
    (placed over `mesh` when it is a DeviceMesh)."""
    sharded = is_device_mesh(mesh)
    if shape.kind == "train":
        state, axes = steps.abstract_state(cfg, ocfg)
        if sharded:
            state = steps.place_state(state, steps.state_shardings(
                axes, state, mesh))
        specs = api.input_specs(cfg, shape)[0]
        bsh = steps.batch_shardings(cfg, shape, mesh)[1] if sharded else None
        batch = _place_group(specs["batch"], bsh and bsh["batch"])
        step = steps.make_train_step(cfg, ocfg, TrainConfig(remat=remat),
                                     shape, mesh)
        return step, (state, batch)
    params, axes = T.init_params(None, cfg, device="meta")
    if sharded:
        params = steps.place_state(
            {"params": params, "opt": {}},
            {"params": tree_shardings(axes, as_dict(params), mesh),
             "opt": {}})["params"]
    specs, _ = api.input_specs(cfg, shape)
    bsh = steps.batch_shardings(cfg, shape, mesh)[1] if sharded else None
    batch = _place_group(specs["batch"], bsh and bsh["batch"])
    if shape.kind == "prefill":
        return _serving(steps.make_prefill_step(cfg, mesh)), (params, batch)
    cache = {"layers": _place_group(specs["cache"]["layers"],
                                    bsh and bsh["cache"]["layers"]),
             "index": shape.seq_len - 1}
    return (_serving(steps.make_decode_step(cfg, mesh)),
            (params, cache, batch))


def _serving(step):
    """A serving step without autograd, as `launch/serve.py` runs it (the
    parameters take gradients; a graph would hold every activation)."""
    def run(*args):
        with torch.no_grad():
            return step(*args)
    return run


def memory_of(args, out, mode: CostMode) -> Dict[str, int]:
    """The reference's memory keys from the step's inputs, outputs and
    the mode's live-bytes peak (module doc, 4)."""
    def storages(tree):
        seen = {}
        for t in _tensors(tree):
            t = _local(t)
            seen.setdefault(id(t.untyped_storage()), t.untyped_storage())
        return seen
    ins = storages(args)
    outs = storages(out)
    arg = sum(st.nbytes() for st in ins.values())
    outb = sum(st.nbytes() for st in outs.values())
    alias = sum(st.nbytes() for k, st in outs.items() if k in ins)
    kept = sum(mode._held.get(k, 0) for k in outs)
    mem = {"argument_bytes": arg, "output_bytes": outb,
           "temp_bytes": max(mode.peak - kept, 0), "alias_bytes": alias}
    mem["total_bytes"] = (mem["argument_bytes"] + mem["output_bytes"]
                          + mem["temp_bytes"] - mem["alias_bytes"])
    return mem


def input_bytes(cfg, shape: ShapeConfig, mesh) -> int:
    """The local bytes of a cell's batch (and decode cache) a rank."""
    specs = api.input_specs(cfg, shape)[0]
    shardings = (steps.batch_shardings(cfg, shape, mesh)[1]
                 if is_device_mesh(mesh) else None)
    return sum(_nbytes(_local(t)) for t in _tensors(
        _place_group(specs, shardings)))


def trace_cell(cfg, ocfg, shape: ShapeConfig, mesh, remat: str
               ) -> Dict[str, Any]:
    """One pass: the cell's step run once on meta tensors under
    `CostMode` (this rank's counts, memory, collective records)."""
    step, args = build_cell(cfg, ocfg, shape, mesh, remat)
    out, mode = count(step, *args, groups=mesh_groups(mesh))
    res = mode.result()
    res["memory"] = memory_of(args, out, mode)
    res["by_op"] = mode.by_op
    return res


def _per_device(res: Dict[str, Any]) -> Dict[str, Any]:
    return {"flops_hlo_static": res["flops"], "dot_flops": res["dot_flops"],
            "transcendentals": res["transcendentals"],
            "bytes_accessed": res["bytes_accessed"],
            "kernel_flops": res["kernel_flops"],
            "kernel_bytes": res["kernel_bytes"],
            "memory": res["memory"],
            "collectives_static": res["collectives"],
            "by_op": res["by_op"]}


def _point(r, res) -> Tuple:
    return (r, res["flops"], res["collectives"]["moved_bytes"],
            res["bytes_accessed"], res["dot_flops"],
            float(res["memory"]["temp_bytes"]))


def probe_lm(cfg, ocfg, shape: ShapeConfig, mesh, devices: int, remat: str,
             tcfg: Optional[TrainConfig] = None, rs=(1, 2)
             ) -> Dict[str, Any]:
    """Probes at `rs` × the layer period on one microbatch → the fit to
    full depth × n_micro + the optimizer (the reference's probe_lm_cell;
    points: (r, flops, collective bytes, bytes accessed, dot flops, temp
    bytes))."""
    tcfg = tcfg or TrainConfig()
    pshape, n_micro = micro_shape(shape, mesh, tcfg)
    r_full = cfg.num_layers // T.period_of(cfg)
    train = shape.kind == "train"
    pts, fb = [], []
    for r in rs:
        small = _shrink(cfg, r)
        pt = _point(r, trace_cell(small, ocfg, pshape, mesh, remat))
        pts.append(pt)
        opt = _opt_flops_per_device(small, devices) if train else 0.0
        opt_by = _opt_bytes_per_device(small, devices) if train else 0.0
        # the optimizer runs once a step, not a microbatch
        fb.append((r, pt[1] - opt, pt[2], pt[3] - opt_by, pt[4], pt[5]))
    f_full, c_full, b_full, d_full, t_full = _linfit(fb, r_full)
    opt_full = _opt_flops_per_device(cfg, devices) if train else 0.0
    opt_by_full = _opt_bytes_per_device(cfg, devices) if train else 0.0
    return {"method": "2-point linear fit in layer repeats (eager trace)",
            "points": pts, "n_micro": n_micro,
            "flops": f_full * n_micro + opt_full,
            "dot_flops": d_full * n_micro,
            "collective_moved_bytes": c_full * n_micro,
            "bytes_accessed": b_full * n_micro + opt_by_full,
            "temp_bytes": t_full}


def probe_lm_cell(arch: str, shape_name: str, mesh, devices: int
                  ) -> Dict[str, Any]:
    """1×/2×-period probes → per-device flops & collective bytes."""
    cfg, ocfg = _cell_cfgs(arch)
    return probe_lm(cfg, ocfg, registry.get_shape(shape_name), mesh,
                    devices, _remat(cfg))


# ---------------------------------------------------------------------------
# Technique cells (the paper's own workload on the production mesh)
# ---------------------------------------------------------------------------

TECHNIQUE_CELLS = {
    "greedyml-facility": dict(objective="facility", n=1 << 20, d=256, k=256),
    "greedyml-kcover": dict(objective="kcover", n=1 << 19,
                            universe=1 << 18, k=256),
}


class StandInTreeMesh(M.TreeMesh):
    """A TreeMesh over a fake process group: every gather's parts are
    this rank's own part (a stand-in for its peers), where the fake
    group would leave them as allocated. The filling is not counted: it
    stands in for the network."""

    @staticmethod
    def _fill(parts, t) -> None:
        from torch.utils._python_dispatch import _disable_current_modes
        with _disable_current_modes():
            for p in parts:
                p.copy_(t)

    def _gather(self, group, size: int, x: torch.Tensor, op: str, lvl):
        t0 = self._start()
        t = self._wire(x)
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t, group=group)
        self._fill(parts, t)
        out = self._unwire(torch.cat(parts, 0), x)
        if self.log is not None:
            self._record(op, lvl, t.numel() * t.element_size() * size, t0)
        return out

    def gather_lanes(self, x: torch.Tensor) -> torch.Tensor:
        t = self._wire(x)
        parts = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(parts, t)
        self._fill(parts, t)
        return self._unwire(torch.cat([parts[r] for r in self.ranks], 0), x)


def technique_radices(mesh_kind: str) -> Tuple[int, ...]:
    """The tree levels of a production mesh, innermost first (the
    reference's `factor_tree_axes` over every mesh axis)."""
    shape, _ = M.PRODUCTION_MESHES[mesh_kind == "multi"]
    return tuple(reversed(shape))


def technique_data(spec: dict, lanes: int, rank: int, device,
                   seed: int = 0):
    """(ids, payloads, valid): this rank's block of the cell's data,
    drawn from `seed` and the rank on `device`."""
    n = spec["n"] // lanes
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed * 100003 + rank)
    ids = torch.arange(rank * n, (rank + 1) * n, device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    if spec["objective"] == "facility":
        pay = torch.randn(n, spec["d"], generator=gen, device=dev)
        if spec.get("dtype"):
            pay = pay.to(getattr(torch, spec["dtype"]))
    else:
        w = spec["universe"] // 32
        # sets of ~1/8 of the universe: three random words and-ed
        def draw():
            return torch.randint(-2 ** 31, 2 ** 31 - 1, (n, w),
                                 generator=gen, device=dev,
                                 dtype=torch.int32)
        pay = draw() & draw() & draw()
    return ids, pay, valid


def _tree_record(r: dict, mesh: M.TreeMesh) -> dict:
    """A `TreeMesh.log` record as a collective record: a level's or the
    shard group's gather, or the root's broadcast to the world."""
    lvl = r["level"]
    if r["op"] == "broadcast":
        return {"kind": "collective-permute", "result_bytes": r["bytes"],
                "group": mesh.world_size, "dim": None}
    return {"kind": "all-gather", "result_bytes": r["bytes"],
            "group": mesh.radices[lvl] if lvl is not None else mesh.shard,
            "dim": mesh.level_names[lvl] if lvl is not None else "shard"}


def run_technique(name: str, mesh_kind: str, device="cuda",
                  k_override: Optional[int] = None,
                  radices: Optional[Sequence[int]] = None,
                  spec: Optional[dict] = None, mesh_cls=StandInTreeMesh,
                  data_rank: Optional[int] = None) -> Dict[str, Any]:
    """This rank's part of the cell's GreedyML tree over the initialized
    (fake) process group, counted: the mode's result, the memory keys,
    the solution, the seconds. ``mesh_cls``: the tree mesh (a real
    `TreeMesh` over a real group); ``data_rank``: whose block this rank
    draws (its own by default)."""
    from repro_torch.core.greedyml import greedyml_distributed
    from repro_torch.core.objective import make_objective
    spec = dict(spec or TECHNIQUE_CELLS[name])
    k = k_override or spec["k"]
    radices = tuple(radices or technique_radices(mesh_kind))
    mesh = mesh_cls(radices, device=device)
    mesh.log = []
    ids, pay, valid = technique_data(
        spec, mesh.lanes, mesh.rank if data_rank is None else data_rank,
        device)
    if spec["objective"] == "facility":
        obj = make_objective("facility", device=device)
    else:
        obj = make_objective("kcover", universe=spec["universe"],
                             device=device)
    t0 = time.perf_counter()
    sol, mode = count(greedyml_distributed, obj, ids, pay, valid, k, mesh,
                      sample_leaf=spec.get("sample", 0),
                      sample_level=spec.get("sample_level", 0))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    res = mode.result()
    res["collectives"] = summarize_collectives(
        mode.collectives + [_tree_record(r, mesh) for r in mesh.log])
    res["memory"] = memory_of((ids, pay, valid), sol, mode)
    res["by_op"] = mode.by_op
    res["seconds"] = time.perf_counter() - t0
    res["solution"] = sol
    res["k"] = k
    return res


def probe_technique_cell(name: str, mesh_kind: str, device="cuda",
                         ks=(4, 8, 16), k_full: Optional[int] = None,
                         **kw) -> Dict[str, Any]:
    """The reference's quadratic fit in k: counts at `ks` extrapolated to
    the full k (kept as a check of the direct count)."""
    k_full = k_full or (kw.get("spec") or TECHNIQUE_CELLS[name])["k"]
    pts = []
    for k in ks:
        res = run_technique(name, mesh_kind, device, k_override=k, **kw)
        pts.append((k, res["flops"], res["collectives"]["moved_bytes"],
                    res["bytes_accessed"]))
    f_full, c_full, b_full = _quadfit(pts, k_full)
    return {"method": "3-point quadratic fit in k", "points": pts,
            "n_micro": 1, "flops": f_full, "collective_moved_bytes": c_full,
            "bytes_accessed": b_full}


def technique_estimate(res: Dict[str, Any]) -> Dict[str, Any]:
    return {"method": "direct count at the full k (rank 0's path)",
            "points": [], "n_micro": 1, "flops": res["flops"],
            "dot_flops": res["dot_flops"],
            "collective_moved_bytes": res["collectives"]["moved_bytes"],
            "bytes_accessed": res["bytes_accessed"],
            "temp_bytes": float(res["memory"]["temp_bytes"])}


# ---------------------------------------------------------------------------
# The sweep and its command line
# ---------------------------------------------------------------------------


def production_mesh(mesh_kind: str):
    return M.make_production_mesh(multi_pod=mesh_kind == "multi",
                                  device="cpu")


def lm_record(cfg, ocfg, shape: ShapeConfig, mesh, devices: int,
              remat: str, probe: bool = True,
              tcfg: Optional[TrainConfig] = None) -> Dict[str, Any]:
    """The full pass (`per_device`) and, with `probe`, the probes'
    `estimated` of one LM cell over `mesh`."""
    tcfg = tcfg or TrainConfig()
    t0 = time.time()
    micro, _ = micro_shape(shape, mesh, tcfg)
    res = trace_cell(cfg, ocfg, micro, mesh, remat)
    if micro is not shape:
        # the arguments hold the whole batch, not one microbatch
        mem = res["memory"]
        extra = (input_bytes(cfg, shape, mesh)
                 - input_bytes(cfg, micro, mesh))
        mem["argument_bytes"] += extra
        mem["total_bytes"] += extra
    rec = {"devices": devices, "per_device": _per_device(res),
           "hlo_bytes": None, "lower_s": round(time.time() - t0, 1),
           "compile_s": 0.0}
    if probe:
        t1 = time.time()
        rec["estimated"] = probe_lm(cfg, ocfg, shape, mesh, devices, remat,
                                    tcfg)
        rec["probe_s"] = round(time.time() - t1, 1)
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             probe: bool = True, device="cuda", mesh=None
             ) -> Dict[str, Any]:
    """One cell over the (already initialized) fake world of its mesh
    kind; the record is written to `out_dir` (if given) and returned."""
    devices = MESH_DEVICES[mesh_kind]
    t0 = time.time()
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_kind, "devices": devices}
    try:
        if arch in TECHNIQUE_CELLS:
            res = run_technique(arch, mesh_kind, device)
            rec.update({"per_device": _per_device(res), "hlo_bytes": None,
                        "lower_s": round(res["seconds"], 1),
                        "compile_s": 0.0, "device": str(device)})
            if probe:
                rec["estimated"] = technique_estimate(res)
                rec["probe_s"] = 0.0
        else:
            cfg, ocfg = _cell_cfgs(arch)
            shape = registry.get_shape(shape_name)
            mesh = mesh if mesh is not None else production_mesh(mesh_kind)
            rec.update(lm_record(cfg, ocfg, shape, mesh, devices,
                                 _remat(cfg),
                                 probe=probe and mesh_kind == "single"))
        rec["ok"] = True
        ma = rec["per_device"]["memory"]
        est = rec.get("estimated", {})
        print(f"[OK] {arch:28s} {shape_name:12s} {mesh_kind:6s} "
              f"mem/dev={ma['total_bytes']/2**30:6.2f} GiB "
              f"flops/dev={est.get('flops', 0):.3e} "
              f"coll/dev={est.get('collective_moved_bytes', 0)/2**20:9.1f} "
              f"MiB ({time.time()-t0:.0f}s)", flush=True)
    except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[FAIL] {arch} {shape_name} {mesh_kind}: {rec['error'][:200]}",
              flush=True)
    rec["seconds"] = round(time.time() - t0, 1)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}__{shape_name}__{mesh_kind}.json".replace("/", "_")
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> List[Dict[str, Any]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--only", default="",
                    help="comma list of arch or arch:shape filters")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--technique", action="store_true",
                    help="also run the GreedyML selection cells")
    ap.add_argument("--device", default="cuda",
                    help="the technique cells' device (the model cells "
                         "use none)")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank this process plays")
    ap.add_argument("--list", action="store_true",
                    help="print the selected cells (arch:shape) and stop")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = [(a, s) for a, s, skip in registry.cells() if skip is None]
    if args.technique:
        cells += [(t, "selection") for t in TECHNIQUE_CELLS]
    if args.only:
        keep = set(args.only.split(","))
        cells = [(a, s) for a, s in cells
                 if a in keep or f"{a}:{s}" in keep]
    if args.list:
        print("\n".join(f"{a}:{s}" for a, s in cells))
        return []

    results = []
    for mesh_kind in meshes:
        todo = []
        for arch, shape_name in cells:
            fname = os.path.join(
                args.out, f"{arch}__{shape_name}__{mesh_kind}.json")
            if args.skip_existing and os.path.exists(fname):
                with open(fname) as f:
                    prev = json.load(f)
                if prev.get("ok"):
                    print(f"[skip] {arch} {shape_name} {mesh_kind} (cached)")
                    results.append(prev)
                    continue
            todo.append((arch, shape_name))
        if not todo:
            continue
        with fake_world(MESH_DEVICES[mesh_kind], args.rank):
            mesh = production_mesh(mesh_kind)
            for arch, shape_name in todo:
                results.append(run_cell(arch, shape_name, mesh_kind,
                                        args.out, probe=not args.no_probe,
                                        device=args.device, mesh=mesh))

    ok = sum(1 for r in results if r.get("ok"))
    print(f"\n{ok}/{len(results)} cells traced successfully")
    if ok < len(results):
        for r in results:
            if not r.get("ok"):
                print("  FAILED:", r["arch"], r["shape"], r["mesh"])
    return results


if __name__ == "__main__":
    main()
