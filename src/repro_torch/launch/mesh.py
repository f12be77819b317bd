"""The accumulation tree's machines as ranks of a `torch.distributed`
process group (answers the tree helpers of `src/repro/launch/mesh.py`:
`make_machine_mesh`, `make_tree_mesh`, `mesh_devices`, `factor_tree_axes`).

One rank is one machine (a lane of the tree). Lane id = rank, mixed-radix
over ``radices`` with the level-0 digit lowest: the paper's
``parent(id, ℓ) = b^ℓ·⌊id/b^ℓ⌋``. Level ℓ's collectives run over the
rank's level-ℓ subgroup: the ranks that share every digit but digit ℓ,
in digit order (`level_ranks`) — the row `core/greedyml.py::gather_groups`
builds for that lane, and the reference's ``lax.all_gather`` over
``tree_axes[ℓ]``. Axis names are listed outermost first, ``lvl{L-1}`` …
``lvl0``, as the reference's reversed mesh axes are, so
`factor_tree_axes` reads alike.

A planned tree with ``shard`` > 1 (`make_tree_mesh(radices, shard)`,
the reference's :80-98) gives every machine `shard` ranks that split its
leaf pool (kernels/shard_gains.py): rank = machine·shard + shard digit,
the shard digit fastest, so `local_block` still hands rank i block i —
the s-th contiguous slice of its machine's pool. Level ℓ's subgroup is
then the ranks that share every machine digit but digit ℓ AND the shard
digit (the shard lanes carry replicated machine state up the tree), and
each machine's ranks form its contiguous shard subgroup
(``shard_group``). The axis names gain an innermost ``shard``.

A tree may hold fewer lanes than the world (``ranks=``, the degraded
tree of runtime/supervisor.py, the reference's mesh over the first
devices): lane i sits on ``ranks[i]``, level subgroups are still created
on every rank in one order, the ranks outside hold no lane, and
`broadcast` and `gather_lanes` run over the whole world, so every rank
gets the root.

The caller's ``init_process_group`` chooses the backend; nothing here
switches it. Under gloo a CUDA tensor is staged through the host for
each collective; NCCL carries it in place (a bool as uint8). NCCL takes
no two ranks on one device: the mesh refuses such a mapping before any
collective runs. `force_host_devices` has no counterpart (JAX only).

The trainer's meshes: `make_local_mesh` names a ("data", "model") grid
over the ranks this process has — a one-device `LocalMesh` in a plain
process, a ``DeviceMesh`` over an initialized process group — and
`make_production_mesh` the reference's (16, 16) ("data", "model") or
(2, 16, 16) ("pod", "data", "model") ``DeviceMesh`` over a world of
exactly 256 or 512 ranks. The sharded train step runs over either
(`launch/steps.py`).
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.runtime.device import resolve_device

DeviceSpec = Union[None, str, torch.device]


def digits(lane: int, radices: Sequence[int]) -> Tuple[int, ...]:
    """The lane id's mixed-radix digits, level 0 first."""
    out = []
    for r in radices:
        out.append(lane % r)
        lane //= r
    return tuple(out)


def level_ranks(radices: Sequence[int], lvl: int, lane: int,
                shard: int = 1) -> List[int]:
    """The ranks of `lane`'s level-`lvl` group: every lane that shares all
    its machine digits but digit `lvl`, and its shard digit, in digit
    order (ascending ranks)."""
    machine, s = divmod(lane, shard)
    inner = math.prod(radices[:lvl])
    base = machine - digits(machine, radices)[lvl] * inner
    return [(base + d * inner) * shard + s for d in range(radices[lvl])]


def level_partition(radices: Sequence[int], lvl: int,
                    shard: int = 1) -> List[List[int]]:
    """All level-`lvl` groups, each once, ordered by their first rank —
    the order every rank creates them in."""
    lanes = math.prod(radices) * shard
    seen, out = set(), []
    for lane in range(lanes):
        g = level_ranks(radices, lvl, lane, shard)
        if g[0] not in seen:
            seen.add(g[0])
            out.append(g)
    return out


def shard_partition(machines: int, shard: int) -> List[List[int]]:
    """Every machine's shard group: its `shard` contiguous ranks."""
    return [list(range(m * shard, (m + 1) * shard))
            for m in range(machines)]


def rank_devices(world: int, device_count: int,
                 local_world: Optional[int] = None) -> List[torch.device]:
    """The default placement: rank r on ``cuda:(local_rank % count)``,
    local_rank = r % local_world (one host: the world)."""
    if device_count < 1:
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(gloo) to run the ranks on the CPU")
    local = local_world or world
    return [torch.device("cuda", (r % local) % device_count)
            for r in range(world)]


def check_devices(backend: str, devices: Sequence[torch.device],
                  local_world: Optional[int] = None) -> None:
    """NCCL takes no two ranks on one CUDA device of one host (it would
    refuse or hang in the first collective): raise first, naming the
    ranks. Rank r sits on host r // local_world (one host: the world)."""
    if str(backend).lower() != "nccl":
        return
    local = local_world or len(devices)
    owner: Dict[Tuple[int, torch.device], int] = {}
    for r, d in enumerate(devices):
        d = torch.device(d)
        if d.type != "cuda":
            raise ValueError(f"NCCL needs CUDA devices; rank {r} is on {d}")
        key = (r // local, d)
        if key in owner:
            raise ValueError(
                f"NCCL takes no two ranks on one device: ranks {owner[key]} "
                f"and {r} are both on {d} of host {key[0]}; give each rank "
                "its own card, or initialise the group with the gloo "
                "backend")
        owner[key] = r


class TreeMesh:
    """The tree's view of the default process group: ``radices`` (level 0
    first), ``shard`` ranks a machine (1: one), axis names ``lvl{L-1}``
    … ``lvl0`` (then ``shard`` when sharded), ``shape`` keyed by axis
    name, the world group, this rank's subgroup at every level
    (``groups[ℓ]``, None meaning the world), its machine's
    ``shard_group`` (with ``shard`` > 1), ``machine`` and
    ``shard_digit``, and its ``device``
    (None: ``cuda:(local_rank % count)``, checked under NCCL for two
    ranks on one card; else the device given, which NCCL takes only at
    world size 1).

    ``ranks``: the ascending ranks holding lanes 0, 1, … (default: every
    rank); ``lane`` is this rank's lane, None outside a subset, where
    ``machine``, ``shard_digit`` and ``coords`` are None too.

    ``log``: None, or a list that every collective appends a record to
    ({'op', 'level', 'bytes', 'seconds', 'first'}; the rank's device is
    synchronised around the call so the seconds are the collective's;
    ``first`` marks this process's first collective over that group,
    whose seconds include NCCL's communicator set-up)."""

    def __init__(self, radices: Sequence[int], *, shard: int = 1,
                 axis_prefix: str = "lvl", device: DeviceSpec = None,
                 ranks: Optional[Sequence[int]] = None):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("call torch.distributed.init_process_group "
                               "first: the tree's ranks are its processes")
        self.radices = tuple(int(r) for r in radices)
        self.shard = int(shard)
        if (self.radices and min(self.radices) < 1) or self.shard < 1 or (
                not self.radices and self.shard < 2 and ranks is None):
            raise ValueError(f"radices must be positive, shard ≥ 1 (≥ 2 "
                             f"with no level): {radices}, {shard}")
        self.world_size = dist.get_world_size()
        self.rank = dist.get_rank()
        lanes = math.prod(self.radices) * self.shard
        if ranks is None:
            if lanes != self.world_size:
                raise ValueError(f"the tree {self.radices} with shard "
                                 f"{self.shard} has {lanes} lanes; the "
                                 f"process group has {self.world_size} "
                                 "ranks")
            ranks = range(self.world_size)
        self.ranks = tuple(int(r) for r in ranks)
        if (len(self.ranks) != lanes or list(self.ranks) != sorted(
                set(self.ranks)) or self.ranks[0] < 0
                or self.ranks[-1] >= self.world_size):
            raise ValueError(f"ranks {self.ranks}: the tree {self.radices} "
                             f"with shard {self.shard} needs {lanes} "
                             "distinct ascending ranks of the "
                             f"{self.world_size}-rank group")
        self.lane = (self.ranks.index(self.rank) if self.rank in self.ranks
                     else None)
        self.backend = str(dist.get_backend()).lower()
        self.device = self._place(device)
        self.axis_names = tuple(f"{axis_prefix}{i}"
                                for i in reversed(range(len(self.radices))))
        self.shape = {f"{axis_prefix}{i}": r
                      for i, r in enumerate(self.radices)}
        if self.shard > 1:
            self.axis_names += ("shard",)
            self.shape["shard"] = self.shard
        self.machine = self.shard_digit = self.coords = None
        if self.member:
            self.machine, self.shard_digit = divmod(self.lane, self.shard)
            self.coords = digits(self.machine, self.radices)
        self.group = dist.group.WORLD
        # every rank creates every group of every level, then the shard
        # groups, in one order
        self.groups = [self._subgroup(level_partition(self.radices, lvl,
                                                      self.shard))
                       for lvl in range(len(self.radices))]
        self.shard_group = (self._subgroup(shard_partition(
            self.machines, self.shard)) if self.shard > 1 else None)
        self.stage_on_host = (self.backend == "gloo"
                              and self.device.type == "cuda")
        self.log: Optional[List[dict]] = None
        self._used_groups: set = set()

    def _place(self, device: DeviceSpec) -> torch.device:
        if device is not None:
            if self.backend == "nccl" and self.world_size > 1:
                raise ValueError("under NCCL with more than one rank leave "
                                 "device=None: the default placement is "
                                 "checked for two ranks on one card")
            return torch.device(device)
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "0")) or None
        devices = rank_devices(self.world_size,
                               torch.cuda.device_count()
                               if torch.cuda.is_available() else 0,
                               local_world)
        check_devices(self.backend, devices, local_world)
        return devices[self.rank]

    def _subgroup(self, partition: List[List[int]]):
        """Create every group of `partition` (lanes; all ranks, one
        order) and return this rank's."""
        mine = None
        for lanes in partition:
            ranks = [self.ranks[lane] for lane in lanes]
            if len(ranks) == self.world_size:
                g = None                       # the world itself
            else:
                g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = g
        return mine

    @property
    def lanes(self) -> int:
        return len(self.ranks)

    @property
    def member(self) -> bool:
        """Whether this rank holds a lane (a subset mesh leaves the other
        ranks without one)."""
        return self.lane is not None

    @property
    def machines(self) -> int:
        return math.prod(self.radices)

    @property
    def level_names(self) -> Tuple[str, ...]:
        """The tree levels' axis names, innermost first."""
        return tuple(reversed([a for a in self.axis_names
                               if a != "shard"]))

    def flat(self) -> "TreeMesh":
        """One level over every rank (RandGreedi's tree), same device."""
        if self.shard > 1 or self.lanes != self.world_size:
            raise ValueError("RandGreedi's flat tree has no shard lanes "
                             "and spans the world")
        m = TreeMesh.__new__(TreeMesh)
        m.__dict__.update(self.__dict__)
        m.radices = (self.world_size,)
        m.axis_names = ("lvl0",)
        m.shape = {"lvl0": self.world_size}
        m.coords = (self.rank,)
        m.groups = [None]
        return m

    # --------------------------------------------------------- collectives
    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        t = x.detach()
        if self.stage_on_host:
            t = t.cpu()
        if t.dtype == torch.bool:
            t = t.to(torch.uint8)
        return t.contiguous()

    def _unwire(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return t.to(device=like.device, dtype=like.dtype)

    def _first_use(self, group) -> bool:
        """Whether this is the process's first collective over `group`
        (None: the world), and mark it used."""
        first = id(group) not in self._used_groups
        self._used_groups.add(id(group))
        return first

    def _record(self, op: str, lvl, nbytes: int, t0: float,
                first: bool = False) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.log.append({"op": op, "level": lvl, "bytes": nbytes,
                         "seconds": time.perf_counter() - t0,
                         "first": first})

    def _start(self) -> float:
        if self.log is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def all_gather(self, lvl: int, x: torch.Tensor) -> torch.Tensor:
        """Concatenate `x` (n, …) of every rank of this rank's level-`lvl`
        group along dim 0, in digit order (lax.all_gather, tiled)."""
        return self._gather(self.groups[lvl], self.radices[lvl], x,
                            "all_gather", lvl)

    def shard_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Concatenate `x` (n, …) of every rank of this rank's shard group
        along dim 0, in shard-digit order."""
        return self._gather(self.shard_group, self.shard, x,
                            "shard_gather", None)

    def _gather(self, group, size: int, x: torch.Tensor, op: str, lvl):
        t0 = self._start()
        t = self._wire(x)
        parts = [torch.empty_like(t) for _ in range(size)]
        first = self._first_use(group)
        dist.all_gather(parts, t, group=group)
        out = self._unwire(torch.cat(parts, 0), x)
        if self.log is not None:
            self._record(op, lvl, t.numel() * t.element_size()
                         * len(parts), t0, first)
        return out

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Lane `src`'s `x` on every rank of the world (a rank outside a
        subset mesh passes a tensor of the same shape and dtype), in a
        new tensor (`x` is left as it was)."""
        t0 = self._start()
        t = self._wire(x)
        if t.data_ptr() == x.data_ptr():
            t = t.clone()
        first = self._first_use(None)
        dist.broadcast(t, src=self.ranks[src])
        out = self._unwire(t, x)
        if self.log is not None:
            self._record("broadcast", None, t.numel() * t.element_size(),
                         t0, first)
        return out

    def gather_lanes(self, x: torch.Tensor) -> torch.Tensor:
        """Every lane's `x` (1, …) stacked (lanes, …) in lane order, on
        every rank of the world: a rank outside a subset mesh passes a
        placeholder of the same shape and dtype."""
        t = self._wire(x)
        parts = [torch.empty_like(t) for _ in range(self.world_size)]
        self._first_use(None)
        dist.all_gather(parts, t)
        return self._unwire(torch.cat([parts[r] for r in self.ranks], 0), x)

    def world_max(self, value: float) -> float:
        """The largest `value` over every rank of the world."""
        dev = self.device if self.backend == "nccl" else torch.device("cpu")
        t = torch.tensor([float(value)], dtype=torch.float64, device=dev)
        self._first_use(None)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())


def make_tree_mesh(radices: Sequence[int], shard: int = 1,
                   axis_prefix: str = "lvl", device: DeviceSpec = None,
                   ranks: Optional[Sequence[int]] = None) -> TreeMesh:
    """The tree mesh of a planned tree (`kernels/plans.py::plan_tree` →
    TreePlan) over the default process group: level ℓ gathers over axis
    f"{axis_prefix}{ℓ}"; ``shard`` > 1 adds the innermost axis "shard",
    the ranks that split each leaf (rank = machine·shard + shard digit).
    ``ranks``: the ascending ranks holding the lanes, lane i on
    ``ranks[i]`` (default: every rank; a subset leaves the others
    without a lane, and a single rank may hold an empty tree). Every
    rank of the world calls this, in one order."""
    if not tuple(radices) and int(shard) <= 1 and ranks is None:
        raise ValueError("empty tree with no sharding needs no mesh")
    return TreeMesh(radices, shard=shard, axis_prefix=axis_prefix,
                    device=device, ranks=ranks)


def make_machine_mesh(m: int, b: int, axis_prefix: str = "lvl",
                      device: DeviceSpec = None,
                      ranks: Optional[Sequence[int]] = None) -> TreeMesh:
    """The tree T(m, L, b) over the default process group: m = b^L lanes,
    level ℓ over axis f"{axis_prefix}{ℓ}"; ``ranks`` as make_tree_mesh."""
    if m <= 0 or b <= 1:
        raise ValueError(f"need m>0, b>1; got m={m} b={b}")
    L = int(round(math.log(m, b)))
    if b ** L != m:
        raise ValueError(f"the tree driver needs m=b^L; got m={m} b={b} "
                         f"(use core.simulate for ragged trees)")
    return make_tree_mesh((b,) * L, axis_prefix=axis_prefix, device=device,
                          ranks=ranks)


def mesh_devices(mesh: TreeMesh) -> int:
    return math.prod(mesh.shape.values())


def factor_tree_axes(mesh: TreeMesh,
                     leaf_axes: Tuple[str, ...]) -> Tuple[str, ...]:
    """Order existing mesh axes into accumulation-tree levels (innermost
    level first)."""
    return tuple(reversed([a for a in leaf_axes if a in mesh.shape]))


def local_block(x, mesh: TreeMesh):
    """This rank's contiguous block of a global (n, …) array: lane i takes
    block i, as `core/greedyml.py::shard_lanes` cuts it."""
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} holds no lane of this mesh")
    n = x.shape[0]
    if n % mesh.lanes:
        raise ValueError(f"n={n} must divide over {mesh.lanes} lanes")
    per = n // mesh.lanes
    return x[mesh.lane * per:(mesh.lane + 1) * per]


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """A named grid of one device (``shape`` all ones): what
    `sharding.axes.mesh_shape` reads of a ``DeviceMesh``, and the device
    its tensors live on."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]
    device: torch.device


def make_local_mesh(data: int = 1, model: int = 1,
                    device: DeviceSpec = None):
    """A ("data", "model") mesh over the ranks this process has (the
    reference's mesh over its local devices): the world of an
    initialized process group, else one — then a `LocalMesh` on
    ``device`` (the card by default)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    data = max(1, min(data, n))
    model = max(1, min(model, n // data))
    dev = resolve_device(device)
    if data * model == 1:
        return LocalMesh((1, 1), ("data", "model"), dev)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))


PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceSpec = None):
    """The reference's 16×16 ("data", "model") mesh of 256 ranks, or its
    2×16×16 ("pod", "data", "model") mesh of 512, over the initialized
    process group's world (a rank a device, on ``device``'s type: the
    card by default). Another world raises, naming it."""
    shape, names = PRODUCTION_MESHES[bool(multi_pod)]
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n != math.prod(shape):
        raise ValueError(
            f"the {'×'.join(map(str, shape))} production mesh needs a "
            f"world of {math.prod(shape)} ranks; this process has "
            f"{n} (an initialized process group: "
            f"{dist.is_initialized()})")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=names)
