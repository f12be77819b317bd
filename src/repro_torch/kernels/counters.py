"""Launch counters of the port's kernel wrappers.

Stand-in for the reference's `ops.count_pallas_dispatches`. Each kernel
wrapper owns one `KernelCounter`:

  calls     every call of the wrapper, whichever path it took — the
            number the reference's jaxpr count measures for the same tier
  launches  CUDA kernel launches only; a wrapper adds one exactly where
            it launches its kernel, and the plain CPU path never does
  cost      the calls that declared their cost (`KernelCounter.declare`,
            at the site that counts `calls`), with the sums of the
            declared ``flops`` and ``bytes``: the work of the call as the
            kernel's bound counts it (PERF.md §6: operations, inputs read
            once, outputs written once), whichever path ran it — the
            counterpart of the ``pl.CostEstimate`` a Pallas call may take

`reset()` zeroes every counter; `snapshot()` reads calls and launches,
`costs()` the declared costs; `dispatches(before, after, device)`
counts what ran between two snapshots. A wrapper function is marked with
`@wrapper`: while one runs, `inside()` is true, so an op counter
(`launch/dryrun.py::CostMode`) leaves the ops of its plain path to the
declared cost.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Dict


@dataclasses.dataclass
class KernelCounter:
    name: str
    calls: int = 0
    launches: int = 0
    cost: int = 0
    flops: float = 0.0
    bytes: float = 0.0

    def declare(self, flops: float, nbytes: float) -> None:
        """Count one call of the wrapper, with its work: ``flops``
        operations and ``nbytes`` compulsory bytes."""
        self.calls += 1
        self.cost += 1
        self.flops += float(flops)
        self.bytes += float(nbytes)


_COUNTERS: Dict[str, KernelCounter] = {}
_DEPTH = threading.local()


def counter(name: str) -> KernelCounter:
    """The process-wide counter of one kernel wrapper."""
    if name not in _COUNTERS:
        _COUNTERS[name] = KernelCounter(name)
    return _COUNTERS[name]


def wrapper(fn):
    """Mark `fn` as a kernel wrapper: `inside()` holds while it runs."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        _DEPTH.n = getattr(_DEPTH, "n", 0) + 1
        try:
            return fn(*args, **kwargs)
        finally:
            _DEPTH.n -= 1
    return run


def inside() -> bool:
    """Whether a kernel wrapper is running in this thread."""
    return getattr(_DEPTH, "n", 0) > 0


def nbytes(*tensors) -> float:
    """The bytes of the given tensors (None counts nothing)."""
    return float(sum(t.numel() * t.element_size() for t in tensors
                     if t is not None))


def reset() -> None:
    for c in _COUNTERS.values():
        c.calls = 0
        c.launches = 0
        c.cost = 0
        c.flops = 0.0
        c.bytes = 0.0


def snapshot() -> Dict[str, Dict[str, int]]:
    return {n: {"calls": c.calls, "launches": c.launches}
            for n, c in sorted(_COUNTERS.items())}


def costs() -> Dict[str, Dict[str, float]]:
    """Every counter's declared costs: {'cost', 'flops', 'bytes'}."""
    return {n: {"cost": c.cost, "flops": c.flops, "bytes": c.bytes}
            for n, c in sorted(_COUNTERS.items())}


def dispatches(before: Dict[str, Dict[str, int]],
               after: Dict[str, Dict[str, int]], device,
               prefix: str = "") -> int:
    """Kernel dispatches between two snapshots, over the counters whose
    name starts with `prefix`: launches on the card, calls on the CPU
    (the plain path launches nothing). ``device``: a torch.device."""
    what = "launches" if device.type == "cuda" else "calls"
    return sum(after[n][what] - before.get(n, {what: 0})[what]
               for n in after if n.startswith(prefix))
