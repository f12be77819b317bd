"""Launch counters of the port's kernel wrappers.

Stand-in for the reference's `ops.count_pallas_dispatches`. Each kernel
wrapper owns one `KernelCounter`:

  calls     every call of the wrapper, whichever path it took — the
            number the reference's jaxpr count measures for the same tier
  launches  CUDA kernel launches only; a wrapper adds one exactly where
            it launches its kernel, and the plain CPU path never does

`reset()` zeroes every counter; `snapshot()` reads them all;
`dispatches(before, after, device)` counts what ran between two
snapshots.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass
class KernelCounter:
    name: str
    calls: int = 0
    launches: int = 0


_COUNTERS: Dict[str, KernelCounter] = {}


def counter(name: str) -> KernelCounter:
    """The process-wide counter of one kernel wrapper."""
    if name not in _COUNTERS:
        _COUNTERS[name] = KernelCounter(name)
    return _COUNTERS[name]


def reset() -> None:
    for c in _COUNTERS.values():
        c.calls = 0
        c.launches = 0


def snapshot() -> Dict[str, Dict[str, int]]:
    return {n: {"calls": c.calls, "launches": c.launches}
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
