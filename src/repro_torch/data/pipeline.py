"""Batches over a token corpus (answers `src/repro/data/pipeline.py`).

Deterministic: batch order is a seeded numpy permutation of document
indices, and resume-from-step just recomputes the index math — no
iterator state in checkpoints. The batches are the reference's to the
bit (the same numpy draws). ``place()`` puts a host batch on the
device, as int64 token ids (the port's index type); over a one-device
mesh that is all the reference's sharded ``device_put`` does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.runtime.device import DeviceLike, resolve_device
from repro_torch.sharding.axes import mesh_shape


@dataclasses.dataclass
class TokenDataset:
    tokens: np.ndarray            # (n_docs, seq+1) int32
    seed: int = 0
    selected: Optional[np.ndarray] = None   # coreset ids (data selection)

    @property
    def n(self) -> int:
        return len(self.selected) if self.selected is not None \
            else self.tokens.shape[0]

    def doc(self, i: int) -> np.ndarray:
        j = self.selected[i] if self.selected is not None else i
        return self.tokens[j]

    def batch(self, step: int, global_batch: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for `step` (resume = recompute, no state)."""
        rng = np.random.default_rng(self.seed + step // max(1, self.n //
                                                            global_batch))
        perm = rng.permutation(self.n)
        start = (step * global_batch) % max(self.n - global_batch + 1, 1)
        idx = perm[start:start + global_batch]
        if len(idx) < global_batch:
            idx = np.concatenate([idx, perm[:global_batch - len(idx)]])
        docs = np.stack([self.doc(i) for i in idx])
        return {"tokens": docs[:, :-1].astype(np.int32),
                "labels": docs[:, 1:].astype(np.int32)}


def place(batch: Dict[str, np.ndarray], mesh=None,
          device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The batch on ``device`` (the card by default); integer arrays
    become int64. A mesh of more than one device raises until the
    sharded trainer exists (ROADMAP item 10c)."""
    if mesh is not None and math.prod(mesh_shape(mesh).values()) > 1:
        raise NotImplementedError("a batch sharded over a mesh of more "
                                  "than one device (ROADMAP item 10c)")
    dev = resolve_device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.dtype == torch.int32:
            t = t.long()
        out[k] = t.to(dev)
    return out
