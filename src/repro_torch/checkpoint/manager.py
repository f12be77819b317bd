"""Fault-tolerant checkpointing: atomic, keep-N (answers
`src/repro/checkpoint/manager.py`).

Layout:  <dir>/step_<N:08d>/arrays.npz + manifest.json — the reference's
layout and keys, so a checkpoint written by either package restores in
the other. A save writes a ``.tmp`` directory and renames it (a crash
mid-save never corrupts the latest checkpoint; stale ``*.tmp`` dirs are
pruned by the next successful save's cleanup). Arrays are addressed by
their flattened tree path, as the reference flattens its pytrees:

  * a dataclass (``Solution``, ``SieveState``, ``RuleState``) by field
    index, ``0`` … — a field that is None has no leaf and keeps its
    index (``SieveState.spent`` off knapsack mode);
  * a dict by key, in sorted order (``states/…``, ``merged/0``);
  * a list or tuple by index;
  * a model's parameter tree (`models/layers.py`): a `Params` node by
    sorted name, a `LayerStack` by index — ``params/blocks/3/attn/wq``;

joined with ``/``. Leaves are torch tensors (any device), numpy arrays
or Python scalars. ``save`` copies every leaf to the host before it
writes anything: a `SieveState` is consumed in place by
`SieveStreamer.process_batch`, so a checkpoint must hold a copy, never
an alias. bf16 tensors (numpy has no bf16) are written as their exact
f32 values. ``restore`` takes the caller's example tree, so structure,
shape and dtype mismatches fail loudly; each leaf is cast to the
example's dtype (the reference's ids are int32, the port's int64; its
bitmap words uint32, the port's int32 — the same bit patterns) and put
on the example's device, the card when the example is on the card. A
step being restored is in a protect-set, so a concurrent keep-N cleanup
never deletes it mid-read.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch
from torch import nn

# steps currently being read by restore(); _cleanup never deletes them
_RESTORING: Set[Tuple[str, int]] = set()

_LEAF_TYPES = (torch.Tensor, np.ndarray, np.generic, int, float, bool)


def _children(node, strict: bool = True
              ) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of a container node in flattening order, or None
    for a leaf (any other object, unless `strict`)."""
    if isinstance(node, _LEAF_TYPES):
        return None
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(str(i), getattr(node, f.name))
                for i, f in enumerate(dataclasses.fields(node))]
    if isinstance(node, dict):
        return [(str(key), node[key]) for key in sorted(node)]
    if isinstance(node, (list, tuple, nn.ModuleList)):
        return [(str(i), x) for i, x in enumerate(node)]
    if isinstance(node, nn.Module) and hasattr(node, "with_children"):
        names = sorted(list(node._parameters) + list(node._modules))
        return [(k, getattr(node, k)) for k in names]
    if strict:
        raise TypeError(f"cannot checkpoint a {type(node).__name__}")
    return None


def _flatten(tree, prefix: str = "", strict: bool = True
             ) -> Dict[str, Any]:
    """{path: leaf} in tree order (None subtrees have no leaf)."""
    if tree is None:
        return {}
    kids = _children(tree, strict)
    if kids is None:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, child in kids:
        out.update(_flatten(child, f"{prefix}/{key}" if prefix else key,
                            strict))
    return out


def _rebuild(tree, fn: Callable[[str, Any], Any], prefix: str = ""):
    """The tree's structure with every leaf replaced by fn(path, leaf)."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)

    def sub(key, child):
        return _rebuild(child, fn, f"{prefix}/{key}" if prefix else key)

    if dataclasses.is_dataclass(tree):
        vals = {f.name: sub(key, child) for (key, child), f in
                zip(kids, dataclasses.fields(tree))}
        return dataclasses.replace(tree, **vals)
    if isinstance(tree, dict):
        return {key: sub(str(key), tree[key]) for key in tree}
    if hasattr(tree, "with_children"):
        return tree.with_children({key: sub(key, child)
                                   for key, child in kids})
    return type(tree)(sub(key, child) for key, child in kids)


def _host_copy(leaf) -> np.ndarray:
    """A host copy of one leaf that nothing else aliases."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy().copy()
    return np.array(leaf, copy=True)


def _numpy_dtype(dtype: torch.dtype):
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty(0, dtype=dtype).numpy().dtype


def save(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Write `tree` as step `step` under `ckpt_dir` (atomic), keeping the
    newest `keep` steps. Returns the step's directory."""
    # the copy comes first: nothing the caller does next can reach it
    arrays = {key: _host_copy(v) for key, v in _flatten(tree).items()}
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "time": time.time(),
                "keys": sorted(arrays.keys()), "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    _cleanup(ckpt_dir, keep)
    return final


def _cleanup(ckpt_dir: str, keep: int) -> None:
    key = os.path.abspath(ckpt_dir)
    for s in list_steps(ckpt_dir)[:-keep]:
        if (key, s) in _RESTORING:      # never delete a step mid-restore
            continue
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
    # stale tmp dirs of crashed saves (this save renamed its own away)
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and name.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                out.append(int(name[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def read_manifest(ckpt_dir: str, step: int) -> Dict:
    with open(os.path.join(ckpt_dir, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)


def _like(arr: np.ndarray, example):
    """`arr` as the example leaf: its dtype, and its device for a tensor."""
    if isinstance(example, torch.Tensor):
        host = torch.from_numpy(
            np.array(arr, dtype=_numpy_dtype(example.dtype), order="C"))
        return host.to(device=example.device, dtype=example.dtype)
    ex = np.asarray(example)
    return arr.astype(ex.dtype)


def restore(ckpt_dir: str, example_tree, step: Optional[int] = None,
            shardings=None) -> Tuple[Any, Dict]:
    """Restore into the structure of `example_tree` (the latest step by
    default). ``shardings``: None, or a matching tree whose leaves have
    ``place(tensor)`` (sharding/axes.py::TensorSharding) — each restored
    leaf is then distributed over its device mesh, the elastic-rescale
    path (checkpoint/reshard.py). Returns (tree, manifest)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    guard = (os.path.abspath(ckpt_dir), int(step))
    _RESTORING.add(guard)
    try:
        manifest = read_manifest(ckpt_dir, step)
        data = np.load(os.path.join(ckpt_dir, f"step_{step:08d}",
                                    "arrays.npz"))
        missing = set(_flatten(example_tree)) - set(data.files)
        if missing:
            raise KeyError(f"checkpoint at step {step} missing keys: "
                           f"{sorted(missing)[:5]}…")

        def leaf(key, ex):
            arr = data[key]
            shape = tuple(ex.shape) if hasattr(ex, "shape") else ()
            if tuple(arr.shape) != shape:
                raise ValueError(f"{key}: ckpt shape {arr.shape} != "
                                 f"{shape}")
            return _like(arr, ex)

        tree = _rebuild(example_tree, leaf)
    finally:
        _RESTORING.discard(guard)
    if shardings is not None:
        places = _flatten(shardings, strict=False)
        tree = _rebuild(tree, lambda key, t: places[key].place(t))
    return tree, manifest
