"""The parameter tree's leaves, in the reference's order and stacking.

The port keeps one `Params` node a layer (`models/layers.py`); the
reference stacks period position i's parameters over the repeats under
``blocks/pos{i}`` (a leading axis of R = num_layers / P), and its
optimizers see those stacked leaves. ``stacked_leaves`` names every
reference leaf of a port tree with the port tensors that make it up, in
repeat order, so an optimizer can compute what the reference computes
over the stack (Adafactor's factoring and update clip) and the
converters can stack and unstack.

A tree is a `Params` (children by sorted name, the reference's sorted
dict keys), a `LayerStack` / ``nn.ModuleList`` / list (by index), a dict
(by sorted key) or a tensor (a leaf). `leaves` flattens any of them in
that order, so a ``tree_map`` mirror of a `Params` tree (the AdamW
moments) flattens in step with it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.layers import LayerStack, Params


def children(node) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs in flattening order, or None for a leaf."""
    if isinstance(node, torch.Tensor):
        return None
    if isinstance(node, Params):
        names = sorted(list(node._parameters) + list(node._modules))
        return [(k, node[k]) for k in names]
    if isinstance(node, (nn.ModuleList, list, tuple)):
        return [(str(i), x) for i, x in enumerate(node)]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    raise TypeError(f"not a parameter tree node: {type(node).__name__}")


def leaves(tree) -> List[Any]:
    kids = children(tree)
    if kids is None:
        return [tree]
    return [leaf for _, child in kids for leaf in leaves(child)]


def tree_map(fn: Callable, tree):
    """fn over every leaf; `Params` and dicts become dicts, layer lists
    lists."""
    kids = children(tree)
    if kids is None:
        return fn(tree)
    if isinstance(tree, (Params, dict)):
        return {k: tree_map(fn, c) for k, c in kids}
    return [tree_map(fn, c) for _, c in kids]


def as_dict(tree):
    """The tree with every list a dict keyed '0', '1', … (the layout of
    the logical-axes trees)."""
    kids = children(tree)
    if kids is None:
        return tree
    return {k: as_dict(c) for k, c in kids}


@dataclasses.dataclass
class StackedLeaf:
    """One leaf of the reference's tree: its path (``blocks/pos0/attn/
    wq``), the `leaves` positions of the port tensors that make it up in
    repeat order, their port paths, and whether the reference stacks it
    (a leading repeats axis, also when R = 1)."""
    path: str
    index: List[int]
    port_paths: List[str]
    stacked: bool


def stacked_leaves(params) -> List[StackedLeaf]:
    """Every reference leaf of the port tree `params`, in first-seen
    order; a `LayerStack`'s layer j sits at ``pos{j mod P}``, repeat
    ``j // P``."""
    found: List[Tuple[str, str, bool]] = []

    def walk(node, ref: str, port: str, stacked: bool):
        def join(a, b):
            return f"{a}/{b}" if a else b
        if isinstance(node, torch.Tensor):
            found.append((ref, port, stacked))
        elif isinstance(node, LayerStack):
            for j, layer in enumerate(node):
                walk(layer, join(ref, f"pos{j % node.period}"),
                     join(port, str(j)), True)
        else:
            for key, child in children(node):
                walk(child, join(ref, key), join(port, key), stacked)

    walk(params, "", "", False)
    groups: Dict[str, StackedLeaf] = {}
    for i, (ref, port, stacked) in enumerate(found):
        g = groups.setdefault(ref, StackedLeaf(ref, [], [], stacked))
        g.index.append(i)
        g.port_paths.append(port)
    return list(groups.values())


def set_path(tree: Dict, path: str, value) -> None:
    """tree[a][b]…[z] = value for path 'a/b/…/z' (dicts made on the way)."""
    parts = path.split("/")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


def get_path(tree, path: str):
    for p in path.split("/"):
        tree = tree[p] if isinstance(tree, (dict, Params)) else tree[int(p)]
    return tree
