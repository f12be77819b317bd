"""GreedyML-backed training-data selection (answers
`src/repro/data/selection.py`: `parse_spec`, `embed_documents`,
`select_coreset`).

Given per-document embeddings, select a diverse coreset with facility
location (or exemplars with k-medoid) through:

  * the **distributed** drivers (core/greedyml.py) when a
    `launch/mesh.py::TreeMesh` is given — every rank passes its own
    contiguous block of the embeddings (block i on rank i, as training
    shards documents) and gets the same coreset back;
  * the **simulator** (core/simulate.py) on one device;
  * the **streaming engine** (streaming/) for ``stream:*`` specs: the
    documents arrive in batches (REPRO_TORCH_STREAM_BATCH, default 128)
    through one sieve, scored against the pool or a fixed subsample of
    it (``stream_eval``).

``spec`` strings: 'greedyml:facility', 'randgreedi:kmedoid',
'stream:facility', 'greedy:facility', 'none', …  Runs on the card
unless ``device`` (or the mesh's device) says otherwise.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.functions import make_objective
from repro_torch.core.greedy import greedy
from repro_torch.core.greedyml import (greedyml_distributed,
                                       randgreedi_distributed)
from repro_torch.core.simulate import run_greedy_dense, run_tree_dense
from repro_torch.core.tree import AccumulationTree, randgreedi_tree
from repro_torch.launch.mesh import TreeMesh, factor_tree_axes
from repro_torch.runtime import flags
from repro_torch.runtime.device import DeviceLike


def parse_spec(spec: str) -> Tuple[str, str]:
    if spec in ("none", ""):
        return "none", ""
    algo, _, obj = spec.partition(":")
    return algo, obj or "facility"


def embed_documents(tokens: np.ndarray, dim: int = 256, seed: int = 0
                    ) -> np.ndarray:
    """Cheap deterministic doc embeddings: hashed bag-of-tokens projection
    (a stand-in for model forward features; unit-normalized)."""
    rng = np.random.default_rng(seed)
    vocab_proj = rng.normal(0, 1.0 / np.sqrt(dim),
                            (int(tokens.max()) + 1, dim)).astype(np.float32)
    emb = vocab_proj[tokens.reshape(-1)].reshape(*tokens.shape, dim)
    emb = emb.mean(axis=1)
    emb /= np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-9)
    return emb.astype(np.float32)


def _chosen(sol) -> np.ndarray:
    return sol.ids[sol.valid].cpu().numpy()


def _select_on_mesh(algo: str, obj_name: str, block, k: int,
                    mesh: TreeMesh, axes: Tuple[str, ...]) -> np.ndarray:
    obj = make_objective(obj_name, device=mesh.device)
    pay = torch.as_tensor(block).to(mesh.device, torch.float32)
    n_l = pay.shape[0]
    ids = torch.arange(mesh.lane * n_l, (mesh.lane + 1) * n_l,
                       device=mesh.device)
    valid = torch.ones(n_l, dtype=torch.bool, device=mesh.device)
    if algo == "greedyml":
        return _chosen(greedyml_distributed(obj, ids, pay, valid, k, mesh,
                                            axes))
    if algo == "randgreedi":
        return _chosen(randgreedi_distributed(obj, ids, pay, valid, k,
                                              mesh, axes))
    if algo == "greedy":
        # the sequential baseline over the whole pool, on every rank
        flat = mesh.flat()
        return _chosen(greedy(obj, flat.all_gather(0, ids),
                              flat.all_gather(0, pay),
                              flat.all_gather(0, valid), k))
    raise KeyError(algo)


def select_coreset(embeddings, k: int, spec: str = "greedyml:facility",
                   mesh: Optional[TreeMesh] = None,
                   tree_axes: Optional[Sequence[str]] = None,
                   machines: int = 8, branching: int = 2,
                   seed: int = 0, stream_batch: int = 0,
                   stream_order: str = "shuffled",
                   stream_eval: int = 0,
                   device: DeviceLike = None) -> np.ndarray:
    """Returns the selected document indices (≤ k). With a ``mesh``,
    ``embeddings`` is THIS rank's block and the indices are global."""
    algo, obj_name = parse_spec(spec)
    n = embeddings.shape[0]
    if algo == "none":
        return np.arange(n)
    if algo == "stream":
        from repro_torch.data.synthetic import Stream
        from repro_torch.streaming import stream_select
        if obj_name in ("kcover", "kdom", "coverage"):
            raise ValueError("stream:* coreset selection operates on "
                             "embeddings; stream coverage sets through "
                             "streaming.stream_select")
        rng = np.random.default_rng(seed + 101)
        emb = np.asarray(embeddings, np.float32)
        stream = Stream(emb, rng.permutation(n) if stream_order == "shuffled"
                        else np.arange(n),
                        stream_batch or flags.stream_batch())
        obj = make_objective(obj_name, device=device)
        # evaluation ground: the pool, or a fixed subsample so sieve state
        # stays O(levels·stream_eval) regardless of the stream's length
        ground = emb
        if 0 < stream_eval < n:
            ground = ground[rng.choice(n, stream_eval, replace=False)]
        sol = stream_select(obj, stream, k, ground=torch.as_tensor(ground))
        return _chosen(sol)
    if mesh is not None:
        axes = tuple(tree_axes or factor_tree_axes(mesh, mesh.axis_names))
        return _select_on_mesh(algo, obj_name, embeddings, k, mesh, axes)
    # single-device simulation path
    if algo == "greedy":
        return run_greedy_dense(obj_name, embeddings, k, device=device).ids
    tree = (randgreedi_tree(machines) if algo == "randgreedi"
            else AccumulationTree(machines, branching))
    return run_tree_dense(obj_name, embeddings, k, tree, seed=seed,
                          device=device).ids
