"""Deterministic synthetic datasets (answers `src/repro/data/synthetic.py`).

`gen_images`, `gen_kcover`, `gen_graph_road`, `gen_graph_social` and
`pack_bitmaps` are numpy copies of the reference's generators: the same
seed gives the same arrays. `gen_images_on` draws the same
mixture-of-Gaussians recipe directly on a torch device (the card unless
the caller names another) from a seeded `torch.Generator` — other
numbers than numpy's from the same seed, but no host-side generation of
multi-gigabyte datasets.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.runtime.device import DeviceLike, resolve_device


def pack_bitmaps(sets: List[np.ndarray], universe: int) -> np.ndarray:
    """Sparse index lists → packed uint32 bitmaps (n, ceil(U/32))."""
    w = (universe + 31) // 32
    out = np.zeros((len(sets), w), np.uint32)
    for i, s in enumerate(sets):
        words, bits = s // 32, s % 32
        np.bitwise_or.at(out[i], words, np.uint32(1) << bits.astype(np.uint32))
    return out


def gen_kcover(n: int, universe: int, seed: int = 0,
               avg_size: float = 10.0) -> List[np.ndarray]:
    """Power-law (zipf-ish) itemset sizes, items zipf-distributed."""
    rng = np.random.default_rng(seed)
    sizes = np.minimum(rng.pareto(1.5, n) * avg_size * 0.5 + 1,
                       universe // 4).astype(np.int64)
    ranks = rng.zipf(1.3, size=int(sizes.sum() * 1.2)) - 1
    ranks = ranks[ranks < universe]
    pool_pos = 0
    sets = []
    for sz in sizes:
        if pool_pos + sz > len(ranks):
            extra = rng.integers(0, universe, size=int(sizes.sum()))
            ranks = np.concatenate([ranks, extra])
        s = np.unique(ranks[pool_pos:pool_pos + sz])
        pool_pos += sz
        sets.append(s.astype(np.int64))
    return sets


def gen_graph_road(n: int, seed: int = 0) -> List[np.ndarray]:
    """Near-planar low-degree graph: grid edges + sparse shortcuts
    (avg degree ≈ 2.4 like road_usa). Returns CLOSED neighborhoods δ(u)."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(n))
    adj = [[] for _ in range(n)]
    for u in range(n):
        r, c = divmod(u, side)
        if c + 1 < side and u + 1 < n and rng.random() < 0.62:
            adj[u].append(u + 1)
            adj[u + 1].append(u)
        if r + 1 < side and u + side < n and rng.random() < 0.58:
            adj[u].append(u + side)
            adj[u + side].append(u)
    m_extra = int(0.02 * n)
    us = rng.integers(0, n, m_extra)
    vs = rng.integers(0, n, m_extra)
    for u, v in zip(us, vs):
        if u != v:
            adj[u].append(int(v))
            adj[v].append(int(u))
    return [np.unique(np.asarray(a + [u], np.int64))
            for u, a in enumerate(adj)]


def gen_graph_social(n: int, seed: int = 0, avg_deg: float = 16.0
                     ) -> List[np.ndarray]:
    """Heavy-tail degree graph (Friendster-like regime, scaled down).
    Returns CLOSED neighborhoods δ(u)."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.8, n) + 1, n // 10)
    deg = (deg * (avg_deg / deg.mean())).astype(np.int64) + 1
    adj = [[] for _ in range(n)]
    for u in range(n):
        tgt = rng.zipf(1.4, deg[u]) % n
        for v in tgt:
            if v != u:
                adj[u].append(int(v))
                adj[int(v)].append(u)
    return [np.unique(np.asarray(a + [u], np.int64))
            for u, a in enumerate(adj)]


def gen_images(n: int, d: int, classes: int = 20, seed: int = 0
               ) -> np.ndarray:
    """Mixture-of-Gaussians 'images', paper preprocessing: subtract mean,
    L2-normalize each vector."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 1.0, (classes, d))
    lbl = rng.integers(0, classes, n)
    x = centers[lbl] + rng.normal(0, 0.35, (n, d))
    x = x - x.mean(axis=1, keepdims=True)
    x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-9)
    return x.astype(np.float32)


def gen_images_on(n: int, d: int, classes: int = 20, seed: int = 0,
                  device: DeviceLike = None,
                  chunk: int = 16_384) -> torch.Tensor:
    """The `gen_images` recipe drawn on `device` (f32, (n, d); default the
    CUDA device, see runtime/device.py): class centers N(0, 1),
    per-image noise N(0, 0.35²), mean-subtracted and L2-normalized per
    image. Generated in row chunks so the temporaries stay a fraction of
    the result."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn((classes, d), generator=gen, device=device)
    lbl = torch.randint(0, classes, (n,), generator=gen, device=device)
    out = torch.empty((n, d), dtype=torch.float32, device=device)
    for i in range(0, n, chunk):
        j = min(n, i + chunk)
        x = centers[lbl[i:j]] + 0.35 * torch.randn(
            (j - i, d), generator=gen, device=device)
        x = x - x.mean(dim=1, keepdim=True)
        out[i:j] = x / torch.clamp(torch.linalg.vector_norm(
            x, dim=1, keepdim=True), min=1e-9)
    return out
