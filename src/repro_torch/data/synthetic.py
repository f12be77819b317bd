"""Deterministic synthetic datasets (answers `src/repro/data/synthetic.py`).

`gen_images`, `gen_embeddings`, `gen_tokens`, `gen_kcover`,
`gen_graph_road`, `gen_graph_social`, `pack_bitmaps` and `gen_stream`
are numpy copies of the reference's
generators: the same seed gives the same arrays and the same arrival
orders. `gen_images_on` draws the same mixture-of-Gaussians recipe
directly on a torch device (the card unless the caller names another)
from a seeded `torch.Generator` — other numbers than numpy's from the
same seed, but no host-side generation of multi-gigabyte datasets.

`Stream` differs from the reference's in one respect: it gathers each
arrival batch by index from the payloads where they lie (a tensor on the
card stays there), instead of building the whole permuted copy
`payloads[order]` on the host first (5.1 GB at kosarak's shape).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, List, Tuple

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


def gen_embeddings(n: int, d: int, clusters: int = 50, seed: int = 0
                   ) -> np.ndarray:
    """Unit-norm document embeddings (facility-location data selection)."""
    return gen_images(n, d, classes=clusters, seed=seed)


def gen_tokens(n_docs: int, seq: int, vocab: int, seed: int = 0
               ) -> np.ndarray:
    """Zipf token corpus (n_docs, seq) int32, reserving id 0 as pad."""
    rng = np.random.default_rng(seed)
    toks = (rng.zipf(1.2, size=(n_docs, seq)) % (vocab - 1)) + 1
    return toks.astype(np.int32)


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


# ---------------------------------------------------------------------------
# arrival streams (the streaming subsystem)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Stream:
    """A deterministic arrival stream over a dataset.

    ``payloads`` is the dataset in ORIGINAL index order — a numpy array
    or a tensor on any device — and ``order`` the (n,) arrival
    permutation of element ids. Iterating yields ``(ids, payloads,
    valid)`` batches of exactly ``batch`` arrivals as tensors on the
    payloads' device (CPU for numpy payloads; bitmap words as the port's
    int32 words): ids int64, the batch's payload rows gathered by index,
    valid bool. The last batch is zero-padded with valid=False. Each
    iteration replays the same stream."""

    payloads: Any               # (n, …) element payloads, original order
    order: Any                  # (n,) arrival permutation of element ids
    batch: int
    universe: int = 0           # > 0 for coverage streams

    @property
    def n(self) -> int:
        return int(self.order.shape[0])

    def _payload_tensor(self) -> torch.Tensor:
        if (isinstance(self.payloads, np.ndarray)
                and self.payloads.dtype == np.uint32):
            from repro_torch.kernels.rules import to_words
            return to_words(self.payloads)
        return torch.as_tensor(self.payloads)

    def batches(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]]:
        pay = self._payload_tensor()
        dev = pay.device
        order = torch.as_tensor(np.asarray(self.order) if not isinstance(
            self.order, torch.Tensor) else self.order).to(dev, torch.int64)
        for i in range(0, self.n, self.batch):
            ids = order[i:i + self.batch]
            rows = pay[ids]
            nv = ids.shape[0]
            valid = torch.ones(self.batch, dtype=torch.bool, device=dev)
            if nv < self.batch:
                pad = self.batch - nv
                ids = torch.cat([ids, torch.zeros(pad, dtype=torch.int64,
                                                  device=dev)])
                rows = torch.cat([rows, rows.new_zeros((pad,)
                                                       + rows.shape[1:])])
                valid[nv:] = False
            yield ids, rows, valid

    def __iter__(self):
        return self.batches()


# arrivals scored at once by `_singleton_proxy`: the (n, chunk) slab of
# distances or similarities is its largest temporary
PROXY_CHUNK = 4096


def _singleton_proxy(name: str, payloads: np.ndarray) -> np.ndarray:
    """Exact raw singleton gains, used to build adversarial orderings:
    the reference's formulas, evaluated for chunks of PROXY_CHUNK
    arrivals at a time — an (n, chunk) slab, never the n×n matrix.
    Within a chunk each arrival's column is summed over the same n rows
    in the same order as the reference's one-shot sum."""
    if name in ("kcover", "kdom", "coverage"):
        return np.unpackbits(payloads.view(np.uint8),
                             axis=1).sum(axis=1).astype(np.float64)
    x = payloads.astype(np.float32)
    n = x.shape[0]
    out = np.empty(n, np.float32)
    sq = (x ** 2).sum(1)
    mind0 = np.linalg.norm(x, axis=1)
    for j in range(0, n, PROXY_CHUNK):
        c = x[j:j + PROXY_CHUNK]
        if name == "kmedoid":
            d = np.sqrt(np.maximum(sq[:, None] + sq[None, j:j + len(c)]
                                   - 2.0 * x @ c.T, 0.0))
            out[j:j + len(c)] = np.maximum(mind0[:, None] - d,
                                           0.0).sum(axis=0)
        else:                                             # facility
            out[j:j + len(c)] = np.maximum(x @ c.T, 0.0).sum(axis=0)
    return out


def gen_stream(name: str, n: int, *, d: int = 64, universe: int = 0,
               batch: int = 64, order: str = "shuffled", seed: int = 0,
               clusters: int = 20, avg_size: float = 10.0) -> Stream:
    """Deterministic arrival stream over the generators above, as the
    reference builds it (numpy payloads).

    ``name``: 'kcover' (packed bitmaps; needs ``universe``) | 'kmedoid' |
    'facility' (unit-norm embeddings). ``order``:
      * 'shuffled'    — uniform random arrival order
      * 'adversarial' — ascending singleton gain: the most valuable
                        elements arrive LAST
      * 'drift'       — cluster-ordered arrivals (each cluster's mass
                        arrives contiguously)
    """
    rng = np.random.default_rng(seed + 101)
    if name in ("kcover", "kdom", "coverage"):
        if universe <= 0:
            raise ValueError("coverage streams need a universe size")
        sets = gen_kcover(n, universe, seed=seed, avg_size=avg_size)
        payloads = pack_bitmaps(sets, universe)
        drift_key = np.asarray([int(s[0]) if len(s) else 0 for s in sets])
    else:
        payloads = gen_images(n, d, classes=clusters, seed=seed)
        centers = gen_images(clusters, d, classes=clusters, seed=seed + 7)
        drift_key = np.argmax(payloads @ centers.T, axis=1)
    if order == "shuffled":
        perm = rng.permutation(n)
    elif order == "adversarial":
        perm = np.argsort(_singleton_proxy(name, payloads), kind="stable")
    elif order == "drift":
        perm = np.argsort(drift_key, kind="stable")
    else:
        raise KeyError(f"unknown stream order {order!r}")
    return Stream(payloads, perm.astype(np.int64), batch, universe)
