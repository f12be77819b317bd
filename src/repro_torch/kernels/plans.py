"""Engine planning for one H100 (answers `src/repro/kernels/plans.py`).

`select_engine` turns (rule, shapes, budgets) into the `EnginePlan` a
greedy invocation runs. The tier names are the reference's; the budget
math is derived again for Hopper, because the TPU notion of "resident"
(VMEM holds the whole (N, C) matrix) does not exist on a GPU: a 400×400
f32 node matrix is 640 KB against 227 KB of shared memory per block.

Tiers, for a batch of ``replicas`` greedies that one launch serves:

  resident   the loop block's state row, mask and argmax scratch fit one
             block's shared memory, AND the matrices of all `replicas`
             greedies, in the storage dtype, fit the L2 share
             (flags.resident_l2_mb, 25 MB). The kernel builds each
             matrix over the card and runs all k steps on a cluster a
             node: ONE dispatch per level.
  streaming  the (N, C) caches of all replicas fit the device-memory
             budget (flags.fused_cache_mb, 40 GB) and one loop block's
             rows + candidate mask fit shared memory. The pairwise
             kernel writes the caches, the loop kernel re-reads them every
             step: TWO launches per level.
  fused      the cache fits but the loop block does not (a candidate
             mask wider than shared memory): the fused per-step engine,
             one fused_step launch per selection.
  None       no cache fits in any storage dtype: per-step engine (one
             gains launch per selection).

Storage ladder: a feature rule's caches are stored f32, else bf16,
else int8 with an f32 scale per ground row (rules.quantize_rows), the
first rung whose bytes (`cache_bytes`) fit flags.fused_cache_mb — or the
rung REPRO_TORCH_FUSED_CACHE_DTYPE forces. At the Tiny-ImageNet leaves
(32 × 3,284²) that is 1.38 GB, 0.69 GB or 0.345 GB: a 1,024 MB budget
picks bf16, 512 MB int8; a node level (16 × 400², 10.2 MB) stays f32.
The kernels read every rung as it is stored, the resident tier's steps
too (its f32 build is rounded once into the rung), so the L2 gate counts
the rung's bytes an entry. An int8 cache is built in chunks of
greedies (`quant_chunk`): the f32 transient is one chunk, not the f32
cache the ladder stepped down from.

A constraint demotes the loop tiers to the fused engine, and sampling
under 'auto' takes the per-step engine (`select_engine`): the loop
kernels evaluate no per-step feasibility mask or candidate subset.

At the Tiny-ImageNet configuration (n = 100,000, m = 32, b = 2,
k = 200) the leaves hold 32 × ≈3,200² × 4 B ≈ 1.3 GB of caches — far
over the 25 MB L2 share — and go to `streaming`; a level-1 node batch
holds 16 × 400² × 4 B = 10 MB and goes to `resident`.

Bitmap rules plan over W universe words: their "matrix" is the (W, C)
transpose of the candidates' 32-bit words, 4 B a word as allocated
(rules.WORD_DTYPE), and their step and streaming kernels split a
greedy by CANDIDATES, each block holding the whole (W,) word row (the
resident loop splits a node by WORDS over a thread-block cluster:
greedy_loop.resident_bits_plan). The streaming gate is the
bitmap loop block's shared memory with one block per greedy (the least
its wrapper falls back to): the W-word row and the (C,) mask,
4·(W + C) bytes. At kosarak's shape (W = 1,290) that admits leaves of
up to ≈56,000 candidates: m = 32 (≈30,938 each) streams, m = 8
(123,750) falls to the fused engine.

The stream filter (`stream_plan`) has its own gate. A feature level's
(N,) f32 row is cut into STREAM_CHUNKS = 8 chunks, and its decisions
run on a thread-block cluster of 8 blocks, each keeping one chunk in
its shared memory, at every N (8 blocks a level decided fastest at
every row count measured, from 2,048 to 100,000). A bitmap level's W
words sit in one block's shared memory. While a block's share fits the
H100's 227 KB a block (STREAM_SMEM_BYTES: N up to ~454,000 f32 rows, W
up to ~57,000 words) the tier is 'kernel'; beyond it the plan says
'global': the same kernels keep each level's row in device memory. The
CPU runs the plain version at any size ('plain').

The sharded tier (`shard_plan`, kernels/shard_gains.py) splits ONE
greedy's ground set over `lanes` cooperating lanes and streams candidate
tiles through the gains kernel: no cache at all, so `select_engine`
escalates to it (resident → streaming → fused → sharded) only when
every cached rung is refused and the caller offers lanes. `plan_tree`
picks the accumulation tree's shape (machines, shard lanes, branching)
from the same byte model (`engine_hbm_bytes`) under the device-memory
budget, ranked by `core/tree.py::AccumulationTree.cost_model`.

The CUDA kernels mask their ragged edges, so shapes are planned
unpadded (the TPU tile padding of the reference has no counterpart).
The serving engine (serving/engine.py) still stacks queries on one
shared candidate bucket, `bucket_len(c, 128)`: `serve_key` says which
queries stack and `serve_plan` how many, each query's real (n, c)
riding the resident loop's ``ctl``.

Measured plans (`launch/autotune.py`) outrank the static plan: an
explicit `plan_override`, then a validated entry of the JSON cache that
flags.autotune_cache_path names (REPRO_TORCH_AUTOTUNE_CACHE, off by
default), then `fused_plan`. Three things differ from the reference's
cache:

  * the key's last field is the device type the entry was measured on
    ('cuda' or 'cpu'), not a kernel backend: a plan tuned on the CPU's
    plain path never steers the card;
  * the budget snapshot records the port's own knobs (fused_cache_mb,
    fused_vmem_mb, resident_l2_mb), so a reference cache file is
    ignored, without a crash;
  * a key buckets (n, c, d) as the reference does, but the port plans
    unpadded shapes and batches of `replicas` greedies, so one key
    covers shapes whose gates disagree (a leaf tuned int8-resident alone
    is 9.8 MB; 32 stacked leaves are 313 MB, past the 25 MB L2 share).
    `_tuned_plan` holds the entry's tier and dtype to the live gates
    and ignores an entry they refuse: the static plan stands.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
from typing import Optional, Tuple

from repro_torch.kernels.rules import KernelRule, cache_itemsize
from repro_torch.runtime import flags

ENGINES = ("step", "fused", "mega_stream", "mega_resident", "sharded")
# the storage ladder of a feature rule's caches, widest first
FEATURE_DTYPES = ("float32", "bfloat16", "int8")

THREADS = 256                       # threads per block of the loop kernels
# argmax scratch of a loop block: one (value, index) pair per thread
REDUCE_BYTES = 8 * THREADS
# the pairwise tile of the resident build: two 16×68 f32 operand tiles
# (64 columns + 4 of bank padding), two 64-entry norm vectors and the 64
# row scales of an int8 ground (csrc/pairwise_tile.cuh)
TILE_BYTES = 4 * (2 * 16 * 68 + 3 * 64)
# the chunks of a feature sieve level's row that the stream filter's
# decisions sum a gain over (in chunk order), a block of a portable
# thread-block cluster each (csrc/stream_filter.cu). A decision is
# latency-bound, so a level decides fastest on all 8: at 72 levels × 256
# arrivals × 12,288 features on an H100 SXM 700 W a batch took 4.48 /
# 3.11 / 2.71 / 2.50 ms on 1 / 2 / 4 / 8 blocks a level at 2,048 rows,
# 3.95 / 2.92 / 2.64 / 2.57 at 8,192, 5.39 / 3.96 / 3.47 / 3.34 at
# 16,384 (PERF.md §6: the cluster-size sweep)
STREAM_CHUNKS = 8
# arrivals a feature decision window evaluates at once
# (csrc/stream_filter.cu: RT_WINDOW)
STREAM_WINDOW = 8
# static shared memory of a feature decision block beside its chunk of
# the row: (window, 8 warps) float64 warp sums, two sets of (window,)
# chunk sums and 8 warp maxima
STREAM_STATIC_BYTES = 8 * STREAM_WINDOW * 8 + 8 * 2 * STREAM_WINDOW + 4 * 8
# static shared memory of a bitmap level block beside its B gains, B
# admission flags and W words: 8 warp maxima and the admission's index,
# rounded up to the dynamic memory's 16-byte alignment
STREAM_BITS_STATIC_BYTES = 48
# shared memory one stream-filter block may hold: the H100's per-block
# maximum (opt-in dynamic shared memory)
STREAM_SMEM_BYTES = flags.H100_SMEM_PER_BLOCK
LOOP_BLOCK_MAX = 256                # target ground rows per loop block
LOOP_BLOCK_MIN = 8
# ground rows a chunk of the per-step fused kernel's gain sum (f32 over
# a chunk's rows in order, then the chunk partials in order: the bits of
# every design since the first); its blocks read spans of FUSED_SPAN
# columns, a span's chunks spread over a thread-block cluster of at most
# FUSED_CLUSTER_MAX blocks (csrc/fused_step.cu)
FUSED_BLOCK_N = 32
FUSED_SPAN = 128
FUSED_CLUSTER_MAX = 8
# candidates per block of the bitmap fused step and streaming loop (one
# warp per candidate, 8 warps a block), which their wrappers size
# themselves. fused_step: at the kcover leaf (32 greedies × 30,938) 484
# blocks per greedy, each folding and copying the 5 KB word row for 64
# candidates' 330 KB. The streaming loop's target, widened by the
# wrapper until all blocks fit the card at once (one grid barrier a
# step)
# f32 bytes of one chunk of an int8 cache build: the greedies whose f32
# matrices fit it are built and quantized at once (at least one). At the
# Tiny-ImageNet leaves a greedy's matrix is 43 MB, so each chunk is one
# greedy — still 676 tiles of 128×128, over 5 a SM, for the pairwise
# kernel
QUANT_CHUNK_BYTES = 64 * 2 ** 20
BITS_BLOCK_C = 64
BITS_LOOP_BLOCK_C = 256
# the shared memory a block of the bitmap resident loop may hold on chip
# (greedy_loop.resident_bits_plan, read at call time): the H100's
# per-block maximum less the kernel's static argmax scratch
RESIDENT_BITS_SMEM_BYTES = flags.H100_SMEM_PER_BLOCK - 1024


@dataclasses.dataclass(frozen=True)
class EnginePlan:
    """The planner's verdict for one (batched) greedy invocation.

    engine        'step' | 'fused' | 'mega_stream' | 'mega_resident' |
                  'sharded'
    rule          the objective's KernelRule
    tier          raw fused_plan tier, None when every cache was refused
    block_n       ground rows a chunk of the per-step fused kernel's
                  gain sum (feature rules; 0 for bitmap rules, whose kernels'
                  wrappers size their own blocks)
    loop_block_n  the streaming tier's admission (`loop_block_n`;
                  feature rules; 0 for bitmap rules): the streaming
                  loop sums in chunks of block_n rows, as fused_step
    dtype         cache storage dtype ('float32'|'bfloat16'|'int8'|'uint32')
    replicas      greedies served by one launch (the batch dimension)
    tile_c        sharded tier only: candidates each lane contributes to
                  a gathered tile
    lanes         sharded tier only: lanes one greedy's ground is split
                  over
    """
    engine: str
    rule: KernelRule
    tier: Optional[str] = None
    block_n: int = 0
    loop_block_n: int = 0
    dtype: str = "float32"
    replicas: int = 1
    tile_c: int = 0
    lanes: int = 1

    @property
    def cached(self) -> bool:
        # the sharded tier recomputes its tiles every step, as 'step'
        return self.engine not in ("step", "sharded")


def bucket_len(size: int, tile: int) -> int:
    """Next power-of-two multiple of `tile` ≥ size."""
    target = tile
    while target < size:
        target *= 2
    return target


def _smem_budget() -> float:
    return flags.fused_vmem_mb() * 2 ** 20


def _row_bytes(dtype: str) -> int:
    """Shared-memory bytes a loop block keeps per ground row besides its
    state: the row's f32 scale for int8 storage."""
    return 4 if dtype == "int8" else 0


def fused_block_n(dtype: str = "float32") -> int:
    """Rows a chunk of the per-step fused kernel's gain sum over a
    `dtype` cache; 0 if none fits. A block of its global tier keeps a
    chunk's state rows (in and out), their int8 scales and the argmax
    scratch in shared memory, so the shape does not enter."""
    bn = FUSED_BLOCK_N
    while bn >= LOOP_BLOCK_MIN:
        if (4 * 2 + _row_bytes(dtype)) * bn + REDUCE_BYTES <= _smem_budget():
            return bn
        bn //= 2
    return 0


def fused_cluster_fits(dtype: str, n: int, block_n: int) -> bool:
    """Whether the per-step fused kernel's cluster design takes a
    `dtype` cache of n ground rows in chunks of `block_n`: a span's
    chunks spread over FUSED_CLUSTER_MAX blocks, each keeping its chunks'
    (FUSED_SPAN,) f32 partials, its rows' state and their int8 scales in
    the H100's shared memory less the kernel's 1 KB of static scratch
    (csrc/fused_step.cu:rt_fused_cluster). Beyond (f32 or bf16 n ≳
    92,000, int8 n ≳ 77,000) the step runs the global tier, its partials
    in device memory: the same sums, the same bits."""
    chunks = -(-n // block_n)
    per_block = -(-chunks // FUSED_CLUSTER_MAX)
    need = per_block * (4 * FUSED_SPAN + (4 + _row_bytes(dtype)) * block_n)
    return need <= flags.H100_SMEM_PER_BLOCK - 1024


def loop_block_n(c: int, dtype: str = "float32") -> int:
    """The STREAMING tier's gate over `c` candidates of a `dtype` cache:
    the rows a loop block of the first design held beside its own copy
    of the (C,) candidate mask and the argmax scratch in shared memory,
    0 if none fits. The kernel since keeps only its chain columns' mask
    and chunks of the plan's block_n rows (csrc/greedy_loop.cu), so the
    gate admits no shape the kernel cannot run."""
    bn = LOOP_BLOCK_MAX
    while bn >= LOOP_BLOCK_MIN:
        if (4 * (c + bn) + _row_bytes(dtype) * bn + REDUCE_BYTES
                <= _smem_budget()):
            return bn
        bn //= 2
    return 0


def _resident_need(n: int, c: int, d: Optional[int],
                   rule: Optional[KernelRule] = None) -> Optional[int]:
    """Shared-memory bytes of one resident loop block: the node's whole
    (N,) state row, its (C,) mask, the argmax scratch and — for feature
    rules — the pairwise build tile (the bitmap kernel builds nothing);
    None when the shape cannot be resident at all (feature rules without
    a feature dim)."""
    if rule is not None and rule.is_bitmap:
        return 4 * (n + c) + REDUCE_BYTES
    if d is None:
        return None
    return 4 * (n + c) + REDUCE_BYTES + TILE_BYTES


def resident_fits(n: int, c: int, d: Optional[int],
                  rule: Optional[KernelRule] = None,
                  replicas: int = 1, dtype: str = "float32") -> bool:
    """The resident gate: one block's state fits shared memory and all
    concurrent matrices fit the L2 share in the storage the loop keeps
    them in — `dtype`'s itemsize an entry plus an int8 matrix's row
    scales (`cache_bytes`), as the reference's gate counts them; a
    bitmap's words 4 B. The f32 build before the rounding is written
    once and read once; the steps run over the stored matrix (in their
    clusters' shared memory, or beyond it from device memory)."""
    need = _resident_need(n, c, d, rule=rule)
    if need is None or need > _smem_budget():
        return False
    stored = "uint32" if rule is not None and rule.is_bitmap else dtype
    return (cache_bytes(n, c, stored, replicas)
            <= flags.resident_l2_mb() * 2 ** 20)


def cache_bytes(n: int, c: int, dtype: str, replicas: int = 1) -> int:
    """Device bytes of `replicas` cached (n, c) matrices stored as
    `dtype`, an int8 matrix with its (n,) f32 row scales — for bitmap
    rules (dtype 'uint32') the candidates' 32-bit words, which the
    "matrix" views."""
    scales = 4 * n if dtype == "int8" else 0
    return max(1, replicas) * (n * c * cache_itemsize(dtype) + scales)


def loop_scratch_bytes(n: int, c: int, dtype: str, replicas: int = 1,
                       block_n: int = FUSED_BLOCK_N) -> int:
    """Device bytes of the streaming loop's chunk partials over `replicas`
    (n, c) caches stored as `dtype`: each greedy's ceil(n / block_n) f32
    rows of its spans' columns (128 for f32, 256 for bf16 and int8;
    csrc/greedy_loop.cu), beside the cache while the loop runs."""
    span = 128 if dtype == "float32" else 256
    return (max(1, replicas) * -(-n // max(1, block_n))
            * -(-c // span) * span * 4)


def quant_chunk(n: int, c: int) -> int:
    """Greedies per chunk of an int8 cache build of (n, c) matrices."""
    return max(1, QUANT_CHUNK_BYTES // max(1, 4 * n * c))


def forced_dtype() -> Optional[str]:
    """The storage REPRO_TORCH_FUSED_CACHE_DTYPE forces on feature rules
    ('float32' | 'bfloat16' | 'int8'), or None under 'auto'."""
    return {"f32": "float32", "bf16": "bfloat16",
            "int8": "int8"}.get(flags.fused_cache_dtype())


def tier_admits(rule: Optional[KernelRule], n: int, c: int,
                d: Optional[int], tier: str, dtype: str,
                replicas: int = 1) -> bool:
    """Whether the live gates admit a cached `tier` in `dtype` for
    `replicas` (n, c, d) greedies: the cache budget for every cached
    tier, `resident_fits` for 'resident', the loop block's shared memory
    for 'streaming', a chunk size (feature rules) or the word row
    (bitmap rules) for 'fused'. `fused_plan` asks them of the ladder's
    first rung whose cache fits; `_tuned_plan` of a cached entry.

    The bitmap kernels keep the (W,) word row in shared memory; their
    streaming gate counts the whole (C,) mask beside it (one block a
    greedy, where the card cannot hold more)."""
    bitmap = rule is not None and rule.is_bitmap
    reps = max(1, replicas)
    if cache_bytes(n, c, dtype, reps) > flags.fused_cache_mb() * 2 ** 20:
        return False
    if tier == "resident":
        return ((bitmap or d is not None)
                and resident_fits(n, c, d, rule=rule, replicas=reps,
                                  dtype=dtype))
    if bitmap:
        if tier == "streaming":
            return 4 * (n + c) + REDUCE_BYTES <= _smem_budget()
        return tier == "fused" and 4 * n + REDUCE_BYTES <= _smem_budget()
    if fused_block_n(dtype) == 0:
        return False
    if tier == "streaming":
        return loop_block_n(c, dtype) > 0
    return tier == "fused"


def fused_plan(n: int, c: int, d: Optional[int] = None,
               rule: Optional[KernelRule] = None,
               replicas: int = 1) -> Optional[dict]:
    """Memory gate for the cached-matrix engines: None when no (n, c)
    matrix fits the cache budget in any permitted storage dtype, else
    {'tier', 'block_n', 'loop_block_n', 'dtype'} (see module doc): the
    first of resident, streaming and fused that `tier_admits` in the
    ladder's first rung whose caches fit."""
    bitmap = rule is not None and rule.is_bitmap
    reps = max(1, replicas)
    cache = flags.fused_cache_mb() * 2 ** 20
    forced = forced_dtype()
    ladder = (("uint32",) if bitmap else
              [t for t in FEATURE_DTYPES if forced in (None, t)])
    dtype = next((t for t in ladder
                  if cache_bytes(n, c, t, reps) <= cache), None)
    if dtype is None:
        return None
    for tier in ("resident", "streaming", "fused"):
        if tier_admits(rule, n, c, d, tier, dtype, reps):
            return {"tier": tier,
                    "block_n": 0 if bitmap else fused_block_n(dtype),
                    "loop_block_n": (loop_block_n(c, dtype)
                                     if tier == "streaming" and not bitmap
                                     else 0),
                    "dtype": dtype}
    return None


# ---------------------------------------------------------------------------
# measured plans: the on-disk autotune cache (launch/autotune.py; answers
# src/repro/kernels/plans.py:472-611)
# ---------------------------------------------------------------------------

AUTOTUNE_VERSION = 1

# mtime-memoised parse of the cache: a steady-state select_engine call
# costs one os.stat, and a rewritten file is picked up without a restart
_AUTOTUNE_MEMO: dict = {}


def autotune_key(rule: KernelRule, n: int, c: int, d: Optional[int],
                 device: str) -> str:
    """Cache key per (rule, bucketed shape, device type): the reference's
    buckets (n to bucket_len(n, 256), c to bucket_len(c, 128), d up to a
    multiple of 128, 0 for bitmap rules), so the strings match the
    reference's up to the last field, which names the device type the
    entry was measured on ('cuda' or 'cpu')."""
    n_pad, c_pad = bucket_len(n, 256), bucket_len(c, 128)
    d_pad = 0 if (rule.is_bitmap or not d) else -(-d // 128) * 128
    return f"{rule.name}|n{n_pad}|c{c_pad}|d{d_pad}|{device}"


def budget_snapshot() -> dict:
    """The port's budget knobs a tuned entry was measured under: saved
    with the entry, compared at lookup (a stale snapshot ⇒ the entry is
    ignored)."""
    return {"fused_cache_mb": flags.fused_cache_mb(),
            "fused_vmem_mb": flags.fused_vmem_mb(),
            "resident_l2_mb": flags.resident_l2_mb()}


def load_autotune_cache(path: Optional[str] = None) -> dict:
    """Entries of the measured-plan cache, or {} when the knob is off,
    the file is missing, fails to parse or carries another schema
    version: a corrupt or stale cache never crashes a run."""
    path = path if path is not None else flags.autotune_cache_path()
    if not path:
        return {}
    ap = os.path.abspath(path)
    try:
        st = os.stat(ap)
    except OSError:
        return {}
    memo = _AUTOTUNE_MEMO.get(ap)
    if memo is not None and memo[0] == st.st_mtime_ns:
        return memo[1]
    try:
        with open(ap, "r", encoding="utf-8") as f:
            blob = json.load(f)
        entries = blob["entries"]
        if blob.get("version") != AUTOTUNE_VERSION \
                or not isinstance(entries, dict):
            entries = {}
    except (OSError, ValueError, KeyError, TypeError):
        entries = {}
    _AUTOTUNE_MEMO[ap] = (st.st_mtime_ns, entries)
    return entries


def save_autotune_cache(entries: dict, path: Optional[str] = None) -> str:
    """Persist tuned entries, merged over any valid existing file: sorted
    keys, written to a sibling tmp file, fsynced and renamed into place
    (a crashed tuner leaves the previous cache whole)."""
    path = path if path is not None else flags.autotune_cache_path()
    if not path:
        raise ValueError("save_autotune_cache needs "
                         f"{flags.AUTOTUNE_CACHE_ENV} or path=")
    ap = os.path.abspath(path)
    merged = dict(load_autotune_cache(ap))
    merged.update(entries)
    os.makedirs(os.path.dirname(ap) or ".", exist_ok=True)
    tmp = ap + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"version": AUTOTUNE_VERSION, "entries": merged}, f,
                  indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, ap)
    return ap


def block_n_ladder(dtype: str):
    """The chunk sizes (ground rows a chunk of the fused and streaming
    gain sums) the planner hands the CUDA wrappers for a `dtype` cache:
    fused_block_n(dtype) halved down to LOOP_BLOCK_MIN, largest first.
    Feature rules only; a bitmap plan's block_n is 0."""
    bn, out = fused_block_n(dtype), []
    while bn >= LOOP_BLOCK_MIN:
        out.append(bn)
        bn //= 2
    return out


def _tuned_plan(rule: KernelRule, n: int, c: int, d: Optional[int],
                device: str, replicas: int = 1) -> Optional[dict]:
    """The validated fused_plan-shaped dict of a tuned entry, or None: no
    cache, no entry, a stale budget snapshot, malformed fields, a dtype
    REPRO_TORCH_FUSED_CACHE_DTYPE forced off, or a tier and dtype the
    live gates refuse at this (n, c, d, replicas) — then the static plan
    stands, so an entry never moves a run onto a tier its shape does not
    admit."""
    entries = load_autotune_cache()
    if not entries:
        return None
    e = entries.get(autotune_key(rule, n, c, d, device))
    if not isinstance(e, dict) or e.get("budgets") != budget_snapshot():
        return None
    tier = e.get("tier")
    if tier == "step":
        return {"tier": "step", "block_n": 0, "loop_block_n": 0,
                "dtype": "float32"}
    dtype = e.get("dtype")
    allowed = ("uint32",) if rule.is_bitmap else FEATURE_DTYPES
    forced = forced_dtype()
    if (tier not in ("resident", "streaming", "fused")
            or dtype not in allowed
            or (forced is not None and not rule.is_bitmap
                and dtype != forced)):
        return None
    try:
        bn, bl = int(e.get("block_n", 0)), int(e.get("loop_block_n", 0))
    except (TypeError, ValueError):
        return None
    if not tier_admits(rule, n, c, d, tier, dtype, replicas):
        return None
    if rule.is_bitmap:
        bn, bl = 0, 0
    elif tier in ("streaming", "fused"):
        if bn not in block_n_ladder(dtype):
            return None
        if tier == "streaming" and not 0 < bl <= loop_block_n(c, dtype):
            return None
        bl = bl if tier == "streaming" else 0
    else:
        bn, bl = fused_block_n(dtype), 0
    return {"tier": tier, "block_n": bn, "loop_block_n": bl,
            "dtype": dtype}


_PLAN_OVERRIDE: Optional[dict] = None


@contextlib.contextmanager
def plan_override(fp: Optional[dict]):
    """Force select_engine to take this fused_plan-shaped dict verbatim
    (past both the cache and the static plan) for the calls inside: how
    launch/autotune.py times each candidate through the real greedy
    driver. Process-wide, not thread-safe."""
    global _PLAN_OVERRIDE
    old = _PLAN_OVERRIDE
    _PLAN_OVERRIDE = fp
    try:
        yield
    finally:
        _PLAN_OVERRIDE = old


def select_engine(rule: KernelRule, n: int, c: int,
                  d: Optional[int] = None, *, requested: str = "auto",
                  sampling: bool = False, constrained: bool = False,
                  replicas: int = 1, lanes: int = 1,
                  device: str = "cuda") -> EnginePlan:
    """Resolve the selection engine for one batched greedy invocation
    (answers `select_engine`, src/repro/kernels/plans.py:614).

    n: ground rows (universe WORDS for bitmap rules), c: candidates,
    d: feature dim (None for bitmap rules), replicas: greedies in the
    batch (their caches live at once). `requested` is greedy(engine=…):

      auto   megakernel when the tier gate admits it and neither sampling
             nor a constraint is active; fused when the cache fits and
             sampling is off; per-step otherwise
      mega   megakernel, falling back to fused, then step
      fused  the cached per-step engine; step when the cache busts
      step   always the recompute-per-step path

    `lanes` > 1 declares that the caller can split this greedy's ground
    over that many lanes (kernels/shard_gains.py): when every cached
    tier is refused, 'auto'/'mega' with no sampling and no constraint
    escalate to engine 'sharded' with `shard_plan`'s tile_c, where the
    shard gate admits the pool (the reference's branch at :660-673).

    Measured plans come first: a `plan_override`, then the cache entry
    of (rule, n, c, d, `device`) — the device type the greedies run on —
    that `_tuned_plan` validates against the live gates at `replicas`;
    a tuned 'step' entry returns the step engine.
    """
    if requested not in ("auto", "mega", "fused", "step"):
        raise ValueError(f"unknown engine {requested!r}; "
                         "expected 'auto', 'mega', 'fused', or 'step'")
    step = EnginePlan("step", rule, replicas=replicas)
    if requested == "step":
        return step
    fp = _PLAN_OVERRIDE
    if fp is None:
        fp = _tuned_plan(rule, n, c, d, device, replicas)
    if fp is None:
        fp = fused_plan(n, c, d=d, rule=rule, replicas=replicas)
    elif fp.get("tier") == "step":
        return step
    if fp is None:
        if (lanes > 1 and requested in ("auto", "mega")
                and not sampling and not constrained):
            sp = shard_plan(rule, n, d, lanes)
            if sp is not None:
                return EnginePlan("sharded", rule, tier="sharded",
                                  dtype=sp["dtype"], replicas=replicas,
                                  tile_c=sp["tile_c"], lanes=lanes)
        return step
    mega_ok = (requested in ("auto", "mega") and not sampling
               and not constrained and fp["tier"] in ("resident",
                                                      "streaming"))
    if mega_ok:
        engine = ("mega_resident" if fp["tier"] == "resident"
                  else "mega_stream")
    elif requested in ("fused", "mega") or not sampling:
        engine = "fused"
    else:
        return step
    return EnginePlan(engine, rule, tier=fp["tier"], block_n=fp["block_n"],
                      loop_block_n=fp["loop_block_n"], dtype=fp["dtype"],
                      replicas=replicas)


def serve_key(rule: KernelRule, n: int, c: int, d: Optional[int],
              backend: str) -> str:
    """Admission-compatibility key of the serving engine (answers
    `serve_key`, src/repro/kernels/plans.py:420): queries sharing a key
    stack into ONE resident dispatch. The rule's identity is its name,
    cap AND λ (they are kernel constants); the candidate axis buckets to
    `bucket_len(c, 128)`, the stacked width; the trailing axis — features
    D, or universe WORDS for bitmap rules — must match exactly; the
    backend is the device type the queries run on."""
    tail = f"w{n}" if rule.is_bitmap else f"d{d}"
    return (f"{rule.name}|cap{rule.cap}|lam{rule.lam}"
            f"|c{bucket_len(c, 128)}|{tail}|{backend}")


def serve_plan(rule: KernelRule, n: int, c: int, d: Optional[int],
               device: str = "cuda") -> Optional[dict]:
    """Admission plan of one stacked serving batch over (n, c, d) pools
    (answers `serve_plan`, src/repro/kernels/plans.py:437), or None when
    a query of that shape cannot ride the resident tier — the engine then
    runs it alone through greedy().

    Otherwise ``{'plan': EnginePlan, 'b_max': int, 'bytes_per_query':
    int}``. A stacked query is one node of the resident loop: its state
    (`_resident_need`) and its matrix in the plan's storage
    (`cache_bytes`). b_max caps the batch so B of them fit
    flags.serve_mem_mb (the card's shared memory, one wave of clusters)
    and flags.serve_batch, and so B matrices still pass the resident
    gate's L2 share (`select_engine` with replicas=B). ``device``: the
    device type the queries run on (the autotune cache's key)."""
    plan = select_engine(rule, n, c, d, requested="mega", device=device)
    if plan.engine != "mega_resident":
        return None
    stored = "uint32" if rule.is_bitmap else plan.dtype
    need = _resident_need(n, c, d, rule=rule)
    if need is None:
        return None
    need += cache_bytes(n, c, stored)
    b_mem = int(flags.serve_mem_mb() * 2 ** 20 // max(need, 1))
    b_max = max(1, min(flags.serve_batch(), b_mem))
    while b_max > 1 and select_engine(rule, n, c, d, requested="mega",
                                      replicas=b_max, device=device
                                      ).engine != "mega_resident":
        b_max -= 1
    return {"plan": plan, "b_max": b_max, "bytes_per_query": need}


def stream_chunk(n: int) -> int:
    """Entries of each of the STREAM_CHUNKS chunks of a feature level's
    row: ceil(n / 8) rounded up to a multiple of 4 (16-byte loads)."""
    return -(-(-(-n // STREAM_CHUNKS)) // 4) * 4


def stream_smem_bytes(n: int, b: int, rule: KernelRule) -> int:
    """Shared memory of one stream-filter block: a feature level's
    chunk of its row (`stream_chunk` f32 entries, one of the cluster's 8)
    beside the static reduction scratch; for bitmap rules (n = W words)
    the level's words, the B gains and the B admission flags."""
    if rule.is_bitmap:
        return 4 * (n + b + -(-b // 4)) + STREAM_BITS_STATIC_BYTES
    return 4 * stream_chunk(n) + STREAM_STATIC_BYTES


def stream_tier(n: int, b: int, rule: KernelRule) -> str:
    """The stream-filter kernel's tier for b arrivals against levels over
    n ground rows (universe words for bitmap rules): 'kernel' while
    shared memory holds a level's state (`stream_smem_bytes` within
    STREAM_SMEM_BYTES, read at call time), else 'global' (the level rows
    live in device memory)."""
    fits = stream_smem_bytes(n, b, rule) <= STREAM_SMEM_BYTES
    return "kernel" if fits else "global"


def stream_plan(n: int, b: int, d: Optional[int],
                rule: KernelRule) -> dict:
    """The stream filter's gate for one batch of b arrivals against
    levels over n ground rows (universe words for bitmap rules) of d
    features: {'tier': 'kernel' | 'global', 'dtype': …} (`stream_tier`).
    Both tiers are the CUDA kernel on the card, for any n; a CUDA tensor
    never runs a plain version. The third tier, 'plain', is the CPU's:
    CPU tensors run the plain sieve filter (ref.stream_sieve) at any
    size, whatever the plan says. As in the reference, 'kernel' means
    the on-chip kernel and any other tier means not.

    dtype is the ground features' storage: 'uint32' words for bitmap
    rules; 'int8' (per-row-quantized, the arrivals stay f32) when
    REPRO_TORCH_FUSED_CACHE_DTYPE forces that rung for a feature rule;
    else 'float32' ('auto' never quantizes a stream)."""
    if rule.is_bitmap:
        dtype = "uint32"
    else:
        if d is None:
            raise ValueError("a feature rule's stream needs its feature dim")
        dtype = "int8" if flags.fused_cache_dtype() == "int8" else "float32"
    return {"tier": stream_tier(n, b, rule), "dtype": dtype}


# ---------------------------------------------------------------------------
# the sharded tier (kernels/shard_gains.py) and the tree planner
# (answers src/repro/kernels/plans.py:354-392 and :696-819)
# ---------------------------------------------------------------------------

# candidate-tile ladder of the sharded tier, the reference's: a wide tile
# takes fewer gathers and gains launches a step, a narrow one a smaller
# gathered working set. The width changes launches and exchange sizes,
# never selections.
SHARD_TILE_MIN = 8
_SHARD_TILES = (512, 256, 128, 64, 32, 16, 8)


def shard_bytes(n: int, d: int, lanes: int, tile_c: int) -> int:
    """Modeled device bytes of ONE lane of a sharded greedy over an
    n-element pool split over `lanes`: its (n_s, d) feature shard with
    its ids, valid and state-row columns, and the gathered (lanes·tile_c,
    d) candidate tile with its mask and gains row. No (N, C) term."""
    n_s = -(-(-(-n // lanes)) // tile_c) * tile_c    # padded lane shard
    return 4 * n_s * (d + 3) + 4 * lanes * tile_c * (d + 2)


def shard_plan(rule: KernelRule, n: int, d: Optional[int],
               lanes: int) -> Optional[dict]:
    """The sharded tier's gate: the widest ladder tile whose lane working
    set (`shard_bytes`) fits flags.fused_cache_mb, as {'tile_c',
    'bytes', 'dtype'}; None for bitmap rules (their ground axis is the
    payload's words), one lane, no feature dim, or a pool whose least
    tile busts the budget. The tier streams f32 features (no cache, so
    no storage rung; the gains kernel reads an int8 ground only under a
    forced int8 rung, as every step engine does)."""
    if rule.is_bitmap or lanes < 2 or not d:
        return None
    budget = flags.fused_cache_mb() * 2 ** 20
    for tile in _SHARD_TILES:
        need = shard_bytes(n, d, lanes, tile)
        if need <= budget:
            return {"tile_c": tile, "bytes": need, "dtype": "float32"}
    return None


def engine_hbm_bytes(plan: EnginePlan, n: int, c: int,
                     d: Optional[int] = None) -> int:
    """Modeled device bytes one greedy holds under `plan`, the currency
    `plan_tree` compares stages in: the pool (features or bitmap words,
    ids, valid, state row) plus a cached tier's (n, c) matrix in its
    storage (`cache_bytes`, unpadded); the sharded tier its lane's
    `shard_bytes` (`n` is the whole pool)."""
    if plan.engine == "sharded":
        return shard_bytes(n, d or 0, plan.lanes, plan.tile_c)
    if plan.rule.is_bitmap:
        feat = 4 * (c * n + 2 * c + n)      # (C, W) words + ids/valid + row
    else:
        feat = 4 * (n * (d or 0) + 3 * n)
    if not plan.cached:
        return feat
    return feat + cache_bytes(n, c, plan.dtype)


@dataclasses.dataclass(frozen=True)
class TreePlan:
    """The planner's verdict for one distributed selection: how `lanes`
    lanes split into tree machines and shard lanes a leaf, and the
    engines of the two kinds of stage.

    radices     per-level branching, innermost first (LevelDispatcher's);
                () is ONE machine, every lane sharding its leaf
    shard       lanes cooperating on each leaf greedy (1: solo leaves)
    leaf_plan   EnginePlan of the leaf greedies
    node_plan   EnginePlan of the accumulation nodes' (b·k) pools
    leaf_n      elements a leaf machine owns (before the shard split)
    peak_bytes  the larger modeled per-lane bytes of the two stages
    cost        BSP cost from AccumulationTree.cost_model (lower wins)
    model       the cost_model dict the plan was checked against ({}
                for the one-machine shape it cannot express)
    """
    radices: Tuple[int, ...]
    shard: int
    leaf_plan: EnginePlan
    node_plan: EnginePlan
    leaf_n: int
    peak_bytes: int
    cost: float
    model: dict

    @property
    def machines(self) -> int:
        return math.prod(self.radices)

    @property
    def branching(self) -> int:
        return max(self.radices) if self.radices else 1

    @property
    def lanes(self) -> int:
        return self.machines * self.shard


def _radix_options(m: int):
    """Uniform level stacks multiplying to m, innermost first: every
    (b,)·L with b^L == m, from the flat RandGreedi (m,) to the deepest."""
    if m == 1:
        return [()]
    opts = []
    for b in range(2, m + 1):
        level, total = 0, 1
        while total < m:
            total *= b
            level += 1
        if total == m:
            opts.append((b,) * level)
    return opts


def plan_tree(rule: KernelRule, n: int, d: Optional[int], k: int,
              lanes: int, budget_mb: Optional[float] = None,
              words: Optional[int] = None,
              device: str = "cuda") -> Optional[TreePlan]:
    """The accumulation tree's shape for `lanes` lanes, from the byte
    model the engine tiers gate on: every shard ∈ divisors(lanes) and
    every uniform radix stack over the m = lanes / shard machines whose
    leaf and node stages both fit `budget_mb` (default
    flags.fused_cache_mb) a lane.

      leaf stage  shard == 1: `select_engine` on the ceil(n/m) pool;
                  shard > 1: the sharded tier (`select_engine(…,
                  lanes=shard)`), feasible only if the escalation fires
      node stage  `select_engine` on the b·k accumulation pool

    Ranked by BSP cost (`AccumulationTree.cost_model`: leaf compute ÷
    shard, plus interior compute and comm), then fewer levels, then more
    sharding; the model's structure is asserted against the enumerated
    tree. None when no shape fits. ``words``: a bitmap rule plans its
    ground over universe words (d is None), so it never shards.
    ``device``: the device type the stages run on (the autotune cache's
    key)."""
    from repro_torch.core.tree import AccumulationTree   # core → kernels

    if rule.is_bitmap and not words:
        raise ValueError("bitmap rules need words= for tree planning")
    budget = (budget_mb if budget_mb is not None
              else flags.fused_cache_mb()) * 2 ** 20
    obj = "kmedoid" if rule.fold == "min" else "coverage"

    def rows(c):
        return words if rule.is_bitmap else c

    best = None
    for shard in (s for s in range(1, lanes + 1) if lanes % s == 0):
        m = lanes // shard
        leaf_n = -(-n // m)
        lp = select_engine(rule, rows(leaf_n), leaf_n, d, lanes=shard,
                           device=device)
        if shard > 1 and lp.engine != "sharded":
            continue        # the solo shapes cover it
        leaf_bytes = engine_hbm_bytes(lp, rows(leaf_n), leaf_n, d)
        if leaf_bytes > budget:
            continue
        for radices in _radix_options(m):
            if radices:
                br = radices[0]
                nc = br * k
                np_ = select_engine(rule, rows(nc), nc, d, device=device)
                node_bytes = engine_hbm_bytes(np_, rows(nc), nc, d)
                if node_bytes > budget:
                    continue
                model = AccumulationTree(m, br).cost_model(
                    n, k, 1.0, objective=obj)
                # the BSP model must describe the tree it costs
                assert model["levels"] == len(radices), (model, radices)
                assert model["elements_per_interior"] == br * k
                cost = model["compute_cost"] / shard + model["comm_cost"]
            else:
                np_, node_bytes = lp, 0
                model = {}
                cost = ((n ** 2) * k if obj == "kmedoid"
                        else n * k) / shard
            cand = TreePlan(radices, shard, lp, np_, leaf_n,
                            max(leaf_bytes, node_bytes), cost, model)
            key = (cand.cost, len(cand.radices), -cand.shard)
            if best is None or key < (best.cost, len(best.radices),
                                      -best.shard):
                best = cand
    return best
