"""Engine planning for one H100 (answers `src/repro/kernels/plans.py`).

`select_engine` turns (rule, shapes, budgets) into the `EnginePlan` a
greedy invocation runs. The tier names are the reference's; the budget
math is derived again for Hopper, because the TPU notion of "resident"
(VMEM holds the whole (N, C) matrix) does not exist on a GPU: a 400×400
f32 node matrix is 640 KB against 227 KB of shared memory per block.

Tiers, for a batch of ``replicas`` greedies that one launch serves:

  resident   the loop block's state row, mask and argmax scratch fit one
             block's shared memory, AND the matrices of all `replicas`
             greedies fit the L2 share (flags.resident_l2_mb, 25 MB).
             The kernel builds each matrix into a device scratch that
             stays in L2 and runs all k steps: ONE launch per level.
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
The kernels read every rung as it is stored. The resident tier's scratch
stays f32 whatever the rung (its kernel rounds the entries in place), so
the L2 gate counts 4 B an entry. An int8 cache is built in chunks of
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
(rules.WORD_DTYPE), and their kernels split a greedy by CANDIDATES, each
block holding the whole (W,) word row. The streaming gate is the
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

The CUDA kernels mask their ragged edges, so shapes are planned
unpadded (the TPU tile padding of the reference has no counterpart).
The autotune cache, `shard_plan`, `serve_plan` and `plan_tree` of the
reference wait for later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.kernels.rules import KernelRule, cache_itemsize
from repro_torch.runtime import flags

ENGINES = ("step", "fused", "mega_stream", "mega_resident")

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
# candidates per block of the bitmap kernels (one warp per candidate, 8
# warps a block), which their wrappers size themselves. fused_step: at
# the kcover leaf (32 greedies × 30,938) 484 blocks per greedy, each
# folding and copying the 5 KB word row for 64 candidates' 330 KB. The
# loops' targets, widened by the wrapper until all blocks fit the card at
# once: the streaming tier's leaves, and the resident tier's nodes of
# b·k candidates, split over several blocks each so a level's few nodes
# spread over the SMs (one grid barrier a step). At kcover's level 1
# (16 nodes × 128 × 1,290 words, k = 64) on an H100 SXM 700 W, 8 a block
# took 0.39 ms, 16 0.53 ms and one block a node 2.78 ms (chip_smoke.py,
# timing_coverage's sweep)
# f32 bytes of one chunk of an int8 cache build: the greedies whose f32
# matrices fit it are built and quantized at once (at least one). At the
# Tiny-ImageNet leaves a greedy's matrix is 43 MB, so each chunk is one
# greedy — still 676 tiles of 128×128, over 5 a SM, for the pairwise
# kernel
QUANT_CHUNK_BYTES = 64 * 2 ** 20
BITS_BLOCK_C = 64
BITS_LOOP_BLOCK_C = 256
BITS_RESIDENT_BLOCK_C = 8


@dataclasses.dataclass(frozen=True)
class EnginePlan:
    """The planner's verdict for one (batched) greedy invocation.

    engine        'step' | 'fused' | 'mega_stream' | 'mega_resident'
    rule          the objective's KernelRule
    tier          raw fused_plan tier, None when every cache was refused
    block_n       ground rows a chunk of the per-step fused kernel's
                  gain sum (feature rules; 0 for bitmap rules, whose kernels'
                  wrappers size their candidate blocks: BITS_*_BLOCK_C)
    loop_block_n  target ground rows per block of the streaming loop
                  (feature rules; 0 for bitmap rules)
    dtype         cache storage dtype ('float32'|'bfloat16'|'int8'|'uint32')
    replicas      greedies served by one launch (the batch dimension)
    """
    engine: str
    rule: KernelRule
    tier: Optional[str] = None
    block_n: int = 0
    loop_block_n: int = 0
    dtype: str = "float32"
    replicas: int = 1

    @property
    def cached(self) -> bool:
        return self.engine != "step"


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
    """Target rows per block of the STREAMING loop kernel over `c`
    candidates of a `dtype` cache; 0 if none fits. A block keeps its
    rows' state (and int8 scales), its own copy of the (C,) candidate
    mask and the argmax scratch in shared memory across all k steps; the
    kernel wrapper may give a block more rows than this when the card
    cannot hold enough blocks at once."""
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
                  replicas: int = 1) -> bool:
    """The resident gate: one block's state fits shared memory and all
    concurrent matrices fit the L2 share. The resident kernel keeps its
    matrices in an f32 scratch whatever the cache dtype (a bf16/int8
    plan rounds the entries in place), so an entry counts 4 B — a
    bitmap's words 4 B too."""
    need = _resident_need(n, c, d, rule=rule)
    if need is None or need > _smem_budget():
        return False
    return max(1, replicas) * n * c * 4 <= flags.resident_l2_mb() * 2 ** 20


def cache_bytes(n: int, c: int, dtype: str, replicas: int = 1) -> int:
    """Device bytes of `replicas` cached (n, c) matrices stored as
    `dtype`, an int8 matrix with its (n,) f32 row scales — for bitmap
    rules (dtype 'uint32') the candidates' 32-bit words, which the
    "matrix" views."""
    scales = 4 * n if dtype == "int8" else 0
    return max(1, replicas) * (n * c * cache_itemsize(dtype) + scales)


def quant_chunk(n: int, c: int) -> int:
    """Greedies per chunk of an int8 cache build of (n, c) matrices."""
    return max(1, QUANT_CHUNK_BYTES // max(1, 4 * n * c))


def fused_plan(n: int, c: int, d: Optional[int] = None,
               rule: Optional[KernelRule] = None,
               replicas: int = 1) -> Optional[dict]:
    """Memory gate for the cached-matrix engines: None when no (n, c)
    matrix fits the cache budget in any permitted storage dtype, else
    {'tier', 'block_n', 'loop_block_n', 'dtype'} (see module doc)."""
    bitmap = rule is not None and rule.is_bitmap
    reps = max(1, replicas)
    cache = flags.fused_cache_mb() * 2 ** 20
    forced = {"f32": "float32", "bf16": "bfloat16",
              "int8": "int8"}.get(flags.fused_cache_dtype())
    dtype = None
    if bitmap:
        if cache_bytes(n, c, "uint32", reps) <= cache:
            dtype = "uint32"
    else:
        for cand in ("float32", "bfloat16", "int8"):
            if forced is not None and cand != forced:
                continue
            if cache_bytes(n, c, cand, reps) <= cache:
                dtype = cand
                break
    if dtype is None:
        return None
    bn = 0 if bitmap else fused_block_n(dtype)
    if ((bitmap or d is not None)
            and resident_fits(n, c, d, rule=rule, replicas=reps)):
        return {"tier": "resident", "block_n": bn, "loop_block_n": 0,
                "dtype": dtype}
    if bitmap:
        # the bitmap kernels keep the (W,) word row in shared memory; the
        # streaming gate counts the whole (C,) mask beside it (one block
        # a greedy, where the card cannot hold more)
        if 4 * n + REDUCE_BYTES > _smem_budget():
            return None
        loop = 4 * (n + c) + REDUCE_BYTES <= _smem_budget()
        return {"tier": "streaming" if loop else "fused", "block_n": 0,
                "loop_block_n": 0, "dtype": dtype}
    if bn == 0:
        return None
    bn_loop = loop_block_n(c, dtype)
    return {"tier": "streaming" if bn_loop else "fused",
            "block_n": bn, "loop_block_n": bn_loop, "dtype": dtype}


def select_engine(rule: KernelRule, n: int, c: int,
                  d: Optional[int] = None, *, requested: str = "auto",
                  sampling: bool = False, constrained: bool = False,
                  replicas: int = 1) -> EnginePlan:
    """Resolve the selection engine for one batched greedy invocation.

    n: ground rows (universe WORDS for bitmap rules), c: candidates,
    d: feature dim (None for bitmap rules), replicas: greedies in the
    batch (their caches live at once). `requested` is greedy(engine=…):

      auto   megakernel when the tier gate admits it and neither sampling
             nor a constraint is active; fused when the cache fits and
             sampling is off; per-step otherwise
      mega   megakernel, falling back to fused, then step
      fused  the cached per-step engine; step when the cache busts
      step   always the recompute-per-step path
    """
    if requested not in ("auto", "mega", "fused", "step"):
        raise ValueError(f"unknown engine {requested!r}; "
                         "expected 'auto', 'mega', 'fused', or 'step'")
    step = EnginePlan("step", rule, replicas=replicas)
    if requested == "step":
        return step
    fp = fused_plan(n, c, d=d, rule=rule, replicas=replicas)
    if fp is None:
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
