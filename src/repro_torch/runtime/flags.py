"""Typed environment knobs of the port (answers `src/repro/runtime/flags.py`).

Only the accessors the selection path reads. The variables
carry a ``REPRO_TORCH_`` prefix so a process that drives both packages
(the parity tests) can shrink one package's budgets without touching the
other's. Accessors re-read the environment on every call, so
``monkeypatch.setenv`` works.

Defaults are derived for one NVIDIA H100 SXM (80 GB HBM3, 50 MB L2,
227 KB = 232,448 bytes of shared memory per block), not copied from the
TPU budgets of the reference:

  REPRO_TORCH_FUSED_CACHE_MB    device memory for ALL cached (N, C)
                                matrices alive at once (a level's leaf
                                greedies run as one batch). Default
                                40,960 MB = half of the 80 GB: the other
                                half holds the features (4.9 GB at the
                                100k x 12,288 Tiny-ImageNet shape), the
                                padded pools (about as much again) and
                                the allocator's slack.
  REPRO_TORCH_FUSED_VMEM_MB     shared memory one block of the loop
                                kernels may hold. Default 227/1024 MB =
                                232,448 bytes, the Hopper per-block
                                maximum (opt-in dynamic shared memory).
  REPRO_TORCH_RESIDENT_L2_MB    L2 share that the matrices of all
                                concurrent resident greedies may take.
                                Default 25 MB = half of the 50 MB L2: a
                                resident node's matrix is built into a
                                device scratch that should stay in L2
                                across its k steps, and the other half
                                is left to the features streaming
                                through the build.
  REPRO_TORCH_FUSED_CACHE_DTYPE 'auto' | 'f32' | 'bf16' | 'int8' cache
                                storage: 'auto' takes the first rung of
                                f32 → bf16 → int8 whose caches fit
                                REPRO_TORCH_FUSED_CACHE_MB (plans.py);
                                the others force one rung. The CUDA
                                kernels read all three; the int8 rung
                                also stores the ground features of the
                                per-step gains and of the stream filter
                                per-row-quantized.
  REPRO_TORCH_STREAM_BATCH      arrivals a batch of the streaming
                                coreset selection (data/selection.py).
                                Default 128, the reference's: a sieve
                                re-anchors once a batch, so the batch
                                size is part of the output, not a
                                device budget.
  REPRO_TORCH_SERVE_BATCH       the serving engine's admission cap:
                                queries stacked into one resident
                                dispatch. Default 16, the reference's.
  REPRO_TORCH_SERVE_QUEUE       the serving engine's request-queue bound
                                (submit raises QueueFull beyond it).
                                Default 1,024, the reference's.
  REPRO_TORCH_SERVE_MEM_MB      on-chip memory the stacked working sets
                                of one admitted batch may take
                                (plans.serve_plan). The reference's 64 MB
                                is a TPU core's VMEM and does not carry
                                over. A stacked query is one node of the
                                resident loop: a cluster of 8 blocks
                                holding its matrix in the plan's storage
                                in shared memory, beside what
                                plans._resident_need counts (its state
                                row, mask, argmax scratch and build
                                tile). The card runs every cluster of a
                                launch at once only while all of them fit
                                its shared memory: 132 SMs × 227 KB
                                (232,448 B, one resident block an SM) =
                                30,683,136 B = 29.26 MB, the default.
                                Past it a batch runs in waves. At the
                                Tiny-ImageNet node (400 pools bucketed
                                to 512, f32) a query takes 1,064,192 B
                                (28 a batch); at kosarak's (128 sets,
                                1,290 words) 668,200 B (45), so the
                                admission cap of 16 binds first.
  REPRO_TORCH_AUTOTUNE_CACHE    path of the measured-plan JSON cache
                                that launch/autotune.py writes and
                                plans.select_engine consults before the
                                static plan. Off by default (unset, '',
                                '0', 'off', 'none', 'disabled'): runs
                                keep the static plans. A file the
                                reference's tuner wrote is not shared:
                                its entries carry the reference's budget
                                snapshot and backend, so the port
                                ignores them.
"""
from __future__ import annotations

import os
from typing import Optional

FUSED_CACHE_MB_ENV = "REPRO_TORCH_FUSED_CACHE_MB"
FUSED_VMEM_MB_ENV = "REPRO_TORCH_FUSED_VMEM_MB"
RESIDENT_L2_MB_ENV = "REPRO_TORCH_RESIDENT_L2_MB"
FUSED_CACHE_DTYPE_ENV = "REPRO_TORCH_FUSED_CACHE_DTYPE"
STREAM_BATCH_ENV = "REPRO_TORCH_STREAM_BATCH"
SERVE_BATCH_ENV = "REPRO_TORCH_SERVE_BATCH"
SERVE_QUEUE_ENV = "REPRO_TORCH_SERVE_QUEUE"
SERVE_MEM_MB_ENV = "REPRO_TORCH_SERVE_MEM_MB"
AUTOTUNE_CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"

H100_HBM_MB = 80 * 1024
H100_L2_MB = 50.0
H100_SMEM_PER_BLOCK = 232_448          # bytes, 227 KB
H100_SMS = 132                         # SMs of the H100 SXM

_FUSED_CACHE_MB_DEFAULT = H100_HBM_MB / 2            # 40,960 MB
_FUSED_VMEM_MB_DEFAULT = H100_SMEM_PER_BLOCK / 2 ** 20  # 0.2217 MB
_RESIDENT_L2_MB_DEFAULT = H100_L2_MB / 2             # 25 MB
_STREAM_BATCH_DEFAULT = 128
_SERVE_BATCH_DEFAULT = 16
_SERVE_QUEUE_DEFAULT = 1024
# every SM's shared memory, one resident block an SM: 29.26 MB
_SERVE_MEM_MB_DEFAULT = H100_SMS * H100_SMEM_PER_BLOCK / 2 ** 20


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def fused_cache_mb() -> float:
    """Device-memory budget (MB) for all concurrent cached matrices."""
    return _env_float(FUSED_CACHE_MB_ENV, _FUSED_CACHE_MB_DEFAULT)


def fused_vmem_mb() -> float:
    """Shared-memory budget (MB) of one block of the loop kernels."""
    return _env_float(FUSED_VMEM_MB_ENV, _FUSED_VMEM_MB_DEFAULT)


def resident_l2_mb() -> float:
    """L2 share (MB) for the matrices of all concurrent resident greedies."""
    return _env_float(RESIDENT_L2_MB_ENV, _RESIDENT_L2_MB_DEFAULT)


def fused_cache_dtype() -> str:
    """Cache storage dtype preference: 'auto' | 'f32' | 'bf16' | 'int8'."""
    v = os.environ.get(FUSED_CACHE_DTYPE_ENV, "auto").lower()
    return v if v in ("auto", "f32", "bf16", "int8") else "auto"


def stream_batch() -> int:
    """Default arrival batch size B of the streaming coreset selection."""
    return max(1, _env_int(STREAM_BATCH_ENV, _STREAM_BATCH_DEFAULT))


def serve_batch() -> int:
    """Admission cap: queries stacked into one resident dispatch."""
    return max(1, _env_int(SERVE_BATCH_ENV, _SERVE_BATCH_DEFAULT))


def serve_queue() -> int:
    """Bound of the serving engine's request queue."""
    return max(1, _env_int(SERVE_QUEUE_ENV, _SERVE_QUEUE_DEFAULT))


def serve_mem_mb() -> float:
    """On-chip memory (MB) one admitted batch's stacked working sets may
    take (see the module docstring for the default's derivation)."""
    return _env_float(SERVE_MEM_MB_ENV, _SERVE_MEM_MB_DEFAULT)


def autotune_cache_path() -> Optional[str]:
    """Path of the measured-plan cache (launch/autotune.py), or None when
    the lookup is off (the default)."""
    v = os.environ.get(AUTOTUNE_CACHE_ENV, "")
    if v.strip().lower() in ("", "0", "off", "none", "disabled"):
        return None
    return v
