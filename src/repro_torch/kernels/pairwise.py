"""Batched pairwise matrix: CUDA kernel, wrapper and plain version
(answers `src/repro/kernels/pairwise.py:pairwise_pallas`).

(B, N, D) ground × (B, C, D) candidates → (B, N, C) f32, 'dot' ⟨g, c⟩
or 'dist' √max(‖g‖²+‖c‖²−2⟨g,c⟩, 0). One launch serves every greedy of
a level. The kernel is csrc/pairwise.cu (fp32 FMA tiles, no TF32, norms
computed in the kernel, ragged edges masked). The gains kernel of the
same reference file (`gains_pallas`) is not ported yet.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, counters
from repro_torch.kernels import rules as R

F32 = torch.float32
MODES = {"dot": 0, "dist": 1}

COUNTER = counters.counter("pairwise")


def pairwise_plain(ground, cands, mode: str):
    """The plain PyTorch version (the rules' expansion via torch.matmul);
    the CPU path, and the kernel's yardstick of correctness on the card."""
    return R.pairwise_block(ground.to(F32), cands.to(F32), mode)


def _lib():
    lib = build.load("pairwise")
    fn = lib.rt_pairwise
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    return lib


def pairwise(ground, cands, mode: str):
    """ground (B, N, D), cands (B, C, D) → (B, N, C) f32. CPU tensors take
    the plain version; CUDA tensors launch the kernel (f32, contiguous)
    or raise."""
    if mode not in MODES:
        raise ValueError(f"unknown pairwise mode {mode!r}")
    COUNTER.calls += 1
    if not ground.is_cuda:
        return pairwise_plain(ground, cands, mode)
    if ground.dim() != 3 or cands.dim() != 3:
        raise ValueError("pairwise kernel takes (B, N, D) and (B, C, D)")
    b, n, d = ground.shape
    if cands.shape[0] != b or cands.shape[2] != d:
        raise ValueError(f"shape mismatch {tuple(ground.shape)} vs "
                         f"{tuple(cands.shape)}")
    if cands.device != ground.device:
        raise ValueError("ground and cands lie on different devices")
    if ground.dtype != F32 or cands.dtype != F32:
        raise NotImplementedError("the pairwise kernel takes f32 features")
    if not (ground.is_contiguous() and cands.is_contiguous()):
        raise ValueError("the pairwise kernel takes contiguous tensors")
    c = cands.shape[1]
    if max(b, n, c, d) >= 2 ** 31:
        raise ValueError("pairwise extents must fit int32")
    out = torch.empty((b, n, c), dtype=F32, device=ground.device)
    if b * n * c == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(ground.device).cuda_stream
    err = lib.rt_pairwise(ground.data_ptr(), cands.data_ptr(),
                          out.data_ptr(), b, n, c, d, MODES[mode], stream)
    build.check(lib, err, "pairwise kernel")
    COUNTER.launches += 1
    return out
