"""The two kernels of `src/repro/kernels/pairwise.py`: CUDA kernels,
wrappers and plain versions. One launch serves every greedy of a level.

  pairwise  (answers `pairwise_pallas`) (B, N, D) ground × (B, C, D)
            candidates → (B, N, C) f32 or bf16, 'dot' ⟨g, c⟩ or 'dist'
            √max(‖g‖²+‖c‖²−2⟨g,c⟩, 0): csrc/pairwise.cu (128×128 fp32
            FMA tiles, no TF32; for 'dist' a float64 norm pass first,
            into a scratch the wrapper allocates; ragged edges masked;
            entries equal to the resident build's bit for bit; the bf16
            output rounds each f32 entry to nearest even, counted as
            `pairwise[bf16]`).
  gains     (answers `gains_pallas`) the step engine's uncached gains:
            Σ_n part(row_n, M_nc) per candidate, (B, C) f32, −inf at
            invalid candidates: csrc/gains.cu for the feature rules
            (64-row tiles of the candidate width, 64 or 80, that pads C
            least, 8 × (4 + E) accumulators a thread, no TF32; the sum
            over rows in float64, in the 64×64 tile's grouping, so
            equal to that tile's build bit for bit: `reference=True`
            runs it). For 'dist' the ground's float64 norms come from
            `ground_norms` — once per greedy, passed as ``gnorm=`` (the
            step engine keeps them in its state), else computed per call
            — and the candidates' from the same pass per call. Over int8
            ground rows with (B, 1, N) f32 row scales (`gscale=`,
            answers `_gains_kernel_quant`) the same kernel widens each
            entry as it stages it, counted as `gains[int8]`; for the
            bitmap rule (cands (B, C, W) and row (B, W) 32-bit words)
            csrc/gains.cu:rt_gains_bits, exact integer popcount sums,
            counted as `gains[coverage]`. The norms pass counts as
            `gains_norms`, a helper with no TPU kernel behind it.

Also the storage helpers the cached-matrix kernels share: a feature
rule's cache is f32, bf16 or int8 with (B, 1, N) f32 row scales
(`STORAGES`, the codes of csrc/rules.cuh), and each storage has a
launch counter of its own (`storage_counters`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, counters, ref
from repro_torch.kernels import rules as R

F32 = torch.float32
BF16 = torch.bfloat16
INT8 = torch.int8
MODES = {"dot": 0, "dist": 1}
# cache storage → the kernels' storage code (RT_STORE_* in rules.cuh)
STORAGES = {F32: 0, BF16: 1, INT8: 2}
DTYPES = {"float32": F32, "bfloat16": BF16, "int8": INT8}
_SUFFIX = {F32: "", BF16: "[bf16]", INT8: "[int8]"}


def storage_counters(name: str) -> dict:
    """{storage dtype: launch counter}: `name` for f32, `name[bf16]`,
    `name[int8]`, so a run shows which variant of a kernel ran."""
    return {dt: counters.counter(name + sfx) for dt, sfx in _SUFFIX.items()}


COUNTERS = {F32: counters.counter("pairwise"),
            BF16: counters.counter("pairwise[bf16]")}
GAINS_COUNTERS = {F32: counters.counter("gains"),
                  INT8: counters.counter("gains[int8]")}
GAINS_BITS_COUNTER = counters.counter("gains[coverage]")
NORMS_COUNTER = counters.counter("gains_norms")
FOLDS = {"min": 0, "max": 1, "satsum": 2, "sum": 3}
# a bitmap gain is at most 32·W; f32 holds every integer up to 2²⁴
MAX_EXACT_WORDS = 2 ** 24 // 32


def check_feature_rule(rule: R.KernelRule, what: str) -> None:
    """Raise NotImplementedError for a fold the feature-rule CUDA kernels
    do not know."""
    if rule.fold not in FOLDS:
        raise NotImplementedError(
            f"{what}: the {rule.name!r} rule has no CUDA path yet")


def check_words(w: int, what: str) -> None:
    """Raise ValueError where a bitmap gain (≤ 32·W) would no longer be
    an exact f32. (A row too wide for one block's shared memory makes
    the launch itself fail, which the wrapper raises.)"""
    if w > MAX_EXACT_WORDS:
        raise ValueError(f"{what}: {w} words per bitmap exceed the "
                         f"{MAX_EXACT_WORDS} whose gains f32 holds exactly")


def check_operand(t, shape, dtype, name: str, device) -> None:
    """Raise ValueError unless a kernel operand has the shape, dtype and
    device given and is contiguous."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, not {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_storage(mat, scale, shape, what: str, device) -> int:
    """Check a cached (B, N, C) matrix operand in its storage, and the
    (B, 1, N) f32 row scales an int8 one needs (and no other may have);
    returns the storage code."""
    if mat.dtype not in STORAGES:
        raise NotImplementedError(f"{what}: the CUDA path takes f32, bf16 "
                                  f"or int8 storage, not {mat.dtype}")
    check_operand(mat, shape, mat.dtype, "mat", device)
    if mat.dtype == INT8:
        if scale is None:
            raise ValueError(f"{what}: an int8 cache needs its row scales")
        check_operand(scale, (shape[0], 1, shape[1]), F32, "scale", device)
    elif scale is not None:
        raise ValueError(f"{what}: row scales beside a {mat.dtype} cache")
    return STORAGES[mat.dtype]


def pairwise_plain(ground, cands, mode: str):
    """The plain PyTorch version (the rules' expansion via torch.matmul);
    the CPU path, and the kernel's yardstick of correctness on the card."""
    return R.pairwise_block(ground.to(F32), cands.to(F32), mode)


def _lib():
    lib = build.load("pairwise")
    fn = lib.rt_pairwise
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    return lib


def _bnc(ground, cands):
    """(B, N, C, D) of a (…, N, D) ground against (…, C, D) candidates."""
    n, d = ground.shape[-2:]
    c = cands.shape[-2]
    return ground.numel() // max(1, n * d), n, c, d


def pairwise_cost(ground, cands, mode: str, out_dtype=F32):
    """(flops, bytes) of one pairwise call: the products, and for 'dist'
    both sides' norms and the combination; the operands read once, the
    matrix written once."""
    b, n, c, d = _bnc(ground, cands)
    flops = 2.0 * b * n * c * d
    if mode == "dist":
        flops += 2.0 * b * (n + c) * d + 4.0 * b * n * c
    return flops, (counters.nbytes(ground, cands)
                   + out_dtype.itemsize * b * n * c)


@counters.wrapper
def pairwise(ground, cands, mode: str, out_dtype=F32):
    """ground (B, N, D), cands (B, C, D) → (B, N, C) in `out_dtype` (f32,
    or bf16: each f32 entry rounded to nearest even). CPU tensors take
    the plain version; CUDA tensors launch the kernel (f32 features,
    contiguous) or raise."""
    if mode not in MODES:
        raise ValueError(f"unknown pairwise mode {mode!r}")
    if out_dtype not in (F32, BF16):
        raise ValueError(f"pairwise stores f32 or bf16, not {out_dtype}")
    counter = COUNTERS[out_dtype]
    counter.declare(*pairwise_cost(ground, cands, mode, out_dtype))
    if not ground.is_cuda:
        return pairwise_plain(ground, cands, mode).to(out_dtype)
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
    out = torch.empty((b, n, c), dtype=out_dtype, device=ground.device)
    if b * n * c == 0:
        return out
    # 'dist': the rows' f32 squared norms, ground's then the candidates'
    norms = (torch.empty(b * (n + c), dtype=F32, device=ground.device)
             if mode == "dist" else None)
    lib = _lib()
    stream = torch.cuda.current_stream(ground.device).cuda_stream
    err = lib.rt_pairwise(ground.data_ptr(), cands.data_ptr(),
                          out.data_ptr(),
                          None if norms is None else norms.data_ptr(), b, n,
                          c, d, MODES[mode], STORAGES[out_dtype], stream)
    build.check(lib, err, "pairwise kernel")
    counter.launches += 1
    return out


def gains_plain(ground, row, cands, cand_valid, rule: R.KernelRule,
                gscale=None):
    """The plain PyTorch version (kernels/ref.py:gains): raw part sums
    (B, C), −inf at invalid candidates; an int8 ground (with `gscale`)
    dequantized first (rules.dequant)."""
    if gscale is not None:
        ground = R.dequant(ground, gscale)
    return ref.gains(ground, row, cands, cand_valid, rule)


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _gains_lib():
    lib = build.load("gains")
    lib.rt_gains.restype = _I
    lib.rt_gains.argtypes = [_P] * 9 + [_I] * 7 + [ctypes.c_float] * 3 + [
        _I, _P]
    lib.rt_gains_norms.restype = _I
    lib.rt_gains_norms.argtypes = [_P] * 3 + [ctypes.c_longlong, _I, _I, _P]
    lib.rt_gains_bits.restype = _I
    lib.rt_gains_bits.argtypes = [_P] * 3 + [_I] * 3 + [_P]
    return lib


def _check_ground(ground, gscale, b, n, d, dev):
    if gscale is None:
        check_operand(ground, (b, n, d), F32, "ground", dev)
    else:
        check_operand(ground, (b, n, d), INT8, "ground", dev)
        check_operand(gscale, (b, 1, n), F32, "gscale", dev)


@counters.wrapper
def ground_norms(ground, gscale=None):
    """(B, N) f32 squared norms of the ground rows ((B, N, D) f32, or
    int8 with its (B, 1, N) row scales: the dequantized rows), each one
    float64 fma(v, v, ·) chain in ascending feature order cast once to
    f32, as the gains kernel reads them for 'dist'. A ground's rows do
    not change over a greedy, so the step engine takes them once. On the
    card one launch, counted as `gains_norms`; CPU tensors get the plain
    float64 sum (the plain gains need no norms)."""
    rows = ground.numel() // max(1, ground.shape[-1])
    NORMS_COUNTER.declare(2.0 * ground.numel(),
                          counters.nbytes(ground, gscale) + 4.0 * rows)
    if not ground.is_cuda:
        g = R.dequant(ground, gscale) if gscale is not None else ground
        return g.double().square().sum(-1).to(F32)
    if ground.dim() != 3:
        raise ValueError("ground_norms takes (B, N, D) ground rows")
    b, n, d = ground.shape
    dev = ground.device
    _check_ground(ground, gscale, b, n, d, dev)
    out = torch.empty((b, n), dtype=F32, device=dev)
    if b * n == 0:
        return out
    lib = _gains_lib()
    err = lib.rt_gains_norms(ground.data_ptr(),
                             None if gscale is None else gscale.data_ptr(),
                             out.data_ptr(), b * n, d,
                             STORAGES[ground.dtype],
                             torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "gains ground norms")
    NORMS_COUNTER.launches += 1
    return out


def gains_cost(ground, row, cands, cand_valid, rule: R.KernelRule,
               gscale=None):
    """(flops, bytes) of one feature gains call: the products, the gain
    parts and folds (4 an entry), for 'dist' the candidates' norms; the
    ground, its scales and norms, the row, the candidates and their
    validity read once, the sums written once."""
    b, n, c, d = _bnc(ground, cands)
    dist = rule.pairwise == "dist"
    flops = 2.0 * b * n * c * d + 4.0 * b * n * c + (
        2.0 * b * c * d if dist else 0.0)
    return flops, (counters.nbytes(ground, gscale, row, cands, cand_valid)
                   + 4.0 * b * c + (4.0 * b * n if dist else 0.0))


@counters.wrapper
def gains(ground, row, cands, cand_valid, rule: R.KernelRule,
          gscale=None, gnorm=None, reference: bool = False):
    """ground (B, N, D), row (B, N), cands (B, C, D), cand_valid (B, C)
    → raw gain sums (B, C) f32, −inf at invalid candidates. With
    ``gscale`` (B, 1, N) f32 the ground is int8 per-row-quantized
    storage (rules.quantize_rows). ``gnorm`` (B, N): the stored ground's
    `ground_norms`, for a 'dist' rule (computed here when not given; the
    plain version needs none). CPU tensors take the plain version; CUDA
    tensors launch the kernel (feature rules, f32 candidates,
    contiguous) or raise. ``reference`` runs the 64×64-tile build the
    kernel equals bit for bit instead (a test's yardstick, not
    counted)."""
    if rule.is_bitmap:
        return _gains_bits(row, cands, cand_valid, rule)
    counter = GAINS_COUNTERS[INT8 if gscale is not None else F32]
    if not reference:
        counter.declare(*gains_cost(ground, row, cands, cand_valid, rule,
                                    gscale))
    if not cands.is_cuda:
        return gains_plain(ground, row, cands, cand_valid, rule, gscale)
    check_feature_rule(rule, "gains")
    if ground.dim() != 3 or cands.dim() != 3:
        raise ValueError("gains kernel takes (B, N, D) and (B, C, D)")
    b, n, d = ground.shape
    c = cands.shape[1]
    dev = cands.device
    _check_ground(ground, gscale, b, n, d, dev)
    check_operand(cands, (b, c, d), F32, "cands", dev)
    check_operand(row, (b, n), F32, "row", dev)
    if tuple(cand_valid.shape) != (b, c):
        raise ValueError(f"cand_valid: shape {tuple(cand_valid.shape)}, "
                         f"expected {(b, c)}")
    if max(b, n, c, d) >= 2 ** 31:
        raise ValueError("gains extents must fit int32")
    dist = rule.pairwise == "dist" and not reference
    if not dist:
        gnorm = None
    elif gnorm is None:
        gnorm = ground_norms(ground, gscale)
    else:
        check_operand(gnorm, (b, n), F32, "gnorm", dev)
    raw = torch.zeros((b, c), dtype=F32, device=dev)
    if b * n * c > 0:
        partials = torch.empty((b, -(-n // 64), c), dtype=torch.float64,
                               device=dev)
        cnorm = torch.empty((b, c), dtype=F32, device=dev) if dist else None
        arrivals = build.arrivals(dev, b * -(-c // 64))
        lib = _gains_lib()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rt_gains(ground.data_ptr(),
                           None if gscale is None else gscale.data_ptr(),
                           None if gnorm is None else gnorm.data_ptr(),
                           row.data_ptr(), cands.data_ptr(),
                           None if cnorm is None else cnorm.data_ptr(),
                           partials.data_ptr(), arrivals.data_ptr(),
                           raw.data_ptr(), b, n, c, d, MODES[rule.pairwise],
                           STORAGES[ground.dtype], FOLDS[rule.fold],
                           rule.cap, rule.lam, 1.0 - rule.lam,
                           int(reference), stream)
        build.check(lib, err, counter.name + " kernel")
        if not reference:
            counter.launches += 1
    return torch.where(cand_valid, raw, torch.full_like(raw, float("-inf")))


def steps_cost(mat, scale, row, mask, out, steps: int = 1):
    """(flops, bytes) of `steps` greedy steps over a (…, N, C) cached
    matrix: a gain part, a fold and a sum an entry a step; the matrix
    (its row scales), the row and the mask read once, ``out`` bytes
    written."""
    n, c = mat.shape[-2:]
    b = mat.numel() // max(1, n * c)
    return (3.0 * steps * b * n * c,
            counters.nbytes(mat, scale, row, mask) + out)


def bits_cost(cands, row, mask, out, steps: int = 1):
    """(flops, bytes) of `steps` bitmap greedy steps over (…, C, W)
    candidate words: an and-not, a popcount and an add a word a step; the
    words, the row and the mask read once, ``out`` bytes written."""
    c, w = cands.shape[-2:]
    b = cands.numel() // max(1, c * w)
    return (3.0 * steps * b * c * w,
            counters.nbytes(cands, row, mask) + out)


@counters.wrapper
def _gains_bits(row, cands, cand_valid, rule: R.KernelRule):
    """The bitmap rule's gains: cands (B, C, W) and row (B, W) int32
    words → raw popcount sums (B, C) f32, −inf at invalid candidates; the
    ground is not read. CPU tensors take the plain version."""
    GAINS_BITS_COUNTER.declare(*bits_cost(
        cands, row, cand_valid, 4.0 * cand_valid.numel()))
    if not cands.is_cuda:
        return gains_plain(None, row, cands, cand_valid, rule)
    if cands.dim() != 3:
        raise ValueError("bitmap gains kernel takes (B, C, W) words")
    b, c, w = cands.shape
    dev = cands.device
    check_operand(cands, (b, c, w), R.WORD_DTYPE, "cands", dev)
    check_operand(row, (b, w), R.WORD_DTYPE, "row", dev)
    if tuple(cand_valid.shape) != (b, c):
        raise ValueError(f"cand_valid: shape {tuple(cand_valid.shape)}, "
                         f"expected {(b, c)}")
    check_words(w, "gains")
    raw = torch.zeros((b, c), dtype=F32, device=dev)
    if b * c > 0:
        lib = _gains_lib()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rt_gains_bits(cands.data_ptr(), row.data_ptr(),
                                raw.data_ptr(), b, c, w, stream)
        build.check(lib, err, "bitmap gains kernel")
        GAINS_BITS_COUNTER.launches += 1
    return torch.where(cand_valid, raw, torch.full_like(raw, float("-inf")))
