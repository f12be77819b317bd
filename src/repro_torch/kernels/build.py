"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source compiles with nvcc into its own shared library with a plain
C interface, loaded through ctypes (no PyTorch headers, so a build takes
seconds, not minutes). All sources compile in parallel, one nvcc each,
started together. The libraries land in ``<repo>/build/repro_torch/<key>/``,
where the key hashes the sources and the flags, so an edited source is
rebuilt and an unchanged one is reused. A library is written under a
temporary name and renamed into place, so concurrent processes never
load a half-written file. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("pairwise", "greedy_loop", "greedy_loop_resident", "fused_step",
           "gains", "stream_filter")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_ARRIVALS: Dict[torch.device, torch.Tensor] = {}
BUILD_SECONDS: Optional[float] = None     # wall time of this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card")


def build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / build_key()


def _build_all(out: Path) -> None:
    """Compile every missing library, one nvcc per source in parallel;
    the ptxas report (registers, shared memory, spills) goes to
    <name>.log beside each library."""
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in SOURCES:
        lib = out / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
        log = open(out / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, lib, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, lib, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        logs = "\n".join((out / f"{n}.log").read_text()[-4000:]
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building all on first use."""
    global BUILD_SECONDS
    with _LOCK:
        if name not in _LIBS:
            out = build_dir()
            if not all((out / f"lib{s}.so").exists() for s in SOURCES):
                t0 = time.perf_counter()
                _build_all(out)
                BUILD_SECONDS = time.perf_counter() - t0
            for s in SOURCES:
                _LIBS[s] = ctypes.CDLL(str(out / f"lib{s}.so"))
        return _LIBS[name]


def ptxas_report(name: str) -> str:
    """The compiler's resource report of one source, when this build
    compiled it."""
    log = build_dir() / f"{name}.log"
    return log.read_text() if log.exists() else ""


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        lib.rt_error_string.restype = ctypes.c_char_p
        lib.rt_error_string.argtypes = [ctypes.c_int]
        msg = lib.rt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def arrivals(device: torch.device, n: int) -> torch.Tensor:
    """n int32 arrival counters on `device` for the kernels' last-block-done
    reductions (fused_step.cu, gains.cu). Zero when handed out: each
    kernel's last block resets the counters it used, so one buffer per
    device serves every launch on the stream in turn."""
    buf = _ARRIVALS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _ARRIVALS[device] = buf
    return buf[:n]
