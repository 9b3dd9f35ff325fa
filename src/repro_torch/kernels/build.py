"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all started together, and the objects are linked into one
shared library with a plain C interface — no PyTorch headers, so a build
takes seconds instead of minutes — and loaded with ``ctypes``. The
library lands in ``_build/`` next to this file (listed in ``.gitignore``)
under a name carrying the hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads what is already there.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine without ``nvcc``. The argument checks that every
wrapper shares (``check_tensor``, ``device_index``, ``counter_arg``) live
here too, beside ``library()``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# name -> argtypes of every C entry point the library exports
SIGNATURES = {
    # hx, z, log_l, log_var, w, u, c, mean, fvar, P, S, Q, m, d, device, stream
    "psvgp_posterior_predict": [_P] * 9 + [_I] * 6 + [_P],
    # x, z, log_l, log_var, w, knm, lk_t, q_diag, P, B, m, d, device, stream
    "psvgp_svgp_projection": [_P] * 8 + [_I] * 5 + [_P],
    # x, z, log_l, log_var, knm, P, B, m, d, device, stream
    "psvgp_rbf_cross_cov": [_P] * 5 + [_I] * 5 + [_P],
    # ptrs, sizes, leaves, b1, 1 - b1, b2, 1 - b2, lr, eps, step_in, step_out, step_host,
    # device, stream
    "psvgp_adam_update": [_P, _P, _I] + [_F] * 6 + [_P, _P, _L, _I, _P],
    # probs, tbl, mask, kprime, idx, keys, step_in, step_host, stream_key, P, n_max, B,
    # device, stream
    "psvgp_minibatch_draws": [_P] * 7 + [_L, _L] + [_I] * 4 + [_P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output (ptxas register/shared-memory report) of the last build


def sources() -> list[Path]:
    """The translation units, one nvcc each."""
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    """What the sources include from ``csrc/``."""
    return sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sources(), *headers()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return path


def compile_shared(srcs: list[Path], lib: Path) -> str:
    """Compile ``srcs`` with one ``nvcc`` each, all started together, and
    link them into the shared library ``lib``; return nvcc's output. Raises
    if any step fails."""
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in srcs]
        jobs = [
            subprocess.Popen([nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objs, strict=True)
        ]
        log = "".join(job.communicate()[0] for job in jobs)
        failed = [job.returncode for job in jobs if job.returncode != 0]
        if not failed:
            so = os.path.join(tmp, "lib.so")
            done = subprocess.run([nvcc(), "-shared", "-o", so, *objs],
                                  capture_output=True, text=True, check=False)
            log += done.stdout + done.stderr
            failed = [done.returncode] if done.returncode != 0 else []
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
        os.replace(so, lib)  # atomic: concurrent builders never see a partial file
    return log


def build() -> Path:
    """Compile the sources unless a library with their hash exists; return it."""
    global build_log
    lib = BUILD_DIR / f"libreprotorch_{source_hash()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    build_log = compile_shared(sources(), lib)
    return lib


def bind(lib: Path, names=tuple(SIGNATURES)) -> ctypes.CDLL:
    """Load a built library and declare the signature of each C entry in
    ``names`` (every entry unless told otherwise); an entry the library
    lacks raises here."""
    handle = ctypes.CDLL(str(lib))
    for name in names:
        fn = getattr(handle, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
    return handle


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(build())
        return _lib


def check_tensor(name: str, t: torch.Tensor, shape: tuple, device: torch.device,
                 dtype: torch.dtype = torch.float32) -> None:
    """Refuse what a kernel does not take: a non-tensor, another device,
    another dtype than ``dtype``, another shape, a non-contiguous layout."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {str(dtype).removeprefix('torch.')}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def device_index(device: torch.device) -> int:
    """The CUDA ordinal of ``device`` (the current device for bare "cuda")."""
    return device.index if device.index is not None else torch.cuda.current_device()


def counter_arg(name: str, c, device: torch.device, out: bool) -> tuple[int, int]:
    """(device pointer or 0, host value) of a step counter: an int64 ()
    tensor on ``device`` or, for an input, a host int (an output may be
    None: nothing is written)."""
    if isinstance(c, torch.Tensor):
        if c.device != device or c.dtype != torch.int64 or c.dim() != 0:
            raise ValueError(f"{name} must be an int64 () tensor on {device}, got {c.dtype} "
                             f"{tuple(c.shape)} on {c.device}")
        return c.data_ptr(), 0
    if out and c is None:
        return 0, 0
    if out or isinstance(c, bool) or not isinstance(c, int):
        raise TypeError(f"{name} must be an int64 () tensor{'' if out else ' or an int'}, "
                        f"got {type(c).__name__}")
    return 0, c
