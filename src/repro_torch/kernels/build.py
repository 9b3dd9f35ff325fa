"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all started together, and the objects are linked into one
shared library with a plain C interface — no PyTorch headers, so a build
takes seconds instead of minutes — and loaded with ``ctypes``. The
library lands in ``_build/`` next to this file (listed in ``.gitignore``)
under a name carrying the hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads what is already there.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine without ``nvcc``.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes of every C entry point the library exports
SIGNATURES = {
    # hx, z, log_l, log_var, w, u, c, mean, fvar, P, S, Q, m, d, device, stream
    "psvgp_posterior_predict": [_P] * 9 + [_I] * 6 + [_P],
    # x, z, log_l, log_var, w, knm, lk_t, q_diag, P, B, m, d, device, stream
    "psvgp_svgp_projection": [_P] * 8 + [_I] * 5 + [_P],
    # x, z, log_l, log_var, knm, P, B, m, d, device, stream
    "psvgp_rbf_cross_cov": [_P] * 5 + [_I] * 5 + [_P],
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


def bind(lib: Path) -> ctypes.CDLL:
    """Load a built library and declare every C entry's signature."""
    handle = ctypes.CDLL(str(lib))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(build())
        return _lib
