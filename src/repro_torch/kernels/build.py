"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
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


def build() -> Path:
    """Compile the sources unless a library with their hash exists; return it."""
    global build_log
    lib = BUILD_DIR / f"libreprotorch_{source_hash()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
        done = subprocess.run(cmd, capture_output=True, text=True, check=False)
        build_log = done.stdout + done.stderr
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed ({done.returncode}):\n{build_log}")
        os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
