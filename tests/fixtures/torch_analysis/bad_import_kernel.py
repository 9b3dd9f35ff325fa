"""RR001 fixture: the CUDA kernels built and loaded when the module is
imported (``kernels/build.py`` builds "at first use ... never at
import")."""
import ctypes

from repro_torch.kernels import build

LIB = build.library()  # <- a violation: nvcc at import
HANDLE = ctypes.CDLL("libpsvgp_kernels.so")  # <- a violation


def launch(*args):
    return LIB.psvgp_svgp_projection(*args)
