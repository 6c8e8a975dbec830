"""The native OpenKE sampler: build and ctypes binding (port of
mre_tpu/openke/native/__init__.py).

``csrc/sampler.cpp`` is a byte-for-byte copy of the JAX package's source,
so a seed and a thread count give the same batches from either library.
It is compiled by g++ on first use, never at import, into ``_build/``
(``utils/build.py``: one process builds while concurrent first users wait,
and the file is renamed into place, so none loads a half-written file). The library keeps its state per
loaded copy: this one and the JAX package's are separate files, loaded
with RTLD_LOCAL, and share nothing.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

from mre_tpu_torch.utils.build import build_once

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "sampler.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
SO = os.path.join(BUILD_DIR, "sampler.so")


def build(force: bool = False) -> str:
    """Compile ``sampler.so`` if it is missing or older than its source;
    raises ``subprocess.CalledProcessError`` (with g++'s output) on failure.
    Safe under concurrent first use (``utils/build.py``)."""
    def compile_to(tmp) -> None:
        cmd = ["g++", "-O2", "-std=c++17", "-fPIC", "-shared", SRC, "-o", str(tmp), "-pthread"]
        subprocess.run(cmd, check=True, capture_output=True, text=True)

    def stale(so) -> bool:
        return force or os.path.getmtime(so) < os.path.getmtime(SRC)

    return str(build_once(SO, compile_to, stale))


def load() -> ctypes.CDLL:
    """The built library with every function's argument and result types
    declared (the JAX package's signatures)."""
    lib = ctypes.CDLL(build(), mode=os.RTLD_LOCAL)
    lib.setInPath.argtypes = [ctypes.c_char_p]
    lib.setWorkThreads.argtypes = [ctypes.c_int64]
    lib.setBern.argtypes = [ctypes.c_int64]
    lib.setSeed.argtypes = [ctypes.c_int64]
    lib.sampling.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [ctypes.c_bool] * 3
    lib.getHeadBatch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64]
    lib.getTailBatch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64]
    lib.testHead.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_bool]
    lib.testTail.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_bool]
    lib.test_link_prediction.argtypes = [ctypes.c_bool]
    for name in ("getTestLinkMRR", "getTestLinkMR", "getTestLinkHit10",
                 "getTestLinkHit3", "getTestLinkHit1"):
        getattr(lib, name).argtypes = [ctypes.c_int64]
        getattr(lib, name).restype = ctypes.c_float
    for name in ("getTestLinkMRRRaw", "getTestLinkMRRaw", "getTestLinkHit10Raw"):
        getattr(lib, name).restype = ctypes.c_float
    for name in ("getEntityTotal", "getRelationTotal", "getTrainTotal",
                 "getTestTotal", "getValidTotal", "getTripleTotal"):
        getattr(lib, name).restype = ctypes.c_int64
    lib.importProb.argtypes = [ctypes.c_float]
    lib.corruptRel.argtypes = [ctypes.c_int64] * 3 + [ctypes.c_bool] * 2
    lib.corruptRel.restype = ctypes.c_int64
    lib.corruptTypeTail.argtypes = [ctypes.c_int64] * 2
    lib.corruptTypeTail.restype = ctypes.c_int64
    lib.hasProb.restype = ctypes.c_int64
    lib.hasTypes.restype = ctypes.c_int64
    return lib
