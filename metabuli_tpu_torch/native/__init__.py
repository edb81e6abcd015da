"""Native (C++) host library, built with g++ at first use.

The sources live here, byte-identical copies of the reference package's
``metabuli_tpu/native/*.cpp`` that the port calls (the taxonomer finish,
tantan masking, FASTX parsing, key sorts), built with the reference
package's flags into this package's git-ignored build directory; nothing
is written next to the sources. A failed build raises: the port has no
pure-Python fallback for the taxonomer finish.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

_LOCK = threading.Lock()
_LIB = None

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "_build")
SRCS = [os.path.join(SRC_DIR, name) for name in
        ("taxonomer.cpp", "masker.cpp", "fastx.cpp", "sortkeys.cpp")]
_SO = os.path.join(BUILD_DIR, "libmetabuli_native.so")


def _build() -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # one builder at a time across processes (pytest-xdist workers)
    with open(_SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        newest = max(os.path.getmtime(src) for src in SRCS)
        if os.path.exists(_SO) and os.path.getmtime(_SO) >= newest:
            return _SO
        tmp = f"{_SO}.{os.getpid()}.tmp"
        # the reference package's flags; -ffp-contract=off keeps the
        # taxonomer's float arithmetic uncontracted, as it is built there
        cmd = [
            "g++", "-O3", "-march=native", "-ffp-contract=off", "-fopenmp",
            "-shared", "-fPIC", "-std=c++17", *SRCS, "-o", tmp, "-lz",
        ]
        res = subprocess.run(cmd, capture_output=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(
                "native host library build failed:\n"
                + res.stderr.decode(errors="replace")[-4000:])
        os.replace(tmp, _SO)
        return _SO


def get_lib():
    """Load the native library, building it first if needed (raises on a
    failed build)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_build())
            lib.taxonomer_assign.restype = ctypes.c_int64
            lib.taxonomer_finish.restype = ctypes.c_int64
            _LIB = lib
        return _LIB
