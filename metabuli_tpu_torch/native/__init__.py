"""Native (C++) host library, built with g++ at first use.

The sources live here, byte-identical copies of the reference package's
``metabuli_tpu/native/*.cpp`` that the port calls (the taxonomer finish,
tantan masking, gene prediction with the Prodigal port, FASTX parsing,
key sorts), and the port's own batch reader and line writer
(``batch_reader.cpp``, ``line_writer.cpp``), built with the reference
package's flags into this package's
git-ignored build directory; nothing is written next to the sources. A
failed build raises: the port has no pure-Python fallback for the
taxonomer finish or the gene predictor.

``METABULI_TPU_SANITIZE=address[,undefined]`` builds an ASan/UBSan
variant instead, a library of its own (``libmetabuli_native.so.asan.so``)
beside the normal one, which it leaves as it is. A process loads it only
under ``LD_PRELOAD=$(g++ -print-file-name=libasan.so)``; the sanitizer
pass over these sources (``sancheck.cpp``,
``tests/test_torch_native_sanitize.py``) replays a classification's
argument buffers in a sanitized executable instead.
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
        ("taxonomer.cpp", "masker.cpp", "genepred.cpp", "prodigal.cpp",
         "fastx.cpp", "sortkeys.cpp", "batch_reader.cpp",
         "line_writer.cpp")]
_SO = os.path.join(BUILD_DIR, "libmetabuli_native.so")
SANITIZE_ENV = "METABULI_TPU_SANITIZE"


def build() -> str:
    """Compile the library if a source is newer than it (raises on a
    failed build); returns its path: the normal library, or its sanitized
    variant when METABULI_TPU_SANITIZE is set."""
    sanitize = os.environ.get(SANITIZE_ENV, "")
    so = _SO + (".asan.so" if sanitize else "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    # one build of each library at a time across processes (pytest-xdist
    # workers)
    with open(so + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        newest = max(os.path.getmtime(src) for src in SRCS)
        if os.path.exists(so) and os.path.getmtime(so) >= newest:
            return so
        tmp = f"{so}.{os.getpid()}.tmp"
        # the reference package's flags; -ffp-contract=off keeps the
        # taxonomer's and the Prodigal port's float arithmetic
        # uncontracted, as it is built there
        cmd = [
            "g++", "-O3", "-march=native", "-ffp-contract=off", "-fopenmp",
            "-shared", "-fPIC", "-std=c++17", *SRCS, "-o", tmp, "-lz",
        ]
        if sanitize:
            cmd[1:1] = [f"-fsanitize={sanitize}", "-fno-omit-frame-pointer",
                        "-g"]
        res = subprocess.run(cmd, capture_output=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(
                "native host library build failed:\n"
                + res.stderr.decode(errors="replace")[-4000:])
        os.replace(tmp, so)
        return so


def _declare_batch_reader(lib) -> None:
    """The C interface of ``batch_reader.cpp`` (``io/batch_reader.py``)."""
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.br_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32,
                            ctypes.c_int32, i64]
    lib.br_open.restype = ptr
    lib.br_close.argtypes = [ptr]
    lib.br_close.restype = None
    lib.br_read.argtypes = [ptr, i64, i64, ptr, ptr, i64]
    lib.br_read.restype = i64
    lib.br_fill.argtypes = [ptr, ptr, ctypes.c_uint8, *[i64] * 6, *[ptr] * 9]
    lib.br_fill.restype = i64


def _declare_line_writer(lib) -> None:
    """The C interface of ``line_writer.cpp`` (``io/line_writer.py``)."""
    i32, i64, ptr = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
    lib.write_lines.argtypes = [i64, *[ptr] * 6, i64, *[ptr] * 3, i32,
                                *[ptr] * 7, i32, i64, ptr, i64]
    lib.write_lines.restype = i64


def get_lib():
    """Load the native library, building it first if needed (raises on a
    failed build)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            lib.taxonomer_assign.restype = ctypes.c_int64
            lib.taxonomer_finish.restype = ctypes.c_int64
            _declare_batch_reader(lib)
            _declare_line_writer(lib)
            _LIB = lib
        return _LIB
