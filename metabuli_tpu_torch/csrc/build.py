"""Build and load the Hopper kernels: ``csrc/*.cu`` -> ``libmetabuli_cuda.so``.

nvcc compiles every CUDA source of this directory, one process per source
started together, and links them into ONE shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds). The build runs at first use into the package's git-ignored
``_build/`` directory and again whenever a source is newer than the
library. ``-fmad=false`` keeps every float32 product and sum a
separate IEEE operation: the chain and combine scores are compared bitwise
with the reference package's.

Each kernel wrapper counts its launches in ``launches`` (a plain dict of
ints): a run can then show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import os
import shutil
import subprocess
import threading

CSRC = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
SO = os.path.join(BUILD_DIR, "libmetabuli_cuda.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-fmad=false", "-Xcompiler", "-fPIC",
]

# kernel name -> launches since the last reset: K1-K4 of the classify
# path, then the probes P1-P4 (tools/probes.py)
launches = {"extract_metamers": 0, "search_scan": 0, "chain_matches": 0,
            "combine_paths": 0, "gather_tile_sum": 0, "merge_join_sum": 0,
            "smoke_double": 0, "stream_sum": 0}

_LOCK = threading.Lock()
_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    # codes, lens, B, L, W, syncmer, smer_len, aa_tab, num_tab,
    # value, pos, valid, dna48, stream
    "mtb_extract_metamers": [_P, _P, _I, _I, _I, _I, _I, _P, _P,
                             _P, _P, _P, _P, _P],
    # value, valid, dna48, Q, W, grest, gstart, gend, prefix, d48,
    # prefix_bits, cap, start, wlen, cut, acc, stash, stash_cap,
    # stash_top, wstash, stream
    "mtb_search_count": [_P, _P, _P, _L, _I, _P, _P, _P, _P, _P, _I, _I,
                         _P, _P, _P, _P, _P, _L, _P, _P, _P],
    # dna48, Q, W, d48, start, wlen, cut, scan, stash, wstash,
    # out_row, out_slot, out_pay, stream
    "mtb_search_write": [_P, _L, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _P],
    # M, qid, species, frame, pos, ham, dna, h16,
    # min_depth, n_species, max_shift, kmer_format,
    # p_score, p_start, p_ham, p_depth, p_sh16, emit, stream
    "mtb_chain_matches": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _P, _P, _P, _P, _P, _P, _P],
    # n_groups, group_start, read, start, end, score, sh16, eh16,
    # read_lens, n_reads, accepted, out_score, stream
    "mtb_combine_paths": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                          _P, _P, _P],
    # table, n_table, slots, n_tiles, tile_q, out, stream
    "mtb_probe_gather_sum": [_P, _L, _P, _L, _I, _P, _P],
    # table, sorted_slots, bounds, n_tiles, tile_t, out, stream
    "mtb_probe_merge_join": [_P, _P, _P, _L, _I, _P, _P],
    # x, n, out, stream
    "mtb_probe_double": [_P, _L, _P, _P],
    # words, n, out, stream
    "mtb_probe_stream_sum": [_P, _L, _P, _P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> str:
    """Compile the kernels if any source is newer than the library."""
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        newest = max(os.path.getmtime(s) for s in srcs)
        if os.path.exists(SO) and os.path.getmtime(SO) >= newest:
            return SO
        tmp = f"{SO}.{os.getpid()}.tmp"
        objs = [os.path.join(BUILD_DIR, os.path.basename(src) + ".o")
                for src in srcs]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj,
                                   src],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT)
                 for src, obj in zip(srcs, objs)]
        try:
            logs = [p.communicate(timeout=900)[0].decode(errors="replace")
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [log for p, log in zip(procs, logs) if p.returncode != 0]
        if not failed:
            res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp,
                                  *objs], capture_output=True, timeout=900)
            if res.returncode != 0:
                failed = [res.stderr.decode(errors="replace")]
        if failed:
            raise RuntimeError("nvcc build of the CUDA kernels failed:\n"
                               + "\n".join(failed)[-6000:])
        os.replace(tmp, SO)
        return SO


def get_lib():
    """The loaded kernel library (built at first use; raises on failure)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def stream(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise on a refused launch (the C side returns cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def require_cuda(name: str, *tensors) -> None:
    """Wrapper-side argument check: every tensor contiguous and on the
    same CUDA device."""
    # get_device() is -1 on the CPU and the card's index on CUDA
    devices = {t.get_device() for t in tensors}
    if len(devices) != 1 or -1 in devices:
        raise ValueError(f"{name}: tensors must share one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
