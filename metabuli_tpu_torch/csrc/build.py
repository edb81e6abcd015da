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

The launch path every wrapper shares is kept cheap, because a small
kernel's call costs what the host spends on it: ``get_lib`` takes its lock
only until the library is loaded, ``stream`` reads PyTorch's current raw
stream handle without building a ``torch.cuda.Stream``, and
``require_cuda`` checks device, contiguity and dtype in one pass.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import os
import shutil
import subprocess
import threading

import torch

CSRC = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
SO = os.path.join(BUILD_DIR, "libmetabuli_cuda.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-fmad=false", "-Xcompiler", "-fPIC",
]

# kernel name -> launches since the last reset: K1-K4 of the classify
# path (K1 of either alphabet), K11 (K2's reduced-alphabet variant), K1
# for old-format (kmer_format 1) DBs, K12's two scanners (UniRef), then
# the probes P1-P4 (tools/probes.py)
launches = {"extract_metamers": 0, "search_scan": 0, "chain_matches": 0,
            "combine_paths": 0, "search_scan_reduced": 0,
            "extract_metamers_f1": 0, "extract_aa_kmers": 0,
            "extract_aa_kmers_dna": 0,
            "gather_tile_sum": 0, "merge_join_sum": 0, "smoke_double": 0,
            "stream_sum": 0}

_LOCK = threading.Lock()
_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    # codes, lens, B, L, W, syncmer, smer_len, aa_tab, num_tab,
    # value, pos, valid, dna48, kmer_format, stream
    "mtb_extract_metamers": [_P, _P, _I, _I, _I, _I, _I, _P, _P,
                             _P, _P, _P, _P, _I, _P],
    # the same, dna48 unused (null)
    "mtb_extract_metamers_reduced": [_P, _P, _I, _I, _I, _I, _I, _P, _P,
                                     _P, _P, _P, _P, _I, _P],
    # value, valid, dna48, Q, W, grest, gstart, gend, prefix, d48,
    # prefix_bits, cap, start, wlen, cut, acc, stash, stash_cap,
    # stash_top, wstash, kmer_format, stream
    "mtb_search_count": [_P, _P, _P, _L, _I, _P, _P, _P, _P, _P, _I, _I,
                         _P, _P, _P, _P, _P, _L, _P, _P, _I, _P],
    # dna48, Q, W, d48, start, wlen, cut, scan, stash, wstash,
    # out_row, out_slot, out_pay, kmer_format, stream
    "mtb_search_write": [_P, _L, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _I, _P],
    # K11: the same two launches for the reduced alphabet; value stands in
    # for dna48 (its low 32 bits are the query's codon numbers), the
    # bucket records for prefix, tword (the rows' codon numbers) for d48,
    # then the 16x16 int32 LUT
    "mtb_search_count_reduced": [_P, _P, _P, _L, _I, _P, _P, _P, _P, _P,
                                 _I, _I, _P, _P, _P, _P, _P, _L, _P, _P,
                                 _P, _I, _P],
    "mtb_search_write_reduced": [_P, _L, _I, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _P, _P, _P, _I, _P],
    # K12: codes, lens, B, L, W, k, syncmer, smer_len, value, pos, valid,
    # stream
    "mtb_extract_aa_kmers": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                             _P],
    # codes, lens, B, L, W, k, aa_tab, value, pos, valid, stream
    "mtb_extract_aa_kmers_dna": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                                 _P],
    # M, qid, species, frame, pos, ham, dna, h16,
    # min_depth, n_species, max_shift, kmer_format,
    # p_score, p_start, p_ham, p_depth, p_sh16, emit, stream
    "mtb_chain_matches": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _P, _P, _P, _P, _P, _P, _P],
    # n_groups, group_start, read, start, end, score, sh16, eh16,
    # read_lens, n_reads, accepted, out_score, stream
    "mtb_combine_paths": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                          _P, _P, _P],
    # table, n_table, slots, n_tiles, out, stream
    "mtb_probe_gather_sum": [_P, _L, _P, _L, _P, _P],
    # table, n_table, slots, n, counts, cursor, extra, part, out, stream
    "mtb_probe_merge_join_sum": [_P, _L, _P, _L, _P, _P, _P, _P, _P, _P],
    # x, n, out, stream
    "mtb_probe_double": [_P, _L, _P, _P],
    # words, n, out, stream
    "mtb_probe_stream_sum": [_P, _L, _P, _P],
    # buf (16-byte aligned), n_vec, sink, stream
    "mtb_l2_evict": [_P, _L, _P, _P],
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


def device(dev="cuda") -> torch.device:
    """``dev`` as a ``torch.device``; raises for a CUDA device when there
    is no card (the kernels run only on one: CPU runs ask for the plain
    versions with "cpu")."""
    dev = torch.device(dev)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the kernels run only on one; pass "
            "device='cpu' (--device cpu) for the plain PyTorch versions")
    return dev


def get_lib():
    """The loaded kernel library (built at first use; raises on failure).
    The lock guards only the first load."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            # PyDLL: the launches hold the interpreter lock, as PyTorch's
            # own do, instead of dropping and taking it again on each call
            lib = ctypes.PyDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def stream(device) -> int:
    """PyTorch's current stream on ``device`` (a CUDA ``torch.device`` or
    a device index) as a raw ``cudaStream_t``: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building the Stream object."""
    if not isinstance(device, int):
        device = (torch.cuda.current_device() if device.index is None
                  else device.index)
    return torch._C._cuda_getCurrentRawStream(device)


def check(rc: int, name: str) -> None:
    """Raise on a refused launch (the C side returns cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def require_cuda(name: str, *tensors, dtype=None) -> int:
    """Wrapper-side argument check, one pass over ``tensors``: every
    tensor contiguous, on the same CUDA device and, where ``dtype`` is
    given, of that dtype. Returns the device's index."""
    # get_device() is -1 on the CPU and the card's index on CUDA
    dev = tensors[0].get_device()
    for t in tensors:
        if t.get_device() != dev or dev < 0:
            raise ValueError(f"{name}: tensors must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name}: {dtype} tensors expected, got "
                            f"{t.dtype}")
    return dev
