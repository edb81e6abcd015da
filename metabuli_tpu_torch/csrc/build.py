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
ints): a run can then show that it went through the kernels. Beside them
the dict counts the shapes of the classify path's kernel calls, from
sizes the host already knows (no device synchronisation).

The compile runs with ``-Xptxas -v``, which only prints: each kernel's
registers, static shared memory, stack frame and spill stores and loads
are parsed from the nvcc logs into ``<library>.resources.json`` beside the
library (``resources()``). ``METABULI_TPU_CUDA_CHECKED=1`` in the process
builds and loads the checked variant instead,
``libmetabuli_cuda_checked.so``: the same sources with ``-DMTB_CHECKED
-lineinfo``, which turns on the bounds checks of ``check.cuh`` (a failed
one traps). ``python -m metabuli_tpu_torch.csrc.build --against DIR``
compiles these sources and DIR's with the normal flags into a temporary
directory and prints whether each kernel's registers, shared memory and
SASS equal DIR's.

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
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import torch

CSRC = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
SO = os.path.join(BUILD_DIR, "libmetabuli_cuda.so")
CHECKED_SO = os.path.join(BUILD_DIR, "libmetabuli_cuda_checked.so")
CHECKED_ENV = "METABULI_TPU_CUDA_CHECKED"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-fmad=false", "-Xcompiler", "-fPIC",
]
# ptxas prints each kernel's resources; the code it makes is the same
PTXAS_VERBOSE = ["-Xptxas", "-v"]
# the checked variant: check.cuh's bounds checks, source lines for a trap
CHECKED_FLAGS = ["-DMTB_CHECKED", "-lineinfo"]

# every __global__ function of csrc/*.cu -> the kernel it belongs to
KERNEL_LABELS = {
    "extract_kernel": "K1", "count_kernel": "K2", "write_kernel": "K2",
    "chain_kernel": "K3", "combine_kernel": "K4", "aa_kmers_kernel": "K12",
    "aa_kmers_dna_warp_kernel": "K12", "aa_kmers_dna_kernel": "K12",
    "gather_tile_sum_kernel": "P1", "partition_count_kernel": "P2",
    "partition_scan_kernel": "P2", "partition_scatter_kernel": "P2",
    "merge_join_kernel": "P2", "double_kernel": "P3",
    "stream_sum_kernel": "P4", "l2_evict_kernel": "P1/P2 L2 evict",
}


def label(name: str) -> str:
    """The kernel a compiled function (``name<template args>``) serves:
    KERNEL_LABELS, with K2's reduced instances as K11 and K1's by
    alphabet and format."""
    base, _, args = name.partition("<")
    flags = [a.strip() == "true" for a in args.rstrip(">").split(",")]
    if base in ("count_kernel", "write_kernel") and flags == [True]:
        return "K11"
    if base == "extract_kernel" and args:
        reduced, old = flags
        return "K1" + " reduced" * reduced + " format 1" * old
    return KERNEL_LABELS.get(base, "?")

# kernel name -> launches since the last reset: K1-K4 of the classify
# path (K1 of either alphabet), K11 (K2's reduced-alphabet variant), K1
# for old-format (kmer_format 1) DBs, K12's two scanners (UniRef), then
# the probes P1-P4 (tools/probes.py). Then "<kernel>.<shape>" counters of
# the classify path, summed over its calls on either device (the CPU's
# calls take the plain versions): the padded bases (rows x width) of each
# block the classifier hands to K1 and those rows' bases (their lengths,
# from the host's rows where the block is cut), the matches M of each K3
# call, and the groups G and paths of each K4 call.
launches = {"extract_metamers": 0, "search_scan": 0, "chain_matches": 0,
            "combine_paths": 0, "search_scan_reduced": 0,
            "extract_metamers_f1": 0, "extract_aa_kmers": 0,
            "extract_aa_kmers_dna": 0,
            "gather_tile_sum": 0, "merge_join_sum": 0, "smoke_double": 0,
            "stream_sum": 0,
            "extract_metamers.padded_bases": 0, "extract_metamers.bases": 0,
            "chain_matches.matches": 0, "combine_paths.groups": 0,
            "combine_paths.paths": 0}

_LOCK = threading.Lock()
_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    # codes, lens, B, L, W, syncmer, smer_len, aa_tab, num_tab,
    # value, pos, valid, dna48, n_codes, n_out, kmer_format, stream
    # (n_codes and n_out, the elements of codes and of each output, bound
    # the checked build's indices, as the other kernels' counts below do)
    "mtb_extract_metamers": [_P, _P, _I, _I, _I, _I, _I, _P, _P,
                             _P, _P, _P, _P, _L, _L, _I, _P],
    # the same, dna48 unused (null)
    "mtb_extract_metamers_reduced": [_P, _P, _I, _I, _I, _I, _I, _P, _P,
                                     _P, _P, _P, _P, _L, _L, _I, _P],
    # value, valid, dna48, Q, W, grest, gstart, gend, prefix, d48,
    # prefix_bits, cap, start, wlen, cut, acc, stash, stash_cap,
    # stash_top, wstash, n_groups, n_rows, n_buckets, kmer_format, stream
    "mtb_search_count": [_P, _P, _P, _L, _I, _P, _P, _P, _P, _P, _I, _I,
                         _P, _P, _P, _P, _P, _L, _P, _P, _L, _L, _L, _I,
                         _P],
    # dna48, Q, W, d48, start, wlen, cut, scan, stash, wstash,
    # out_row, out_slot, out_pay, stash_cap, n_rows, n_out, kmer_format,
    # stream (n_groups, n_rows, n_buckets, stash_cap and n_out bound the
    # checked build's indices)
    "mtb_search_write": [_P, _L, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _L, _L, _L, _I, _P],
    # K11: the same two launches for the reduced alphabet; value stands in
    # for dna48 (its low 32 bits are the query's codon numbers), the
    # bucket records for prefix, tword (the rows' codon numbers) for d48,
    # then the 16x16 int32 LUT
    "mtb_search_count_reduced": [_P, _P, _P, _L, _I, _P, _P, _P, _P, _P,
                                 _I, _I, _P, _P, _P, _P, _P, _L, _P, _P,
                                 _P, _L, _L, _L, _I, _P],
    "mtb_search_write_reduced": [_P, _L, _I, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _P, _P, _P, _L, _L, _L, _I, _P],
    # K12: codes, lens, B, L, W, k, syncmer, smer_len, value, pos, valid,
    # stream
    "mtb_extract_aa_kmers": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                             _P],
    # codes, lens, B, L, W, k, aa_tab, value, pos, valid, n_out, stream
    "mtb_extract_aa_kmers_dna": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                                 _L, _P],
    # M, qid, species, frame, pos, ham, dna, h16,
    # min_depth, n_species, max_shift, kmer_format,
    # p_score, p_start, p_ham, p_depth, p_sh16, emit, stream
    "mtb_chain_matches": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _P, _P, _P, _P, _P, _P, _P],
    # n_groups, group_start, read, start, end, score, sh16, eh16,
    # read_lens, n_reads, n_paths, accepted, out_score, stream
    "mtb_combine_paths": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
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


def checked() -> bool:
    """Whether this process builds and loads the checked variant."""
    return os.environ.get(CHECKED_ENV) == "1"


def library_path() -> str:
    """The library this process builds and loads."""
    return CHECKED_SO if checked() else SO


def resources_path(so: str) -> str:
    return so[:-len(".so")] + ".resources.json"


def resources() -> dict:
    """The built library's resource record: ``kernels`` (a record per
    compiled kernel: ``name`` with its template arguments, ``kernel``,
    ``label``, ``source``, ``registers``, ``smem`` bytes, ``stack`` bytes,
    ``spill_stores`` and ``spill_loads`` bytes), ``checked`` and ``nvcc_s``
    (the build's seconds)."""
    with open(resources_path(library_path())) as fh:
        return json.load(fh)


def _demangle(name: str) -> str:
    """A kernel's Itanium-mangled name as ``name<args>``: the plain and
    namespaced forms and bool template arguments, which is what csrc
    declares; anything else stays mangled."""
    m = re.match(r"_Z(N?)", name)
    if not m:
        return name
    i, parts, args = m.end(), [], ""
    while i < len(name) and name[i].isdigit():
        n = re.match(r"\d+", name[i:]).group()
        i += len(n)
        parts.append(name[i:i + int(n)])
        i += int(n)
        if not m.group(1):
            break
    if name[i:i + 1] == "I":
        vals = re.match(r"I((?:Lb[01]E)+)E", name[i:])
        if not vals:
            return name
        args = "<" + ", ".join("true" if v == "1" else "false" for v in
                               re.findall(r"Lb([01])E", vals.group(1))) + ">"
    parts = [p for p in parts if not p.startswith("_GLOBAL__N")]
    return "::".join(parts) + args if parts else name


def parse_ptxas(log: str, source: str = "") -> list[dict]:
    """Each kernel's resources from a ``-Xptxas -v`` compile log."""
    kernels, props, entry, props_for = {}, {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            kernels[entry] = {"registers": 0, "smem": 0}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props_for = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            props[props_for] = dict(zip(
                ("stack", "spill_stores", "spill_loads"),
                map(int, m.groups())))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            kernels[entry]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            kernels[entry]["smem"] = int(sm.group(1)) if sm else 0
    out = []
    for mangled, rec in kernels.items():
        name = _demangle(mangled).split("::")[-1]
        out.append({"name": name, "kernel": name.split("<")[0],
                    "label": label(name),
                    "source": source, **rec,
                    **props.get(mangled, dict(stack=0, spill_stores=0,
                                              spill_loads=0))})
    return out


def _compile(srcs, out_dir, tag, flags, so) -> list[dict]:
    """Every source to an object in ``out_dir`` (one nvcc process each,
    all started together), then one shared library ``so``; returns the
    kernels' resources from the logs. Raises on a failed compile."""
    objs = [os.path.join(out_dir, os.path.basename(src) + tag + ".o")
            for src in srcs]
    procs = [subprocess.Popen([_nvcc(), *flags, "-c", "-o", obj, src],
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
        res = subprocess.run([_nvcc(), *flags, "-shared", "-o", so, *objs],
                             capture_output=True, timeout=900)
        if res.returncode != 0:
            failed = [res.stderr.decode(errors="replace")]
    if failed:
        raise RuntimeError("nvcc build of the CUDA kernels failed:\n"
                           + "\n".join(failed)[-6000:])
    return [k for src, log in zip(srcs, logs)
            for k in parse_ptxas(log, os.path.basename(src))]


def build() -> str:
    """Compile the kernels if any source (or header) is newer than the
    library or its resource record is missing; the checked variant under
    METABULI_TPU_CUDA_CHECKED=1."""
    checked_build = checked()
    so = library_path()
    record = resources_path(so)
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    deps = srcs + glob.glob(os.path.join(CSRC, "*.cuh"))
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(so + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        newest = max(os.path.getmtime(s) for s in deps)
        if (os.path.exists(so) and os.path.exists(record)
                and os.path.getmtime(so) >= newest):
            return so
        tmp = f"{so}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        kernels = _compile(
            srcs, BUILD_DIR, ".checked" if checked_build else "",
            NVCC_FLAGS + PTXAS_VERBOSE
            + (CHECKED_FLAGS if checked_build else []), tmp)
        with open(record + ".tmp", "w") as fh:
            json.dump({"checked": checked_build,
                       "nvcc_s": time.perf_counter() - t0,
                       "kernels": kernels}, fh, indent=1)
        os.replace(record + ".tmp", record)
        os.replace(tmp, so)
        return so


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


def sass_by_kernel(so: str) -> dict:
    """Each kernel's SASS in ``so`` (cuobjdump -sass), demangled name ->
    its instructions, with the constant-bank operands (where a kernel
    reads its parameters) written as ``c[..]``, so that two builds whose
    kernels differ only in their parameter lists compare equal."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    sass, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _demangle(m.group(1)).split("::")[-1]
            sass[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            ins = line.split("/*", 2)[1].split("*/", 1)[1]
            sass[name].append(re.sub(r"c\[0x[0-9a-f]+\]\[0x[0-9a-f]+\]",
                                     "c[..]", ins.strip()))
    return sass


def _resources_of(csrc: str) -> list[dict]:
    """The kernels' resources of the ``*.cu`` files in ``csrc``, compiled
    with the normal library's flags into a temporary directory, each with
    its SASS (``sass_by_kernel``)."""
    srcs = sorted(glob.glob(os.path.join(csrc, "*.cu")))
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "lib.so")
        kernels = _compile(srcs, tmp, "", NVCC_FLAGS + PTXAS_VERBOSE, so)
        sass = sass_by_kernel(so)
    return [dict(k, sass=sass.get(k["name"], [])) for k in kernels]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m metabuli_tpu_torch.csrc.build",
        description="Whether each kernel's registers, shared memory and "
                    "SASS (constant-bank operands aside) equal another "
                    "source tree's, one JSON line per kernel; exit 1 if "
                    "any kernel's registers or shared memory differ.")
    ap.add_argument("--against", metavar="DIR", required=True,
                    help="the other tree's csrc directory")
    a = ap.parse_args(argv)
    mine = _resources_of(CSRC)
    other = {k["name"]: k for k in _resources_of(a.against)}
    same = True
    for k in mine:
        o = other.get(k["name"])
        eq = o is not None and all(k[f] == o[f] for f in ("registers",
                                                           "smem"))
        same &= eq
        print(json.dumps({"name": k["name"], "label": k["label"],
                          "registers": k["registers"], "smem": k["smem"],
                          "against_registers": o and o["registers"],
                          "against_smem": o and o["smem"], "equal": eq,
                          "sass_instructions": len(k["sass"]),
                          "sass_equal": o is not None
                          and k["sass"] == o["sass"]}))
    same &= len(other) == len(mine)
    print(json.dumps({"kernels": len(mine), "against": len(other),
                      "equal": same}))
    return 0 if same else 1

if __name__ == "__main__":
    sys.exit(main())
