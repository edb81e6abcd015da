"""Every kernel of the checked build against its plain version, at the
main path's shapes.

    METABULI_TPU_CUDA_CHECKED=1 python -m metabuli_tpu_torch.tools.checked DIR

With the variable set, ``csrc/build.py`` builds and loads
``libmetabuli_cuda_checked.so``: the kernels with the bounds checks of
``csrc/check.cuh`` on (``-DMTB_CHECKED -lineinfo``), each of which traps
on an index outside its array. ``DIR`` holds what ``save_batch`` wrote of
a classifier and one of its batches (chip_smoke.py writes it from its
``kernels`` phase: the 2^28-row smoke DB and 8,192 reads of 150 bp).
This runs each kernel once there:
  K1        the batch's reads, and one launch of the world's first 64
            genomes of 100 kb (the smoke DB build's K1 shape), in each
            alphabet and format
  K2        the batch's metamers against the classifier's own table (its
            rows, prefix bits, buckets and deepest group as cap)
  K3, K4    the batch's matches and paths on that table (the classify
            path's columns, min depths and read lengths)
  K11, K1f1 the batch's metamers against the index of the 64 genomes'
            rows (reduced alphabet, format 1)
  K12       one 2,000,000-residue flush of 300-residue proteins, padded
            to 512, and the batch's reads as DNA rows
  P1-P4     the probes' reference sizes (tools/probes.run): a 2^23-slot
            table and 2^28 slots, 2,097,152 queries; [8, 128]; 2 GiB
Any difference from a plain version or a trap exits 1. One line per
check, then a JSON line: the build's seconds, the checks and this run's
seconds. The edge shapes are ``tests/test_torch_kernels.py``'s, run
against the same library by ``chip_smoke.py``'s ``checked`` phase.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from ..classify import device_chain, device_combine, pipeline
from ..classify.device_compact import compact_paths
from ..csrc import build
from ..ops import encode
from ..ops.genetic_code import encode_seqs_padded
from . import probes, world


def save_batch(path: str, clf, reads) -> None:
    """What the checked run takes of the main path into ``path``: the
    table ``clf`` built its device index from (``Classifier`` leaves out
    the DB's last row), and one batch of reads (a ``ReadBatch``, as
    ``Classifier._iter_batches`` gives them) with the tables K3 and K4
    read."""
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "values.npy"), clf.index.values[:-1])
    np.save(os.path.join(path, "taxids.npy"),
            clf.index.taxids[:-1].astype(np.int32))
    dtx = clf.taxonomer
    torch.save({
        "codes": torch.from_numpy(reads.codes),
        "lens": torch.from_numpy(reads.lens),
        "read_lens": torch.from_numpy(reads.read_lens),
        "species": clf.d_species.cpu(), "min_depth": dtx.min_depth.cpu(),
        "max_shift": dtx.p.max_codon_shift, "cap": clf.cap,
        "kmer_format": clf.par.kmer_format,
    }, os.path.join(path, "batch.pt"))


def same(got, want) -> bool:
    """Equal outputs: integers exactly, float32 bit for bit."""
    got = [g for g in got if g is not None]
    want = [w for w in want if w is not None]
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if not torch.is_tensor(g):
            if g != w:
                return False
            continue
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if g.shape != w.shape or not torch.equal(g, w):
            return False
    return True


class Checks:
    """Each kernel against its plain version; a record per check."""

    def __init__(self):
        self.records = []

    def __call__(self, name, shape, fn_k, fn_p, keep=lambda r: r):
        got = fn_k()
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # a trap in the kernel surfaces here
        want = fn_p()
        ok = same(keep(got), keep(want))
        rec = {"kernel": name, "shape": shape, "equal": ok}
        self.records.append(rec)
        print(f"[checked] kernel={name} shape={shape} equal={ok}",
              flush=True)
        return got


def table(codes, lens, dev, **kw):
    """The sorted unique (value, genome) rows of K1's metamers of
    ``codes`` (a genome a row, taxid row + 1) as a device index."""
    mm = encode.extract_metamers(codes, lens, **kw)
    tax = torch.arange(1, codes.shape[0] + 1, device=dev)
    v, t = world.unique_rows(
        mm.value[mm.valid], tax[:, None, None].expand(mm.valid.shape)
        [mm.valid])
    del mm
    return pipeline.build_dev_index(
        v.cpu().numpy().view(np.uint64), t.to(torch.int32).cpu().numpy(),
        device=dev, kmer_format=kw.get("kmer_format", 2),
        reduced=kw.get("reduced", False))


def main_path(check: Checks, dev, path: str,
              n_genomes: int = world.DB_CHUNK, residues: int = 2_000_000,
              probe_bits=(23, 28), stream_rows: int = 1 << 28) -> None:
    """The kernels at the main path's shapes, from ``save_batch``'s
    ``path`` (see the module docstring; smaller sizes rehearse the run on
    the CPU, whose wrappers take the plain versions)."""
    b = torch.load(os.path.join(path, "batch.pt"))
    c, ln = b["codes"].to(dev), b["lens"].to(dev)
    n = c.shape[0]
    offs = torch.zeros(n, dtype=torch.int32, device=dev)
    qids = torch.arange(n, dtype=torch.int32, device=dev)
    tmp = tempfile.mkdtemp(prefix="metabuli_checked_")
    genomes = world.make_world(tmp, "skew")[1]
    shutil.rmtree(tmp)
    gc, gl = (torch.from_numpy(a).to(dev) for a in encode_seqs_padded(
        [g for g, _ in genomes[:n_genomes]]))
    del genomes

    for kw, name in (({}, "extract_metamers"),
                     ({"reduced": True}, "extract_metamers"),
                     ({"kmer_format": 1}, "extract_metamers_f1")):
        tag = "+".join(f"{k}={v}" for k, v in kw.items())
        for shape, (x, xl) in (("reads", (c, ln)), ("db_chunk", (gc, gl))):
            check(name, "/".join(filter(None, (shape, tag))),
                  lambda: encode.extract_metamers(x, xl, **kw),
                  lambda: encode.extract_metamers_plain(x, xl, **kw))
        if kw:
            idx = table(gc, gl, dev, **kw)
            cap = idx.max_group
        else:  # as Classifier builds its (unchunked) index
            idx = pipeline.build_dev_index(
                np.load(os.path.join(path, "values.npy")),
                np.load(os.path.join(path, "taxids.npy")),
                kmer_format=b["kmer_format"], device=dev)
            cap = b["cap"]
        mm = encode.extract_metamers(c, ln, **kw)
        q = (mm.value.reshape(-1), mm.valid.reshape(-1),
             None if mm.dna48 is None else mm.dna48.reshape(-1))
        W = mm.value.shape[2]
        scan = "search_scan_reduced" if idx.reduced else "search_scan"
        cand = check(scan, "/".join(filter(None, ("reads", tag))),
                     lambda: pipeline.search_scan(idx, *q, W, cap),
                     lambda: pipeline.search_scan_plain(idx, *q, W, cap),
                     keep=lambda r: r[:-1])
        print(f"[checked] {scan} rows={idx.n} prefix_bits={idx.prefix_bits}"
              f" cap={cap} kept={cand.row.numel()} "
              f"walked_again={cand.n_rewalk}", flush=True)
        del mm, q, cand
        if kw:
            del idx
            continue
        species = b["species"].to(dev)
        m, _ = pipeline.classify_core(idx, species, c, ln, offs, qids,
                                      cap=cap)
        del idx
        frame, ham = m.packed & 7, (m.packed >> 3) & 0xFF
        h16 = (m.packed >> 11) & 0xFFFF
        cargs = (m.qid, m.species, frame, m.pos, ham, m.dna, h16,
                 b["min_depth"].to(dev))
        kw3 = dict(max_shift=b["max_shift"])
        chain = check("chain_matches", "reads",
                      lambda: device_chain.chain_matches(*cargs, **kw3),
                      lambda: device_chain.chain_matches_plain(*cargs,
                                                               **kw3))
        paths, gstart = device_combine.sort_paths(
            compact_paths(chain, m.qid, m.species, m.pos, h16))
        rl = b["read_lens"].to(dev)
        check("combine_paths", "reads",
              lambda: [device_combine.combine_paths(paths, gstart, rl)],
              lambda: [device_combine.combine_paths_plain(paths, gstart,
                                                          rl)])
        print(f"[checked] matches={m.qid.numel()} paths={paths.read.numel()}"
              f" groups={gstart.numel() - 1}", flush=True)
        del m, cargs, chain, paths, gstart
    # K12: one create-uniref-db flush, and the reads as DNA rows
    prng = np.random.default_rng(1)
    letters = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    prots = [bytes(prng.choice(letters, 300))
             for _ in range(-(-residues // 300))]
    pc, pl = (torch.from_numpy(a).to(dev)
              for a in encode.encode_aa_seqs_padded(prots, 512))
    check("extract_aa_kmers", "flush",
          lambda: encode.extract_aa_kmers(pc, pl),
          lambda: encode.extract_aa_kmers_plain(pc, pl))
    check("extract_aa_kmers_dna", "reads",
          lambda: encode.extract_aa_kmers_dna(c, ln),
          lambda: encode.extract_aa_kmers_dna_plain(c, ln))
    # the probes at their reference sizes
    g = torch.Generator(device=dev).manual_seed(0)
    ints = lambda hi, k: torch.randint(0, hi, (k,), generator=g,
                                       dtype=torch.int32, device=dev)
    for bits in probe_bits:
        t, s = ints(1 << 31, 1 << bits), ints(1 << bits, 2_097_152)
        for name in ("gather_tile_sum", "merge_join_sum"):
            check(name, f"table_2^{bits}",
                  lambda: [getattr(probes, name)(t, s)],
                  lambda: [getattr(probes, name + "_plain")(t, s)])
        del t, s
    x = ints(1 << 31, 1024).view(8, 128)
    check("smoke_double", "8x128", lambda: [probes.smoke_double(x)],
          lambda: [probes.smoke_double_plain(x)])
    big = torch.randint(-(1 << 63), (1 << 63) - 1, (stream_rows,),
                        generator=g, dtype=torch.int64, device=dev)
    check("stream_sum", f"{big.nbytes}B", lambda: [probes.stream_sum(big)],
          lambda: [probes.stream_sum_plain(big)])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not build.checked():
        print(f"set {build.CHECKED_ENV}=1: this runs the checked build",
              flush=True)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the checked kernels run only on one",
              flush=True)
        return 2
    if len(argv) != 1:
        print("usage: python -m metabuli_tpu_torch.tools.checked DIR "
              "(a directory save_batch wrote)", flush=True)
        return 2
    t0 = time.perf_counter()
    build.get_lib()
    res = build.resources()
    print(f"[checked] library={os.path.basename(build.library_path())} "
          f"nvcc_s={res['nvcc_s']:.3f} kernels={len(res['kernels'])}",
          flush=True)
    check = Checks()
    main_path(check, torch.device("cuda:0"), argv[0])
    ok = all(r["equal"] for r in check.records)
    print(json.dumps({"checked": ok, "nvcc_s": res["nvcc_s"],
                      "main_path_checks": len(check.records),
                      "s": time.perf_counter() - t0,
                      "records": check.records}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
