"""Smoke run of the PyTorch port's classify path on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

  device    the CUDA device, its capability (must be 9.0), and
            nvidia-smi's name and power limit
  build     nvcc builds the kernels, g++ the native host library
  probes    the device-cost probes P1-P4 (metabuli_tpu_torch.tools.probes
            in a process of its own; not on the classify path) against
            their plain versions at the profiling scripts' sizes; per
            probe and per library call that computes the same function:
            ms (one call between events), loop_ms (1,000 back-to-back
            calls, per call) and launch_ms (device time alone, from a
            torch.profiler trace)
  db        the smoke DB: the adversarial "skew" world of
            metabuli_tpu_torch.tools.world (2 genera x 192 species, a 6 kb
            wobble-diverged core + 94 kb unique each; the same genomes as
            bench.py's from the same seed), 6-frame metamers of
            every genome window extracted with K1, unique per (value,
            species), padded with never-matching decoy rows to 2^28 rows
  kernels   K1-K4 against their plain versions at the main path's shapes
            (8,192 reads of 150 bp), and K1 also at the smoke DB's shape
            (one launch of 64 genomes of 100 kb), at the CLI build's
            (build_blocks: its largest padded batch of predicted gene
            blocks of 8 species) and on one 30 Mb sequence (long_row: its
            length bucket of 50,331,648 bases is 65,536 chunks of 256
            windows): integers equal, float32
            bitwise; the median ms of each over 5 runs after a warm-up,
            from CUDA events, for the wrapper (ms) and the plain version;
            its kernels' device time alone (launch_ms, median of 5 from a
            torch.profiler trace); bound_ms from the batch's own bytes
            (tools/probes.bound); K2's stash size and the warps whose write
            walked again
  parity    one 8,192-read batch classified through the kernels and
            through the plain versions gives identical classification lines
  tiny      the two-genome world of .claude/skills/verify/SKILL.md through
            the CLI: all 120 reads classified, the report 50/50
  dbbuild   the port's CLI ``build`` of the skew world as a FASTA library
            (tools.world.write_library: 384 species x 100 kb, one file per
            genus) at the defaults (gene prediction and masking on), then
            ``updateDB`` with a new genus of 16 random 100 kb genomes
            (tools.world.new_genus, --new-taxa), then ``classify`` of the
            65,536 reads against the updated DB; each with the kernels'
            launch counts (K1 > 0 in build and updateDB), stage seconds,
            peak device memory; the DB digests, the classified count and
            the classifications' digest must equal the JAX package's on
            the CPU (the constants below)
  classify  the CLI on 65,536 reads of 150 bp (tools.world.sample_reads,
            max_mut 2, 10 % random reads), 8,192 per batch: reads/s, stage
            times, peak memory, and every kernel's launch count > 0
  longread  bench.py's longread configuration: the "uniform" world (4
            genera x 2 species of 200 kb), a DB of its 6-frame metamers
            padded with never-matching decoys to 60,000,000 rows, 8,192
            reads of 3,000 bases (max_mut 30); one automatic batch
            (--batch-reads 0) whose device peak above the index must stay
            within its byte budget; K1-K4 against their plain
            versions on one 1,024-read batch (as in kernels, with the
            largest K3 block and K4 group) and that batch through both
            (identical lines), then the CLI with --seq-mode 3
            --batch-reads 1024: reads/s, stage times, peak memory, every
            kernel launched; the classified count and the classifications'
            digest must equal the JAX package's on the CPU (constants
            below)
  hosttax   the classify phase's reads and DB through the CLI with
            --device-tax 0 (K1 and K2 on the card, the native host
            taxonomer): reads/s and the host assign's seconds; the
            classifications must equal the classify phase's
  pipeline  the classify phase's run is pipelined: the worker's finish
            seconds, the part of them during which the main thread parsed
            or dispatched another batch, and each thread's CPU seconds

Each CLI run of a phase starts with every launch count at 0 and reads
them when it returns. The last three lines are the kernels' JSON record
(K1-K4, each with its longread record and launches, then the probes
P1-P4 with their launches in the classify run, 0 since they are off the
path, and their loop_ms and library_* times), nvidia-smi's name and power
limit, and the device record.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ROWS = 1 << 28  # smoke DB rows after decoy padding
# classified reads of the 65,536 (world and reads from seed 0): the count
# every earlier run of this script gave on the card
CLASSIFIED = 58_985
# the dbbuild phase's results from the JAX package on the CPU, for the
# same files and flags, printed by
#   JAX_PLATFORMS=cpu python tests/helpers/smoke_reference.py
# (sha256 of diffIdx + info + taxID_list; of the blocks handed to
# extraction; of the classifications file)
DB_DATE = "2026-01-01"
BUILD_DB_SHA256 = (
    "54434100fb92a104349d323cfc2815cc7e38314fffe0626b6eb4ab2ab992cd50")
BUILD_BLOCKS_SHA256 = (
    "bd85eb7000f51ce0a9f1caa35227210570b2d8fb66354e2dab2d6aa61467bb05")
UPDATE_DB_SHA256 = (
    "bc088ccc65e69f744b10b7781a06fb37cc5381432bcc00d64745b56a2f3c816d")
UPDATE_BLOCKS_SHA256 = (
    "cf811256f049fd5f517ec42330213627a68f38558d9b9487a8b0e48b02c83566")
UPDATED_CLASSIFIED = 58_984
UPDATED_CLASSIFICATIONS_SHA256 = (
    "731474296ae78e408fd952ad90169c3ff0a9062e458989f0026ccb2b29253d79")
LONG_ROW = 30_000_000  # bases of the long_row K1 record
# the longread phase: bench.py's longread configuration (its TARGET_ROWS,
# reads, read length and batch)
LONGREAD_ROWS = 60_000_000
LONGREAD_READS = 8_192
LONGREAD_LEN = 3_000
LONGREAD_BATCH = 1_024
# the JAX package's classified count and classifications digest for the
# same reads against the genome-derived rows of the same DB (with
# never-matching decoys, which change no classification), printed by
#   JAX_PLATFORMS=cpu python tests/helpers/smoke_reference.py longread
LONGREAD_CLASSIFIED = 7_373
LONGREAD_CLASSIFICATIONS_SHA256 = (
    "4759244bdc2f7f244444d890205c3e688c0a2eec0b0ec5b17b81ac3db9a72b82")

# kernel name -> its CUDA functions, as the profiler names them
KERNEL_FUNCTIONS = {"extract_metamers": ["extract_kernel"],
                    "search_scan": ["count_kernel", "write_kernel"],
                    "chain_matches": ["chain_kernel"],
                    "combine_paths": ["combine_kernel"]}

KERNELS = [
    # name, source, the XLA block it replaces
    ("extract_metamers", "metabuli_tpu_torch/csrc/extract.cu",
     "metabuli_tpu/ops/encode.py:72"),
    ("search_scan", "metabuli_tpu_torch/csrc/search_scan.cu",
     "metabuli_tpu/classify/pipeline.py:607"),
    ("chain_matches", "metabuli_tpu_torch/csrc/chain.cu",
     "metabuli_tpu/classify/device_chain.py:89"),
    ("combine_paths", "metabuli_tpu_torch/csrc/combine.cu",
     "metabuli_tpu/classify/device_combine.py:66"),
]


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def fail(phase: str, msg: str) -> None:
    print(f"[{phase}] FAILED: {msg}", flush=True)
    sys.exit(1)


def run_cli(argv) -> dict:
    """metabuli_tpu_torch.cli.main(argv); returns its JSON summary."""
    from metabuli_tpu_torch.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"cli exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


# ---------------------------------------------------------------- kernels
def max_abs_err(got, want) -> float:
    """Largest |kernel - plain| over every output; integers compare
    exactly and float32 outputs must also match bit for bit."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        if not torch.is_tensor(g):
            err = max(err, abs(float(g) - float(w)))
            continue
        if g.shape != w.shape:
            return float("inf")
        if g.numel() == 0:
            continue
        if g.dtype == torch.float32 and not torch.equal(
                g.view(torch.int32), w.view(torch.int32)):
            err = max(err, float("nan") if torch.isnan(g).any() else 1e-30)
        err = max(err, float((g.double() - w.double()).abs().max()))
    return err


def kernel_phase(clf, metas, rows, out, phase="kernels", shape=None,
                 k1_shapes=()) -> dict:
    """K1-K4 against their plain versions on one batch's tensors, into
    ``out`` (kernel -> record; a ``shape`` of the batch goes under that
    key of each record), and K1 also at ``k1_shapes``: (shape, (numpy
    codes, lens) or a callable that returns them)."""
    import torch

    from metabuli_tpu_torch.classify import device_chain, device_combine
    from metabuli_tpu_torch.classify import pipeline
    from metabuli_tpu_torch.classify.device_compact import compact_paths
    from metabuli_tpu_torch.ops import encode
    from metabuli_tpu_torch.ops.genetic_code import encode_seqs_padded
    from metabuli_tpu_torch.tools.probes import bound, device_ms, median_ms

    dev = clf.device
    codes, lens = encode_seqs_padded([r[0] for r in rows])
    codes = torch.from_numpy(codes).to(dev)
    lens = torch.from_numpy(lens).to(dev)
    n = len(rows)
    offs = torch.zeros(n, dtype=torch.int32, device=dev)
    qids = torch.arange(n, dtype=torch.int32, device=dev)

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def record(name, fn_k, fn_p, cost, shape=shape):
        """``cost(outputs)`` -> least bytes of the call; a second ``shape``
        of a kernel is kept under that key of its record."""
        got, want = fn_k(), fn_p()
        torch.cuda.synchronize()
        # K2's count of warps that walked again is the kernel's own
        same = lambda r: (r[:-1] if isinstance(r, pipeline.Candidates)
                          else r)
        err = max_abs_err(same(got), same(want))
        b_ms, b_by = bound(cost(got))
        l_ms, parts = device_ms(fn_k, KERNEL_FUNCTIONS[name],
                                at_least=b_ms)
        rec = {"max_abs_err": err, "ms": median_ms(fn_k), "launch_ms": l_ms,
               "plain_ms": median_ms(fn_p), "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": None}
        if shape is None:
            out[name] = rec
        else:
            out.setdefault(name, {})[shape] = rec
        say(phase, kernel=name, **({} if shape is None else
                                       {"shape": shape}), equal=err == 0,
            **{k: round(rec[k], 4)
               for k in ("ms", "launch_ms", "plain_ms", "bound_ms")},
            bound_by=b_by,
            launch_parts_ms=[round(p, 4) for p in parts.values()])
        if err != 0:
            fail(phase, f"{name} differs from its plain version ({err})")
        return got

    # least bytes: every input read once, every output written once (K2:
    # only the table entries its queries need; K4: only what it must read)
    mm = record("extract_metamers",
                lambda: encode.extract_metamers(codes, lens),
                lambda: encode.extract_metamers_plain(codes, lens),
                lambda mm: nbytes([codes, lens, *mm]))
    for k1_shape, batch in k1_shapes:
        c, ln = batch() if callable(batch) else batch
        c, ln = torch.from_numpy(c).to(dev), torch.from_numpy(ln).to(dev)
        say(phase, shape=k1_shape, rows=c.shape[0], bases=c.shape[1],
            chunks=-(-encode.max_windows(c.shape[1]) // 256))
        record("extract_metamers",
               lambda: encode.extract_metamers(c, ln),
               lambda: encode.extract_metamers_plain(c, ln),
               lambda r: nbytes([c, ln, *r]), shape=k1_shape)
        del c, ln
        torch.cuda.empty_cache()
    idx, W = clf.dev_index, mm.value.shape[2]
    q = (mm.value.reshape(-1), mm.valid.reshape(-1), mm.dna48.reshape(-1))
    gs, ge, hit = pipeline._search_groups(idx, q[0], q[1])
    n_valid, n_hit = int(q[1].sum()), int(hit.sum())
    n_window = int((torch.minimum(ge, gs + clf.cap) - gs).sum())
    say(phase, slots=q[0].numel(), valid_slots=n_valid,
        hit_slots=n_hit, window_rows=n_window)
    cand = record("search_scan",
                  lambda: pipeline.search_scan(idx, *q, W, clf.cap),
                  lambda: pipeline.search_scan_plain(idx, *q, W, clf.cap),
                  lambda c: (17 * q[0].numel() + 12 * n_valid + 8 * n_hit
                             + 8 * n_window + 12 * c.row.numel()))
    say(phase, stash_per_slot=pipeline.stash_per_slot(idx),
        rows_per_hit=round(idx.rows_per_hit, 3),
        warps=(q[0].numel() + 31) // 32, warps_walked_again=cand.n_rewalk)
    m, counts = pipeline.classify_core(idx, clf.d_species, codes, lens, offs,
                                       qids, cap=clf.cap)
    block = ((m.qid.long() << 40) | (m.species.long() << 8)
             | (m.packed & 7).long())
    largest = lambda k: int(torch.unique_consecutive(
        k, return_counts=True)[1].max()) if k.numel() else 0
    frame, ham = m.packed & 7, (m.packed >> 3) & 0xFF
    h16 = (m.packed >> 11) & 0xFFFF
    dtx = clf.device_taxonomer
    cargs = (m.qid, m.species, frame, m.pos, ham, m.dna, h16, dtx.min_depth)
    kw = dict(max_shift=dtx.p.max_codon_shift)
    # K3 loads each of its seven int32 columns per row and the int32
    # min_depth table, and writes five 32-bit path columns and a flag a row
    chain = record("chain_matches",
                   lambda: device_chain.chain_matches(*cargs, **kw),
                   lambda: device_chain.chain_matches_plain(*cargs, **kw),
                   lambda r: nbytes([*cargs, *r]))
    paths, gstart = device_combine.sort_paths(
        compact_paths(chain, m.qid, m.species, m.pos, h16))
    rl = torch.as_tensor(np.array([x.read_len for x in metas], np.int32),
                         device=dev)
    # K4 reads every path's start, end and score, a boundary-codon word
    # (sh16 or eh16) only for each side of a path that a trim cuts, and per
    # group its bounds, its head's read and that read's length (once per
    # read); it writes a score per group
    P, G = paths.read.numel(), gstart.numel() - 1
    n_trim = int(device_combine.combine_trims_plain(paths, gstart, rl)[1])
    n_read = int(torch.unique(paths.read[gstart[:-1].long()]).numel())
    record("combine_paths",
           lambda: [device_combine.combine_paths(paths, gstart, rl)],
           lambda: [device_combine.combine_paths_plain(paths, gstart, rl)],
           lambda r: 12 * P + 4 * n_trim + 4 * (G + 1) + 8 * G + 4 * n_read)
    say(phase, matches=counts["n_matches"], paths=P, groups=G,
        trimmed_sides=n_trim, group_reads=n_read,
        largest_k3_block_rows=largest(block),
        largest_k3_group_rows=largest(
            (block << 16) | torch.div(m.pos, 3, rounding_mode="floor")),
        largest_k4_group_paths=int((gstart[1:] - gstart[:-1]).max())
        if G else 0)
    return out


def long_row():
    """One LONG_ROW-base sequence padded to the build's length bucket
    (384 * 2^k bases): codes [1, L] uint8, lens [1] int32."""
    from metabuli_tpu_torch.ops.genetic_code import encode_seqs_padded

    bucket = 384
    while bucket < LONG_ROW + 2:
        bucket *= 2
    rng = np.random.default_rng(30)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    return encode_seqs_padded([bytes(rng.choice(acgt, LONG_ROW))],
                              max_len=bucket)


def build_block_batch(tax, genomes, dev):
    """The largest padded batch (rows x bucket) that the CLI build hands
    K1 from the predicted gene blocks of ``genomes`` (masking on, the
    defaults): codes and lens."""
    from metabuli_tpu_torch.db.build import (IndexBuilder, SeqTask,
                                             predict_gene_blocks)
    from metabuli_tpu_torch.params import BuildParams

    par = BuildParams()
    tasks = []
    for g, sp in genomes:
        t = tax.to_internal(sp)
        tasks.append(SeqTask(g, t, int(tax.species_of[t])))
    blocks = predict_gene_blocks(tasks, tax, mask_mode=par.mask_mode,
                                 mask_prob=par.mask_prob)
    builder = IndexBuilder(par, tax, device=dev)
    batch = max(builder.batches(blocks),
                key=lambda b: len(b) * max(len(t.seq) for t in b))
    return builder.padded(batch)


def sha256_of(*paths) -> str:
    import hashlib

    h = hashlib.sha256()
    for path in paths:
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def dbbuild_phase(tmp, tax, genomes, fq, dev) -> dict:
    """The CLI's build, updateDB and classify (see the module docstring);
    returns each step's kernel launch counts."""
    from metabuli_tpu_torch.tools import world

    lib, acc = world.write_library(os.path.join(tmp, "library"), genomes,
                                   world.genus_of(tax, genomes))
    new_lib, new_acc, new_taxa, _ = world.new_genus(
        os.path.join(tmp, "new_genus"), tax)
    bdb = os.path.join(tmp, "built_db")
    udb = os.path.join(tmp, "updated_db")
    out = os.path.join(tmp, "updated_out")
    launches = {}

    def counted(step, argv):
        s, launches[step] = counted_cli(argv, dev)
        return s

    def check_db(step, s, db, want_db, want_blocks):
        got = sha256_of(*(os.path.join(db, f)
                          for f in ("diffIdx", "info", "taxID_list")))
        k1 = launches[step]["extract_metamers"]
        stage_s = {k: round(v, 3) for k, v in s["stage_s"].items()}
        say("dbbuild", step=step, sequences=s["sequences"],
            blocks=s["blocks"], total_kmers=s["total_kmers"],
            unique_kmers=s["unique_kmers"], k1_launches=k1,
            run_s=round(s["run_s"], 3),
            db_bytes=sum(os.path.getsize(os.path.join(db, f))
                         for f in os.listdir(db)),
            peak_mem_gib=round(s["peak_mem_gib"], 3))
        say("dbbuild", step=step, stage_s=stage_s,
            other_s=round(s["run_s"] - sum(s["stage_s"].values()), 3))
        say("dbbuild", step=step, db_sha256=got, equal_jax=got == want_db,
            blocks_sha256=s["blocks_sha256"],
            blocks_equal_jax=s["blocks_sha256"] == want_blocks)
        if k1 == 0:
            fail("dbbuild", f"{step}: K1 never launched")
        if got != want_db:
            fail("dbbuild", f"{step}: the DB differs from the JAX package's "
                 + ("(so do the gene blocks: the host's gene prediction)"
                    if s["blocks_sha256"] != want_blocks else
                    "(the gene blocks are equal: extraction or later)"))

    s = counted("build", ["build", bdb, lib, acc, "--taxonomy-path",
                          os.path.join(tmp, "skew_taxonomy"),
                          "--db-date", DB_DATE])
    check_db("build", s, bdb, BUILD_DB_SHA256, BUILD_BLOCKS_SHA256)
    s = counted("update", ["updateDB", udb, new_lib, new_acc, "--old-db",
                           bdb, "--new-taxa", new_taxa, "--db-date",
                           DB_DATE])
    check_db("update", s, udb, UPDATE_DB_SHA256, UPDATE_BLOCKS_SHA256)
    s = counted("classify", ["classify", fq, udb, out, "updated",
                             "--seq-mode", "1", "--batch-reads", "8192"])
    digest = sha256_of(os.path.join(out, "updated_classifications.tsv"))
    say("dbbuild", step="classify", reads=s["reads"],
        classified=s["classified"],
        reads_per_s=round(s["reads"] / s["classify_s"], 1),
        classify_s=round(s["classify_s"], 3),
        peak_mem_gib=round(s["peak_mem_gib"], 3),
        launches=launches["classify"])
    say("dbbuild", step="classify",
        stage_ms={k: round(v, 3) for k, v in s["stage_ms"].items()})
    say("dbbuild", step="classify", classifications_sha256=digest,
        equal_jax=digest == UPDATED_CLASSIFICATIONS_SHA256)
    if s["classified"] != UPDATED_CLASSIFIED:
        fail("dbbuild", f"{s['classified']} reads classified, the JAX "
                        f"package {UPDATED_CLASSIFIED}")
    if digest != UPDATED_CLASSIFICATIONS_SHA256:
        fail("dbbuild", "the classifications differ from the JAX package's")
    return launches


def parity(clf, metas, rows, resident, phase) -> None:
    """One batch through the kernels and through the plain versions: the
    classification lines must be identical."""
    import torch

    dev = clf.device
    lines, peak = {}, {}
    for plain in (False, True):
        torch.cuda.reset_peak_memory_stats(dev)
        res = clf.classify_batch(metas, rows, plain=plain)
        peak[plain] = torch.cuda.max_memory_allocated(dev) - resident
        lines[plain] = [clf.reporter.classification_row(mt.name, rc,
                                                        mt.read_len)
                        for mt, rc in zip(metas, res)]
    same = lines[False] == lines[True]
    say(phase, reads=len(metas),
        classified=sum(rc.is_classified for rc in res), identical=same,
        batch_peak_gib=round(peak[False] / 2**30, 3),
        plain_batch_peak_gib=round(peak[True] / 2**30, 3))
    if not same:
        fail(phase, "kernel and plain classifications differ")


def counted_cli(argv, dev) -> tuple[dict, dict]:
    """One CLI run with every launch count set to 0 just before it and
    read just after: (its summary with run_s and peak_mem_gib, the count
    of every kernel, K1-K4 and the probes)."""
    import torch

    from metabuli_tpu_torch.csrc import build

    for k in build.launches:
        build.launches[k] = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    s = run_cli(argv)
    s["run_s"] = time.perf_counter() - t0
    s["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return s, dict(build.launches)


def longread_phase(tmp, dev, timings) -> dict:
    """bench.py's longread configuration (see the module docstring);
    returns the CLI run's launch counts."""
    import torch

    from metabuli_tpu_torch.classify.classifier import Classifier
    from metabuli_tpu_torch.params import ClassifyParams
    from metabuli_tpu_torch.tools import world

    t0 = time.perf_counter()
    tax, genomes, rng = world.make_world(tmp, "uniform")
    db = os.path.join(tmp, "longread_db")
    info = world.build_db(db, tax, genomes, dev, rows=LONGREAD_ROWS,
                          never_match=True)
    say("longread", **info)
    if info["rows"] != LONGREAD_ROWS:
        fail("longread", f"{info['rows']} rows, asked for {LONGREAD_ROWS}")
    reads = world.sample_reads(genomes, rng, LONGREAD_READS, LONGREAD_LEN,
                               max_mut=LONGREAD_LEN // 100)
    fq = os.path.join(tmp, "long.fq")
    world.write_fastq(fq, reads)
    del reads
    clf = Classifier(db, ClassifyParams(seq_mode=3, batch_reads=0),
                     device=dev)
    resident = torch.cuda.memory_allocated(dev)
    say("longread", db_load_s=round(clf.load_s, 3), cap=clf.cap,
        resident_gib=round(resident / 2**30, 3))
    # one automatic batch (--batch-reads 0): its device peak above the
    # resident index must stay within the byte budget it was cut for
    auto_metas, auto_rows = next(clf._iter_batches(fq, None))
    torch.cuda.reset_peak_memory_stats(dev)
    clf.classify_batch(auto_metas, auto_rows)
    auto_peak = torch.cuda.max_memory_allocated(dev) - resident
    say("longread", auto_reads=len(auto_metas),
        auto_bases=sum(len(r[0]) for r in auto_rows),
        batch_reads=clf.par.batch_reads, batch_bases=clf.batch_bases,
        auto_batch_peak_gib=round(auto_peak / 2**30, 3),
        budget_gib=round(clf.batch_budget / 2**30, 3))
    if auto_peak > clf.batch_budget:
        fail("longread", "an automatic batch took more device memory than "
                         "its budget")
    # the CLI run's first batch: single-end reads, so read i is row i
    metas, rows = auto_metas[:LONGREAD_BATCH], auto_rows[:LONGREAD_BATCH]
    kernel_phase(clf, metas, rows, timings, phase="longread",
                 shape="longread")
    parity(clf, metas, rows, resident, "longread")
    del clf
    torch.cuda.empty_cache()
    out = os.path.join(tmp, "long_out")
    s, counts = counted_cli(["classify", fq, db, out, "long", "--seq-mode",
                             "3", "--batch-reads", str(LONGREAD_BATCH)], dev)
    digest = sha256_of(os.path.join(out, "long_classifications.tsv"))
    say("longread", reads=s["reads"], classified=s["classified"],
        reads_per_s=round(s["reads"] / s["classify_s"], 1),
        classify_s=round(s["classify_s"], 3), db_load_s=round(s["load_s"], 3),
        finish_s=round(s["finish_s"], 3),
        peak_mem_gib=round(s["peak_mem_gib"], 3), launches=counts)
    say("longread", stage_ms={k: round(v, 3)
                              for k, v in s["stage_ms"].items()})
    say("longread", classifications_sha256=digest,
        equal_jax=digest == LONGREAD_CLASSIFICATIONS_SHA256,
        phase_s=round(time.perf_counter() - t0, 3))
    if (s["reads"] != LONGREAD_READS
            or min(counts[name] for name, _, _ in KERNELS) == 0):
        fail("longread", f"{s['reads']} reads, launches {counts}")
    if s["classified"] != LONGREAD_CLASSIFIED:
        fail("longread", f"{s['classified']} reads classified, the JAX "
                         f"package {LONGREAD_CLASSIFIED}")
    if digest != LONGREAD_CLASSIFICATIONS_SHA256:
        fail("longread", "the classifications differ from the JAX package's")
    shutil.rmtree(os.path.join(tmp, "longread_db"), ignore_errors=True)
    return counts


def hosttax_phase(tmp, fq, db, want_digest, dev) -> dict:
    """The smoke DB's 65,536 reads with --device-tax 0: the match core on
    the card, the native host taxonomer; the classifications must equal
    the default path's. Returns the launch counts."""
    t0 = time.perf_counter()
    out = os.path.join(tmp, "hosttax_out")
    s, counts = counted_cli(["classify", fq, db, out, "hosttax",
                             "--seq-mode", "1", "--batch-reads", "8192",
                             "--device-tax", "0"], dev)
    digest = sha256_of(os.path.join(out, "hosttax_classifications.tsv"))
    say("hosttax", reads=s["reads"], classified=s["classified"],
        reads_per_s=round(s["reads"] / s["classify_s"], 1),
        classify_s=round(s["classify_s"], 3),
        host_assign_s=round(s["finish_s"], 3),
        assign_overlap_s=round(s["finish_overlap_s"], 3),
        peak_mem_gib=round(s["peak_mem_gib"], 3), launches=counts)
    say("hosttax", stage_ms={k: round(v, 3)
                             for k, v in s["stage_ms"].items()},
        equal_default=digest == want_digest,
        phase_s=round(time.perf_counter() - t0, 3))
    if counts["extract_metamers"] == 0 or counts["search_scan"] == 0:
        fail("hosttax", f"K1 or K2 never launched: {counts}")
    if digest != want_digest:
        fail("hosttax", "the classifications differ from the default path's")
    return counts


def pipeline_phase(s) -> None:
    """The classify phase's CLI run, pipelined: the worker's finish
    seconds, the part of them during which the main thread parsed or
    dispatched another batch, and each thread's CPU seconds."""
    say("pipeline", classified=s["classified"],
        classify_s=round(s["classify_s"], 3),
        finish_s=round(s["finish_s"], 3),
        overlap_s=round(s["finish_overlap_s"], 3),
        overlap_share=round(s["finish_overlap_s"] / max(s["finish_s"],
                                                        1e-9), 3),
        finish_cpu_s=round(s["finish_cpu_s"], 3),
        main_cpu_s=round(s["main_cpu_s"], 3),
        dispatch_s=round(s["device_s"], 3), worker_s=round(s["tax_s"], 3))
    if s["classified"] != CLASSIFIED:
        fail("pipeline", f"{s['classified']} reads classified")


# ------------------------------------------------------------------- main
def main() -> int:
    # ---- device
    import torch

    if not torch.cuda.is_available():
        fail("device", "no CUDA device: the smoke run needs one H100")
    dev = torch.device("cuda:0")
    cap = torch.cuda.get_device_capability(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    say("device", name=repr(torch.cuda.get_device_name(dev)),
        capability=cap, count=torch.cuda.device_count())
    print(card, flush=True)
    if cap != (9, 0):
        fail("device", f"capability {cap}, the kernels are built for sm_90a")
    sys.path.insert(0, ROOT)
    from metabuli_tpu_torch import native
    from metabuli_tpu_torch.classify.classifier import Classifier
    from metabuli_tpu_torch.csrc import build
    from metabuli_tpu_torch.ops.genetic_code import encode_seqs_padded
    from metabuli_tpu_torch.params import ClassifyParams

    # ---- build
    t0 = time.perf_counter()
    build.get_lib()
    t1 = time.perf_counter()
    native.get_lib()
    say("build", nvcc_s=round(t1 - t0, 3),
        gxx_s=round(time.perf_counter() - t1, 3))

    # ---- probes (not on the classify path), in a process of their own:
    # with their torch.profiler traces taken in this process, the first
    # trace of each kernel in the kernels phase held none or only some of
    # its launches
    pr = subprocess.run([sys.executable, "-m",
                         "metabuli_tpu_torch.tools.probes"], cwd=ROOT,
                        capture_output=True, text=True, timeout=900)
    sys.stderr.write(pr.stderr[-4000:])
    try:
        probe_res = json.loads(pr.stdout.strip().splitlines()[-1])["probes"]
    except (IndexError, ValueError, KeyError):
        fail("probes", f"the runner exited {pr.returncode}")

    def times(r):
        """A record's times, and why a launch_ms is None where one is."""
        return {k: None if v is None else round(v, 4) for k, v in r.items()
                if k.endswith("ms") and not isinstance(v, dict)
                or k.startswith(("ns_", "gb_"))} | (
            {"launch_lost": r["launch_lost"]} if "launch_lost" in r else {})

    for name, r in probe_res.items():
        say("probes", kernel=name, replaces=r["replaces"],
            equal=r["max_abs_err"] == 0, bound_by=r["bound_by"], l2=r["l2"],
            **times(r), launch_parts_ms={
                k: round(v, 4) for k, v in r["launch_parts_ms"].items()})
        # P1 and P2: on a DB-sized table; P2 with every query in one tile
        for shape in ("at_db", "one_tile"):
            if shape in r:
                say("probes", kernel=name, shape=shape,
                    equal=r[shape]["max_abs_err"] == 0, l2=r[shape]["l2"],
                    **times(r[shape]))
        if r["max_abs_err"] != 0:
            fail("probes", f"{name} differs from its plain version")
    if pr.returncode != 0:
        fail("probes", f"the runner exited {pr.returncode}")

    from metabuli_tpu_torch.tools import world

    tmp = tempfile.mkdtemp(prefix="metabuli_smoke_")
    try:
        # ---- db
        tax, genomes, rng = world.make_world(tmp, "skew")
        db = os.path.join(tmp, "db")
        info = world.build_db(db, tax, genomes, dev, rows=ROWS)
        say("db", **info)
        if info["rows"] != ROWS:
            fail("db", f"{info['rows']} rows, asked for {ROWS}")
        reads = world.sample_reads(genomes, rng, 65_536, 150, max_mut=2)
        fq = os.path.join(tmp, "reads.fq")
        world.write_fastq(fq, reads)

        # ---- kernels + parity (one classifier, one 8,192-read batch)
        par = ClassifyParams(seq_mode=1, batch_reads=8192)
        clf = Classifier(db, par, device=dev)
        resident = torch.cuda.memory_allocated(dev)
        say("kernels", db_load_s=round(clf.load_s, 3), cap=clf.cap,
            index_rows=clf.dev_index.n,
            resident_gib=round(resident / 2**30, 3))
        metas, rows = next(clf._iter_batches(fq, None))
        timings = {}
        kernel_phase(clf, metas, rows, timings, k1_shapes=[
            ("db_chunk", encode_seqs_padded(
                [g for g, _ in genomes[:world.DB_CHUNK]])),
            ("build_blocks", build_block_batch(tax, genomes[:8], dev)),
            ("long_row", long_row)])
        parity(clf, metas, rows, resident, "parity")
        del clf
        torch.cuda.empty_cache()

        # ---- tiny: the verify skill's two-genome world
        trng = np.random.default_rng(3)
        acgt = np.array(list(b"ACGT"), np.uint8)
        g1 = bytes(trng.choice(acgt, 20000))
        g2 = bytes(trng.choice(acgt, 20000))
        tdir = os.path.join(tmp, "tiny")
        world.write_taxonomy(os.path.join(tdir, "taxonomy"),
                             [(1, 1, "no rank"), (2, 1, "genus"),
                              (4, 2, "species"), (8, 2, "species")],
                             {t: f"Name{t}" for t in (1, 2, 4, 8)})
        from metabuli_tpu_torch.db.taxonomy import Taxonomy

        ttax = Taxonomy.from_dmp(*(os.path.join(tdir, "taxonomy", f) for f in
                                   ("names.dmp", "nodes.dmp", "merged.dmp")))
        world.build_db(os.path.join(tdir, "db"), ttax, [(g1, 4), (g2, 8)],
                       dev)
        treads = ([g1[i * 160:i * 160 + 150] for i in range(60)]
                  + [g2[i * 160:i * 160 + 150] for i in range(60)])
        world.write_fastq(os.path.join(tdir, "reads.fq"), treads)
        s = run_cli(["classify", os.path.join(tdir, "reads.fq"),
                     os.path.join(tdir, "db"), os.path.join(tdir, "out"),
                     "e2e", "--seq-mode", "1", "--batch-reads", "128"])
        report = open(os.path.join(tdir, "out", "e2e_report.tsv")).read()
        split = [ln.split("\t") for ln in report.splitlines()
                 if ln.split("\t")[-1].strip() in ("Name4", "Name8")]
        halves = sorted(float(c[0]) for c in split)
        say("tiny", reads=s["reads"], classified=s["classified"],
            report_pct=halves)
        if s["classified"] != 120 or halves != [50.0, 50.0]:
            fail("tiny", "expected 120 classified reads split 50/50")

        # ---- dbbuild: the CLI's build, updateDB and classify
        build_launches = dbbuild_phase(tmp, tax, genomes, fq, dev)

        # ---- classify: the CLI on 65,536 reads, kernels counted
        s, counts = counted_cli(["classify", fq, db,
                                 os.path.join(tmp, "out"), "smoke",
                                 "--seq-mode", "1", "--batch-reads", "8192"],
                                dev)
        with open(os.path.join(tmp, "out", "smoke_classifications.tsv")) as fh:
            n_lines = sum(1 for ln in fh if not ln.startswith("#"))
        rate = s["reads"] / s["classify_s"]
        say("classify", reads=s["reads"], classified=s["classified"],
            db_load_s=round(s["load_s"], 3),
            reads_per_s=round(rate, 1), classify_s=round(s["classify_s"], 3),
            peak_mem_gib=round(s["peak_mem_gib"], 3), launches=counts)
        say("classify", stage_ms={k: round(v, 3)
                                  for k, v in s["stage_ms"].items()})
        if s["reads"] != 65_536 or n_lines != 65_536:
            fail("classify", f"{s['reads']} reads, {n_lines} output lines")
        if s["classified"] != CLASSIFIED:
            fail("classify", f"{s['classified']} reads classified, "
                             f"expected {CLASSIFIED}")
        if min(counts[name] for name, _, _ in KERNELS) == 0:
            fail("classify", f"a kernel never launched: {counts}")
        smoke_digest = sha256_of(os.path.join(tmp, "out",
                                              "smoke_classifications.tsv"))

        # ---- longread, hosttax, pipeline
        lr_launches = longread_phase(tmp, dev, timings)
        ht_launches = hosttax_phase(tmp, fq, db, smoke_digest, dev)
        pipeline_phase(s)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    probe_keys = ("max_abs_err", "l2", "ms", "loop_ms", "launch_ms",
                  "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "library_loop_ms", "library_launch_ms")
    timings["extract_metamers"].update(
        launches_build=build_launches["build"]["extract_metamers"],
        launches_update=build_launches["update"]["extract_metamers"])
    for name, _, _ in KERNELS:
        timings[name].update(launches_longread=lr_launches[name],
                             launches_hosttax=ht_launches[name])
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], **timings[name]}
        for name, src, rep in KERNELS] + [
        {"name": name, "route": r["route"], "source": r["source"],
         "replaces": r["replaces"], "launches": counts[name],
         **{k: r[k] for k in probe_keys}}
        for name, r in probe_res.items()]}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
