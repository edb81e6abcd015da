"""Smoke run of the PyTorch port's classify path on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

  device    the CUDA device, its capability (must be 9.0), and
            nvidia-smi's name and power limit
  build     nvcc builds the kernels, g++ the native host library
  resources each __global__ function of the library (every template
            instance) from ptxas (-Xptxas -v, csrc/build.py): its kernel,
            registers, static shared memory, stack frame and spill stores
            and loads; fails unless every one of the 16 functions is there
            and none spills
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
  checked   in processes of their own with METABULI_TPU_CUDA_CHECKED=1,
            on the checked library (csrc/check.cuh's bounds checks on, each
            trapping on an index outside its array): every case of
            tests/test_torch_kernels.py (the edge shapes; started before
            the db phase, whose work is on the host, and read after it),
            and metabuli_tpu_torch.tools.checked, which runs every kernel
            of KERNELS and P1-P4 once against its plain version at the
            main path's shapes (the kernels phase's batch, and K2 on its
            2^28-row table, handed over by tools.checked.save_batch);
            fails on a trap, any difference or a case that does not pass
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
            or dispatched another batch, each thread's CPU seconds, and
            the main thread's spans (parse, encode, launch, wait, emit,
            reports, main_stall) in ms a batch
  reduced   the port's CLI ``build --reduced-aa 1`` of dbbuild's library at
            the defaults (K1's reduced variant on the card), then K1
            reduced and K11 (K2's reduced variant) against their plain
            versions on the first 8,192 smoke reads and the reduced
            index (as in kernels), with the reduced index's device bytes
            (bucket records and codon column against the prefix layout
            they replaced, also at PREFIX_BITS), its buckets' group
            counts and, beside K11's bound, the 32-byte sectors a query
            slot touches in either layout, then ``classify`` of the
            65,536 reads against it (the host taxonomer, as the JAX
            package takes for reduced DBs) with its peak device memory:
            the DB, gene-block and classifications digests and the
            classified count must equal the JAX package's on the CPU
            (constants below), K1 and K11 launched
  chunked   the classify phase's DB and reads through the CLI with
            --max-ram 2 (2^28 rows x 28 B = 7 GiB: 4 AA-aligned chunks,
            each built once on the card, kept in pinned host memory and
            copied in per batch): reads/s, the chunk_copy stage,
            peak device memory; the classifications must equal the
            classify phase's, 58,985 classified, and the run's peak above
            the resident chunk's buffers must stay under the --max-ram
            budget

  format1   the port's CLI ``build --kmer-format 1`` of dbbuild's library
            at the defaults (K1's old-format variant on the card), then K1
            format 1 and K2 (its format flag) against their plain versions
            on the first 8,192 smoke reads and the format-1 index, then
            ``classify`` of the 65,536 reads against it on the device
            taxonomer and again with --device-tax 0: the DB and
            classifications digests and the classified count must equal
            the JAX package's on the CPU (constants below), the two runs'
            files must be equal, K1 format 1, K2, K3 and K4 launched;
            reads/s beside dbbuild's classify
  grouping  the port's CLI ``grouping`` (K1 on the card, the groups and
            the propagation on the host) of the 65,536 smoke reads with
            dbbuild's classifications of them (equal to the JAX package's)
            and ``--dbdir`` its updated DB (taxonomy-aware majority LCA),
            then again with ``--common-kmer-db`` (the port's
            ``create-common-kmer-list`` of dbbuild's first DB) and
            ``--neighbor-kmers 12``: each read_groups.tsv's digest and
            group count must equal the JAX package's
  uniref    a synthetic UniRef100 XML dump (tools.world.uniref_inputs:
            32,768 entries of 300 residues in 4,096 UniRef90 and 512
            UniRef50 clusters), ``create-uniref-db`` of it (K12 on
            protein rows, one launch a 2,000,000-residue flush), K12 on
            protein rows against its plain version on the first flush and
            K12 on DNA rows on the first 8,192 DNA queries (150 bp), then
            ``assign_uniref`` of 65,536 DNA reads (back-translated entry
            fragments, 2 % base errors, 10 % random) and of 4,096 protein
            fragments of 100 residues (auto-detected): the DB's diffIdx,
            info and tree digests and both classifications digests must
            equal the JAX package's on the CPU (constants below)
  sharded   the classify phase's DB and reads through the CLI over two
            processes on the one card (--num-processes 2 --db-shards 2
            --dist-backend gloo: each rank builds half the table; with a
            row's shards in two processes the fused step takes the
            all_to_all route, each rank receiving every shard's matches
            of its half of the row's reads through pinned host buffers,
            tailing and writing them): per rank DB load s, shard rows,
            peak device GiB, reads/s, the exchange's MB and ms a batch and
            K1-K4's launches (K2 once a batch a rank); the
            classifications, report and Krona file must equal the
            classify phase's byte for byte
  sharded_mesh  dbbuild's updated DB and the 65,536 reads over four
            processes, a 2 x 2 (data, db) mesh on gloo, once on the fused
            (all_to_all) route and once with METABULI_TPU_DIST_FUSED=0
            (the plain route: the db axis's all_gather, the native host
            assign): the classifications' digest
            and classified count must equal the JAX package's (dbbuild's
            constants)
  nccl      the same with one process through the distributed path on
            NCCL (--num-processes 1 --db-shards 1 --dist-backend nccl):
            NCCL initialises and its collectives run on the card, once a
            batch; the digest must equal the JAX package's

Each spawned rank has a timeout; the first rank that fails, or the
timeout, kills the others and fails the phase. Each CLI run of a phase starts with every launch count at 0 and reads
them when it returns. The last three lines are the kernels' JSON record
(K1-K4, K11, K1 format 1 and K12's two entry points, each with its
launches in each phase's run; ``launches`` is the main run of each: the
classify run for K1-K4, the reduced run for K11, the format1 classify
run for K1 format 1, assign_uniref of the DNA reads for K12 on DNA rows
and create-uniref-db for K12 on protein rows; then the probes P1-P4 with
their launches in the classify run, 0 since they are off the path, and
their loop_ms and library_* times), nvidia-smi's name and power limit,
and the device record.
"""

from __future__ import annotations

import atexit
import contextlib
import io
import json
import os
import re
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
# the reduced phase: the JAX package's DB, gene-block and classifications
# digests and classified count for dbbuild's library built with
# --reduced-aa 1 and the 65,536 reads, printed by
#   JAX_PLATFORMS=cpu python tests/helpers/smoke_reference.py reduced
REDUCED_DB_SHA256 = (
    "29f1738b89353814b83fe7dbea3ad94dd8773514f3832dc5d15079ffeb41e7f0")
REDUCED_BLOCKS_SHA256 = (
    "bd85eb7000f51ce0a9f1caa35227210570b2d8fb66354e2dab2d6aa61467bb05")
REDUCED_CLASSIFIED = 58_985
REDUCED_CLASSIFICATIONS_SHA256 = (
    "ee8328606e1ff07f4ac26e5e0379699a53168f8282a1302b85103f259f2e63a0")
# the chunked phase's --max-ram (GiB) and the chunks it gives the smoke DB
CHUNKED_MAX_RAM = 2
CHUNKED_CHUNKS = 4
# the format1 phase: the JAX package's DB digest, classified count and
# classifications digest for dbbuild's library built with --kmer-format 1
# and the 65,536 reads, printed by
#   JAX_PLATFORMS=cpu python tests/helpers/smoke_reference.py format1
FORMAT1_DB_SHA256 = (
    "ddaa8b0868d5b2e1f5fc9b4bb2e8fdee43c95287169e914a0a182f54b0287194")
FORMAT1_CLASSIFIED = 58_984
FORMAT1_CLASSIFICATIONS_SHA256 = (
    "731474296ae78e408fd952ad90169c3ff0a9062e458989f0026ccb2b29253d79")
# the grouping phase: the JAX package's read_groups.tsv digest and group
# count, plain and with the common-k-mer list, printed by
#   JAX_PLATFORMS=cpu python tests/helpers/smoke_reference.py grouping
GROUPING = {"plain": (52_396, "ed01ab5a96b58af1be1223200f21779bcef9a173"
                              "ad4d20cd15e17bde01c178ee"),
            "common": (55_324, "1a3ffb1f42c828f88f15865209b3469b40a37f55"
                               "7bf859339d1eef5dafb9fb10")}
# the uniref phase: the JAX package's DB digests (diffIdx, info, and the
# tree by tools.world.uniref_tree_sha256) and k-mers, and per query file
# its classified count and classifications digest, printed by
#   JAX_PLATFORMS=cpu python tests/helpers/smoke_reference.py uniref
UNIREF_DB = {"kmers": 5_514_252, "diffIdx": (
    "3bc936513d00001eecdec82b67c5fd12a85aa3d4e07e1382d4bce00461ff5678"),
    "info": "46c58f962a850085518567658dceffb7aa0e2b8908e541b3f383de910f80bd85",
    "unirefTree": (
        "8c9eef9ae93a942d03a35175adb954c0fded69c36c142defbb9ea27360560521")}
UNIREF_QUERIES = {
    "dna": (65_536, 58_616, "c5a0e6c0300ce41d7f82c439e48cafca13449ae3ea6a40"
                            "ff9532240fd2fe0967"),
    "protein": (4_096, 3_687, "0c21a97f684705b90f97418fe10c09fc503465f82e343d"
                              "2cf2990064f9d60b11")}
UNIREF_FLUSH = 2_000_000  # create-uniref-db's residues a K12 launch

# kernel name -> its CUDA functions, as the profiler names them
KERNEL_FUNCTIONS = {"extract_metamers": ["extract_kernel"],
                    "search_scan": ["count_kernel", "write_kernel"],
                    "chain_matches": ["chain_kernel"],
                    "combine_paths": ["combine_kernel"],
                    "search_scan_reduced": ["count_kernel", "write_kernel"],
                    "extract_metamers_f1": ["extract_kernel"],
                    "extract_aa_kmers": ["aa_kmers_kernel"],
                    # 150 bp reads: the warp kernel alone
                    "extract_aa_kmers_dna": ["aa_kmers_dna_warp_kernel"]}

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
    # K11: K2's reduced-alphabet variant, run only on a reduced DB
    ("search_scan_reduced", "metabuli_tpu_torch/csrc/search_scan.cu",
     "metabuli_tpu/ops/hamming.py:119"),
    # K1's old-format variant, run only on a kmer_format 1 DB
    ("extract_metamers_f1", "metabuli_tpu_torch/csrc/extract.cu",
     "metabuli_tpu/ops/encode.py:239"),
    # K12: the UniRef DBs' amino-acid k-mer scanners
    ("extract_aa_kmers", "metabuli_tpu_torch/csrc/aa_kmers.cu",
     "metabuli_tpu/ops/encode.py:342"),
    ("extract_aa_kmers_dna", "metabuli_tpu_torch/csrc/aa_kmers.cu",
     "metabuli_tpu/ops/encode.py:377"),
]
# the probes P1-P4 (tools/probes.py)
KERNEL_PROBES = ("gather_tile_sum", "merge_join_sum", "smoke_double",
                 "stream_sum")
# the kernels of the standard alphabet's classify path
MAIN_KERNELS = ("extract_metamers", "search_scan", "chain_matches",
                "combine_paths")


T0 = time.perf_counter()


def say(phase: str, **kv) -> None:
    """One line of a phase, with the script's seconds so far."""
    print(f"[{phase}] t={time.perf_counter() - T0:.1f} "
          + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


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


def record_kernel(out, phase, name, fn_k, fn_p, cost, shape=None):
    """One kernel against its plain version on the same inputs, into
    ``out`` (kernel -> record; a ``shape`` of a kernel goes under that key
    of its record): equal outputs, the wrapper's and the plain version's
    median ms, the kernels' device time alone (launch_ms) and the bound
    from ``cost(outputs)``, the least bytes of the call. Fails the run on
    any difference. Returns the kernel's outputs."""
    import torch

    from metabuli_tpu_torch.classify import pipeline
    from metabuli_tpu_torch.tools.probes import (LostLaunches, bound,
                                                 device_ms, median_ms)

    got, want = fn_k(), fn_p()
    torch.cuda.synchronize()
    # K2's count of warps that walked again is the kernel's own
    same = lambda r: (r[:-1] if isinstance(r, pipeline.Candidates)
                      else [x for x in r if x is not None])
    err = max_abs_err(same(got), same(want))
    if err != 0:
        fail(phase, f"{name} differs from its plain version ({err})")
    b_ms, b_by = bound(cost(got))
    try:
        l_ms, parts = device_ms(fn_k, KERNEL_FUNCTIONS[name], at_least=b_ms)
        lost = {}
    except LostLaunches as e:
        # H6: every trace lost the launches, a fault of the profiler on
        # that machine and not of the kernel; recorded as probes.py does
        l_ms, parts, lost = None, {}, {"launch_lost": str(e)}
    rec = {"max_abs_err": err, "ms": median_ms(fn_k), "launch_ms": l_ms,
           "plain_ms": median_ms(fn_p), "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": None, **lost}
    if shape is None:
        out[name] = rec
    else:
        out.setdefault(name, {})[shape] = rec
    say(phase, kernel=name, **({} if shape is None else {"shape": shape}),
        equal=err == 0,
        **{k: None if rec[k] is None else round(rec[k], 4)
           for k in ("ms", "launch_ms", "plain_ms", "bound_ms")},
        bound_by=b_by,
        launch_parts_ms=[round(p, 4) for p in parts.values()], **lost)
    return got


def scan_cost(idx, q, W, cap, phase, table_bytes=8):
    """K2's or K11's least bytes on query slots ``q`` (value, valid,
    dna48 or None) of index ``idx``: 17 B per query slot (value, valid,
    dna48; 9 B without dna48), 12 B per valid slot (two prefix entries and
    the grest entry found), 8 B per hit slot (gstart, gend),
    ``table_bytes`` per window row (d48, or K11's 4-byte half of taxdna)
    and 12 B per kept row out (row, slot, payload)."""
    import torch

    from metabuli_tpu_torch.classify import pipeline

    gs, ge, hit = pipeline._search_groups(idx, q[0], q[1])
    n_valid, n_hit = int(q[1].sum()), int(hit.sum())
    n_window = int((torch.minimum(ge, gs + cap) - gs).sum())
    say(phase, slots=q[0].numel(), valid_slots=n_valid, hit_slots=n_hit,
        window_rows=n_window)
    per_slot = 9 if q[2] is None else 17
    return lambda c: (per_slot * q[0].numel() + 12 * n_valid + 8 * n_hit
                      + table_bytes * n_window + 12 * c.row.numel())


def reduced_layout(idx, q, cap, phase) -> None:
    """The reduced index's device bytes in its layout (bucket records,
    codon column) against the prefix layout it replaced, also at
    PREFIX_BITS; its buckets' group counts; and, as a note beside
    scan_cost's bound, the 32-byte sectors a query slot touches in either
    layout, counted from the batch: a record (or prefix[bucket], with
    prefix[bucket + 1] in its sector), a grest sector per lower-bound
    step, gstart and gend where that search finds the group, and the
    window's rows (tword at 4 B a row, or taxdna at 8)."""
    import torch

    from metabuli_tpu_torch.classify import pipeline

    pb, n_rec = idx.prefix_bits, idx.brec.shape[0]
    rec_b = idx.brec.numel() * 4
    word_b = idx.tword.numel() * 4
    before = idx.nbytes - rec_b - word_b + 4 * n_rec
    most = 1 << pipeline.PREFIX_BITS
    prefix = idx.bucket_prefix().to(torch.int64)
    counts = prefix[1:] - prefix[:-1]
    full = int((counts > 0).sum())
    say(phase, prefix_bits=pb, index_bytes=idx.nbytes,
        index_bytes_prefix_layout=before, records_bytes=rec_b,
        codon_column_bytes=word_b, prefix_bytes_replaced=4 * n_rec,
        records_bytes_at_prefix_bits_26=16 * (most + 1),
        prefix_bytes_at_prefix_bits_26=4 * (most + 1),
        buckets=counts.numel(), empty_buckets=counts.numel() - full,
        multi_group_buckets=int((counts > 1).sum()),
        multi_group_share=round(float((counts > 1).sum()) / counts.numel(),
                                4),
        multi_group_share_of_filled=round(
            float((counts > 1).sum()) / max(full, 1), 4))
    value, valid = q[0], q[1]
    rb = 32 - pb
    pi = pipeline.aa_permute(pipeline.aa_key(value, True), True)
    rest, bucket = pi & ((1 << rb) - 1), pi >> rb
    rec = idx.brec[bucket].to(torch.int64)
    x = rec[:, 0] & 0xFFFFFFFF
    rest0, n_b = x & ((1 << rb) - 1), counts[bucket]
    steps = lambda n: torch.ceil(torch.log2(n.double() + 1)).to(torch.int64)
    gs, ge, hit = pipeline._search_groups(idx, value, valid)
    length = torch.minimum(ge - gs, torch.full_like(gs, cap))
    rows = lambda b: torch.where(
        length > 0, (b * (gs + length) - 1) // 32 - (b * gs) // 32 + 1, 0)
    later = valid & (n_b > 1) & (rest > rest0)
    new = (valid.long() + torch.where(later, steps(n_b - 1), 0)
           + 2 * (later & hit).long() + rows(4))
    old = (valid.long() + torch.where(valid & (n_b > 0), steps(n_b), 0)
           + 2 * hit.long() + rows(8))
    n = max(int(value.numel()), 1)
    say(phase, sectors_per_slot_prefix_layout=round(int(old.sum()) / n, 4),
        sectors_per_slot_records=round(int(new.sum()) / n, 4),
        slots_past_first_group=int(later.sum()))


def kernel_phase(clf, reads, out, phase="kernels", shape=None,
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

    dev = clf.device
    codes = torch.from_numpy(reads.codes).to(dev)
    lens = torch.from_numpy(reads.lens).to(dev)
    n = len(reads.lens)
    offs = torch.zeros(n, dtype=torch.int32, device=dev)
    qids = torch.arange(n, dtype=torch.int32, device=dev)

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def record(name, fn_k, fn_p, cost, shape=shape):
        return record_kernel(out, phase, name, fn_k, fn_p, cost, shape)

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
    cand = record("search_scan",
                  lambda: pipeline.search_scan(idx, *q, W, clf.cap),
                  lambda: pipeline.search_scan_plain(idx, *q, W, clf.cap),
                  scan_cost(idx, q, W, clf.cap, phase))
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
    rl = torch.as_tensor(reads.read_lens, device=dev)
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


def dbbuild_phase(tmp, tax, genomes, fq, dev):
    """The CLI's build, updateDB and classify (see the module docstring);
    returns each step's kernel launch counts, the library's list and
    accession map, and the classify run's reads/s."""
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
    return launches, lib, acc, s["reads"] / s["classify_s"]


def reduced_phase(tmp, lib, acc, fq, dev, timings) -> dict:
    """``build --reduced-aa 1`` of dbbuild's library, K1 reduced and K11
    against their plain versions, and ``classify`` of the smoke reads (see
    the module docstring); returns the classify run's launch counts and
    the build's K1 launches."""
    import torch

    from metabuli_tpu_torch.classify import pipeline
    from metabuli_tpu_torch.classify.classifier import Classifier
    from metabuli_tpu_torch.ops import encode
    from metabuli_tpu_torch.params import ClassifyParams

    t0 = time.perf_counter()
    rdb = os.path.join(tmp, "reduced_db")
    s, build_counts = counted_cli(
        ["build", rdb, lib, acc, "--taxonomy-path",
         os.path.join(tmp, "skew_taxonomy"), "--db-date", DB_DATE,
         "--reduced-aa", "1"], dev)
    got = sha256_of(*(os.path.join(rdb, f)
                      for f in ("diffIdx", "info", "taxID_list")))
    say("reduced", step="build", sequences=s["sequences"],
        blocks=s["blocks"], total_kmers=s["total_kmers"],
        unique_kmers=s["unique_kmers"],
        k1_launches=build_counts["extract_metamers"],
        run_s=round(s["run_s"], 3), peak_mem_gib=round(s["peak_mem_gib"], 3),
        stage_s={k: round(v, 3) for k, v in s["stage_s"].items()})
    say("reduced", step="build", db_sha256=got,
        equal_jax=got == REDUCED_DB_SHA256,
        blocks_equal_jax=s["blocks_sha256"] == REDUCED_BLOCKS_SHA256)
    if build_counts["extract_metamers"] == 0:
        fail("reduced", "build: K1 never launched")
    if got != REDUCED_DB_SHA256:
        fail("reduced", "the reduced DB differs from the JAX package's"
             + (" (so do the gene blocks)"
                if s["blocks_sha256"] != REDUCED_BLOCKS_SHA256 else ""))

    # K1 reduced and K11 on the first smoke batch and the reduced index
    clf = Classifier(rdb, ClassifyParams(seq_mode=1, batch_reads=8192),
                     device=dev)
    idx = clf.dev_index
    say("reduced", db_load_s=round(clf.load_s, 3), cap=clf.cap,
        index_rows=idx.n, mode=clf.mode, reduced=idx.reduced)
    if not idx.reduced or clf.mode != "host":
        fail("reduced", "the DB did not load as a reduced index on the host "
                        "taxonomer path")
    reads = next(clf._iter_batches(fq, None))
    codes = torch.from_numpy(reads.codes).to(dev)
    lens = torch.from_numpy(reads.lens).to(dev)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts
                            if t is not None)
    mm = record_kernel(
        timings, "reduced", "extract_metamers",
        lambda: encode.extract_metamers(codes, lens, reduced=True),
        lambda: encode.extract_metamers_plain(codes, lens, reduced=True),
        lambda r: nbytes([codes, lens, *r]), shape="reduced")
    W = mm.value.shape[2]
    q = (mm.value.reshape(-1), mm.valid.reshape(-1), None)
    reduced_layout(idx, q, clf.cap, "reduced")
    record_kernel(
        timings, "reduced", "search_scan_reduced",
        lambda: pipeline.search_scan(idx, *q, W, clf.cap),
        lambda: pipeline.search_scan_plain(idx, *q, W, clf.cap),
        scan_cost(idx, q, W, clf.cap, "reduced", table_bytes=4))
    del clf, mm, q, codes, lens
    torch.cuda.empty_cache()

    out = os.path.join(tmp, "reduced_out")
    s, counts = counted_cli(["classify", fq, rdb, out, "reduced",
                             "--seq-mode", "1", "--batch-reads", "8192"],
                            dev)
    digest = sha256_of(os.path.join(out, "reduced_classifications.tsv"))
    say("reduced", step="classify", reads=s["reads"],
        classified=s["classified"],
        reads_per_s=round(s["reads"] / s["classify_s"], 1),
        classify_s=round(s["classify_s"], 3), db_load_s=round(s["load_s"], 3),
        host_assign_s=round(s["finish_s"], 3),
        peak_mem_gib=round(s["peak_mem_gib"], 3), launches=counts)
    say("reduced", step="classify",
        stage_ms={k: round(v, 3) for k, v in s["stage_ms"].items()})
    say("reduced", classifications_sha256=digest,
        equal_jax=digest == REDUCED_CLASSIFICATIONS_SHA256,
        phase_s=round(time.perf_counter() - t0, 3))
    if counts["extract_metamers"] == 0 or counts["search_scan_reduced"] == 0:
        fail("reduced", f"K1 or K11 never launched: {counts}")
    if s["classified"] != REDUCED_CLASSIFIED:
        fail("reduced", f"{s['classified']} reads classified, the JAX "
                        f"package {REDUCED_CLASSIFIED}")
    if digest != REDUCED_CLASSIFICATIONS_SHA256:
        fail("reduced", "the classifications differ from the JAX package's")
    shutil.rmtree(rdb, ignore_errors=True)
    return counts, build_counts["extract_metamers"]


def chunked_phase(tmp, fq, db, want_digest, dev) -> dict:
    """The classify phase's reads and DB through the CLI with --max-ram
    CHUNKED_MAX_RAM (see the module docstring); returns the launch
    counts."""
    from unittest import mock

    import torch

    from metabuli_tpu_torch.classify.chunked import ChunkedIndex
    from metabuli_tpu_torch.classify.classifier import Classifier

    t0 = time.perf_counter()
    seen = {}
    run = Classifier.classify_file

    def measured(self, *args, **kw):
        # the run's device memory from its first batch on: the chunk
        # buffers resident, the peak above them
        torch.cuda.synchronize(dev)
        seen["resident"] = torch.cuda.memory_allocated(dev)
        seen["index"] = self.dev_index
        torch.cuda.reset_peak_memory_stats(dev)
        s = run(self, *args, **kw)
        seen["peak"] = torch.cuda.max_memory_allocated(dev)
        return s

    out = os.path.join(tmp, "chunked_out")
    with mock.patch.object(Classifier, "classify_file", measured):
        s, counts = counted_cli(
            ["classify", fq, db, out, "chunked", "--seq-mode", "1",
             "--batch-reads", "8192", "--max-ram", str(CHUNKED_MAX_RAM)],
            dev)
    digest = sha256_of(os.path.join(out, "chunked_classifications.tsv"))
    ix = seen["index"]
    budget = CHUNKED_MAX_RAM << 30
    n_chunks = len(ix.bounds) if isinstance(ix, ChunkedIndex) else 1
    chunk_bytes = ix.device_bytes if n_chunks > 1 else 0
    above = seen["peak"] - chunk_bytes
    say("chunked", reads=s["reads"], classified=s["classified"],
        chunks=n_chunks,
        chunk_rows=[b - a for a, b in getattr(ix, "bounds", [])],
        reads_per_s=round(s["reads"] / s["classify_s"], 1),
        classify_s=round(s["classify_s"], 3), db_load_s=round(s["load_s"], 3),
        peak_mem_gib=round(s["peak_mem_gib"], 3),
        run_peak_gib=round(seen["peak"] / 2**30, 3),
        resident_gib=round(seen["resident"] / 2**30, 3),
        chunk_buffers_gib=round(chunk_bytes / 2**30, 3),
        peak_above_chunk_gib=round(above / 2**30, 3),
        budget_gib=CHUNKED_MAX_RAM, launches=counts)
    say("chunked", stage_ms={k: round(v, 3)
                             for k, v in s["stage_ms"].items()},
        chunk_copy_ms_per_batch=round(
            s["stage_ms"].get("chunk_copy", 0.0) / -(-s["reads"] // 8192),
            3),
        equal_classify=digest == want_digest,
        phase_s=round(time.perf_counter() - t0, 3))
    if n_chunks != CHUNKED_CHUNKS:
        fail("chunked", f"{n_chunks} chunks, expected {CHUNKED_CHUNKS}")
    if min(counts[name] for name in MAIN_KERNELS) == 0:
        fail("chunked", f"a kernel never launched: {counts}")
    if s["classified"] != CLASSIFIED:
        fail("chunked", f"{s['classified']} reads classified, expected "
                        f"{CLASSIFIED}")
    if digest != want_digest:
        fail("chunked", "the classifications differ from the classify "
                        "phase's")
    if above >= budget:
        fail("chunked", "the run's peak above the chunk buffers exceeds "
                        "the --max-ram budget")
    return counts


def format1_phase(tmp, lib, acc, fq, dev, timings, dbbuild_rate) -> dict:
    """``build --kmer-format 1`` of dbbuild's library, K1 format 1 and K2
    on its index against their plain versions, and ``classify`` of the
    smoke reads on both taxonomer paths (see the module docstring);
    returns each run's launch counts."""
    import torch

    from metabuli_tpu_torch.classify import pipeline
    from metabuli_tpu_torch.classify.classifier import Classifier
    from metabuli_tpu_torch.ops import encode
    from metabuli_tpu_torch.params import ClassifyParams

    t0 = time.perf_counter()
    fdb = os.path.join(tmp, "format1_db")
    s, counts = {}, {}
    s["build"], counts["build"] = counted_cli(
        ["build", fdb, lib, acc, "--taxonomy-path",
         os.path.join(tmp, "skew_taxonomy"), "--db-date", DB_DATE,
         "--kmer-format", "1"], dev)
    b = s["build"]
    got = sha256_of(*(os.path.join(fdb, f)
                      for f in ("diffIdx", "info", "taxID_list")))
    k1 = counts["build"]["extract_metamers_f1"]
    say("format1", step="build", blocks=b["blocks"],
        unique_kmers=b["unique_kmers"], k1_format1_launches=k1,
        run_s=round(b["run_s"], 3), peak_mem_gib=round(b["peak_mem_gib"], 3),
        stage_s={k: round(v, 3) for k, v in b["stage_s"].items()},
        db_sha256=got, equal_jax=got == FORMAT1_DB_SHA256)
    if k1 == 0 or counts["build"]["extract_metamers"] != 0:
        fail("format1", f"build: K1 format 1 not the extraction: "
                        f"{counts['build']}")
    if got != FORMAT1_DB_SHA256:
        fail("format1", "the format-1 DB differs from the JAX package's")

    # K1 format 1 and K2 with its format flag on the first smoke batch
    clf = Classifier(fdb, ClassifyParams(seq_mode=1, batch_reads=8192),
                     device=dev)
    idx = clf.dev_index
    say("format1", db_load_s=round(clf.load_s, 3), cap=clf.cap,
        index_rows=idx.n, mode=clf.mode, kmer_format=idx.kmer_format)
    if idx.kmer_format != 1 or clf.mode != "device":
        fail("format1", "the DB did not load as a format-1 index on the "
                        "device taxonomer path")
    reads = next(clf._iter_batches(fq, None))
    codes = torch.from_numpy(reads.codes).to(dev)
    lens = torch.from_numpy(reads.lens).to(dev)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    mm = record_kernel(
        timings, "format1", "extract_metamers_f1",
        lambda: encode.extract_metamers(codes, lens, kmer_format=1),
        lambda: encode.extract_metamers_plain(codes, lens, kmer_format=1),
        lambda r: nbytes([codes, lens, *r]))
    W = mm.value.shape[2]
    q = (mm.value.reshape(-1), mm.valid.reshape(-1), mm.dna48.reshape(-1))
    record_kernel(
        timings, "format1", "search_scan",
        lambda: pipeline.search_scan(idx, *q, W, clf.cap),
        lambda: pipeline.search_scan_plain(idx, *q, W, clf.cap),
        scan_cost(idx, q, W, clf.cap, "format1"), shape="format1")
    del clf, mm, q, codes, lens
    torch.cuda.empty_cache()

    digests = {}
    for run, extra in (("classify", []), ("hosttax", ["--device-tax", "0"])):
        out = os.path.join(tmp, f"format1_{run}")
        s[run], counts[run] = counted_cli(
            ["classify", fq, fdb, out, "f1", "--seq-mode", "1",
             "--batch-reads", "8192", *extra], dev)
        r = s[run]
        digests[run] = sha256_of(os.path.join(out, "f1_classifications.tsv"))
        say("format1", step=run, reads=r["reads"], classified=r["classified"],
            reads_per_s=round(r["reads"] / r["classify_s"], 1),
            classify_s=round(r["classify_s"], 3),
            db_load_s=round(r["load_s"], 3),
            peak_mem_gib=round(r["peak_mem_gib"], 3), launches=counts[run])
        say("format1", step=run,
            stage_ms={k: round(v, 3) for k, v in r["stage_ms"].items()})
    rate = s["classify"]["reads"] / s["classify"]["classify_s"]
    say("format1", classifications_sha256=digests["classify"],
        equal_jax=digests["classify"] == FORMAT1_CLASSIFICATIONS_SHA256,
        hosttax_equal=digests["hosttax"] == digests["classify"],
        reads_per_s_over_dbbuild=round(rate / dbbuild_rate, 3),
        phase_s=round(time.perf_counter() - t0, 3))
    c = counts["classify"]
    if min(c[n] for n in ("extract_metamers_f1", "search_scan",
                          "chain_matches", "combine_paths")) == 0:
        fail("format1", f"a kernel never launched: {c}")
    if s["classify"]["classified"] != FORMAT1_CLASSIFIED:
        fail("format1", f"{s['classify']['classified']} reads classified, "
                        f"the JAX package {FORMAT1_CLASSIFIED}")
    if digests["classify"] != FORMAT1_CLASSIFICATIONS_SHA256:
        fail("format1", "the classifications differ from the JAX package's")
    if digests["hosttax"] != digests["classify"]:
        fail("format1", "--device-tax 0 differs from the device taxonomer")
    shutil.rmtree(fdb, ignore_errors=True)
    return counts


def grouping_phase(tmp, fq, dev) -> dict:
    """``grouping`` of the smoke reads with dbbuild's classifications,
    plain and with a common-k-mer list (see the module docstring);
    returns each run's launch counts."""
    t0 = time.perf_counter()
    cls = os.path.join(tmp, "updated_out", "updated_classifications.tsv")
    common = os.path.join(tmp, "common_kmers")
    s, counts = counted_cli(["create-common-kmer-list",
                             os.path.join(tmp, "built_db"), common], dev)
    say("grouping", step="common_kmers", kmers=s["kmers"],
        run_s=round(s["run_s"], 3))
    runs = {}
    for run, extra in (("plain", []), ("common", [
            "--common-kmer-db", common, "--neighbor-kmers", "12"])):
        out = os.path.join(tmp, f"grouping_{run}")
        s, runs[run] = counted_cli(
            ["grouping", fq, cls, out, "--dbdir",
             os.path.join(tmp, "updated_db"), *extra], dev)
        digest = sha256_of(os.path.join(out, "read_groups.tsv"))
        groups, want = GROUPING[run]
        say("grouping", step=run, reads=s["reads"], groups=s["groups"],
            rescued=s["rescued"], run_s=round(s["run_s"], 3),
            reads_per_s=round(s["reads"] / s["run_s"], 1),
            k1_launches=runs[run]["extract_metamers"],
            peak_mem_gib=round(s["peak_mem_gib"], 3),
            read_groups_sha256=digest, equal_jax=digest == want)
        if runs[run]["extract_metamers"] == 0:
            fail("grouping", f"{run}: K1 never launched")
        if s["groups"] != groups or digest != want:
            fail("grouping", f"{run}: the groups differ from the JAX "
                             "package's")
    say("grouping", phase_s=round(time.perf_counter() - t0, 3))
    return runs


def uniref_phase(tmp, dev, timings) -> dict:
    """``create-uniref-db`` and ``assign_uniref`` of the synthetic UniRef
    world, and K12's two entry points against their plain versions (see
    the module docstring); returns each run's launch counts."""
    import torch

    from metabuli_tpu_torch.io import fasta
    from metabuli_tpu_torch.ops import encode
    from metabuli_tpu_torch.ops.genetic_code import encode_seqs_padded
    from metabuli_tpu_torch.tools import world

    t0 = time.perf_counter()
    xml, dna, prot, seqs = world.uniref_inputs(os.path.join(tmp, "uniref"))
    udb = os.path.join(tmp, "uniref_db")
    runs = {}
    s, runs["db"] = counted_cli(["create-uniref-db", xml, udb], dev)
    got = {"diffIdx": sha256_of(os.path.join(udb, "diffIdx")),
           "info": sha256_of(os.path.join(udb, "info")),
           "unirefTree": world.uniref_tree_sha256(
               os.path.join(udb, "unirefTree"))}
    say("uniref", step="db", entries=len(seqs), clusters=s["clusters"],
        kmers=s["kmers"], run_s=round(s["run_s"], 3),
        k12_launches=runs["db"]["extract_aa_kmers"],
        peak_mem_gib=round(s["peak_mem_gib"], 3),
        equal_jax={k: v == UNIREF_DB[k] for k, v in got.items()})
    if runs["db"]["extract_aa_kmers"] == 0:
        fail("uniref", "create-uniref-db: K12 never launched")
    if s["kmers"] != UNIREF_DB["kmers"] or any(
            v != UNIREF_DB[k] for k, v in got.items()):
        fail("uniref", "the UniRef DB differs from the JAX package's")

    # K12 on the DB's first flush and on the first 8,192 DNA queries
    n, total = 0, 0
    while total < UNIREF_FLUSH:
        total += len(seqs[n])
        n += 1
    codes, lens = encode.encode_aa_seqs_padded(seqs[:n], 512)
    codes = torch.from_numpy(codes).to(dev)
    lens = torch.from_numpy(lens).to(dev)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    say("uniref", shape="flush", rows=n, residues=total,
        slots=codes.shape[0] * (codes.shape[1] - encode.AA_K + 1))
    record_kernel(timings, "uniref", "extract_aa_kmers",
                  lambda: encode.extract_aa_kmers(codes, lens),
                  lambda: encode.extract_aa_kmers_plain(codes, lens),
                  lambda r: nbytes([codes, lens, *r]))
    reads = [r.seq for _, r in zip(range(8192), fasta.read_records(dna))]
    dcodes, dlens = encode_seqs_padded(reads)
    dcodes = torch.from_numpy(dcodes).to(dev)
    dlens = torch.from_numpy(dlens).to(dev)
    say("uniref", shape="reads", rows=len(reads), bases=dcodes.shape[1])
    record_kernel(timings, "uniref", "extract_aa_kmers_dna",
                  lambda: encode.extract_aa_kmers_dna(dcodes, dlens),
                  lambda: encode.extract_aa_kmers_dna_plain(dcodes, dlens),
                  lambda r: nbytes([dcodes, dlens, *r]))
    del codes, lens, dcodes, dlens
    torch.cuda.empty_cache()

    for run, path in (("dna", dna), ("protein", prot)):
        out = os.path.join(tmp, f"uniref_{run}")
        s, runs[run] = counted_cli(["assign_uniref", path, udb, out], dev)
        digest = sha256_of(os.path.join(out, "uniref_classifications.tsv"))
        queries, classified, want = UNIREF_QUERIES[run]
        say("uniref", step=run, queries=s["queries"],
            classified=s["classified"], run_s=round(s["run_s"], 3),
            queries_per_s=round(s["queries"] / s["run_s"], 1),
            launches={k: v for k, v in runs[run].items() if v},
            peak_mem_gib=round(s["peak_mem_gib"], 3),
            classifications_sha256=digest, equal_jax=digest == want)
        k12 = "extract_aa_kmers_dna" if run == "dna" else "extract_aa_kmers"
        if runs[run][k12] == 0:
            fail("uniref", f"{run}: K12 never launched")
        if (s["queries"], s["classified"], digest) != (queries, classified,
                                                       want):
            fail("uniref", f"{run}: the classifications differ from the JAX "
                           "package's")
    say("uniref", phase_s=round(time.perf_counter() - t0, 3))
    shutil.rmtree(udb, ignore_errors=True)
    return runs


def parity(clf, reads, resident, phase) -> None:
    """One batch through the kernels and through the plain versions: the
    classification lines must be identical."""
    import torch

    dev = clf.device
    lines, peak = {}, {}
    for plain in (False, True):
        torch.cuda.reset_peak_memory_stats(dev)
        res = clf.classify_batch(reads, plain=plain)
        peak[plain] = torch.cuda.max_memory_allocated(dev) - resident
        lines[plain] = [clf.reporter.classification_row(name, rc, rl)
                        for name, rc, rl in zip(
                            reads.names, res, reads.read_lens.tolist())]
    same = lines[False] == lines[True]
    say(phase, reads=len(reads.names),
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
    auto = next(clf._iter_batches(fq, None))
    torch.cuda.reset_peak_memory_stats(dev)
    clf.classify_batch(auto)
    auto_peak = torch.cuda.max_memory_allocated(dev) - resident
    say("longread", auto_reads=len(auto.names),
        auto_bases=int(auto.lens.sum()),
        batch_reads=clf.par.batch_reads, batch_bases=clf.batch_bases,
        auto_batch_peak_gib=round(auto_peak / 2**30, 3),
        budget_gib=round(clf.batch_budget / 2**30, 3))
    if auto_peak > clf.batch_budget:
        fail("longread", "an automatic batch took more device memory than "
                         "its budget")
    # the CLI run's first batch
    reads = auto.take(0, LONGREAD_BATCH)
    kernel_phase(clf, reads, timings, phase="longread", shape="longread")
    parity(clf, reads, resident, "longread")
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
            or min(counts[name] for name in MAIN_KERNELS) == 0):
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
    dispatched another batch, each thread's CPU seconds, and the main
    thread's spans (``stage_ms`` parse ... reports, main_stall) a
    batch."""
    say("pipeline", classified=s["classified"],
        classify_s=round(s["classify_s"], 3),
        finish_s=round(s["finish_s"], 3),
        overlap_s=round(s["finish_overlap_s"], 3),
        overlap_share=round(s["finish_overlap_s"] / max(s["finish_s"],
                                                        1e-9), 3),
        finish_cpu_s=round(s["finish_cpu_s"], 3),
        main_cpu_s=round(s["main_cpu_s"], 3), batches=s["batches"])
    say("pipeline", main_ms_per_batch={
        k: round(s["stage_ms"][k] / s["batches"], 3)
        for k in ("parse", "encode", "launch", "wait", "emit", "reports",
                  "main_stall")})
    if s["classified"] != CLASSIFIED:
        fail("pipeline", f"{s['classified']} reads classified")


# ------------------------------------------------------------ item 13
def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spawn_ranks(tmp, phase, argvs, timeout, env=None) -> list:
    """One process per argv (``python -m ...`` from the repo root), all
    started together, their output in files. The first that fails, or the
    timeout, kills the rest and fails the phase. Returns each rank's last
    JSON line of output (a CLI run's summary), or None."""
    outs = [open(os.path.join(tmp, f"{phase}_rank{i}.{k}"), "w+")
            for i in range(len(argvs)) for k in ("out", "err")]
    procs = [subprocess.Popen([sys.executable, "-m", *a], cwd=ROOT,
                              stdout=outs[2 * i], stderr=outs[2 * i + 1],
                              env={**os.environ, **(env or {})})
             for i, a in enumerate(argvs)]
    end = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if (time.monotonic() > end
                    or any(p.poll() not in (None, 0) for p in procs)):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        rcs = [p.wait() for p in procs]
    res = []
    for i, rc in enumerate(rcs):
        fh_out, fh_err = outs[2 * i], outs[2 * i + 1]
        fh_out.seek(0)
        fh_err.seek(0)
        lines = [ln for ln in fh_out.read().splitlines()
                 if ln.startswith("{")]
        if rc != 0:
            sys.stderr.write(f"[{phase}] rank {i} exited {rc}:\n"
                             + fh_err.read()[-3000:])
        res.append(json.loads(lines[-1]) if lines else None)
        fh_out.close()
        fh_err.close()
    if any(rcs):
        fail(phase, f"ranks exited {rcs} (timeout {timeout} s)")
    return res


def rank_lines(phase, ranks) -> None:
    """Each CLI rank's summary: DB load, shard rows, peak device GiB,
    reads/s, the gather's MB and ms a batch, the kernels' launches."""
    for s in ranks:
        n = max(1, s["gathers"])
        say(phase, rank=s["rank"], mesh=s["mesh"], backend=s["backend"],
            route=s["route"],
            db_load_s=round(s["load_s"], 3), shard_rows=s["shard_rows"],
            peak_mem_gib=round(s.get("peak_mem_gib", 0.0), 3),
            reads_per_s=round(s["reads"] / s["classify_s"], 1),
            classify_s=round(s["classify_s"], 3), gathers=s["gathers"],
            gather_mb_per_batch=round(s["gather_bytes"] / n / 1e6, 3),
            gather_ms_per_batch=round(s["gather_ms"] / n, 3),
            finish_s=round(s["finish_s"], 3), launches=s["launches"])
        say(phase, rank=s["rank"],
            stage_ms={k: round(v, 3) for k, v in s["stage_ms"].items()})


def dist_argv(fq, db, out, job, world, shards, backend, port, rank):
    return ["metabuli_tpu_torch.cli", "classify", fq, db, out, job,
            "--seq-mode", "1", "--batch-reads", "8192", "--num-processes",
            str(world), "--process-id", str(rank), "--coordinator",
            f"localhost:{port}", "--db-shards", str(shards),
            "--dist-backend", backend]


def sharded_phase(tmp, fq, db) -> list:
    """The classify phase's DB and reads over two gloo ranks on the one
    card (see the module docstring); returns each rank's launch counts."""
    t0 = time.perf_counter()
    out = os.path.join(tmp, "sharded_out")
    port = free_port()
    ranks = spawn_ranks(tmp, "sharded", [
        dist_argv(fq, db, out, "sharded", 2, 2, "gloo", port, i)
        for i in range(2)], timeout=480)
    rank_lines("sharded", ranks)
    same = {kind: sha256_of(os.path.join(out, f"sharded_{kind}"))
            == sha256_of(os.path.join(tmp, "out", f"smoke_{kind}"))
            for kind in ("classifications.tsv", "report.tsv", "krona.html")}
    say("sharded", classified=ranks[0]["classified"], equal_classify=same,
        phase_s=round(time.perf_counter() - t0, 3))
    for s in ranks:
        if s["route"] != "alltoall":
            fail("sharded", f"rank {s['rank']}: the {s['route']} route")
        if min(s["launches"].get(k, 0) for k in MAIN_KERNELS) == 0:
            fail("sharded", f"rank {s['rank']}: a kernel never launched")
        if s["launches"]["search_scan"] != s["gathers"]:
            fail("sharded", f"rank {s['rank']}: K2 not once a batch")
    if ranks[0]["classified"] != CLASSIFIED or not all(same.values()):
        fail("sharded", "the files differ from the classify phase's")
    return [s["launches"] for s in ranks]


def sharded_mesh_phase(tmp, fq) -> dict:
    """dbbuild's updated DB over a 2 x 2 gloo mesh, fused and plain (see
    the module docstring); returns each run's per-rank launch counts."""
    t0 = time.perf_counter()
    udb = os.path.join(tmp, "updated_db")
    runs = {}
    for run, env in (("fused", {}), ("plain",
                                     {"METABULI_TPU_DIST_FUSED": "0"})):
        out = os.path.join(tmp, f"mesh_{run}")
        port = free_port()
        ranks = spawn_ranks(tmp, f"sharded_mesh_{run}", [
            dist_argv(fq, udb, out, "mesh", 4, 2, "gloo", port, i)
            for i in range(4)], timeout=300, env=env)
        rank_lines(f"sharded_mesh_{run}", ranks)
        digest = sha256_of(os.path.join(out, "mesh_classifications.tsv"))
        say("sharded_mesh", run=run, classified=ranks[0]["classified"],
            classifications_sha256=digest,
            equal_jax=digest == UPDATED_CLASSIFICATIONS_SHA256)
        if (ranks[0]["classified"] != UPDATED_CLASSIFIED
                or digest != UPDATED_CLASSIFICATIONS_SHA256):
            fail("sharded_mesh", f"{run}: the classifications differ from "
                                 "the JAX package's")
        kernels = MAIN_KERNELS if run == "fused" else MAIN_KERNELS[:2]
        for s in ranks:
            if min(s["launches"].get(k, 0) for k in kernels) == 0:
                fail("sharded_mesh", f"{run} rank {s['rank']}: a kernel "
                                     "never launched")
        runs[run] = [s["launches"] for s in ranks]
    say("sharded_mesh", phase_s=round(time.perf_counter() - t0, 3))
    return runs


def nccl_phase(tmp, fq) -> list:
    """One process through the distributed path on NCCL (see the module
    docstring); returns its launch counts."""
    t0 = time.perf_counter()
    out = os.path.join(tmp, "nccl_out")
    (s,) = spawn_ranks(tmp, "nccl", [dist_argv(
        fq, os.path.join(tmp, "updated_db"), out, "nccl", 1, 1, "nccl",
        free_port(), 0)], timeout=300)
    rank_lines("nccl", [s])
    digest = sha256_of(os.path.join(out, "nccl_classifications.tsv"))
    say("nccl", classified=s["classified"], classifications_sha256=digest,
        equal_jax=digest == UPDATED_CLASSIFICATIONS_SHA256,
        phase_s=round(time.perf_counter() - t0, 3))
    if s["backend"] != "nccl" or s["gathers"] != s["launches"].get(
            "search_scan", -1):
        fail("nccl", f"the NCCL collectives did not run once a batch: {s}")
    if digest != UPDATED_CLASSIFICATIONS_SHA256:
        fail("nccl", "the classifications differ from the JAX package's")
    return [s["launches"]]


# ------------------------------------------------------------------- main
def checked_env() -> dict:
    from metabuli_tpu_torch.csrc import build

    return dict(os.environ, **{build.CHECKED_ENV: "1"})


def start_checked_tests(log: str) -> subprocess.Popen:
    """Every case of tests/test_torch_kernels.py (the edge shapes) on the
    checked library, in a process of its own (a trap ends the CUDA
    context), started while the smoke DB is built and written (host
    work); output to ``log``. Killed at exit if still running."""
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pytest", "-q", "--noconftest",
             "-p", "no:cacheprovider", "tests/test_torch_kernels.py"],
            cwd=ROOT, stdout=fh, stderr=subprocess.STDOUT, env=checked_env())
    atexit.register(lambda: proc.poll() is None and (proc.kill(),
                                                     proc.wait()))
    proc.t0 = time.perf_counter()
    return proc


def finish_checked_tests(proc: subprocess.Popen, log: str) -> None:
    try:
        proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        fail("checked", "tests/test_torch_kernels.py ran past 600 s")
    with open(log) as fh:
        out = fh.read()
    tail = out.strip().splitlines()[-1:] or [""]
    counts = {k: int(v) for v, k in
              re.findall(r"(\d+) (passed|failed|skipped|errors?)", tail[0])}
    say("checked", edge_cases=tail[0], passed=counts.get("passed", 0),
        tests_s=round(time.perf_counter() - proc.t0, 3))
    if proc.returncode != 0 or set(counts) != {"passed"}:
        sys.stderr.write(out[-6000:])
        fail("checked", f"tests/test_torch_kernels.py on the checked "
                        f"library: {tail[0]}")


def checked_phase(batch_dir: str) -> None:
    """tools/checked.py on the checked library, in a process of its own:
    every kernel once on the kernels phase's batch and table."""
    t0 = time.perf_counter()
    ck = subprocess.run([sys.executable, "-m",
                         "metabuli_tpu_torch.tools.checked", batch_dir],
                        cwd=ROOT, capture_output=True, text=True,
                        timeout=600, env=checked_env())
    sys.stderr.write(ck.stderr[-4000:])
    try:
        ck_res = json.loads(ck.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        sys.stderr.write(ck.stdout[-4000:])
        fail("checked", f"the runner exited {ck.returncode}")
    for line in ck.stdout.splitlines():
        if line.startswith("[checked] search_scan"):
            say("checked", scan=line.split(" ", 1)[1])
    say("checked", nvcc_s=round(ck_res["nvcc_s"], 3),
        main_path_checks=ck_res["main_path_checks"],
        equal=sum(r["equal"] for r in ck_res["records"]),
        kernels=sorted({r["kernel"] for r in ck_res["records"]}),
        run_s=round(ck_res["s"], 3),
        phase_s=round(time.perf_counter() - t0, 3))
    if ck.returncode != 0 or not ck_res["checked"]:
        sys.stderr.write(ck.stdout[-4000:])
        fail("checked", f"the runner exited {ck.returncode}: "
                        + str([r for r in ck_res["records"]
                               if not r["equal"]]))
    missing = ({name for name, _, _ in KERNELS} | set(KERNEL_PROBES)) - {
        r["kernel"] for r in ck_res["records"]}
    if missing:
        fail("checked", f"not run: {sorted(missing)}")


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

    # ---- resources: every __global__ function, from ptxas
    res = build.resources()
    for k in res["kernels"]:
        say("resources", kernel=k["name"], label=k["label"],
            source=k["source"], registers=k["registers"], smem=k["smem"],
            stack=k["stack"], spill_stores=k["spill_stores"],
            spill_loads=k["spill_loads"])
    functions = {k["kernel"] for k in res["kernels"]}
    spills = [k["name"] for k in res["kernels"]
              if k["spill_stores"] or k["spill_loads"]]
    say("resources", functions=len(functions), compiled=len(res["kernels"]),
        spilling=len(spills))
    if functions != set(build.KERNEL_LABELS):
        fail("resources", f"functions {sorted(functions)}, expected "
                          f"{sorted(build.KERNEL_LABELS)}")
    if spills:
        fail("resources", f"spills in {spills}")

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

    from metabuli_tpu_torch.tools import checked, world

    tmp = tempfile.mkdtemp(prefix="metabuli_smoke_")
    try:
        # ---- checked, the edge shapes, beside the db phase's host work
        tests_log = os.path.join(tmp, "checked_tests.log")
        tests = start_checked_tests(tests_log)

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
        finish_checked_tests(tests, tests_log)

        # ---- kernels + parity (one classifier, one 8,192-read batch)
        par = ClassifyParams(seq_mode=1, batch_reads=8192)
        clf = Classifier(db, par, device=dev)
        resident = torch.cuda.memory_allocated(dev)
        say("kernels", db_load_s=round(clf.load_s, 3), cap=clf.cap,
            index_rows=clf.dev_index.n,
            resident_gib=round(resident / 2**30, 3))
        reads = next(clf._iter_batches(fq, None))
        timings = {}
        kernel_phase(clf, reads, timings, k1_shapes=[
            ("db_chunk", encode_seqs_padded(
                [g for g, _ in genomes[:world.DB_CHUNK]])),
            ("build_blocks", build_block_batch(tax, genomes[:8], dev)),
            ("long_row", long_row)])
        parity(clf, reads, resident, "parity")
        checked_dir = os.path.join(tmp, "checked")
        checked.save_batch(checked_dir, clf, reads)
        del clf
        torch.cuda.empty_cache()

        # ---- checked: every kernel once at the main path's shapes
        checked_phase(checked_dir)

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
        build_launches, lib, acc, dbbuild_rate = dbbuild_phase(
            tmp, tax, genomes, fq, dev)

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
        if min(counts[name] for name in MAIN_KERNELS) == 0:
            fail("classify", f"a kernel never launched: {counts}")
        smoke_digest = sha256_of(os.path.join(tmp, "out",
                                              "smoke_classifications.tsv"))

        # ---- longread, hosttax, pipeline, reduced, chunked
        lr_launches = longread_phase(tmp, dev, timings)
        ht_launches = hosttax_phase(tmp, fq, db, smoke_digest, dev)
        pipeline_phase(s)
        red_launches, red_build_k1 = reduced_phase(tmp, lib, acc, fq, dev,
                                                   timings)
        ch_launches = chunked_phase(tmp, fq, db, smoke_digest, dev)

        # ---- format1, grouping, uniref
        f1_launches = format1_phase(tmp, lib, acc, fq, dev, timings,
                                    dbbuild_rate)
        grp_launches = grouping_phase(tmp, fq, dev)
        uni_launches = uniref_phase(tmp, dev, timings)

        # ---- item 13: sharded, sharded_mesh, nccl
        rank_runs = {"sharded": sharded_phase(tmp, fq, db)}
        mesh_runs = sharded_mesh_phase(tmp, fq)
        rank_runs.update({"sharded_mesh": mesh_runs["fused"],
                          "sharded_mesh_plain": mesh_runs["plain"],
                          "nccl": nccl_phase(tmp, fq)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    probe_keys = ("max_abs_err", "l2", "ms", "loop_ms", "launch_ms",
                  "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "library_loop_ms", "library_launch_ms")
    timings["extract_metamers"].update(
        launches_build=build_launches["build"]["extract_metamers"],
        launches_update=build_launches["update"]["extract_metamers"],
        launches_reduced_build=red_build_k1)
    timings["extract_metamers_f1"].update(
        launches_format1_build=f1_launches["build"]["extract_metamers_f1"])
    phase_runs = {"classify": counts, "longread": lr_launches,
                  "hosttax": ht_launches, "reduced": red_launches,
                  "chunked": ch_launches,
                  "format1": f1_launches["classify"],
                  "format1_hosttax": f1_launches["hosttax"],
                  "grouping": grp_launches["plain"],
                  "grouping_common": grp_launches["common"],
                  "uniref_db": uni_launches["db"],
                  "uniref_dna": uni_launches["dna"],
                  "uniref_protein": uni_launches["protein"]}
    for name, _, _ in KERNELS:
        timings[name].update({f"launches_{phase}": run[name]
                              for phase, run in phase_runs.items()})
    # the multi-process phases: one count per rank
    for name in MAIN_KERNELS:
        timings[name].update({f"launches_{phase}": [r.get(name, 0)
                                                    for r in runs]
                              for phase, runs in rank_runs.items()})
    # the main path of each kernel: K11's is the reduced run, K1 format
    # 1's the format1 classify run, K12's create-uniref-db (protein rows)
    # and assign_uniref of the DNA reads
    main_run = {name: counts for name, _, _ in KERNELS} | {
        "search_scan_reduced": red_launches,
        "extract_metamers_f1": f1_launches["classify"],
        "extract_aa_kmers": uni_launches["db"],
        "extract_aa_kmers_dna": uni_launches["dna"]}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": main_run[name][name], **timings[name]}
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
