"""Classification orchestrator: file -> batches -> device -> reports.

Counterpart of ``metabuli_tpu.classify.classifier`` (`Classifier.cpp:44-164`):
reads stream in batches (short reads, pairs, or long reads and contigs
with ``--seq-mode 3``); each batch runs the match core on the device and
then one of the reference package's three taxonomer paths, chosen once
and kept as ``taxonomer``, whose ``send`` ends the device stages and
whose ``drain`` finishes the batch on the host:

  device  (the default, ``DeviceTaxonomer``) the taxonomer stages on the
          device, the native ``taxonomer_finish`` on the host;
  host    (``--device-tax 0``, ``HostTaxonomer``) the sorted matches to
          the host, the native ``taxonomer_assign``;
  log     (``--print-log``, ``LogTaxonomer``) the sorted matches to the
          host, the Python ``Taxonomer`` per read, which prints each
          species' match paths.

Batches run in a depth-2 pipeline, as in the reference package: the main
thread parses, encodes, uploads and dispatches batch i+1 while one worker
thread finishes batch i on the host; batches are written in order, each
from its result columns (``BatchResult``) by the native line writer
(``io/line_writer.py``), with no Python object a read on the device
path. Stages are sized exactly on the device, so there is no warm-up
batch and no retry. A ragged batch (long reads, contigs) goes to the
match core in blocks of rows sorted by length (``pipeline.length_blocks``),
each gathered on the host and uploaded to its own longest row; a batch
of one block (e.g. 8,192 pairs of 150 bp) goes up as the reader made it.

The reduced alphabet (``--reduced-aa 1``) takes the host path (or the log
path under ``--print-log``) whatever ``--device-tax`` says, as in the
reference package: the device taxonomer's stages assume the standard
codon layout. A DB over ``--max-ram``, or whose index build would not fit
the card's free memory, streams through the card in AA-aligned chunks
(``chunked.ChunkedIndex``).
"""

from __future__ import annotations

import itertools
import os
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import NamedTuple

import numpy as np
import torch

from ..csrc import build
from ..db.index import MetamerIndex
from ..io.batch_reader import BatchReader, ReadBatch
from ..io.line_writer import LineWriter
from ..io.report import Reporter
from ..params import ClassifyParams
from .batch_result import BatchReads, BatchResult
from .chunked import BYTES_PER_ROW, ChunkedIndex, build_chunks
from .device_taxonomer import DeviceTaxonomer
from .host_taxonomers import HostTaxonomer, LogTaxonomer
from .pipeline import (Block, HostCopy, build_dev_index, classify_blocks,
                       length_blocks)
from .taxonomer import ReadClassification, TaxonomerParams

# device bytes per 150 bp read of a batch above the resident index: 0.346
# GiB for 8,192 reads, measured on the same card and DB; an automatic
# batch also ends at these bytes per base (long reads, contigs)
BATCH_BYTES_PER_READ = 45_400
BATCH_READ_LEN = 150


def mask_rows(reads: ReadBatch, prob: float) -> np.ndarray:
    """``--mask-mode 1``: a copy of the batch's code matrix with each row's
    low-complexity regions (tantan, ``ops.mask``) set to the invalid
    code."""
    from ..ops.mask import mask_codes

    codes = reads.codes.copy()
    for r_i, n in enumerate(reads.lens.tolist()):
        codes[r_i, :n] = mask_codes(codes[r_i, :n], prob)
    return codes


def _rf_open(name: str, args: tuple):
    rec = torch.profiler.record_function(name)
    rec.__enter__()
    return rec


def _rf_close(rec):
    rec.__exit__(None, None, None)


# A span's profiler range: the user-scope range that record_function
# opens, entered without a dispatcher op (which can hand the interpreter
# lock to another thread) and with the batch's id as an int input; a
# torch without these private entry points gets record_function's range,
# without the id.
if all(hasattr(torch.autograd, f"_record_function_with_args_{e}")
       for e in ("enter", "exit")):
    _enter_range = torch.autograd._record_function_with_args_enter
    _close_range = torch.autograd._record_function_with_args_exit

    def _open_range(name: str, args: tuple):
        return _enter_range(name, *args)
else:
    _open_range, _close_range = _rf_open, _rf_close


class StageTimer:
    """Per-stage wall time of the batches, from CUDA events on the card
    (host clock on the CPU); ``ms`` accumulates over the run. A batch's
    marks are read once its device work is done (``resolve``), so timing
    adds no synchronisation to the dispatch. The host phases around them
    are ``span``s: host-clock ms in the same ``ms``, and ranges on the
    profiler's timeline."""

    # the main thread's phases whose stall goes to ms["main_stall"]
    STALLED = ("parse", "encode", "launch", "emit")

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.ms: dict[str, float] = {}
        self._marks: list = []

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self):
        self._marks = [("start", self._now())]

    def mark(self, name: str):
        self._marks.append((name, self._now()))

    def stop(self) -> list:
        """Close the batch's marks and return them for ``resolve``."""
        marks, self._marks = self._marks, []
        return marks

    def resolve(self, marks: list):
        if self.cuda and marks:
            marks[-1][1].synchronize()
        for (_, a), (name, b) in zip(marks, marks[1:]):
            self.add(name, a.elapsed_time(b) if self.cuda else (b - a) * 1e3)

    def add(self, name: str, ms: float):
        self.ms[name] = self.ms.get(name, 0.0) + ms

    @contextmanager
    def span(self, name: str, batch: int | None = None, *, ms: bool = True):
        """A ``metabuli.<name>`` range on the profiler's host timeline, on
        the device activities' clock, whose input is the batch's id (a
        trace shows it where the profiler records inputs); with no
        profiler on it costs a range's enter and exit. Adds the span's
        host-clock ms to ``ms[name]`` (``ms=False``: the range alone)
        and, for a ``STALLED`` phase, its wall time less this thread's
        CPU time to ``ms["main_stall"]``: time the thread neither
        computed nor meant to wait (the interpreter lock held by another
        thread, the host's preemption, a read from the disk, a device
        wait the CUDA runtime sleeps through)."""
        rec = _open_range(f"metabuli.{name}",
                          () if batch is None else (batch,))
        t, cpu = time.perf_counter(), time.thread_time()
        try:
            yield
        finally:
            wall = time.perf_counter() - t
            if name in self.STALLED:
                self.add("main_stall",
                         max(0.0, wall - (time.thread_time() - cpu)) * 1e3)
            if ms:
                self.add(name, wall * 1e3)
            _close_range(rec)


class Job(NamedTuple):
    """One dispatched batch: its reads' names, the copy of its device
    results in flight to the host, its reads' lengths, its stage marks,
    the run's index of its first read and the batch's id (its index in the
    run)."""

    names: list
    host: HostCopy
    read_lens: np.ndarray
    marks: list
    first: int = 0
    batch: int = 0


def overlap_s(a, b) -> float:
    """Seconds in which two lists of sorted, disjoint (start, end) spans
    overlap."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class Classifier:
    def __init__(self, db_dir: str, params: ClassifyParams, device="cuda"):
        self.device = build.device(device)
        self.par = params
        self.timer = StageTimer(self.device)
        with self.timer.span("load.decode"):
            self.index = MetamerIndex.load(db_dir)
        # the rest of the load: the DB's parameters, the taxonomer's
        # tables and the device index
        with self.timer.span("load.index"):
            dbp = self.index.params
            # db.parameters override user flags (`common.cpp:88-133`)
            params.syncmer = dbp.syncmer
            params.smer_len = dbp.smer_len
            params.kmer_format = dbp.kmer_format
            params.reduced_aa = dbp.reduced_aa
            params.skip_redundancy = dbp.skip_redundancy
            if dbp.accession_level == 0 and params.accession_level == 1:
                params.accession_level = 0
            reduced = bool(params.reduced_aa)
            self.taxonomy = self.index.taxonomy
            tp = TaxonomerParams(
                min_score=params.min_score,
                min_sp_score=params.min_sp_score,
                min_cons_cnt=params.min_cons_cnt,
                min_cons_cnt_euk=params.min_cons_cnt_euk,
                tie_ratio=params.tie_ratio,
                syncmer=bool(params.syncmer),
                smer_len=params.smer_len,
                seq_mode=params.seq_mode,
                accession_level=params.accession_level,
                em=bool(params.em),
                reduced_aa=reduced,
                kmer_format=params.kmer_format,
                print_log=bool(params.print_log),
            )
            # --print-log dumps each species' match paths during
            # combination (Taxonomer.cpp:346-353); only the Python
            # taxonomer prints them, so it takes every read, as in the
            # reference package; the device taxonomer assumes the standard
            # codon layout, so the reduced alphabet takes the host path
            self.mode = ("log" if params.print_log else
                         "device" if params.device_tax and not reduced
                         else "host")
            if self.mode == "log":
                self.taxonomer = LogTaxonomer(tp, self.taxonomy)
            elif self.mode == "device":
                self.taxonomer = DeviceTaxonomer(
                    tp, self.taxonomy, self.device, threads=params.threads)
            else:
                self.taxonomer = HostTaxonomer(tp, self.taxonomy,
                                               threads=params.threads)
            self.reporter = Reporter(self.taxonomy,
                                     bool(params.print_lineage))
            self.writer = LineWriter(self.reporter)

            # Reference quirk kept for bit-identity
            # (`KmerMatcher.cpp:363-406`): the last k-mer of the database
            # never becomes a candidate, so it is left out of the
            # searchable table.
            self.dev_index = self._build_index(
                self.index.values[:-1],
                self.index.taxids[:-1].astype(np.int32))
            self.d_species = torch.as_tensor(
                self.index.species_table().astype(np.int32),
                device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        ms = self.timer.ms
        self.load_stages = {"decode_s": ms.pop("load.decode") / 1e3,
                            "index_s": ms.pop("load.index") / 1e3}
        self.load_s = sum(self.load_stages.values())
        # an automatic batch (--batch-reads 0) ends at batch_reads reads or
        # batch_bases bases, to stay within batch_budget device bytes above
        # the resident index
        self.batch_bases = self.batch_budget = 0
        if params.batch_reads == 0:
            (params.batch_reads, self.batch_bases,
             self.batch_budget) = self._auto_batch()
        # cap = the DB's true max AA-group size: the fixed point of the
        # reference package's retry ladder, which starts at --max-cap and
        # grows the cap to max_group whenever a group was cut, so its
        # output never truncates a group and --max-cap changes no output
        self.cap = max(1, self.index.max_group)
        self.stats = {"matches": 0, "kmers": 0, "reads": 0}

    def _build_index(self, values: np.ndarray, taxids: np.ndarray):
        """The searchable table on the device: one ``DevIndex``, or AA-
        aligned chunks as many as --max-ram asks for at BYTES_PER_ROW (as
        the reference package decides, on the whole table) and at least as
        many as keep one chunk's index build within the free memory."""
        params, reduced = self.par, bool(self.par.reduced_aa)
        rows = len(self.index.values)
        budget = int(params.max_ram) << 30
        min_chunks = 1
        if self.device.type == "cuda":
            min_chunks = build_chunks(
                rows, torch.cuda.mem_get_info(self.device)[0])
        if rows * BYTES_PER_ROW > budget or min_chunks > 1:
            return ChunkedIndex(
                values, taxids, budget, reduced=reduced, device=self.device,
                min_chunks=min_chunks, kmer_format=params.kmer_format)
        return build_dev_index(values, taxids, kmer_format=params.kmer_format,
                               device=self.device, reduced=reduced)

    def _auto_batch(self) -> tuple[int, int, int]:
        """(reads, bases, bytes) per batch from free device memory (the
        QueryIndexer byte-budget analogue, `QueryIndexer.cpp:24-28`): a
        batch ends at whichever it reaches first, so long reads and
        contigs are cut by bases at the bytes per base of a 150 bp read.
        The device bytes follow the padded bases the match core takes,
        and its length-sorted blocks (``pipeline.length_blocks``) pad a
        batch by less than ``BLOCK_BASES`` x ln(longest / shortest row)
        bases (none where its rows share one length; ~17 M for rows of
        500 bp to 30 kb), whatever its longest read: so a batch stays
        within ``bytes`` up to that padding, where one matrix padded to
        its longest row would exceed it by the ratio of its longest row
        to its mean. Reads are independent, so where a batch ends changes
        no output."""
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
        else:
            free = 4 << 30  # CPU: stay modest
        avail = max(free - (1 << 30), 1 << 28)
        b = 512
        while b * 2 * BATCH_BYTES_PER_READ <= avail // 2 and b < 16384:
            b *= 2
        budget = avail // 2
        return b, budget * BATCH_READ_LEN // BATCH_BYTES_PER_READ, budget

    # ---------------------------------------------------------------- batches
    def _iter_batches(self, q1: str, q2: str | None,
                      skip: int = 0) -> BatchReader:
        """The run's ``ReadBatch``es (``io.batch_reader``): a batch holds
        ``batch_reads`` reads, or fewer where ``batch_bases`` (if set) would
        be passed (at least one read a batch)."""
        return BatchReader(q1, q2, self.par.batch_reads, self.batch_bases,
                           skip)

    def classify_batch(self, reads: ReadBatch, plain: bool = False
                       ) -> list[ReadClassification]:
        """One batch through the device stages and the host finish, on
        this thread.

        ``plain=True`` runs the plain PyTorch versions of the four kernels
        instead of the kernels (the check of one against the other)."""
        job = self._dispatch(reads, plain=plain)
        results, _ = self._finish_batch(job)
        self.timer.resolve(job.marks)
        return list(results)

    def _dispatch(self, reads: ReadBatch, plain: bool = False,
                  batch: int = 0) -> Job:
        """Upload a batch, run its device stages and queue the copy of
        their results to the host (main thread): the spans ``encode`` up to
        the first copy to the device (``--mask-mode 1``'s masking),
        ``launch`` from it to the queued copy back, both with the batch's
        id ``batch``."""
        with self.timer.span("encode", batch):
            codes = (mask_rows(reads, self.par.mask_prob)
                     if self.par.mask_mode else reads.codes)
        with self.timer.span("launch", batch):
            self.timer.start()
            blocks = self._upload(codes, reads, batch)
            host, counts = self._device_stages(blocks, reads.read_lens,
                                               plain)
            marks = self.timer.stop()
        self.stats["kmers"] += counts["total_kmers"]
        self.stats["matches"] += counts["n_matches"]
        return Job(reads.names, host, reads.read_lens, marks, batch=batch)

    def _cut_blocks(self, lens: np.ndarray) -> list[np.ndarray] | None:
        """The rows of each block of a batch (``pipeline.length_blocks``);
        None: the batch is one block."""
        return length_blocks(lens)

    def _upload(self, codes: np.ndarray, reads: ReadBatch,
                batch: int) -> list[Block]:
        """A batch's blocks on the device (``--mask-mode 1``'s ``codes``
        in place of the reader's): each gathered on the host (its rows'
        codes cut to its longest row, their lengths, position offsets and
        qids) and copied up inside a ``metabuli.block`` range with the
        batch's id, each copy's end marked ``upload``. A batch of one
        block goes up as it is, with no gather. Counts the padded bases
        and the bases handed to K1 (``build.launches``)."""
        cut = self._cut_blocks(reads.lens)
        blocks = []
        for rows in cut or [None]:
            with self.timer.span("block", batch, ms=False):
                if rows is None:
                    arrays = (codes, reads.lens, reads.pos, reads.qid)
                else:
                    lens = reads.lens[rows]  # the longest first
                    arrays = (codes[rows, :lens[0]], lens, reads.pos[rows],
                              reads.qid[rows])
                blocks.append(Block(*(torch.as_tensor(a, device=self.device)
                                      for a in arrays)))
                self.timer.mark("upload")
            build.launches["extract_metamers.padded_bases"] += arrays[0].size
            build.launches["extract_metamers.bases"] += int(arrays[1].sum())
        return blocks

    def _device_stages(self, blocks: list[Block], read_lens, plain: bool):
        """A batch's device stages, ending with the copy of their results
        to the host queued (the taxonomer's ``send``): (that
        ``HostCopy``, the match counters)."""
        m, counts = classify_blocks(
            self.dev_index, self.d_species, blocks, cap=self.cap,
            syncmer=bool(self.par.syncmer), smer_len=self.par.smer_len,
            plain=plain, timer=self.timer)
        return self.taxonomer.send(m, read_lens, plain=plain,
                                   timer=self.timer), counts

    def _finish_batch(self, job: Job):
        """Wait for a batch's copy and finish its reads on the host (the
        pipeline's worker; launches no CUDA work and changes no shared
        state). Returns the results (the taxonomer's ``drain``: a
        ``BatchReads``), the host clock at the end of the wait and at the
        end of the taxonomer call, and this thread's CPU seconds in that
        call."""
        job.host.wait()
        t1 = time.perf_counter()
        cpu = time.thread_time()
        # the range alone: done() adds the taxonomer call to "finish"
        with self.timer.span("finish", job.batch, ms=False):
            results = self.taxonomer.drain(job.host, job.read_lens,
                                           len(job.names))
        return results, (t1, time.perf_counter(), time.thread_time() - cpu)

    def _write_lines(self, fh, results: BatchReads, names: list,
                     read_lens: np.ndarray, *, first: bool = False,
                     index_base: int | None = None) -> BatchResult:
        """Write a batch's lines (``LineWriter.write``) from its columns.
        Counts the lines in ``write_lines.lines``, those whose reads'
        objects exist also in ``write_lines.object_lines``; returns the
        columns."""
        cols = results.columns()
        self.writer.write(fh, cols, names, read_lens, first=first,
                          index_base=index_base)
        build.launches["write_lines.lines"] += len(names)
        if results.made:
            build.launches["write_lines.object_lines"] += len(names)
        return cols

    def _emit_batch(self, fh, job: Job, results: BatchReads, tax_counts,
                    total_reads, first, mappings, all_results):
        """Write one batch's classifications (``LineWriter``) and add its
        reads to the clade counts; under --em, its mappings and its
        (name, ``ReadClassification``, length) rows to the EM step's."""
        n = len(job.names)
        self.stats["reads"] += n
        made = results.made
        cols = self._write_lines(fh, results, job.names, job.read_lens,
                                 first=first)
        cols.clade_counts(tax_counts)
        if self.par.em:
            if not made:  # the EM step's objects, made here
                build.launches["write_lines.object_lines"] += n
            mappings.extend(cols.mappings(total_reads))
            all_results.extend(zip(job.names, results,
                                   job.read_lens.tolist()))
        return total_reads + n, False

    def _run_batches(self, batches, emit) -> dict:
        """Run ``batches`` (``ReadBatch``es) through the depth-2
        pipeline: the worker finishes batch i while this thread dispatches
        batch i+1, and ``emit(job, results)`` takes each batch in order on
        this thread. --print-log stays serial: its Python taxonomer holds
        the interpreter lock throughout and prints, so a worker would
        overlap nothing and could interleave its lines. Returns the
        batches it ran (``batches``), the taxonomer calls' host-clock
        seconds (``finish_s``), their part
        during which this thread parsed or dispatched another batch
        (``finish_overlap_s``) and the CPU seconds of the thread that made
        them (``finish_cpu_s``, their OpenMP helpers not counted).

        This thread's loop is in spans, each with its batch's id:
        ``parse`` (the next batch from ``batches``; the last finds none),
        ``encode`` and ``launch`` (``_dispatch``), ``wait`` (on the
        worker) and ``emit``."""
        spans = {"finish": [], "busy": []}
        finish_cpu = 0.0

        def done(job, results, clock):
            nonlocal finish_cpu
            t1, t2, cpu = clock
            spans["finish"].append((t1, t2))
            finish_cpu += cpu
            self.timer.resolve(job.marks)
            self.timer.add("finish", (t2 - t1) * 1e3)
            with self.timer.span("emit", job.batch):
                emit(job, results)
                # the written batch's CUDA events and pinned copies go
                # here, not between spans: freeing a CUDA object can hand
                # the interpreter lock to the worker
                job.marks.clear()
                if job.host is not None:
                    job.host.tensors.clear()

        pool = (None if self.taxonomer.serial else
                ThreadPoolExecutor(1, thread_name_prefix="metabuli-finish"))
        try:
            inflight = None
            for batch in itertools.count():
                t0 = time.perf_counter()
                with self.timer.span("parse", batch):
                    nxt = next(batches, None)
                job = fut = None
                if nxt is not None:
                    job = self._dispatch(nxt, batch=batch)
                spans["busy"].append((t0, time.perf_counter()))
                if job is not None:
                    if pool is None:
                        done(job, *self._finish_batch(job))
                        continue
                    fut = pool.submit(self._finish_batch, job)
                if inflight is not None:
                    prev, prev_fut = inflight
                    with self.timer.span("wait", prev.batch):
                        res = prev_fut.result()
                    done(prev, *res)
                if nxt is None:
                    break
                inflight = (job, fut)
        finally:
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)
        # the loop's last batch found no reads: its id is the count
        return {"batches": batch,
                "finish_s": sum(b - a for a, b in spans["finish"]),
                "finish_overlap_s": overlap_s(spans["finish"], spans["busy"]),
                "finish_cpu_s": finish_cpu}

    def _write_reports(self, out_dir: str, job_id: str, tax_counts: dict,
                       total_reads: int):
        """The Kraken-style report and the Krona file of a run's clade
        counts."""
        with open(os.path.join(out_dir, f"{job_id}_report.tsv"), "w") as fh:
            self.reporter.write_report(fh, tax_counts, total_reads)
        prelude = None
        if self.par.krona_prelude:
            with open(self.par.krona_prelude) as pf:
                prelude = pf.read()
        with open(os.path.join(out_dir, f"{job_id}_krona.html"), "w") as fh:
            self.reporter.write_krona(fh, tax_counts, total_reads,
                                      prelude=prelude)

    # ------------------------------------------------------------------- main
    def classify_file(self, q1: str, q2: str | None, out_dir: str,
                      job_id: str, resume: bool = False) -> dict:
        os.makedirs(out_dir, exist_ok=True)
        cls_path = os.path.join(out_dir, f"{job_id}_classifications.tsv")
        tax_counts: dict[int, int] = {}
        total_reads = 0
        first = True
        skip = 0
        if resume and os.path.exists(cls_path):
            # rebuild clade counts from the existing rows, append the rest
            with open(cls_path) as fh:
                for line in fh:
                    if line.startswith("#"):
                        continue
                    cols = line.rstrip("\n").split("\t")
                    if len(cols) < 3:
                        continue
                    t = (self.taxonomy.to_internal(int(cols[2]))
                         if cols[0] == "1" else 0)
                    tax_counts[max(t, 0)] = tax_counts.get(max(t, 0), 0) + 1
                    skip += 1
            total_reads = skip
            first = False
        mappings = [] if self.par.em else None
        all_results = [] if self.par.em else None

        def emit(job, results):
            nonlocal total_reads, first
            total_reads, first = self._emit_batch(
                fh, job, results, tax_counts, total_reads, first, mappings,
                all_results)

        t_run, cpu_run = time.perf_counter(), time.thread_time()
        with (open(cls_path, "ab" if skip else "wb") as fh,
              self._iter_batches(q1, q2, skip=skip) as reader):
            run = self._run_batches(reader, emit)

        # batch id: the run's last batch
        with self.timer.span("reports", max(run["batches"] - 1, 0)):
            self._write_reports(out_dir, job_id, tax_counts, total_reads)
        summary = {
            "reads": total_reads - skip,
            "classified": total_reads - tax_counts.get(0, 0),
            **self.stats,
            # DB load + device index build, then first batch -> last write
            "load_s": self.load_s,
            "load_stages": self.load_stages,
            "classify_s": time.perf_counter() - t_run,
            "stage_ms": self.timer.ms,
            # the query files' bytes (decompressed) the reader consumed
            "parse_bytes": reader.bytes,
            # the taxonomer calls (host clock), their part during which
            # this thread parsed or dispatched another batch, and the CPU
            # seconds of the thread that made them (their OpenMP helpers
            # not counted) and of this thread over the run: the two threads
            # share one interpreter lock, so a finish that waits for it
            # runs its clock past its CPU seconds
            **run,
            "main_cpu_s": time.thread_time() - cpu_run,
        }
        if self.par.em and total_reads:
            from .em import run_em_reassignment

            run_em_reassignment(self, mappings, all_results, out_dir, job_id,
                                total_reads)
        return summary
