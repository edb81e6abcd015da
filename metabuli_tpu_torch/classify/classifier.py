"""Classification orchestrator: file -> batches -> device -> reports.

Counterpart of ``metabuli_tpu.classify.classifier`` (`Classifier.cpp:44-164`)
for its default path, the fused device taxonomer: reads stream in
batches, each batch runs the match core and the taxonomer stages on the
device, and the host finishes each read and writes the classifications,
report and Krona files. Stages are sized exactly on the device, so there
is no warm-up batch and no retry.

Paths that are not ported raise ``NotImplementedError`` naming their
ROADMAP.md item; none is taken quietly.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..db.index import MetamerIndex
from ..io import fasta
from ..io.report import Reporter
from ..ops.genetic_code import encode_seqs_padded
from ..params import ClassifyParams
from .device_taxonomer import DeviceTaxonomer
from .pipeline import build_dev_index
from .taxonomer import ReadClassification, TaxonomerParams

# device bytes per table row: taxdna + d48 (16) + a group's grest, gstart,
# gend (12, at most one group per row)
BYTES_PER_ROW = 28
# device bytes per table row at the peak of the index build (sort keys,
# permutation and expansion temporaries): 22.8 GiB for 2^28 rows, measured
# on an H100 80GB HBM3 (chip_smoke.py's skew DB)
BUILD_BYTES_PER_ROW = 92
# device bytes per 150 bp read of a batch above the resident index: 0.346
# GiB for 8,192 reads, measured on the same card and DB
BATCH_BYTES_PER_READ = 45_400


def not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to metabuli_tpu_torch yet "
        f"(ROADMAP.md Queue 1, {item}); use metabuli_tpu for it")


def _used_len(length: int) -> int:
    return max(0, 3 * ((length - 2) // 3))


@dataclass
class QueryMeta:
    name: str
    read_len: int  # usedLen(mate1) + usedLen(mate2)


class StageTimer:
    """Per-stage wall time of the batches, from CUDA events on the card
    (host clock on the CPU); ``ms`` accumulates over the run."""

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

    def stop(self):
        if self.cuda:
            torch.cuda.synchronize()
        for (_, a), (name, b) in zip(self._marks, self._marks[1:]):
            ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
            self.ms[name] = self.ms.get(name, 0.0) + ms
        self._marks = []


class Classifier:
    def __init__(self, db_dir: str, params: ClassifyParams, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the kernels run only on one; pass "
                "device='cpu' (--device cpu) for the plain PyTorch versions")
        self.par = params
        if not params.device_tax:
            raise not_ported("--device-tax 0 (the host taxonomer)", "item 8")
        if params.print_log:
            raise not_ported("--print-log (the host taxonomer)", "item 8")
        if params.seq_mode == 3:
            raise not_ported("--seq-mode 3 (long reads)", "item 10")
        t0 = time.perf_counter()
        self.index = MetamerIndex.load(db_dir)
        dbp = self.index.params
        # db.parameters override user flags (`common.cpp:88-133`)
        params.syncmer = dbp.syncmer
        params.smer_len = dbp.smer_len
        params.kmer_format = dbp.kmer_format
        params.reduced_aa = dbp.reduced_aa
        params.skip_redundancy = dbp.skip_redundancy
        if dbp.accession_level == 0 and params.accession_level == 1:
            params.accession_level = 0
        if params.reduced_aa:
            raise not_ported("--reduced-aa 1 (reduced alphabet)", "item 9")
        if params.kmer_format != 2:
            raise not_ported("kmer_format 1 databases", "item 14")
        rows = len(self.index.values)
        if rows * BYTES_PER_ROW > int(params.max_ram) << 30:
            raise not_ported("a DB larger than --max-ram (chunked index)",
                             "item 7")
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            if rows * BUILD_BYTES_PER_ROW > free:
                raise not_ported(
                    f"a DB larger than the card ({rows} rows need "
                    f"~{rows * BUILD_BYTES_PER_ROW / 2**30:.1f} GiB to load, "
                    f"{free / 2**30:.1f} GiB free; chunked index)", "item 7")
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
            reduced_aa=False,
            kmer_format=params.kmer_format,
        )
        self.device_taxonomer = DeviceTaxonomer(
            tp, self.taxonomy, self.device, threads=params.threads)
        self.reporter = Reporter(self.taxonomy, bool(params.print_lineage))

        # Reference quirk kept for bit-identity (`KmerMatcher.cpp:363-406`):
        # the last k-mer of the database never becomes a candidate, so it
        # is left out of the searchable table.
        self.dev_index = build_dev_index(
            self.index.values[:-1], self.index.taxids[:-1].astype(np.int32),
            kmer_format=params.kmer_format, device=self.device)
        self.d_species = torch.as_tensor(
            self.index.species_table().astype(np.int32), device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.load_s = time.perf_counter() - t0
        if params.batch_reads == 0:
            params.batch_reads = self._auto_batch_reads()
        # cap = the DB's true max AA-group size: the fixed point of the
        # reference package's retry ladder, which starts at --max-cap and
        # grows the cap to max_group whenever a group was cut, so its
        # output never truncates a group and --max-cap changes no output
        self.cap = max(1, self.index.max_group)
        self.timer = StageTimer(self.device)
        self.stats = {"matches": 0, "kmers": 0, "reads": 0,
                      "device_s": 0.0, "tax_s": 0.0}

    def _auto_batch_reads(self) -> int:
        """Reads per batch from free device memory (the QueryIndexer
        byte-budget analogue, `QueryIndexer.cpp:24-28`)."""
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
        else:
            free = 4 << 30  # CPU: stay modest
        avail = max(free - (1 << 30), 1 << 28)
        b = 512
        while b * 2 * BATCH_BYTES_PER_READ <= avail // 2 and b < 16384:
            b *= 2
        return b

    # ---------------------------------------------------------------- batches
    def _iter_batches(self, q1: str, q2: str | None, skip: int = 0):
        """Yield (metas, rows), rows = [(seq, qid_local, pos_offset)]."""
        batch_reads = self.par.batch_reads
        metas: list[QueryMeta] = []
        rows: list[tuple[bytes, int, int]] = []
        it1 = fasta.read_records(q1)
        it2 = fasta.read_records(q2) if q2 else None
        for _ in range(skip):
            next(it1, None)
            if it2 is not None:
                next(it2, None)
        while True:
            rec1 = next(it1, None)
            if rec1 is None:
                break
            qid = len(metas)
            if it2 is not None:
                rec2 = next(it2, None)
                if rec2 is None:
                    raise ValueError(
                        "paired-end files have different read counts")
                ul1, ul2 = _used_len(len(rec1.seq)), _used_len(len(rec2.seq))
                metas.append(QueryMeta(rec1.name, ul1 + ul2))
                rows.append((rec1.seq, qid, 0))
                rows.append((rec2.seq, qid, ul1 + 3))
            else:
                metas.append(QueryMeta(rec1.name, _used_len(len(rec1.seq))))
                rows.append((rec1.seq, qid, 0))
            if len(metas) >= batch_reads:
                yield metas, rows
                metas, rows = [], []
        if metas:
            yield metas, rows

    def classify_batch(self, metas, rows, plain: bool = False
                       ) -> list[ReadClassification]:
        """One batch through the device stages and the host finish.

        ``plain=True`` runs the plain PyTorch versions of the four kernels
        instead of the kernels (the check of one against the other)."""
        par = self.par
        t0 = time.perf_counter()
        max_len = max((len(r[0]) for r in rows), default=0)
        codes, lens = encode_seqs_padded([r[0] for r in rows],
                                         max_len=max_len)
        if par.mask_mode:
            from ..ops.mask import mask_codes

            for r_i, row in enumerate(rows):
                n = len(row[0])
                codes[r_i, :n] = mask_codes(codes[r_i, :n], par.mask_prob)
        dev = self.device
        as_dev = lambda a, dt: torch.as_tensor(np.asarray(a, dt), device=dev)
        read_lens = np.array([m.read_len for m in metas], np.int32)
        self.timer.start()
        handle, counts = self.device_taxonomer.dispatch(
            self.dev_index, self.d_species, as_dev(codes, np.uint8),
            as_dev(lens, np.int32), as_dev([r[2] for r in rows], np.int32),
            as_dev([r[1] for r in rows], np.int32), read_lens,
            cap=self.cap, syncmer=bool(par.syncmer), smer_len=par.smer_len,
            plain=plain, timer=self.timer)
        t1 = time.perf_counter()
        results = self.device_taxonomer.drain(handle, read_lens, len(metas))
        self.timer.mark("finish")
        self.timer.stop()
        self.stats["device_s"] += t1 - t0
        self.stats["tax_s"] += time.perf_counter() - t1
        self.stats["kmers"] += counts["total_kmers"]
        self.stats["matches"] += counts["n_matches"]
        return results

    def _emit_batch(self, fh, metas, results, tax_counts, total_reads,
                    first, mappings, all_results):
        """Write one batch's classifications + accumulate clade counts/EM."""
        self.stats["reads"] += len(metas)
        rows_out = [(meta.name, rc, meta.read_len)
                    for meta, rc in zip(metas, results)]
        self.reporter.write_classifications(fh, rows_out, first=first)
        for rc in results:
            t = rc.taxid if rc.is_classified else 0
            tax_counts[t] = tax_counts.get(t, 0) + 1
        if self.par.em:
            for i, rc in enumerate(results):
                for sp, sc in rc.species_scores:
                    mappings.append((total_reads + i, sp, sc))
            all_results.extend((meta.name, rc, meta.read_len)
                               for meta, rc in zip(metas, results))
        return total_reads + len(metas), False

    # ------------------------------------------------------------------- main
    def classify_file(self, q1: str, q2: str | None, out_dir: str,
                      job_id: str, resume: bool = False) -> dict:
        os.makedirs(out_dir, exist_ok=True)
        cls_path = os.path.join(out_dir, f"{job_id}_classifications.tsv")
        report_path = os.path.join(out_dir, f"{job_id}_report.tsv")
        krona_path = os.path.join(out_dir, f"{job_id}_krona.html")

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
        t_run = time.perf_counter()
        with open(cls_path, "a" if skip else "w") as fh:
            for metas, rows in self._iter_batches(q1, q2, skip=skip):
                results = self.classify_batch(metas, rows)
                total_reads, first = self._emit_batch(
                    fh, metas, results, tax_counts, total_reads, first,
                    mappings, all_results)

        with open(report_path, "w") as fh:
            self.reporter.write_report(fh, tax_counts, total_reads)
        with open(krona_path, "w") as fh:
            prelude = None
            if self.par.krona_prelude:
                with open(self.par.krona_prelude) as pf:
                    prelude = pf.read()
            self.reporter.write_krona(fh, tax_counts, total_reads,
                                      prelude=prelude)

        summary = {
            "reads": total_reads - skip,
            "classified": total_reads - tax_counts.get(0, 0),
            **self.stats,
            # DB load + device index build, then first batch -> last write
            "load_s": self.load_s,
            "classify_s": time.perf_counter() - t_run,
            "stage_ms": self.timer.ms,
        }
        if self.par.em and total_reads:
            from .em import run_em_reassignment

            run_em_reassignment(self, mappings, all_results, out_dir, job_id,
                                total_reads)
        return summary
