"""Database construction: FASTA library -> sorted metamer index.

The port's counterpart of ``metabuli_tpu.db.build``, line for line except
the extraction: each padded batch is uploaded to the builder's
``torch.device`` and goes through kernel K1 (``ops.encode.
extract_metamers``) on the card, or its plain PyTorch version on the CPU;
the valid windows come back to the host as uint64 bit patterns. Every
other stage runs on the host, as in the JAX package. Each build also
returns the seconds of its stages (``stage_s``, see ``BuildTimer``).

Re-designs the reference's IndexCreator pipeline
(`Metabuli src/commons/IndexCreator.cpp:316-376`):

  1. map sequence accessions to taxids (accession2taxid),
  2. extract target metamers on device in large batches,
  3. sort by (value, species, taxid) (`Kmer.h:77-87`),
  4. deduplicate per (value, species) with LCA of member taxids
     (`IndexCreator.h:475-629`, FilterMode::DB_CREATION),
  5. write diffIdx / info / split / taxID_list / db.parameters.

Gene prediction (`--gene-prediction`, predict_gene_blocks), low-complexity
masking, CDS-info bypass, accession-level mode, and the out-of-core
flush-file + k-way merge path (`IndexCreator.h:322-472` analogue in
formats.merge_flush_files) are all wired; remaining parity gaps vs the
reference are tracked in PARITY.md (chiefly: the gene predictor is a
same-family self-trainer, not a bit-exact Prodigal port).
"""

from __future__ import annotations

import contextlib
import datetime
import hashlib
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..csrc import build as kernels
from ..io import fasta
from ..ops import encode
from ..ops.genetic_code import encode_seqs_padded
from ..params import BuildParams
from .formats import DbParameters, write_db_files, write_taxid_list
from .taxonomy import Taxonomy


class BuildTimer:
    """Seconds of each build stage: host stages from ``perf_counter``; the
    extraction (K1) from CUDA events on the card (host clock on the CPU),
    synchronized at its end so the next stage's host time holds none of
    it. Stages: scan, load, gene_prediction, masking, encode, upload,
    extract, gather, sort_dedup, flush_merge, write. A stage opened inside
    another pauses it, so no second is counted twice."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.s: dict[str, float] = {}
        self._open: list[list] = []  # [name, start] of the open stages

    def add(self, name: str, seconds: float):
        self.s[name] = self.s.get(name, 0.0) + seconds

    @contextlib.contextmanager
    def stage(self, name: str):
        now = time.perf_counter()
        if self._open:
            outer = self._open[-1]
            self.add(outer[0], now - outer[1])
        self._open.append([name, now])
        try:
            yield
        finally:
            now = time.perf_counter()
            self.add(name, now - self._open.pop()[1])
            if self._open:
                self._open[-1][1] = now

    @contextlib.contextmanager
    def device_stage(self, name: str):
        if not self.cuda:
            with self.stage(name):
                yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            end.synchronize()
            self.add(name, start.elapsed_time(end) / 1e3)


@dataclass
class SeqTask:
    seq: bytes
    taxid: int      # internal
    species: int    # internal
    single_frame: bool = False  # CDS blocks scan only forward frame 0
                                # (`IndexCreator.cpp:1104-1127`)


def read_acc2taxid(path: str) -> dict[str, int]:
    """accession -> taxid map; accepts 2+-column TSV with optional header
    (`Metabuli src/commons/common.cpp` fillAcc2TaxIdMap analogue)."""
    out: dict[str, int] = {}
    with open(path) as fh:
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 2:
                continue
            acc = cols[0]
            # NCBI 4-column format: accession, accession.version, taxid, gi
            if len(cols) >= 3 and cols[1] and not cols[1].isdigit():
                acc_ver, tax = cols[1], cols[2]
            else:
                acc_ver, tax = cols[0], cols[1]
            try:
                out[acc_ver] = int(tax)
                out.setdefault(acc, int(tax))
            except ValueError:
                continue  # header line
    return out


def accession_of(header_name: str) -> str:
    """First token of the FASTA header (reference uses the accession up to
    the first whitespace/dot version included)."""
    return header_name.split()[0]


@dataclass
class AccEntry:
    """One accession from the build pre-scan (location, not content)."""

    species: int    # internal species id
    fasta_idx: int  # which input file
    order: int      # record index within the file
    length: int
    taxid: int      # internal taxid the sequence is indexed under
    offset: int     # byte range within the (plain) FASTA file
    end: int


def get_accession_batches(
    entries: list[AccEntry], buffer_kmers: int = 1 << 30
) -> list[list[AccEntry]]:
    """Group accessions into per-(species, fasta) batches with the
    reference's cut rules (`IndexCreator::getAccessionBatches`,
    `Metabuli src/commons/IndexCreator.cpp:735-785`):

      - accessions ordered by (species, whichFasta, order);
      - a batch never spans a (species, fasta) boundary;
      - a sequence is ADDED first, then the batch is cut when the
        accumulated per-sequence floor(length*0.4) k-mer estimate exceeds
        the buffer, the base sum exceeds 100 Mbp, the batch holds more
        than 300 sequences, or more than 100 sequences with a base sum
        over 50 Mbp (post-add cut, `IndexCreator.cpp:763-771`);
      - batches are processed in ascending total-length order (`:492-495`).

    Batching only shapes memory use with gene prediction off; with it on,
    batch composition feeds the per-batch intergenic 23-mer accumulation,
    so matching the reference's cut points exactly matters for DB parity.
    """
    ordered = sorted(entries, key=lambda e: (e.species, e.fasta_idx, e.order))
    batches: list[list[AccEntry]] = []
    cur: list[AccEntry] = []
    cur_len = 0
    cur_kmers = 0
    for e in ordered:
        boundary = cur and (
            cur[0].species != e.species or cur[0].fasta_idx != e.fasta_idx
        )
        if boundary:
            batches.append(cur)
            cur, cur_len, cur_kmers = [], 0, 0
        cur.append(e)
        cur_len += e.length
        cur_kmers += int(e.length * 0.4)
        if (
            cur_kmers > buffer_kmers
            or cur_len > 100_000_000
            or len(cur) > 300
            or (len(cur) > 100 and cur_len > 50_000_000)
        ):
            batches.append(cur)
            cur, cur_len, cur_kmers = [], 0, 0
    if cur:
        batches.append(cur)
    batches.sort(key=lambda b: sum(e.length for e in b))
    return batches


class IndexBuilder:
    def __init__(self, params: BuildParams, taxonomy: Taxonomy,
                 flush_dir: str | None = None, device="cuda"):
        self.device = kernels.device(device)
        self.timer = BuildTimer(self.device)
        # the blocks handed to extraction, in order: with gene prediction
        # on, its output (where a build differs, this tells the host's
        # gene prediction from the extraction)
        self.n_blocks = 0
        self.blocks_sha256 = hashlib.sha256()
        self.par = params
        self.tax = taxonomy
        self._values: list[np.ndarray] = []
        self._taxids: list[np.ndarray] = []
        self._species: list[np.ndarray] = []
        self._pending = 0
        # out-of-core: flush sorted/deduped blocks once pending k-mers exceed
        # the RAM budget (the reference's N_diffIdx/N_info flush files,
        # `IndexCreator.cpp:793-798`); 16B/entry pending + sort scratch
        self._flush_dir = flush_dir
        self._flush_pairs: list[tuple[str, str]] = []
        if params.flush_kmers > 0:
            self._flush_threshold = params.flush_kmers
        else:
            self._flush_threshold = max(1 << 20, (params.max_ram << 30) // 32)

    # ---------------------------------------------------------------- extract
    def add_sequences(self, tasks: list[SeqTask]):
        """Extract metamers for a batch of sequences on device."""
        if not tasks:
            return
        self.n_blocks += len(tasks)
        for t in tasks:
            self.blocks_sha256.update(
                np.array([t.taxid, t.species, t.single_frame, len(t.seq)],
                         np.int64).tobytes() + t.seq)
        for batch in self.batches(tasks):
            self._extract_batch(batch)

    def batches(self, tasks: list[SeqTask]):
        """The sub-batches ``add_sequences`` extracts, one padded matrix
        each, in order."""
        par = self.par
        # group into padded sub-batches by size so the padded matrix stays
        # small; single-frame (CDS) tasks batch separately
        tasks = sorted(tasks, key=lambda t: (t.single_frame, len(t.seq)))

        def bucket_of(n):
            # length bucket of the padded code matrix (matches
            # _extract_batch's rounding)
            b = 384
            while b < n + 2:
                b *= 2
            return b

        def bpad_of(n):
            b = 1
            while b < n:
                b *= 2
            return b

        # Device-memory backpressure: the extraction tensors are sized by
        # the PADDED matrix [b_pad, bucket] where bucket is the batch MAX
        # length — mixing one long sequence into thousands of short gene
        # blocks multiplies EVERY row's cost, so the cut must account the
        # true padded product, not a per-task sum (the HBM analogue of the
        # reference's buffer reserve/un-reserve retry,
        # `Metabuli src/commons/IndexCreator.cpp:1237-1241`).
        batch: list[SeqTask] = []
        for t in tasks:
            if batch:
                cost = bpad_of(len(batch) + 1) * bucket_of(len(t.seq))
                if batch[0].single_frame != t.single_frame or (
                    cost > par.batch_bases
                ):
                    yield batch
                    batch = []
            batch.append(t)
        if batch:
            yield batch

    def _extract_batch(self, batch: list[SeqTask]):
        """Extract one padded batch on device; on device OOM, split the
        batch and retry on the device (un-reserve/retry analogue of
        `IndexCreator.cpp:1237-1241`)."""
        try:
            self._extract_batch_once(batch)
            return
        except torch.cuda.OutOfMemoryError:
            if len(batch) == 1:
                raise
        # retried outside the handler, so the traceback no longer holds
        # the failed attempt's device tensors
        import sys

        print(
            f"extract batch of {len(batch)} OOMed on device; "
            "splitting and retrying",
            file=sys.stderr,
        )
        mid = len(batch) // 2
        self._extract_batch(batch[:mid])
        self._extract_batch(batch[mid:])

    def padded(self, batch: list[SeqTask]) -> tuple[np.ndarray, np.ndarray]:
        """The padded codes [b_pad, bucket] uint8 and lens [b_pad] int32 of
        one batch, as the extraction takes them."""
        # bucket the padded length and batch size so only a few device
        # program shapes ever compile
        max_len = max(len(t.seq) for t in batch) + 2
        bucket = 384
        while bucket < max_len:
            bucket *= 2
        codes, lens = encode_seqs_padded([t.seq for t in batch],
                                         max_len=bucket)
        if batch[0].single_frame:
            # target-block scans cover floor(L/3) codons (initScanner sets
            # aaLen = seqLen/3, `KmerScanner.h:74-77`), not the query-side
            # maxCoveredLength; bump lens so (len-2)//3 == L//3 (the padded
            # tail reads INVALID codes and can't form extra valid codons)
            real = np.array([len(t.seq) for t in batch], np.int64)
            lens = (3 * (real // 3) + 2).astype(np.int32)
        # NB: masking happens at TASK CREATION (whole strand-corrected
        # sequences, before block cutting) — tantan posteriors are
        # context-dependent, so masking cut blocks here would diverge from
        # the reference (`IndexCreator.cpp:1082-1099`)
        b_pad = 1
        while b_pad < len(batch):
            b_pad *= 2
        if b_pad != len(batch):
            pad = np.full((b_pad - len(batch), bucket), 7, np.uint8)
            codes = np.concatenate([codes, pad])
            lens = np.concatenate([lens, np.zeros(b_pad - len(batch), np.int32)])
        return codes, lens

    def _extract_batch_once(self, batch: list[SeqTask]):
        par = self.par
        timer = self.timer
        with timer.stage("encode"):
            codes, lens = self.padded(batch)
        with timer.stage("upload"):
            d_codes = torch.from_numpy(codes).to(self.device)
            d_lens = torch.from_numpy(lens).to(self.device)
        with timer.device_stage("extract"):
            mm = encode.extract_metamers(d_codes, d_lens,
                                         syncmer=bool(par.syncmer),
                                         smer_len=par.smer_len,
                                         reduced=bool(par.reduced_aa),
                                         kmer_format=par.kmer_format)
        with timer.stage("gather"):
            valid = mm.valid
            if batch[0].single_frame:
                valid = valid.clone()
                valid[:, 1:, :] = False  # forward frame 0 only
            b, f, w = torch.nonzero(valid, as_tuple=True)
            # int64 bit patterns come back as uint64 (torch has no uint64
            # shifts or compares on the CPU)
            vals = mm.value[b, f, w].cpu().numpy().view(np.uint64)
            b = b.cpu().numpy()
            del mm, valid, d_codes, d_lens
        taxids = np.array([t.taxid for t in batch], np.uint32)[b]
        species = np.array([t.species for t in batch], np.uint32)[b]
        self._values.append(vals)
        self._taxids.append(taxids)
        self._species.append(species)
        self._pending += len(vals)
        if self._flush_dir is not None and self._pending >= self._flush_threshold:
            self._flush()

    # ------------------------------------------------------------- out-of-core
    def _sort_dedup(self, values, taxids, species):
        """Sort by (value, species, taxid) (`Kmer.h:77-87`) and dedup per
        (value, species) with LCA of member taxids (`IndexCreator.h:535-581`,
        FilterMode::DB_CREATION)."""
        from ..native.sort import lexsort_vst

        order = lexsort_vst(values, species, taxids)
        values, taxids, species = values[order], taxids[order], species[order]
        if len(values) == 0:
            return values, taxids, species
        new_group = np.ones(len(values), bool)
        new_group[1:] = (values[1:] != values[:-1]) | (species[1:] != species[:-1])
        group_id = np.cumsum(new_group) - 1
        lca = self.tax.lca_segments(taxids.astype(np.int64), group_id)
        return values[new_group], lca.astype(np.uint32), species[new_group]

    def _drain_pending(self):
        if self._values:
            values = np.concatenate(self._values)
            taxids = np.concatenate(self._taxids)
            species = np.concatenate(self._species)
        else:
            values = np.zeros(0, np.uint64)
            taxids = np.zeros(0, np.uint32)
            species = np.zeros(0, np.uint32)
        self._values, self._taxids, self._species = [], [], []
        self._pending = 0
        return values, taxids, species

    def _flush(self):
        """Write the pending block as a sorted/deduped flush-file pair."""
        from .formats import delta_encode

        values, taxids, species = self._drain_pending()
        with self.timer.stage("sort_dedup"):
            values, taxids, _ = self._sort_dedup(values, taxids, species)
        if len(values) == 0:
            return
        i = len(self._flush_pairs)
        os.makedirs(self._flush_dir, exist_ok=True)
        dpath = os.path.join(self._flush_dir, f"{i}_diffIdx")
        ipath = os.path.join(self._flush_dir, f"{i}_info")
        with self.timer.stage("flush_merge"):
            delta_encode(values).tofile(dpath)
            taxids.tofile(ipath)
        self._flush_pairs.append((dpath, ipath))

    # ------------------------------------------------------------------ write
    def finalize(self, db_dir: str, db_name: str = "") -> dict:
        par = self.par
        timer = self.timer
        os.makedirs(db_dir, exist_ok=True)
        if self._flush_pairs:
            # out-of-core path: flush the remainder, then k-way merge with
            # cross-flush (value, species)-dedup + LCA
            # (`IndexCreator.h:322-472`)
            from .formats import merge_flush_files, read_taxid_list

            if self._pending:
                self._flush()
            with timer.stage("flush_merge"):
                n_unique = merge_flush_files(
                    db_dir, self._flush_pairs,
                    self.tax.species_of.astype(np.uint32),
                    self.tax.lca_segments,
                    split_num=par.split_num, reduced=bool(par.reduced_aa),
                )
            for d, i in self._flush_pairs:
                # only remove our own temporaries, not external inputs
                # (updateDB feeds the old DB's diffIdx/info as one more pair)
                if self._flush_dir and os.path.dirname(d) == self._flush_dir:
                    os.remove(d)
                    os.remove(i)
            self._flush_pairs = []
            # unique taxids from the merged info file, streamed in chunks
            with timer.stage("flush_merge"):
                uniq: np.ndarray = np.zeros(0, np.uint32)
                info_mm = np.memmap(os.path.join(db_dir, "info"),
                                    dtype=np.uint32, mode="r") if n_unique else []
                for s in range(0, len(info_mm), 1 << 24):
                    uniq = np.union1d(uniq,
                                      np.asarray(info_mm[s : s + (1 << 24)]))
            out_taxids = uniq
            n_total = n_unique  # post-flush-dedup inputs; pre-dedup count n/a
            out_count = n_unique
        else:
            values, taxids, species = self._drain_pending()
            n_total = len(values)
            with timer.stage("sort_dedup"):
                out_values, out_taxids, _ = self._sort_dedup(values, taxids,
                                                             species)
            out_count = len(out_values)
            with timer.stage("write"):
                write_db_files(db_dir, out_values, out_taxids, par.split_num,
                               reduced=bool(par.reduced_aa))
        dbp = DbParameters(
            db_name=db_name or par.db_name,
            creation_date=par.db_date or datetime.date.today().isoformat(),
            reduced_aa=par.reduced_aa,
            accession_level=par.accession_level,
            mask_mode=par.mask_mode,
            mask_prob=par.mask_prob,
            skip_redundancy=1,
            syncmer=par.syncmer,
            smer_len=par.smer_len,
            kmer_format=par.kmer_format,
        )
        with timer.stage("write"):
            dbp.write(os.path.join(db_dir, "db.parameters"))
            self.tax.save(os.path.join(db_dir, "taxonomyDB"))
            write_taxid_list(
                os.path.join(db_dir, "taxID_list"), np.unique(out_taxids)
            )
        return {
            "total_kmers": int(n_total),
            "unique_kmers": int(out_count),
            "blocks": self.n_blocks,
            "blocks_sha256": self.blocks_sha256.hexdigest(),
            "stage_s": timer.s,
        }


def predict_gene_blocks(tasks: list[SeqTask], tax: Taxonomy,
                        buffer_kmers: int = 1 << 62, mask_mode: int = 0,
                        mask_prob: float = 0.9,
                        timer: BuildTimer | None = None) -> list[SeqTask]:
    """Replace whole-sequence tasks with predicted coding blocks.

    Per species (mirrors `IndexCreator::fillTargetKmerBuffer`,
    `IndexCreator.cpp:1128-1218`): train the gene predictor on the species'
    longest sequence, min-hash-compare every sequence against it and
    reverse-complement opposite-strand ones (`SeqIterator.cpp:65-112`),
    predict genes, and extract the extended-ORF blocks
    (`ProdigalWrapper.cpp:344-560`) as single-frame tasks (reverse-strand
    blocks are reverse-complemented so every block scans forward frame 0,
    equivalent to `extractTargetKmers`' strand-aware scan,
    `KmerExtractor.cpp:407-426`). CDS-derived tasks pass through untouched.
    Training sequences >= 100 kb (non-Eukaryota) use the bit-exact Prodigal
    single-mode port; the reference's meta mode (< 100 kb or Eukaryota)
    falls back to the self-training stand-in — Prodigal's metagenomic
    models are absent from the reference checkout (see db/genes.py)."""
    from .genes import GenePredictor

    timer = timer or BuildTimer(torch.device("cpu"))
    out: list[SeqTask] = []
    by_sp: dict[int, list[SeqTask]] = {}
    for t in tasks:
        if t.single_frame:
            out.append(t)
        else:
            by_sp.setdefault(t.species, []).append(t)
    euk_id = getattr(tax, "eukaryota_id", 0)
    for sp in sorted(by_sp):
        ts = by_sp[sp]
        gp = GenePredictor()
        train_seq = max(ts, key=lambda t: len(t.seq)).seq
        with timer.stage("gene_prediction"):
            gp.train(train_seq,
                     euk=bool(euk_id and tax.is_ancestor(euk_id, sp)))
        # process in reference-style batches (post-add cut rule, same as
        # get_accession_batches) with a per-batch intergenic reset, so this
        # in-memory path and the streaming path produce the same DB for
        # the same inputs (the reference seeds a fresh intergenic list per
        # AccessionBatch)
        batch: list[SeqTask] = []
        blen = 0
        bkmers = 0
        for t in ts:
            batch.append(t)
            blen += len(t.seq)
            bkmers += int(len(t.seq) * 0.4)
            if (
                bkmers > buffer_kmers
                or blen > 100_000_000
                or len(batch) > 300
                or (len(batch) > 100 and blen > 50_000_000)
            ):
                out.extend(_predict_with_trainer(gp, batch, mask_mode,
                                                 mask_prob, timer))
                batch, blen, bkmers = [], 0, 0
        if batch:
            out.extend(_predict_with_trainer(gp, batch, mask_mode, mask_prob,
                                             timer))
    return out


def _build_streaming(
    db_dir, fasta_files, scans, acc2taxid, tax, params, builder,
) -> dict:
    """Batch-streamed build: accessions grouped by the reference's batch
    rules (`get_accession_batches`) and loaded by byte-range seek, so
    peak memory holds one batch (<= ~100 Mbp) instead of every input
    sequence. Gene prediction trains once per species on its longest
    sequence and the trainer is dropped when the species' last batch is
    done (`IndexCreator.cpp:758-783`)."""
    entries: list[AccEntry] = []
    acc_rows = []
    skipped = 0
    for fi, recs in enumerate(scans):
        for ri, rec in enumerate(recs):
            acc = accession_of(rec.name)
            org = acc2taxid.get(acc) or acc2taxid.get(acc.split(".")[0])
            if not org:
                skipped += 1
                continue
            internal = tax.to_internal(org)
            if internal < 0:
                skipped += 1
                continue
            sp = int(tax.species_of[internal])
            entries.append(
                AccEntry(sp, fi, ri, rec.length, internal, rec.offset,
                         rec.end)
            )
            acc_rows.append((acc, org))
    buffer_kmers = max(1 << 22, (params.max_ram << 30) >> 5)
    batches = get_accession_batches(entries, buffer_kmers=buffer_kmers)

    handles = {}
    timer = builder.timer

    def load(e: AccEntry) -> bytes:
        with timer.stage("load"):
            fh = handles.get(e.fasta_idx)
            if fh is None:
                fh = handles[e.fasta_idx] = open(fasta_files[e.fasta_idx],
                                                 "rb")
            return fasta.read_fasta_at(fh, e.offset, e.end)

    trainers: dict[int, object] = {}
    remaining: dict[int, int] = {}
    train_entry: dict[int, AccEntry] = {}
    if params.gene_prediction:
        for b in batches:
            sp = b[0].species
            remaining[sp] = remaining.get(sp, 0) + 1
        for e in entries:
            t = train_entry.get(e.species)
            if t is None or e.length > t.length:
                train_entry[e.species] = e

    n_input_seqs = 0
    try:
        for batch in batches:
            tasks = [
                SeqTask(load(e), e.taxid, e.species) for e in batch
            ]
            n_input_seqs += len(tasks)
            if params.gene_prediction:
                sp = batch[0].species
                gp = trainers.get(sp)
                if gp is None:
                    from .genes import GenePredictor

                    gp = GenePredictor()
                    euk_id = getattr(tax, "eukaryota_id", 0)
                    train_seq = load(train_entry[sp])
                    with timer.stage("gene_prediction"):
                        gp.train(
                            train_seq,
                            euk=bool(euk_id and tax.is_ancestor(euk_id, sp)),
                        )
                    trainers[sp] = gp
                tasks = _predict_with_trainer(gp, tasks, params.mask_mode,
                                              params.mask_prob, timer)
                remaining[sp] -= 1
                if remaining[sp] == 0:
                    del trainers[sp]
            elif params.mask_mode:
                from ..ops.mask import mask_bytes

                with timer.stage("masking"):
                    tasks = [
                        SeqTask(mask_bytes(t.seq, params.mask_prob), t.taxid,
                                t.species)
                        for t in tasks
                    ]
            builder.add_sequences(tasks)
    finally:
        for fh in handles.values():
            fh.close()

    stats = builder.finalize(db_dir, params.db_name)
    stats["sequences"] = n_input_seqs
    stats["skipped_accessions"] = skipped
    with timer.stage("write"):
        with open(os.path.join(db_dir, "acc2taxid.map"), "w") as fh:
            fh.write("accession\ttaxID\n")
            for acc, taxid in acc_rows:
                fh.write(f"{acc}\t{taxid}\n")
    return stats


def _predict_with_trainer(gp, tasks: list[SeqTask], mask_mode: int = 0,
                          mask_prob: float = 0.9,
                          timer: BuildTimer | None = None) -> list[SeqTask]:
    """Gene-block extraction for one batch with a trained predictor
    (the per-sequence part of ``predict_gene_blocks``). The intergenic
    list resets to the post-train seed per batch (the reference seeds a
    fresh ProdigalWrapper per AccessionBatch), so results don't depend
    on the ascending-length batch processing order.

    With masking on, the WHOLE strand-corrected sequence is masked once
    and blocks are cut from the masked copy, while gene prediction and
    the intergenic-kmer hashes read the raw sequence — exactly the
    reference's maskedSeq handling (`IndexCreator.cpp:1082-1099` forward,
    `:1196-1203` reverse-complemented)."""
    from .genes import revcomp

    timer = timer or BuildTimer(torch.device("cpu"))
    gp.reset_intergenic()
    out: list[SeqTask] = []
    for t in tasks:
        seq = t.seq
        with timer.stage("gene_prediction"):
            if not gp.same_strand(seq):
                seq = revcomp(seq)
        mseq = seq
        if mask_mode:
            from ..ops.mask import mask_bytes

            with timer.stage("masking"):
                mseq = mask_bytes(seq, mask_prob)
        with timer.stage("gene_prediction"):
            bs, be, bt = gp.extended_orfs(seq)
        for i in range(len(bs)):
            s = max(0, int(bs[i]))
            e = min(len(seq) - 1, int(be[i]))
            if e - s + 1 < 24:
                continue
            block = mseq[s : e + 1]
            if int(bt[i]) == -1:
                block = revcomp(block)
            out.append(SeqTask(block, t.taxid, t.species, single_frame=True))
    return out


def build_database(
    db_dir: str,
    fasta_list: str,
    acc2taxid_path: str,
    taxonomy_dir: str,
    params: BuildParams | None = None,
    device="cuda",
) -> dict:
    """`metabuli build` workflow (`Metabuli src/workflow/build.cpp:32-120`)."""
    params = params or BuildParams()
    tax = Taxonomy.from_dmp(
        os.path.join(taxonomy_dir, "names.dmp"),
        os.path.join(taxonomy_dir, "nodes.dmp"),
        os.path.join(taxonomy_dir, "merged.dmp"),
    )
    acc2taxid = read_acc2taxid(acc2taxid_path)
    builder = IndexBuilder(params, tax, flush_dir=os.path.join(db_dir, "flush"),
                           device=device)
    timer = builder.timer

    cds_map = {}
    if params.cds_info:
        from .cds import load_cds_info

        cds_map = load_cds_info(params.cds_info)

    with open(fasta_list) as fh:
        fasta_files = [line.strip() for line in fh if line.strip()]

    # batch-streamed path (plain FASTA, no CDS bypass, no accession-level
    # taxa): bounded memory at any input size
    if not cds_map and params.accession_level != 1:
        with timer.stage("scan"):
            scans = [fasta.scan_fasta(p) for p in fasta_files]
        if all(s is not None for s in scans):
            return _build_streaming(
                db_dir, fasta_files, scans, acc2taxid, tax, params, builder
            )

    tasks: list[SeqTask] = []
    acc_rows = []
    skipped = 0
    acc_nodes: list[tuple[int, int, str, str]] = []  # (new org id, parent org, rank, name)
    used_org_ids = set(int(t) for t in tax.internal2org if t > 0)
    next_acc_id = 1
    pending: list[tuple] = []
    for path in fasta_files:
        for rec in _timed_records(path, timer):
            acc = accession_of(rec.name)
            org_taxid = acc2taxid.get(acc) or acc2taxid.get(acc.split(".")[0])
            if not org_taxid:
                skipped += 1
                continue
            internal = tax.to_internal(org_taxid)
            if internal < 0:
                skipped += 1
                continue
            if params.accession_level == 1:
                # fresh smallest-unused external taxid per accession, child
                # of its taxon with rank "accession"
                # (`IndexCreator.cpp:615-664`)
                while next_acc_id in used_org_ids:
                    next_acc_id += 1
                used_org_ids.add(next_acc_id)
                acc_nodes.append((next_acc_id, org_taxid, "accession", acc))
                pending.append((rec.seq, next_acc_id, acc, org_taxid))
                continue
            species = int(tax.species_of[internal])
            if acc in cds_map:
                from .cds import divide_cds_noncds

                src = rec.seq
                if params.mask_mode:
                    # reference: divide the MASKED genome
                    # (`IndexCreator.cpp:1095-1099` devideToCdsAndNonCds
                    # reads maskedSeq)
                    from ..ops.mask import mask_bytes

                    with timer.stage("masking"):
                        src = mask_bytes(rec.seq, params.mask_prob)
                cds_blocks, non_cds = divide_cds_noncds(src, cds_map[acc])
                for block in cds_blocks + non_cds:
                    if len(block) >= 24:
                        tasks.append(
                            SeqTask(block, internal, species, single_frame=True)
                        )
            else:
                tasks.append(SeqTask(rec.seq, internal, species))
            acc_rows.append((acc, org_taxid))
    if params.accession_level == 1 and acc_nodes:
        from .update import extend_taxonomy

        tax = extend_taxonomy(tax, acc_nodes)
        builder.tax = tax
        for seq, acc_org, acc, org_taxid in pending:
            internal = tax.to_internal(acc_org)
            species = int(tax.species_of[internal])
            tasks.append(SeqTask(seq, internal, species))
            acc_rows.append((acc, org_taxid, acc_org))
    n_input_seqs = len(tasks)
    if params.gene_prediction:
        buffer_kmers = max(1 << 22, (params.max_ram << 30) >> 5)
        tasks = predict_gene_blocks(tasks, tax, buffer_kmers,
                                    params.mask_mode, params.mask_prob,
                                    timer)
    elif params.mask_mode:
        from ..ops.mask import mask_bytes

        with timer.stage("masking"):
            tasks = [
                t if t.single_frame
                else SeqTask(mask_bytes(t.seq, params.mask_prob), t.taxid,
                             t.species)
                for t in tasks
            ]
    builder.add_sequences(tasks)
    stats = builder.finalize(db_dir, params.db_name)
    stats["sequences"] = n_input_seqs
    stats["skipped_accessions"] = skipped
    with timer.stage("write"), \
            open(os.path.join(db_dir, "acc2taxid.map"), "w") as fh:
        # 3 columns in accession-level DBs (`IndexCreator.cpp:708-719`)
        if params.accession_level == 1:
            fh.write("accession\ttaxID\taccessionTaxID\n")
            for row in acc_rows:
                fh.write(f"{row[0]}\t{row[1]}\t{row[2]}\n")
        else:
            fh.write("accession\ttaxID\n")
            for acc, taxid in acc_rows:
                fh.write(f"{acc}\t{taxid}\n")
    return stats


def _timed_records(path: str, timer: BuildTimer):
    """``fasta.read_records(path)``, each record's read timed as load."""
    records = fasta.read_records(path)
    while True:
        with timer.stage("load"):
            rec = next(records, None)
        if rec is None:
            return
        yield rec


def filter_common_kmers(values, species, taxonomy: Taxonomy):
    """FilterMode::COMMON_KMER (`IndexCreator.h:538-565`): keep metamers
    shared by more than one species; id := LCA of the member species."""
    from ..native.sort import argsort_pair

    order = argsort_pair(np.asarray(values, np.uint64))
    values = values[order]
    species = species[order]
    if not len(values):
        return values, species.astype(np.uint32)
    new_group = np.ones(len(values), bool)
    new_group[1:] = values[1:] != values[:-1]
    gid = np.cumsum(new_group) - 1
    # group has >1 distinct species?
    sp_change = np.ones(len(values), bool)
    sp_change[1:] = (species[1:] != species[:-1]) | new_group[1:]
    distinct_per_group = np.bincount(gid[sp_change])
    common = distinct_per_group > 1
    lca = taxonomy.lca_segments(species.astype(np.int64), gid)
    keep_groups = np.nonzero(common)[0]
    starts = np.nonzero(new_group)[0]
    return values[starts[keep_groups]], lca[keep_groups].astype(np.uint32)


def filter_unique_kmers(values, taxids):
    """FilterMode::UNIQ_KMER (`IndexCreator.h:566-574`): keep metamers whose
    occurrences all carry the same id."""
    from ..native.sort import argsort_pair

    order = argsort_pair(np.asarray(values, np.uint64), taxids)
    values = values[order]
    taxids = taxids[order]
    if not len(values):
        return values, taxids
    new_group = np.ones(len(values), bool)
    new_group[1:] = values[1:] != values[:-1]
    gid = np.cumsum(new_group) - 1
    id_change = np.ones(len(values), bool)
    id_change[1:] = (taxids[1:] != taxids[:-1]) | new_group[1:]
    distinct = np.bincount(gid[id_change])
    uniq = distinct == 1
    starts = np.nonzero(new_group)[0]
    keep = np.nonzero(uniq)[0]
    return values[starts[keep]], taxids[starts[keep]]
