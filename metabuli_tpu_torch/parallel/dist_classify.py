"""Multi-process / multi-device classification.

Counterpart of ``metabuli_tpu.parallel.dist_classify``: every process
joins the process group, and all iterate the SAME sequence of global read
batches of ``per_row * n_data`` reads. Each process runs its data row's
reads against its db shard and writes the reads it owns to a part file
``.{job}_part{rank}.tsv``; after a barrier process 0 merges the parts by
the reads' global index into the classifications, the report and the
Krona file.

The fused route (the device taxonomer's tail on merged match columns,
``mesh.sharded_fused``) is the all_to_all where a row's shards lie in
several processes: each db rank receives every shard's matches of its
range of the row's reads, tails and writes only those. Where one process
holds the row (``--db-shards N`` alone, or one shard a row) it is the
gather. ``--reduced-aa 1`` and ``METABULI_TPU_DIST_FUSED=0`` take the plain
route (``mesh.sharded_classify``: the gather and the one sort), and the
row's db rank 0 assigns the row's reads on the host.

The batches run through the single-card classifier's depth-2 pipeline
(``Classifier._run_batches``), each rank dispatching on its main thread
(the db axis's collectives are there) while its worker finishes the batch
before. Choices the ranks must share are agreed by all_reduce, as the
reference package's ``process_allgather`` agrees on its hints: the size of
an automatic batch (``--batch-reads 0``), which each rank derives from its
own free device memory, takes the smallest over every process before the
first batch; an all_to_all whose segment outgrew its block (agreed over
the db group before the exchange) runs the batch again at the row's
longest segment on every rank of the row. Every stage is sized exactly,
so the reference package's first-batch size hints have no counterpart.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..classify.batch_result import BatchReads
from ..classify.classifier import Classifier, Job
from ..csrc import build
from ..io.batch_reader import ReadBatch
from ..params import ClassifyParams
from . import distributed as dist
from .mesh import A2A_OVERFLOW, Mesh, sharded_classify, sharded_fused


class ShardedClassifier(Classifier):
    """The classifier of one rank of a (data, db) mesh: its db shards on
    its device, its data row's reads of each global batch."""

    # the all_to_all route's block rows (0: its budget rule)
    a2a_budget = 0

    def __init__(self, db_dir: str, params: ClassifyParams, mesh: Mesh):
        self.mesh = mesh
        # the reference package's distributed run: the fused (device)
        # taxonomer unless the alphabet is reduced or
        # METABULI_TPU_DIST_FUSED=0, then the native host assign; no
        # --print-log, no EM
        params.print_log = 0
        params.em = 0
        params.device_tax = int(
            os.environ.get("METABULI_TPU_DIST_FUSED", "1") != "0")
        super().__init__(db_dir, params, device=mesh.device)
        # every rank must cut the same global batches
        params.batch_reads, self.batch_bases = mesh.agree(
            [params.batch_reads, self.batch_bases], "min", world=True)
        self.per_row = max(1, params.batch_reads // mesh.n_data)
        params.batch_reads = self.per_row * mesh.n_data
        self.route = ("plain" if self.mode != "device" else "alltoall"
                      if mesh.grouped and mesh.n_db > 1 else "gather")
        self._seen = 0  # reads of the batches dispatched so far

    def _build_index(self, values: np.ndarray, taxids: np.ndarray):
        self.bounds, shards = dist.distribute_index(
            values, taxids, self.mesh, self.par.kmer_format,
            bool(self.par.reduced_aa))
        return shards

    def _own(self, n: int) -> range:
        """The reads of an ``n``-read row this process writes: its range
        of them on the all_to_all route, all of them on the row's db rank
        0 otherwise."""
        if self.route == "alltoall":
            stride = -(-n // self.mesh.n_db)
            j = self.mesh.rank % self.mesh.n_db
            return range(min(n, j * stride), min(n, (j + 1) * stride))
        return range(n) if self.mesh.writer else range(0)

    def _dispatch(self, reads: ReadBatch, plain: bool = False,
                  batch: int = 0) -> Job:
        """This data row's reads of a global batch through the sharded
        step; a row without reads (the last batch) skips it on every rank
        of the row."""
        first = self._seen
        self._seen += len(reads.names)
        reads, lo = dist.distribute_reads(reads, self.mesh, self.per_row)
        first += lo
        if not reads.names:
            return Job([], None, np.zeros(0, np.int32), [], first, batch)
        return super()._dispatch(reads, plain=plain,
                                 batch=batch)._replace(
            first=first)

    def _device_stages(self, blocks, read_lens, plain: bool):
        core = dict(cap=self.cap, syncmer=bool(self.par.syncmer),
                    smer_len=self.par.smer_len, plain=plain, timer=self.timer)
        args = (self.mesh, self.dev_index, self.d_species)
        own = self._own(len(read_lens))
        if self.route == "plain":
            m, counts = sharded_classify(*args, blocks, **core)
            return (self.taxonomer.send(m, read_lens, plain=plain,
                                        timer=self.timer)
                    if own else None), counts
        dtx, budget = self.taxonomer, self.a2a_budget
        while True:
            [(handle, counts)] = sharded_fused(
                *args, dtx, read_lens, blocks, route=self.route,
                a2a_budget=budget, **core)
            if not counts.get("tax_overflow", 0) & A2A_OVERFLOW:
                break
            budget = counts["a2a_segment"]
        return (dtx.start_drain(handle) if own else None), counts

    def _finish_batch(self, job: Job):
        """The batch's results of the reads this process writes."""
        if job.host is None:
            t = time.perf_counter()
            return BatchReads(objects=[]), (t, t, 0.0)
        own = self._own(len(job.names))
        results, clock = super()._finish_batch(job)
        return results.take(own.start, own.stop), clock

    def classify_file(self, q1: str, q2: str | None, out_dir: str,
                      job_id: str, resume: bool = False) -> dict:
        """Classify, write this rank's part, and (process 0, after a
        barrier) merge the parts into the run's outputs."""
        mesh = self.mesh
        os.makedirs(out_dir, exist_ok=True)
        part = os.path.join(out_dir, f".{job_id}_part{mesh.rank}.tsv")

        def emit(job, results):
            # each line after its read's global index and a tab
            own = self._own(len(job.names))
            self._write_lines(fh, results, job.names[own.start:own.stop],
                              job.read_lens[own.start:own.stop],
                              index_base=job.first + own.start)

        t_run = time.perf_counter()
        with (open(part, "wb") as fh,
              self._iter_batches(q1, q2) as reader):
            run = self._run_batches(reader, emit)
        classify_s = time.perf_counter() - t_run
        mesh.barrier()
        summary = {
            **self.stats, "reads": self._seen, "rank": mesh.rank,
            "mesh": [mesh.n_data, mesh.n_db], "backend": mesh.backend,
            "route": self.route,
            "shard_rows": self.dev_index.rows,
            "load_s": self.load_s, "classify_s": classify_s,
            "stage_ms": self.timer.ms, "parse_bytes": reader.bytes,
            **run, **mesh.stats,
            "launches": {k: v for k, v in build.launches.items() if v},
        }
        if self.device.type == "cuda":
            summary["peak_mem_gib"] = (
                torch.cuda.max_memory_allocated(self.device) / 2**30)
        if mesh.rank == 0:
            summary["classified"] = self._merge_parts(out_dir, job_id)
        mesh.barrier()
        return summary

    def _merge_parts(self, out_dir: str, job_id: str) -> int:
        """Process 0: every part's rows sorted by global index into the
        classifications file, then the report and the Krona file of their
        clade counts. Returns the classified reads."""
        rows = []
        for p in range(self.mesh.world):
            path = os.path.join(out_dir, f".{job_id}_part{p}.tsv")
            if not os.path.exists(path):
                continue
            with open(path) as fh:
                for line in fh:
                    gidx, rest = line.split("\t", 1)
                    rows.append((int(gidx), rest))
        rows.sort(key=lambda x: x[0])
        tax_counts: dict[int, int] = {}
        cls_path = os.path.join(out_dir, f"{job_id}_classifications.tsv")
        with open(cls_path, "w") as fh:
            fh.write(self.reporter.classification_header())
            for _, rest in rows:
                fh.write(rest)
                cols = rest.split("\t")
                t = (self.taxonomy.to_internal(int(cols[2]))
                     if cols[0] == "1" else 0)
                tax_counts[max(t, 0)] = tax_counts.get(max(t, 0), 0) + 1
        self._write_reports(out_dir, job_id, tax_counts, len(rows))
        return len(rows) - tax_counts.get(0, 0)


def classify_distributed(
    db_dir: str,
    q1: str,
    q2: str | None,
    out_dir: str,
    job_id: str,
    par: ClassifyParams,
    coordinator: str | None,
    num_processes: int,
    process_id: int,
    n_db: int | None = None,
    device: str = "cuda",
    backend: str | None = None,
) -> dict:
    """One process's part of a classify over a (data, db) mesh (see the
    module docstring); process 0's summary also counts the classified
    reads."""
    dev, backend, world, rank = dist.initialize(
        coordinator, num_processes, process_id, backend, device)
    try:
        mesh = dist.global_mesh(n_db, dev, backend, world, rank)
        clf = ShardedClassifier(db_dir, par, mesh)
        return clf.classify_file(q1, q2, out_dir, job_id)
    finally:
        dist.shutdown()
