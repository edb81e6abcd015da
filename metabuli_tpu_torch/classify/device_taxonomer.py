"""Device taxonomer: sorted matches -> per-read classifications.

Counterpart of ``metabuli_tpu.classify.device_taxonomer`` (the default
classify path): on the device, chain DP (K3) -> path compaction ->
combination (K4) -> group compaction, and per-(read, species, quotient)
best taxids aggregated to (read, species, taxid, count) runs; on the host,
the reference package's finish (`chooseBestTaxon`, `Taxonomer.cpp:130-202`)
carried over unchanged: per-read species selection, min-score branches,
the below-species BFS and EM mappings, through the native library.

Every device stage is sized exactly, so the reference package's grid
hints, overflow flags, retry ladder and host re-combine have no
counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .batch_result import BatchReads, BatchResult
from .device_chain import chain_matches, chain_matches_plain
from .device_combine import combine_paths, combine_paths_plain, sort_paths
from .device_compact import compact_groups, compact_paths
from .device_redundancy import device_taxonomy, quotient_best
from .native_taxonomer import NativeTaxonomer
from .pipeline import HostCopy, MatchColumns, sort_by_keys, to_host_async
from .taxonomer import TaxonomerParams


class TaxCounts(NamedTuple):
    """Quotient-row counts per (read, species, taxid), in that order."""

    read: torch.Tensor
    species: torch.Tensor
    taxid: torch.Tensor
    count: torch.Tensor


def taxonomer_tail(m: MatchColumns, dt, min_depth: torch.Tensor,
                   read_lens: torch.Tensor, *, dna_shift: int,
                   max_shift: int, kmer_format: int = 2, plain: bool = False,
                   timer=None):
    """Sorted match columns -> (FlatGroups, TaxCounts).

    ``plain=True`` runs the plain versions of K3 and K4 wherever the
    tensors lie; ``timer`` (optional) marks stage boundaries."""
    mark = timer.mark if timer is not None else (lambda name: None)
    frame = m.packed & 7
    ham = (m.packed >> 3) & 0xFF
    h16 = (m.packed >> 11) & 0xFFFF
    chain = (chain_matches_plain if plain else chain_matches)(
        m.qid, m.species, frame, m.pos, ham, m.dna, h16, min_depth,
        max_shift=max_shift, kmer_format=kmer_format)
    mark("chain")
    paths, group_start = sort_paths(
        compact_paths(chain, m.qid, m.species, m.pos, h16))
    score = (combine_paths_plain if plain else combine_paths)(
        paths, group_start, read_lens)
    groups = compact_groups(paths, group_start, score)
    mark("combine")
    q = quotient_best(dt, m.qid, m.species, m.pos, ham, m.taxid,
                      dna_shift=dna_shift)
    i64 = lambda x: x.to(torch.int64)
    rr, rs, rt = sort_by_keys(
        [(i64(q.row_read) << 32) | i64(q.row_species), i64(q.row_taxid)],
        (q.row_read, q.row_species, q.row_taxid))
    n = rr.numel()
    new = torch.ones(n, dtype=torch.bool, device=rr.device)
    if n:
        new[1:] = (rr[1:] != rr[:-1]) | (rs[1:] != rs[:-1]) | (rt[1:] != rt[:-1])
    heads = torch.nonzero(new).squeeze(1)
    count = torch.diff(heads, append=heads.new_full((1,), n))
    mark("quotient")
    return groups, TaxCounts(rr[heads], rs[heads], rt[heads],
                             count.to(torch.int32))


class DeviceTaxonomer:
    """Batch taxonomer on the device; the host finishes per read. The
    classifier's default taxonomer: ``send`` ends a batch's device stages
    and ``drain`` finishes it on a worker thread (``host_taxonomers``
    holds the other two)."""

    serial = False

    def __init__(self, params: TaxonomerParams, taxonomy, device="cpu",
                 threads: int = 0):
        self.p = params
        self.tax = taxonomy
        self.device = torch.device(device)
        self.dt = device_taxonomy(taxonomy, self.device)
        # the host finish runs through the native library; a failed build
        # raises here, not at the first batch
        self._nt = NativeTaxonomer(params, taxonomy, threads=threads)
        # euk-aware min depth per species (dense internal ids)
        n = taxonomy.n_nodes()
        euk = np.zeros(n + 1, bool)
        if taxonomy.eukaryota_id:
            e = taxonomy.eukaryota_id
            for i in range(1, n + 1):
                euk[i] = taxonomy.is_ancestor(e, i)
        self.min_depth = torch.as_tensor(np.where(
            euk, params.min_cons_cnt_euk, params.min_cons_cnt
        ).astype(np.int32), device=self.device)

    def tail(self, m: MatchColumns, read_lens_by_qid, *, plain: bool = False,
             timer=None):
        """``taxonomer_tail`` of sorted match columns with this
        taxonomer's tables: the handle ``start_drain`` copies out."""
        rl = torch.as_tensor(
            np.maximum(np.asarray(read_lens_by_qid, np.int32), 0)
            if len(read_lens_by_qid) else np.zeros(1, np.int32),
            device=self.device)
        return taxonomer_tail(
            m, self.dt, self.min_depth, rl, dna_shift=self.p.dna_shift,
            max_shift=self.p.max_codon_shift, kmer_format=self.p.kmer_format,
            plain=plain, timer=timer)

    def send(self, m: MatchColumns, read_lens_by_qid, *, plain: bool = False,
             timer=None) -> HostCopy:
        """End a batch's device stages: ``tail``, then ``start_drain``."""
        return self.start_drain(self.tail(m, read_lens_by_qid, plain=plain,
                                          timer=timer))

    def start_drain(self, handle) -> HostCopy:
        """End a batch's dispatch: queue the copies of the small group and
        taxcount tensors to pinned host memory (``to_host_async``)."""
        groups, taxcnt = handle
        return to_host_async([*groups, *taxcnt])

    def drain_columns(self, host: HostCopy, read_lens_by_qid: np.ndarray,
                      n_reads: int) -> BatchResult:
        """Wait for a ``start_drain`` copy and finish the batch on the
        host: its ``BatchResult``, straight from the native finish's
        buffers. Launches no CUDA work, so it may run on a worker thread
        beside the next batch's dispatch."""
        g = [t.numpy() for t in host.wait()]
        if len(g[0]) == 0:
            return BatchResult.empty(n_reads)
        return self._finish(g[0], g[1], g[2].astype(np.float32), *g[3:],
                            read_lens_by_qid, n_reads)

    def drain(self, host: HostCopy, read_lens_by_qid: np.ndarray,
              n_reads: int) -> BatchReads:
        """``drain_columns`` as a ``ReadClassification`` a read, made
        when a caller first asks for one (``BatchReads``)."""
        return BatchReads(self.drain_columns(host, read_lens_by_qid,
                                             n_reads))

    def _finish(self, g_read, g_sp, g_score, run_read, run_sp, run_tax,
                run_cnt, read_lens_by_qid, n_reads) -> BatchResult:
        """Host finish through the native library (OpenMP): per-read
        species selection (ties -> LCA), min-score branches, below-species
        BFS (`chooseBestTaxon`, `Taxonomer.cpp:130-202`). Its output
        buffers hold every possible row (at most 10 EM mappings per read,
        one tax count per run or read), so a nonzero return is a fault."""
        import ctypes

        nt = self._nt
        p = self.p
        lib = nt.lib
        a32 = lambda x: np.ascontiguousarray(x, np.int32)
        out_taxid = np.zeros(n_reads, np.int32)
        out_score = np.zeros(n_reads, np.float32)
        out_cls = np.zeros(n_reads, np.uint8)
        map_cap = (10 * n_reads) if p.em else 1
        mp_read = np.zeros(map_cap, np.int64)
        mp_sp = np.zeros(map_cap, np.int32)
        mp_score = np.zeros(map_cap, np.float32)
        mp_used = ctypes.c_int64(0)
        tc_cap = max(1024, len(run_read) + n_reads)
        tc_read = np.zeros(tc_cap, np.int64)
        tc_tax = np.zeros(tc_cap, np.int32)
        tc_cnt = np.zeros(tc_cap, np.int32)
        tc_used = ctypes.c_int64(0)
        rl = np.zeros(n_reads, np.int32)
        rl[: len(read_lens_by_qid)] = read_lens_by_qid[:n_reads]
        rc = lib.taxonomer_finish(
            ctypes.c_int64(len(g_read)), a32(g_read).ctypes,
            a32(g_sp).ctypes,
            np.ascontiguousarray(g_score, np.float32).ctypes,
            ctypes.c_int64(len(run_read)), a32(run_read).ctypes,
            a32(run_sp).ctypes, a32(run_tax).ctypes, a32(run_cnt).ctypes,
            ctypes.c_int64(n_reads), rl.ctypes,
            ctypes.c_int32(self.tax.n_nodes()),
            nt._parent.ctypes, nt._euler_first.ctypes,
            nt._euler_node.ctypes, nt._sparse.ctypes,
            nt._euler_depth.ctypes,
            ctypes.c_int32(nt._sparse.shape[0]),
            ctypes.c_int64(nt._sparse.shape[1]),
            nt._tin.ctypes, nt._tout.ctypes, nt._species_of.ctypes,
            nt._leafish.ctypes, ctypes.c_int32(self.tax.eukaryota_id),
            ctypes.c_float(p.min_score), ctypes.c_float(p.min_sp_score),
            ctypes.c_float(p.tie_ratio), ctypes.c_int32(p.denominator),
            ctypes.c_int32(p.accession_level),
            ctypes.c_int32(1 if p.em else 0),
            ctypes.c_int32(0),
            out_taxid.ctypes, out_score.ctypes, out_cls.ctypes,
            ctypes.c_int64(tc_cap), tc_read.ctypes, tc_tax.ctypes,
            tc_cnt.ctypes, ctypes.byref(tc_used),
            ctypes.c_int64(map_cap), mp_read.ctypes, mp_sp.ctypes,
            mp_score.ctypes, ctypes.byref(mp_used),
        )
        if rc != 0:
            raise RuntimeError(f"native taxonomer_finish returned {rc}")
        tc, mp = int(tc_used.value), int(mp_used.value)
        return BatchResult(out_cls, out_taxid, out_score, tc_read[:tc],
                           tc_tax[:tc], tc_cnt[:tc], mp_read[:mp],
                           mp_sp[:mp], mp_score[:mp])
