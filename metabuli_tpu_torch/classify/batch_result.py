"""A batch's classifications as columns.

``BatchResult`` holds what the classification lines and the EM step take
of a batch, as NumPy arrays: per read, and per row of the two row sets the
host finish writes (``taxonomer_finish``, ``taxonomer_assign``). The device
taxonomer's ``drain_columns`` returns it straight from the finish's
buffers; the taxonomers that make a ``ReadClassification`` a read (the
host path, ``--print-log``) come in through ``from_objects``, so one line
writer (``io/line_writer.py``) serves every path. ``objects`` makes the
``ReadClassification``s where a caller needs them.

``BatchReads`` is the form a batch's result takes from the finish to the
writer, whichever taxonomer made it: a sequence of ``ReadClassification``s
that makes them from the columns only when a caller first asks for one,
and hands the writer the columns, taken from the objects once they exist
(so a change a caller made to them is written).
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import NamedTuple

import numpy as np

from .taxonomer import ReadClassification


class BatchResult(NamedTuple):
    """Per read: ``cls`` (uint8, nonzero: classified), ``taxid`` (int32,
    internal) and ``score`` (float32 from the finish, float64 from
    objects). The tax-count rows (read, internal taxid, count) and the EM
    rows (read, species, score^2), each in the finish's order: a read's
    rows in their order, reads in any order."""

    cls: np.ndarray
    taxid: np.ndarray
    score: np.ndarray
    tc_read: np.ndarray
    tc_taxid: np.ndarray
    tc_count: np.ndarray
    em_read: np.ndarray
    em_species: np.ndarray
    em_score: np.ndarray

    @classmethod
    def empty(cls, n_reads: int) -> "BatchResult":
        """``n_reads`` unclassified reads of score 0, with no rows."""
        i64, i32, f32 = (np.zeros(0, t) for t in (np.int64, np.int32,
                                                  np.float32))
        return cls(np.zeros(n_reads, np.uint8), np.zeros(n_reads, np.int32),
                   np.zeros(n_reads, np.float32), i64, i32, i32, i64, i32,
                   f32)

    @classmethod
    def from_objects(cls, results: list) -> "BatchResult":
        """The columns of a list of ``ReadClassification``s: each read's
        tax counts in its dict's order, its species scores in its list's."""
        n = len(results)
        tc = [(i, t, c) for i, rc in enumerate(results)
              for t, c in rc.tax_counts.items()]
        em = [(i, sp, sc) for i, rc in enumerate(results)
              for sp, sc in rc.species_scores]
        tc_read, tc_taxid, tc_count = (
            np.array([r[k] for r in tc], t)
            for k, t in enumerate((np.int64, np.int32, np.int32)))
        em_read, em_species, em_score = (
            np.array([r[k] for r in em], t)
            for k, t in enumerate((np.int64, np.int32, np.float64)))
        return cls(
            np.fromiter((rc.is_classified for rc in results), np.uint8, n),
            np.fromiter((rc.taxid for rc in results), np.int32, n),
            np.fromiter((rc.score for rc in results), np.float64, n),
            tc_read, tc_taxid, tc_count, em_read, em_species, em_score)

    def objects(self) -> list:
        """A ``ReadClassification`` a read, as the finish's rows fill them:
        the rows applied in order, so a later (read, taxid) row overwrites
        an earlier one, and ``top_species`` is a read's first EM row."""
        out = [ReadClassification(is_classified=bool(c), taxid=t, score=s)
               for c, t, s in zip(self.cls.tolist(), self.taxid.tolist(),
                                  self.score.tolist())]
        for r, t, c in zip(self.tc_read.tolist(), self.tc_taxid.tolist(),
                           self.tc_count.tolist()):
            out[r].tax_counts[t] = c
        for r, sp, sc in zip(self.em_read.tolist(), self.em_species.tolist(),
                             self.em_score.tolist()):
            res = out[r]
            res.species_scores.append((sp, sc))
            if not res.top_species:
                res.top_species = sp
        return out

    def take(self, lo: int, hi: int) -> "BatchResult":
        """Reads ``[lo, hi)`` as a batch of their own, their rows' reads
        counted from ``lo``."""
        tc = (self.tc_read >= lo) & (self.tc_read < hi)
        em = (self.em_read >= lo) & (self.em_read < hi)
        return BatchResult(
            self.cls[lo:hi], self.taxid[lo:hi], self.score[lo:hi],
            self.tc_read[tc] - lo, self.tc_taxid[tc], self.tc_count[tc],
            self.em_read[em] - lo, self.em_species[em], self.em_score[em])

    def mappings(self, first: int) -> list:
        """The EM step's (query, species, score^2) triples, query-sorted,
        the batch's reads counted from ``first``."""
        o = np.argsort(self.em_read, kind="stable")
        return list(zip((self.em_read[o] + first).tolist(),
                        self.em_species[o].tolist(),
                        self.em_score[o].tolist()))

    def clade_counts(self, tax_counts: dict) -> None:
        """Add the batch's reads to ``tax_counts`` (internal taxid, 0 for
        the unclassified -> reads), new taxa in the order of their first
        read, as a loop over the reads adds them."""
        t = np.where(self.cls != 0, self.taxid, 0)
        taxa, first, counts = np.unique(t, return_index=True,
                                        return_counts=True)
        for k in np.argsort(first).tolist():
            key = int(taxa[k])
            tax_counts[key] = tax_counts.get(key, 0) + int(counts[k])


class BatchReads(Sequence):
    """A batch's ``ReadClassification`` a read, over its columns: the
    objects are made, all at once, when one is first asked for, and from
    then on they are the batch's result (``columns`` reads them)."""

    def __init__(self, cols: BatchResult | None = None,
                 objects: list | None = None):
        self._cols = cols
        self._objects = objects

    def _made(self) -> list:
        if self._objects is None:
            self._objects = self._cols.objects()
        return self._objects

    def __len__(self) -> int:
        if self._objects is None:
            return len(self._cols.cls)
        return len(self._objects)

    def __getitem__(self, i):
        return self._made()[i]

    def __setitem__(self, i, value) -> None:
        self._made()[i] = value

    @property
    def made(self) -> bool:
        """Whether the batch's objects exist."""
        return self._objects is not None

    def columns(self) -> BatchResult:
        """The batch's columns: the finish's as they came, or, once the
        objects exist, theirs."""
        if self._objects is None:
            return self._cols
        return BatchResult.from_objects(self._objects)

    def take(self, lo: int, hi: int) -> "BatchReads":
        """Reads ``[lo, hi)`` as a batch of their own."""
        if self._objects is None:
            return BatchReads(self._cols.take(lo, hi))
        return BatchReads(objects=self._objects[lo:hi])
