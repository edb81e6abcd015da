"""Classification lines from a batch's result columns, written natively.

``LineWriter`` turns a ``BatchResult`` (``classify/batch_result.py``) and
its reads' names and lengths into the bytes that
``Reporter.write_classifications`` (``io/report.py``, a copy of the JAX
package's) writes for the same reads, in one call of
``native/line_writer.cpp``, without the interpreter lock and without a
Python object per read. The taxonomy's tables (original taxids, ranks)
are built once; a taxon's lineage (``--lineage 1``) is made the first time
a classified read reaches it. ``tests/test_torch_line_writer.py`` holds
the bytes to ``Reporter``'s.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..classify.batch_result import BatchResult
from .report import Reporter

# a line's bytes besides its name, rank, lineage and tax-count pairs, at
# the most: an index and a tab (21), "1\t" (2), the name's tab (1), an
# int64 taxid and a tab (21), an int32 length and a tab (12), a score and
# a tab (14), the rank's tab (1), "-\t-\t\n" (5)
_LINE_BYTES = 96
_PAIR_BYTES = 33  # an int64 taxid, ':', an int32 count, ' '


def _name_blob(names: list) -> tuple[bytes, np.ndarray]:
    """The names' UTF-8 bytes one after another, and their offsets."""
    joined = "".join(names)
    blob = joined.encode()
    if len(blob) == len(joined):  # ASCII: a character a byte
        lens = np.fromiter(map(len, names), np.int64, len(names))
    else:
        encoded = [name.encode() for name in names]
        blob = b"".join(encoded)
        lens = np.fromiter(map(len, encoded), np.int64, len(names))
    off = np.zeros(len(names) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    return blob, off


class LineWriter:
    """The classification lines of ``reporter``'s taxonomy and lineage
    setting, byte for byte."""

    def __init__(self, reporter: Reporter):
        tax = reporter.tax
        self.tax = tax
        self.header = reporter.classification_header().encode()
        self.print_lineage = reporter.print_lineage
        n = tax.n_nodes()
        self.n_nodes = n
        if tax.use_internal:
            self._orig = np.array(tax.internal2org[:n + 1], np.int64)
            self._orig[0] = 0
        else:
            self._orig = np.arange(n + 1, dtype=np.int64)
        self._rank_id = np.ascontiguousarray(tax.rank_id, np.int32)
        ranks = [r.encode() for r in tax.ranks]
        self._ranks = b"".join(ranks)
        self._rank_off = np.zeros(len(ranks) + 1, np.int64)
        np.cumsum([len(r) for r in ranks], out=self._rank_off[1:])
        self._rank_max = max(map(len, ranks), default=0)
        # each taxon's lineage in _lineages, once a read reached it
        self._lin_start = np.full(n + 1, -1, np.int64)
        self._lin_len = np.zeros(n + 1, np.int64)
        self._lineages = b""
        self._lib = native.get_lib()

    def _add_lineages(self, taxa: np.ndarray) -> None:
        """Make the lineage of each of ``taxa`` that has none yet."""
        taxa = np.unique(taxa)
        new = taxa[self._lin_start[taxa] < 0].tolist()
        if not new:
            return
        parts, at = [self._lineages], len(self._lineages)
        for t in new:
            s = self.tax.lineage(t).encode()
            self._lin_start[t], self._lin_len[t] = at, len(s)
            parts.append(s)
            at += len(s)
        self._lineages = b"".join(parts)

    def lines(self, res: BatchResult, names: list, read_lens: np.ndarray,
              index_base: int | None = None) -> memoryview:
        """The lines of a batch's reads; with ``index_base`` each starts
        with its read's index in the run (``index_base`` + its place in
        the batch) and a tab."""
        n = len(names)
        if not len(res.cls) == len(res.taxid) == len(res.score) == \
                len(read_lens) == n:
            raise ValueError(f"{n} names for {len(res.cls)} results")
        if not len(res.tc_read) == len(res.tc_taxid) == len(res.tc_count):
            raise ValueError("tax-count columns of unequal lengths")
        cls = np.ascontiguousarray(res.cls, np.uint8)
        taxid = np.ascontiguousarray(res.taxid, np.int32)
        score = np.ascontiguousarray(res.score, np.float64)
        rl = np.ascontiguousarray(read_lens, np.int32)
        rows = (np.ascontiguousarray(res.tc_read, np.int64),
                np.ascontiguousarray(res.tc_taxid, np.int32),
                np.ascontiguousarray(res.tc_count, np.int32))
        blob, name_off = _name_blob(names)
        cap = len(blob) + n * (_LINE_BYTES + self._rank_max) \
            + len(rows[0]) * _PAIR_BYTES
        lineage = (None, None)
        if self.print_lineage:
            taxa = taxid[cls != 0]
            if len(taxa) and (taxa.min() < 0 or taxa.max() > self.n_nodes):
                raise ValueError("a classified read's taxid is outside "
                                 "the taxonomy")
            self._add_lineages(taxa)
            cap += int(self._lin_len[taxa].sum()) + len(taxa)
            lineage = (self._lin_start.ctypes.data, self._lin_len.ctypes.data)
        out = np.empty(max(cap, 1), np.uint8)
        used = self._lib.write_lines(
            n, cls.ctypes.data, taxid.ctypes.data, score.ctypes.data,
            rl.ctypes.data, blob, name_off.ctypes.data, len(rows[0]),
            *(a.ctypes.data for a in rows), self.n_nodes,
            self._orig.ctypes.data, self._rank_id.ctypes.data, self._ranks,
            self._rank_off.ctypes.data, *lineage, self._lineages,
            index_base is not None, index_base or 0, out.ctypes.data, cap)
        if used < 0:
            raise RuntimeError(f"native write_lines returned {used}")
        return memoryview(out)[:used]

    def write(self, fh, res: BatchResult, names: list, read_lens: np.ndarray,
              first: bool = False, index_base: int | None = None) -> None:
        """The header (``first``), then the batch's lines, into ``fh``, a
        file open for bytes."""
        if first:
            fh.write(self.header)
        fh.write(self.lines(res, names, read_lens, index_base))
