"""The host taxonomers: a batch's sorted matches copied to the host and
assigned read by read there.

Each of the classifier's three taxonomers (these two and the device
taxonomer, ``device_taxonomer.DeviceTaxonomer``) ends a batch's device
stages with ``send(m, read_lens, *, plain, timer) -> HostCopy`` and
finishes it on the host with ``drain(host, read_lens, n_reads) ->
BatchReads``; ``serial`` says whether its finish must run on the thread
that dispatches (the pipeline then has no worker). The classifier knows
nothing else of them.

  HostTaxonomer  (``--device-tax 0``, the reduced alphabet) the native
                 ``taxonomer_assign`` over each read's match range;
  LogTaxonomer   (``--print-log``) the Python ``Taxonomer`` read by read,
                 which prints each species' match paths; it holds the
                 interpreter lock throughout and prints, so it is serial.
"""

from __future__ import annotations

import numpy as np

from .batch_result import BatchReads
from .native_taxonomer import NativeTaxonomer
from .pipeline import (FIELDS, HostCopy, MatchColumns, matches_to_host,
                       to_host_async)
from .taxonomer import ReadClassification, Taxonomer, TaxonomerParams


class _HostMatches:
    """A batch's sorted match columns to the host, as the reference
    package's host match dict with each read's range of its rows."""

    serial = False

    def send(self, m: MatchColumns, read_lens, *, plain: bool = False,
             timer=None) -> HostCopy:
        """Queue the copy of the sorted match columns to the host."""
        return to_host_async(m)

    @staticmethod
    def _matches(host: HostCopy, n_reads: int):
        """(the host match dict, each read's first row, one past its last
        row)."""
        m = matches_to_host(MatchColumns(*host.wait()))
        reads = np.arange(n_reads)
        return (m, np.searchsorted(m["qid"], reads, side="left"),
                np.searchsorted(m["qid"], reads, side="right"))


class HostTaxonomer(_HostMatches):
    """The native ``taxonomer_assign`` on the host."""

    def __init__(self, params: TaxonomerParams, taxonomy, threads: int = 0):
        self._nt = NativeTaxonomer(params, taxonomy, threads=threads)

    def drain(self, host: HostCopy, read_lens: np.ndarray,
              n_reads: int) -> BatchReads:
        m, starts, ends = self._matches(host, n_reads)
        return BatchReads(objects=self._nt.assign_batch(
            m, starts, ends, read_lens)[0])


class LogTaxonomer(_HostMatches):
    """The Python ``Taxonomer`` read by read, printing as it goes."""

    serial = True

    def __init__(self, params: TaxonomerParams, taxonomy):
        self._tx = Taxonomer(params, taxonomy)

    def drain(self, host: HostCopy, read_lens: np.ndarray,
              n_reads: int) -> BatchReads:
        m, starts, ends = self._matches(host, n_reads)
        out = []
        for lo, hi, rl in zip(starts.tolist(), ends.tolist(),
                              read_lens.tolist()):
            if lo == hi:
                out.append(ReadClassification(score=0.0))
                continue
            sub = {k: m[k][lo:hi] for k in FIELDS}
            out.append(self._tx.choose_best_taxon(sub, rl))
        return BatchReads(objects=out)
