"""Out-of-core classification: the DB streamed through the card in
AA-aligned chunks.

Counterpart of ``metabuli_tpu.classify.chunked`` (the ``--max-ram``
analogue of the reference's buffered merge-join,
`KmerMatcher.cpp:212-265`): a table larger than its device budget, or too
large to build on the card at once, is cut into chunks at amino-acid group
boundaries (``chunk_bounds``), so each group, and with it every query's
candidate window and Hamming cutoff, lies in exactly one chunk. Each batch
runs against every chunk in turn and the chunks' matches are merged by the
match sort (``pipeline.classify_core``).

Where the reference package rebuilds each chunk's device index on every
pass, the port builds each chunk once on the device, keeps its tables in
pinned host memory and copies one chunk at a time into device buffers
sized for the largest chunk, so the device holds one chunk's tables. Empty
chunks (a small budget asks for more chunks than there are groups) are
dropped: they hold no rows and change no output.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .pipeline import DevIndex, build_dev_index

# device bytes per table row: taxdna + d48 (16) + a group's grest, gstart,
# gend (12, at most one group per row); a reduced index holds tword (4)
# in place of d48 and its bucket records (16 B for each bucket, about two
# a group) in place of prefix
BYTES_PER_ROW = 28
# device bytes per table row at the peak of the index build (sort keys,
# permutation and expansion temporaries): 22.8 GiB for 2^28 rows, measured
# on an H100 80GB HBM3 (chip_smoke.py's skew DB)
BUILD_BYTES_PER_ROW = 92

TABLES = ("grest", "gstart", "gend", "taxdna", "d48", "prefix", "brec",
          "tword")


def chunk_bounds(
    values: np.ndarray, n_chunks: int, reduced: bool = False
) -> list[tuple[int, int]]:
    n = len(values)
    aa = values >> np.uint64(32 if reduced else 24)
    bounds = [0]
    for s in range(1, n_chunks):
        target = s * n // n_chunks
        while 0 < target < n and aa[target] == aa[target - 1]:
            target += 1
        bounds.append(min(target, n))
    bounds.append(n)
    return list(zip(bounds[:-1], bounds[1:]))


def build_chunks(rows: int, free_bytes: int) -> int:
    """The fewest chunks whose index build, at BUILD_BYTES_PER_ROW, fits
    in ``free_bytes`` of device memory less a GiB (at least 256 MiB)."""
    room = max(free_bytes - (1 << 30), 1 << 28)
    return max(1, -(-rows * BUILD_BYTES_PER_ROW // room))


def pin(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in pinned host memory; raises if the memory cannot
    be pinned (an unpinned copy would make every chunk copy synchronous)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    if not h.is_pinned():
        raise RuntimeError("could not pin host memory for a DB chunk")
    h.copy_(t)
    return h


class ChunkedIndex:
    """The table as AA-aligned ``DevIndex`` chunks, streamed through
    ``device`` one at a time (``on_device``).

    ``budget_bytes`` is the device budget of one chunk at ``BYTES_PER_ROW``
    (``--max-ram``); ``min_chunks`` raises the count, e.g. so that one
    chunk's index build fits the card's free memory."""

    def __init__(self, values: np.ndarray, taxids: np.ndarray,
                 budget_bytes: int, reduced: bool = False, device="cpu",
                 min_chunks: int = 1, kmer_format: int = 2):
        need = len(values) * BYTES_PER_ROW
        self.n_chunks = max(1, -(-need // max(1, budget_bytes)), min_chunks)
        self.reduced = reduced
        self.kmer_format = kmer_format
        self.device = torch.device(device)
        # past one chunk a row, more chunks only add empty ones
        bounds = chunk_bounds(values, min(self.n_chunks, max(1, len(values))),
                              reduced)
        self.bounds = [(a, b) for a, b in bounds if b > a] or [(0, 0)]
        cuda = self.device.type == "cuda"
        self.chunks: list[DevIndex] = []
        for a, b in self.bounds:
            ix = build_dev_index(values[a:b], taxids[a:b], kmer_format,
                                 device=device, reduced=reduced)
            if cuda:  # built on the card, kept pinned on the host
                ix = dataclasses.replace(ix, **{
                    k: pin(getattr(ix, k)) for k in TABLES
                    if getattr(ix, k) is not None})
            self.chunks.append(ix)
        # one set of device buffers, each as large as its largest chunk
        self._buf = {}
        if cuda:
            for k in TABLES:
                ts = [getattr(ix, k) for ix in self.chunks]
                if ts[0] is not None:
                    self._buf[k] = torch.empty(max(t.numel() for t in ts),
                                               dtype=ts[0].dtype,
                                               device=self.device)

    @property
    def device_bytes(self) -> int:
        """Bytes of the device buffers that hold the resident chunk."""
        return sum(b.numel() * b.element_size() for b in self._buf.values())

    def on_device(self, mark=None):
        """Yield each chunk's ``DevIndex`` on the device in turn. On the
        card each chunk's tables are copied (asynchronously, on the
        current stream) into the shared buffers, overwriting the previous
        chunk's: the caller finishes its work on a chunk, on the same
        stream, before it asks for the next. ``mark`` (optional) marks the
        end of each copy as ``chunk_copy``."""
        for ix in self.chunks:
            if self._buf:
                ix = dataclasses.replace(ix, **{
                    k: self._buf[k][:getattr(ix, k).numel()].view(
                        getattr(ix, k).shape).copy_(getattr(ix, k),
                                                    non_blocking=True)
                    for k in self._buf})
            if mark is not None:
                mark("chunk_copy")
            yield ix
