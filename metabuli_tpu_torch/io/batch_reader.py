"""Batches of query reads as the device's host arrays, read natively.

``BatchReader`` streams one query file, or a pair, through
``native/batch_reader.cpp`` and yields ``ReadBatch``es: a batch's names,
read lengths and padded code matrix with its row lengths, position offsets
and qids, made in C++ without the interpreter lock and without a Python
object per read (but each name's ``str``). Its results are those of the
record parser (``fasta.read_records``), batched as the classifier batches
and encoded by ``genetic_code.encode_seqs_padded``:
``tests/test_torch_batch_reader.py`` holds it to that path.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple

import numpy as np

from .. import native
from ..ops.genetic_code import CHAR_CODE, INVALID
from . import fasta

_ERR_HEADER, _ERR_PLUS, _ERR_PAIRS, _ERR_READ = -1, -2, -3, -4
_ERR_CAP = 64
# the reader looks every byte up in this table
_TABLE = np.ascontiguousarray(CHAR_CODE, np.uint8)
if _TABLE.shape != (256,):
    raise ValueError(f"CHAR_CODE has {_TABLE.shape} entries, not 256")


class ReadBatch(NamedTuple):
    """A batch of reads (a pair is one read) as the device stages take
    them: a row a mate, the rows of read i before those of read i + 1."""

    names: list            # str a read: its header's first token
    read_lens: np.ndarray  # int32 [reads]: usedLen(mate 1) + usedLen(mate 2)
    codes: np.ndarray      # uint8 [rows, longest row]: base codes, INVALID pad
    lens: np.ndarray       # int32 [rows]
    pos: np.ndarray        # int32 [rows]: 0, or usedLen(mate 1) + 3 for mate 2
    qid: np.ndarray        # int32 [rows]: the row's read

    def take(self, lo: int, hi: int) -> "ReadBatch":
        """Reads ``[lo, hi)`` as a batch of their own: qids from 0, the
        code matrix cut to their longest row."""
        r0, r1 = (int(r) for r in np.searchsorted(self.qid, (lo, hi)))
        lens = self.lens[r0:r1]
        width = int(lens.max()) if r1 > r0 else 0
        return ReadBatch(self.names[lo:hi], self.read_lens[lo:hi],
                         np.ascontiguousarray(self.codes[r0:r1, :width]),
                         lens, self.pos[r0:r1], self.qid[r0:r1] - lo)


class BatchReader:
    """Iterator of the ``ReadBatch``es of ``q1`` (and ``q2``, its mates):
    each ends at ``batch_reads`` reads, or before the read that would pass
    ``batch_bases`` bases (if set; at least one read a batch), after
    ``skip`` records of each file. Plain or gzip, FASTA or FASTQ, each
    file's format read from its first byte. A malformed FASTQ record, or
    ``q2`` ending before ``q1``, raises ``ValueError`` when the batch
    holding it is asked for. ``bytes`` counts the files' bytes read so far
    (decompressed). Closed at its end, by ``close``, or when collected."""

    def __init__(self, q1: str, q2: str | None, batch_reads: int,
                 batch_bases: int = 0, skip: int = 0):
        self.batch_reads, self.batch_bases = batch_reads, batch_bases
        self.bytes = 0
        for path in (q1, q2):
            if path:
                open(path, "rb").close()  # a missing file raises as open does
        self._lib = lib = native.get_lib()
        h = lib.br_open(q1.encode(), q2.encode() if q2 else None,
                        fasta.is_fastq(q1), bool(q2) and fasta.is_fastq(q2),
                        skip)
        if not h:
            raise OSError(f"cannot read {q1}" + (f" or {q2}" if q2 else ""))
        self._h = h
        self._close = weakref.finalize(self, lib.br_close, h)
        self._info = np.zeros(8, np.int64)
        self._err = ctypes.create_string_buffer(_ERR_CAP)

    def __iter__(self):
        return self

    def close(self) -> None:
        self._close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __next__(self) -> ReadBatch:
        if not self._close.alive:
            raise StopIteration
        lib, info = self._lib, self._info
        try:
            n = lib.br_read(self._h, self.batch_reads, self.batch_bases,
                            info.ctypes.data, self._err, _ERR_CAP)
            self.bytes = int(info[6])
            if n < 0:
                raise self._error(n, self._err.raw[:int(info[7])])
            if n == 0:
                raise StopIteration
            return self._fill(*info[:6].tolist())
        except BaseException:
            self.close()
            raise

    def _error(self, code: int, detail: bytes) -> Exception:
        if code == _ERR_HEADER:
            return ValueError(f"malformed FASTQ header: {detail!r}")
        if code == _ERR_PLUS:
            return ValueError("malformed FASTQ: missing '+' line")
        if code == _ERR_PAIRS:
            return ValueError("paired-end files have different read counts")
        if code == _ERR_READ:
            return EOFError("a query file ended before its compressed "
                            "stream did, or is not valid gzip")
        return RuntimeError(f"batch reader failed ({code})")

    def _fill(self, reads, rows, width, name_bytes, hdr_bytes, n_slow
              ) -> ReadBatch:
        codes = np.empty((rows, width), np.uint8)
        lens, pos, qid = (np.empty(rows, np.int32) for _ in range(3))
        read_lens = np.empty(reads, np.int32)
        names = np.empty(name_bytes, np.uint8)
        hdr = np.empty(hdr_bytes, np.uint8)
        hdr_off = np.empty(reads + 1, np.int64)
        slow = np.empty(n_slow, np.int32)
        rc = self._lib.br_fill(
            self._h, _TABLE.ctypes.data, INVALID, reads, rows, width,
            name_bytes, hdr_bytes, n_slow,
            *(a.ctypes.data for a in (codes, lens, pos, qid, read_lens,
                                      names, hdr, hdr_off, slow)))
        if rc != 0:
            raise RuntimeError(f"batch reader failed ({rc})")
        # each name ends in '\n'; a slow header's name is cut in Python
        name_list = names.tobytes().decode("ascii").split("\n")
        name_list.pop()
        for i in slow.tolist():
            a, b = int(hdr_off[i]), int(hdr_off[i + 1])
            name_list[i] = fasta._split_header(hdr[a:b].tobytes())[0]
        return ReadBatch(name_list, read_lens, codes, lens, pos, qid)
