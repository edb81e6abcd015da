"""The native batch reader (``io/batch_reader.py``,
``native/batch_reader.cpp``) against the record path it replaced in
``classify``: ``fasta.read_records``, the classifier's batching loop and
``encode_seqs_padded``, kept here as the oracle. Each case's batches must
equal the oracle's array for array and name for name."""

from __future__ import annotations

import gzip
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from metabuli_tpu_torch.io import fasta
from metabuli_tpu_torch.io.batch_reader import BatchReader, ReadBatch
from metabuli_tpu_torch.ops.genetic_code import encode_seqs_padded

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _used_len(length: int) -> int:
    return max(0, 3 * ((length - 2) // 3))


def oracle(q1, q2, batch_reads, batch_bases=0, skip=0):
    """The classifier's batches before the native reader: records from
    ``fasta.read_records``, cut by reads or bases, encoded by
    ``encode_seqs_padded``."""
    def batch(names, read_lens, rows):
        codes, lens = encode_seqs_padded([r[0] for r in rows],
                                         max_len=max((len(r[0]) for r in rows),
                                                     default=0))
        return ReadBatch(names, np.array(read_lens, np.int32), codes, lens,
                         np.array([r[2] for r in rows], np.int32),
                         np.array([r[1] for r in rows], np.int32))

    names, read_lens, rows = [], [], []
    bases = 0
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
        rec2 = next(it2, None) if it2 is not None else None
        if it2 is not None and rec2 is None:
            raise ValueError("paired-end files have different read counts")
        n = len(rec1.seq) + (len(rec2.seq) if rec2 is not None else 0)
        if batch_bases and names and bases + n > batch_bases:
            yield batch(names, read_lens, rows)
            names, read_lens, rows, bases = [], [], [], 0
        bases += n
        qid = len(names)
        names.append(rec1.name)
        if rec2 is not None:
            ul1, ul2 = _used_len(len(rec1.seq)), _used_len(len(rec2.seq))
            read_lens.append(ul1 + ul2)
            rows.append((rec1.seq, qid, 0))
            rows.append((rec2.seq, qid, ul1 + 3))
        else:
            read_lens.append(_used_len(len(rec1.seq)))
            rows.append((rec1.seq, qid, 0))
        if len(names) >= batch_reads:
            yield batch(names, read_lens, rows)
            names, read_lens, rows, bases = [], [], [], 0
    if names:
        yield batch(names, read_lens, rows)


def assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.names == w.names
        assert all(type(n) is str for n in g.names)
        for f in ("read_lens", "codes", "lens", "pos", "qid"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert np.array_equal(a, b), f


def _seq(rng, n, alphabet=b"ACGT"):
    return bytes(rng.choice(np.frombuffer(alphabet, np.uint8), n))


def _fastq(records, nl=b"\n"):
    return b"".join(b"@" + h + nl + s + nl + b"+" + nl + b"I" * len(s) + nl
                    for h, s in records)


def _reads(rng, n, lo=100, hi=160, prefix=b"r"):
    return [(prefix + str(i).encode() + b" comment x", _seq(rng, int(
        rng.integers(lo, hi)))) for i in range(n)]


def _write(tmp, name, data: bytes) -> str:
    path = tmp / name
    if name.endswith(".gz"):
        with gzip.open(path, "wb") as fh:
            fh.write(data)
    else:
        path.write_bytes(data)
    return str(path)


def _case(name, tmp, rng):
    """(q1, q2, batch_reads, batch_bases, skip) of case ``name``."""
    if name == "paired_fastq":
        a, b = _reads(rng, 45), _reads(rng, 45, 140, 151)
        return (_write(tmp, "r1.fq", _fastq(a)),
                _write(tmp, "r2.fq", _fastq(b)), 16, 0, 0)
    if name == "single_fastq":
        return _write(tmp, "r.fq", _fastq(_reads(rng, 37))), None, 8, 0, 0
    if name == "multiline_fasta":
        recs = [(b"c%d desc" % i, _seq(rng, int(rng.integers(1, 400))))
                for i in range(23)]
        text = b"".join(b">" + h + b"\n" + b"\n".join(
            s[j:j + 60] for j in range(0, len(s), 60)) + b"\n"
            for h, s in recs)
        return _write(tmp, "c.fna", b"junk before\n" + text), None, 5, 0, 0
    if name == "gzip_paired":
        a, b = _reads(rng, 30), _reads(rng, 30)
        return (_write(tmp, "r1.fq.gz", _fastq(a)),
                _write(tmp, "r2.fq.gz", _fastq(b)), 7, 0, 0)
    if name == "gzip_fasta":
        text = b"".join(b">g%d\n%s\n" % (i, _seq(rng, 300))
                        for i in range(12))
        return _write(tmp, "g.fa.gz", text), None, 4, 0, 0
    if name == "crlf":
        a = _reads(rng, 20)
        fa = b"".join(b">x%d y\r\n%s\r\n%s\r\n" % (i, s[:50], s[50:])
                      for i, (_, s) in enumerate(a))
        return (_write(tmp, "crlf.fq", _fastq(a, b"\r\n")),
                _write(tmp, "crlf_mates.fasta", fa), 6, 0, 0)
    if name == "blank_lines":
        data = b"\n\r\n".join(_fastq([r]) for r in _reads(rng, 15))
        return _write(tmp, "blank.fq", data + b"\n\n"), None, 4, 0, 0
    if name == "blank_lines_fasta":
        fa = b"\n\n>a\nAC\n\nGT\n\n>b\n\n>c\nTT\n>d"
        return _write(tmp, "blank.fa", fa), None, 2, 0, 0
    if name == "odd_headers":
        heads = [b" lead space", b"a\tb c", b"tab\tonly", b"x\x0by z",
                 b"\x1cfs name", b"bad\xffbyte q", b"", b"   ", b"\t\ttab",
                 b"uni\xc3\xa9 code", b"trail  ", b"cr\rin"]
        recs = [(h, _seq(rng, 60)) for h in heads]
        return _write(tmp, "odd.fq", _fastq(recs)), None, 5, 0, 0
    if name == "n_and_lower_case":
        recs = [(b"n%d" % i, _seq(rng, 120, b"ACGTNacgtnRYK.-"))
                for i in range(25)]
        return _write(tmp, "n.fq", _fastq(recs)), None, 9, 0, 0
    if name == "contigs_cut_by_bases":
        lens = [5000, 2000, 7000, 1, 300, 4000, 4000, 1200, 9000, 50]
        text = b"".join(b">ctg%d len=%d\n%s\n" % (i, n, _seq(rng, n))
                        for i, n in enumerate(lens))
        return _write(tmp, "ctg.fasta", text), None, 64, 7000, 0
    if name == "paired_cut_by_bases":
        a, b = _reads(rng, 40, 50, 200), _reads(rng, 40, 50, 200)
        return (_write(tmp, "p1.fq", _fastq(a)),
                _write(tmp, "p2.fq", _fastq(b)), 64, 900, 0)
    if name == "skip":
        a, b = _reads(rng, 33), _reads(rng, 33)
        return (_write(tmp, "s1.fq", _fastq(a)),
                _write(tmp, "s2.fq", _fastq(b)), 10, 0, 12)
    if name == "skip_past_the_end":
        return _write(tmp, "s.fq", _fastq(_reads(rng, 5))), None, 10, 0, 9
    if name == "empty_file":
        return _write(tmp, "empty.fq", b""), None, 8, 0, 0
    if name == "empty_gzip":
        return _write(tmp, "empty.fq.gz", b""), None, 8, 0, 0
    if name == "no_format_byte":
        # the first byte names no format: the file name does
        return (_write(tmp, "nofmt.fq", b"\n" + _fastq(_reads(rng, 6))),
                _write(tmp, "nofmt.fa", b"x\n>a b\nACGT\n" + b"".join(
                    b">m%d\nACGTACGT\n" % i for i in range(5))), 4, 0, 0)
    if name == "one_read_a_batch":
        return _write(tmp, "one.fq", _fastq(_reads(rng, 4))), None, 1, 0, 0
    if name == "empty_sequences":
        recs = [(b"e%d" % i, b"" if i % 2 else b"A") for i in range(6)]
        return _write(tmp, "e.fq", _fastq(recs)), None, 3, 0, 0
    if name == "long_line":
        text = b">big\n" + _seq(rng, 3_000_000) + b"\n>small\nACGT\n"
        return _write(tmp, "big.fa", text), None, 8, 0, 0
    if name == "no_final_newline":
        return (_write(tmp, "nonl.fq", _fastq(_reads(rng, 3))[:-1]),
                None, 8, 0, 0)
    raise KeyError(name)


CASES = ["paired_fastq", "single_fastq", "multiline_fasta", "gzip_paired",
         "gzip_fasta", "crlf", "blank_lines", "blank_lines_fasta",
         "odd_headers", "n_and_lower_case", "contigs_cut_by_bases",
         "paired_cut_by_bases", "skip", "skip_past_the_end", "empty_file",
         "empty_gzip", "no_format_byte", "one_read_a_batch",
         "empty_sequences", "long_line", "no_final_newline"]


@pytest.mark.parametrize("name", CASES)
def test_batches_equal_the_record_path(tmp_path, name):
    q1, q2, batch_reads, batch_bases, skip = _case(
        name, tmp_path, np.random.default_rng(len(name)))
    want = list(oracle(q1, q2, batch_reads, batch_bases, skip))
    with BatchReader(q1, q2, batch_reads, batch_bases, skip) as reader:
        got = list(reader)
    assert_same_batches(got, want)
    assert bool(got) == (name not in ("empty_file", "empty_gzip",
                                      "skip_past_the_end"))
    # every byte of the files, decompressed, was read
    size = sum(len(fasta._open(q).read()) for q in (q1, q2) if q)
    assert reader.bytes == size


def _errors(tmp):
    rng = np.random.default_rng(5)
    good = _fastq(_reads(rng, 9))
    return {
        "header": (_write(tmp, "h.fq", good + b"!not a header\nAC\n+\nII\n"),
                   None, ValueError, "malformed FASTQ header"),
        "plus": (_write(tmp, "p.fq", good + b"@x\nACGT\nno plus\nIIII\n"),
                 None, ValueError, "missing '+' line"),
        "truncated_record": (_write(tmp, "t.fq", good + b"@x\nACGT\n"), None,
                             ValueError, "missing '+' line"),
        "pairs": (_write(tmp, "a.fq", good + _fastq(_reads(rng, 1))),
                  _write(tmp, "b.fq", good), ValueError,
                  "paired-end files have different read counts"),
    }


@pytest.mark.parametrize("kind", ["header", "plus", "truncated_record",
                                  "pairs"])
def test_malformed_input_raises_as_the_record_path_does(tmp_path, kind):
    """The error, with the record path's message, when the batch holding
    the bad record is asked for; the batches before it come out first."""
    q1, q2, exc, msg = _errors(tmp_path)[kind]
    want, got = [], []
    with pytest.raises(exc, match=re.escape(msg)) as want_err:
        for b in oracle(q1, q2, 4):
            want.append(b)
    reader = BatchReader(q1, q2, 4)
    with pytest.raises(exc, match=re.escape(msg)) as got_err:
        for b in reader:
            got.append(b)
    assert str(got_err.value) == str(want_err.value)
    assert_same_batches(got, want)
    assert next(reader, None) is None  # closed by the error


def test_paired_file_2_longer_ends_with_file_1(tmp_path):
    """As the record path: file 2's extra records are not read."""
    rng = np.random.default_rng(1)
    a, b = _reads(rng, 5), _reads(rng, 8)
    q1, q2 = (_write(tmp_path, "a.fq", _fastq(a)),
              _write(tmp_path, "b.fq", _fastq(b)))
    got = list(BatchReader(q1, q2, 3))
    assert_same_batches(got, list(oracle(q1, q2, 3)))
    assert sum(len(g.names) for g in got) == 5


def test_missing_file_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        BatchReader(str(tmp_path / "nope.fq"), None, 4)


def test_take_is_a_batch_of_its_reads(tmp_path):
    """``ReadBatch.take`` gives what the reader gives for those reads
    alone: the distributed path's slice of a global batch."""
    rng = np.random.default_rng(2)
    a, b = _reads(rng, 12, 20, 200), _reads(rng, 12, 20, 200)
    q1, q2 = (_write(tmp_path, "a.fq", _fastq(a)),
              _write(tmp_path, "b.fq", _fastq(b)))
    [whole] = list(BatchReader(q1, q2, 12))
    for lo, hi in ((0, 5), (5, 12), (3, 4), (12, 12)):
        part = whole.take(lo, hi)
        ones = (_write(tmp_path, f"a{lo}.fq", _fastq(a[lo:hi])),
                _write(tmp_path, f"b{lo}.fq", _fastq(b[lo:hi])))
        assert_same_batches([part], list(oracle(*ones, 12)) or [
            ReadBatch([], np.zeros(0, np.int32), np.zeros((0, 0), np.uint8),
                      *(np.zeros(0, np.int32) for _ in range(3)))])
        assert part.codes.flags["C_CONTIGUOUS"]


def test_mask_mode_masks_the_readers_rows(tmp_path):
    """``--mask-mode 1``: the classifier masks each row of the reader's
    matrix as the record path masked each row of ``encode_seqs_padded``'s,
    and leaves the batch's own matrix as it was."""
    from metabuli_tpu_torch.classify.classifier import mask_rows
    from metabuli_tpu_torch.ops.mask import mask_codes

    rng = np.random.default_rng(4)
    unit = _seq(rng, 6)
    recs = [(b"m%d" % i, unit * 20 + _seq(rng, int(rng.integers(0, 80))))
            for i in range(9)]
    q = _write(tmp_path, "m.fq", _fastq(recs))
    [batch] = list(BatchReader(q, None, 16))
    before = batch.codes.copy()
    got = mask_rows(batch, 0.9)
    [want] = list(oracle(q, None, 16))
    codes = want.codes
    for i, (_, s) in enumerate(recs):
        codes[i, :len(s)] = mask_codes(codes[i, :len(s)], 0.9)
    assert np.array_equal(got, codes)
    assert not np.array_equal(codes, before)  # the repeats were masked
    assert np.array_equal(batch.codes, before)


SANITIZED = """
import sys
from metabuli_tpu_torch.io.batch_reader import BatchReader
for arg in sys.argv[1:]:
    files, reads, bases = arg.split(":")
    q1, q2 = (files.split(",") + [None])[:2]
    try:
        with BatchReader(q1, q2, int(reads), int(bases)) as r:
            print("ok", sum(len(b.names) for b in r))
    except (ValueError, EOFError) as e:
        print("raised", type(e).__name__)
print("SANITIZED-OK")
"""


def _outcome(q1, q2, reads, bases):
    try:
        return f"ok {sum(len(b.names) for b in oracle(q1, q2, reads, bases))}"
    except (ValueError, EOFError) as e:
        return f"raised {type(e).__name__}"


def test_reader_under_sanitizers(tmp_path):
    """The reader in the loader's ASan/UBSan library (a process of its
    own, under LD_PRELOAD) on truncated, CRLF and over-long inputs: no
    sanitizer report, and each input read, or raising, as the record path
    does."""
    from metabuli_tpu_torch import native

    rng = np.random.default_rng(9)
    reads = _fastq(_reads(rng, 40))
    gz = gzip.compress(reads * 50)
    files = {
        "cut_qual.fq": reads[:-37],          # cut inside a quality line
        "cut_seq.fq": reads[:-200],          # cut inside a sequence line
        "cut_header.fq": reads + b"@r",      # cut after a header
        "cut.fq.gz": gz[:len(gz) // 2],      # a gzip stream cut short
        "crlf.fq": _fastq(_reads(rng, 30), b"\r\n"),
        "crlf.fa": b">a b\r\nAC\r\nGT\r\n\r\n>c\r\n" + b"G" * 70 + b"\r",
        "long.fa": b">long\n" + _seq(rng, 5_000_000) + b"\n>x\nAC",
        "long_header.fq": _fastq([(b"h" * 3_000_000, b"ACGT")]),
        "mates.fq": reads,
    }
    paths = {k: _write(tmp_path, k, v) for k, v in files.items()}
    runs = [(paths[k], None, 8, 0) for k in files if k != "mates.fq"]
    runs += [(paths["mates.fq"], paths["cut_header.fq"], 8, 0),
             (paths["cut_header.fq"], paths["mates.fq"], 8, 0),
             (paths["long.fa"], None, 4, 1000)]
    args = [f"{q1}{',' + q2 if q2 else ''}:{r}:{b}" for q1, q2, r, b in runs]
    lib = subprocess.run(["g++", "-print-file-name=libasan.so"],
                         capture_output=True, text=True).stdout.strip()
    env = dict(os.environ, PYTHONPATH=str(ROOT), LD_PRELOAD=lib,
               **{native.SANITIZE_ENV: "address,undefined"},
               ASAN_OPTIONS="detect_leaks=0:abort_on_error=1",
               UBSAN_OPTIONS="print_stacktrace=1:halt_on_error=1")
    res = subprocess.run([sys.executable, "-c", SANITIZED, *args], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-4000:]
    assert "AddressSanitizer" not in out and "runtime error" not in out, \
        out[-4000:]
    lines = res.stdout.splitlines()
    assert lines[-1] == "SANITIZED-OK"
    want = [_outcome(*run) for run in runs]
    assert lines[:-1] == want
    assert sum(w.startswith("raised") for w in want) == 4
