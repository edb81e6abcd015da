"""The native line writer (``io/line_writer.py`` over
``native/line_writer.cpp``) and the batch result columns it takes
(``classify/batch_result.py``): the writer's bytes equal the copied
``Reporter.write_classifications``'s for the same reads, the sharded
classifier's leading-index lines equal its former per-read lines, and
``drain_columns(...).objects()`` equals the list the former ``drain`` made
with its loops (kept here as the oracle) on a real device-stage batch."""

from __future__ import annotations

import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from metabuli_tpu_torch.classify.batch_result import BatchReads, BatchResult
from metabuli_tpu_torch.classify.taxonomer import ReadClassification
from metabuli_tpu_torch.db.taxonomy import Taxonomy
from metabuli_tpu_torch.io.line_writer import LineWriter
from metabuli_tpu_torch.io.report import Reporter

ROOT = pathlib.Path(__file__).resolve().parent.parent
F32_MAX = float(np.finfo(np.float32).max)
SCORES = [0.0, 1e-5, 0.9999995, 123456.7, 1e7, F32_MAX]
# original taxid, parent, rank, name: sparse original ids, a name beyond
# ASCII, ranks with and without a lineage prefix
NODES = [(1, 1, "no rank", "root"), (131567, 1, "no rank", "cellular"),
         (2, 131567, "superkingdom", "Bacteria"),
         (1224, 2, "phylum", "Proteobacteria"),
         (543, 1224, "family", "Enterobacteriaceae"),
         (561, 543, "genus", "Escherichia"),
         (620, 543, "genus", "Shigélla"),
         (562, 561, "species", "Escherichia coli"),
         (564, 561, "species", "Escherichia fergusonii"),
         (622, 620, "species", "Shigella dysenteriae"),
         (83333, 562, "strain", "E. coli K-12"),
         (2000000001, 620, "species", "Shigella sp. X")]


def taxonomy(root: pathlib.Path) -> Taxonomy:
    root.mkdir(parents=True, exist_ok=True)
    (root / "nodes.dmp").write_text("".join(
        f"{t}\t|\t{p}\t|\t{r}\t|\n" for t, p, r, _ in NODES))
    (root / "names.dmp").write_text("".join(
        f"{t}\t|\t{n}\t|\t\t|\tscientific name\t|\n"
        for t, _, _, n in NODES), encoding="utf-8")
    (root / "merged.dmp").write_text("")
    return Taxonomy.from_dmp(*(str(root / f) for f in (
        "names.dmp", "nodes.dmp", "merged.dmp")))


@pytest.fixture(scope="module")
def tax(tmp_path_factory):
    return taxonomy(tmp_path_factory.mktemp("tax"))


def random_objects(rng, tax, n):
    """Reads of every kind: classified or not, with 0-6 tax counts, a
    score from SCORES, a float32 widened, or a double."""
    nodes = tax.n_nodes()
    out = []
    for _ in range(n):
        kind = rng.integers(3)
        scale = 10.0 ** rng.integers(-6, 9)
        score = (SCORES[rng.integers(len(SCORES))] if kind == 0 else
                 float(np.float32(rng.random() * scale)) if kind == 1 else
                 float(rng.random()))
        rc = ReadClassification(score=score)
        if rng.random() < 0.7:
            rc.is_classified = True
            rc.taxid = int(rng.integers(1, nodes + 1))
            for t in rng.choice(np.arange(1, nodes + 1),
                                rng.integers(0, 7), replace=False):
                rc.tax_counts[int(t)] = int(rng.integers(1, 3000))
        out.append(rc)
    return out


def random_names(rng, n):
    names = [f"read_{i}/{rng.integers(1 << 30)}" for i in range(n)]
    if n > 3:
        names[1] = "x" * 20_000          # a long name
        names[2] = "lecture_été_é"         # beyond ASCII
        names[3] = ""
    return names


def reporter_bytes(rep, names, objects, read_lens, first=True) -> bytes:
    fh = io.StringIO()
    rep.write_classifications(fh, zip(names, objects, read_lens.tolist()),
                              first=first)
    return fh.getvalue().encode()


def writer_bytes(writer, res, names, read_lens, first=True) -> bytes:
    fh = io.BytesIO()
    writer.write(fh, res, names, read_lens, first=first)
    return fh.getvalue()


@pytest.mark.parametrize("lineage", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lines_equal_the_reporter(tax, seed, lineage):
    """Random reads, some of length 0, over two batches of one writer (the
    second reuses the first's lineages): the header and every line equal
    ``Reporter``'s."""
    rng = np.random.default_rng(seed)
    rep = Reporter(tax, lineage)
    writer = LineWriter(rep)
    for first, n in ((True, 300), (False, 257)):
        objects = random_objects(rng, tax, n)
        names = random_names(rng, n)
        read_lens = rng.integers(0, 40_000, n).astype(np.int32)
        read_lens[::17] = 0
        res = BatchResult.from_objects(objects)
        assert writer_bytes(writer, res, names, read_lens, first) == \
            reporter_bytes(rep, names, objects, read_lens, first)


@pytest.mark.parametrize("score", SCORES + [-0.0, float("inf"),
                                            float("nan"), 5e-324])
@pytest.mark.parametrize("lineage", [False, True])
def test_scores_print_as_the_reporter(tax, score, lineage):
    """Each score as a float32 widened and as it is, on a classified and
    an unclassified read."""
    rep = Reporter(tax, lineage)
    objects = []
    for s in (float(np.float32(score)), score):
        objects.append(ReadClassification(True, 5, s, tax_counts={5: 3}))
        objects.append(ReadClassification(False, 0, s))
    names = [f"r{i}" for i in range(len(objects))]
    read_lens = np.full(len(objects), 147, np.int32)
    assert writer_bytes(LineWriter(rep), BatchResult.from_objects(objects),
                        names, read_lens) == \
        reporter_bytes(rep, names, objects, read_lens)


def rows_result(tax, rng, n_reads=40, n_rows=400):
    """Columns with tax-count rows in shuffled read order, many of them
    repeating a (read, taxid) of an earlier row, and EM rows."""
    nodes = tax.n_nodes()
    cls = (rng.random(n_reads) < 0.8).astype(np.uint8)
    taxid = np.where(cls != 0, rng.integers(1, nodes + 1, n_reads), 0)
    read = rng.integers(0, n_reads, n_rows)
    return BatchResult(
        cls, taxid.astype(np.int32),
        rng.random(n_reads).astype(np.float32), read.astype(np.int64),
        rng.integers(1, 4, n_rows).astype(np.int32),
        rng.integers(1, 1000, n_rows).astype(np.int32),
        rng.integers(0, n_reads, 60).astype(np.int64),
        rng.integers(1, nodes + 1, 60).astype(np.int32),
        rng.random(60).astype(np.float32))


@pytest.mark.parametrize("lineage", [False, True])
def test_duplicate_rows_last_wins(tax, lineage):
    """A later row of one (read, taxid) replaces an earlier one, as the
    finish's dict update does; the pairs print in ascending taxid."""
    rng = np.random.default_rng(7)
    res = rows_result(tax, rng)
    want = [dict() for _ in res.cls]
    for r, t, c in zip(res.tc_read.tolist(), res.tc_taxid.tolist(),
                       res.tc_count.tolist()):
        want[r][t] = c
    objects = res.objects()
    assert [rc.tax_counts for rc in objects] == want
    assert sum(len(d) for d in want) < len(res.tc_read)  # there were repeats
    rep = Reporter(tax, lineage)
    names = [f"q{i}" for i in range(len(res.cls))]
    read_lens = np.full(len(res.cls), 300, np.int32)
    assert writer_bytes(LineWriter(rep), res, names, read_lens) == \
        reporter_bytes(rep, names, objects, read_lens)


@pytest.mark.parametrize("lineage", [False, True])
def test_empty_batch_and_empty_tax_counts(tax, lineage):
    rep = Reporter(tax, lineage)
    writer = LineWriter(rep)
    empty = BatchResult.empty(0)
    none = np.zeros(0, np.int32)
    assert writer_bytes(writer, empty, [], none) == \
        rep.classification_header().encode()
    assert writer_bytes(writer, empty, [], none, first=False) == b""
    objects = [ReadClassification(True, 3, 0.5), ReadClassification()]
    read_lens = np.array([0, 150], np.int32)
    got = writer_bytes(writer, BatchResult.from_objects(objects),
                       ["a", "b"], read_lens, first=False)
    assert got == reporter_bytes(rep, ["a", "b"], objects, read_lens, False)
    assert got.split(b"\n")[0].endswith(b"\t")  # no pairs, the tab stays


def test_from_objects_round_trips(tax):
    rng = np.random.default_rng(3)
    objects = random_objects(rng, tax, 200)
    for i, rc in enumerate(objects[::5]):
        rc.species_scores = [(5, 0.25), (7, float(np.float32(0.1 * i)))]
        rc.top_species = 5
    assert BatchResult.from_objects(objects).objects() == objects
    assert BatchResult.empty(3).objects() == [ReadClassification()] * 3


def test_batch_reads_make_objects_once_and_write_them(tax):
    """``BatchReads`` hands the writer the finish's columns until an
    object is asked for; from then on the objects, changed or replaced,
    are what is written, in the batch and in a slice of it."""
    rng = np.random.default_rng(5)
    res = rows_result(tax, rng)
    reads = BatchReads(res)
    assert not reads.made and reads.columns() is res
    assert len(reads) == len(res.cls)
    assert reads.take(3, 9).columns().cls.tolist() == res.cls[3:9].tolist()
    objects = res.objects()
    assert list(reads) == objects and reads.made
    first = next(i for i, rc in enumerate(objects) if rc.is_classified)
    reads[first].taxid = 2
    objects[first].taxid = 2
    h = len(reads) // 2
    reads[h:] = [ReadClassification() for _ in reads[h:]]
    objects[h:] = [ReadClassification() for _ in objects[h:]]
    rep = Reporter(tax)
    names = [f"r{i}" for i in range(len(objects))]
    rl = np.full(len(objects), 150, np.int32)
    assert writer_bytes(LineWriter(rep), reads.columns(), names, rl) == \
        reporter_bytes(rep, names, objects, rl)
    part = reads.take(h - 2, h + 2)
    assert part.made and list(part) == objects[h - 2:h + 2]
    assert BatchReads(objects=objects).columns().objects() == objects


def test_clade_counts_and_mappings_as_the_read_loop(tax):
    """The clade counts equal the per-read loop's, keys in its order (the
    report's ties keep it); the mappings are query-sorted, each read's in
    its rows' order."""
    rng = np.random.default_rng(11)
    res = rows_result(tax, rng)
    counts = {0: 2, 9: 1}
    want = dict(counts)
    for rc in res.objects():
        t = rc.taxid if rc.is_classified else 0
        want[t] = want.get(t, 0) + 1
    res.clade_counts(counts)
    assert list(counts.items()) == list(want.items())
    want_map = [(100 + i, sp, sc) for i, rc in enumerate(res.objects())
                for sp, sc in rc.species_scores]
    assert res.mappings(100) == want_map


def test_faults_raise(tax):
    writer = LineWriter(Reporter(tax))
    res = BatchResult.from_objects([ReadClassification(True, 2, 1.0)])
    names, rl = ["a"], np.array([3], np.int32)
    with pytest.raises(RuntimeError, match="returned -3"):
        writer.lines(res._replace(tc_read=np.array([1], np.int64),
                                  tc_taxid=np.array([2], np.int32),
                                  tc_count=np.array([1], np.int32)),
                     names, rl)
    with pytest.raises(RuntimeError, match="returned -2"):
        writer.lines(res._replace(taxid=np.array([tax.n_nodes() + 1],
                                                 np.int32)), names, rl)
    with pytest.raises(ValueError):
        writer.lines(res, ["a", "b"], rl)


def test_sharded_index_lines_equal_the_former_rows(tax):
    """``ShardedClassifier``'s part-file lines of a batch's own reads: the
    read's global index and a tab, then ``Reporter``'s row."""
    rng = np.random.default_rng(5)
    rep = Reporter(tax, True)
    objects = random_objects(rng, tax, 90)
    names = random_names(rng, 90)
    read_lens = rng.integers(1, 500, 90).astype(np.int32)
    res = BatchResult.from_objects(objects)
    first = 123_456
    for lo, hi in ((0, 90), (30, 60), (45, 45), (89, 90)):
        want = "".join(f"{first + i}\t" + rep.classification_row(
            names[i], objects[i], int(read_lens[i])) for i in range(lo, hi))
        got = LineWriter(rep).lines(res.take(lo, hi), names[lo:hi],
                                    read_lens[lo:hi], index_base=first + lo)
        assert bytes(got) == want.encode()


def drain_loop(res: BatchResult) -> list:
    """The former ``DeviceTaxonomer._finish``'s loops over the native
    finish's buffers, the oracle of ``objects``."""
    n_reads = len(res.cls)
    results = [ReadClassification() for _ in range(n_reads)]
    for i in range(n_reads):
        r = results[i]
        r.is_classified = bool(res.cls[i])
        r.taxid = int(res.taxid[i])
        r.score = float(res.score[i])
    for k in range(len(res.tc_read)):
        results[int(res.tc_read[k])].tax_counts[int(res.tc_taxid[k])] = int(
            res.tc_count[k])
    for k in range(len(res.em_read)):
        r = results[int(res.em_read[k])]
        r.species_scores.append((int(res.em_species[k]),
                                 float(res.em_score[k])))
        if not r.top_species:
            r.top_species = int(res.em_species[k])
    return results


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    from test_torch_classify import _golden_db

    return _golden_db(tmp_path_factory.mktemp("gold"), 0)


@pytest.mark.parametrize("em", [0, 1])
def test_drain_columns_objects_equal_the_drain_loop(golden, em):
    """A device-stage batch of the golden world on the CPU: the columns'
    objects equal the former loops' over the same buffers and ``drain``'s
    of the same batch run again; the lines equal ``Reporter``'s."""
    from metabuli_tpu_torch.classify.classifier import Classifier
    from metabuli_tpu_torch.params import ClassifyParams

    _, q, db = golden
    clf = Classifier(db, ClassifyParams(seq_mode=1, batch_reads=32, em=em),
                     device="cpu")
    with clf._iter_batches(q, None) as reader:
        batch = next(reader)
    n = len(batch.names)
    dtx = clf.device_taxonomer
    job = clf._dispatch(batch)
    res = dtx.drain_columns(job.host, job.read_lens, n)
    assert isinstance(res.cls, np.ndarray) and len(res.cls) == n
    want = drain_loop(res)
    assert res.objects() == want
    job = clf._dispatch(batch)
    assert list(dtx.drain(job.host, job.read_lens, n)) == want
    assert clf.classify_batch(batch) == want
    assert sum(rc.is_classified for rc in want) > n // 2
    assert (len(res.em_read) > 0) == bool(em)
    assert writer_bytes(clf.writer, res, batch.names, batch.read_lens) == \
        reporter_bytes(clf.reporter, batch.names, want, batch.read_lens)


@pytest.mark.parametrize("flags", [[], ["--device-tax", "0"],
                                   ["--em", "1"]],
                         ids=["device", "host", "em"])
def test_line_counters(golden, tmp_path, flags, monkeypatch):
    """``write_lines.lines`` counts every line; ``.object_lines`` those
    whose read had a ``ReadClassification`` made: none on the device path
    without --em, where ``objects`` is never called."""
    from metabuli_tpu_torch.cli import main
    from metabuli_tpu_torch.csrc import build

    _, q, db = golden
    if not flags:
        def refuse(self):
            raise AssertionError("objects made on the device path")
        monkeypatch.setattr(BatchResult, "objects", refuse)
    before = dict(build.launches)
    assert main(["classify", q, db, str(tmp_path), "c", "--seq-mode", "1",
                 "--batch-reads", "8", "--device", "cpu", *flags]) == 0
    lines = build.launches["write_lines.lines"] - before["write_lines.lines"]
    objects = (build.launches["write_lines.object_lines"]
               - before["write_lines.object_lines"])
    rows = (tmp_path / "c_classifications.tsv").read_text().count("\n") - 1
    assert lines == rows == 21
    assert objects == (0 if not flags else rows)


SANITIZED = """
import pathlib, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import test_torch_line_writer as t
from metabuli_tpu_torch.classify.batch_result import BatchResult
from metabuli_tpu_torch.io.line_writer import LineWriter
from metabuli_tpu_torch.io.report import Reporter
tax = t.taxonomy(pathlib.Path(sys.argv[2]))
rng = np.random.default_rng(21)
for lineage in (False, True):
    rep = Reporter(tax, lineage)
    w = LineWriter(rep)
    for n in (0, 1, 97, 400):
        objects = t.random_objects(rng, tax, n)
        names = t.random_names(rng, n)
        rl = rng.integers(0, 9000, n).astype(np.int32)
        res = BatchResult.from_objects(objects)
        assert t.writer_bytes(w, res, names, rl) == t.reporter_bytes(
            rep, names, objects, rl)
        got = bytes(w.lines(res, names, rl, index_base=7))
        assert got.count(b"\\n") == n
    res = t.rows_result(tax, rng)
    names = [f"q{i}" for i in range(len(res.cls))]
    rl = np.full(len(res.cls), 300, np.int32)
    assert t.writer_bytes(w, res, names, rl) == t.reporter_bytes(
        rep, names, res.objects(), rl)
for bad in (dict(tc_read=np.array([5], np.int64)),
            dict(taxid=np.array([-1], np.int32))):
    res = BatchResult.from_objects(
        [t.ReadClassification(True, 2, 1.0, tax_counts={2: 1})])
    try:
        LineWriter(Reporter(tax)).lines(res._replace(**bad), ["a"],
                                        np.array([1], np.int32))
    except RuntimeError:
        pass
    else:
        raise AssertionError(bad)
print("SANITIZED-OK")
"""


def test_writer_under_sanitizers(tmp_path):
    """The writer's cases in the loader's ASan/UBSan library (a process of
    its own, under LD_PRELOAD): equal bytes and no sanitizer report."""
    from metabuli_tpu_torch import native

    lib = subprocess.run(["g++", "-print-file-name=libasan.so"],
                         capture_output=True, text=True).stdout.strip()
    env = dict(os.environ, PYTHONPATH=str(ROOT), LD_PRELOAD=lib,
               **{native.SANITIZE_ENV: "address,undefined"},
               ASAN_OPTIONS="detect_leaks=0:abort_on_error=1",
               UBSAN_OPTIONS="print_stacktrace=1:halt_on_error=1")
    res = subprocess.run(
        [sys.executable, "-c", SANITIZED, str(ROOT / "tests"),
         str(tmp_path / "tax")], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=900)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-4000:]
    assert "AddressSanitizer" not in out and "runtime error" not in out, \
        out[-4000:]
    assert res.stdout.splitlines()[-1] == "SANITIZED-OK"
