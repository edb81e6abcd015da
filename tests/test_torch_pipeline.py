"""The port's depth-2 batch pipeline on the CPU: outputs byte-equal to the
JAX package over many batches and with every flag that shapes the output
files, batches written in order whatever the worker's pace, and a failure
in the worker ends the run."""

import gzip
import os
import pathlib
import subprocess
import sys
import threading
import time

import pytest

from helpers import jax_native
from metabuli_tpu_torch.classify import classifier as port_classifier
from metabuli_tpu_torch.classify.device_taxonomer import DeviceTaxonomer
from metabuli_tpu_torch.cli import main as port_main
from test_torch_classify import _golden_db
from test_torch_slice7 import assert_same, outputs, run_both


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    """The JAX side on its native path, wherever this module runs."""
    jax_native.loaded()


ROOT = pathlib.Path(__file__).resolve().parent.parent
# 21 golden reads, 4 a batch: 6 batches
BATCHED = ["--seq-mode", "1", "--batch-reads", "4"]


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    return _golden_db(tmp_path_factory.mktemp("gold"), 0)


def _truncate(path, rows):
    """Keep the header and the first ``rows`` rows (an interrupted run)."""
    lines = pathlib.Path(path).read_text().splitlines(keepends=True)
    pathlib.Path(path).write_text("".join(lines[:1 + rows]))


def test_pipeline_em_and_resume_equal_jax(tmp_path, golden):
    """Six batches with --em 1 (the EM files too), then --resume on
    classifications cut after 9 rows: every file equal to JAX's. (The
    two flags together raise in both packages' EM step, ROADMAP R6.)"""
    _, q, db = golden
    jax_out, port_out = run_both(str(tmp_path), [q, db, None], "pe",
                                 [*BATCHED, "--em", "1"])
    assert_same(jax_out, port_out)
    assert len(port_out) == 7  # classifications, report, krona, 4 EM files
    for side in ("jax", "port"):
        _truncate(tmp_path / f"{side}_pe" / "pe_classifications.tsv", 9)
    jax_res, port_res = run_both(str(tmp_path), [q, db, None], "pe",
                                 [*BATCHED, "--resume"])
    assert_same(jax_res, port_res)
    assert port_res["pe_classifications.tsv"] == \
        port_out["pe_classifications.tsv"]


@pytest.mark.parametrize("flags", [
    ["--em", "1"], ["--mask-mode", "1"], ["--lineage", "1"],
    ["--min-score", "0.3"], ["--accession-level", "1"],
    ["--tie-ratio", "0.8"], ["--resume"],
], ids=lambda f: f[0].lstrip("-"))
def test_flag_outputs_equal_jax(tmp_path, golden, flags):
    """Each flag through both CLIs on the golden world (syncmer 0), every
    output file byte-equal; --resume on a classifications file cut after
    5 rows."""
    root, q, db = golden
    if flags == ["--resume"]:
        full = os.path.join(root, "port_full")
        assert port_main(["classify", q, db, full, "fl", *BATCHED,
                          "--device", "cpu"]) == 0
        for side in ("jax", "port"):
            d = tmp_path / f"{side}_fl"
            d.mkdir()
            (d / "fl_classifications.tsv").write_bytes(
                pathlib.Path(full, "fl_classifications.tsv").read_bytes())
            _truncate(d / "fl_classifications.tsv", 5)
    jax_out, port_out = run_both(str(tmp_path), [q, db, None], "fl",
                                 [*BATCHED, *flags])
    assert_same(jax_out, port_out)
    assert port_out["fl_classifications.tsv"].count(b"\n") == 22


def _gzip_pairs(root, q) -> list:
    """The golden reads as gzip FASTQ pairs: mate 1 the read's first 90
    bases, mate 2 the reverse complement of its last 90."""
    recs = pathlib.Path(q).read_text().split(">")[1:]
    mates = ([], [])
    for rec in recs:
        name, seq = rec.split("\n")[:2]
        rc = seq.translate(str.maketrans("ACGTN", "TGCAN"))[::-1]
        for m, s in zip(mates, (seq[:90], rc[:90])):
            m.append(f"@{name} x\n{s}\n+\n{'I' * len(s)}\n")
    paths = [os.path.join(root, f"m{i}.fq.gz") for i in (1, 2)]
    for path, m in zip(paths, mates):
        with gzip.open(path, "wt") as fh:
            fh.write("".join(m))
    return paths


def _contigs(root, world) -> list:
    """Contigs of 600-2,500 bases cut from the golden genomes (in
    ``world``), in 60-column FASTA lines with CRLF ends."""
    out = []
    for i, fa in enumerate(sorted(pathlib.Path(world, "fasta").iterdir())):
        g = "".join(fa.read_text().split("\n")[1:])
        for j, (a, n) in enumerate(((100, 2500), (3000, 600), (4000, 1500))):
            s = g[a + 7 * i:a + 7 * i + n]
            out.append(f">ctg{i}_{j} {fa.name}\r\n" + "".join(
                s[k:k + 60] + "\r\n" for k in range(0, len(s), 60)))
    path = os.path.join(root, "contigs.fasta")
    pathlib.Path(path).write_text("".join(out), newline="")
    return [path]


@pytest.mark.parametrize("sample", ["gzip_pairs", "fasta_contigs"])
def test_reader_inputs_equal_jax(tmp_path, golden, sample):
    """The port's CLI, reading through its native batch reader, on a gzip
    paired FASTQ sample and on a multi-line FASTA contig sample: the
    classifications and the report equal the JAX package's."""
    root, q, db = golden
    if sample == "gzip_pairs":
        files, flags = _gzip_pairs(tmp_path, q), ["--seq-mode", "2"]
    else:
        files, flags = _contigs(tmp_path, root), ["--seq-mode", "3"]
    jax_out, port_out = run_both(str(tmp_path), [*files, db, None], "rd",
                                 [*flags, "--batch-reads", "4"])
    assert_same(jax_out, port_out)
    lines = port_out["rd_classifications.tsv"].decode().splitlines()
    assert len(lines) == 1 + (21 if sample == "gzip_pairs" else 9)
    assert sum(ln.startswith("1\t") for ln in lines) >= len(lines) // 2


def test_pipeline_keeps_batch_order_when_a_drain_is_slow(tmp_path, golden,
                                                          monkeypatch):
    """Batch 0's finish sleeps: the main thread dispatches batch 1 while
    it runs, and the batches are still written in order."""
    _, q, db = golden
    ref = tmp_path / "ref"
    assert port_main(["classify", q, db, str(ref), "or", *BATCHED,
                      "--device", "cpu"]) == 0
    events, lock = [], threading.Lock()
    drain, dispatch = DeviceTaxonomer.drain, port_classifier.Classifier._dispatch

    def slow_drain(self, host, read_lens, n_reads):
        with lock:
            k = sum(e[0] == "drain" for e in events)
            events.append(("drain", k))
        if k == 0:
            time.sleep(0.5)
        out = drain(self, host, read_lens, n_reads)
        with lock:
            events.append(("drained", k))
        return out

    def counted_dispatch(self, reads, **kw):
        with lock:
            events.append(("dispatch", sum(e[0] == "dispatch"
                                           for e in events)))
        return dispatch(self, reads, **kw)

    monkeypatch.setattr(DeviceTaxonomer, "drain", slow_drain)
    monkeypatch.setattr(port_classifier.Classifier, "_dispatch",
                        counted_dispatch)
    got = tmp_path / "got"
    assert port_main(["classify", q, db, str(got), "or", *BATCHED,
                      "--device", "cpu"]) == 0
    assert outputs(got) == outputs(ref)
    assert events.index(("dispatch", 1)) < events.index(("drained", 0))
    assert [e for e in events if e[0] == "drained"] == [
        ("drained", k) for k in range(6)]


def test_pipeline_worker_failure_ends_the_run(tmp_path, golden, monkeypatch):
    """A drain that raises on batch 1: ``classify_file`` raises it and the
    CLI exits non-zero; nothing carries on."""
    _, q, db = golden
    calls = []

    def failing_drain(self, host, read_lens, n_reads):
        calls.append(n_reads)
        if len(calls) == 2:
            raise RuntimeError("finish failed")
        return drain(self, host, read_lens, n_reads)

    drain = DeviceTaxonomer.drain
    monkeypatch.setattr(DeviceTaxonomer, "drain", failing_drain)
    par = port_classifier.ClassifyParams(seq_mode=1, batch_reads=4)
    clf = port_classifier.Classifier(db, par, device="cpu")
    with pytest.raises(RuntimeError, match="finish failed"):
        clf.classify_file(q, None, str(tmp_path / "out"), "er")
    assert len(calls) <= 3  # batch 2 at most was in flight
    lines = (tmp_path / "out" / "er_classifications.tsv").read_text()
    assert lines.count("\n") == 1 + 4  # the header and batch 0 alone
    code = (
        "import sys\n"
        "from metabuli_tpu_torch.classify.device_taxonomer import "
        "DeviceTaxonomer\n"
        "from metabuli_tpu_torch.cli import main\n"
        "def drain(*a):\n"
        "    raise RuntimeError('finish failed')\n"
        "DeviceTaxonomer.drain = drain\n"
        "sys.exit(main(sys.argv[1:]))\n")
    p = subprocess.run(
        [sys.executable, "-c", code, "classify", q, db,
         str(tmp_path / "cli"), "er", *BATCHED, "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert p.returncode != 0
    assert "finish failed" in p.stderr


def test_overlap_s_sums_the_intersections_of_two_span_lists():
    spans = [(0.0, 2.0), (3.0, 5.0), (6.0, 7.0)]
    assert port_classifier.overlap_s(spans, [(1.0, 4.0), (4.5, 6.5)]) == 3.0
    assert port_classifier.overlap_s(spans, []) == 0.0
    assert port_classifier.overlap_s(spans, spans) == 5.0


def test_overlap_counts_finish_time_beside_a_dispatch_not_a_wait(
        tmp_path, golden, monkeypatch):
    """Batch 0's finish and batch 1's dispatch each sleep 0.5 s, side by
    side: the summary's overlap holds that finish time, and the worker's
    CPU seconds do not hold its sleep."""
    _, q, db = golden
    drain, dispatch = DeviceTaxonomer.drain, port_classifier.Classifier._dispatch
    n = {"drain": 0, "dispatch": 0}

    def sleepy(fn, key):
        def run(*a, **k):
            n[key] += 1
            if n[key] == 1 + (key == "dispatch"):
                time.sleep(0.5)
            return fn(*a, **k)
        return run

    monkeypatch.setattr(DeviceTaxonomer, "drain", sleepy(drain, "drain"))
    monkeypatch.setattr(port_classifier.Classifier, "_dispatch",
                        sleepy(dispatch, "dispatch"))
    par = port_classifier.ClassifyParams(seq_mode=1, batch_reads=4)
    clf = port_classifier.Classifier(db, par, device="cpu")
    s = clf.classify_file(q, None, str(tmp_path / "out"), "ov")
    assert s["finish_s"] >= 0.5
    assert 0.2 <= s["finish_overlap_s"] <= s["finish_s"]
    assert 0 <= s["finish_cpu_s"] <= s["finish_s"] - 0.2
    assert 0 < s["main_cpu_s"] <= s["classify_s"]
    assert s["parse_bytes"] == os.path.getsize(q)  # the reader read it all
