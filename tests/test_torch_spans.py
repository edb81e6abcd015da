"""The port's host spans on the CPU: the main thread's loop split into
disjoint phases carrying their batch's id, on the profiler's timeline and
in the summary's ``stage_ms``; the worker's finish range; the DB load in
two parts."""

import itertools
import json
import time

import pytest
import torch

from helpers import jax_native
from metabuli_tpu_torch.classify import classifier as port_classifier
from metabuli_tpu_torch.cli import _profiler
from metabuli_tpu_torch.cli import main as port_main
from test_torch_classify import _golden_db

MAIN = ("parse", "encode", "launch", "wait", "emit", "reports")
STALLED = ("parse", "encode", "launch", "emit")
# 21 golden reads, 4 a batch: batches 0-5
BATCHES = set(range(6))


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    """The golden DB is built by the JAX package on its native path."""
    jax_native.loaded()


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    return _golden_db(tmp_path_factory.mktemp("gold"), 0)


def _classifier(db):
    par = port_classifier.ClassifyParams(seq_mode=1, batch_reads=4)
    return port_classifier.Classifier(db, par, device="cpu")


def _all_threads() -> bool:
    """Whether this torch's profiler takes ``profile_all_threads``, and so
    records the finish worker's ranges."""
    try:
        torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return False
    return True


def _spans(events):
    """{phase: [(batch id or None, thread, start, end)]} of the trace's
    ``metabuli.*`` ranges."""
    out = {}
    for e in events:
        if e.name.startswith("metabuli."):
            ids = [v for v in e.concrete_inputs if v is not None]
            out.setdefault(e.name[len("metabuli."):], []).append(
                (ids[0] if ids else None, e.thread, e.time_range.start,
                 e.time_range.end))
    return out


def test_trace_holds_each_phase_of_each_batch_without_overlap(tmp_path,
                                                              golden):
    """The DB load and one six-batch run under the profiler: every main
    thread phase of every batch with its id, on one thread, no two
    overlapping; the worker's finish of each batch on another thread."""
    _, q, db = golden
    with _profiler("cpu") as prof:
        clf = _classifier(db)
        clf.classify_file(q, None, str(tmp_path / "out"), "sp")
    spans = _spans(prof.events())
    assert [s[0] for s in spans["load.decode"]] == [None]
    assert [s[0] for s in spans["load.index"]] == [None]
    for phase in ("encode", "launch", "wait", "emit"):
        assert sorted(s[0] for s in spans[phase]) == sorted(BATCHES), phase
    # the last parse finds the end of the file
    assert sorted(s[0] for s in spans["parse"]) == [0, 1, 2, 3, 4, 5, 6]
    assert [s[0] for s in spans["reports"]] == [5]
    main = sorted((s for p in MAIN for s in spans[p]), key=lambda s: s[2])
    assert len({s[1] for s in main}) == 1
    for a, b in zip(main, main[1:]):
        assert a[3] <= b[2]
    if _all_threads():
        assert sorted(s[0] for s in spans["finish"]) == sorted(BATCHES)
        assert {s[1] for s in spans["finish"]} != {main[0][1]}


def test_spans_fall_back_to_record_function(tmp_path, golden, monkeypatch):
    """On a torch without the private range entry points the spans open
    ``torch.profiler.record_function``'s range: every phase still in the
    trace (without its batch's id) and in ``stage_ms``."""
    monkeypatch.setattr(port_classifier, "_open_range",
                        port_classifier._rf_open)
    monkeypatch.setattr(port_classifier, "_close_range",
                        port_classifier._rf_close)
    _, q, db = golden
    with _profiler("cpu") as prof:
        clf = _classifier(db)
        s = clf.classify_file(q, None, str(tmp_path / "out"), "fb")
    spans = _spans(prof.events())
    for phase in (*MAIN, "load.decode", "load.index"):
        assert phase in spans, phase
    assert len(spans["encode"]) == len(BATCHES)
    assert all(k in s["stage_ms"] for k in (*MAIN, "main_stall"))


def test_stage_ms_holds_every_phase_within_the_run(tmp_path, golden):
    _, q, db = golden
    s = _classifier(db).classify_file(q, None, str(tmp_path / "out"), "sm")
    ms = s["stage_ms"]
    assert all(ms[k] >= 0 for k in (*MAIN, "main_stall"))
    assert sum(ms[k] for k in MAIN) <= s["classify_s"] * 1e3
    assert ms["main_stall"] <= sum(ms[k] for k in STALLED)
    assert "device_s" not in s and "tax_s" not in s


def test_a_slow_launch_shows_in_launch_and_main_stall(tmp_path, golden,
                                                      monkeypatch):
    """The third batch's device stages sleep 0.6 s: against a warm run
    without
    the sleep, ``launch`` rises by at least 0.3 s and ``main_stall``
    (wall less CPU time) by at least 0.25 s. (The sleep is longer than
    the rises asked for: the plain kernels' time swings by tens of ms
    between runs on the CPU.)"""
    _, q, db = golden
    clf = _classifier(db)

    def run(name):
        before = dict(clf.timer.ms)
        clf.classify_file(q, None, str(tmp_path / name), name)
        return {k: v - before.get(k, 0.0) for k, v in clf.timer.ms.items()}

    run("warm")  # the plain kernels' first calls
    base = run("base")
    stages = port_classifier.Classifier._device_stages
    calls = itertools.count()

    def slow(self, *a, **k):
        if next(calls) == 2:
            time.sleep(0.6)
        return stages(self, *a, **k)

    monkeypatch.setattr(port_classifier.Classifier, "_device_stages", slow)
    got = run("slow")
    assert got["launch"] - base["launch"] >= 300
    assert got["main_stall"] - base["main_stall"] >= 250


def test_load_stages_sum_to_load_s(golden):
    _, _, db = golden
    clf = _classifier(db)
    st = clf.load_stages
    assert set(st) == {"decode_s", "index_s"}
    assert min(st.values()) >= 0
    assert sum(st.values()) == pytest.approx(clf.load_s, rel=0.01)
    # the load's ranges time themselves, outside the batches' stage_ms
    assert not any(k.startswith("load.") for k in clf.timer.ms)


def test_summary_counts_the_batches(tmp_path, golden):
    """The summary's ``batches`` is the run's, and the ``reports`` span
    carries the last one's id."""
    _, q, db = golden
    s = _classifier(db).classify_file(q, None, str(tmp_path / "out"), "nb")
    assert s["batches"] == len(BATCHES)
    assert s["stage_ms"]["reports"] >= 0


def test_cli_trace_holds_the_load_and_every_batch(tmp_path, golden):
    """``classify --trace-dir``: the profile opens before the DB load, and
    its trace.json holds the load's two ranges, each main-thread phase
    with its batch's id and (this torch profiles every thread) the
    worker's finish ranges."""
    _, q, db = golden
    tdir = tmp_path / "trace"
    assert port_main(["classify", q, db, str(tmp_path / "out"), "tr",
                      "--seq-mode", "1", "--batch-reads", "4", "--device",
                      "cpu", "--trace-dir", str(tdir)]) == 0
    with open(tdir / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    ids = {}
    for e in events:
        if e.get("name", "").startswith("metabuli."):
            got = e.get("args", {}).get("Concrete Inputs", [])
            ids.setdefault(e["name"], []).append(
                int(got[0]) if got else None)
    assert ids["metabuli.load.decode"] == [None]
    assert ids["metabuli.load.index"] == [None]
    for phase in ("encode", "launch", "wait", "emit"):
        assert sorted(ids[f"metabuli.{phase}"]) == sorted(BATCHES), phase
    assert sorted(ids["metabuli.parse"]) == [0, 1, 2, 3, 4, 5, 6]
    assert ids["metabuli.reports"] == [5]
    if _all_threads():
        assert sorted(ids["metabuli.finish"]) == sorted(BATCHES)
