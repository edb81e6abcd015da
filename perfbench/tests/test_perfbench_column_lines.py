"""The reader of ``column_lines_pct``: nothing without the line writer's
counters (a program that lacks them), and the share of lines written from
columns where they are."""

import importlib.util
import json
import os
from types import SimpleNamespace

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
NAME = "column_lines_pct"


def read(launches):
    spec = importlib.util.spec_from_file_location(
        "m", os.path.join(BENCH, "metrics", NAME + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(SimpleNamespace(launches=launches))


def test_nothing_without_the_counters():
    assert read({}) is None
    assert read({"extract_metamers": 4, "search_scan": 4}) is None
    assert read({"write_lines.lines": 0, "write_lines.object_lines": 0}) \
        is None


def test_share_of_column_lines():
    assert read({"write_lines.lines": 65536,
                 "write_lines.object_lines": 0}) == 100.0
    assert read({"write_lines.lines": 400,
                 "write_lines.object_lines": 100}) == pytest.approx(75.0)


def test_entry_in_the_benchmark():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    [m] = [m for m in spec["per_layer"] if m["name"] == NAME]
    cells = [w["name"] for w in spec["workloads"]]
    assert m["workloads"] == cells
    assert (m["source"], m["layer"], m["moves"], m["better"]) == (
        "program_counter", "batch pipeline, main thread", "reads_per_s",
        "higher")
