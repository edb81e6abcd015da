"""Whole runs of the harness on a benchmark made of files alone
(``tiny.py``), on the CPU with the look for a card skipped: the last
line, a configuration, mix and metric added as files, the batches counted
as the program cut them, the faults a run must catch, the control, and
the exits without a card or a program."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import tiny
from harness import traffic, world

REPO = tiny.REPO
TIMEOUT = 300


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("bench"))
    tiny.make(r)
    return r


def drive(root, args, fault=None, device="cpu", rc=0):
    cmd = [sys.executable, os.path.join(REPO, "perfbench", "tests",
                                        "tiny.py"), root, "--device", device]
    if fault:
        cmd += ["--fault", fault]
    p = subprocess.run(cmd + ["--"] + args, capture_output=True, text=True,
                       timeout=TIMEOUT, cwd=root)
    assert p.returncode == rc, p.stderr[-3000:]
    if rc:
        assert p.stdout == ""
        return None, p.stderr
    lines = p.stdout.strip().splitlines()
    return json.loads(lines[-1]), p.stderr


def test_end_to_end_line(root):
    res, err = drive(root, ["--workload", "tiny.pe", "--seed",
                            str(2**31 + 5), "--seconds", "0.5"])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] % tiny.MIXES["tiny_pe"]["reads"] == 0
    # no card: no peak; every other end-to-end metric
    assert set(res["metrics"]) == {"reads_per_s", "db_load_s", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["device"]["count"] == 1
    assert {"rows_bad", "lines_mismatched", "reports_mismatched"} == \
        set(res["checks"])
    assert err.strip().splitlines()[-1].startswith(
        "perfbench: check reports_mismatched 0 limit 0")


def long_batches(seed: int, tmp) -> int:
    """The batches the program's reader cuts ``tiny.long``'s first sample
    of ``seed`` into, at ``tiny.BATCH_BASES`` bases."""
    from metabuli_tpu_torch.io.batch_reader import BatchReader

    g = world.genomes(tiny.LONG["world"])[2]
    s = traffic.sample(tiny.MIXES["tiny_long"], g, seed, 0)
    assert np.ptp(s.mates[0].lens) > 300  # drawn lengths
    (path,) = s.write(str(tmp), "s")
    with BatchReader(path, None, 1 << 20, tiny.BATCH_BASES) as reader:
        return sum(1 for _ in reader)


def test_traced_line_with_a_metric_added_as_a_file(root, tmp_path):
    res, _ = drive(root, ["--workload", "tiny.long", "--seed", "7",
                          "--seconds", "0", "--trace", "1"])
    assert res["correct"] is True
    m = res["metrics"]
    # the reader that only the tiny benchmark has, found by its name: the
    # batches of the window's one sample, cut by bases
    assert m["batches_seen"]["value"] == long_batches(7, tmp_path) > 2
    for name in ("main_cpu_ms_per_batch", "finish_ms_per_batch",
                 "match_core_ms_per_batch", "tail_ms_per_batch"):
        assert m[name]["value"] > 0
    # a CPU trace has no device operations: no profiler metric
    assert "device_idle_pct" not in m and "roofline_pct.search_scan" not in m
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_a_broken_path_is_not_correct(root, fault):
    res, err = drive(root, ["--workload", "tiny.pe", "--seed", "11",
                            "--seconds", "0"], fault=fault)
    assert res["correct"] is False
    assert res["checks"]["lines_mismatched"]["value"] > 0
    assert "limit 0" in err


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_a_broken_long_path_is_not_correct(root, fault):
    res, _ = drive(root, ["--workload", "tiny.long", "--seed", "13",
                          "--seconds", "0"], fault=fault)
    assert res["correct"] is False
    assert res["checks"]["lines_mismatched"]["value"] > 0


def test_jax_in_the_process_no_result(root):
    _, err = drive(root, ["--workload", "tiny.pe", "--seed", "11",
                          "--seconds", "0"], fault="jax", rc=3)
    assert "loaded JAX or the JAX package: jax" in err


def test_control_is_not_correct(root):
    res, _ = drive(root, ["--workload", "tiny.long", "--seed", "11",
                          "--seconds", "0", "--control", "1"])
    assert res["correct"] is False
    assert res["checks"]["lines_mismatched"]["value"] > 0


def test_no_card_no_result():
    if "CUDA_VISIBLE_DEVICES" not in os.environ:
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is here")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "prok_deep.pe150", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=TIMEOUT, cwd=REPO)
    assert p.returncode != 0 and p.stdout == ""


def test_no_program_no_result(root, tmp_path):
    """A checkout of the benchmark alone fails before any work."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "perfbench"),
                    tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "prok_deep.pe150", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True,
                       text=True, timeout=TIMEOUT, cwd=tmp_path,
                       env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0 and p.stdout == ""
    assert not (tmp_path / "perfbench" / "cache").exists()


@pytest.mark.gpu
def test_tiny_cell_on_the_card(root):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res, _ = drive(root, ["--workload", "tiny.pe", "--seed", "3",
                          "--seconds", "0", "--trace", "1"], device="cuda")
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0


@pytest.mark.gpu
def test_tiny_long_cell_on_the_card(root, tmp_path):
    """Drawn lengths with indels, batches cut by bases: correct, the
    batches the program's, and the control not correct."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res, err = drive(root, ["--workload", "tiny.long", "--seed", "5",
                            "--seconds", "0", "--trace", "1"],
                     device="cuda")
    print(err[-2000:])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert res["metrics"]["batches_seen"]["value"] == \
        long_batches(5, tmp_path) > 2
    res, err = drive(root, ["--workload", "tiny.long", "--seed", "5",
                            "--seconds", "0", "--control", "1"],
                     device="cuda")
    print(err[-600:])
    assert res["correct"] is False
