"""The long-read cell: its configuration, mix and cell resolve from the
real BENCHMARK.json, and the readers of its per-layer metrics (K1's
padding, the rooflines of K3 and K4) give nothing without their counters
or a complete trace and the right number on a synthetic context."""

import importlib.util
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

import run
from harness import peaks, trace, traffic

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
CELL = "prok_deep_long.long3k"


def module(name):
    spec = importlib.util.spec_from_file_location(
        "m", os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_long_cell_resolves():
    cell, cfg, mix, spec = run.load_cell(REPO, BENCH, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "prok_deep_2e28_long", "long3k", 1)
    deep = next(c for c in spec["configs"] if c["name"] == "prok_deep_2e28")
    with open(os.path.join(REPO, deep["file"])) as fh:
        short = json.load(fh)
    # the same DB as the paired cell's; long reads, automatic batches
    for key in ("rows", "genomes", "world", "decoys", "db"):
        assert cfg[key] == short[key], key
    assert cfg["classify"] == {"seq_mode": 3, "batch_reads": 0,
                               "threads": 8, "device_tax": 1}
    assert set(cfg["reduced"]) == {"rows", "genomes"}
    entry = next(c for c in spec["configs"] if c["name"] == cfg["name"])
    assert entry["reduced"] == ["rows", "genomes"]
    assert mix["reads"] == 65536 and not mix["paired"]
    assert (mix["len_mean"], mix["len_sd"], mix["min_len"],
            mix["max_len"]) == (3000, 2000, 500, 30000)
    assert mix["sub_rate"] == mix["ins_rate"] == mix["del_rate"] == 0.01
    lens = traffic.lengths(mix)
    assert lens.min() >= 500 and lens.max() <= 30000
    assert abs(lens.mean() - 3000) < 60
    metrics = {m["name"]: m for m in spec["per_layer"]}
    for name in ("k1_padding_pct", "roofline_pct.chain_matches",
                 "roofline_pct.combine_paths"):
        assert CELL in metrics[name]["workloads"]
        assert os.path.exists(os.path.join(BENCH, "metrics", name + ".py"))


def test_k1_padding():
    read = module("k1_padding_pct").read
    assert read(SimpleNamespace(launches={})) is None
    assert read(SimpleNamespace(launches={"extract_metamers": 3})) is None
    ctx = SimpleNamespace(launches={"extract_metamers.padded_bases": 1000,
                                    "extract_metamers.bases": 880})
    assert read(ctx) == pytest.approx(12.0)


def synthetic(k3_s: float, k4_s: float) -> trace.Trace:
    return trace.Trace(window=(0.0, 10.0), device=[
        ("void chain_kernel(int, Matches)", 1.0, 1.0 + k3_s),
        ("void combine_kernel(int, int const*)", 3.0, 3.0 + k4_s)])


def test_chain_bytes_by_hand():
    """One match: qid, species, frame, pos, hamming, dna and h16 read
    (28 B); score, start, hamming, depth, start h16 (20 B) and the emit
    flag (1 B) written."""
    assert module("roofline_pct.chain_matches").least_bytes(1) == 49
    assert module("roofline_pct.chain_matches").least_bytes(1000) == 49000


def test_combine_bytes_by_hand():
    """Two groups of 3 and 1 paths: 4 x (start, end, score) = 48 B, 2 x
    (bound, read, read length, score) = 32 B."""
    assert module("roofline_pct.combine_paths").least_bytes(2, 4) == 80


@pytest.mark.parametrize("name,counters,kernel_s,bytes_", [
    ("roofline_pct.chain_matches", {"chain_matches.matches": 10**9},
     (0.1, 0.0), 49 * 10**9),
    ("roofline_pct.combine_paths",
     {"combine_paths.groups": 10**8, "combine_paths.paths": 10**9},
     (0.0, 0.01), 16 * 10**8 + 12 * 10**9),
])
def test_rooflines(name, counters, kernel_s, bytes_):
    read = module(name).read
    hbm = peaks.H100_SXM["hbm_bytes_per_s"]
    ctx = SimpleNamespace(trace=synthetic(*kernel_s), trace_complete=True,
                          launches=dict(counters), peaks=peaks.H100_SXM)
    want = 100.0 * bytes_ / hbm / max(kernel_s)
    assert read(ctx) == pytest.approx(want)
    # no counters (the parent's program), an incomplete trace, no trace,
    # no launch of the kernel in the trace
    for change in ({"launches": {}}, {"trace_complete": False},
                   {"trace": None}, {"trace": synthetic(0.0, 0.0)}):
        assert read(SimpleNamespace(**{**vars(ctx), **change})) is None


def test_the_mix_cut_as_the_program_cuts_it():
    """The mix's lengths in the automatic batch's 16,384 reads, cut as
    the port cuts a batch (the tests may import the port): at most 1.25
    times the bases padded, in a few dozen blocks."""
    from metabuli_tpu_torch.classify.pipeline import length_blocks

    _, _, mix, _ = run.load_cell(REPO, BENCH, CELL)
    lens = traffic.lengths(mix)
    for a in range(0, lens.size, 16384):
        part = lens[a:a + 16384]
        blocks = length_blocks(part)
        padded = sum(len(b) * int(part[b].max()) for b in blocks)
        assert padded <= 1.25 * part.sum()
        assert len(blocks) < 40
        assert np.array_equal(np.sort(np.concatenate(blocks)),
                              np.arange(part.size))
