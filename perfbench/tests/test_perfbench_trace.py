"""The metric arithmetic on synthetic traces and tables."""

import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest

from harness import modules, peaks, reference, trace, traffic, world

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def metric(name, ctx):
    spec = importlib.util.spec_from_file_location(
        "m", os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def synthetic():
    """A 10 s window: K1 and K2 launches overlapping a copy, one kernel
    past the window's end, host spans and an op."""
    dev = [
        ("void extract_kernel<false, false>(int)", 1.0, 1.5),
        ("Memcpy HtoD (Pageable -> Device)", 1.25, 2.0),
        ("void count_kernel<false>(long)", 3.0, 3.5),
        ("void write_kernel<false>(long)", 3.5, 4.0),
        ("void extract_kernel<false, false>(int)", 9.5, 11.0),
    ]
    return trace.Trace(window=(0.0, 10.0), device=dev,
                       host=[("classify_file", 0.5, 9.8)],
                       ops=[("aten::copy_", 4.5, 5.5)])


def test_idle_is_the_window_less_the_union():
    tr = synthetic()
    # busy: [1, 2] + [3, 4] + [9.5, 10] = 2.5 s of 10
    assert trace.busy_s(tr) == pytest.approx(2.5)
    assert trace.idle_pct(tr) == pytest.approx(75.0)
    assert trace.gaps(tr) == [(0.0, 1.0), (2.0, 3.0), (4.0, 9.5)]


def test_gaps_are_named_by_the_host():
    top = trace.idle_gaps(synthetic(), n=2)
    assert top[0] == ["classify_file: after aten::copy_",
                      pytest.approx(5.5)]
    named = {round(v, 3): n for n, v in trace.idle_gaps(synthetic())}
    # (0, 1): its middle lies outside every harness span
    assert named[1.0] in ("window: before aten::copy_",
                          "classify_file: before aten::copy_")
    tr = synthetic()
    tr.ops = []
    assert trace.idle_gaps(tr, n=1) == [["classify_file", pytest.approx(5.5)]]


def test_device_ops_and_kernel_counts():
    tr = synthetic()
    ops = trace.device_ops(tr)
    assert ops[0] == ["extract_kernel", pytest.approx(1.0)]
    assert dict(ops)["Memcpy HtoD (Pageable -> Device)"] == \
        pytest.approx(0.75)
    assert trace.kernel_s(tr, "K2") == pytest.approx(1.0)
    assert trace.kernel_count(tr, "extract_kernel") == 2
    assert trace.kernels(tr) == 4  # the copy is no kernel
    counted = {"extract_metamers": 2, "search_scan": 1, "chain_matches": 0,
               "combine_paths": 0}
    assert trace.launches_agree(tr, counted)
    assert not trace.launches_agree(tr, dict(counted, search_scan=2))


def test_profiler_metrics_only_from_a_complete_trace():
    ctx = SimpleNamespace(trace=synthetic(), trace_complete=True,
                          batches=2, k2_bytes=int(3.35e12 * 0.25e-3),
                          peaks=peaks.H100_SXM)
    # 0.25 ms of least time over 1 s of K2
    assert metric("roofline_pct.search_scan", ctx) == pytest.approx(0.025)
    assert metric("device_idle_pct", ctx) == pytest.approx(75.0)
    assert metric("kernel_launches_per_batch", ctx) == pytest.approx(2.0)
    ctx.trace_complete = False
    for name in ("roofline_pct.search_scan", "device_idle_pct",
                 "kernel_launches_per_batch"):
        assert metric(name, ctx) is None


def test_summary_metrics():
    ctx = SimpleNamespace(
        batches=4, main_cpu_s=2.0, finish_s=1.0, finish_overlap_s=0.25,
        index_resident_bytes=3 * 2**30,
        stage_ms={"upload": 8.0, "extract": 1.0, "search_scan": 2.0,
                  "fetch": 3.0, "sort": 4.0, "chain": 1.0, "combine": 1.0,
                  "quotient": 2.0, "finish": 40.0})
    assert metric("main_cpu_ms_per_batch", ctx) == 500.0
    assert metric("finish_ms_per_batch", ctx) == 10.0
    assert metric("finish_overlap_pct", ctx) == 25.0
    assert metric("upload_ms_per_batch", ctx) == 2.0
    assert metric("match_core_ms_per_batch", ctx) == 2.5
    assert metric("tail_ms_per_batch", ctx) == 1.0
    assert metric("index_resident_gib", ctx) == 3.0
    ctx.stage_ms = {}
    assert metric("tail_ms_per_batch", ctx) is None


def test_k2_bytes_count_each_row_once():
    """Two reads whose metamers meet one 3-row group: the group's rows
    count once (8 B each, the value K2 reads; no taxid), every valid
    metamer and kept pair once."""
    nodes, names = [(1, 1, "no rank"), (2, 1, "species"),
                    (3, 1, "species")], {1: "r", 2: "a", 3: "b"}
    tax = world.Taxonomy(nodes, names)
    read = np.frombuffer(b"ATGGCTAAACGTGATTGGCCTTACGGAGCA", np.uint8)[None]
    codes = reference.metamers.to_codes(read)
    import torch

    ex = reference.metamers.Extractor("cpu")
    value, _, _, valid = ex.extract(torch.from_numpy(codes),
                                    torch.tensor([read.shape[1]]))
    v0 = int(value[0, 0, 0])  # frame 0, window 0
    assert bool(valid[0, 0, 0])
    group = sorted([v0, v0 ^ 1, v0 ^ 2])  # other codon numbers, same amino acids
    values = np.array(group + [2**63], np.uint64)  # + the unsearched last row
    taxids = np.array([2, 3, 2, 3], np.uint32)
    table = reference.Table(values, taxids, tax, "cpu")
    both = traffic.Mate(np.concatenate([read[0], read[0]]),
                        np.array([read.shape[1]] * 2))
    got = reference.k2_bytes(table, [both])
    n_valid = int(valid.sum()) * 2
    assert got["kmers"] == n_valid
    assert got["group_rows"] == 3
    assert got["bytes"] == 8 * n_valid + 8 * 3 + 8 * got["matches"]
    assert got["matches"] >= 2  # the exact row, once a read


@pytest.mark.parametrize("names,bad", [
    (["jax", "jax.numpy", "os"], ["jax", "jax.numpy"]),
    (["jaxlib.xla_client", "flax.linen"], ["flax.linen", "jaxlib.xla_client"]),
    (["metabuli_tpu", "metabuli_tpu.ops.encode"],
     ["metabuli_tpu", "metabuli_tpu.ops.encode"]),
    (["metabuli_tpu_torch", "metabuli_tpu_torch.classify", "jaxtyping",
      "flaxen", "numpy"], []),
])
def test_forbidden_modules_by_whole_top_level_name(names, bad):
    assert modules.forbidden(names) == bad


def test_kernel_names_shortened():
    assert trace.short_name(
        "(anonymous namespace)::chain_kernel(int, (anonymous namespace)::"
        "Matches, int const*)") == "chain_kernel"
    assert trace.short_name("void at::native::vectorized_elementwise_kernel"
                            "<4, F>(int, F)") == \
        "at::native::vectorized_elementwise_kernel"
    assert trace.short_name("Memcpy HtoD (Pinned -> Device)") == \
        "Memcpy HtoD (Pinned -> Device)"
    assert trace.short_name("") == "(unnamed)"


def test_trace_from_a_profiler_run():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("window"):
            with torch.profiler.record_function("classify_file"):
                torch.ones(1000).cumsum(0)
    tr = trace.from_profiler(prof)
    assert tr is not None and tr.window_s > 0
    assert [n for n, _, _ in tr.host] == ["classify_file"]
    assert any(n == "aten::cumsum" for n, _, _ in tr.ops)
    assert tr.device == []  # marks are never device operations
