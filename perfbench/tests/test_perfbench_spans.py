"""The readers of the program's main-thread spans, and idle gaps named by
those spans, on synthetic summaries and traces."""

import importlib.util
import os
from types import SimpleNamespace

import pytest

from harness import trace

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# reader -> the stage_ms key it reads
READERS = {
    "parse_ms_per_batch": "parse",
    "encode_ms_per_batch": "encode",
    "launch_ms_per_batch": "launch",
    "finish_wait_ms_per_batch": "wait",
    "emit_ms_per_batch": "emit",
    "reports_ms_per_batch": "reports",
    "main_stall_ms_per_batch": "main_stall",
}


def metric(name, ctx):
    spec = importlib.util.spec_from_file_location(
        "m", os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_reader_is_ms_a_batch_or_none(name):
    key = READERS[name]
    stage_ms = {k: 10.0 * (i + 1) for i, k in enumerate(READERS.values())}
    ctx = SimpleNamespace(batches=4, stage_ms=stage_ms)
    assert metric(name, ctx) == stage_ms[key] / 4
    # a parent without the span, or a window without batches
    ctx.stage_ms = {k: v for k, v in stage_ms.items() if k != key}
    assert metric(name, ctx) is None
    ctx.stage_ms, ctx.batches = stage_ms, 0
    assert metric(name, ctx) is None


def test_a_gap_over_a_program_span_is_named_by_it():
    """The device idles from 2 s to 6 s while the main thread parses;
    the gap takes the span's name, not the runtime calls around it."""
    tr = trace.Trace(
        window=(0.0, 8.0),
        device=[("void count_kernel<false>(long)", 1.0, 2.0),
                ("void chain_kernel(int)", 6.0, 7.0)],
        host=[("classify_file", 0.5, 7.5)],
        ops=[("cudaEventSynchronize", 1.9, 2.05),
             ("metabuli.parse", 2.1, 5.0),
             ("metabuli.encode", 5.0, 5.9),
             ("cudaLaunchKernel", 5.95, 6.0)])
    top = trace.idle_gaps(tr, n=1)
    assert top == [["classify_file: metabuli.parse", pytest.approx(4.0)]]
