"""CUDA kernels a batch in the profiler trace of the window (the hand
kernels and every PyTorch operation between them), once the trace holds
every K1-K4 launch the program counted."""

from harness import trace


def read(ctx):
    if ctx.trace is None or not ctx.trace_complete or not ctx.batches:
        return None
    return trace.kernels(ctx.trace) / ctx.batches
