"""K2's (``csrc/search_scan.cu``) share of its memory roofline: the least
time, the benchmark's own byte count of the window's searches at the
card's HBM bandwidth, over K2's device time in the profiler trace. The
bytes come from the reference's join (``harness.reference.k2_bytes``):
each valid query metamer read once, each row of a group a query met
read once (its 8 B value, no taxid), each kept pair written once."""

from harness import trace


def read(ctx):
    if ctx.trace is None or not ctx.trace_complete or not ctx.k2_bytes:
        return None
    k2 = trace.kernel_s(ctx.trace, "K2")
    if k2 <= 0:
        return None
    return 100.0 * ctx.k2_bytes / ctx.peaks["hbm_bytes_per_s"] / k2
