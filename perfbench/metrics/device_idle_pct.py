"""The share of the traced window in which no kernel, copy or fill ran on
the card: the window less the union of device operation intervals."""

from harness import trace


def read(ctx):
    if ctx.trace is None or not ctx.trace_complete:
        return None
    return trace.idle_pct(ctx.trace)
