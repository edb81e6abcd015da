"""The match core a batch (``classify/pipeline.py::classify_core``: K1,
K2, the fetch and the 5-key sort), from ``stage_ms`` extract +
search_scan + fetch + sort (CUDA events)."""

STAGES = ("extract", "search_scan", "fetch", "sort")


def read(ctx):
    if not ctx.batches or any(s not in ctx.stage_ms for s in STAGES):
        return None
    return sum(ctx.stage_ms[s] for s in STAGES) / ctx.batches
