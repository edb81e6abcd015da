"""The device taxonomer tail a batch
(``classify/device_taxonomer.py::taxonomer_tail``: K3, K4 and the
quotient stage), from ``stage_ms`` chain + combine + quotient (CUDA
events)."""

STAGES = ("chain", "combine", "quotient")


def read(ctx):
    if not ctx.batches or any(s not in ctx.stage_ms for s in STAGES):
        return None
    return sum(ctx.stage_ms[s] for s in STAGES) / ctx.batches
