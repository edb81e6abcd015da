"""The main thread's FASTQ read and batch assembly a batch
(``Classifier._run_batches``: the next batch from ``_iter_batches``),
from the summary's ``stage_ms["parse"]`` (the program's span, host
clock)."""


def read(ctx):
    ms = ctx.stage_ms.get("parse")
    if not ctx.batches or ms is None:
        return None
    return ms / ctx.batches
