"""The main thread's wait on the worker's finish a batch
(``Classifier._run_batches``: the future's ``result()``), from the
summary's ``stage_ms["wait"]`` (the program's span, host clock)."""


def read(ctx):
    ms = ctx.stage_ms.get("wait")
    if not ctx.batches or ms is None:
        return None
    return ms / ctx.batches
