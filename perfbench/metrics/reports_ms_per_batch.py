"""The main thread's report and Krona files a sample
(``Classifier._write_reports``) over the batches, from the summary's
``stage_ms["reports"]`` (the program's span, host clock)."""


def read(ctx):
    ms = ctx.stage_ms.get("reports")
    if not ctx.batches or ms is None:
        return None
    return ms / ctx.batches
