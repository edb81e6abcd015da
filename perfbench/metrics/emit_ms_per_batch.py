"""The main thread's write of a batch's lines and clade counts
(``Classifier._emit_batch``), from the summary's ``stage_ms["emit"]``
(the program's span, host clock)."""


def read(ctx):
    ms = ctx.stage_ms.get("emit")
    if not ctx.batches or ms is None:
        return None
    return ms / ctx.batches
