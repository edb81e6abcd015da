"""The main thread's encode a batch (``Classifier._dispatch`` up to the
first copy to the card: ``--mask-mode 1``'s masking of the rows; the
native batch reader has already encoded the bases), from the summary's
``stage_ms["encode"]`` (the program's span, host clock)."""


def read(ctx):
    ms = ctx.stage_ms.get("encode")
    if not ctx.batches or ms is None:
        return None
    return ms / ctx.batches
