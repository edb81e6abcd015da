"""The main thread's launch a batch (``Classifier._dispatch`` from the
first copy to the card to the queued copy back: the upload, the device
stages' launches and the read-backs they wait on), from the summary's
``stage_ms["launch"]`` (the program's span, host clock)."""


def read(ctx):
    ms = ctx.stage_ms.get("launch")
    if not ctx.batches or ms is None:
        return None
    return ms / ctx.batches
