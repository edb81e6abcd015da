"""A batch's copy to the card (``Classifier._dispatch``), from
``stage_ms["upload"]`` (CUDA events of the program's ``StageTimer``)."""


def read(ctx):
    ms = ctx.stage_ms.get("upload")
    if not ctx.batches or ms is None:
        return None
    return ms / ctx.batches
