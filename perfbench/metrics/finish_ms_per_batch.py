"""The worker's host finish a batch (``DeviceTaxonomer.drain`` -> the
native ``taxonomer_finish``), from the summary's ``stage_ms["finish"]``
(host clock)."""


def read(ctx):
    ms = ctx.stage_ms.get("finish")
    if not ctx.batches or ms is None:
        return None
    return ms / ctx.batches
