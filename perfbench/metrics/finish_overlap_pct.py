"""The share of the worker's finish during which the main thread parsed
or dispatched another batch: the summary's ``finish_overlap_s`` over its
``finish_s``, summed over the window's samples."""


def read(ctx):
    if not ctx.finish_s:
        return None
    return 100.0 * ctx.finish_overlap_s / ctx.finish_s
