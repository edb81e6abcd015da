"""The device memory the loaded DB holds: ``torch.cuda.memory_allocated()``
after the ``Classifier`` is built, before the first sample."""


def read(ctx):
    if ctx.index_resident_bytes is None:
        return None
    return ctx.index_resident_bytes / 2**30
