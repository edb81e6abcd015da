"""The main thread's CPU time a batch: parse, encode, upload, dispatch
and write (``Classifier._run_batches`` and what it calls on that
thread), from the summary's ``main_cpu_s`` (thread CPU clock) summed
over the window's samples."""


def read(ctx):
    if not ctx.batches or ctx.main_cpu_s is None:
        return None
    return 1e3 * ctx.main_cpu_s / ctx.batches
