"""The main thread's stall a batch: the wall time of its parse, encode,
launch and emit spans less its CPU time in them (the interpreter lock
held by the worker, the host's preemption, waits the thread sleeps
through), from the summary's ``stage_ms["main_stall"]`` (host and
thread clocks)."""


def read(ctx):
    ms = ctx.stage_ms.get("main_stall")
    if not ctx.batches or ms is None:
        return None
    return ms / ctx.batches
