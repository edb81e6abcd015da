"""The share of the window's classification lines that the native line
writer took as columns, with no ``ReadClassification`` made for their
reads: 100 x (lines - object lines) / lines, from the ``build.launches``
counters ``write_lines.lines`` and ``write_lines.object_lines``. A program
without the counters gives nothing."""


def read(ctx):
    lines = ctx.launches.get("write_lines.lines")
    objects = ctx.launches.get("write_lines.object_lines")
    if not lines or objects is None:
        return None
    return 100.0 * (lines - objects) / lines
