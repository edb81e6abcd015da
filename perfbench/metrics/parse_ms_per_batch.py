"""The main thread's read of the next batch a batch
(``Classifier._run_batches``: ``next`` on the native batch reader,
``io/batch_reader.py`` over ``native/batch_reader.cpp``, which parses the
FASTQ/FASTA records and fills the batch's code matrix, lengths, offsets
and names), from the summary's ``stage_ms["parse"]`` (the program's span,
host clock)."""


def read(ctx):
    ms = ctx.stage_ms.get("parse")
    if not ctx.batches or ms is None:
        return None
    return ms / ctx.batches
