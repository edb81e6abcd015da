"""One rank of the port's multi-process ``classify`` (the CLI's arguments
follow), with sizes a test sets:

    python -m tests.helpers.torch_dist_rank classify ... --process-id R \\
        [--skew-batch READS,BASES] [--a2a-budget ROWS]

``--skew-batch`` makes rank R's automatic batch (``--batch-reads 0``) end
at READS // (R + 1) reads or BASES // (R + 1) bases, as ranks whose cards
have different free memory size it. ``--a2a-budget`` starts the
all_to_all route at ROWS block rows, so a batch whose segment outgrows
them runs again. Imports only the port.
"""

import sys

from metabuli_tpu_torch.classify.classifier import Classifier
from metabuli_tpu_torch.cli import main
from metabuli_tpu_torch.parallel.dist_classify import ShardedClassifier


def _pop(argv, flag):
    if flag not in argv:
        return None
    i = argv.index(flag)
    value = argv[i + 1]
    del argv[i:i + 2]
    return value


if __name__ == "__main__":
    argv = sys.argv[1:]
    skew, budget = _pop(argv, "--skew-batch"), _pop(argv, "--a2a-budget")
    rank = int(argv[argv.index("--process-id") + 1])
    if skew:
        reads, bases = (int(v) // (rank + 1) for v in skew.split(","))
        Classifier._auto_batch = lambda self: (reads, bases, 1 << 30)
    if budget:
        ShardedClassifier.a2a_budget = int(budget)
    sys.exit(main(argv))
