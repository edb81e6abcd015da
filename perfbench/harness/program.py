"""The system under test, as users call it: the port's ``Classifier``
(what ``cli.py classify`` builds) and its launch counters. The only
module of the benchmark that imports the port."""

from __future__ import annotations

import copy


def classifier(db_dir: str, settings: dict, device: str):
    """A ``Classifier`` of ``db_dir`` with the configuration's classify
    settings (``ClassifyParams`` field names)."""
    from metabuli_tpu_torch.classify.classifier import Classifier
    from metabuli_tpu_torch.params import ClassifyParams

    return Classifier(db_dir, ClassifyParams(**settings), device=device)


def build(cuda: bool) -> None:
    """Build (or find built) and load the program's native host library
    and, on a card, its kernel library, as its first call would."""
    from metabuli_tpu_torch import native

    native.get_lib()
    if cuda:
        from metabuli_tpu_torch.csrc import build as kernels

        kernels.get_lib()


def launches() -> dict:
    """The program's kernel launch counters, as they stand."""
    from metabuli_tpu_torch.csrc import build

    return copy.copy(build.launches)
