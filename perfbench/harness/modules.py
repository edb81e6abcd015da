"""The check that the process never loaded JAX or the JAX package."""

from __future__ import annotations

FORBIDDEN = ("jax", "jaxlib", "flax", "metabuli_tpu")


def forbidden(names) -> list[str]:
    """The loaded module names whose top-level name (the part before the
    first dot), compared whole, is a forbidden one: ``metabuli_tpu_torch``
    is not ``metabuli_tpu``."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
