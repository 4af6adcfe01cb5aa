"""The run may not load JAX or the JAX package: top-level module names are
compared whole, so the port `bellpepper_tpu_torch` passes."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "bellpepper_tpu")


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))
