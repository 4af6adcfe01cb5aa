"""Gadget library — circuit building blocks.

Mirrors reference crates/bellpepper/src/gadgets/mod.rs: primitive gadgets
(boolean, num) live logically in the core; composite gadgets (uint32,
multieq, multipack, boolean_utils, lookup) and circuit apps (sha256,
blake2s) layer on top."""

from ..constraint_system import AssignmentMissingError


def get_value(opt):
    """The `Assignment` helper (gadgets/mod.rs:19-32): unwrap an optional
    witness value or raise AssignmentMissing."""
    if opt is None:
        raise AssignmentMissingError()
    return opt


from . import boolean, num  # noqa: E402

__all__ = ["get_value", "boolean", "num"]
