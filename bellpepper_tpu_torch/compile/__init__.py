"""Witness tapes and the witness program (the evaluator of every opcode
and the bit-sliced one); the production steps are in ``pipeline``."""

from .tape import V_CONST, V_VAR, Op, SnapshotTape, corrupted
from .witness_program import PACKED_OPS, WitnessProgram

__all__ = ["Op", "PACKED_OPS", "SnapshotTape", "V_CONST", "V_VAR", "WitnessProgram", "corrupted"]
