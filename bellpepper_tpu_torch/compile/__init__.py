"""Circuit compilation: witness tapes and the witness program.

``TapeCS`` captures the semantic op behind every allocation of one
template synthesis; ``WitnessProgram`` compiles the tape into a batched
device program (the evaluator of every opcode and the bit-sliced one) that
evaluates whole witness vectors over independent instances. The production
steps are in ``pipeline``."""

from .tape import V_CONST, V_VAR, Op, SnapshotTape, TapeCS, corrupted
from .witness_program import PACKED_OPS, WitnessProgram

__all__ = ["Op", "PACKED_OPS", "SnapshotTape", "TapeCS", "V_CONST", "V_VAR", "WitnessProgram", "corrupted"]
