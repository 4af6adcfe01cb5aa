"""Witness-tape data types shared by the native builder and WitnessProgram.

Reference: ``bellpepper_tpu/compile/tape.py:23-37``. The recording
backend ``TapeCS`` is not ported yet; ``WitnessProgram`` accepts any tape
object with ``.field`` and ``.snapshot()``, including the JAX package's.

Operand encodings:
  bit var, field var → slot index
  Boolean view       → (V_CONST, 0/1, 0) | (V_VAR, slot, negated)
  small LC (num_iszero, num_inv_or_one) → [(coeff, slot), ...]
  lookup             → ([index-bit views], (table values, ...))
  select             → [condition view, slot if true, slot if false]
"""

from __future__ import annotations

from typing import List

# View kinds
V_CONST = 0
V_VAR = 1


class Op:
    __slots__ = ("opcode", "outs", "args")

    def __init__(self, opcode: str, outs: List[int], args):
        self.opcode = opcode
        self.outs = outs
        self.args = args

    def __repr__(self) -> str:  # pragma: no cover
        more = "..." if len(self.outs) > 4 else ""
        return f"Op({self.opcode}, outs={self.outs[:4]}{more})"


class SnapshotTape:
    """A tape made of a snapshot (num_inputs, num_aux, ops, free_slots)."""

    def __init__(self, field, snap):
        self.field = field
        self._snap = snap

    def snapshot(self):
        return self._snap


def corrupted(tape, opcode: str, pick: str = "last", into: str = "and", swap: bool = False, where=None):
    """The tape with one `opcode` op rewritten: the first or the last
    (`pick`) of those for which ``where(op)`` holds (every one without
    `where`) computes `into` instead or, with `swap`, takes its first two
    arguments swapped."""
    ni, na, ops, free = tape.snapshot()
    hits = [k for k, op in enumerate(ops) if op.opcode == opcode and (where is None or where(op))]
    i = {"first": hits[0], "last": hits[-1]}[pick]
    ops = list(ops)
    args = list(ops[i].args)
    if swap:
        args[0], args[1] = args[1], args[0]
    ops[i] = Op(ops[i].opcode if swap else into, ops[i].outs, args)
    return SnapshotTape(tape.field, (ni, na, ops, free))
