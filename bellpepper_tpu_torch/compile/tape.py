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
