"""Witness tapes: TapeCS records the witness op-graph during a single
template synthesis; the tape data types are shared with the native builder
and WitnessProgram.

Reference: ``bellpepper_tpu/compile/tape.py``. A circuit written with the
port's gadgets is synthesized once into ``TapeCS`` (and once into
``r1cs.ShapeCS`` for its R1CS); ``native.NativeBuilder`` writes the same
tape from C++. Every allocation defaults to FREE (a value supplied at
witness-generation time); gadget hooks (ConstraintSystem.record_witness_op)
override the slot with its semantic op. Slots are global: inputs first
(slot 0 = ONE), then aux — the same column space as the compiled R1CS.
``WitnessProgram`` accepts any tape object with ``.field`` and
``.snapshot()``: these, ``SnapshotTape`` and the JAX package's.

Operand encodings:
  bit var, field var → slot index
  Boolean view       → (V_CONST, 0/1, 0) | (V_VAR, slot, negated)
  small LC (num_iszero, num_inv_or_one) → [(coeff, slot), ...]
  lookup             → ([index-bit views], (table values, ...))
  select             → [condition view, slot if true, slot if false]
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..constraint_system import ConstraintSystem
from ..fields import SCALAR, PrimeField
from ..lc import INPUT, Index, Variable

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


class TapeCS(ConstraintSystem):
    """Witness-tape recording backend.

    Synthesize the circuit once (values may be None — closures are never
    invoked), then hand the tape to WitnessProgram. Constraint structure is
    NOT recorded here; pair with ShapeCS for the R1CS."""

    def __init__(self, field: PrimeField = SCALAR):
        self.field = field
        self.num_inputs = 1
        self.num_aux = 0
        # op per slot (None = free); slot = global index. op_list preserves
        # recording order, which respects dependencies (gadgets record an
        # op only after its operands exist) — slot order does NOT (inputize
        # writes a low input slot from a later aux slot).
        self.ops: dict[int, Op] = {}
        self.op_list: List[Op] = []
        self.alloc_order: List[Tuple[bool, int]] = []

    # -- slot helpers --------------------------------------------------------
    def slot_of(self, var: Variable, num_inputs: Optional[int] = None) -> int:
        """Global slot of a variable. Aux slots are provisional during
        synthesis (input count still growing); finalized in snapshot()."""
        idx = var.index
        if idx.tag == INPUT:
            return idx.idx
        return ~idx.idx  # marker; resolved at snapshot

    def _resolve(self, s: int) -> int:
        return s if s >= 0 else self.num_inputs + (~s)

    # -- ConstraintSystem ------------------------------------------------------
    def alloc_within(self, _prefix, _annotation, _f) -> Variable:
        self.num_aux += 1
        v = Variable(Index.aux(self.num_aux - 1))
        self.alloc_order.append((False, self.num_aux - 1))
        return v

    def alloc_input_within(self, _prefix, _annotation, _f) -> Variable:
        self.num_inputs += 1
        v = Variable(Index.input(self.num_inputs - 1))
        self.alloc_order.append((True, self.num_inputs - 1))
        return v

    def enforce_within(self, _prefix, _annotation, _a, _b, _c) -> None:
        pass

    def register_namespace(self, prefix) -> None:
        pass

    # -- op recording -------------------------------------------------------------
    def _view(self, boolean) -> Tuple[int, int, int]:
        """Normalize a Boolean to (kind, slot_or_const, negated)."""
        from ..gadgets.boolean import Boolean

        assert isinstance(boolean, Boolean)
        if boolean.kind == Boolean.CONST:
            return (V_CONST, 1 if boolean.const_value else 0, 0)
        slot = self.slot_of(boolean.bit.get_variable())
        return (V_VAR, slot, 1 if boolean.kind == Boolean.NOT else 0)

    def record_witness_op(self, opcode: str, out_vars, operands) -> None:
        outs = [self.slot_of(v) for v in out_vars]
        if opcode in ("xor", "and", "and_not", "nor"):
            args = [self.slot_of(v) for v in operands]
        elif opcode in ("ch", "maj"):
            args = [self._view(b) for b in operands]
        elif opcode == "addmany":
            # operands: list of words, each a list of 32 Booleans.
            args = [[self._view(b) for b in word] for word in operands]
        elif opcode in ("fadd", "fmul", "finv", "copy", "fbits_le"):
            args = [self.slot_of(v) for v in operands]
        elif opcode == "select":
            cond, x, y = operands
            args = [self._view(cond), self.slot_of(x), self.slot_of(y)]
        elif opcode == "pack":
            args = [self._view(b) for b in operands]
        elif opcode == "lookup":
            # operands: (index bits LSB-first as Booleans, 2^k field consts).
            # The gadget folds any conditional negation into the table
            # (lookup.rs:122-187's sign bit becomes the top index bit).
            bits, table = operands
            args = ([self._view(b) for b in bits], tuple(int(t) for t in table))
        elif opcode in ("num_iszero", "num_inv_or_one"):
            (num,) = operands
            terms = []
            for k, coeff in num._lc.inputs.iter():
                terms.append((coeff, k))
            for k, coeff in num._lc.aux.iter():
                terms.append((coeff, ~k))
            args = terms
        else:
            raise ValueError(f"unknown witness opcode: {opcode}")
        op = Op(opcode, outs, args)
        self.op_list.append(op)
        for o in outs:
            self.ops[o] = op

    # -- snapshot -----------------------------------------------------------------
    def snapshot(self):
        """Resolve provisional aux slots against the final input count.
        Returns (num_inputs, num_aux, resolved op list in recording order,
        free_slots list in allocation order)."""
        R = self._resolve
        resolved = []
        for op in self.op_list:
            outs = [R(o) for o in op.outs]
            oc = op.opcode
            if oc in ("xor", "and", "and_not", "nor", "fadd", "fmul", "finv", "copy", "fbits_le"):
                args = [R(a) for a in op.args]
            elif oc in ("ch", "maj", "pack"):
                args = [
                    (k, R(s) if k == V_VAR else s, n) for (k, s, n) in op.args
                ]
            elif oc == "addmany":
                args = [
                    [(k, R(s) if k == V_VAR else s, n) for (k, s, n) in word]
                    for word in op.args
                ]
            elif oc == "select":
                (ck, cs_, cn), x, y = op.args
                args = [(ck, R(cs_) if ck == V_VAR else cs_, cn), R(x), R(y)]
            elif oc in ("num_iszero", "num_inv_or_one"):
                args = [(coeff, R(s)) for (coeff, s) in op.args]
            elif oc == "lookup":
                views, table = op.args
                args = (
                    [(k, R(s) if k == V_VAR else s, n) for (k, s, n) in views],
                    table,
                )
            else:  # pragma: no cover
                raise AssertionError(oc)
            resolved.append(Op(oc, outs, args))

        produced = {o for op in resolved for o in op.outs}
        free = []
        for is_input, idx in self.alloc_order:
            slot = idx if is_input else self.num_inputs + idx
            if slot not in produced:
                free.append(slot)
        return self.num_inputs, self.num_aux, resolved, free


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
