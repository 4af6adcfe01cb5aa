"""Field-element gadgets: AllocatedNum and the symbolic Num accumulator.

Re-design of reference crates/bellpepper-core/src/gadgets/num.rs. Exact
constraint formulas preserved:

  inputize              input * 1 = aux                    num.rs:104-121
  add                   (a + b) * 1 = c                    num.rs:279-309
  mul                   a * b = c                          num.rs:311-341
  square                a * a = c                          num.rs:343-373
  assert_nonzero        a * inv = 1                        num.rs:375-403
  conditionally_reverse (a-b)*cond = a-c; (b-a)*cond = b-d num.rs:408-454
  to_bits_le[_strict]   Σ 2^i·bit − a = 0 (+ in-field run-of-ones check)
                                                           num.rs:128-277
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..constraint_system import (
    AssignmentMissingError,
    ConstraintSystem,
    DivisionByZeroError,
)
from ..lc import LinearCombination, Variable
from .boolean import AllocatedBit, Boolean, field_into_allocated_bits_le


def _require(value):
    if value is None:
        raise AssignmentMissingError()
    return value


class AllocatedNum:
    """An allocated field element (num.rs:10-14)."""

    __slots__ = ("value", "variable")

    def __init__(self, value: Optional[int], variable: Variable):
        self.value = value
        self.variable = variable

    def get_value(self) -> Optional[int]:
        return self.value

    def get_variable(self) -> Variable:
        return self.variable

    # -- serde parity (num.rs:10-14 derive(Serialize, Deserialize)) -------
    # Field values serialize as the canonical 32-byte repr in hex
    # (big-endian, the `to_repr` byte order reversed — same convention as
    # the shape hash); None maps to null like serde's Option.
    def to_json(self) -> dict:
        return {
            "value": (
                None if self.value is None else f"{self.value:064x}"
            ),
            "variable": self.variable.to_json(),
        }

    @staticmethod
    def from_json(obj: dict) -> "AllocatedNum":
        v = obj["value"]
        return AllocatedNum(
            None if v is None else int(v, 16),
            Variable.from_json(obj["variable"]),
        )

    # -- allocation ----------------------------------------------------------
    @staticmethod
    def alloc(cs: ConstraintSystem, value) -> "AllocatedNum":
        holder = {}

        def f():
            v = value() if callable(value) else value
            v = _require(v) % cs.field.p
            holder["v"] = v
            return v

        var = cs.alloc("num", f)
        return AllocatedNum(holder.get("v"), var)

    @staticmethod
    def alloc_infallible(cs: ConstraintSystem, value) -> "AllocatedNum":
        return AllocatedNum.alloc(cs, value)

    @staticmethod
    def alloc_input(cs: ConstraintSystem, value) -> "AllocatedNum":
        holder = {}

        def f():
            v = value() if callable(value) else value
            v = _require(v) % cs.field.p
            holder["v"] = v
            return v

        var = cs.alloc_input("input num", f)
        return AllocatedNum(holder.get("v"), var)

    @staticmethod
    def alloc_maybe_input(cs: ConstraintSystem, is_input: bool, value) -> "AllocatedNum":
        return (
            AllocatedNum.alloc_input(cs, value)
            if is_input
            else AllocatedNum.alloc(cs, value)
        )

    def inputize(self, cs: ConstraintSystem) -> None:
        """Mirror an aux variable as a public input (num.rs:104-121)."""
        input_var = cs.alloc_input("input variable", lambda: _require(self.value))
        cs.record_witness_op("copy", [input_var], [self.variable])
        cs.enforce(
            "enforce input is correct",
            lambda lc: lc + input_var,
            lambda lc: lc + ConstraintSystem.one(),
            lambda lc: lc + self.variable,
        )

    # -- bit decomposition ---------------------------------------------------
    def to_bits_le_strict(self, cs: ConstraintSystem) -> List[Boolean]:
        """Full in-field LE bit decomposition (num.rs:128-251).

        Enforces value < modulus with the run-of-ones k-ary AND trick over
        the big-endian bits of -1 (= p-1): inside a run of ones of p-1, bits
        are allocated normally; at each zero of p-1, the bit is allocated
        with alloc_conditionally against the AND of the preceding run —
        forcing it to 0 whenever all higher run-bits equal p-1's."""
        field = cs.field

        def kary_and(cs_ns, v: List[AllocatedBit]) -> AllocatedBit:
            assert v
            cur = v[0]
            for i, bit in enumerate(v):
                if i == 0:
                    continue
                cur = AllocatedBit.and_(cs_ns.namespace(f"and {i}"), cur, bit)
            return cur

        n = field.NUM_BITS
        # Big-endian bits of p - 1 and of the value.
        b_bits = [(field.p - 1) >> (n - 1 - i) & 1 for i in range(n)]
        a_bits = (
            [((self.value >> (n - 1 - i)) & 1) == 1 for i in range(n)]
            if self.value is not None
            else [None] * n
        )

        result: List[AllocatedBit] = []
        last_run: Optional[AllocatedBit] = None
        current_run: List[AllocatedBit] = []
        i = 0
        for b, a_bit in zip(b_bits, a_bits):
            # p's top bit is 1, so no leading-zero skip is needed here (the
            # reference skips repr bits above NUM_BITS, boolean-style).
            if b:
                a = AllocatedBit.alloc(cs.namespace(f"bit {i}"), a_bit)
                current_run.append(a)
                result.append(a)
            else:
                if current_run:
                    if last_run is not None:
                        current_run.append(last_run)
                    last_run = kary_and(cs.namespace(f"run ending at {i}"), current_run)
                    current_run = []
                a = AllocatedBit.alloc_conditionally(
                    cs.namespace(f"bit {i}"), a_bit, last_run
                )
                result.append(a)
            i += 1

        assert not current_run  # p is prime → ends on a run of zeros

        cs.record_witness_op(
            "fbits_le",
            [b.get_variable() for b in reversed(result)],
            [self.variable],
        )

        # Unpack: Σ 2^i bit_i − self = 0 over little-endian order.
        lc = LinearCombination.zero(field)
        coeff = field.ONE
        for bit in reversed(result):
            lc.iadd_term(bit.get_variable(), coeff)
            coeff = field.double(coeff)
        lc.isub_term(self.variable)
        cs.enforce("unpacking constraint", lambda l: l, lambda l: l, lambda _l: lc)

        return [Boolean.from_bit(b) for b in reversed(result)]

    def to_bits_le(self, cs: ConstraintSystem) -> List[Boolean]:
        """Non-strict LE decomposition (num.rs:256-277)."""
        field = cs.field
        bits = field_into_allocated_bits_le(cs, self.value)
        cs.record_witness_op(
            "fbits_le", [b.get_variable() for b in bits], [self.variable]
        )
        lc = LinearCombination.zero(field)
        coeff = field.ONE
        for bit in bits:
            lc.iadd_term(bit.get_variable(), coeff)
            coeff = field.double(coeff)
        lc.isub_term(self.variable)
        cs.enforce("unpacking constraint", lambda l: l, lambda l: l, lambda _l: lc)
        return [Boolean.from_bit(b) for b in bits]

    # -- arithmetic --------------------------------------------------------------
    def add(self, cs: ConstraintSystem, other: "AllocatedNum") -> "AllocatedNum":
        field = cs.field

        def f():
            return field.add(_require(self.value), _require(other.value))

        value = (
            field.add(self.value, other.value)
            if self.value is not None and other.value is not None
            else None
        )
        var = cs.alloc("sum num", f)
        cs.record_witness_op("fadd", [var], [self.variable, other.variable])
        cs.enforce(
            "addition constraint",
            lambda lc: lc + self.variable + other.variable,
            lambda lc: lc + ConstraintSystem.one(),
            lambda lc: lc + var,
        )
        return AllocatedNum(value, var)

    def mul(self, cs: ConstraintSystem, other: "AllocatedNum") -> "AllocatedNum":
        field = cs.field

        def f():
            return field.mul(_require(self.value), _require(other.value))

        value = (
            field.mul(self.value, other.value)
            if self.value is not None and other.value is not None
            else None
        )
        var = cs.alloc("product num", f)
        cs.record_witness_op("fmul", [var], [self.variable, other.variable])
        cs.enforce(
            "multiplication constraint",
            lambda lc: lc + self.variable,
            lambda lc: lc + other.variable,
            lambda lc: lc + var,
        )
        return AllocatedNum(value, var)

    def square(self, cs: ConstraintSystem) -> "AllocatedNum":
        field = cs.field

        def f():
            return field.square(_require(self.value))

        value = field.square(self.value) if self.value is not None else None
        var = cs.alloc("squared num", f)
        cs.record_witness_op("fmul", [var], [self.variable, self.variable])
        cs.enforce(
            "squaring constraint",
            lambda lc: lc + self.variable,
            lambda lc: lc + self.variable,
            lambda lc: lc + var,
        )
        return AllocatedNum(value, var)

    def assert_nonzero(self, cs: ConstraintSystem) -> None:
        field = cs.field

        def f():
            v = _require(self.value)
            inv = field.invert(v)
            if inv is None:
                raise DivisionByZeroError()
            return inv

        inv_var = cs.alloc("ephemeral inverse", f)
        cs.record_witness_op("finv", [inv_var], [self.variable])
        cs.enforce(
            "nonzero assertion constraint",
            lambda lc: lc + self.variable,
            lambda lc: lc + inv_var,
            lambda lc: lc + ConstraintSystem.one(),
        )

    @staticmethod
    def conditionally_reverse(
        cs: ConstraintSystem,
        a: "AllocatedNum",
        b: "AllocatedNum",
        condition: Boolean,
    ) -> Tuple["AllocatedNum", "AllocatedNum"]:
        """(b, a) if condition else (a, b), two constraints (num.rs:408-454)."""
        field = cs.field
        one = ConstraintSystem.one()

        def fc():
            return _require(b.value) if _require(condition.get_value()) else _require(a.value)

        c = AllocatedNum.alloc(cs.namespace("conditional reversal result 1"), fc)
        cs.record_witness_op("select", [c.variable], [condition, b.variable, a.variable])
        cs.enforce(
            "first conditional reversal",
            lambda lc: lc + a.variable - b.variable,
            lambda _lc: condition.lc(one, field.ONE, field),
            lambda lc: lc + a.variable - c.variable,
        )

        def fd():
            return _require(a.value) if _require(condition.get_value()) else _require(b.value)

        d = AllocatedNum.alloc(cs.namespace("conditional reversal result 2"), fd)
        cs.record_witness_op("select", [d.variable], [condition, a.variable, b.variable])
        cs.enforce(
            "second conditional reversal",
            lambda lc: lc + b.variable - a.variable,
            lambda _lc: condition.lc(one, field.ONE, field),
            lambda lc: lc + b.variable - d.variable,
        )
        return c, d


class Num:
    """Symbolic LC accumulator — addition costs zero constraints
    (num.rs:465-540)."""

    __slots__ = ("value", "_lc", "field")

    def __init__(self, field, value: Optional[int], lc: LinearCombination):
        self.field = field
        self.value = value
        self._lc = lc

    @staticmethod
    def zero(field) -> "Num":
        return Num(field, field.ZERO, LinearCombination.zero(field))

    @staticmethod
    def from_allocated_num(field, num: AllocatedNum) -> "Num":
        return Num(field, num.value, LinearCombination.from_variable(field, num.variable))

    def get_value(self) -> Optional[int]:
        return self.value

    def lc(self, coeff: int) -> LinearCombination:
        return LinearCombination.zero(self.field) + (coeff, self._lc)

    def add_bool_with_coeff(self, one: Variable, bit: Boolean, coeff: int) -> "Num":
        bval = bit.get_value()
        if self.value is not None and bval is not None:
            newval = self.field.add(self.value, coeff) if bval else self.value
        else:
            newval = None
        return Num(self.field, newval, self._lc + bit.lc(one, coeff, self.field))

    def add(self, other: "Num") -> "Num":
        value = (
            self.field.add(self.value, other.value)
            if self.value is not None and other.value is not None
            else None
        )
        return Num(self.field, value, self._lc + other._lc)

    def scale(self, scalar: int) -> "Num":
        lc = LinearCombination.zero(self.field) + (scalar, self._lc)
        value = self.field.mul(self.value, scalar) if self.value is not None else None
        return Num(self.field, value, lc)
