"""Boolean gadgets: AllocatedBit, the 3-state Boolean, and bit decompositions.

Re-design of reference crates/bellpepper-core/src/gadgets/boolean.rs.
Constraint formulas are preserved exactly (they determine the pinned
constraint counts and shape hashes):

  alloc                (1 - a) * a = 0                     boolean.rs:68-97
  alloc_conditionally  (1 - must_be_false - a) * a = 0     boolean.rs:27-64
  xor                  (2a) * b = a + b - c                boolean.rs:101-151
  and                  a * b = c                           boolean.rs:155-192
  and_not              a * (1 - b) = c                     boolean.rs:195-232
  nor                  (1 - a) * (1 - b) = c               boolean.rs:235-272
  sha256_ch            (b - c) * a = ch - c                boolean.rs:536-641
  sha256_maj           b*c = bc; (2bc - b - c)*a = bc-maj  boolean.rs:644-759

`Boolean` negation is free (Is↔Not flip) and constant folding mirrors the
reference's rewrite rules, so gadget structure (and therefore the constraint
counts of sha256/blake2s) matches bit-for-bit."""

from __future__ import annotations

from typing import List, Optional

from ..constraint_system import (
    AssignmentMissingError,
    ConstraintSystem,
    UnsatisfiableError,
)
from ..lc import LinearCombination, Variable


def _bit_value(value: Optional[bool], field):
    """Lazy closure for a bit's field value."""

    def f():
        if value is None:
            raise AssignmentMissingError()
        return field.ONE if value else field.ZERO

    return f


class AllocatedBit:
    """A variable constrained to be 0 or 1 (boolean.rs:9-13)."""

    __slots__ = ("variable", "value")

    def __init__(self, variable: Variable, value: Optional[bool]):
        self.variable = variable
        self.value = value

    def get_value(self) -> Optional[bool]:
        return self.value

    def get_variable(self) -> Variable:
        return self.variable

    @staticmethod
    def alloc(cs: ConstraintSystem, value: Optional[bool]) -> "AllocatedBit":
        field = cs.field
        var = cs.alloc("boolean", _bit_value(value, field))
        # (1 - a) * a = 0
        cs.enforce(
            "boolean constraint",
            lambda lc: lc + ConstraintSystem.one() - var,
            lambda lc: lc + var,
            lambda lc: lc,
        )
        return AllocatedBit(var, value)

    @staticmethod
    def alloc_conditionally(
        cs: ConstraintSystem, value: Optional[bool], must_be_false: "AllocatedBit"
    ) -> "AllocatedBit":
        """Boolean-constrained, and forced to 0 when `must_be_false` is 1
        (boolean.rs:27-64): (1 - must_be_false - a) * a = 0."""
        field = cs.field
        var = cs.alloc("boolean", _bit_value(value, field))
        cs.enforce(
            "boolean constraint",
            lambda lc: lc + ConstraintSystem.one() - must_be_false.variable - var,
            lambda lc: lc + var,
            lambda lc: lc,
        )
        return AllocatedBit(var, value)

    @staticmethod
    def xor(cs: ConstraintSystem, a: "AllocatedBit", b: "AllocatedBit") -> "AllocatedBit":
        field = cs.field

        def f():
            if a.value is None or b.value is None:
                raise AssignmentMissingError()
            return field.ONE if (a.value ^ b.value) else field.ZERO

        result_var = cs.alloc("xor result", f)
        result_value = None if (a.value is None or b.value is None) else (a.value ^ b.value)
        # (a + a) * b = a + b - c
        cs.enforce(
            "xor constraint",
            lambda lc: lc + a.variable + a.variable,
            lambda lc: lc + b.variable,
            lambda lc: lc + a.variable + b.variable - result_var,
        )
        cs.record_witness_op("xor", [result_var], [a.variable, b.variable])
        return AllocatedBit(result_var, result_value)

    @staticmethod
    def and_(cs: ConstraintSystem, a: "AllocatedBit", b: "AllocatedBit") -> "AllocatedBit":
        field = cs.field

        def f():
            if a.value is None or b.value is None:
                raise AssignmentMissingError()
            return field.ONE if (a.value & b.value) else field.ZERO

        result_var = cs.alloc("and result", f)
        result_value = None if (a.value is None or b.value is None) else (a.value & b.value)
        # a * b = c
        cs.enforce(
            "and constraint",
            lambda lc: lc + a.variable,
            lambda lc: lc + b.variable,
            lambda lc: lc + result_var,
        )
        cs.record_witness_op("and", [result_var], [a.variable, b.variable])
        return AllocatedBit(result_var, result_value)

    @staticmethod
    def and_not(cs: ConstraintSystem, a: "AllocatedBit", b: "AllocatedBit") -> "AllocatedBit":
        field = cs.field

        def f():
            if a.value is None or b.value is None:
                raise AssignmentMissingError()
            return field.ONE if (a.value and not b.value) else field.ZERO

        result_var = cs.alloc("and not result", f)
        result_value = (
            None if (a.value is None or b.value is None) else (a.value and not b.value)
        )
        # a * (1 - b) = c
        cs.enforce(
            "and not constraint",
            lambda lc: lc + a.variable,
            lambda lc: lc + ConstraintSystem.one() - b.variable,
            lambda lc: lc + result_var,
        )
        cs.record_witness_op("and_not", [result_var], [a.variable, b.variable])
        return AllocatedBit(result_var, result_value)

    @staticmethod
    def nor(cs: ConstraintSystem, a: "AllocatedBit", b: "AllocatedBit") -> "AllocatedBit":
        field = cs.field

        def f():
            if a.value is None or b.value is None:
                raise AssignmentMissingError()
            return field.ONE if (not a.value and not b.value) else field.ZERO

        result_var = cs.alloc("nor result", f)
        result_value = (
            None if (a.value is None or b.value is None) else (not a.value and not b.value)
        )
        # (1 - a) * (1 - b) = c
        cs.enforce(
            "nor constraint",
            lambda lc: lc + ConstraintSystem.one() - a.variable,
            lambda lc: lc + ConstraintSystem.one() - b.variable,
            lambda lc: lc + result_var,
        )
        cs.record_witness_op("nor", [result_var], [a.variable, b.variable])
        return AllocatedBit(result_var, result_value)


# Rust-name alias: AllocatedBit::and
AllocatedBit.and_bit = AllocatedBit.and_


def u64_into_boolean_vec_le(
    cs: ConstraintSystem, value: Optional[int]
) -> List["Boolean"]:
    """Allocate 64 LE bits of a u64 (boolean.rs:275-304)."""
    if value is not None:
        values = [bool((value >> i) & 1) for i in range(64)]
    else:
        values = [None] * 64
    return [
        Boolean.from_bit(AllocatedBit.alloc(cs.namespace(f"bit {i}"), b))
        for i, b in enumerate(values)
    ]


def field_into_allocated_bits_le(
    cs: ConstraintSystem, value: Optional[int]
) -> List[AllocatedBit]:
    """Allocate exactly NUM_BITS little-endian bits of a field element
    (boolean.rs:320-364). The reference skips the leading zero bits of the
    field characteristic; since values are canonical (< p < 2^NUM_BITS)
    this equals a plain NUM_BITS LE decomposition."""
    field = cs.field
    n = field.NUM_BITS
    if value is not None:
        assert 0 <= value < (1 << n)
        values = [bool((value >> i) & 1) for i in range(n)]
    else:
        values = [None] * n
    return [
        AllocatedBit.alloc(cs.namespace(f"bit {i}"), b) for i, b in enumerate(values)
    ]


def field_into_boolean_vec_le(cs: ConstraintSystem, value: Optional[int]) -> List["Boolean"]:
    return [Boolean.from_bit(b) for b in field_into_allocated_bits_le(cs, value)]


class Boolean:
    """Constant | Is(bit) | Not(bit) — negation is free (boolean.rs:366-469)."""

    __slots__ = ("kind", "bit", "const_value")

    IS = 0
    NOT = 1
    CONST = 2

    def __init__(self, kind: int, bit: Optional[AllocatedBit] = None, const_value: Optional[bool] = None):
        self.kind = kind
        self.bit = bit
        self.const_value = const_value

    # -- constructors ---------------------------------------------------------
    @staticmethod
    def from_bit(bit: AllocatedBit) -> "Boolean":
        return Boolean(Boolean.IS, bit=bit)

    @staticmethod
    def constant(b: bool) -> "Boolean":
        return Boolean(Boolean.CONST, const_value=bool(b))

    def is_constant(self) -> bool:
        return self.kind == Boolean.CONST

    def get_value(self) -> Optional[bool]:
        if self.kind == Boolean.CONST:
            return self.const_value
        v = self.bit.get_value()
        if v is None:
            return None
        return v if self.kind == Boolean.IS else (not v)

    def not_(self) -> "Boolean":
        """Free negation (boolean.rs:463-469)."""
        if self.kind == Boolean.CONST:
            return Boolean.constant(not self.const_value)
        return Boolean(Boolean.NOT if self.kind == Boolean.IS else Boolean.IS, bit=self.bit)

    def lc(self, one: Variable, coeff: int, field) -> LinearCombination:
        """Project to an LC (boolean.rs:437-455): Constant→coeff·one or 0,
        Is→coeff·v, Not→coeff·one − coeff·v."""
        if self.kind == Boolean.CONST:
            if self.const_value:
                return LinearCombination.zero(field) + (coeff, one)
            return LinearCombination.zero(field)
        if self.kind == Boolean.IS:
            return LinearCombination.zero(field) + (coeff, self.bit.get_variable())
        return LinearCombination.zero(field) + (coeff, one) - (coeff, self.bit.get_variable())

    # -- relations --------------------------------------------------------------
    @staticmethod
    def enforce_equal(cs: ConstraintSystem, a: "Boolean", b: "Boolean") -> None:
        """4-way constant-folded equality (boolean.rs:383-427)."""
        field = cs.field
        one = ConstraintSystem.one()
        if a.is_constant() and b.is_constant():
            if a.const_value != b.const_value:
                raise UnsatisfiableError()
            return
        if (a.is_constant() and a.const_value) or (b.is_constant() and b.const_value):
            x = b if a.is_constant() else a
            cs.enforce(
                "enforce equal to one",
                lambda lc: lc,
                lambda lc: lc,
                lambda lc: (lc + one) - x.lc(one, field.ONE, field),
            )
            return
        if (a.is_constant() and not a.const_value) or (b.is_constant() and not b.const_value):
            x = b if a.is_constant() else a
            cs.enforce(
                "enforce equal to zero",
                lambda lc: lc,
                lambda lc: lc,
                lambda _lc: x.lc(one, field.ONE, field),
            )
            return
        cs.enforce(
            "enforce equal",
            lambda lc: lc,
            lambda lc: lc,
            lambda _lc: a.lc(one, field.ONE, field) - b.lc(one, field.ONE, field),
        )

    # -- logic ops ----------------------------------------------------------------
    @staticmethod
    def xor(cs: ConstraintSystem, a: "Boolean", b: "Boolean") -> "Boolean":
        """Constant/negation rewrite rules then AllocatedBit::xor
        (boolean.rs:472-491)."""
        if a.is_constant() and not a.const_value:
            return b.clone()
        if b.is_constant() and not b.const_value:
            return a.clone()
        if a.is_constant() and a.const_value:
            return b.not_()
        if b.is_constant() and b.const_value:
            return a.not_()
        if a.kind != b.kind:
            # Is xor Not = not(Is xor Is); the Is operand goes first, like
            # the reference's `xor(cs, is, &not.not())` (boolean.rs:481-484),
            # because the XOR constraint (2a)*b = a+b-c is asymmetric.
            if a.kind == Boolean.IS:
                return Boolean.xor(cs, a, b.not_()).not_()
            return Boolean.xor(cs, b, a.not_()).not_()
        # Is/Is or Not/Not: a xor b == (not a) xor (not b)
        return Boolean.from_bit(AllocatedBit.xor(cs, a.bit, b.bit))

    @staticmethod
    def and_(cs: ConstraintSystem, a: "Boolean", b: "Boolean") -> "Boolean":
        """Dispatch to and/and_not/nor (boolean.rs:494-516)."""
        if (a.is_constant() and not a.const_value) or (b.is_constant() and not b.const_value):
            return Boolean.constant(False)
        if a.is_constant() and a.const_value:
            return b.clone()
        if b.is_constant() and b.const_value:
            return a.clone()
        if a.kind == Boolean.IS and b.kind == Boolean.NOT:
            return Boolean.from_bit(AllocatedBit.and_not(cs, a.bit, b.bit))
        if a.kind == Boolean.NOT and b.kind == Boolean.IS:
            return Boolean.from_bit(AllocatedBit.and_not(cs, b.bit, a.bit))
        if a.kind == Boolean.NOT and b.kind == Boolean.NOT:
            return Boolean.from_bit(AllocatedBit.nor(cs, a.bit, b.bit))
        return Boolean.from_bit(AllocatedBit.and_(cs, a.bit, b.bit))

    @staticmethod
    def or_(cs: ConstraintSystem, a: "Boolean", b: "Boolean") -> "Boolean":
        """a ∨ b = ¬(¬a ∧ ¬b) (boolean.rs:519-533)."""
        return Boolean.and_(
            cs.namespace("not and (not a) (not b)"), a.not_(), b.not_()
        ).not_()

    @staticmethod
    def sha256_ch(cs: ConstraintSystem, a: "Boolean", b: "Boolean", c: "Boolean") -> "Boolean":
        """(a ∧ b) ⊕ (¬a ∧ c) in one constraint, with the reference's six
        constant-operand special cases (boolean.rs:536-641)."""
        field = cs.field
        one = ConstraintSystem.one()
        av, bv, cv = a.get_value(), b.get_value(), c.get_value()
        ch_value = None
        if av is not None and bv is not None and cv is not None:
            ch_value = (av and bv) ^ ((not av) and cv)

        if a.is_constant() and b.is_constant() and c.is_constant():
            return Boolean.constant(ch_value)
        if a.is_constant() and not a.const_value:
            return c.clone()
        if b.is_constant() and not b.const_value:
            return Boolean.and_(cs, a.not_(), c)
        if c.is_constant() and not c.const_value:
            return Boolean.and_(cs, a, b)
        if c.is_constant() and c.const_value:
            return Boolean.and_(cs, a, b.not_()).not_()
        if b.is_constant() and b.const_value:
            return Boolean.and_(cs, a.not_(), c.not_()).not_()
        # a == Constant(true) falls through, like the reference.

        def f():
            if ch_value is None:
                raise AssignmentMissingError()
            return field.ONE if ch_value else field.ZERO

        ch = cs.alloc("ch", f)
        # (b - c) * a = ch - c
        cs.enforce(
            "ch computation",
            lambda _lc: b.lc(one, field.ONE, field) - c.lc(one, field.ONE, field),
            lambda _lc: a.lc(one, field.ONE, field),
            lambda lc: (lc + ch) - c.lc(one, field.ONE, field),
        )
        cs.record_witness_op("ch", [ch], [a, b, c])
        return Boolean.from_bit(AllocatedBit(ch, ch_value))

    @staticmethod
    def sha256_maj(cs: ConstraintSystem, a: "Boolean", b: "Boolean", c: "Boolean") -> "Boolean":
        """(a∧b) ⊕ (a∧c) ⊕ (b∧c) in two constraints (boolean.rs:644-759)."""
        field = cs.field
        one = ConstraintSystem.one()
        av, bv, cv = a.get_value(), b.get_value(), c.get_value()
        maj_value = None
        if av is not None and bv is not None and cv is not None:
            maj_value = (av and bv) ^ (av and cv) ^ (bv and cv)

        if a.is_constant() and b.is_constant() and c.is_constant():
            return Boolean.constant(maj_value)
        if a.is_constant() and not a.const_value:
            return Boolean.and_(cs, b, c)
        if b.is_constant() and not b.const_value:
            return Boolean.and_(cs, a, c)
        if c.is_constant() and not c.const_value:
            return Boolean.and_(cs, a, b)
        if c.is_constant() and c.const_value:
            return Boolean.and_(cs, a.not_(), b.not_()).not_()
        if b.is_constant() and b.const_value:
            return Boolean.and_(cs, a.not_(), c.not_()).not_()
        if a.is_constant() and a.const_value:
            return Boolean.and_(cs, b.not_(), c.not_()).not_()

        def f():
            if maj_value is None:
                raise AssignmentMissingError()
            return field.ONE if maj_value else field.ZERO

        maj = cs.alloc("maj", f)
        bc = Boolean.and_(cs.namespace("b and c"), b, c)
        # (2bc - b - c) * a = bc - maj
        cs.enforce(
            "maj computation",
            lambda _lc: (
                bc.lc(one, field.ONE, field)
                + bc.lc(one, field.ONE, field)
                - b.lc(one, field.ONE, field)
                - c.lc(one, field.ONE, field)
            ),
            lambda _lc: a.lc(one, field.ONE, field),
            lambda _lc: bc.lc(one, field.ONE, field) - maj,
        )
        cs.record_witness_op("maj", [maj], [a, b, c])
        return Boolean.from_bit(AllocatedBit(maj, maj_value))

    # -- misc -----------------------------------------------------------------
    def clone(self) -> "Boolean":
        if self.kind == Boolean.CONST:
            return Boolean.constant(self.const_value)
        return Boolean(self.kind, bit=self.bit)

    def __repr__(self) -> str:  # pragma: no cover
        if self.kind == Boolean.CONST:
            return f"Boolean.Constant({self.const_value})"
        tag = "Is" if self.kind == Boolean.IS else "Not"
        return f"Boolean.{tag}({self.bit.get_value()})"
