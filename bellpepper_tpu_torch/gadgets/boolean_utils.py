"""Variadic boolean helpers: is-zero, or_v, and_v, and the or_/and_
combinators.

Re-design of reference crates/bellpepper/src/gadgets/boolean_utils.rs. The
reference's `or!`/`and!` are Rust macros whose namespaces derive from
stringify!(...); here they are variadic functions taking an optional label
(Python has no token stringification, so labels default to positional
names)."""

from __future__ import annotations

from typing import List

from ..constraint_system import ConstraintSystem
from .boolean import AllocatedBit, Boolean
from .num import Num


def alloc_num_is_zero(cs: ConstraintSystem, num: Num) -> Boolean:
    """3-constraint is-zero (boolean_utils.rs:52-98):
    result·x = 0 and (x + result)·q = 1 with q = x⁻¹ or 1."""
    field = cs.field
    num_value = num.get_value()
    x = num_value if num_value is not None else field.ZERO
    is_zero = (num_value == field.ZERO) if num_value is not None else None

    result = AllocatedBit.alloc(cs.namespace("x = 0"), is_zero)
    cs.record_witness_op("num_iszero", [result.get_variable()], [num])

    # result * x = 0: at least one of them is zero.
    cs.enforce(
        "result or x is 0",
        lambda lc: lc + result.get_variable(),
        lambda _lc: num.lc(field.ONE),
        lambda lc: lc,
    )

    def fq():
        inv = field.invert(x)
        return inv if inv is not None else field.ONE

    q = cs.alloc("q", fq)
    cs.record_witness_op("num_inv_or_one", [q], [num])

    # (x + result) * q = 1: x and result are not both zero.
    cs.enforce(
        "(x + result) * q = 1",
        lambda _lc: num.lc(field.ONE) + result.get_variable(),
        lambda lc: lc + q,
        lambda lc: lc + ConstraintSystem.one(),
    )
    # Together with booleanity: result == (x == 0).
    return Boolean.from_bit(result)


def or_v(cs: ConstraintSystem, v: List[Boolean]) -> Boolean:
    """Variadic OR (boolean_utils.rs:101-111)."""
    assert len(v) >= 4, (
        "with less than 4 elements, or_v is more expensive than repeated or"
    )
    return or_v_unchecked_for_optimization(cs, v)


def or_v_unchecked_for_optimization(cs: ConstraintSystem, v: List[Boolean]) -> Boolean:
    """OR = not(count_true == 0) (boolean_utils.rs:114-128)."""
    field = cs.field
    one = ConstraintSystem.one()
    count_true = Num.zero(field)
    for b in v:
        count_true = count_true.add_bool_with_coeff(one, b, field.ONE)
    nor = alloc_num_is_zero(cs.namespace("nor"), count_true)
    return nor.not_()


def and_v(cs: ConstraintSystem, v: List[Boolean]) -> Boolean:
    """AND = (count_false == 0) (boolean_utils.rs:131-150)."""
    assert len(v) >= 4, (
        "with less than 4 elements, and_v is more expensive than repeated and"
    )
    field = cs.field
    one = ConstraintSystem.one()
    count_false = Num.zero(field)
    for b in v:
        count_false = count_false.add_bool_with_coeff(one, b.not_(), field.ONE)
    return alloc_num_is_zero(cs.namespace("nor_of_nots"), count_false)


def or_(cs: ConstraintSystem, *bools: Boolean, label: str | None = None) -> Boolean:
    """Variadic OR combinator (the reference's `or!` macro,
    boolean_utils.rs:9-27): 2 operands → Boolean.or_; 3 → right-fold;
    ≥4 → or_v."""
    assert len(bools) >= 2
    if label is None:
        label = f"or({len(bools)})"
    if len(bools) == 2:
        return Boolean.or_(cs.namespace(label), bools[0], bools[1])
    if len(bools) == 3:
        ns = cs.namespace(label)
        tmp = or_(ns, *bools[1:], label="rest")
        return or_(ns, bools[0], tmp, label="fold")
    return or_v(cs.namespace(label), list(bools))


def and_(cs: ConstraintSystem, *bools: Boolean, label: str | None = None) -> Boolean:
    """Variadic AND combinator (the reference's `and!` macro,
    boolean_utils.rs:30-49)."""
    assert len(bools) >= 2
    if label is None:
        label = f"and({len(bools)})"
    if len(bools) == 2:
        return Boolean.and_(cs.namespace(label), bools[0], bools[1])
    if len(bools) == 3:
        ns = cs.namespace(label)
        tmp = and_(ns, *bools[1:], label="rest")
        return and_(ns, bools[0], tmp, label="fold")
    return and_v(cs.namespace(label), list(bools))
