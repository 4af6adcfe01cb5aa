"""multipack — pack vectors of bits into scalar field elements.

Re-design of reference crates/bellpepper/src/gadgets/multipack.rs: bits are
chunked by Scalar::CAPACITY and each chunk packed as Σ 2^i·bit into one
public input (one packing constraint per chunk)."""

from __future__ import annotations

from typing import List

from ..constraint_system import AssignmentMissingError, ConstraintSystem
from ..fields import PrimeField
from .boolean import Boolean
from .num import AllocatedNum, Num


def pack_into_inputs(cs: ConstraintSystem, bits: List[Boolean]) -> None:
    """Expose bits as compact public inputs (multipack.rs:12-38)."""
    field = cs.field
    one = ConstraintSystem.one()
    cap = field.CAPACITY
    for i in range(0, len(bits), cap):
        chunk = bits[i : i + cap]
        num = Num.zero(field)
        coeff = field.ONE
        for bit in chunk:
            num = num.add_bool_with_coeff(one, bit, coeff)
            coeff = field.double(coeff)

        idx = i // cap

        def f(num=num):
            v = num.get_value()
            if v is None:
                raise AssignmentMissingError()
            return v

        input_var = cs.alloc_input(f"input {idx}", f)
        cs.record_witness_op("pack", [input_var], list(chunk))
        # num * 1 = input
        cs.enforce(
            f"packing constraint {idx}",
            lambda _lc, num=num: num.lc(field.ONE),
            lambda lc: lc + one,
            lambda lc, input_var=input_var: lc + input_var,
        )


def bytes_to_bits(data: bytes) -> List[bool]:
    """Big-endian bits per byte (multipack.rs:40-45)."""
    return [bool((b >> i) & 1) for b in data for i in range(7, -1, -1)]


def bytes_to_bits_le(data: bytes) -> List[bool]:
    """Little-endian bits per byte (multipack.rs:47-52)."""
    return [bool((b >> i) & 1) for b in data for i in range(8)]


def compute_multipacking(field: PrimeField, bits: List[bool]) -> List[int]:
    """Out-of-circuit packing mirror (multipack.rs:54-73)."""
    result = []
    cap = field.CAPACITY
    for i in range(0, len(bits), cap):
        cur = field.ZERO
        coeff = field.ONE
        for bit in bits[i : i + cap]:
            if bit:
                cur = field.add(cur, coeff)
            coeff = field.double(coeff)
        result.append(cur)
    return result


def pack_bits(cs: ConstraintSystem, bits: List[Boolean]) -> AllocatedNum:
    """Pack up to CAPACITY bits into a single AllocatedNum
    (multipack.rs:76-105)."""
    field = cs.field
    one = ConstraintSystem.one()
    num = Num.zero(field)
    coeff = field.ONE
    for bit in bits[: field.CAPACITY]:
        num = num.add_bool_with_coeff(one, bit, coeff)
        coeff = field.double(coeff)

    def f():
        v = num.get_value()
        if v is None:
            raise AssignmentMissingError()
        return v

    alloc_num = AllocatedNum.alloc(cs.namespace("input"), f)
    cs.record_witness_op(
        "pack", [alloc_num.get_variable()], list(bits[: field.CAPACITY])
    )
    cs.enforce(
        "packing constraint",
        lambda _lc: num.lc(field.ONE),
        lambda lc: lc + one,
        lambda lc: lc + alloc_num.get_variable(),
    )
    return alloc_num
