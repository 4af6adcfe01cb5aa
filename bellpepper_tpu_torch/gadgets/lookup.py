"""Window-table lookup gadgets (for fixed-base EC scalar-mul windows).

Re-design of reference crates/bellpepper/src/gadgets/lookup.rs:
  - synth: Möbius/inclusion-exclusion transform of 2^w constants into
    multilinear coefficients (lookup.rs:11-28)
  - lookup3_xy: 3-bit window (x, y) lookup in 2 constraints + 1 precomp AND
  - lookup3_xy_with_conditional_negation: 2-bit lookup + sign bit; x comes
    back as a free Num, 1 constraint + precomp
"""

from __future__ import annotations

from typing import List, Tuple

from ..constraint_system import AssignmentMissingError, ConstraintSystem
from .boolean import Boolean
from .num import AllocatedNum, Num


def synth(field, window_size: int, constants: List[int], assignment: List[int]) -> None:
    """In-place multilinear coefficient synthesis (lookup.rs:11-28)."""
    assert len(assignment) == (1 << window_size)
    for i, constant in enumerate(constants):
        cur = field.sub(constant, assignment[i])
        assignment[i] = cur
        for j in range(i + 1, len(assignment)):
            if j & i == i:
                assignment[j] = field.add(assignment[j], cur)


def lookup3_xy(
    cs: ConstraintSystem, bits: List[Boolean], coords: List[Tuple[int, int]]
) -> Tuple[AllocatedNum, AllocatedNum]:
    """3-bit window table lookup returning (x, y) (lookup.rs:32-118)."""
    assert len(bits) == 3
    assert len(coords) == 8
    field = cs.field

    b0, b1, b2 = bits[0].get_value(), bits[1].get_value(), bits[2].get_value()
    if b0 is not None and b1 is not None and b2 is not None:
        i = int(b0) + 2 * int(b1) + 4 * int(b2)
    else:
        i = None

    def fx():
        if i is None:
            raise AssignmentMissingError()
        return coords[i][0]

    def fy():
        if i is None:
            raise AssignmentMissingError()
        return coords[i][1]

    res_x = AllocatedNum.alloc(cs.namespace("x"), fx)
    res_y = AllocatedNum.alloc(cs.namespace("y"), fy)
    cs.record_witness_op(
        "lookup",
        [res_x.get_variable()],
        (bits, [field.normalize(c[0]) for c in coords]),
    )
    cs.record_witness_op(
        "lookup",
        [res_y.get_variable()],
        (bits, [field.normalize(c[1]) for c in coords]),
    )

    x_coeffs = [field.ZERO] * 8
    y_coeffs = [field.ZERO] * 8
    synth(field, 3, [c[0] for c in coords], x_coeffs)
    synth(field, 3, [c[1] for c in coords], y_coeffs)

    precomp = Boolean.and_(cs.namespace("precomp"), bits[1], bits[2])
    one = ConstraintSystem.one()

    cs.enforce(
        "x-coordinate lookup",
        lambda lc: (
            lc
            + (x_coeffs[0b001], one)
            + bits[1].lc(one, x_coeffs[0b011], field)
            + bits[2].lc(one, x_coeffs[0b101], field)
            + precomp.lc(one, x_coeffs[0b111], field)
        ),
        lambda lc: lc + bits[0].lc(one, field.ONE, field),
        lambda lc: (
            (lc + res_x.get_variable())
            - (x_coeffs[0b000], one)
            - bits[1].lc(one, x_coeffs[0b010], field)
            - bits[2].lc(one, x_coeffs[0b100], field)
            - precomp.lc(one, x_coeffs[0b110], field)
        ),
    )

    cs.enforce(
        "y-coordinate lookup",
        lambda lc: (
            lc
            + (y_coeffs[0b001], one)
            + bits[1].lc(one, y_coeffs[0b011], field)
            + bits[2].lc(one, y_coeffs[0b101], field)
            + precomp.lc(one, y_coeffs[0b111], field)
        ),
        lambda lc: lc + bits[0].lc(one, field.ONE, field),
        lambda lc: (
            (lc + res_y.get_variable())
            - (y_coeffs[0b000], one)
            - bits[1].lc(one, y_coeffs[0b010], field)
            - bits[2].lc(one, y_coeffs[0b100], field)
            - precomp.lc(one, y_coeffs[0b110], field)
        ),
    )

    return res_x, res_y


def lookup3_xy_with_conditional_negation(
    cs: ConstraintSystem, bits: List[Boolean], coords: List[Tuple[int, int]]
) -> Tuple[Num, Num]:
    """2-bit lookup with a sign bit; x is a free Num (lookup.rs:122-187)."""
    assert len(bits) == 3
    assert len(coords) == 4
    field = cs.field
    one = ConstraintSystem.one()

    b0, b1 = bits[0].get_value(), bits[1].get_value()
    i = (int(b0) + 2 * int(b1)) if (b0 is not None and b1 is not None) else None

    def fy():
        if i is None:
            raise AssignmentMissingError()
        sign = bits[2].get_value()
        if sign is None:
            raise AssignmentMissingError()
        tmp = coords[i][1]
        return field.neg(tmp) if sign else tmp

    y = AllocatedNum.alloc(cs.namespace("y"), fy)
    # Device witness op: the sign bit becomes the top index bit of an
    # 8-entry table whose upper half holds the negated y values.
    cs.record_witness_op(
        "lookup",
        [y.get_variable()],
        (
            [bits[0], bits[1], bits[2]],
            [field.normalize(c[1]) for c in coords]
            + [field.neg(c[1]) for c in coords],
        ),
    )

    x_coeffs = [field.ZERO] * 4
    y_coeffs = [field.ZERO] * 4
    synth(field, 2, [c[0] for c in coords], x_coeffs)
    synth(field, 2, [c[1] for c in coords], y_coeffs)

    precomp = Boolean.and_(cs.namespace("precomp"), bits[0], bits[1])

    x = (
        Num.zero(field)
        .add_bool_with_coeff(one, Boolean.constant(True), x_coeffs[0b00])
        .add_bool_with_coeff(one, bits[0], x_coeffs[0b01])
        .add_bool_with_coeff(one, bits[1], x_coeffs[0b10])
        .add_bool_with_coeff(one, precomp, x_coeffs[0b11])
    )

    y_lc = (
        precomp.lc(one, y_coeffs[0b11], field)
        + bits[1].lc(one, y_coeffs[0b10], field)
        + bits[0].lc(one, y_coeffs[0b01], field)
        + (y_coeffs[0b00], one)
    )

    cs.enforce(
        "y-coordinate lookup",
        lambda lc: lc + y_lc + y_lc,
        lambda lc: lc + bits[2].lc(one, field.ONE, field),
        lambda lc: (lc + y_lc) - y.get_variable(),
    )

    y_num = Num.from_allocated_num(field, y)
    return x, y_num
