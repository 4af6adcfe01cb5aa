"""NativeBuilder's num family in the port against the JAX package's:
num_to_bits_le_strict, num_conditionally_reverse, num_is_zero, lookup3_xy
and lookup3_xy_with_conditional_negation give the same R1CS arrays and
decoded tape, and the port's Evaluator gives the same witness (values and
limbs) as the JAX evaluator on the same free inputs, exactly (tolerance
0). Then the one place where the port departs from the reference on
purpose: an is-zero of a field value wider than 32 bits is evaluated in
the field, where the reference reads the value's low 32 bits."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellpepper_tpu.compile.witness_program import WitnessProgram as RefProgram
from bellpepper_tpu.native import NativeBuilder as RefBuilder
from bellpepper_tpu_torch import SCALAR, NativeBuilder, WitnessProgram, build_production_step
from bellpepper_tpu_torch.backend.field_backend import FieldBackend
from bellpepper_tpu_torch.compile.tape import Op

RND = random.Random(0x5EED_000A)
P = SCALAR.p
COORDS8 = [(RND.randrange(P), RND.randrange(P)) for _ in range(8)]
COORDS4 = [(RND.randrange(P), RND.randrange(P)) for _ in range(4)]
WIDE = [RND.randrange(P) for _ in range(3)] + [0, P - 1]


def _strict(nb):
    nb.num_to_bits_le_strict(nb.alloc_num())


def _reverse(nb):
    cond = nb.alloc_bit()
    sa, sb = nb.alloc_num(), nb.alloc_num()
    nb.num_conditionally_reverse(sa, sb, cond)


def _is_zero(nb):
    nb.num_is_zero(nb.alloc_num())


def _lookup(nb):
    nb.lookup3_xy([nb.alloc_bit() for _ in range(3)], COORDS8)


def _lookup_cn(nb):
    nb.lookup3_xy_with_conditional_negation([nb.alloc_bit() for _ in range(3)], COORDS4)


# each circuit with its free inputs: (free bits or u32 values in free-slot
# order, skipping free field slots; one list of free field values a field
# slot), one column an instance
CASES = {
    "num_to_bits_le_strict": (_strict, [], [WIDE]),
    "num_conditionally_reverse": (_reverse, [[0, 1, 1, 0]], [WIDE[:4], WIDE[1:]]),
    "num_is_zero": (_is_zero, [[0, 5, 1, 0xFFFFFFFF]], []),
    "lookup3_xy": (_lookup, [[(i >> k) & 1 for i in range(8)] for k in range(3)], []),
    "lookup3_xy_with_conditional_negation": (_lookup_cn, [[(i >> k) & 1 for i in range(8)] for k in range(3)],
                                             []),
}


def _build(builder_cls, circuit):
    nb = builder_cls()
    circuit(nb)
    return nb.finish()


def _free_inputs(prog, bit_cols, field_cols):
    """free_bits uint32[B, n_free] (0 in the free field slots) and
    free_field limbs uint32[B, max(nf, 1), 16]."""
    B = len((bit_cols or field_cols)[0])
    ff_set = set(prog.free_field_slots)
    fb = np.zeros((B, len(prog.free_slots)), np.uint32)
    cols = iter(bit_cols)
    for i, s in enumerate(prog.free_slots):
        if s not in ff_set:
            fb[:, i] = next(cols)
    ffl = np.zeros((B, max(len(field_cols), 1), 16), np.uint32)
    for j, col in enumerate(field_cols):
        ffl[:, j] = FieldBackend.to_limbs(col)
    return fb, ffl


@pytest.mark.parametrize("name", list(CASES))
def test_num_gadget_template_and_tape_match_reference(name):
    circuit = CASES[name][0]
    t, tape = _build(NativeBuilder, circuit)
    t_ref, tape_ref = _build(RefBuilder, circuit)
    assert (t.num_inputs, t.num_aux, t.num_constraints) == (t_ref.num_inputs, t_ref.num_aux, t_ref.num_constraints)
    assert t.coeff_table == t_ref.coeff_table
    for m in "abc":
        for f in ("rows", "cols", "coeff_ids"):
            assert np.array_equal(np.asarray(getattr(getattr(t, m), f)), np.asarray(getattr(getattr(t_ref, m), f)))
    ni, na, ops, free = tape.snapshot()
    assert (ni, na, free) == tape_ref.snapshot()[:2] + (tape_ref.snapshot()[3],)
    assert [(o.opcode, o.outs, o.args) for o in ops] == [(o.opcode, o.outs, o.args) for o in tape_ref.snapshot()[2]]


def test_num_gadget_views_match_reference():
    """The views and slotcodes the bindings return."""
    def returned(cls):
        nb = cls()
        s = nb.alloc_num()
        cond = nb.alloc_bit()
        return (list(map(int, nb.num_to_bits_le_strict(s))), nb.num_conditionally_reverse(s, nb.alloc_num(), cond),
                int(nb.num_is_zero(s)), nb.lookup3_xy([cond] * 3, COORDS8),
                nb.lookup3_xy_with_conditional_negation([cond] * 3, COORDS4))

    port = returned(NativeBuilder)
    assert port == returned(RefBuilder) and len(port[0]) == SCALAR.NUM_BITS


@pytest.mark.parametrize("name", list(CASES))
def test_num_gadget_witness_matches_reference(name):
    circuit, bit_cols, field_cols = CASES[name]
    _t, tape = _build(NativeBuilder, circuit)
    prog, ref_prog = WitnessProgram(tape), RefProgram(tape)
    fb, ffl = _free_inputs(prog, bit_cols, field_cols)
    want_vals, want_fl = ref_prog.build(False)(jnp.asarray(fb), jnp.asarray(ffl))
    free_field = torch.from_numpy(ffl.view(np.int32)) if prog.free_field_slots else None
    vals, fl = prog.build(device="cpu")(torch.from_numpy(fb.view(np.int32)), free_field)
    assert np.array_equal(vals.numpy().view(np.uint32), np.asarray(want_vals))
    assert np.array_equal(fl.numpy().view(np.uint32), np.asarray(want_fl))


def test_is_zero_of_a_wide_field_value():
    """num_is_zero of a 40-bit pack output: the port's witness holds
    (is-zero bit, inverse or one) of the field value and the mixed step's
    verdict is clean; where the value is below 2^32 it equals the
    reference's witness, which is computed from the low 32 bits."""
    nb = NativeBuilder()
    bits = [nb.alloc_bit() for _ in range(40)]
    packed = nb.pack_bits(bits)
    out = nb.num_is_zero(packed)
    template, tape = nb.finish()
    prog = WitnessProgram(tape)
    values = [0, 1, 12345, (1 << 40) - 1, 1 << 32, 0xABCDE12345]
    fb = np.asarray([[(v >> k) & 1 for k in range(40)] for v in values], np.uint32)
    free = torch.from_numpy(fb.view(np.int32))
    vals, fl = prog.build(device="cpu")(free)
    out_slot = nb.view(out)[1]
    inv_row = prog.field_rows[next(op.outs[0] for op in tape.snapshot()[2] if op.opcode == "num_inv_or_one")]
    for i, v in enumerate(values):
        assert int(vals[i, out_slot]) == (v == 0)
        assert FieldBackend.from_limbs(fl[i, inv_row])[0] == (pow(v, P - 2, P) if v else 1)
    total, first = build_production_step(prog, template, len(values), device="cpu")(free[None])
    assert (int(total), int(first)) == (0, 0xFFFFFFFF)
    ref_vals, ref_fl = RefProgram(tape).build(False)(jnp.asarray(fb), jnp.asarray(np.zeros((6, 1, 16), np.uint32)))
    narrow = [i for i, v in enumerate(values) if v < 1 << 32]
    assert np.array_equal(vals.numpy().view(np.uint32)[narrow], np.asarray(ref_vals)[narrow])
    assert np.array_equal(fl.numpy().view(np.uint32)[narrow], np.asarray(ref_fl)[narrow])


class _RetapedLC:
    """A tape whose is-zero stages read the small LC ``lc`` in place of
    the builder's one-term LC (NativeBuilder only records the latter)."""

    def __init__(self, tape, lc):
        self.field = tape.field
        ni, na, ops, free = tape.snapshot()
        ops = [Op(o.opcode, o.outs, lc) if o.opcode in ("num_iszero", "num_inv_or_one") else o for o in ops]
        self._snapshot = (ni, na, ops, free)

    def snapshot(self):
        return self._snapshot


def test_is_zero_of_a_free_field_num_and_a_scaled_bit():
    """An is-zero LC x + 3·b of a free field num x (a free field input,
    since it is also decomposed) and a bit b: the is-zero bit and the
    inverse (or one) are those of the sum mod p, held exactly against
    Python ints at 0, small sums, sums at and above 2^32 (where a uint32
    sum wraps) and p − 1, and at x + 3 = p (zero only mod p)."""
    nb = NativeBuilder()
    x = nb.alloc_num()
    nb.num_to_bits_le_strict(x)
    b = nb.alloc_bit()
    out = nb.num_is_zero(x)
    _t, tape = nb.finish()
    prog = WitnessProgram(_RetapedLC(tape, [(1, nb._slot(x)), (3, nb.view(b)[1])]))
    assert prog.free_field_slots == [nb._slot(x)]
    xs = [0, 0, 5, 5, (1 << 32) - 3, (1 << 32) + 7, P - 1, P - 3, P - 4]
    bs = [0, 1, 0, 1, 1, 0, 0, 1, 1]
    fb, ffl = _free_inputs(prog, [bs], [xs])
    vals, fl = prog.build(device="cpu")(torch.from_numpy(fb.view(np.int32)), torch.from_numpy(ffl.view(np.int32)))
    inv_row = prog.field_rows[next(op.outs[0] for op in tape.snapshot()[2] if op.opcode == "num_inv_or_one")]
    for i, (xv, bv) in enumerate(zip(xs, bs)):
        s = (xv + 3 * bv) % P
        assert int(vals[i, nb.view(out)[1]]) == (s == 0)
        assert FieldBackend.from_limbs(fl[i, inv_row])[0] == (pow(s, P - 2, P) if s else 1)
