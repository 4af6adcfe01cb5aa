"""The reference-compatible routes of the port against the JAX package:
``Satisfier(r1cs, use_pallas=False)`` (the DeviceR1CS route: per-entry
``mul``, digit row sums, ``reduce_digits``) on small circuits against the
reference's ``Satisfier(r)``, which takes its jnp route on the CPU — the
same ``is_satisfied`` and the same ``which_is_unsatisfied`` after one
fault in each row class of the templated limbs route (booleanity rows,
rows of at most two ±1 terms, and the rows of other coefficients); both
of the port's routes agree. ``WitnessProgram.run`` against the
reference's ``run`` (given free field inputs and with none), and
``FieldBackend.mul_pow2`` against Python ints at the corner values. All on
the CPU, at a few dozen rows."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellpepper_tpu.backend.matvec import Satisfier as RefSatisfier
from bellpepper_tpu.compile.witness_program import WitnessProgram as RefProgram
from bellpepper_tpu.native import NativeBuilder as RefBuilder
from bellpepper_tpu_torch import FIELDS, NativeBuilder, R1CS, Satisfier, WitnessProgram
from bellpepper_tpu_torch.backend import field_kernels as fk
from bellpepper_tpu_torch.backend.field_backend import get_backend
from bellpepper_tpu_torch.backend.layout import _classify_trivial_limb_rows
from bellpepper_tpu_torch.backend.words import from_numpy_u32, to_numpy_u32

RNG = np.random.default_rng(0x5EED_0014)


def _circuit(root):
    """Bits packed into a number (a row of 2^i coefficients), products,
    sums and squares (rows of ±1 terms), in either package's frontend."""
    pkg = importlib.import_module(root)
    boolean = importlib.import_module(f"{root}.gadgets.boolean")
    multipack = importlib.import_module(f"{root}.gadgets.multipack")
    num = importlib.import_module(f"{root}.gadgets.num")
    vals = np.random.default_rng(7).integers(0, 2, 12).tolist()
    cs = pkg.TestConstraintSystem()
    bits = [boolean.Boolean.from_bit(boolean.AllocatedBit.alloc(cs.namespace(f"bit {i}"), bool(v)))
            for i, v in enumerate(vals)]
    packed = multipack.pack_bits(cs.namespace("pack"), bits)
    a = num.AllocatedNum.alloc(cs.namespace("a"), 0x1234567)
    x = a
    for i in range(3):
        x = x.mul(cs.namespace(f"mul {i}"), packed).add(cs.namespace(f"add {i}"), a).square(cs.namespace(f"sq {i}"))
    x.inputize(cs.namespace("out"))
    return cs


def _row_classes(r1cs):
    bit_rows, triv_rows, fold_idx = _classify_trivial_limb_rows(r1cs)
    cls = {r: "bit" for r, _c in bit_rows}
    cls.update({t[0]: "trivial" for t in triv_rows})
    cls.update({int(r): "fold" for r in fold_idx})
    return cls


def _first_rows(r1cs):
    """column → the least row that reads it."""
    first = {}
    for name in ("a", "b", "c"):
        m = getattr(r1cs, name)
        for row, col in zip(np.asarray(m.rows).tolist(), np.asarray(m.cols).tolist()):
            first[col] = min(first.get(col, row), row)
    return first


def test_device_r1cs_route_matches_reference():
    cs, rcs = _circuit("bellpepper_tpu_torch"), _circuit("bellpepper_tpu")
    r1cs = R1CS.from_test_cs(cs)
    ref_r1cs = importlib.import_module("bellpepper_tpu.r1cs").R1CS.from_test_cs(rcs)
    sat, templ = Satisfier(r1cs, False, device="cpu"), Satisfier(r1cs, device="cpu")
    ref = RefSatisfier(ref_r1cs)
    assert (sat.route, templ.route, ref.use_pallas) == ("device_r1cs", "templated", False)
    inputs, aux = cs.scalar_inputs(), cs.scalar_aux()
    assert (inputs, aux) == (rcs.scalar_inputs(), rcs.scalar_aux())

    def verdicts(ins, ax):
        z, rz = sat.z_from_assignments(ins, ax), ref.z_from_assignments(ins, ax)
        assert (to_numpy_u32(z) == np.asarray(rz)).all()
        got = (sat.is_satisfied(z), sat.which_is_unsatisfied(z))
        assert got == (templ.is_satisfied(z), templ.which_is_unsatisfied(z))
        assert got == (ref.is_satisfied(rz), ref.which_is_unsatisfied(rz))
        return got

    fk.reset_launch_counts()
    assert verdicts(inputs, aux) == (True, None)
    # on the CPU the wrappers count nothing: the route is the plain versions
    assert all(v == 0 for v in fk.launch_counts().values())

    classes, first = _row_classes(r1cs), _first_rows(r1cs)
    n_in = r1cs.num_inputs
    faulted = {}
    for col in sorted(first):
        if col == 0 or classes[first[col]] in faulted:
            continue
        ins, ax = list(inputs), list(aux)
        vals = ins if col < n_in else ax
        i = col if col < n_in else col - n_in
        vals[i] = (vals[i] + 2) % r1cs.field.p
        ok, row = r1cs.eval_host(ins, ax)
        assert not ok
        assert verdicts(ins, ax) == (False, r1cs.names[row])
        faulted[classes[row]] = r1cs.names[row]
    assert set(faulted) == {"bit", "trivial", "fold"}, faulted


def test_device_r1cs_route_edges():
    """No constraints: vacuously satisfied on both routes; a z of the
    wrong shape is refused."""
    cs = importlib.import_module("bellpepper_tpu_torch").TestConstraintSystem()
    cs.alloc(lambda: "x", lambda: 5)
    r0 = R1CS.from_test_cs(cs)
    for up in (False, None):
        sat = Satisfier(r0, up, device="cpu")
        z = sat.z_from_assignments(cs.scalar_inputs(), cs.scalar_aux())
        assert sat.is_satisfied(z) and sat.which_is_unsatisfied(z) is None
    sat = Satisfier(R1CS.from_test_cs(_circuit("bellpepper_tpu_torch")), False, device="cpu")
    with pytest.raises(ValueError, match="z must be"):
        sat.is_satisfied(torch.zeros((3, 16), dtype=torch.int32))


def _free_field_program(builder_cls):
    """x·pack(bits) + y, squared, with free field inputs x and y."""
    nb = builder_cls()
    x, y = nb.alloc_num(), nb.alloc_num()
    a = nb.pack_bits(nb.alloc_u32())
    nb.num_square(nb.num_add(nb.num_mul(x, a), y))
    return nb.finish()[1]


def test_witness_program_run_matches_reference():
    prog, ref = WitnessProgram(_free_field_program(NativeBuilder)), RefProgram(_free_field_program(RefBuilder))
    B = 8
    bits = RNG.integers(0, 2, size=(B, len(prog.free_slots))).astype(np.uint32)
    p = prog.field.p
    ff = np.asarray([[[(v >> (16 * k)) & 0xFFFF for k in range(16)]
                      for v in (int.from_bytes(RNG.bytes(32), "little") % p for _ in prog.free_field_slots)]
                     for _ in range(B)], np.uint32)
    for free_field in (ff, None):
        vals, flimbs = prog.run(bits, free_field, device="cpu")
        rvals, rflimbs = ref.run(bits, None if free_field is None else jnp.asarray(free_field))
        np.testing.assert_array_equal(to_numpy_u32(vals), np.asarray(rvals))
        np.testing.assert_array_equal(to_numpy_u32(flimbs), np.asarray(rflimbs))
    assert list(prog._evals) == [torch.device("cpu")]  # built once, kept
    again, _ = prog.run(from_numpy_u32(bits), device="cpu")
    assert torch.equal(again, vals) and len(prog._evals) == 1


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_mul_pow2_matches_python_ints(name):
    field = FIELDS[name]
    be, p = get_backend(field), field.p
    vals = [0, 1, 2, p - 1, p - 2, (p + 1) // 2, 2**255 % p, 2**128 - 1, int.from_bytes(RNG.bytes(32), "little") % p]
    a = from_numpy_u32(be.to_limbs(vals))
    for k in (0, 1, 15, 16, 17, 31, 32, 63, 64, 128, 254, 255, 256, 511, 1000):
        assert be.from_limbs(be.mul_pow2(a, k)) == [v * pow(2, k, p) % p for v in vals], k
    # the limb axis elsewhere, as the evaluator keeps it
    a_t = a.t().contiguous()[None]  # [1, 16, N]
    got = be.mul_pow2(a_t, 77, dim=1)
    assert be.from_limbs(got[0].t()) == [v * pow(2, 77, p) % p for v in vals]
