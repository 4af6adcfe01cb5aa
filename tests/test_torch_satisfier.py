"""The port's Satisfier, TemplatedSatisfier and limbs production paths
against the JAX package and the Python-int host oracle: Satisfier on
tests/test_device_satisfy.py's circuits (names, corruptions, random DAGs,
WitnessCS witnesses, replicated templates) and on one sha256 compression
with a non-bit value planted in a message-bit slot; TemplatedSatisfier in
the limbs and mixed forms on config 1; build_production_step(...,
witness_form="limbs") and build_chunked_check against the reference's at
2 × 128, clean and corrupted. Verdicts and names are compared exactly."""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest

from bellpepper_tpu import SCALAR, TestConstraintSystem, WitnessCS
from bellpepper_tpu.backend.matvec import Satisfier as RefSatisfier
from bellpepper_tpu.backend.matvec import TemplatedSatisfier as RefTemplated
from bellpepper_tpu.compile.pipeline import build_chunked_check as ref_chunked
from bellpepper_tpu.compile.pipeline import build_production_step as ref_step
from bellpepper_tpu.compile.witness_program import WitnessProgram as RefProgram
from bellpepper_tpu.gadgets.num import AllocatedNum
from bellpepper_tpu.native import NativeBuilder as RefBuilder
from bellpepper_tpu.r1cs import R1CS as RefR1CS, ShapeCS
from bellpepper_tpu_torch import (
    NativeBuilder,
    Satisfier,
    TemplatedSatisfier,
    WitnessProgram,
    build_chunked_check,
    build_production_step,
)
from bellpepper_tpu_torch.backend.words import from_numpy_u32, to_numpy_u32

import test_device_satisfy
import test_packed
import test_torch_mixed
from test_torch_mixed import _one_torch_thread  # noqa: F401  (autouse)

RNG = np.random.default_rng(0x5EED_000B)
P = SCALAR.p
SENT = 0xFFFFFFFF


def _limbs16(v):
    return [(v >> (16 * l)) & 0xFFFF for l in range(16)]


def _both(r1cs, inputs, aux):
    """(is_satisfied, which_is_unsatisfied) of the port and the reference
    on one witness."""
    sat, ref = Satisfier(r1cs, device="cpu"), RefSatisfier(r1cs, use_pallas=False)
    z, rz = sat.z_from_assignments(inputs, aux), ref.z_from_assignments(inputs, aux)
    assert (to_numpy_u32(z) == np.asarray(rz)).all()
    got = (sat.is_satisfied(z), sat.which_is_unsatisfied(z))
    assert got == (ref.is_satisfied(rz), ref.which_is_unsatisfied(rz))
    return got


def test_satisfier_matches_host_oracle():
    cs = TestConstraintSystem()
    test_device_satisfy.mul_add_circuit(cs)
    r1cs = RefR1CS.from_test_cs(cs)
    assert r1cs.num_inputs > 1  # the output is inputized: batch 1 takes inputs
    assert _both(r1cs, cs.scalar_inputs(), cs.scalar_aux()) == (True, None)
    cs.set("ab/product num", 999)
    host = cs.which_is_unsatisfied()
    assert host is not None
    assert _both(RefR1CS.from_test_cs(cs), cs.scalar_inputs(), cs.scalar_aux()) == (False, host)


def test_satisfier_random_circuits():
    rng = random.Random(0x5962BE3D)
    for _trial in range(3):
        cs = TestConstraintSystem()
        nums = [AllocatedNum.alloc(cs.namespace(f"in {i}"), rng.randrange(P)) for i in range(4)]
        for step in range(12):
            op, x, y = rng.randrange(3), rng.choice(nums), rng.choice(nums)
            ns = cs.namespace(f"op {step}")
            nums.append(x.mul(ns, y) if op == 0 else x.add(ns, y) if op == 1 else x.square(ns))
        r1cs = RefR1CS.from_test_cs(cs)
        assert _both(r1cs, cs.scalar_inputs(), cs.scalar_aux()) == (True, None)
        aux = cs.scalar_aux()
        idx = rng.randrange(len(aux))
        aux[idx] = (aux[idx] + 1) % P
        host_ok, host_row = r1cs.eval_host(cs.scalar_inputs(), aux)
        assert _both(r1cs, cs.scalar_inputs(), aux) == (
            (True, None) if host_ok else (False, r1cs.names[host_row])
        )


def test_satisfier_witness_cs_and_replicate():
    shape = ShapeCS()
    test_device_satisfy.mul_add_circuit(shape)
    r1cs = shape.finish()
    for a_val in (3, 17, P - 2):
        w = WitnessCS()
        test_device_satisfy.mul_add_circuit(w, {"a": a_val})
        assert _both(r1cs, w.inputs_slice(), w.aux_slice()) == (True, None)

    def template(cs):
        a = AllocatedNum.alloc(cs.namespace("a"), 5)
        b = AllocatedNum.alloc(cs.namespace("b"), 6)
        a.mul(cs.namespace("prod"), b)

    shape = ShapeCS()
    template(shape)
    r4 = shape.finish().replicate(4)
    w = WitnessCS()
    for _ in range(4):
        template(w)
    aux = list(w.aux_slice())
    assert _both(r4, w.inputs_slice(), aux) == (True, None)
    aux[7] = (aux[7] + 1) % P
    assert _both(r4, w.inputs_slice(), aux)[0] is False


@functools.lru_cache(maxsize=None)
def _sha256():
    nb = NativeBuilder()
    bits = [nb.alloc_bit() for _ in range(512)]
    nb.sha256_compression(bits, nb.sha256_iv())
    template, tape = nb.finish()
    return template, WitnessProgram(tape)


def test_satisfier_sha256_finds_a_non_bit_message_value():
    """One compression (26,352 rows) at batch 1 takes the non-fused limbs
    route; a random field element in a message-bit slot is named at the
    least row that fails over the Python ints, as the reference names it."""
    template, prog = _sha256()
    free = from_numpy_u32(RNG.integers(0, 2, size=(1, 512)).astype(np.uint32))
    vals, flimbs = prog.build(device="cpu")(free)
    z = prog.z_template_limbs(vals, flimbs)[0]
    sat = Satisfier(template, device="cpu")
    assert sat.is_satisfied(z) and sat.which_is_unsatisfied(z) is None
    slot = prog.free_slots[300]
    zs = to_numpy_u32(z).copy()
    zs[slot] = _limbs16(random.Random(3).randrange(P))
    bad = from_numpy_u32(zs)
    ints = [sum(int(x) << (16 * l) for l, x in enumerate(row)) for row in zs]
    ok, row = RefR1CS.eval_host(template, ints[:1], ints[1:])
    assert not ok and sat.which_is_unsatisfied(bad) == f"constraint #{row}"
    assert RefSatisfier(template, use_pallas=False).which_is_unsatisfied(jnp.asarray(zs)) == f"constraint #{row}"


@functools.lru_cache(maxsize=None)
def _config1():
    t, tape = test_torch_mixed._config1(NativeBuilder)
    tr, tape_r = test_torch_mixed._config1(RefBuilder)
    return t, tape, WitnessProgram(tape), tr, tape_r, RefProgram(tape_r)


@pytest.mark.parametrize("form", ["limbs", "mixed"])
def test_templated_satisfier_matches_reference(form):
    t, _tape, prog, tr, _tr, ref = _config1()
    B = 128
    free = from_numpy_u32(RNG.integers(0, 2, size=(B, 128)).astype(np.uint32))
    vals, flimbs = prog.build(device="cpu")(free)
    fs = prog.field_slots
    mixed = form == "mixed"
    sat = TemplatedSatisfier(t, B, witness_form=form if mixed else None, field_slots=fs if mixed else None,
                             device="cpu")
    rsat = RefTemplated(tr, B, use_pallas=False, witness_form=form, field_slots=fs if form == "mixed" else None)
    if form == "limbs":
        z = to_numpy_u32(prog.z_template_limbs(vals, flimbs))
        bad = z.copy()
        bad[B // 2, prog.free_slots[9]] = _limbs16(random.Random(4).randrange(P))  # a non-bit value
        cases = [(sat.z_from_instances(z), jnp.asarray(z)), (sat.z_from_instances(bad), jnp.asarray(bad))]
    else:
        v, f = to_numpy_u32(vals), to_numpy_u32(flimbs)
        fb = f.copy()
        fb[B // 2, 40, 2] ^= 4
        cases = [((from_numpy_u32(v), from_numpy_u32(f)), (jnp.asarray(v), jnp.asarray(f))),
                 ((from_numpy_u32(v), from_numpy_u32(fb)), (jnp.asarray(v), jnp.asarray(fb)))]
    for k, (z, rz) in enumerate(cases):
        got = (sat.is_satisfied(z), sat.which_is_unsatisfied(z))
        assert got == (rsat.is_satisfied(rz), rsat.which_is_unsatisfied(rz))
        assert got[0] == (k == 0)
        if k:
            assert got[1].startswith(f"instance {B // 2}: constraint #")


@pytest.mark.parametrize("name,corrupt", [("config1", False), ("config1", True), ("addmany", False),
                                          ("addmany", True)],
                         ids=["config1-clean", "config1-corrupted", "addmany-clean", "addmany-corrupted"])
def test_limbs_production_step_matches_reference(name, corrupt, monkeypatch):
    """Config 1 (the fold rows on the fused route at B = 128) with its
    last fadd computing a product when corrupted, and the pure-bit addmany
    fixture of tests/test_packed.py with its last xor computing an and."""
    if name == "config1":
        t, tape, _prog, tr, tape_r, _ref = _config1()
        if corrupt:
            tape, tape_r = test_torch_mixed._corrupted(tape), test_torch_mixed._corrupted(tape_r)
    else:
        monkeypatch.setattr(test_packed, "WitnessProgram", lambda tape: tape)
        t, tape = test_packed._addmany_setup()
        tr = t
        if corrupt:
            import test_torch_pipeline

            tape = test_torch_pipeline._corrupted(tape)
        tape_r = tape
    prog, ref = WitnessProgram(tape), RefProgram(tape_r)
    B = 128
    free = RNG.integers(0, 2, size=(2, B, len(prog.free_slots))).astype(np.uint32)
    step = build_production_step(prog, t, B, device="cpu", witness_form="limbs")
    got = tuple(int(v) for v in step(from_numpy_u32(free)))
    want = tuple(int(v) for v in ref_step(ref, tr, B, use_pallas=False, witness_form="limbs")(jnp.asarray(free)))
    assert got == want and (got[0] > 0) == corrupt
    if not corrupt:
        assert got == (0, SENT)


def test_chunked_check_matches_reference():
    t, _tape, prog, tr, _tr, _ref = _config1()
    B = 128
    zs = []
    for _k in range(2):
        free = from_numpy_u32(RNG.integers(0, 2, size=(B, 128)).astype(np.uint32))
        zs.append(to_numpy_u32(prog.z_template_limbs(*prog.build(device="cpu")(free))))
    z4 = np.stack(zs)
    z4[1, 7, prog.free_slots[2]] = _limbs16(2)
    got = tuple(int(v) for v in build_chunked_check(t, B, 2, device="cpu")(from_numpy_u32(z4)))
    want = tuple(int(v) for v in ref_chunked(tr, B, 2, use_pallas=False)(jnp.asarray(z4)))
    assert got == want and got[0] > 0 and got[1] // t.num_constraints == B + 7
    with pytest.raises(ValueError):
        build_chunked_check(t, B, 3, device="cpu")(from_numpy_u32(z4))
