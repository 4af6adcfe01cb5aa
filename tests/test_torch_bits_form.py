"""The port's generic bits witness form against the JAX package: BitsCheck's
mask and (n_bad, first) verdict against build_templated_check(t, B,
False, "bits") on the sha256 and config-2 templates at B = 1, 33, 96 and
128, clean and corrupted; the padded instances it cuts away; the packed
check's no-majority fallback against the reference's violations_packed_fb
on a hand-built R1CS whose rows mostly carry coefficients ≥ 2^31; the bits
production step and chunked check against the reference's; and
TemplatedSatisfier(..., "bits") on the Pallas and Vesta fields. All
comparisons are exact.

Config 2 (benchmarks/configs_1_2_3.py:162-206): eight allocated UInt32s,
then seven rounds of x ← addmany(x ⊕ rotr(op_i, 5i), shr(op_{i-1}, 3))
under one MultiEq."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellpepper_tpu.backend import matvec as ref_mv
from bellpepper_tpu.backend.matvec import TemplatedSatisfier as RefSatisfier
from bellpepper_tpu.compile.pipeline import build_chunked_check as ref_chunked
from bellpepper_tpu.compile.pipeline import build_production_step as ref_step
from bellpepper_tpu.compile.tape import Op as RefOp
from bellpepper_tpu.compile.witness_program import WitnessProgram as RefProgram
from bellpepper_tpu.native import NativeBuilder as RefBuilder
from bellpepper_tpu_torch import (
    PALLAS_SCALAR,
    SCALAR,
    VESTA_SCALAR,
    COOMatrix,
    NativeBuilder,
    PrimeField,
    R1CS,
    TemplatedSatisfier,
    WitnessProgram,
    build_chunked_check,
    build_production_step,
)
from bellpepper_tpu_torch.backend import matvec as mv
from bellpepper_tpu_torch.backend.words import from_numpy_u32, pack_rows, to_numpy_u32
from bellpepper_tpu_torch.compile.tape import SnapshotTape

RNG = np.random.default_rng(0x5EED_000B)
SENT = 0xFFFFFFFF


def config2(builder_cls, field=SCALAR):
    nb = builder_cls(field)
    ops = [nb.alloc_u32() for _ in range(8)]
    nb.multieq_begin()
    x = ops[0]
    for i in range(1, 8):
        rot = [ops[i][(k + 5 * i) % 32] for k in range(32)]
        x = [nb.xor(a, b) for a, b in zip(x, rot)]
        x = nb.addmany([x, ops[i - 1][3:] + [nb.constant(False)] * 3])
    nb.multieq_end()
    return nb.finish()


def sha256(builder_cls, field=SCALAR):
    nb = builder_cls(field)
    bits = [nb.alloc_bit() for _ in range(512)]
    nb.sha256_compression(bits, nb.sha256_iv())
    return nb.finish()


@pytest.fixture(scope="module")
def templates():
    out = {}
    for name, make in (("sha256", sha256), ("config2", config2)):
        t, tape = make(NativeBuilder)
        out[name] = (t, WitnessProgram(tape))
    return out


def _bits_witness(prog, B):
    free = RNG.integers(0, 2, size=(B, len(prog.free_slots))).astype(np.int32)
    vals, _ = prog.build(device="cpu")(torch.from_numpy(free))
    return to_numpy_u32(vals)


def _ref_verdict(mask):
    return (int(mask.sum()), int(np.argmax(mask)) if mask.any() else SENT)


@pytest.mark.parametrize("B", [1, 33, 96, 128])
@pytest.mark.parametrize("name", ["sha256", "config2"])
def test_bits_check_matches_reference(templates, name, B):
    template, prog = templates[name]
    R = template.num_constraints
    ref = jax.jit(ref_mv.build_templated_check(template, B, False, "bits"))
    check = mv.build_templated_check(template, B, None, "bits", device="cpu")
    assert isinstance(check, mv.BitsCheck)
    vals = _bits_witness(prog, B)
    cases = [(vals, None)]
    for slot, inst in ((prog.num_slots // 2, B // 2), (prog.free_slots[7], B - 1),
                       (prog.num_slots - 1, 0)):
        v = vals.copy()
        v[inst, slot] ^= 1
        cases.append((v, inst))
    for v, inst in cases:
        want = np.asarray(ref(jnp.asarray(v)))
        got = check(from_numpy_u32(v)).numpy()
        assert (got == want).all()
        verdict = tuple(int(x) for x in check.verdict(from_numpy_u32(v)))
        assert verdict == _ref_verdict(want)
        if inst is None:
            assert verdict == (0, SENT)
        else:
            assert verdict[0] > 0 and verdict[1] // R == inst, (verdict, inst)


def test_padded_instances_are_cut(templates):
    """At B = 33 the packed words carry 31 all-zero padding instances,
    which the family rows flag (ONE reads 0); BitsCheck's mask and verdict
    leave them out."""
    template, prog = templates["sha256"]
    B = 33
    check = mv.build_templated_check(template, B, None, "bits", device="cpu")
    z_T = from_numpy_u32(_bits_witness(prog, B)).t()
    words = pack_rows(z_T, check.Bw)
    nb_pad, first_pad = (int(x) for x in check.packed.verdict_slot_major(words))
    assert nb_pad > 0 and first_pad // template.num_constraints >= B
    assert check.mask_slot_major(z_T).shape == (template.num_constraints, B)
    assert tuple(int(x) for x in check.verdict_slot_major(z_T)) == (0, SENT)


def _big_coefficient_template(n=12):
    """Rows (c_k·x_k + d_k·x_{k+1})·ONE = c_k·y_k + d_k·y_{k+1} with c_k,
    d_k ≥ 2^31 (big rows), plus two booleanity rows: no small-row
    majority. Slots: ONE, x_0..x_n, y_0..y_n."""
    p = SCALAR.p
    rows = []
    for k in range(n):
        c, d = (1 << 31) + 977 * k, (1 << 200) + k
        rows.append({"a": [(1 + k, c), (2 + k, d)], "b": [(0, 1)],
                     "c": [(n + 2 + k, c), (n + 3 + k, d)]})
    for s in (1, n + 2):
        rows.append({"a": [(s, 1)], "b": [(0, 1), (s, p - 1)], "c": []})
    table, mats = [], {m: ([], [], []) for m in "abc"}
    for r, row in enumerate(rows):
        for m, terms in row.items():
            for col, cf in terms:
                if cf % p not in table:
                    table.append(cf % p)
                mats[m][0].append(r)
                mats[m][1].append(col)
                mats[m][2].append(table.index(cf % p))
    coo = {m: COOMatrix(*(np.asarray(x, np.int32) for x in mats[m])) for m in "abc"}
    return R1CS(SCALAR, 1, 2 * n + 2, len(rows), coo["a"], coo["b"], coo["c"], table), n


def test_no_majority_fallback_matches_reference():
    template, n = _big_coefficient_template()
    assert mv._classify_small_rows(template) is None
    B = 512
    x = RNG.integers(0, 1 << 32, size=(B // 32, n + 1), dtype=np.uint64).astype(np.uint32)
    vals = np.concatenate([np.full((B // 32, 1), SENT, np.uint32), x, x], axis=1)
    ref = jax.jit(ref_mv.build_templated_check(template, B, False, "bits_packed"))
    check = mv.build_templated_check(template, B, None, "bits_packed", device="cpu")
    assert check.fallback is not None
    R = template.num_constraints
    for slot, word, bit in ((None, 0, 0), (n + 4, 3, 17), (1, 15, 31)):
        v = vals.copy()
        if slot is not None:
            v[word, slot] ^= np.uint32(1 << bit)
        want = np.asarray(ref(jnp.asarray(v)))
        got = check(from_numpy_u32(v)).numpy()
        assert (got == want).all()
        verdict = tuple(int(x) for x in check.verdict(from_numpy_u32(v)))
        assert verdict == _ref_verdict(want)
        assert (verdict[0] > 0) == (slot is not None)
        if slot is not None:
            assert verdict[1] // R == 32 * word + bit
    # the bits form on the same template takes the fallback too
    z = np.zeros((33, template.num_inputs + template.num_aux), np.uint32)
    z[:, 0] = 1
    z[5, 3] = z[5, n + 4] = 1
    z[20, 2] = 1  # x_1 without y_1
    want = np.asarray(ref_mv.build_templated_check(template, 33, False, "bits")(jnp.asarray(z)))
    bits = mv.build_templated_check(template, 33, None, "bits", device="cpu")
    assert (bits(from_numpy_u32(z)).numpy() == want).all() and want.any()
    assert tuple(int(x) for x in bits.verdict(from_numpy_u32(z))) == _ref_verdict(want)


def _corrupted(tape):
    """The tape with its last xor computing and."""
    ni, na, ops, free = tape.snapshot()
    i = max(k for k, op in enumerate(ops) if op.opcode == "xor")
    ops = list(ops)
    ops[i] = RefOp("and", ops[i].outs, ops[i].args)
    return SnapshotTape(tape.field, (ni, na, ops, free))


@pytest.mark.parametrize("corrupt", [False, True], ids=["clean", "corrupted"])
def test_bits_production_step_matches_reference(templates, corrupt):
    """Config 2 (a pure-bit program) takes the bits form by default in
    both packages."""
    template, _ = templates["config2"]
    _t, tape = config2(RefBuilder)
    if corrupt:
        tape = _corrupted(tape)
    prog, ref = WitnessProgram(tape), RefProgram(tape)
    B = 96
    free = RNG.integers(0, 2, size=(2, B, len(prog.free_slots))).astype(np.uint32)
    want = tuple(int(v) for v in ref_step(ref, template, B, use_pallas=False)(jnp.asarray(free)))
    got = tuple(int(v) for v in build_production_step(prog, template, B, device="cpu")(from_numpy_u32(free)))
    assert got == want
    assert (got[0] > 0) == corrupt
    if not corrupt:
        assert got == (0, SENT)


@pytest.mark.parametrize("name", ["sha256", "config2"])
def test_bits_chunked_check_matches_reference(templates, name):
    template, prog = templates[name]
    B, n_chunks = 64, 2
    z4 = np.stack([_bits_witness(prog, B) for _ in range(n_chunks)])
    z4[1, 40, prog.num_slots // 3] ^= 1
    want = tuple(int(v) for v in ref_chunked(template, B, n_chunks, False, "bits")(jnp.asarray(z4)))
    got = tuple(int(v) for v in build_chunked_check(template, B, n_chunks, device="cpu",
                                                    witness_form="bits")(from_numpy_u32(z4)))
    assert got == want and got[0] > 0
    assert got[1] // template.num_constraints == B + 40


@pytest.mark.parametrize("field", [PALLAS_SCALAR, VESTA_SCALAR], ids=lambda f: f.name)
def test_templated_satisfier_bits_on_pasta(field):
    """The reference's tests/test_pasta_fields.py:80 case: sha256 on a
    Pasta field, checked in the bits form."""
    B = 2
    t, tape = sha256(NativeBuilder, field)
    tr, tape_r = sha256(RefBuilder, field)
    prog = WitnessProgram(tape)
    vals = _bits_witness(prog, B)
    sat = TemplatedSatisfier(t, B, witness_form="bits", device="cpu")
    ref = RefSatisfier(tr, B, use_pallas=False, witness_form="bits")
    assert sat.is_satisfied(sat.z_from_instances(vals)) and ref.is_satisfied(jnp.asarray(vals))
    bad = vals.copy()
    bad[1, prog.num_slots - 5] ^= 1
    name = sat.which_is_unsatisfied(sat.z_from_instances(bad))
    assert name == ref.which_is_unsatisfied(jnp.asarray(bad))
    assert name.startswith("instance 1: ")


def test_bits_form_refuses_small_fields(templates):
    """Config 2's template over a 127-bit field, which the bits form
    refused until its canonical route was ported (bits_matvec_canonical,
    then mul and a compare, where p·2^11 does not bound the semi values):
    the mask and verdict equal the reference's, clean and with one bit
    flipped."""
    small, tape = config2(NativeBuilder, PrimeField("m127", (1 << 127) - 1))
    prog = WitnessProgram(tape)
    B = 64
    check = mv.build_templated_check(small, B, None, "bits", device="cpu")
    ref = jax.jit(ref_mv.build_templated_check(small, B, False, "bits"))
    z = _bits_witness(prog, B)
    bad = z.copy()
    bad[9, prog.num_slots - 7] ^= 1
    for k, zz in enumerate((z, bad)):
        want = np.asarray(ref(jnp.asarray(zz)))
        assert (check(from_numpy_u32(zz)).numpy() == want).all()
        assert tuple(int(v) for v in check.verdict(from_numpy_u32(zz))) == _ref_verdict(want)
        assert want.any() == (k == 1)
