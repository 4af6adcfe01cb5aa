"""The port below 253 bits against the JAX package and Python ints, bit for
bit (tolerance 0), at Goldilocks (2^64 − 2^32 + 1), 2^127 − 1, NIST
P-192's prime 2^192 − 2^64 − 1 and Jubjub's scalar field (252 bits)
(tests/torch_small_fields.py):

  * ``FieldBackend`` add, sub, neg, mul, square and inv against the
    reference's ``FieldBackend`` and Python ints, pow_const against Python
    ints;
  * the plain versions of the word kernels and of the fold matvec's
    canonical outputs (mul and mul_digits with a raw a in [p, 2^256),
    reduce_digits at its corner sums, chain, limbs_matvec and
    bits_matvec_canonical) against Python ints; the canonical bits bucket
    against the reference's Pallas kernel in interpret mode at Jubjub's
    scalar field (at Goldilocks the Pallas kernels' 202-step
    shift-subtract chain runs past a test's time in interpret mode, and
    the Pallas mul adds 37 s at Jubjub: the plain mul is held to the
    reference's FieldBackend instead);
  * config 1 (and its num_assert_nonzero variant) in the mixed and limbs
    forms at B = 64 through ``build_production_step``, clean and with its
    last fadd computing a product, against the reference's step with
    use_pallas=False;
  * the flagship (one sha256 compression) over Goldilocks: NativeBuilder's
    template equal to the reference's (CAPACITY 63 changes the MultiEq
    packing: 26,508 rows), and its packed verdict at B = 512, clean and
    with flipped bits, equal to the reference's;
  * the num family over Goldilocks: the strict decomposition's witness
    against the reference's evaluator, an is-zero of a field LC against
    Python ints;
  * both ``Satisfier`` routes, the row-chunked check and completion at
    2^12 rows (config 5's generator) and ``RowShardedSatisfier`` against
    the reference's."""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellpepper_tpu import TestConstraintSystem
from bellpepper_tpu.backend import field_pallas as ref_fp
from bellpepper_tpu.backend import matvec as ref_mv
from bellpepper_tpu.backend.field_jnp import get_backend as ref_backend
from bellpepper_tpu.backend.matvec import Satisfier as RefSatisfier
from bellpepper_tpu.backend.sharding import RowShardedSatisfier as RefRowSharded, default_mesh
from bellpepper_tpu.compile.pipeline import build_production_step as ref_step
from bellpepper_tpu.compile.tape import Op as RefOp
from bellpepper_tpu.compile.witness_program import WitnessProgram as RefProgram
from bellpepper_tpu.fields import PrimeField as RefPrimeField
from bellpepper_tpu.gadgets.num import AllocatedNum
from bellpepper_tpu.native import NativeBuilder as RefBuilder
from bellpepper_tpu.r1cs import R1CS as RefR1CS, COOMatrix as RefCOO
from bellpepper_tpu_torch import NativeBuilder, R1CS, COOMatrix, Satisfier, WitnessProgram, build_production_step
from bellpepper_tpu_torch.backend import field_kernels as fk
from bellpepper_tpu_torch.backend import matvec as mv
from bellpepper_tpu_torch.backend import row_chunked as rc
from bellpepper_tpu_torch.backend.field_backend import FieldBackend, get_backend
from bellpepper_tpu_torch.backend.row_sharded import RowShardedSatisfier
from bellpepper_tpu_torch.backend.words import from_numpy_u32, to_numpy_u32
from bellpepper_tpu_torch.tools.config5 import config5_r1cs, config5_z, flipped_first_row

from torch_circuits import digit_sum_corners
from test_torch_mixed import _one_torch_thread  # noqa: F401  (autouse)
from torch_small_fields import GOLDILOCKS, JUBJUB_FR, SMALL_FIELDS

SENT = 0xFFFFFFFF
IDS = lambda f: f.name  # noqa: E731


def _ref_field(field):
    return RefPrimeField(field.name, field.p)


def _values(p, n, seed):
    """Corners (0, 1, 2, p − 1, p − 2, (p − 1)/2, 2^(NUM_BITS − 1)), then
    uniform values."""
    rnd = random.Random(seed)
    corners = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, 1 << (p.bit_length() - 1)]
    return corners + [rnd.randrange(p) for _ in range(n - len(corners))]


def _lm(values):
    """int32[16, N] limb-major 16-bit limbs of Python ints below 2^256."""
    return from_numpy_u32(np.asarray([[(v >> (16 * l)) & 0xFFFF for v in values] for l in range(16)], np.uint32))


def _lm_ints(t):
    x = to_numpy_u32(t).astype(object)
    return [sum(int(x[l, i]) << (16 * l) for l in range(x.shape[0])) for i in range(x.shape[1])]


# --- FieldBackend ----------------------------------------------------------------
@pytest.mark.parametrize("field", SMALL_FIELDS, ids=IDS)
def test_backend_matches_reference_and_python_ints(field):
    p = field.p
    be, ref = get_backend(field), ref_backend(_ref_field(field))
    a, b = _values(p, 40, 1), _values(p, 40, 2)[::-1]
    A, B = from_numpy_u32(FieldBackend.to_limbs(a)), from_numpy_u32(FieldBackend.to_limbs(b))
    rA, rB = jnp.asarray(ref.to_limbs(a)), jnp.asarray(ref.to_limbs(b))
    e = 0xD1CE_5EED_0000_0001

    def both(got, want):
        assert FieldBackend.from_limbs(got) == ref.from_limbs(np.asarray(want))
        return FieldBackend.from_limbs(got)

    assert both(be.add(A, B), ref.add(rA, rB)) == [(x + y) % p for x, y in zip(a, b)]
    assert both(be.sub(A, B), ref.sub(rA, rB)) == [(x - y) % p for x, y in zip(a, b)]
    assert both(be.neg(A), ref.neg(rA)) == [-x % p for x in a]
    assert both(be.mul(A, B), ref.mul(rA, rB)) == [x * y % p for x, y in zip(a, b)]
    assert both(be.square(A), ref.square(rA)) == [x * x % p for x in a]
    assert both(be.inv(A), ref.inv(rA)) == [pow(x, p - 2, p) for x in a]
    assert FieldBackend.from_limbs(be.pow_const(A, e)) == [pow(x, e, p) for x in a]


# --- the plain versions ------------------------------------------------------------
@pytest.mark.parametrize("field", SMALL_FIELDS, ids=IDS)
def test_plain_kernels_match_python_ints(field):
    """mul and mul_digits (a canonical or raw in [p, 2^256), b canonical),
    reduce_digits at its corner sums, chain on config 1's pattern, and the
    canonical limbs and bits forms of the fold matvec at a few (row,
    instance) columns."""
    p = field.p
    rnd = random.Random(3)
    av = [0, 1, p - 1, p, p + 1, 2 * p, (1 << 256) - 1] + [rnd.randrange(1 << 256) for _ in range(40)]
    bv = _values(p, len(av), 4)
    want = [x * y % p for x, y in zip(av, bv)]
    assert _lm_ints(fk.mul_plain(_lm(av), _lm(bv), field)) == want
    dig = to_numpy_u32(fk.mul_digits_plain(_lm(av), _lm(bv), field)).astype(object)
    assert [sum(int(dig[j, i]) << (8 * j) for j in range(32)) for i in range(len(av))] == want
    corners = digit_sum_corners(p, 5)
    got = _lm_ints(fk.reduce_digits_plain(from_numpy_u32(corners.T.copy()), field))
    assert got == [sum(int(x) << (8 * j) for j, x in enumerate(col)) % p for col in corners]

    x0, e0, e1 = (_values(p, 12, s) for s in (5, 6, 7))
    descs = (("fmul", "prev", 0), ("fadd", "prev", 1), ("fmul", "prev", "prev"))
    out = fk.chain_plain(_lm(x0), torch.cat([_lm(e0), _lm(e1)]), descs, 5, field)
    for i in range(len(x0)):
        x = x0[i]
        for r in range(5):
            m = x * e0[i] % p
            s = (m + e1[i]) % p
            x = s * s % p
            assert _lm_ints(out[48 * r : 48 * r + 48].reshape(3, 16, -1)[:, :, i].t()) == [m, s, x], (i, r)

    rng = np.random.default_rng(8)
    S, n_rows, K, B = 20, 5, 3, 8
    zt = rng.integers(0, 1 << 16, size=(S, 16, B)).astype(np.uint32)
    cols = rng.integers(0, S, size=(n_rows, K)).astype(np.int32)
    cols[-1] = -1
    cols[1, 2] = -1
    Fz = rng.integers(0, 256, size=(32, n_rows, 32 * K)).astype(np.uint32)
    got = to_numpy_u32(fk.limbs_matvec_plain(from_numpy_u32(zt), torch.from_numpy(cols),
                                             torch.from_numpy(fk.fold_operand(Fz)), field, "canonical"))
    vals = rng.integers(0, 1 << 32, size=(S, 1), dtype=np.uint64).astype(np.uint32)
    Fb = rng.integers(0, 256, size=(32, n_rows, K)).astype(np.uint32)
    gotb = to_numpy_u32(fk.bits_matvec_canonical_plain(from_numpy_u32(vals), torch.from_numpy(cols),
                                                       torch.from_numpy(fk.fold_operand(Fb)), field))
    assert got.shape == (16, n_rows, B) and gotb.shape == (16, n_rows, 32)
    for r in range(n_rows):
        for b in (0, B - 1):
            digit = lambda e, j: (int(zt[cols[r, e], j // 2, b]) >> (8 * (j % 2))) & 0xFF  # noqa: E731
            exact = sum(int(Fz[d, r, 32 * e + j]) * digit(e, j) << (8 * d)
                        for e in range(K) if cols[r, e] >= 0 for j in range(32) for d in range(32))
            assert sum(int(got[l, r, b]) << (16 * l) for l in range(16)) == exact % p, (r, b)
        for b in (0, 17, 31):
            exact = sum(int(Fb[d, r, e]) << (8 * d) for e in range(K) if cols[r, e] >= 0
                        if (int(vals[cols[r, e], 0]) >> b) & 1 for d in range(32))
            assert sum(int(gotb[l, r, b]) << (16 * l) for l in range(16)) == exact % p, (r, b)


def test_plain_kernels_match_pallas_interpret():
    """The canonical bits bucket against make_bits_matvec_bucket(...,
    out_form="canonical") in interpret mode at Jubjub's scalar field,
    where the Pallas kernel canonicalizes with its 14-step shift-subtract
    chain (_chain_rows), the reference having no quotient estimate below
    253 bits; padding rows read zero."""
    field = JUBJUB_FR
    rf = _ref_field(field)
    rng = np.random.default_rng(11)
    K, n_rows, S, Bw = 4, 8, 40, 4
    vals = rng.integers(0, 1 << 32, size=(S, Bw), dtype=np.uint64).astype(np.uint32)
    cols = rng.integers(0, S, size=(n_rows, K)).astype(np.int32)
    cols[n_rows - 2 :] = -1
    cd = rng.integers(0, 256, size=(32, n_rows, K)).astype(np.uint32)
    bits = to_numpy_u32(fk._gather_bits(from_numpy_u32(vals), torch.from_numpy(cols)))  # [n_rows, K, B]
    kern = ref_fp.make_bits_matvec_bucket(rf, K, n_rows, 32 * Bw, interpret=True, out_form="canonical")
    want = np.asarray(kern(jnp.asarray(bits), jnp.asarray(cd)))
    got = fk.bits_matvec_canonical(from_numpy_u32(vals), torch.from_numpy(cols),
                                   torch.from_numpy(fk.fold_operand(cd)), field)
    assert (to_numpy_u32(got) == want).all() and not want[:, n_rows - 2 :].any()


# --- config 1 ------------------------------------------------------------------------
def _config1(builder_cls, field, nonzero):
    nb = builder_cls(field)
    bits = [nb.alloc_bit() for _ in range(128)]
    a, b = nb.pack_bits(bits[:64]), nb.pack_bits(bits[64:])
    x = a
    for _ in range(30):
        x = nb.num_square(nb.num_add(nb.num_mul(x, b), a))
    if nonzero:
        nb.num_assert_nonzero(x)
    return nb.finish()


def _last_fadd_is_fmul(tape):
    ni, na, ops, free = tape.snapshot()
    i = max(k for k, op in enumerate(ops) if op.opcode == "fadd")
    ops = list(ops)
    ops[i] = RefOp("fmul", ops[i].outs, ops[i].args)

    class _Tape:
        field = tape.field

        def snapshot(self):
            return ni, na, ops, free

    return _Tape()


@pytest.mark.parametrize(
    "field,variant,form,corrupt",
    [(GOLDILOCKS, False, "mixed", False), (GOLDILOCKS, False, "mixed", True), (GOLDILOCKS, False, "limbs", False),
     (GOLDILOCKS, False, "limbs", True), (JUBJUB_FR, True, "mixed", False)],
    ids=["goldilocks-mixed", "goldilocks-mixed-corrupted", "goldilocks-limbs", "goldilocks-limbs-corrupted",
         "jubjub-variant-mixed"],
)
def test_config1_step_matches_reference(field, variant, form, corrupt):
    B = 64
    t, tape = _config1(NativeBuilder, field, variant)
    tr, tape_r = _config1(RefBuilder, _ref_field(field), variant)
    assert t.coeff_table == tr.coeff_table and t.num_constraints == tr.num_constraints
    if corrupt:
        tape, tape_r = _last_fadd_is_fmul(tape), _last_fadd_is_fmul(tape_r)
    prog, ref = WitnessProgram(tape), RefProgram(tape_r)
    free = np.random.default_rng(12).integers(0, 2, size=(2, B, len(prog.free_slots))).astype(np.uint32)
    got = tuple(int(v) for v in build_production_step(prog, t, B, None, form, device="cpu")(from_numpy_u32(free)))
    want = tuple(int(v) for v in ref_step(ref, tr, B, use_pallas=False, witness_form=form)(jnp.asarray(free)))
    assert got == want and (got[0] > 0) == corrupt


# --- the flagship --------------------------------------------------------------------
def _sha256(builder_cls, field):
    nb = builder_cls(field)
    nb.sha256_compression([nb.alloc_bit() for _ in range(512)], nb.sha256_iv())
    return nb.finish()


def test_flagship_over_goldilocks_matches_reference():
    """The template array for array, and the packed verdict at B = 512 (its
    big rows through bits_matvec_canonical and mul), clean and with a
    flipped bit in a word of the bench probe's slot and in a late slot."""
    B = 512
    t, tape = _sha256(NativeBuilder, GOLDILOCKS)
    tr, _ = _sha256(RefBuilder, _ref_field(GOLDILOCKS))
    assert (t.num_constraints, t.num_inputs + t.num_aux) == (tr.num_constraints, tr.num_inputs + tr.num_aux)
    assert t.num_constraints == 26508 and t.coeff_table == tr.coeff_table
    for m in "abc":
        for f in ("rows", "cols", "coeff_ids"):
            assert np.array_equal(np.asarray(getattr(getattr(t, m), f)), np.asarray(getattr(getattr(tr, m), f)))
    prog = WitnessProgram(tape)
    free = np.random.default_rng(13).integers(0, 1 << 32, size=(B // 32, len(prog.free_slots)),
                                              dtype=np.uint64).astype(np.uint32)
    vp = to_numpy_u32(prog.build_packed(device="cpu")(from_numpy_u32(free)))
    check = mv.build_templated_check(t, B, None, "bits_packed", device="cpu")
    assert check.big is not None and not check.big.semi
    ref = jax.jit(ref_mv.build_templated_check(tr, B, False, "bits_packed").verdict)
    for flip in (None, (8, 600, 7), (3, vp.shape[1] - 9, 30)):
        v = vp.copy()
        if flip:
            v[flip[0], flip[1]] ^= np.uint32(1 << flip[2])
        got = tuple(int(x) for x in check.verdict(from_numpy_u32(v)))
        assert got == tuple(int(x) for x in ref(jnp.asarray(v)))
        assert (got == (0, SENT)) == (flip is None)
        if flip:
            assert got[1] // t.num_constraints == 32 * flip[0] + flip[2]


# --- the num family ---------------------------------------------------------------------
def test_num_family_over_goldilocks():
    """num_to_bits_le_strict of free field values (0, 1, p − 1 and random
    ones) gives the reference's field rows and bit slots (is-zero's
    inverse and u32 value are the port's own: it works in the field where
    the reference reads the low 32 bits, test_torch_num_family.py); the
    is-zero of the field LC x + 3·b gives the bit and inverse of the sum
    mod p (WitnessProgram's _lc_field), at sums that wrap p."""
    from test_torch_num_family import _free_inputs, _RetapedLC

    p = GOLDILOCKS.p
    nb = NativeBuilder(GOLDILOCKS)
    x = nb.alloc_num()
    bits = [nb.view(v)[1] for v in nb.num_to_bits_le_strict(x)]
    b = nb.alloc_bit()
    out = nb.num_is_zero(x)
    _t, tape = nb.finish()
    xs = [0, 0, 1, p - 1, p - 3, p - 4, (1 << 32) + 7, 12345]
    bs = [0, 1, 0, 1, 1, 1, 0, 1]
    prog = WitnessProgram(tape)
    fb, ffl = _free_inputs(prog, [bs], [xs])
    vals, fl = prog.build(device="cpu")(torch.from_numpy(fb.view(np.int32)), torch.from_numpy(ffl.view(np.int32)))
    want_vals, want_fl = RefProgram(tape).build(False)(jnp.asarray(fb), jnp.asarray(ffl))
    inv_row = prog.field_rows[next(op.outs[0] for op in tape.snapshot()[2] if op.opcode == "num_inv_or_one")]
    rows = [r for r in range(fl.shape[1]) if r != inv_row]
    assert np.array_equal(fl.numpy().view(np.uint32)[:, rows], np.asarray(want_fl)[:, rows])
    assert len(bits) == GOLDILOCKS.NUM_BITS
    assert np.array_equal(vals.numpy().view(np.uint32)[:, bits], np.asarray(want_vals)[:, bits])
    lc = WitnessProgram(_RetapedLC(tape, [(1, nb._slot(x)), (3, nb.view(b)[1])]))
    vals, fl = lc.build(device="cpu")(torch.from_numpy(fb.view(np.int32)), torch.from_numpy(ffl.view(np.int32)))
    inv_row = lc.field_rows[next(op.outs[0] for op in tape.snapshot()[2] if op.opcode == "num_inv_or_one")]
    for i, (xv, bv) in enumerate(zip(xs, bs)):
        s = (xv + 3 * bv) % p
        assert int(vals[i, nb.view(out)[1]]) == (s == 0)
        assert FieldBackend.from_limbs(fl[i, inv_row])[0] == (pow(s, p - 2, p) if s else 1)


# --- Satisfier, row-chunked, row-sharded -----------------------------------------------
@functools.lru_cache(maxsize=None)
def _circuit(field):
    """A random 40-step mul/add/square circuit over `field` in the
    reference's TestConstraintSystem: (its R1CS, the port's copy, inputs,
    aux)."""
    p = field.p
    rnd = random.Random(p % 1009)
    cs = TestConstraintSystem(_ref_field(field))
    nums = [AllocatedNum.alloc(cs.namespace(f"in {i}"), rnd.randrange(p)) for i in range(4)]
    for step in range(40):
        op, x, y = rnd.randrange(3), rnd.choice(nums), rnd.choice(nums)
        ns = cs.namespace(f"op {step}")
        nums.append(x.mul(ns, y) if op == 0 else x.add(ns, y) if op == 1 else x.square(ns))
    rr = RefR1CS.from_test_cs(cs)
    r = R1CS(field, rr.num_inputs, rr.num_aux, rr.num_constraints,
             *(COOMatrix(m.rows, m.cols, m.coeff_ids) for m in (rr.a, rr.b, rr.c)), rr.coeff_table, names=rr.names)
    return rr, r, list(cs.scalar_inputs()), list(cs.scalar_aux())


@pytest.mark.parametrize("field", SMALL_FIELDS, ids=IDS)
def test_satisfier_routes_match_reference(field):
    """Satisfier(r, True) (the templated limbs route) and Satisfier(r,
    False) (DeviceR1CS) against the reference's Satisfier, clean and with
    one aux value off by one."""
    rr, r, inputs, aux = _circuit(field)
    bad = list(aux)
    bad[17] = (bad[17] + 1) % field.p
    ref = RefSatisfier(rr, use_pallas=False)
    for wit in (aux, bad):
        rz = ref.z_from_assignments(inputs, wit)
        want = (ref.is_satisfied(rz), ref.which_is_unsatisfied(rz))
        for route in (True, False):
            sat = Satisfier(r, route, device="cpu")
            z = sat.z_from_assignments(inputs, wit)
            assert (to_numpy_u32(z) == np.asarray(rz)).all()
            assert (sat.is_satisfied(z), sat.which_is_unsatisfied(z)) == want
    assert want[0] is False and want[1] is not None


def test_row_sharded_satisfier_matches_reference():
    rr, r, inputs, aux = _circuit(GOLDILOCKS)
    sat = RowShardedSatisfier(r, n_shards=2, device="cpu")
    want = RefRowSharded(rr, default_mesh(2), use_pallas=False)
    for k in range(2):
        a = list(aux)
        if k:
            a[9] = (a[9] + 5) % GOLDILOCKS.p
        got = tuple(int(x) for x in sat._check(sat.z_from_assignments(inputs, a)))
        assert got == tuple(int(x) for x in want._check(want.z_from_assignments(inputs, a)))
        assert (got[0] == 0) == (k == 0)


@pytest.mark.parametrize("field", [GOLDILOCKS], ids=IDS)
def test_row_chunked_check_and_completion_match_reference(field):
    """Config 5's generator at 2^12 rows over the field: the completion's
    product (raw z, nearly every value in [p, 2^256)) equal to the
    reference's, and the check (its canonical route) clean on the
    completed witness, failing every row on the raw one, and failing at
    the row numpy names after z[5, 0] ^= 1, as the reference's."""
    r, zfree, N0, _ = config5_r1cs(12, field=field)
    R = r.num_constraints
    rr = RefR1CS(field=_ref_field(field), num_inputs=1, num_aux=r.num_aux, num_constraints=R,
                 a=RefCOO(r.a.rows, r.a.cols, r.a.coeff_ids), b=RefCOO(r.b.rows, r.b.cols, r.b.coeff_ids),
                 c=RefCOO(r.c.rows, r.c.cols, r.c.coeff_ids), coeff_table=r.coeff_table)
    z = config5_z(zfree, R, "cpu")
    check, prep = rc.build_row_chunked_check(r, R >> 10, device="cpu")
    assert check._route == "canonical"
    prod, pp = rc.build_row_chunked_product(r, R >> 8, reuse=(check._layout_meta, prep), device="cpu")
    rf, rp = ref_mv.build_row_chunked_product(rr, R >> 8)
    w = prod(z, pp)
    assert (to_numpy_u32(w) == np.asarray(jax.jit(rf)(jnp.asarray(to_numpy_u32(z)), rp))).all()
    zc = z.clone()
    zc[N0 + 1 :] = w
    zb = zc.clone()
    zb[5, 0] ^= 1
    ref_check, ref_prep = ref_mv.build_row_chunked_check(rr, R >> 10)
    got = [tuple(int(x) for x in check(zz, prep)) for zz in (zc, z, zb)]
    assert got == [tuple(int(x) for x in jax.jit(ref_check)(jnp.asarray(to_numpy_u32(zz)), ref_prep))
                   for zz in (zc, z, zb)]
    assert got[0] == (0, SENT) and got[1] == (R, 0) and got[2][1] == flipped_first_row(r, 5)
