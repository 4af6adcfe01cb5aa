"""The port's monolithic and row-chunked evaluators, product and check
(bellpepper_tpu_torch/backend/row_chunked.py) against the JAX package's
(bellpepper_tpu/backend/matvec.py) on the same numpy-seeded systems, bit
for bit: the evaluations at 1, 4 and 16 chunks and the monolithic
r1cs_eval, premul on and off (with zero coefficients), the skewed-row
fallback to segment sums, slice mode and a shuffled C, the semi-reduced
blocks, the product with and without a reused layout, both check routes'
(n_bad, first) (the semi route's chunk mask also against the Pallas
mulcmp in interpret mode), a witness whose values lie in [p, 2^256), the
zero-constraint system and every ValueError. Fixtures are
tests/test_row_chunked.py's (R 64) and tests/test_row_chunked_semi.py's
(R 1,024 and 4,096)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellpepper_tpu.backend import matvec as ref
from bellpepper_tpu.backend.field_jnp import get_backend as ref_backend
from bellpepper_tpu.fields import SCALAR
from bellpepper_tpu.r1cs import R1CS, COOMatrix
from bellpepper_tpu_torch.backend import row_chunked as rc
from bellpepper_tpu_torch.backend.field_backend import get_backend
from bellpepper_tpu_torch.backend.field_kernels import mulcmp
from bellpepper_tpu_torch.backend.words import from_numpy_u32, to_numpy_u32

import test_row_chunked
import test_row_chunked_semi
from test_torch_mixed import _one_torch_thread  # noqa: F401  (autouse)

SENT = 0xFFFFFFFF
P = SCALAR.p
NAMES = ("a", "b", "c")


def _t(z) -> torch.Tensor:
    return from_numpy_u32(np.asarray(z), "cpu")


def _np(ts):
    return [to_numpy_u32(t) for t in ts]


def _eq(xs, ys):
    assert len(xs) == len(ys)
    for x, y in zip(xs, ys):
        np.testing.assert_array_equal(np.asarray(x, np.uint32), np.asarray(y, np.uint32))


@functools.lru_cache(maxsize=None)
def _small():
    """tests/test_row_chunked.py's system (R 64, N0 32) with its product
    segment completed by the reference, and the reference's monolithic
    A·z, B·z, C·z of the raw z."""
    r1cs, z = test_row_chunked._synthetic()
    be = ref_backend(SCALAR)
    az, bz, cz = ref.r1cs_eval(be, ref.DeviceR1CS.from_r1cs(r1cs), z)
    zc = z.at[r1cs.num_inputs + 32 :].set(be.mul(az, bz))
    return r1cs, np.asarray(z), np.asarray(zc), [np.asarray(x) for x in (az, bz, cz)]


def _non_canonical(shape, seed):
    """Random 16-bit limbs with the top limb at least p's top limb + 1:
    every value in [p, 2^256), slot 0 ONE."""
    rng = np.random.default_rng(seed)
    z = rng.integers(0, 1 << 16, size=shape).astype(np.uint32)
    z[:, 15] = rng.integers((P >> 240) + 1, 1 << 16, size=shape[0])
    z[0] = 0
    z[0, 0] = 1
    return z


def _ints(t: torch.Tensor):
    """Limb-major int32[L, n] 16-bit limbs → n Python ints."""
    x = to_numpy_u32(t).astype(object)
    return [sum(int(x[l, i]) << (16 * l) for l in range(x.shape[0])) for i in range(x.shape[1])]


def _verdict(fn, *args):
    return tuple(int(x) for x in fn(*args))


@pytest.mark.parametrize("n_chunks", [1, 4, 16])
def test_chunked_eval_matches_reference_and_monolithic(n_chunks):
    r1cs, z, _zc, want = _small()
    be = get_backend(SCALAR)
    _eq(_np(rc.r1cs_eval(be, rc.DeviceR1CS.from_r1cs(r1cs, device="cpu"), _t(z))), want)
    ref_fn, ref_prep = ref.build_row_chunked_eval(r1cs, n_chunks)
    ev, prep = rc.build_row_chunked_eval(r1cs, n_chunks, device="cpu")
    assert ev._layout_meta == ref_fn._layout_meta and ev._semi_ok == ref_fn._semi_ok
    got = _np(ev(_t(z), prep))
    _eq(got, want)
    _eq(got, jax.jit(ref_fn)(jnp.asarray(z), ref_prep))


def test_violation_mask_matches_reference():
    r1cs, z, zc, _ = _small()
    zb = zc.copy()
    zb[33 + 5, 0] ^= 1
    d, rd = rc.DeviceR1CS.from_r1cs(r1cs, device="cpu"), ref.DeviceR1CS.from_r1cs(r1cs)
    for zz in (z, zc, zb):
        got = rc.violation_mask(get_backend(SCALAR), d, _t(zz)).numpy()
        assert (got == np.asarray(ref.violation_mask(ref_backend(SCALAR), rd, jnp.asarray(zz)))).all()
    assert got.sum() == 1 and got[5]


@functools.lru_cache(maxsize=None)
def _zero_coeff_system():
    """tests/test_row_chunked.py::test_premul_on_off_parity's system: a
    zero coefficient appended to the table and 8 of A's entries on it."""
    rng = np.random.default_rng(17)
    r0, z = test_row_chunked._synthetic(seed=17)
    cids = np.asarray(r0.a.coeff_ids).copy()
    cids[rng.integers(0, len(cids), size=8)] = 4
    r1cs = R1CS(field=SCALAR, num_inputs=r0.num_inputs, num_aux=r0.num_aux, num_constraints=r0.num_constraints,
                a=COOMatrix(rows=r0.a.rows, cols=r0.a.cols, coeff_ids=cids), b=r0.b, c=r0.c,
                coeff_table=list(r0.coeff_table) + [0])
    ref_fn, ref_prep = ref.build_row_chunked_eval(r1cs, 4, premul_table=True)
    return r1cs, np.asarray(z), [np.asarray(x) for x in jax.jit(ref_fn)(z, ref_prep)]


@pytest.mark.parametrize("premul", [False, True])
def test_premul_on_off_matches_reference(premul):
    r1cs, z, want = _zero_coeff_system()
    ev, prep = rc.build_row_chunked_eval(r1cs, 4, premul_table=premul, device="cpu")
    assert ev._layout_meta["premul"] is premul
    assert ("src" in prep["a"]) is premul and ("mask" in prep["a"]) is premul  # zero entries masked
    _eq(_np(ev(_t(z), prep)), want)


def _skewed():
    """tests/test_row_chunked.py's skewed system: row 0 of A holds 41
    entries, the others 1."""
    rng = np.random.default_rng(23)
    R, N0 = 64, 32
    rows_a = np.concatenate([np.zeros(40, np.int32), np.arange(R, dtype=np.int32)])
    a = COOMatrix(rows=np.sort(rows_a), cols=rng.integers(1, N0, size=len(rows_a)).astype(np.int32),
                  coeff_ids=rng.integers(0, 4, size=len(rows_a)).astype(np.int32))
    rows = np.arange(R, dtype=np.int32)
    b = COOMatrix(rows=rows.copy(), cols=rng.integers(1, N0, size=R).astype(np.int32),
                  coeff_ids=np.zeros(R, np.int32))
    c = COOMatrix(rows=rows.copy(), cols=(N0 + 1 + rows).astype(np.int32), coeff_ids=np.zeros(R, np.int32))
    r1cs = R1CS(field=SCALAR, num_inputs=1, num_aux=N0 + R, num_constraints=R, a=a, b=b, c=c,
                coeff_table=[1, 2, (1 << 17) % SCALAR.p, SCALAR.p - 1])
    z = np.random.default_rng(5).integers(0, 1 << 16, size=(1 + N0 + R, 16)).astype(np.uint32)
    z[0] = 0
    z[0, 0] = 1
    return r1cs, z


def test_skewed_rows_fall_back_to_segment_sum():
    r1cs, z = _skewed()
    want = ref.r1cs_eval(ref_backend(SCALAR), ref.DeviceR1CS.from_r1cs(r1cs), jnp.asarray(z))
    ev, prep = rc.build_row_chunked_eval(r1cs, 4, device="cpu")
    assert ev._layout_meta["modes"]["a"] == ("seg",) and "lrow" in prep["a"]
    assert ev._layout_meta == ref.build_row_chunked_eval(r1cs, 4)[0]._layout_meta
    _eq(_np(ev(_t(z), prep)), want)
    ref_check, ref_prep = ref.build_row_chunked_check(r1cs, 4)
    want = _verdict(jax.jit(ref_check), jnp.asarray(z), ref_prep)
    for route in (None, False):
        check, cprep = rc.build_row_chunked_check(r1cs, 4, use_pallas=route, device="cpu")
        assert check._route == "canonical"  # a segment-sum matrix has no semi blocks
        assert _verdict(check, _t(z), cprep) == want


@functools.lru_cache(maxsize=None)
def _semi_system(identity_c: bool, R: int = 1 << 10):
    r1cs, z, _be = test_row_chunked_semi._synthetic(R=R, identity_c=identity_c)
    return r1cs, np.asarray(z)


def test_semi_carry_is_one_carry_pass():
    """_carry16_semi against the reference's 16 dependent carry steps on
    limbs below 2^26, with runs of 0xFFFF and 2^16 that carry through
    many positions."""
    rng = np.random.default_rng(41)
    n = 4096
    cases = [rng.integers(0, 1 << 26, size=(n, 16)), rng.integers(0, 1 << 17, size=(n, 16)),
             rng.choice([0, 0xFFFE, 0xFFFF, 0x10000, 0x1FFFF, 0x2FFFE, (1 << 26) - 1], size=(n, 16))]
    chain = np.full((n, 16), 0xFFFF)
    chain[:, 0] = rng.integers(0, 1 << 26, size=n)
    for x in cases + [chain]:
        xt = torch.from_numpy(x.astype(np.int32))
        want, carry = [], 0
        for i in range(16):
            tot = x[:, i] + carry
            want.append(tot & 0xFFFF)
            carry = tot >> 16
        want.append(carry)
        np.testing.assert_array_equal(rc._carry16_semi(xt).numpy(), np.stack(want))


def test_slice_mode_and_semi_blocks_match_reference():
    """Slice mode for the identity C; every chunk's semi blocks equal the
    reference's array for array, and name the canonical blocks' values
    mod p, on the satisfied witness and on raw 16-bit limbs."""
    r1cs, z = _semi_system(True)
    ev, prep = rc.build_row_chunked_eval(r1cs, 4, device="cpu")
    ref_fn, ref_prep = ref.build_row_chunked_eval(r1cs, 4)
    assert ev._semi_ok and ev._layout_meta == ref_fn._layout_meta
    assert ev._layout_meta["modes"]["c"] == ("slice", (1 << 8) + 1) and set(prep["c"]) == {"start"}
    semi_ref = jax.jit(lambda zz, xs: ref_fn._blocks_semi(ref_fn._zsrc(zz, ref_prep["coeff_limbs"]),
                                                          ref_prep["coeff_limbs"], xs, NAMES))
    xs_ref = ref_fn._xs(ref_prep, NAMES)
    z_raw = np.random.default_rng(123).integers(0, 1 << 16, size=z.shape).astype(np.uint32)
    for zz in (z, z_raw):
        cl = prep["coeff_limbs"]
        zsrc = ev._zsrc(_t(zz), cl)
        xs = ev._xs(prep, NAMES)
        for k in range(4):
            semis = ev._blocks_semi(zsrc, cl, rc._chunk(xs, k), NAMES)
            cans = ev._blocks(zsrc, cl, rc._chunk(xs, k), NAMES)
            _eq(_np(semis), semi_ref(jnp.asarray(zz), jax.tree.map(lambda a: a[k], xs_ref)))
            for semi, can in zip(semis, cans):
                vals = _ints(can)
                assert all(v < P for v in vals)
                assert [v % P for v in _ints(semi)] == vals


def test_non_contiguous_c_is_not_slice_mode_and_checks_clean():
    r1cs, z = _semi_system(False)
    ev, prep = rc.build_row_chunked_eval(r1cs, 4, device="cpu")
    assert "start" not in prep["c"] and ev._layout_meta["modes"]["c"] == ("ell", 1, True)
    zb = z.copy()
    zb[5, 0] ^= 1
    ref_check, ref_prep = ref.build_row_chunked_check(r1cs, 4)
    for route in (None, False):
        check, cprep = rc.build_row_chunked_check(r1cs, 4, use_pallas=route, device="cpu")
        assert _verdict(check, _t(z), cprep) == (0, SENT)
        assert _verdict(check, _t(zb), cprep) == _verdict(jax.jit(ref_check), jnp.asarray(zb), ref_prep)


def test_product_with_and_without_reuse_matches_reference():
    r1cs, z = _semi_system(True)
    ref_fn, ref_prep = ref.build_row_chunked_product(r1cs, 8)
    want = np.asarray(jax.jit(ref_fn)(jnp.asarray(z), ref_prep))
    check, prep = rc.build_row_chunked_check(r1cs, 4, device="cpu")
    prod_r, prep_r = rc.build_row_chunked_product(r1cs, 8, reuse=(check._layout_meta, prep), device="cpu")
    assert prep_r["a"] is prep["a"] and prep_r["b"] is prep["b"]
    assert prep_r["coeff_limbs"] is prep["coeff_limbs"]
    prod_f, prep_f = rc.build_row_chunked_product(r1cs, 8, device="cpu")
    assert prod_f._layout_meta == ref_fn._layout_meta
    for fn, pp in ((prod_r, prep_r), (prod_f, prep_f)):
        np.testing.assert_array_equal(to_numpy_u32(fn(_t(z), pp)), want)
    assert _verdict(check, _t(z), prep) == (0, SENT)


@pytest.mark.parametrize("use_pallas", [None, True, False])
def test_check_routes_match_reference(use_pallas):
    """Both routes' (n_bad, first) equal the reference's on the completed
    witness, with the product of row 37 flipped, and on the raw z (every
    row's product unknown)."""
    r1cs, z, zc, _ = _small()
    zb = zc.copy()
    zb[33 + 37, 0] ^= 1
    ref_check, ref_prep = ref.build_row_chunked_check(r1cs, 4)
    check, prep = rc.build_row_chunked_check(r1cs, 4, use_pallas=use_pallas, device="cpu")
    assert check._route == ("canonical" if use_pallas is False else "semi")
    got = [_verdict(check, _t(zz), prep) for zz in (zc, zb, z)]
    assert got == [_verdict(jax.jit(ref_check), jnp.asarray(zz), ref_prep) for zz in (zc, zb, z)]
    assert got[:2] == [(0, SENT), (1, 37)]


def test_semi_route_chunk_matches_pallas_mulcmp_interpret():
    """One chunk of R = 4,096 (rpc 1,024, one TILE): the port's semi
    blocks and mulcmp mask equal the reference's blocks and its Pallas
    mulcmp (interpret mode), with two of the chunk's products flipped."""
    from bellpepper_tpu.backend.field_pallas import make_mulcmp

    r1cs, z = _semi_system(True, R=4096)
    zb = z.copy()
    for row in (3, 700):
        zb[(1 << 8) + 1 + row, 0] ^= 1
    ref_fn, ref_prep = ref.build_row_chunked_eval(r1cs, 4)
    cl = ref_prep["coeff_limbs"]
    xs0 = jax.tree.map(lambda a: a[0], ref_fn._xs(ref_prep, NAMES))
    ref_blocks = ref_fn._blocks_semi(ref_fn._zsrc(jnp.asarray(zb), cl), cl, xs0, NAMES)
    want = np.asarray(make_mulcmp(SCALAR, interpret=True)(*ref_blocks)) != 0
    ev, prep = rc.build_row_chunked_eval(r1cs, 4, device="cpu")
    blocks = ev._blocks_semi(ev._zsrc(_t(zb), prep["coeff_limbs"]), prep["coeff_limbs"],
                             rc._chunk(ev._xs(prep, NAMES), 0), NAMES)
    _eq(_np(blocks), ref_blocks)
    got = mulcmp(*blocks, SCALAR).numpy() != 0
    assert (got == want).all() and np.nonzero(got)[0].tolist() == [3, 700]
    check, cprep = rc.build_row_chunked_check(r1cs, 4, device="cpu")
    assert _verdict(check, _t(zb), cprep) == (2, 3)


@pytest.mark.parametrize("premul", [None, False])
def test_witness_in_p_to_2_256_matches_reference(premul):
    """Every witness value in [p, 2^256): the evaluation (against the
    reference's monolithic r1cs_eval), the product (against its chunked
    product) and both routes' verdicts (against its check)."""
    r1cs, _z, _zc, _ = _small()
    z = _non_canonical((r1cs.num_inputs + r1cs.num_aux, 16), 29)
    zj = jnp.asarray(z)
    be = ref_backend(SCALAR)
    want = ref.r1cs_eval(be, ref.DeviceR1CS.from_r1cs(r1cs), zj)
    ev, prep = rc.build_row_chunked_eval(r1cs, 4, premul_table=premul, device="cpu")
    _eq(_np(ev(_t(z), prep)), want)
    ref_prod, ref_pprep = ref.build_row_chunked_product(r1cs, 4, premul_table=premul)
    prod, pprep = rc.build_row_chunked_product(r1cs, 4, premul_table=premul, device="cpu")
    pz = prod(_t(z), pprep)
    np.testing.assert_array_equal(to_numpy_u32(pz), np.asarray(jax.jit(ref_prod)(zj, ref_pprep)))
    zc = _t(z)
    zc[33:] = pz
    ref_check, ref_cprep = ref.build_row_chunked_check(r1cs, 4, premul_table=premul)
    for route in (None, False):
        check, cprep = rc.build_row_chunked_check(r1cs, 4, premul_table=premul, use_pallas=route, device="cpu")
        for zz in (_t(z), zc):
            assert _verdict(check, zz, cprep) == _verdict(jax.jit(ref_check), jnp.asarray(to_numpy_u32(zz)),
                                                          ref_cprep)
        assert _verdict(check, zc, cprep) == (0, SENT)


def test_zero_constraint_system():
    e = COOMatrix(rows=np.zeros(0, np.int64), cols=np.zeros(0, np.int64), coeff_ids=np.zeros(0, np.int64))
    r0 = R1CS(field=SCALAR, num_inputs=1, num_aux=3, num_constraints=0, a=e, b=e, c=e, coeff_table=[1])
    z = from_numpy_u32(get_backend(SCALAR).to_limbs([1, 5, 6, 7]), "cpu")
    ref_check, ref_prep = ref.build_row_chunked_check(r0, 1)
    for route in (None, False):
        check, prep = rc.build_row_chunked_check(r0, 1, use_pallas=route, device="cpu")
        assert _verdict(check, z, prep) == _verdict(ref_check, jnp.asarray(to_numpy_u32(z)), ref_prep) == (0, SENT)
    prod, prep = rc.build_row_chunked_product(r0, 1, device="cpu")
    assert prod(z, prep).shape == (0, 16)
    ev, prep = rc.build_row_chunked_eval(r0, 1, device="cpu")
    assert [tuple(x.shape) for x in ev(z, prep)] == [(0, 16)] * 3


def test_every_error_is_raised_as_the_reference_raises_it():
    """Chunks that do not divide R, a z of the wrong row count, a row over
    MAX_ROW_NNZ (ValueError); a reused segment-sum layout and a reused
    layout without the matrices asked for (assert)."""
    r1cs, z, _zc, _ = _small()
    for n in (0, 3, -4):
        for build in (rc.build_row_chunked_eval, rc.build_row_chunked_check, rc.build_row_chunked_product):
            with pytest.raises(ValueError, match="evenly divide"):
                build(r1cs, n, device="cpu")
        with pytest.raises(ValueError, match="evenly divide"):
            ref.build_row_chunked_eval(r1cs, n)
    for route in (None, False):
        check, prep = rc.build_row_chunked_check(r1cs, 4, use_pallas=route, device="cpu")
        with pytest.raises(ValueError, match="expected num_inputs"):
            check(_t(z[:-1]), prep)
        with pytest.raises(ValueError, match="int32"):
            check(_t(z).to(torch.int64), prep)
    with pytest.raises(ValueError, match="expected num_inputs"):
        ref.build_row_chunked_eval(r1cs, 4)[0]._zsrc(jnp.asarray(z[:-1]), None)
    dense = rc.MAX_ROW_NNZ + 1
    big = COOMatrix(rows=np.zeros(dense, np.int32), cols=np.ones(dense, np.int32), coeff_ids=np.zeros(dense, np.int32))
    rows = np.arange(64, dtype=np.int32)
    one = COOMatrix(rows=rows, cols=np.ones(64, np.int32), coeff_ids=np.zeros(64, np.int32))
    rd = R1CS(field=SCALAR, num_inputs=1, num_aux=1, num_constraints=64, a=big, b=one, c=one, coeff_table=[1])
    for build in (functools.partial(rc.build_row_chunked_eval, device="cpu"), ref.build_row_chunked_eval):
        with pytest.raises(ValueError, match="entries"):
            build(rd, 4)
    for build in (functools.partial(rc.DeviceR1CS.from_r1cs, device="cpu"), ref.DeviceR1CS.from_r1cs):
        with pytest.raises(ValueError, match="entries"):
            build(rd)
    rs, _z = _skewed()
    check, prep = rc.build_row_chunked_check(rs, 4, device="cpu")
    with pytest.raises(AssertionError, match="chunk-count-specific"):
        rc.build_row_chunked_product(rs, 8, reuse=(check._layout_meta, prep), device="cpu")
    prod, pprep = rc.build_row_chunked_product(r1cs, 4, device="cpu")
    with pytest.raises(AssertionError, match="lacks matrices"):
        rc.build_row_chunked_check(r1cs, 4, reuse=(prod._layout_meta, pprep), device="cpu")
