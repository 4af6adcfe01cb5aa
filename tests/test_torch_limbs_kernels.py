"""The limbs form's kernels' plain versions against the JAX package's
Pallas kernels in interpret mode, bit for bit: fold_digit_table for the
three fields; limbs_matvec (semi and canonical) against
make_limbs_matvec_bucket at tests/test_fused_limbs.py's shapes and at the
2064-wide bound with every digit at its largest; mul_digits and
reduce_digits against PallasFieldOps(interpret=True) at N = 1024 for
SCALAR and a pasta field, corner values included. The CPU wrappers'
dispatch and input checks are in test_torch_kernels.py."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from bellpepper_tpu.backend import field_pallas as ref_fp
from bellpepper_tpu.fields import FIELDS, PALLAS_SCALAR, SCALAR
from bellpepper_tpu_torch.backend import field_consts, field_kernels as fk, layout
from bellpepper_tpu_torch.backend.words import from_numpy_u32, to_numpy_u32

from test_torch_mixed import _one_torch_thread  # noqa: F401  (autouse)

RNG = np.random.default_rng(0x5EED_000A)
P = SCALAR.p


def _limbs16(v):
    return [(v >> (16 * l)) & 0xFFFF for l in range(16)]


@pytest.mark.parametrize("field", list(FIELDS.values()), ids=lambda f: f.name)
def test_fold_digit_table_matches_reference(field):
    p = field.p
    coeffs = [0, 1, 2, p - 1, p - 2, p, (1 << 200) % p, int(RNG.integers(1, 1 << 62))]
    coeffs += [random.Random(k).randrange(p) for k in range(8)]
    got = field_consts.fold_digit_table(field, coeffs)
    assert got.dtype == np.uint32 and got.shape == (len(coeffs), 32, 32)
    assert (got == ref_fp.fold_digit_table(field, coeffs)).all()


# --- the kernels' plain versions -----------------------------------------------
@pytest.mark.parametrize(
    "K,n_rows,B,out_form,top",
    [(1, 8, 128, "semi", False), (2, 16, 128, "semi", False), (4, 8, 256, "semi", False),
     (4, 8, 256, "canonical", False), (layout.MAX_FUSED_LIMBS_K, 8, 128, "semi", True)],
    ids=["K1", "K2", "K4", "K4-canonical", "K2064-top"],
)
def test_limbs_matvec_plain_matches_pallas(K, n_rows, B, out_form, top):
    """Random digits and fold planes; at the 2064-wide bound the first
    rows hold 255 everywhere, so the digit sums reach 66048·255² and the
    carries wrap 32 bits as the TPU's do."""
    assert layout.MAX_FUSED_LIMBS_K == ref_fp.MAX_FUSED_LIMBS_K
    x = RNG.integers(0, 256, size=(n_rows, 32 * K, B)).astype(np.uint32)
    F = RNG.integers(0, 256, size=(32, n_rows, 32 * K)).astype(np.uint32)
    if top:
        x[:2] = 255
        F[:, :2] = 255
    kern = ref_fp.make_limbs_matvec_bucket(SCALAR, K, n_rows, B, interpret=True, out_form=out_form)
    want = np.asarray(kern(jnp.asarray(x), jnp.asarray(F)))
    got = fk.limbs_matvec(from_numpy_u32(x), from_numpy_u32(F), SCALAR, out_form)
    assert got.shape == ((17 if out_form == "semi" else 16), n_rows, B)
    assert (to_numpy_u32(got) == want).all()
    if not top:  # and the limbs are Σ c·z mod p as Python ints
        for r, b in ((0, 0), (n_rows - 1, B - 1)):
            val = sum(int(want[l, r, b]) << (16 * l) for l in range(want.shape[0]))
            exact = sum(int(F[d, r, c]) * int(x[r, c, b]) << (8 * d) for d in range(32) for c in range(32 * K))
            assert val % P == exact % P and (out_form == "semi" or val < P)


@pytest.mark.parametrize("field", [SCALAR, PALLAS_SCALAR], ids=lambda f: f.name)
def test_mul_digits_and_reduce_digits_plain_match_pallas(field):
    """N = 1024: corner products of 0, 1 and p − 1, random canonical
    operands; digit sums of 2^24 − 1 everywhere, zeros, 1s and random
    sums below 2^24."""
    p, N = field.p, 1024
    ops = ref_fp.PallasFieldOps(field, interpret=True)
    rnd = random.Random(11)
    av = [0, 1, p - 1] * 3 + [rnd.randrange(p) for _ in range(N - 9)]
    bv = [v for v in (0, 1, p - 1) for _ in range(3)] + [rnd.randrange(p) for _ in range(N - 9)]
    a = np.asarray([_limbs16(v) for v in av], np.uint32).T.copy()
    b = np.asarray([_limbs16(v) for v in bv], np.uint32).T.copy()
    want = np.asarray(ops.mul_digits(jnp.asarray(a), jnp.asarray(b)))
    got = to_numpy_u32(fk.mul_digits(from_numpy_u32(a), from_numpy_u32(b), field))
    assert got.shape == (32, N) and (got == want).all()
    assert [sum(int(got[j, i]) << (8 * j) for j in range(32)) for i in range(12)] == [
        x * y % p for x, y in zip(av[:12], bv[:12])
    ]
    d = RNG.integers(0, 1 << 24, size=(32, N)).astype(np.uint32)
    d[:, 0] = (1 << 24) - 1
    d[:, 1] = 0
    d[:, 2] = 1
    want = np.asarray(ops.reduce_digits(jnp.asarray(d)))
    got = to_numpy_u32(fk.reduce_digits(from_numpy_u32(d), field))
    assert got.shape == (16, N) and (got == want).all()
    for i in range(4):
        val = sum(int(got[l, i]) << (16 * l) for l in range(16))
        assert val == sum(int(d[j, i]) << (8 * j) for j in range(32)) % p
