"""The port's field arithmetic against the JAX package and Python ints:
``field_backend`` against ``field_jnp.FieldBackend``; the torch row
helpers of the 16-bit multiply pipeline against the Pallas kernels' jnp
row helpers; ``mul_plain`` against ``FieldBackend.mul``; ``chain_plain``
against ``make_chain_kernel(interpret=True)`` on fadd-only patterns
(interpret-mode fmul bodies take about a minute each on the CPU,
tests/test_chain_kernel.py:6-13) and against Python-int recurrences on
fmul patterns. Every comparison is bit-exact as uint32."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellpepper_tpu.backend import field_pallas as ref_fp
from bellpepper_tpu.backend.field_jnp import get_backend as ref_backend
from bellpepper_tpu.fields import PALLAS_SCALAR, SCALAR, VESTA_SCALAR
from bellpepper_tpu_torch.backend import field_kernels as fk
from bellpepper_tpu_torch.backend.field_backend import FieldBackend, get_backend
from bellpepper_tpu_torch.backend.field_consts import consts_for
from bellpepper_tpu_torch.backend.words import from_numpy_u32, to_numpy_u32, to_u32

RNG = np.random.default_rng(0x5EED_0007)
FIELDS3 = [SCALAR, PALLAS_SCALAR, VESTA_SCALAR]


def _values(field, n, seed):
    """Corner values (0, 1, 2, p − 1, p − 2, 2^k) then uniform ones."""
    p = field.p
    rnd = random.Random(seed)
    corners = [0, 1, 2, p - 1, p - 2, 1 << 128, (1 << 254) % p, (p - 1) // 2]
    return corners + [rnd.randrange(p) for _ in range(n - len(corners))]


def _limbs(field, values):
    """int32[N, 16] batch-major canonical limbs."""
    return from_numpy_u32(FieldBackend.to_limbs(values))


def _ints(t):
    return FieldBackend.from_limbs(t)


def test_host_conversions_match_reference():
    vals = _values(SCALAR, 40, 1)
    ref = ref_backend(SCALAR)
    assert (FieldBackend.to_limbs(vals) == ref.to_limbs(vals)).all()
    assert FieldBackend.from_limbs(ref.to_limbs(vals)) == ref.from_limbs(ref.to_limbs(vals)) == vals
    assert FieldBackend.from_limbs(_limbs(SCALAR, vals)) == vals


@pytest.mark.parametrize("field", FIELDS3, ids=lambda f: f.name)
def test_backend_matches_python_ints(field):
    p = field.p
    be = get_backend(field)
    a, b = _values(field, 48, 2), _values(field, 48, 3)[::-1]
    A, B = _limbs(field, a), _limbs(field, b)
    assert _ints(be.add(A, B)) == [(x + y) % p for x, y in zip(a, b)]
    assert _ints(be.sub(A, B)) == [(x - y) % p for x, y in zip(a, b)]
    assert _ints(be.neg(A)) == [(-x) % p for x in a]
    assert _ints(be.mul(A, B)) == [x * y % p for x, y in zip(a, b)]
    assert _ints(be.square(A)) == [x * x % p for x in a]
    assert _ints(be.pow_const(A, 0)) == [1] * len(a)
    assert _ints(be.pow_const(A, 77)) == [pow(x, 77, p) for x in a]
    assert be.eq(A, A).all() and not be.eq(A, B)[1:].any()
    assert be.is_zero(A).tolist() == [x == 0 for x in a]
    # the limb axis elsewhere: [W, 16, B] as the witness evaluator holds it
    At = A.t().reshape(1, 16, -1)
    Bt = B.t().reshape(1, 16, -1)
    assert _ints(be.mul(At, Bt, dim=1).transpose(1, 2)) == [x * y % p for x, y in zip(a, b)]
    assert _ints(be.add(At, Bt, dim=1).transpose(1, 2)) == [(x + y) % p for x, y in zip(a, b)]


def test_backend_matches_field_jnp():
    """add, sub, neg, mul and inv against field_jnp.FieldBackend (inv:
    the Fermat ladder, zero maps to zero)."""
    p = SCALAR.p
    be, ref = get_backend(SCALAR), ref_backend(SCALAR)
    a, b = _values(SCALAR, 24, 4), _values(SCALAR, 24, 5)
    A, B = _limbs(SCALAR, a), _limbs(SCALAR, b)
    rA, rB = jnp.asarray(ref.to_limbs(a)), jnp.asarray(ref.to_limbs(b))
    for got, want in (
        (be.add(A, B), ref.add(rA, rB)),
        (be.sub(A, B), ref.sub(rA, rB)),
        (be.neg(A), ref.neg(rA)),
        (be.mul(A, B), ref.mul(rA, rB)),
        (be.inv(A), ref.inv(rA)),
    ):
        assert (to_numpy_u32(got) == np.asarray(want)).all()
    assert _ints(be.inv(A)) == [pow(x, p - 2, p) for x in a]


def _layout(t, layout):
    """[n, 16] limbs as the layout under test: the limb axis last, or in
    dim 1 of [W, 16, B] as the witness evaluator holds it (W = 2)."""
    return t if layout == "last" else t.reshape(2, -1, 16).transpose(1, 2)


def _back(t, layout):
    return t if layout == "last" else t.transpose(1, 2).reshape(-1, 16)


_LADDER_REF = {}


def _ladder_ref(field, a, b):
    """field_jnp's mul, square, inv, pow_const(0xD201) and pow_const(1) of
    a and b (computed once a field: both layouts compare with them)."""
    if field.p not in _LADDER_REF:
        ref = ref_backend(field)
        rA, rB = jnp.asarray(ref.to_limbs(a)), jnp.asarray(ref.to_limbs(b))
        _LADDER_REF[field.p] = [np.asarray(r) for r in (
            ref.mul(rA, rB), ref.square(rA), ref.inv(rA), ref.pow_const(rA, 0xD201), ref.pow_const(rA, 1))]
    return _LADDER_REF[field.p]


@pytest.mark.parametrize("layout", ["last", "dim1"])
@pytest.mark.parametrize("field", FIELDS3, ids=lambda f: f.name)
def test_backend_mul_ladder_matches_field_jnp(field, layout):
    """mul, square, inv and pow_const, which run through fk.mul and
    fk.pow_ladder, against field_jnp.FieldBackend and Python ints, bit-exact,
    with the limb axis last ([n, 16]) and in dim 1 ([W, 16, B]). The values
    start with the corners 0, 1, 2, p − 1 and p − 2; inv(0) is 0."""
    p = field.p
    be = get_backend(field)
    a, b = _values(field, 32, 40), _values(field, 32, 41)[::-1]
    dim = -1 if layout == "last" else 1
    A, B = _layout(_limbs(field, a), layout), _layout(_limbs(field, b), layout)
    got = (be.mul(A, B, dim), be.square(A, dim), be.inv(A, dim), be.pow_const(A, 0xD201, dim),
           be.pow_const(A, 1, dim))
    ints = ([x * y % p for x, y in zip(a, b)], [x * x % p for x in a], [pow(x, p - 2, p) for x in a],
            [pow(x, 0xD201, p) for x in a], a)
    for g, want, want_ints in zip(got, _ladder_ref(field, a, b), ints):
        assert g.shape == A.shape and g.dtype == torch.int32 and g.is_contiguous()
        flat = _back(g, layout)
        assert (to_numpy_u32(flat) == want).all()
        assert _ints(flat) == want_ints
    assert a[0] == 0 and _ints(_back(got[2], layout))[0] == 0


@pytest.mark.parametrize("field", FIELDS3, ids=lambda f: f.name)
def test_backend_multiplies_through_the_mul_wrapper(field, monkeypatch):
    """Every multiply of FieldBackend is one fk.mul or one step of
    fk.pow_ladder: mul and square one product each (broadcasting a single
    row against a batch), inv one product a squaring and one a set bit of
    p − 2 after the top one. On the CPU each product is one mul_plain, so
    counting mul_plain counts what the card launches."""
    p = field.p
    be = get_backend(field)
    calls = []
    plain = fk.mul_plain

    def counted(a, b, f):
        calls.append(a.shape)
        return plain(a, b, f)

    monkeypatch.setattr(fk, "mul_plain", counted)
    a = _values(field, 12, 50)
    A = _limbs(field, a)
    one = _limbs(field, [p - 2])
    assert _ints(be.mul(one, A)) == [(p - 2) * x % p for x in a] and len(calls) == 1
    assert _ints(be.square(A)) == [x * x % p for x in a] and len(calls) == 2
    assert calls == [(16, 12)] * 2
    del calls[:]
    e = p - 2
    assert _ints(be.inv(A)) == [pow(x, e, p) for x in a]
    assert len(calls) == e.bit_length() - 1 + bin(e).count("1") - 1


def test_pow_ladder_checks_its_inputs():
    x = torch.zeros((16, 4), dtype=torch.int32)
    for bits in ([], [0, 1]):
        with pytest.raises(ValueError):
            fk.pow_ladder(x, bits, SCALAR)
    with pytest.raises(ValueError):
        fk.pow_ladder(x[:8].contiguous(), [1], SCALAR)
    with pytest.raises(TypeError):
        fk.pow_ladder(x.long(), [1], SCALAR)
    assert torch.equal(fk.pow_ladder(x, [1], SCALAR), x)
    assert fk.pow_ladder(x, [1], SCALAR) is not x


def test_backend_refuses_unsupported_fields():
    """A field above 255 bits is refused (add and sub keep a + b < 2p below
    2^256). A 127-bit field, refused until the word tail took every
    field, multiplies, squares and inverts as the reference's backend and
    Python ints do."""
    from bellpepper_tpu.fields import PrimeField as RefPrimeField
    from bellpepper_tpu_torch.fields import PrimeField

    with pytest.raises(ValueError):
        FieldBackend(PrimeField("p256", (1 << 256) - 189))
    p = 2**127 - 1
    be, ref = FieldBackend(PrimeField("small", p)), ref_backend(RefPrimeField("small", p))
    rnd = random.Random(6)
    a = [0, 1, 2, p - 1, p - 2, 1 << 126, (p - 1) // 2] + [rnd.randrange(p) for _ in range(25)]
    b = a[::-1]
    A, B = _limbs(None, a), _limbs(None, b)
    rA, rB = jnp.asarray(ref.to_limbs(a)), jnp.asarray(ref.to_limbs(b))
    assert _ints(be.mul(A, B)) == [x * y % p for x, y in zip(a, b)] == ref.from_limbs(np.asarray(ref.mul(rA, rB)))
    assert _ints(be.square(A)) == [x * x % p for x in a]
    assert _ints(be.inv(A)) == [pow(x, p - 2, p) for x in a] == ref.from_limbs(np.asarray(ref.inv(rA)))


# --- the row helpers ---------------------------------------------------------
def _rand_rows(n, width, high):
    return RNG.integers(0, high, size=(n, width), dtype=np.uint64).astype(np.uint32)


def _both(rows_u32):
    """The same rows as torch int64 rows and jnp uint32 rows."""
    return (
        [torch.from_numpy(r.astype(np.int64)) for r in rows_u32],
        [jnp.asarray(r) for r in rows_u32],
    )


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.numpy().astype(np.uint32) == np.asarray(w)).all()
        assert int(g.min()) >= 0 and int(g.max()) < 1 << 32


@pytest.mark.parametrize("field", FIELDS3, ids=lambda f: f.name)
def test_row_helpers_match_pallas_rows(field):
    c, rc = consts_for(field), ref_fp._Consts(field)
    a, ra = _both(_rand_rows(16, 257, 1 << 16))
    b, rb = _both(_rand_rows(16, 257, 1 << 16))
    conv, rconv = fk._conv16_rows(a, b), ref_fp._conv16_rows(ra, rb)
    _assert_rows_equal(conv, rconv)
    d, rd = fk._carry16_rows(conv, 32), ref_fp._carry16_rows(rconv, 32)
    _assert_rows_equal(d, rd)
    _assert_rows_equal(fk._fold1_split(d, c, 16), ref_fp._fold1_split(rd, rc, 16))
    # 34 positions folded with 18 rows, as mulcmp does
    d34, rd34 = _both(_rand_rows(34, 257, 1 << 16))
    _assert_rows_equal(fk._fold1_split(d34, c, 18), ref_fp._fold1_split(rd34, rc, 18))
    # x < 2^266 into the canonical tail
    x = _rand_rows(17, 257, 1 << 16)
    x[16] &= 0x3FF
    xt, rx = _both(x)
    _assert_rows_equal(fk._canon_tail_v2(xt, c), ref_fp._canon_tail_v2(rx, rc))
    _assert_rows_equal(fk._reduce16_rows(conv, c), ref_fp._reduce16_rows(rconv, rc))
    # canonical + canonical
    vals = [_values(field, 257, s) for s in (6, 7)]
    ca, rca = _both(FieldBackend.to_limbs(vals[0]).T.copy())
    cb, rcb = _both(FieldBackend.to_limbs(vals[1]).T.copy())
    _assert_rows_equal(fk._add_canon_rows(ca, cb, c), ref_fp._add_canon_rows(rca, rcb, rc))


# --- mul ---------------------------------------------------------------------
@pytest.mark.parametrize("field", FIELDS3, ids=lambda f: f.name)
def test_mul_plain_matches_python_ints(field):
    p = field.p
    a, b = _values(field, 300, 8), _values(field, 300, 9)
    # every corner against every corner in the first columns
    corners = a[:8]
    a[:64] = [x for x in corners for _ in corners]
    b[:64] = [y for _ in corners for y in corners]
    A, B = _limbs(field, a).t().contiguous(), _limbs(field, b).t().contiguous()
    got = fk.mul(A, B, field)
    assert torch.equal(got, fk.mul_plain(A, B, field))
    assert _ints(got.t()) == [x * y % p for x, y in zip(a, b)]


def test_mul_plain_matches_field_jnp_mul():
    ref = ref_backend(SCALAR)
    a, b = _values(SCALAR, 128, 10), _values(SCALAR, 128, 11)
    got = fk.mul_plain(_limbs(SCALAR, a).t().contiguous(), _limbs(SCALAR, b).t().contiguous(), SCALAR)
    want = ref.mul(jnp.asarray(ref.to_limbs(a)), jnp.asarray(ref.to_limbs(b)))
    assert (to_numpy_u32(got.t()) == np.asarray(want)).all()


# --- chain -------------------------------------------------------------------
def _lm(field, values, n=None):
    """limb-major int32[16, n] (zero-padded)."""
    x = np.zeros((16, n or len(values)), np.uint32)
    x[:, : len(values)] = FieldBackend.to_limbs(values).T
    return from_numpy_u32(x)


def _col(t, i):
    v = to_u32(t)[:, i]
    return sum(int(v[l]) << (16 * l) for l in range(16))


@pytest.mark.parametrize(
    "descs,n_reps,n_ext",
    [((("fadd", "prev", 0),), 5, 1), ((("fadd", "prev", 0), ("fadd", 1, "prev")), 3, 2)],
    ids=["d1", "d2_two_ext"],
)
def test_chain_plain_matches_pallas_fadd(descs, n_reps, n_ext):
    """fadd-only chains at one TILE: the Pallas chain kernel in interpret
    mode against the plain version, every step's limbs."""
    N = ref_fp.TILE
    x0 = _values(SCALAR, N, 12)
    ext = [_values(SCALAR, N, 13 + k) for k in range(n_ext)]
    x0_t = _lm(SCALAR, x0)
    ext_t = torch.cat([_lm(SCALAR, e) for e in ext])
    run = ref_fp.make_chain_kernel(SCALAR, descs, n_reps, n_ext, interpret=True)
    want = np.asarray(run(jnp.asarray(to_numpy_u32(x0_t)), jnp.asarray(to_numpy_u32(ext_t))))
    got = fk.chain(x0_t, ext_t, descs, n_reps, SCALAR)
    assert got.shape == (n_reps * len(descs) * 16, N)
    assert (to_numpy_u32(got) == want).all()


@pytest.mark.parametrize("field", FIELDS3, ids=lambda f: f.name)
def test_chain_plain_config1_matches_python_ints(field):
    """x ← ((x·b + a) mod p)² mod p for 30 reps, the config-1 pattern as
    _detect_linear_chain gives it (ext 0 = b, ext 1 = a)."""
    p = field.p
    N = 64
    a, b, x0 = _values(field, N, 20), _values(field, N, 21), _values(field, N, 22)
    descs = (("fmul", "prev", 0), ("fadd", "prev", 1), ("fmul", "prev", "prev"))
    out = fk.chain(_lm(field, x0), torch.cat([_lm(field, b), _lm(field, a)]), descs, 30, field)
    assert out.shape == (30 * 3 * 16, N)
    for i in (0, 1, 2, 9, N - 1):
        x = x0[i]
        for r in range(30):
            m = x * b[i] % p
            s = (m + a[i]) % p
            x = s * s % p
            assert [_col(out[(3 * r + j) * 16 : (3 * r + j + 1) * 16], i) for j in range(3)] == [m, s, x]


def test_chain_split_gives_the_same_steps():
    """A chain run in two segments (the second starting from the first's
    last output) gives the steps of one run: the kernel needs no step cap,
    and a caller that splits changes nothing."""
    descs = (("fmul", 2, "prev"), ("fadd", "prev", 0), ("fmul", "prev", 1))
    x0 = _lm(SCALAR, _values(SCALAR, 40, 30))
    ext = torch.cat([_lm(SCALAR, _values(SCALAR, 40, 31 + k)) for k in range(3)])
    whole = fk.chain(x0, ext, descs, 7, SCALAR)
    first = fk.chain(x0, ext, descs, 3, SCALAR)
    second = fk.chain(first[-16:].contiguous(), ext, descs, 4, SCALAR)
    assert torch.equal(whole, torch.cat([first, second]))


def test_chain_code_packs_a_byte_a_position():
    """The kernel's pattern arguments: any external index the ext tensor
    holds, up to MAX_PATTERN positions, the same limits as on the CPU."""
    descs = (("fmul", 8, "prev"), ("fadd", "prev", "prev"), ("fmul", 0, 5))
    assert fk._chain_code(descs, 9) == (0b101, 0x00FF08, 0x05FFFF)
    assert fk.MAX_PATTERN == 8
    with pytest.raises(ValueError):
        fk._chain_code(descs, 8)


def test_chain_and_mul_check_their_inputs():
    x = torch.zeros((16, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        fk.chain(x, x, (("fsub", "prev", 0),), 2, SCALAR)
    with pytest.raises(ValueError):
        fk.chain(x, x, (("fadd", "prev", 1),), 2, SCALAR)  # one external only
    with pytest.raises(ValueError):
        fk.chain(x, x[:15].contiguous(), (("fadd", "prev", 0),), 2, SCALAR)
    with pytest.raises(ValueError):
        fk.chain(x, x, (("fadd", "prev", 0),) * 9, 2, SCALAR)
    with pytest.raises(TypeError):
        fk.mul(x.long(), x.long(), SCALAR)
    with pytest.raises(ValueError):
        fk.mul(x, x[:, :4].contiguous(), SCALAR)
    with pytest.raises(ValueError):
        fk.mul(x.to("meta"), x.to("meta"), SCALAR)
