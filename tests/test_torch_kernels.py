"""The three field kernels' plain PyTorch versions against the JAX
package's Pallas kernels run in interpret mode, at the packed sha256
path's shapes (small batch), bit-exact; the CPU wrappers' dispatch; and
the per-field kernel constants against the reference's."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellpepper_tpu.backend import field_pallas as ref_fp
from bellpepper_tpu.backend import matvec as ref_mv
from bellpepper_tpu.fields import FIELDS, PALLAS_SCALAR, SCALAR, VESTA_SCALAR
from bellpepper_tpu_torch import NativeBuilder, WitnessProgram
from bellpepper_tpu_torch.backend import field_consts, field_kernels as fk
from bellpepper_tpu_torch.backend import matvec as mv
from bellpepper_tpu_torch.backend.layout import _classify_pow2_eq_rows, _classify_small_rows
from bellpepper_tpu_torch.backend.words import from_numpy_u32, to_numpy_u32

RNG = np.random.default_rng(0x5EED_0003)


def _u32(shape):
    return RNG.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("field", list(FIELDS.values()), ids=lambda f: f.name)
def test_field_consts_match_reference(field):
    got = field_consts._Consts(field)
    ref = ref_fp._Consts(field)
    for name in ("p16", "fold", "fold16", "fold16_hi", "p2_17", "fold16b", "ps",
                 "p0inv", "qe"):
        assert getattr(got, name) == getattr(ref, name), name
    assert field_consts._digits(field.p, 16, 16) == ref_fp._digits(field.p, 16, 16)


# --- kernel 2: bitplane_eq -------------------------------------------------
@pytest.mark.parametrize(
    "n_pos,m_a,m_c",
    [(250, 7, 1), (24, 3, 2), (40, 4, 3)],
    ids=["sha256", "mc2", "mc3_wide"],
)
def test_bitplane_eq_plain_matches_pallas(n_pos, m_a, m_c):
    W = 512
    kern = ref_fp.make_bitplane_eq_kernel(n_pos, m_a, m_c, interpret=True, tile_w=512)
    P = fk.padded_positions(n_pos)
    assert P == kern.n_pos_padded
    A, C = _u32((m_a * P, W)), _u32((m_c * P, W))
    # a third of the columns equal: A's addends past the first zero and
    # C's first addend a copy of A's first, the other C addends zero
    A[P:, ::3] = 0
    C[:, ::3] = 0
    C[:P, ::3] = A[:P, ::3]
    want = np.asarray(kern(jnp.asarray(A), jnp.asarray(C)))
    got = fk.bitplane_eq_plain(from_numpy_u32(A), from_numpy_u32(C), P, m_a, m_c)
    assert (to_numpy_u32(got) == want).all()
    assert not want[::3].any() and want.any()


@pytest.fixture(scope="module")
def sha256_words():
    nb = NativeBuilder()
    bits = [nb.alloc_bit() for _ in range(512)]
    nb.sha256_compression(bits, nb.sha256_iv())
    template, tape = nb.finish()
    prog = WitnessProgram(tape)
    free = _u32((16, len(prog.free_slots)))
    return template, prog.build_packed("cpu")(from_numpy_u32(free))


def test_pow2_kernel_form_matches_adder_forms(sha256_words):
    """On the sha256 MultiEq rows (n_pos 250, m_a 7, m_c 1): the port's
    kernel form (gather + bitplane_eq) equals its adder form and the
    reference's adder and Pallas forms, on a valid witness, under
    corruption, and on random words."""
    template, vp = sha256_words
    _small, big_idx, _lay = _classify_small_rows(template)
    spec, rest = _classify_pow2_eq_rows(template, big_idx)
    assert len(spec["rows_orig"]) == 25 and spec["n_pos"] == 250
    assert spec["a_cols"].shape[2] == 7 and spec["c_cols"].shape[2] == 1
    assert len(rest) == 1

    def both(vals_bm):
        vals_p = vals_bm.t().contiguous()
        got = to_numpy_u32(mv._pow2_eq_bad_words_kernel(vals_p, spec))
        alt = to_numpy_u32(mv._pow2_eq_bad_words(vals_p, spec))
        vp_ref = jnp.asarray(to_numpy_u32(vals_p))
        ref = np.asarray(ref_mv._pow2_eq_bad_words(vp_ref, spec))
        ref_k = np.asarray(ref_mv._pow2_eq_bad_words_pallas(vp_ref, spec, interpret=True))
        assert (got == ref).all() and (alt == ref).all() and (ref_k == ref).all()
        return got

    assert both(vp).sum() == 0
    cols = spec["a_cols"][spec["a_mask"] != 0]
    slot = int(cols[cols > 0][0])
    bad = vp.clone()
    bad[2, slot] ^= 1 << 9
    assert both(bad).any()
    rand = _u32(tuple(vp.shape))
    rand[:, 0] = 0xFFFFFFFF
    both(from_numpy_u32(rand))


# --- kernel 4: bits_matvec_semi ------------------------------------------
@pytest.mark.parametrize("K", [512, 1, 256])
def test_bits_matvec_semi_plain_matches_pallas(K):
    """The sha256 big row's ELL buckets: (K, n_rows) = (512, 8), (1, 8),
    (256, 8), at B = 128, random bits and random coefficient digits."""
    n_rows, B = 8, 128
    x = RNG.integers(0, 2, size=(n_rows, K, B)).astype(np.uint32)
    F = RNG.integers(0, 256, size=(32, n_rows, K)).astype(np.uint32)
    kern = ref_fp.make_bits_matvec_bucket(SCALAR, K, n_rows, B, interpret=True, out_form="semi")
    want = np.asarray(kern(jnp.asarray(x), jnp.asarray(F)))
    got = fk.bits_matvec_semi_plain(from_numpy_u32(x), from_numpy_u32(F), SCALAR)
    assert got.shape == (17, n_rows, B)
    assert (to_numpy_u32(got) == want).all()
    # and the limbs are a value < 2^265 congruent to Σ digit-weighted sums
    p = SCALAR.p
    for r, b in ((0, 0), (n_rows - 1, B - 1)):
        val = sum(int(want[l, r, b]) << (16 * l) for l in range(17))
        exact = sum(int(F[d, r, c]) << (8 * d) for d in range(32) for c in range(K) if x[r, c, b])
        assert val < 1 << 265 and val % p == exact % p


# --- kernel 5: mulcmp --------------------------------------------------------
def _limbs17(v):
    return [(v >> (16 * l)) & 0xFFFF for l in range(17)]


def _mulcmp_operands(field, N):
    """Semi-reduced operands: random representatives of random products,
    every third corrupted, and the corner values 0, p, 2p, 2^265 - 1 in
    every combination in the first columns."""
    p = field.p
    rnd = random.Random(17)
    corners = [0, p, 2 * p, (1 << 265) - 1]
    A = np.zeros((17, N), np.uint32)
    B = np.zeros((17, N), np.uint32)
    C = np.zeros((17, N), np.uint32)
    want_bad = np.zeros(N, bool)
    i = 0
    for a in corners:
        for b in corners:
            for c in corners:
                A[:, i], B[:, i], C[:, i] = _limbs17(a), _limbs17(b), _limbs17(c)
                want_bad[i] = (a * b - c) % p != 0
                i += 1
    for i in range(i, N):
        a, b = rnd.randrange(p), rnd.randrange(p)
        c = (a * b) % p
        if i % 3 == 0:
            c = (c + rnd.randrange(1, p)) % p
        want_bad[i] = i % 3 == 0
        for arr, v in ((A, a), (B, b), (C, c)):
            arr[:, i] = _limbs17(v + rnd.randrange((1 << 264) // p) * p)
    return A, B, C, want_bad


def test_mulcmp_plain_matches_pallas():
    N = 1024
    A, B, C, want_bad = _mulcmp_operands(SCALAR, N)
    kern = ref_fp.make_mulcmp(SCALAR, interpret=True)
    want = np.asarray(kern(jnp.asarray(A), jnp.asarray(B), jnp.asarray(C)))
    got = fk.mulcmp_plain(from_numpy_u32(A), from_numpy_u32(B), from_numpy_u32(C), SCALAR)
    assert (to_numpy_u32(got) == want).all()
    assert ((want != 0) == want_bad).all()


@pytest.mark.parametrize("field", [PALLAS_SCALAR, VESTA_SCALAR], ids=lambda f: f.name)
def test_mulcmp_plain_other_fields(field):
    A, B, C, want_bad = _mulcmp_operands(field, 256)
    got = fk.mulcmp_plain(from_numpy_u32(A), from_numpy_u32(B), from_numpy_u32(C), field)
    assert ((to_numpy_u32(got) != 0) == want_bad).all()


# --- wrappers on the CPU -----------------------------------------------------
def test_wrappers_use_plain_version_on_cpu():
    fk.reset_launch_counts()
    A, C = from_numpy_u32(_u32((7 * 256, 64))), from_numpy_u32(_u32((256, 64)))
    assert torch.equal(fk.bitplane_eq(A, C, 256, 7, 1), fk.bitplane_eq_plain(A, C, 256, 7, 1))
    x = from_numpy_u32(RNG.integers(0, 2, size=(8, 4, 40)).astype(np.uint32))
    F = from_numpy_u32(RNG.integers(0, 256, size=(32, 8, 4)).astype(np.uint32))
    assert torch.equal(fk.bits_matvec_semi(x, F, SCALAR), fk.bits_matvec_semi_plain(x, F, SCALAR))
    a, b, c, _w = (from_numpy_u32(v) if i < 3 else v
                   for i, v in enumerate(_mulcmp_operands(SCALAR, 100)))
    assert torch.equal(fk.mulcmp(a, b, c, SCALAR), fk.mulcmp_plain(a, b, c, SCALAR))
    a16, b16 = (from_numpy_u32(RNG.integers(0, 1 << 16, size=(16, 50)).astype(np.uint32) >> (i + 1))
                for i in range(2))
    assert torch.equal(fk.mul(a16, b16, SCALAR), fk.mul_plain(a16, b16, SCALAR))
    descs = (("fadd", "prev", 0), ("fmul", "prev", 0))
    assert torch.equal(fk.chain(a16, b16, descs, 2, SCALAR), fk.chain_plain(a16, b16, descs, 2, SCALAR))
    xd = from_numpy_u32(RNG.integers(0, 256, size=(8, 64, 40)).astype(np.uint32))
    Fd = from_numpy_u32(RNG.integers(0, 256, size=(32, 8, 64)).astype(np.uint32))
    for form in ("semi", "canonical"):
        assert torch.equal(fk.limbs_matvec(xd, Fd, SCALAR, form), fk.limbs_matvec_plain(xd, Fd, SCALAR, form))
    assert torch.equal(fk.mul_digits(a16, b16, SCALAR), fk.mul_digits_plain(a16, b16, SCALAR))
    d = Fd[:, 0].contiguous()
    assert torch.equal(fk.reduce_digits(d, SCALAR), fk.reduce_digits_plain(d, SCALAR))
    assert fk.launch_counts() == {k: 0 for k in fk.KERNELS}
    assert fk.KERNELS == ("bitplane_eq", "bits_matvec_semi", "mulcmp", "chain", "mul",
                          "limbs_matvec", "mul_digits", "reduce_digits")


def test_wrappers_check_their_inputs():
    A = torch.zeros((7 * 256, 64), dtype=torch.int32)
    C = torch.zeros((256, 64), dtype=torch.int32)
    with pytest.raises(TypeError):
        fk.bitplane_eq(A.to(torch.int64), C, 256, 7, 1)
    with pytest.raises(ValueError):
        fk.bitplane_eq(A, C[:128], 256, 7, 1)
    with pytest.raises(ValueError):
        fk.bitplane_eq(A.t().contiguous().t(), C, 256, 7, 1)
    with pytest.raises(ValueError):
        fk.bitplane_eq(A.to("meta"), C.to("meta"), 256, 7, 1)
    s = torch.zeros((17, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        fk.mulcmp(s, s, s[:, :4].contiguous(), SCALAR)
    with pytest.raises(ValueError):
        fk.bits_matvec_semi(torch.zeros((8, 4, 16), dtype=torch.int32),
                            torch.zeros((32, 8, 5), dtype=torch.int32), SCALAR)
    x = torch.zeros((8, 64, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        fk.limbs_matvec(x, torch.zeros((32, 8, 64), dtype=torch.int32), SCALAR, "packed")
    wide = torch.zeros((1, 32 * (ref_fp.MAX_FUSED_LIMBS_K + 1), 1), dtype=torch.int32)
    with pytest.raises(ValueError):  # C·255² must stay below 2^32
        fk.limbs_matvec(wide, torch.zeros((32, 1, wide.shape[1]), dtype=torch.int32), SCALAR)
    with pytest.raises(ValueError):
        fk.reduce_digits(torch.zeros((16, 4), dtype=torch.int32), SCALAR)
    a16 = torch.zeros((16, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        fk.mul_digits(a16, a16[:, :3].contiguous(), SCALAR)
