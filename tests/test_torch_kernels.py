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
from bellpepper_tpu_torch.backend import field_consts, field_kernels as fk, op_rate
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
    """The planes as rows of one witness, a tenth of them empty (−1 in the
    plane table, zero rows for the Pallas kernel)."""
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
    planes = np.arange((m_a + m_c) * P, dtype=np.int32)
    empty = RNG.random(len(planes)) < 0.1
    empty[:P] = empty[m_a * P : (m_a + 1) * P] = False  # keep the equal columns equal
    planes[empty] = -1
    vals = np.concatenate([A, C])
    vals[empty] = 0
    A, C = vals[: m_a * P].copy(), vals[m_a * P :].copy()
    vals[empty] = _u32((int(empty.sum()), W))  # an empty plane's slot is never read
    want = np.asarray(kern(jnp.asarray(A), jnp.asarray(C)))
    got = fk.bitplane_eq_plain(from_numpy_u32(vals), torch.from_numpy(planes), 1, P, m_a, m_c)
    assert got.shape == (1, W)
    assert (to_numpy_u32(got[0]) == want).all()
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


def test_bitplane_eq_from_words_matches_pallas(sha256_words):
    """bitplane_eq's plain version on the packed witness through the sha256
    plane table (a third of its planes empty) at Bw = 2, against the
    reference's gather + Pallas kernel: the valid witness, random words,
    and the two together, one word each."""
    template, vp = sha256_words
    _small, big_idx, _lay = _classify_small_rows(template)
    spec, _rest = _classify_pow2_eq_rows(template, big_idx)
    planes = mv._pow2_plane_index(spec)
    P = fk.padded_positions(spec["n_pos"])
    assert (planes < 0).mean() > 0.3 and planes.max() < vp.shape[1]
    mixed = vp[:2].clone()
    mixed[1] = from_numpy_u32(_u32(vp.shape[1]))
    for words in (vp[:2], from_numpy_u32(_u32((2, vp.shape[1]))), mixed):
        vals_p = words.t().contiguous()
        got = fk.bitplane_eq(vals_p, torch.from_numpy(planes.astype(np.int32)), 25, P, 7, 1)
        ref = ref_mv._pow2_eq_bad_words_pallas(jnp.asarray(to_numpy_u32(vals_p)), spec, interpret=True)
        assert got.shape == (25, 2) and (to_numpy_u32(got) == np.asarray(ref)).all()
    assert not got[:, 0].any() and got[:, 1].any()


# --- kernel 4: bits_matvec_semi ------------------------------------------
def _cols_with_padding(n_rows, K, S, live=None):
    """A bucket's column table: random slots below S, each row's live
    entries front-packed (the ELL layout's), the rest −1, and the last
    three rows empty (a segment's padding)."""
    cols = RNG.integers(0, S, size=(n_rows, K)).astype(np.int32)
    for r in range(n_rows):
        n = 0 if r >= n_rows - 3 else (K if live is None else live(r))
        cols[r, n:] = -1
    return cols


def test_pow2_table_marks_empty_planes():
    """The plane table's −1 entries are exactly the empty ELL slots and the
    padded positions."""
    spec = {"n_pos": 5, "a_cols": np.array([[[3, 4], [5, 0], [6, 7], [1, 2], [8, 9]]]),
            "a_mask": np.array([[[1, 1], [1, 0], [0, 1], [1, 1], [1, 0]]], np.uint32),
            "c_cols": np.array([[[2], [0], [4], [6], [7]]]),
            "c_mask": np.array([[[1], [0], [1], [1], [0]]], np.uint32)}
    tab = mv._pow2_plane_index(spec).reshape(3, 8)  # (k, e) for n = 1
    assert tab[0].tolist() == [3, 5, -1, 1, 8, -1, -1, -1]
    assert tab[1].tolist() == [4, -1, 7, 2, -1, -1, -1, -1]
    assert tab[2].tolist() == [2, -1, 4, 6, -1, -1, -1, -1]


@pytest.mark.parametrize("K", [512, 1, 256])
def test_bits_matvec_semi_plain_matches_pallas(K):
    """The sha256 big row's ELL buckets: (K, n_rows) = (512, 8), (1, 8),
    (256, 8), at B = 128 (Bw = 4), from packed words through a column table
    with padding rows and empty tail entries, random coefficient digits;
    the Pallas kernel gets the gathered bits."""
    n_rows, S, Bw = 8, 64, 4
    B = 32 * Bw
    vals = _u32((S, Bw))
    cols = _cols_with_padding(n_rows, K, S, live=lambda r: max(1, K - 7 * r))
    F = RNG.integers(0, 256, size=(32, n_rows, K)).astype(np.uint32)
    live = cols >= 0
    x = (vals[np.maximum(cols, 0)][:, :, :, None] >> np.arange(32, dtype=np.uint32)) & 1  # [n, K, Bw, 32]
    x = np.where(live[:, :, None, None], x, 0).reshape(n_rows, K, B).astype(np.uint32)
    kern = ref_fp.make_bits_matvec_bucket(SCALAR, K, n_rows, B, interpret=True, out_form="semi")
    want = np.asarray(kern(jnp.asarray(x), jnp.asarray(F)))
    got = fk.bits_matvec_semi_plain(from_numpy_u32(vals), torch.from_numpy(cols),
                                    torch.from_numpy(fk.fold_operand(F)), SCALAR)
    assert got.shape == (17, n_rows, B)
    assert (to_numpy_u32(got) == want).all()
    assert not want[:, n_rows - 3 :].any()  # the padding rows read zero
    # and the limbs are a value < 2^265 congruent to Σ digit-weighted sums
    p = SCALAR.p
    for r, b in ((0, 0), (n_rows - 4, B - 1)):
        val = sum(int(want[l, r, b]) << (16 * l) for l in range(17))
        exact = sum(int(F[d, r, c]) << (8 * d) for d in range(32) for c in range(K) if x[r, c, b])
        assert val < 1 << 265 and val % p == exact % p


def test_fold_operand_layout():
    planes = RNG.integers(0, 256, size=(32, 3, 40)).astype(np.uint32)
    op = fk.fold_operand(planes)
    assert op.dtype == np.uint8 and op.shape == (3, 32, 64)
    assert (op[:, :, :40] == planes.transpose(1, 0, 2)).all() and not op[:, :, 40:].any()
    with pytest.raises(ValueError):
        fk.fold_operand(planes + 256)


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
    vals = from_numpy_u32(_u32((64, 2)))
    planes = torch.from_numpy(RNG.integers(-1, 64, size=8 * 256 * 3).astype(np.int32))
    assert torch.equal(fk.bitplane_eq(vals, planes, 3, 256, 7, 1), fk.bitplane_eq_plain(vals, planes, 3, 256, 7, 1))
    cols = torch.from_numpy(_cols_with_padding(8, 4, 64))
    F = torch.from_numpy(fk.fold_operand(RNG.integers(0, 256, size=(32, 8, 4)).astype(np.uint32)))
    assert torch.equal(fk.bits_matvec_semi(vals, cols, F, SCALAR), fk.bits_matvec_semi_plain(vals, cols, F, SCALAR))
    a, b, c, _w = (from_numpy_u32(v) if i < 3 else v
                   for i, v in enumerate(_mulcmp_operands(SCALAR, 100)))
    assert torch.equal(fk.mulcmp(a, b, c, SCALAR), fk.mulcmp_plain(a, b, c, SCALAR))
    a16, b16 = (from_numpy_u32(RNG.integers(0, 1 << 16, size=(16, 50)).astype(np.uint32) >> (i + 1))
                for i in range(2))
    assert torch.equal(fk.mul(a16, b16, SCALAR), fk.mul_plain(a16, b16, SCALAR))
    descs = (("fadd", "prev", 0), ("fmul", "prev", 0))
    assert torch.equal(fk.chain(a16, b16, descs, 2, SCALAR), fk.chain_plain(a16, b16, descs, 2, SCALAR))
    zt = from_numpy_u32(RNG.integers(0, 1 << 16, size=(64, 16, 40)).astype(np.uint32))
    Fd = RNG.integers(0, 256, size=(32, 8, 64)).astype(np.uint32)
    Fo = torch.from_numpy(fk.fold_operand(Fd))
    cols = torch.from_numpy(_cols_with_padding(8, 2, 64))
    for form in ("semi", "canonical"):
        assert torch.equal(fk.limbs_matvec(zt, cols, Fo, SCALAR, form), fk.limbs_matvec_plain(zt, cols, Fo, SCALAR, form))
    assert torch.equal(fk.mul_digits(a16, b16, SCALAR), fk.mul_digits_plain(a16, b16, SCALAR))
    d = from_numpy_u32(Fd[:, 0])
    assert torch.equal(fk.reduce_digits(d, SCALAR), fk.reduce_digits_plain(d, SCALAR))
    x = from_numpy_u32(RNG.integers(1, 100, size=(8, 50)).astype(np.uint32))
    assert torch.equal(op_rate.op_rate(x, "u32_mul", 3), op_rate.op_rate_plain(x, "u32_mul", 3))
    assert fk.launch_counts() == {k: 0 for k in fk.KERNELS} and op_rate.op_rate.launches == 0
    assert fk.KERNELS == ("bitplane_eq", "bits_matvec_semi", "mulcmp", "chain", "mul",
                          "limbs_matvec", "mul_digits", "reduce_digits")


def test_wrappers_check_their_inputs():
    vals = torch.zeros((64, 4), dtype=torch.int32)
    planes = torch.zeros(8 * 256, dtype=torch.int32)
    with pytest.raises(TypeError):
        fk.bitplane_eq(vals.to(torch.int64), planes, 1, 256, 7, 1)
    with pytest.raises(TypeError):
        fk.bitplane_eq(vals, planes.to(torch.int64), 1, 256, 7, 1)
    with pytest.raises(ValueError):  # the table's length must be (m_a + m_c)·P·n
        fk.bitplane_eq(vals, planes[:-1].contiguous(), 1, 256, 7, 1)
    with pytest.raises(ValueError):
        fk.bitplane_eq(vals.t().contiguous().t(), planes, 1, 256, 7, 1)
    with pytest.raises(ValueError):  # P must be a power of two
        fk.bitplane_eq(vals, torch.zeros(8 * 250, dtype=torch.int32), 1, 250, 7, 1)
    with pytest.raises(ValueError):  # the counter holds m_a + m_c <= 30
        fk.bitplane_eq(vals, torch.zeros(32 * 8, dtype=torch.int32), 1, 8, 31, 1)
    with pytest.raises(ValueError):
        fk.bitplane_eq(vals.to("meta"), planes.to("meta"), 1, 256, 7, 1)
    s = torch.zeros((17, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        fk.mulcmp(s, s, s[:, :4].contiguous(), SCALAR)
    cols = torch.zeros((8, 4), dtype=torch.int32)
    F = torch.zeros((8, 32, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):  # F must cover the rows' K rounded up to 32
        fk.bits_matvec_semi(vals, cols, F[:, :, :16].contiguous(), SCALAR)
    with pytest.raises(TypeError):  # F is bytes
        fk.bits_matvec_semi(vals, cols, F.to(torch.int32), SCALAR)
    with pytest.raises(TypeError):
        fk.bits_matvec_semi(vals, cols.to(torch.int64), F, SCALAR)
    zt = torch.zeros((64, 16, 16), dtype=torch.int32)
    Fd = torch.zeros((8, 32, 128), dtype=torch.uint8)
    with pytest.raises(ValueError):
        fk.limbs_matvec(zt, cols, Fd, SCALAR, "packed")
    with pytest.raises(ValueError):  # zt is [S, 16, B]
        fk.limbs_matvec(zt[:, :8].contiguous(), cols, Fd, SCALAR)
    with pytest.raises(ValueError):  # F of the limbs form is [n_rows, 32, 32K]
        fk.limbs_matvec(zt, cols, F, SCALAR)
    K = ref_fp.MAX_FUSED_LIMBS_K + 1
    with pytest.raises(ValueError):  # C·255² must stay below 2^32
        fk.limbs_matvec(zt, torch.zeros((1, K), dtype=torch.int32),
                        torch.zeros((1, 32, 32 * K), dtype=torch.uint8), SCALAR)
    with pytest.raises(ValueError):
        fk.reduce_digits(torch.zeros((16, 4), dtype=torch.int32), SCALAR)
    a16 = torch.zeros((16, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        fk.mul_digits(a16, a16[:, :3].contiguous(), SCALAR)
    x = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        op_rate.op_rate(x, "u64_mul", 4)
    with pytest.raises(ValueError):  # R must be one of the kernel's instantiations
        op_rate.op_rate(x[:3].contiguous(), "u32_add", 4)
    with pytest.raises(TypeError):  # the f32 classes take float32
        op_rate.op_rate(x, "f32_fma", 4)


# --- the op-rate probe -----------------------------------------------------------
def _probe_numpy(x: np.ndarray, op: str, rounds: int) -> np.ndarray:
    """benchmarks/probe_vpu_ops.py's rounds, in numpy."""
    rows = [r.copy() for r in x]
    with np.errstate(over="ignore"):
        for _ in range(rounds):
            for i, v in enumerate(rows):
                if op == "u32_add":
                    v = v + (v | np.uint32(1))
                elif op == "u32_mul":
                    v = v * (v | np.uint32(1))
                elif op == "u16_mul":
                    v = (v & np.uint32(0xFFFF)) * np.uint32(3)
                elif op == "u32_shift_and":
                    v = (v >> np.uint32(3)) & np.uint32(0xFFFF)
                elif op == "f32_mul":
                    v = v * v
                elif op == "f32_fma":
                    v = v * v + v
                else:
                    v = v.astype(np.int32).astype(np.float32).astype(np.int32).astype(np.uint32)
                rows[i] = v
        acc = rows[0]
        for v in rows[1:]:
            acc = acc + v
    return acc


@pytest.mark.parametrize("op", op_rate.OPS)
def test_op_rate_plain_matches_numpy(op):
    """The plain version against a numpy evaluation of the same rounds on
    the probe's inputs (1..99): integer classes bit-exact over 64 rounds,
    f32 classes over 4 rounds (later rounds overflow to inf), equal to
    within one part in 10^6 (both round every op; only the summation
    library differs)."""
    flt = op in op_rate.FLOAT_OPS
    rounds = 4 if flt else 64
    x = RNG.integers(1, 100, size=(8, 300)).astype(np.float32 if flt else np.uint32)
    want = _probe_numpy(x, op, rounds)
    xt = torch.from_numpy(x) if flt else from_numpy_u32(x)
    got = op_rate.op_rate_plain(xt, op, rounds)
    if flt:
        assert np.isfinite(want).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    else:
        assert (to_numpy_u32(got) == want).all()
