"""The port's CUDA kernels and step on the card (marker `cuda`; each test
skips where torch sees no CUDA device). This file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every kernel is held bit-exact to its plain version at ragged sizes (the
kernels mask the edge themselves), its launch is counted, and the packed
sha256 step, the config-1 field step in the mixed and the limbs forms, and
the Satisfier on the card give the CPU's verdicts, clean and corrupted."""

import random

import numpy as np
import pytest
import torch

from bellpepper_tpu_torch import (
    PALLAS_SCALAR,
    SCALAR,
    NativeBuilder,
    Satisfier,
    WitnessProgram,
    build_packed_production_step,
    build_production_step,
)
from bellpepper_tpu_torch.backend import field_kernels as fk, op_rate
from bellpepper_tpu_torch.backend.words import from_numpy_u32

RNG = np.random.default_rng(0x5EED_0006)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _u32(shape, dev, high=1 << 32):
    return from_numpy_u32(
        RNG.integers(0, high, size=shape, dtype=np.uint64).astype(np.uint32), dev
    )


def _planes(P, m_a, m_c, n, S, dev):
    """A random plane table over S slots, a third of its planes empty."""
    t = RNG.integers(0, S, size=(m_a + m_c) * P * n).astype(np.int32)
    t[RNG.random(t.size) < 1 / 3] = -1
    return torch.from_numpy(t).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("P,m_a,m_c,n,Bw", [(256, 7, 1, 25, 1024), (256, 7, 1, 3, 37), (32, 3, 2, 5, 777),
                                            (64, 4, 3, 2, 1)])
def test_bitplane_eq_on_card(cuda, P, m_a, m_c, n, Bw):
    """Ragged Bw (the 4-byte copies), the sha256 instantiation (7, 1) and
    the generic one; half the columns made equal by a witness whose C
    plane is a copy of A's one live plane at every position."""
    S = 64
    vals = _u32((S, Bw), cuda)
    planes = _planes(P, m_a, m_c, n, S, cuda)
    before = fk.bitplane_eq.launches
    got = fk.bitplane_eq(vals, planes, n, P, m_a, m_c)
    torch.cuda.synchronize()
    assert fk.bitplane_eq.launches == before + 1
    assert torch.equal(got, fk.bitplane_eq_plain(vals, planes, n, P, m_a, m_c))
    # every row's A side reads slot 2e at position e (addend 0, the others
    # empty) and its C side slot 2e + 1 (every C addend); with vals[2e + 1]
    # = vals[2e] at even words, m_c = 1 holds A = C there
    tab = torch.full(((m_a + m_c), P, n), -1, dtype=torch.int32)
    e = torch.arange(P, dtype=torch.int32)[:, None] % (S // 2)
    tab[0], tab[m_a:] = 2 * e, 2 * e + 1
    vals[1::2, ::2] = vals[0::2, ::2]
    tab = tab.reshape(-1).to(cuda)
    got = fk.bitplane_eq(vals, tab, n, P, m_a, m_c)
    assert torch.equal(got, fk.bitplane_eq_plain(vals, tab, n, P, m_a, m_c))
    if m_c == 1:
        assert not got[:, ::2].any()


def _cols(n_rows, K, S, dev):
    """A column table: random slots, row r's live entries front-packed
    (K − 5r of them), the last three rows empty (a segment's padding)."""
    cols = RNG.integers(0, S, size=(n_rows, K)).astype(np.int32)
    for r in range(n_rows):
        cols[r, 0 if r >= n_rows - 3 else max(1, K - 5 * r):] = -1
    return torch.from_numpy(cols).to(dev)


def _fold(n_rows, C, dev):
    F = RNG.integers(0, 256, size=(32, n_rows, C)).astype(np.uint32)
    return torch.from_numpy(fk.fold_operand(F)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,K,Bw", [(8, 512, 1024), (8, 1, 1024), (8, 256, 1024), (5, 37, 31), (4, 1, 1)])
def test_bits_matvec_semi_on_card(cuda, n_rows, K, Bw):
    """The sha256 big row's bucket shapes and ragged ones (Bw not a
    multiple of 4: the 4-byte copies; a partial instance tile)."""
    S = 700
    vals = _u32((S, Bw), cuda)
    cols, F = _cols(n_rows, K, S, cuda), _fold(n_rows, K, cuda)
    before = fk.bits_matvec_semi.launches
    got = fk.bits_matvec_semi(vals, cols, F, SCALAR)
    torch.cuda.synchronize()
    assert fk.bits_matvec_semi.launches == before + 1
    assert torch.equal(got, fk.bits_matvec_semi_plain(vals, cols, F, SCALAR))
    assert not got[:, n_rows - 3 :].any()


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1000, 1])
def test_mulcmp_on_card(cuda, N):
    ops = [_u32((17, N), cuda, 1 << 16) for _ in range(3)]
    for o in ops:
        o[16] &= 0x1FF
    before = fk.mulcmp.launches
    got = fk.mulcmp(*ops, SCALAR)
    torch.cuda.synchronize()
    assert fk.mulcmp.launches == before + 1
    assert torch.equal(got, fk.mulcmp_plain(*ops, SCALAR))


@pytest.mark.cuda
def test_wrappers_refuse_rather_than_fall_back(cuda):
    vals = torch.zeros((64, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # the kernel's counter holds m_a + m_c <= 30
        fk.bitplane_eq(vals, torch.zeros(32 * 8, dtype=torch.int32, device=cuda), 1, 8, 31, 1)
    with pytest.raises(ValueError):
        fk.bitplane_eq(vals[:, ::2], torch.zeros(8 * 8, dtype=torch.int32, device=cuda), 1, 8, 7, 1)
    with pytest.raises(ValueError):  # the plane table lies on another device
        fk.bitplane_eq(vals, torch.zeros(8 * 8, dtype=torch.int32), 1, 8, 7, 1)
    cols = torch.zeros((8, 64), dtype=torch.int32, device=cuda)
    n_F = 8 * 32 * 2048
    buf = torch.zeros(n_F + 8, dtype=torch.uint8, device=cuda)
    zt = torch.zeros((4, 16, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # the operand must be 16-byte aligned
        fk.limbs_matvec(zt, cols, buf[8:].reshape(8, 32, 2048), SCALAR)
    F = buf[:n_F].reshape(8, 32, 2048)
    with pytest.raises(TypeError):
        fk.limbs_matvec(zt, cols.to(torch.int64), F, SCALAR)
    with pytest.raises(ValueError):  # the instance tile is [S, 16, B]
        fk.limbs_matvec(zt[:, :8].contiguous(), cols, F, SCALAR)
    with pytest.raises(ValueError):
        fk.bits_matvec_semi(vals[:, ::2], cols[:, :32].contiguous(), F[:, :, :32].contiguous(), SCALAR)
    x = torch.zeros((8, 4), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):  # an integer class takes int32 words
        op_rate.op_rate(x, "u32_mul", 4)


class _Tape:
    def __init__(self, field, snap):
        self.field = field
        self._snap = snap

    def snapshot(self):
        return self._snap


@pytest.mark.cuda
def test_step_on_card_matches_cpu(cuda):
    nb = NativeBuilder()
    bits = [nb.alloc_bit() for _ in range(512)]
    nb.sha256_compression(bits, nb.sha256_iv())
    template, tape = nb.finish()
    ni, na, ops, free = tape.snapshot()
    i = max(k for k, op in enumerate(ops) if op.opcode == "maj")
    bad_ops = list(ops)
    bad_ops[i] = type(ops[i])("ch", ops[i].outs, ops[i].args)
    words = RNG.integers(0, 1 << 32, size=(2, 16, 512), dtype=np.uint64).astype(np.uint32)
    for t in (tape, _Tape(tape.field, (ni, na, bad_ops, free))):
        prog = WitnessProgram(t)
        want = build_packed_production_step(prog, template, 512, device="cpu")(from_numpy_u32(words))
        got = build_packed_production_step(prog, template, 512, device=cuda)(
            from_numpy_u32(words, cuda)
        )
        assert tuple(int(v) for v in got) == tuple(int(v) for v in want)


def _canonical(field, n, seed, dev):
    """int32[16, n] limb-major canonical values, corners (0, 1, p − 1)
    first."""
    p = field.p
    rnd = random.Random(seed)
    vals = [0, 1, p - 1] + [rnd.randrange(p) for _ in range(n - 3)]
    x = np.asarray([[(v >> (16 * l)) & 0xFFFF for v in vals] for l in range(16)], np.uint32)
    return from_numpy_u32(x, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("field", [SCALAR, PALLAS_SCALAR], ids=lambda f: f.name)
@pytest.mark.parametrize("N", [1000, 3])
def test_mul_on_card(cuda, field, N):
    a, b = _canonical(field, N, 1, cuda), _canonical(field, N, 2, cuda).flip(1).contiguous()
    before = fk.mul.launches
    got = fk.mul(a, b, field)
    torch.cuda.synchronize()
    assert fk.mul.launches == before + 1
    assert torch.equal(got, fk.mul_plain(a, b, field))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "descs,n_ext",
    [
        ((("fmul", "prev", 0), ("fadd", "prev", 1), ("fmul", "prev", "prev")), 2),
        ((("fadd", "prev", 0),), 1),
        ((("fmul", 2, "prev"), ("fadd", 3, "prev"), ("fmul", "prev", 1), ("fadd", 0, "prev")), 4),
        ((("fmul", 0, "prev"), ("fadd", 1, "prev"), ("fmul", "prev", 2), ("fadd", 3, "prev"),
          ("fmul", 4, 5), ("fadd", "prev", 6), ("fmul", "prev", 7), ("fadd", "prev", "prev")), 9),
    ],
    ids=["config1", "fadd", "four_ext", "eight_ops_nine_ext"],
)
def test_chain_on_card(cuda, descs, n_ext):
    N = 777
    x0 = _canonical(SCALAR, N, 3, cuda)
    ext = torch.cat([_canonical(SCALAR, N, 4 + k, cuda) for k in range(n_ext)])
    before = fk.chain.launches
    got = fk.chain(x0, ext, descs, 5, SCALAR)
    torch.cuda.synchronize()
    assert fk.chain.launches == before + 1
    assert torch.equal(got, fk.chain_plain(x0, ext, descs, 5, SCALAR))


def _config1(nonzero):
    nb = NativeBuilder()
    bits = [nb.alloc_bit() for _ in range(128)]
    a, b = nb.pack_bits(bits[:64]), nb.pack_bits(bits[64:])
    x = a
    for _ in range(30):
        x = nb.num_square(nb.num_add(nb.num_mul(x, b), a))
    if nonzero:
        nb.num_assert_nonzero(x)
    return nb.finish()


@pytest.mark.cuda
@pytest.mark.parametrize("nonzero", [False, True], ids=["config1", "nonzero"])
def test_field_step_on_card_matches_cpu(cuda, nonzero):
    """Config 1 (through chain and mulcmp) and its variant (through mul)
    at B = 512 × 2 chunks, clean and with one fadd of the tape computing a
    product."""
    template, tape = _config1(nonzero)
    ni, na, ops, free = tape.snapshot()
    i = max(k for k, op in enumerate(ops) if op.opcode == "fadd")
    bad_ops = list(ops)
    bad_ops[i] = type(ops[i])("fmul", ops[i].outs, ops[i].args)
    bits = RNG.integers(0, 2, size=(2, 512, 128)).astype(np.uint32)
    for t, corrupt in ((tape, False), (_Tape(tape.field, (ni, na, bad_ops, free)), True)):
        prog = WitnessProgram(t)
        want = build_production_step(prog, template, 512, device="cpu")(from_numpy_u32(bits))
        fk.reset_launch_counts()
        got = build_production_step(prog, template, 512, device=cuda)(from_numpy_u32(bits, cuda))
        got = tuple(int(v) for v in got)
        assert got == tuple(int(v) for v in want)
        assert (got[0] > 0) == corrupt
        counts = fk.launch_counts()
        assert counts["mulcmp"] == 2
        if nonzero:  # the corrupted tape has one fmul more
            assert counts["mul"] == 2 * (60 + corrupt) and counts["chain"] == 0
        elif not corrupt:
            assert counts["chain"] == 2 and counts["mul"] == 0


# --- the limbs form ------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize(
    "n_rows,K,B,out_form,top",
    [(8, 64, 1000, "semi", False), (8, 64, 1000, "canonical", False), (3, 1, 257, "canonical", False),
     (24, 1024, 1024, "semi", False), (8, 2064, 33, "semi", True), (8, 2064, 33, "canonical", True)],
    ids=["K64-semi", "K64-canonical", "K1-canonical", "K1024-semi", "K2064-top-semi", "K2064-top-canonical"],
)
def test_limbs_matvec_on_card(cuda, n_rows, K, B, out_form, top):
    """Ragged B (B % 4 != 0: the 4-byte copies), K = 1, the sha256 widest
    a-bucket's shape, and the 2064-wide bound: the first rows read one
    slot of all-0xFFFF limbs through every entry against planes of 255, so
    the digit sums reach 66048·255² and the carries wrap 32 bits."""
    S = 300
    zt = _u32((S, 16, B), cuda, 1 << 16)
    cols = _cols(n_rows, K, S, cuda)
    F = _fold(n_rows, 32 * K, cuda)
    if top:
        zt[7] = 0xFFFF
        cols[:2] = 7
        F[:2] = 255
    before = fk.limbs_matvec.launches
    got = fk.limbs_matvec(zt, cols, F, SCALAR, out_form)
    torch.cuda.synchronize()
    assert fk.limbs_matvec.launches == before + 1
    assert torch.equal(got, fk.limbs_matvec_plain(zt, cols, F, SCALAR, out_form))
    assert not got[:, n_rows - 3 :].any()


@pytest.mark.cuda
@pytest.mark.parametrize("op", op_rate.OPS)
def test_op_rate_on_card(cuda, op):
    """Integer classes bit-exact over 64 rounds; f32 classes over 4 rounds
    (later ones overflow to inf) within a relative 10^-5: the kernel's
    fused multiply-add rounds once where the plain version rounds twice,
    and a squaring doubles a relative error each round."""
    flt = op in op_rate.FLOAT_OPS
    rounds = 4 if flt else 64
    x = torch.from_numpy(RNG.integers(1, 100, size=(8, 3000)).astype(np.int32)).to(cuda)
    if flt:
        x = x.float()
    before = op_rate.op_rate.launches
    got = op_rate.op_rate(x, op, rounds)
    torch.cuda.synchronize()
    assert op_rate.op_rate.launches == before + 1
    want = op_rate.op_rate_plain(x, op, rounds)
    if flt:
        assert torch.isfinite(want).all()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("field", [SCALAR, PALLAS_SCALAR], ids=lambda f: f.name)
@pytest.mark.parametrize("N", [1000, 1])
def test_mul_digits_and_reduce_digits_on_card(cuda, field, N):
    a = _canonical(field, max(N, 3), 5, cuda)[:, :N].contiguous()
    b = _canonical(field, max(N, 3), 6, cuda).flip(1)[:, :N].contiguous()
    before = (fk.mul_digits.launches, fk.reduce_digits.launches)
    got = fk.mul_digits(a, b, field)
    d = _u32((32, N), cuda, 1 << 24)
    d[:, 0] = (1 << 24) - 1
    red = fk.reduce_digits(d, field)
    torch.cuda.synchronize()
    assert (fk.mul_digits.launches, fk.reduce_digits.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, fk.mul_digits_plain(a, b, field))
    assert torch.equal(red, fk.reduce_digits_plain(d, field))


@pytest.mark.cuda
def test_limbs_step_on_card_matches_cpu(cuda):
    """The config-1 limbs step (the fold rows on the fused route) at
    B = 256 × 2 chunks, clean and with one fadd of the tape computing a
    product, against the CPU; then the Satisfier of the template at
    batch 1 (the non-fused route) with a non-bit value in a bit slot."""
    template, tape = _config1(False)
    ni, na, ops, free = tape.snapshot()
    i = max(k for k, op in enumerate(ops) if op.opcode == "fadd")
    bad_ops = list(ops)
    bad_ops[i] = type(ops[i])("fmul", ops[i].outs, ops[i].args)
    bits = RNG.integers(0, 2, size=(2, 256, 128)).astype(np.uint32)
    for t, corrupt in ((tape, False), (_Tape(tape.field, (ni, na, bad_ops, free)), True)):
        prog = WitnessProgram(t)
        want = build_production_step(prog, template, 256, "cpu", witness_form="limbs")(from_numpy_u32(bits))
        fk.reset_launch_counts()
        got = build_production_step(prog, template, 256, cuda, witness_form="limbs")(from_numpy_u32(bits, cuda))
        got = tuple(int(v) for v in got)
        assert got == tuple(int(v) for v in want) and (got[0] > 0) == corrupt
        counts = fk.launch_counts()
        assert counts["limbs_matvec"] == 6 and counts["mulcmp"] == 4
    prog = WitnessProgram(tape)
    z = prog.z_template_limbs(*prog.build("cpu")(from_numpy_u32(bits[0, :1])))[0]
    z[prog.free_slots[7]] = z[prog.free_slots[7]].flip(0) + 3  # a non-bit canonical value
    got, want = Satisfier(template, device=cuda), Satisfier(template, device="cpu")
    fk.reset_launch_counts()
    assert got.which_is_unsatisfied(z.to(cuda)) == want.which_is_unsatisfied(z) is not None
    counts = fk.launch_counts()
    assert counts["mul_digits"] == 3 and counts["reduce_digits"] == 3 and counts["mul"] == 1
