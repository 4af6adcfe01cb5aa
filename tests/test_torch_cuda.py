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
from bellpepper_tpu_torch.backend import field_kernels as fk
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


@pytest.mark.cuda
@pytest.mark.parametrize("P,m_a,m_c,W", [(256, 7, 1, 1000), (32, 3, 2, 777), (64, 4, 3, 1)])
def test_bitplane_eq_on_card(cuda, P, m_a, m_c, W):
    A, C = _u32((m_a * P, W), cuda), _u32((m_c * P, W), cuda)
    C[:, ::2] = 0
    C[:P, ::2] = A[:P, ::2]
    A[P:, ::2] = 0
    before = fk.bitplane_eq.launches
    got = fk.bitplane_eq(A, C, P, m_a, m_c)
    torch.cuda.synchronize()
    assert fk.bitplane_eq.launches == before + 1
    assert torch.equal(got, fk.bitplane_eq_plain(A, C, P, m_a, m_c))
    assert not got[::2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,K,B", [(8, 512, 1000), (3, 37, 257), (8, 1, 33)])
def test_bits_matvec_semi_on_card(cuda, n_rows, K, B):
    x = _u32((n_rows, K, B), cuda, 2)
    F = _u32((32, n_rows, K), cuda, 256)
    before = fk.bits_matvec_semi.launches
    got = fk.bits_matvec_semi(x, F, SCALAR)
    torch.cuda.synchronize()
    assert fk.bits_matvec_semi.launches == before + 1
    assert torch.equal(got, fk.bits_matvec_semi_plain(x, F, SCALAR))


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
    A = torch.zeros((31 * 8, 4), dtype=torch.int32, device=cuda)
    C = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # the kernel's counter holds m_a + m_c <= 30
        fk.bitplane_eq(A, C, 8, 31, 1)
    with pytest.raises(ValueError):
        fk.bitplane_eq(A[:, ::2], C[:, ::2], 8, 31, 1)


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
     (2, 2064, 33, "semi", True), (2, 2064, 33, "canonical", True)],
    ids=["K64-semi", "K64-canonical", "K1-canonical", "K2064-top-semi", "K2064-top-canonical"],
)
def test_limbs_matvec_on_card(cuda, n_rows, K, B, out_form, top):
    """Ragged B, K = 1 and the 2064-wide bound (every digit 255, so the
    digit sums reach 66048·255² and the carries wrap 32 bits)."""
    x = _u32((n_rows, 32 * K, B), cuda, 256)
    F = _u32((32, n_rows, 32 * K), cuda, 256)
    if top:
        x[0] = 255
        F[:, 0] = 255
    before = fk.limbs_matvec.launches
    got = fk.limbs_matvec(x, F, SCALAR, out_form)
    torch.cuda.synchronize()
    assert fk.limbs_matvec.launches == before + 1
    assert torch.equal(got, fk.limbs_matvec_plain(x, F, SCALAR, out_form))


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
