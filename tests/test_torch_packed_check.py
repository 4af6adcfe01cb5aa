"""The port's bits_packed check against the JAX package: every host-side
layout array (row partition, structured families, pow2 spec, sub-system,
shared ELL), then the violation mask and the reduced (n_bad, first)
verdict against build_templated_check(t, 512, False, "bits_packed"),
clean and under single-bit corruption, on the sha256 template and on the
tests/test_packed.py fixtures. All comparisons are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellpepper_tpu.backend import matvec as ref_mv
from bellpepper_tpu_torch import NativeBuilder, PrimeField, WitnessProgram
from bellpepper_tpu_torch.backend import layout
from bellpepper_tpu_torch.backend import matvec as mv
from bellpepper_tpu_torch.backend.words import from_numpy_u32, to_numpy_u32, unpack_bits
import test_packed

RNG = np.random.default_rng(0x5EED_0004)
B = 512
FIXTURES = ["addmany", "families", "adversarial_pow2", "lookalike"]


def fixture_tape(name, monkeypatch):
    """(template, TapeCS tape) of a tests/test_packed.py fixture circuit."""
    monkeypatch.setattr(test_packed, "WitnessProgram", lambda tape: tape)
    return getattr(test_packed, f"_{name}_setup")()


@pytest.fixture(scope="module")
def sha256():
    nb = NativeBuilder()
    bits = [nb.alloc_bit() for _ in range(512)]
    nb.sha256_compression(bits, nb.sha256_iv())
    template, tape = nb.finish()
    return template, WitnessProgram(tape)


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and (a == b).all()


def _assert_layouts_match(template):
    part, ref_part = layout._classify_small_rows(template), ref_mv._classify_small_rows(template)
    small_idx, big_idx, lay = part
    r_small, r_big, r_lay = ref_part
    assert _eq(small_idx, r_small) and _eq(big_idx, r_big)
    for name in "abc":
        assert _eq(lay[name][0], r_lay[name][0]) and _eq(lay[name][1], r_lay[name][1])

    fams, left = layout._classify_bit_row_families(template, small_idx)
    r_fams, r_left = ref_mv._classify_bit_row_families(template, small_idx)
    assert fams.keys() == r_fams.keys() and _eq(left, r_left)
    for kind in fams:
        assert _eq(fams[kind][0], r_fams[kind][0]) and _eq(fams[kind][1], r_fams[kind][1])

    spec, rest = layout._classify_pow2_eq_rows(template, big_idx)
    r_spec, r_rest = ref_mv._classify_pow2_eq_rows(template, big_idx)
    assert _eq(rest, r_rest)
    assert (spec is None) == (r_spec is None)
    if spec is not None:
        assert spec.keys() == r_spec.keys()
        for k, v in spec.items():
            assert (v == r_spec[k]) if np.isscalar(v) else _eq(v, r_spec[k]), k

    for keep in (big_idx, big_idx[rest], small_idx[:50]):
        sub = layout._sub_rows_r1cs(template, keep)
        r_sub = ref_mv._sub_rows_r1cs(template, keep)
        assert sub.num_constraints == r_sub.num_constraints
        for name in "abc":
            m, rm = getattr(sub, name), getattr(r_sub, name)
            assert _eq(m.rows, rm.rows) and _eq(m.cols, rm.cols) and _eq(m.coeff_ids, rm.coeff_ids)
        for zero_id in (0, len(template.coeff_table)):
            mats, pos, rtp = layout._build_shared_ell(sub, zero_id)
            r_mats, r_pos, r_rtp = ref_mv._build_shared_ell(sub, zero_id)
            assert rtp == r_rtp and _eq(pos, r_pos)
            for name in "abc":
                m, rm = mats[name], r_mats[name]
                assert _eq(m.cols, rm.cols) and _eq(m.coeff_ids, rm.coeff_ids)
                assert m.buckets == rm.buckets


def test_layouts_match_reference_sha256(sha256):
    template, _prog = sha256
    _assert_layouts_match(template)
    small_idx, big_idx, _ = layout._classify_small_rows(template)
    fams, left = layout._classify_bit_row_families(template, small_idx)
    assert len(small_idx) == 26326 and len(big_idx) == 26 and len(left) == 0
    assert len(fams["bool"][1]) == 6822
    assert sum(len(v[1]) for k, v in fams.items() if k != "bool") == 19504


@pytest.mark.parametrize("name", FIXTURES)
def test_layouts_match_reference_fixtures(name, monkeypatch):
    template, _tape = fixture_tape(name, monkeypatch)
    _assert_layouts_match(template)


def test_row_density_guard_matches_reference():
    rows = np.zeros(layout.MAX_ROW_NNZ + 1, np.int32)
    with pytest.raises(ValueError):
        layout._assert_row_density(rows, 4, "matrix a")
    with pytest.raises(ValueError):
        ref_mv._assert_row_density(rows, 4, "matrix a")
    layout._assert_row_density(rows[:-1], 4, "matrix a")
    assert layout.MAX_ROW_NNZ == ref_mv.MAX_ROW_NNZ


def test_family_formulas_match_reference():
    """Every family formula on all 2^n full-word bit assignments."""
    arity = {"condalloc": 2, "xor": 3, "and": 3, "and_not": 3, "nor": 3, "ch": 4, "maj2": 5}
    for kind, n in arity.items():
        rows = np.asarray([[-(k >> i & 1) for k in range(1 << n)] for i in range(n)], np.int32)
        got = mv._family_bad(kind, [torch.from_numpy(r) for r in rows])
        want = ref_mv._family_bad(kind, [jnp.asarray(r.view(np.uint32)) for r in rows])
        assert (to_numpy_u32(got) == np.asarray(want)).all(), kind


class _Pair:
    """The port's and the reference's check of one template at B = 512.
    The reference's full mask is compared where `with_mask` (its jit
    compile dominates on the sha256 template, where only the verdict is
    compared; the port's mask is still held to the port's verdict)."""

    def __init__(self, template, with_mask=True):
        self.R = template.num_constraints
        self.port = mv.build_templated_check(template, B, None, "bits_packed", device="cpu")
        ref = ref_mv.build_templated_check(template, B, False, "bits_packed")
        self.ref_mask = jax.jit(ref) if with_mask else None
        self.ref_verdict = jax.jit(ref.verdict)

    def check(self, vp_np):
        vp = from_numpy_u32(vp_np)
        mask = self.port(vp).numpy()
        nb, first = self.port.verdict(vp)
        r_nb, r_first = self.ref_verdict(jnp.asarray(vp_np))
        assert mask.shape == (B * self.R,)
        if self.ref_mask is not None:
            assert (mask == np.asarray(self.ref_mask(jnp.asarray(vp_np)))).all()
        assert int(nb) == int(r_nb) == int(mask.sum())
        assert int(first) == int(r_first)
        if mask.any():
            assert int(first) == int(np.argmax(mask))
        return int(nb), int(first)


def _witness(prog, free=None):
    if free is None:
        free = RNG.integers(0, 1 << 32, size=(B // 32, len(prog.free_slots)),
                            dtype=np.uint64).astype(np.uint32)
    return to_numpy_u32(prog.build_packed(device="cpu")(from_numpy_u32(free)))


def test_check_matches_reference_sha256(sha256):
    template, prog = sha256
    pair = _Pair(template, with_mask=False)
    vp = _witness(prog)
    assert pair.check(vp) == (0, 0xFFFFFFFF)
    # the bench probe: bit 7 of word Bw/2 at slot 600
    bad = vp.copy()
    bad[8, 600] ^= np.uint32(1 << 7)
    nb, first = pair.check(bad)
    assert nb > 0 and first // template.num_constraints == 32 * 8 + 7
    # a sweep of single-bit corruptions over slots of every row class
    slots = np.unique(np.r_[1, 2, 511, 512, 600, template.num_inputs + template.num_aux - 1,
                            RNG.integers(1, prog.num_slots, size=10)])
    for i, slot in enumerate(slots):
        bad = vp.copy()
        word, bit = i % (B // 32), (5 * i) % 32
        bad[word, slot] ^= np.uint32(1 << bit)
        nb, first = pair.check(bad)
        assert nb > 0 and first // template.num_constraints == 32 * word + bit


@pytest.mark.parametrize("name", FIXTURES)
def test_check_matches_reference_fixtures(name, monkeypatch):
    """Every slot corrupted in turn (one bit of one instance)."""
    template, tape = fixture_tape(name, monkeypatch)
    prog = WitnessProgram(tape)
    pair = _Pair(template)
    vp = _witness(prog)
    pair.check(vp)
    for slot in range(1, prog.num_slots):
        bad = vp.copy()
        bad[3, slot] ^= np.uint32(1 << 21)
        pair.check(bad)
    rand = RNG.integers(0, 1 << 32, size=vp.shape, dtype=np.uint64).astype(np.uint32)
    rand[:, 0] = 0xFFFFFFFF
    pair.check(rand)


def test_check_rejects_wrong_shape(sha256):
    """A wrong witness shape raises. The bits form is ported: at B = 32 its
    verdict equals the reference's on a packed check's witness with one
    bit flipped, over the shipped field and, through the canonical route,
    over a 127-bit one."""
    template, prog = sha256
    chk = mv.build_templated_check(template, B, None, "bits_packed", device="cpu")
    with pytest.raises(ValueError):
        chk.verdict(torch.zeros((B // 32, 10), dtype=torch.int32))
    nb = NativeBuilder(PrimeField("m127", (1 << 127) - 1))
    nb.sha256_compression([nb.alloc_bit() for _ in range(512)], nb.sha256_iv())
    small, small_tape = nb.finish()
    free = RNG.integers(0, 1 << 32, size=(1, len(prog.free_slots)), dtype=np.uint64).astype(np.uint32)
    for t, p in ((template, prog), (small, WitnessProgram(small_tape))):
        z = unpack_bits(p.build_packed(device="cpu")(from_numpy_u32(free)))
        z[17, 9000] ^= 1
        bits = mv.build_templated_check(t, 32, None, "bits", device="cpu")
        want = np.asarray(jax.jit(ref_mv.build_templated_check(t, 32, False, "bits"))(
            jnp.asarray(to_numpy_u32(z))))
        got = tuple(int(v) for v in bits.verdict(z))
        assert got == (int(want.sum()), int(np.argmax(want))) and got[1] // t.num_constraints == 17
