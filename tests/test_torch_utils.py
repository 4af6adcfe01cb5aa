"""The port's serialization and profiling utilities
(bellpepper_tpu_torch/utils): tests/test_utils.py's four tests on the
port's own circuits, and the cross-package promises — the port's
shape_fingerprint of an R1CS equals the reference's of the same R1CS
(config 1's template from either NativeBuilder and from the ShapeCS
frontend, and an R1CS from TestConstraintSystem), an R1CS or witness file
saved by either package loads in the other, the witness provenance checks
hold in both, and a witness saved from an int32 word tensor stores its
uint32 bit pattern."""

import numpy as np
import pytest
import torch

import bellpepper_tpu.utils as ref_utils
from bellpepper_tpu.backend.field_jnp import get_backend as ref_backend
from bellpepper_tpu.native import NativeBuilder as RefBuilder
from bellpepper_tpu.r1cs import R1CS as RefR1CS
from bellpepper_tpu_torch import NativeBuilder, Satisfier, TestConstraintSystem
from bellpepper_tpu_torch.backend.field_backend import get_backend
from bellpepper_tpu_torch.backend.words import from_numpy_u32
from bellpepper_tpu_torch.gadgets.num import AllocatedNum
from bellpepper_tpu_torch.r1cs import R1CS
from bellpepper_tpu_torch.utils import (
    load_r1cs,
    load_witness,
    phase,
    phase_report,
    save_r1cs,
    save_witness,
    shape_fingerprint,
)

import test_torch_frontend_path as frontend


def _circuit(cs):
    a = AllocatedNum.alloc(cs.namespace("a"), 3)
    b = AllocatedNum.alloc(cs.namespace("b"), 4)
    c = a.mul(cs.namespace("c"), b)
    c.inputize(cs.namespace("out"))


def _ref_cs():
    import bellpepper_tpu as bp
    from bellpepper_tpu.gadgets.num import AllocatedNum as RefNum

    cs = bp.TestConstraintSystem()
    a = RefNum.alloc(cs.namespace("a"), 3)
    b = RefNum.alloc(cs.namespace("b"), 4)
    a.mul(cs.namespace("c"), b).inputize(cs.namespace("out"))
    return cs


# -- tests/test_utils.py on the port -----------------------------------------

def test_r1cs_roundtrip(tmp_path):
    cs = TestConstraintSystem()
    _circuit(cs)
    r = R1CS.from_test_cs(cs)
    p = str(tmp_path / "ckpt.npz")
    fp = save_r1cs(p, r)
    r2 = load_r1cs(p, expect_fingerprint=fp)
    assert shape_fingerprint(r2) == fp
    assert r2.names == r.names
    assert r2.coeff_table == r.coeff_table
    for m in ("a", "b", "c"):
        assert (getattr(r2, m).rows == getattr(r, m).rows).all()
        assert (getattr(r2, m).cols == getattr(r, m).cols).all()

    # satisfiability still works after resume
    ok, row = r2.eval_host(cs.scalar_inputs(), cs.scalar_aux())
    assert ok


def test_witness_roundtrip_and_provenance(tmp_path):
    cs = TestConstraintSystem()
    _circuit(cs)
    r = R1CS.from_test_cs(cs)
    fp = save_r1cs(str(tmp_path / "r.npz"), r)

    be = get_backend(r.field)
    z = be.to_limbs(cs.scalar_inputs() + cs.scalar_aux())
    wp = str(tmp_path / "w.npz")
    save_witness(wp, z, fp, shard=(2, 8))
    z2, meta = load_witness(wp, expect_fingerprint=fp)
    assert (z2 == z).all()
    assert meta["shard_index"] == 2 and meta["shard_count"] == 8

    with pytest.raises(AssertionError):
        load_witness(wp, expect_fingerprint="deadbeef")


def test_fingerprint_detects_shape_change(tmp_path):
    cs = TestConstraintSystem()
    _circuit(cs)
    r = R1CS.from_test_cs(cs)
    cs2 = TestConstraintSystem()
    _circuit(cs2)
    cs2.enforce("extra", lambda lc: lc, lambda lc: lc, lambda lc: lc)
    r2 = R1CS.from_test_cs(cs2)
    assert shape_fingerprint(r) != shape_fingerprint(r2)


def test_phase_profiling():
    with phase("synthesize"):
        sum(range(1000))
    with phase("synthesize"):
        sum(range(1000))
    with phase("check", trace=True):
        sum(range(10))
    rep = phase_report(reset=True)
    assert rep["synthesize"]["count"] == 2
    assert rep["check"]["count"] == 1
    assert phase_report() == {}


# -- the cross-package promises ----------------------------------------------

def _native_config1(builder_cls):
    nb = builder_cls()
    bits = [nb.alloc_bit() for _ in range(128)]
    a, b = nb.pack_bits(bits[:64]), nb.pack_bits(bits[64:])
    x = a
    for _ in range(30):
        x = nb.num_square(nb.num_add(nb.num_mul(x, b), a))
    return nb.finish()[0]


def test_fingerprints_equal_the_reference():
    pairs = {
        "config1 NativeBuilder": (_native_config1(NativeBuilder), _native_config1(RefBuilder)),
        "config1 ShapeCS": (frontend.frontend("config1", frontend.PORT)[0],
                            frontend.frontend("config1", frontend.REF)[0]),
        "TestConstraintSystem": (R1CS.from_test_cs(_port_cs()), RefR1CS.from_test_cs(_ref_cs())),
    }
    fps = {}
    for name, (port, ref) in pairs.items():
        for m in ("a", "b", "c"):
            assert getattr(port, m).rows.dtype == np.int32 == getattr(ref, m).rows.dtype, name
        fps[name] = shape_fingerprint(port)
        assert fps[name] == ref_utils.shape_fingerprint(ref), name
    assert fps["config1 NativeBuilder"] == fps["config1 ShapeCS"]
    assert len(set(fps.values())) == 2


def _port_cs():
    cs = TestConstraintSystem()
    _circuit(cs)
    return cs


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_files_load_across_packages(tmp_path, writer):
    """An R1CS and a witness saved by one package load in the other, with
    the same fingerprint, arrays, names and limbs; the loaded R1CS checks
    through the port's DeviceR1CS route on the CPU."""
    cs, rcs = _port_cs(), _ref_cs()
    port_r, ref_r = R1CS.from_test_cs(cs), RefR1CS.from_test_cs(rcs)
    z = get_backend(port_r.field).to_limbs(cs.scalar_inputs() + cs.scalar_aux())
    rp, wp = str(tmp_path / "r.npz"), str(tmp_path / "w.npz")
    if writer == "reference":
        fp = ref_utils.save_r1cs(rp, ref_r)
        ref_utils.save_witness(wp, ref_backend(ref_r.field).to_limbs(rcs.scalar_inputs() + rcs.scalar_aux()), fp,
                               shard=(1, 4))
        loaded = load_r1cs(rp, expect_fingerprint=fp)
        zl, meta = load_witness(wp, expect_fingerprint=fp)
        assert isinstance(loaded, R1CS)
    else:
        fp = save_r1cs(rp, port_r)
        save_witness(wp, from_numpy_u32(z), fp, shard=(1, 4))  # an int32 word tensor
        loaded = ref_utils.load_r1cs(rp, expect_fingerprint=fp)
        zl, meta = ref_utils.load_witness(wp, expect_fingerprint=fp)
        assert isinstance(loaded, RefR1CS)
    assert fp == shape_fingerprint(port_r) == ref_utils.shape_fingerprint(ref_r)
    assert loaded.names == port_r.names and loaded.coeff_table == port_r.coeff_table
    for m in ("a", "b", "c"):
        for f in ("rows", "cols", "coeff_ids"):
            np.testing.assert_array_equal(getattr(getattr(loaded, m), f), getattr(getattr(port_r, m), f))
    assert zl.dtype == np.uint32 and (zl == z).all()
    assert (meta["shard_index"], meta["shard_count"]) == (1, 4)

    sat = Satisfier(loaded, False, device="cpu")
    assert sat.is_satisfied(from_numpy_u32(zl))
    bad = zl.copy()
    bad[-1, 0] ^= 1
    vals = get_backend(port_r.field).from_limbs(bad)
    ok, row = port_r.eval_host(vals[: port_r.num_inputs], vals[port_r.num_inputs :])
    assert not ok and sat.which_is_unsatisfied(from_numpy_u32(bad)) == port_r.names[row]


def test_witness_provenance_across_packages(tmp_path):
    """The fingerprint and version checks hold whichever package wrote the
    file: a witness of another R1CS is refused, a checkpoint whose arrays
    no longer match its fingerprint is refused, and a word tensor's
    negative int32 words load as their uint32 bit patterns."""
    r = R1CS.from_test_cs(_port_cs())
    fp = save_r1cs(str(tmp_path / "r.npz"), r)
    words = torch.tensor([[-1, 0, 2**31 - 1, -(2**31)]], dtype=torch.int32)
    wp = str(tmp_path / "w.npz")
    save_witness(wp, words, fp)
    for load in (load_witness, ref_utils.load_witness):
        z, meta = load(wp, expect_fingerprint=fp)
        np.testing.assert_array_equal(z, words.numpy().view(np.uint32))
        assert (meta["shard_index"], meta["shard_count"]) == (0, 1)
        with pytest.raises(AssertionError):
            load(wp, expect_fingerprint="0" * 64)
    for load in (load_r1cs, ref_utils.load_r1cs):
        with pytest.raises(AssertionError):
            load(str(tmp_path / "r.npz"), expect_fingerprint="0" * 64)
    with np.load(str(tmp_path / "r.npz")) as f:
        arrays = dict(f)
    arrays["a_cols"] = arrays["a_cols"][::-1].copy()
    np.savez_compressed(str(tmp_path / "tampered.npz"), **arrays)
    for load in (load_r1cs, ref_utils.load_r1cs):
        with pytest.raises(AssertionError, match="fingerprint mismatch"):
            load(str(tmp_path / "tampered.npz"))
