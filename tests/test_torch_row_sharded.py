"""The port's row-sharded layout and checker
(bellpepper_tpu_torch/backend/row_sharded.py) against the JAX package's
(bellpepper_tpu/backend/matvec.py build_row_sharded_parts and
bellpepper_tpu/backend/sharding.py RowShardedSatisfier on the 8-device
virtual CPU mesh that tests/conftest.py sets up, use_pallas=False): the
layout array for array at 1, 2, 4 and 8 shards, and the verdicts in the
limbs and bits witness forms, clean and corrupted; on the circuit of
tests/test_row_sharding.py the row which_is_unsatisfied names is the host
oracle's (R1CS.eval_host)."""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellpepper_tpu import SCALAR, TestConstraintSystem
from bellpepper_tpu.backend.matvec import build_row_sharded_parts as ref_parts
from bellpepper_tpu.backend.sharding import RowShardedSatisfier as RefSatisfier, default_mesh
from bellpepper_tpu.r1cs import R1CS, COOMatrix
from bellpepper_tpu_torch.backend.row_sharded import RowShardedSatisfier, build_row_sharded_parts
from bellpepper_tpu_torch.backend.words import from_numpy_u32

import test_row_sharding
from test_torch_mixed import _one_torch_thread  # noqa: F401  (autouse)

P = SCALAR.p
SHARDS = [1, 2, 4, 8]


@functools.lru_cache(maxsize=None)
def _num_circuit():
    """tests/test_row_sharding.py's circuit (50 random mul/add/square
    steps over 4 inputs) and its witness."""
    cs = TestConstraintSystem()
    test_row_sharding.build_circuit(cs)
    assert cs.is_satisfied()
    return R1CS.from_test_cs(cs), list(cs.scalar_inputs()), list(cs.scalar_aux())


@functools.lru_cache(maxsize=None)
def _bit_circuit(n_in=12, n_gates=60, seed=9):
    """A random boolean circuit of 0/1 values: booleanity rows of the free
    bits, then AND (x·y = out) and XOR (2x·y = x + y − out) gates over
    earlier bits. Returns (r1cs, bit witness)."""
    rng = np.random.default_rng(seed)
    bits = [1] + [int(b) for b in rng.integers(0, 2, n_in)]
    rows = {m: [] for m in "abc"}
    r = 0

    def entry(m, col, cid):
        rows[m].append((r, col, cid))

    for x in range(1, n_in + 1):
        entry("a", x, 0)
        entry("b", 0, 0)
        entry("b", x, 2)
        r += 1
    for _ in range(n_gates):
        x, y = (int(v) for v in rng.integers(1, len(bits), 2))
        out = len(bits)
        if rng.integers(0, 2):
            bits.append(bits[x] & bits[y])
            entry("a", x, 0)
            entry("b", y, 0)
            entry("c", out, 0)
        else:
            bits.append(bits[x] ^ bits[y])
            entry("a", x, 1)
            entry("b", y, 0)
            entry("c", x, 0)
            entry("c", y, 0)
            entry("c", out, 2)
        r += 1
    mats = {
        m: COOMatrix(rows=np.asarray([e[0] for e in v], np.int32), cols=np.asarray([e[1] for e in v], np.int32),
                     coeff_ids=np.asarray([e[2] for e in v], np.int32))
        for m, v in rows.items()
    }
    r1cs = R1CS(field=SCALAR, num_inputs=1, num_aux=len(bits) - 1, num_constraints=r, **mats,
                coeff_table=[1, 2, P - 1], names=[f"row {i}" for i in range(r)])
    return r1cs, np.asarray(bits, np.uint32)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_parts_match_reference(n_shards):
    for r1cs in (_num_circuit()[0], _bit_circuit()[0]):
        for cd in (False, True):
            parts, meta = build_row_sharded_parts(r1cs, n_shards, with_coeff_digits=cd)
            want, want_meta = ref_parts(r1cs, n_shards, with_coeff_digits=cd)
            assert {n: set(v) for n, v in parts.items()} == {n: set(v) for n, v in want.items()}
            for n in "abc":
                for key, arr in want[n].items():
                    assert parts[n][key].dtype == arr.dtype
                    np.testing.assert_array_equal(parts[n][key], arr)
            assert set(meta) == set(want_meta)
            np.testing.assert_array_equal(meta["row_origin"], want_meta["row_origin"])
            assert meta["row_origin"].dtype == want_meta["row_origin"].dtype
            for key in ("buckets", "rows_per_shard", "rows_padded", "coeff_table", "zero_id"):
                assert meta[key] == want_meta[key], key


def _verdict(sat, z):
    return tuple(int(x) for x in sat._check(z))


@pytest.mark.parametrize("n_shards", SHARDS)
def test_limbs_satisfier_matches_reference(n_shards):
    r1cs, inputs, aux = _num_circuit()
    sat = RowShardedSatisfier(r1cs, n_shards=n_shards, device="cpu")
    want = RefSatisfier(r1cs, default_mesh(n_shards), use_pallas=False)
    rnd = random.Random(n_shards)
    for k in range(3):
        a = list(aux)
        if k:
            i = rnd.randrange(len(a))
            a[i] = (a[i] + rnd.randrange(1, P)) % P
        got = _verdict(sat, sat.z_from_assignments(inputs, a))
        assert got == tuple(int(x) for x in want._check(want.z_from_assignments(inputs, a)))
        assert (got[0] == 0) == (k == 0)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_bits_satisfier_matches_reference(n_shards):
    r1cs, bits = _bit_circuit()
    sat = RowShardedSatisfier(r1cs, n_shards=n_shards, witness_form="bits", device="cpu")
    want = RefSatisfier(r1cs, default_mesh(n_shards), use_pallas=False, witness_form="bits")
    for flip in (None, 5, len(bits) - 1, 20):
        z = bits.copy()
        if flip is not None:
            z[flip] ^= 1
        got = _verdict(sat, from_numpy_u32(z, "cpu"))
        assert got == tuple(int(x) for x in want._check(jnp.asarray(z)))
        host_ok, host_row = r1cs.eval_host([int(z[0])], [int(v) for v in z[1:]])
        assert got[0] == 0 if host_ok else got[1] == host_row
    assert flip is not None and got[0] > 0


def test_which_is_unsatisfied_matches_host_oracle():
    """tests/test_row_sharding.py's check at 4 shards: satisfied, then one
    corrupted aux value at a time named as the host oracle names it."""
    r1cs, inputs, aux = _num_circuit()
    sat = RowShardedSatisfier(r1cs, n_shards=4, device="cpu")
    z = sat.z_from_assignments(inputs, aux)
    assert sat.is_satisfied(z) and sat.which_is_unsatisfied(z) is None
    rnd = random.Random(0x5962BE3D)
    for _ in range(4):
        a = list(aux)
        i = rnd.randrange(len(a))
        a[i] = (a[i] + 1) % P
        host_ok, host_row = r1cs.eval_host(inputs, a)
        got = sat.which_is_unsatisfied(sat.z_from_assignments(inputs, a))
        assert got == (None if host_ok else r1cs.names[host_row])


def test_zero_constraint_system_and_bad_arguments():
    e = COOMatrix(rows=np.zeros(0, np.int32), cols=np.zeros(0, np.int32), coeff_ids=np.zeros(0, np.int32))
    r0 = R1CS(field=SCALAR, num_inputs=1, num_aux=3, num_constraints=0, a=e, b=e, c=e, coeff_table=[1])
    sat = RowShardedSatisfier(r0, n_shards=2, device="cpu")
    z = sat.z_from_assignments([1], [5, 6, 7])
    assert sat.is_satisfied(z) and _verdict(sat, z) == (0, 0xFFFFFFFF)
    r1cs, inputs, aux = _num_circuit()
    with pytest.raises(ValueError, match="witness_form"):
        RowShardedSatisfier(r1cs, device="cpu", witness_form="mixed")
    sat = RowShardedSatisfier(r1cs, n_shards=2, device="cpu")
    z = sat.z_from_assignments(inputs, aux)
    for bad in (z[:-1], z.to(torch.int64), z[:, 0]):
        with pytest.raises(ValueError, match="z must be"):
            sat.is_satisfied(bad)
