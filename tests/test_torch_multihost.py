"""The port's multi-process glue (bellpepper_tpu_torch/utils/multihost.py)
and its sharded unpacked step: the single-process branch and the launcher
contract as tests/test_multihost.py pins the reference's; the group, the
global batch and the checkers in one W = 1 gloo group in this process; and
multihost_verdict_step (sharded_witness_and_check) on W = 2 ranks of a
gloo group on the CPU, spawned once for the file by the port's launcher
(tools/dryrun_multichip.RankJob, the ranks running
tests/torch_sharding_ranks.py, which imports no JAX), each rank passing
its own share of the free bits. Their n_bad and witness shards in rank
order equal the JAX package's sharded_witness_and_check on a 2-device mesh
of the conftest's virtual CPU devices (use_pallas=False): sha256 in the
bits form, called as the reference is on the ranks' global_mesh(), and a
corrupted config-2 program whose rows fail, on their group. The ranks'
default_mesh() spans both, default_mesh(1) leaves rank 1 out, and
RowShardedSatisfier on default_mesh() names the row that the
single-device checker names. The limbs form is in
tests/test_torch_sharded_limbs.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from bellpepper_tpu.backend.sharding import default_mesh
from bellpepper_tpu.backend.sharding import sharded_witness_and_check as ref_step
from bellpepper_tpu.compile.witness_program import WitnessProgram as RefProgram
from bellpepper_tpu_torch import RowShardedSatisfier, TemplatedSatisfier, WitnessProgram, build_packed_production_step
from bellpepper_tpu_torch.backend import sharding
from bellpepper_tpu_torch.backend.sharding import ShardedSatisfier, sharded_packed_witness_and_check
from bellpepper_tpu_torch.backend.words import from_numpy_u32, to_numpy_u32
from bellpepper_tpu_torch.compile.tape import corrupted
from bellpepper_tpu_torch.tools.dryrun_multichip import RankJob, free_port, sha256_template
from bellpepper_tpu_torch.utils.multihost import (
    global_group,
    init_group,
    initialize_multihost,
    make_global_batch,
    multihost_verdict_step,
)

import test_torch_sharding
import torch_sharding_ranks as ranks

W = 2
SHA_B, C2_B = 4, 64
RNG = np.random.default_rng(0x5EED_0012)


@pytest.fixture(scope="module")
def case():
    """The free bits, and the W = 2 ranks started on them (they run while
    the tests compute the references)."""
    c2_row_z = RNG.integers(0, 2, size=ranks.config2()[0].num_aux + 1).astype(np.uint32)
    c2_row_z[0] = 1  # ONE
    inp = {"sha_free": RNG.integers(0, 2, size=(SHA_B, 512)).astype(np.uint32),
           "c2_free": RNG.integers(0, 2, size=(C2_B, 96)).astype(np.uint32), "c2_row_z": c2_row_z}
    r = test_torch_sharding._Ranks(RankJob(ranks.multihost_rank, W, inp, backend="gloo", device="cpu"))
    yield inp, r
    r.results()


def test_multihost_verdict_step_matches_reference(case):
    inp, r = case
    t2, tape2 = ranks.config2()
    for key, (t, tape), free, B in (("sha256", sha256_template(), inp["sha_free"], SHA_B),
                                    ("config2_bad", (t2, corrupted(tape2, "xor")), inp["c2_free"], C2_B)):
        step, sharding_ = ref_step(RefProgram(tape), t, B, default_mesh(W), use_pallas=False)
        n_bad, z = step(jax.device_put(jnp.asarray(free), sharding_))
        assert (int(n_bad) == 0) == (key == "sha256"), (key, int(n_bad))
        results = r.results()
        assert all(res["world"] == W and res["foreign"] == [] for res in results)
        for res in results:
            assert res[key][0] == int(n_bad), key
        got = np.concatenate([to_numpy_u32(res[key][1]) for res in results])
        np.testing.assert_array_equal(got, np.asarray(z))
    assert [res["mesh"] for res in results] == [(W, ("data",), True, 1, False), (W, ("data",), True, 1, True)]
    one = RowShardedSatisfier(t2, n_shards=W, witness_form="bits", device="cpu")
    zr = from_numpy_u32(inp["c2_row_z"])
    want = (W, 1, one.is_satisfied(zr), one.which_is_unsatisfied(zr))
    assert want[3] is not None and all(res["row_mesh"] == want for res in results)


def test_initialize_single_process_fallback(monkeypatch):
    """No launcher variables: stays single-process, returns False, makes
    no group; partial or invalid variables do the same (as
    tests/test_multihost.py:22-30 pins the reference)."""
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_multihost() is False
    assert initialize_multihost("127.0.0.1:1234", num_processes=1) is False
    assert initialize_multihost("127.0.0.1:1234", 4, -1) is False
    monkeypatch.setenv("NUM_PROCESSES", "2")
    assert initialize_multihost() is False  # no coordinator
    assert not dist.is_initialized()


def test_backend_follows_the_device(monkeypatch):
    """Without a named backend the group takes NCCL for the card, which
    does not exist here: init_group raises before any group is made, and
    does not fall back to gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_group("127.0.0.1:1", 1, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharding.rank_device()
    assert not dist.is_initialized()
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="no process group"):
        sharding.default_group()


@pytest.fixture(scope="module")
def group1():
    """A W = 1 gloo group in this process."""
    assert init_group(f"127.0.0.1:{free_port()}", 1, 0, device="cpu") == "gloo"
    try:
        yield global_group()
    finally:
        dist.destroy_process_group()


def test_group_and_global_batch_single_rank(group1):
    assert group1 is dist.group.WORLD and sharding.default_group(1) is group1
    assert dist.get_world_size(group1) == 1 and dist.get_backend(group1) == "gloo"
    assert sharding.rank_device(group1, "cpu") == torch.device("cpu")
    local = np.arange(12, dtype=np.uint32).reshape(12, 1) | np.uint32(1 << 31)
    arr = make_global_batch(local, None, group=group1, device="cpu")
    assert arr.dtype == torch.int32 and arr.device == torch.device("cpu")
    np.testing.assert_array_equal(to_numpy_u32(arr), local)
    np.testing.assert_array_equal(to_numpy_u32(make_global_batch(arr, None, device="cpu")), local)


def test_w1_in_process_matches_single_device(group1):
    """With one rank every sharded function is its single-device
    counterpart: ShardedSatisfier against TemplatedSatisfier, the packed step
    against build_packed_production_step, the unpacked step's witness
    against the evaluator's, RowShardedSatisfier given the group against
    it without one."""
    t, z3s = ranks.field_z3(RNG, 8, ((6, 2), (1, 0)))
    sat = ShardedSatisfier(t, 8, group=group1, device="cpu")
    one = TemplatedSatisfier(t, 8, device="cpu")
    for z in z3s:
        zl = sat.shard_z(z)
        assert (sat.is_satisfied(zl), sat.which_is_unsatisfied(zl)) == (
            one.is_satisfied(zl), one.which_is_unsatisfied(zl))
    assert not sat.is_satisfied(zl)

    t, tape = ranks.config3()
    for tp in (tape, corrupted(tape, "pack", swap=True)):
        prog = WitnessProgram(tp)
        free = from_numpy_u32(RNG.integers(0, 1 << 32, size=(16, 128), dtype=np.uint64).astype(np.uint32))
        step, shard = sharded_packed_witness_and_check(prog, t, 512, None, group=group1, device="cpu")
        nb, first, vals = step(shard(free))
        want = build_packed_production_step(prog, t, 512, device="cpu")(free[None])
        assert (int(nb), int(first)) == tuple(int(v) for v in want)
        assert torch.equal(vals, prog.build_packed_mixed(device="cpu")(free)[0])

    t, tape = ranks.config2()
    prog = WitnessProgram(tape)
    free = RNG.integers(0, 2, size=(C2_B, 96)).astype(np.uint32)
    step, shard = multihost_verdict_step(prog, t, C2_B, None, device="cpu")
    n_bad, z = step(shard(free))
    assert int(n_bad) == 0 and torch.equal(z, prog.build(device="cpu")(from_numpy_u32(free))[0])

    r1cs = ranks.config2()[0]
    zb = z[5].clone()
    zb[40] ^= 1
    for zz in (z[5], zb):
        got = RowShardedSatisfier(r1cs, witness_form="bits", device="cpu", group=group1)._check(zz)
        want = RowShardedSatisfier(r1cs, witness_form="bits", device="cpu")._check(zz)
        assert tuple(int(v) for v in got) == tuple(int(v) for v in want)
    assert int(want[0]) > 0


def test_bad_arguments(group1):
    t, tape = ranks.config3()
    prog = WitnessProgram(tape)
    with pytest.raises(ValueError, match="512"):
        sharded_packed_witness_and_check(prog, t, 256, None, group=group1, device="cpu")
    step, _ = sharded_packed_witness_and_check(prog, t, 512, None, group=group1, device="cpu")
    with pytest.raises(ValueError, match="16 words"):
        step(torch.zeros((8, 128), dtype=torch.int32))
    with pytest.raises(ValueError, match="witness_form"):
        ShardedSatisfier(t, 32, group=group1, witness_form="mixed", device="cpu")
    with pytest.raises(ValueError, match="shards"):
        RowShardedSatisfier(t, n_shards=2, device="cpu", group=group1)
    sat = ShardedSatisfier(t, 32, group=group1, witness_form="bits", device="cpu")
    with pytest.raises(ValueError, match="leading axis"):
        sat.shard_z(np.zeros((16, t.num_aux + 1), np.uint32))
