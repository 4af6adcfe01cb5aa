"""The port's sharded steps in the limbs form: multihost_verdict_step
(sharded_witness_and_check) on a template that is not pure bits, with
free field inputs, and ShardedSatisfier in the limbs form, on W = 2
ranks of a gloo group on the CPU, spawned once for the file by the
port's launcher (tools/dryrun_multichip.RankJob, the ranks running
tests/torch_sharding_ranks.py, which imports no JAX), each rank passing
its own share of the inputs. Held bit for bit against the JAX package's
bellpepper_tpu/backend/sharding.py on a 2-device mesh of the conftest's
virtual CPU devices (use_pallas=False): the step's n_bad and limbs
shards in rank order, clean and with a corrupted pack; the satisfier's
verdicts and which_is_unsatisfied messages, clean and with a flipped
limb on either rank."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bellpepper_tpu.backend.sharding import ShardedSatisfier as RefSharded, default_mesh
from bellpepper_tpu.backend.sharding import sharded_witness_and_check as ref_step
from bellpepper_tpu.compile.witness_program import WitnessProgram as RefProgram
from bellpepper_tpu_torch import SCALAR
from bellpepper_tpu_torch.backend.words import to_numpy_u32
from bellpepper_tpu_torch.compile.tape import corrupted
from bellpepper_tpu_torch.tools.dryrun_multichip import RankJob

import test_torch_sharding
import torch_sharding_ranks as ranks

W = 2
FIELD_B = 8  # both templates' batch
FLIPS = ((6, 2), (1, 0))  # (instance, limb) of a flipped pack-output limb: on rank 1, on rank 0
RNG = np.random.default_rng(0x5EED_0013)


@pytest.fixture(scope="module")
def case():
    """The inputs, and the W = 2 ranks started on them (they run while
    the tests compute the references)."""
    _t, field_z3 = ranks.field_z3(RNG, FIELD_B, FLIPS)
    inp = {"field_batch": FIELD_B, "field_z3": field_z3, **ranks.free_field_inputs(RNG, FIELD_B, SCALAR.p)}
    r = test_torch_sharding._Ranks(RankJob(ranks.limbs_rank, W, inp, backend="gloo", device="cpu"))
    yield inp, r
    r.results()


def test_limbs_step_with_free_field_matches_reference(case):
    """multihost_verdict_step on a template that is not pure bits: the
    limbs form, with free field inputs passed beside the free bits. n_bad
    and the limbs shards in rank order, clean and with a corrupted pack,
    equal the reference's sharded_witness_and_check on a 2-device mesh."""
    inp, r = case
    t, tape = ranks.free_field_template()
    for key, tp in (("free_field", tape), ("free_field_bad", corrupted(tape, "pack", swap=True))):
        ref = RefProgram(tp)
        assert not ref.is_pure_bits and len(ref.free_field_slots) == 2
        step, sharding_ = ref_step(ref, t, FIELD_B, default_mesh(W), use_pallas=False)
        n_bad, z = step(*(jax.device_put(jnp.asarray(inp[k]), sharding_) for k in ("ff_bits", "ff_limbs")))
        assert (int(n_bad) == 0) == (key == "free_field"), (key, int(n_bad))
        results = r.results()
        assert all(res["world"] == W and res["foreign"] == [] for res in results)
        assert all(res[key][0] == int(n_bad) for res in results), key
        got = np.concatenate([to_numpy_u32(res[key][1]) for res in results])
        assert got.shape == (FIELD_B, t.num_aux + 1, 16)
        np.testing.assert_array_equal(got, np.asarray(z))


def test_sharded_satisfier_limbs_matches_reference(case):
    """ShardedSatisfier in the limbs form on W = 2 ranks: is_satisfied and
    the which_is_unsatisfied message, clean and with a flipped limb on
    either rank, equal to the reference's on a 2-device mesh."""
    inp, r = case
    t, _tape = ranks.field_template()
    sat = RefSharded(t, FIELD_B, default_mesh(W), use_pallas=False)
    want = [(sat.is_satisfied(sat.shard_z(z)), sat.which_is_unsatisfied(sat.shard_z(z))) for z in inp["field_z3"]]
    assert want[0] == (True, None)
    assert [w[1].split(":")[0] for w in want[1:]] == [f"instance {i}" for i, _ in FLIPS]
    for res in r.results():
        assert res["satisfier"] == want
