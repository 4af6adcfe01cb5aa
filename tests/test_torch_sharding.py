"""The port's sharded steps and checkers (bellpepper_tpu_torch/backend/
sharding.py and RowShardedSatisfier given a group) against the JAX
package's bellpepper_tpu/backend/sharding.py on a 2-device mesh of the
virtual CPU devices that tests/conftest.py sets up (use_pallas=False).

The port runs on W = 2 ranks of a gloo group on the CPU, spawned once for
the file by the port's launcher (tools/dryrun_multichip.RankJob); the
ranks run tests/torch_sharding_ranks.py, which imports no JAX, while this
process computes the references. Compared exactly: the packed step's
(n_bad, first) and its witness shards in rank order on sha256 at 1,024
instances and on config 3's mixed packed layout, clean and with a
corrupted pack; RowShardedSatisfier's verdicts and which_is_unsatisfied
messages across the ranks on tests/test_row_sharding.py's
circuit, clean and corrupted, each rank holding only its own shard; and a
global first index past 2^32 against the Python int (where the
reference's uint32 offset wraps)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bellpepper_tpu import SCALAR as REF_SCALAR, TestConstraintSystem
from bellpepper_tpu.backend.sharding import (
    RowShardedSatisfier as RefRowSharded,
    default_mesh,
    sharded_packed_witness_and_check as ref_packed,
)
from bellpepper_tpu.compile.witness_program import WitnessProgram as RefProgram
from bellpepper_tpu.r1cs import R1CS as RefR1CS
from bellpepper_tpu_torch import SCALAR, COOMatrix, R1CS
from bellpepper_tpu_torch.backend.words import to_numpy_u32
from bellpepper_tpu_torch.compile.tape import corrupted
from bellpepper_tpu_torch.tools.dryrun_multichip import RankJob, sha256_template

import test_row_sharding
import torch_sharding_ranks as ranks

W = 2
SHA_B = C3_B = 1024  # 512 instances (16 packed words) a rank, the least the packed step takes
SENT = 0xFFFFFFFF
# a rank's share of the flagship's 4 × 32,768 sha256 instances' rows, so
# that rank 1's first violation lands past 2^32
SPAN = 131072 * 26352
OVERFLOW = [(0, SENT), (3, 1_000_000_007)]
RNG = np.random.default_rng(0x5EED_0011)


def _words(n_words, n_free):
    return RNG.integers(0, 1 << 32, size=(n_words, n_free), dtype=np.uint64).astype(np.uint32)


def _row_circuit():
    """tests/test_row_sharding.py's circuit, its R1CS as the reference's
    and as the port's, its inputs and its aux clean and with one value
    changed."""
    cs = TestConstraintSystem()
    test_row_sharding.build_circuit(cs)
    assert cs.is_satisfied()
    ref = RefR1CS.from_test_cs(cs)
    mats = {m: COOMatrix(rows=np.asarray(getattr(ref, m).rows), cols=np.asarray(getattr(ref, m).cols),
                         coeff_ids=np.asarray(getattr(ref, m).coeff_ids)) for m in "abc"}
    port = R1CS(field=SCALAR, num_inputs=ref.num_inputs, num_aux=ref.num_aux,
                num_constraints=ref.num_constraints, coeff_table=[int(v) for v in ref.coeff_table],
                names=list(ref.names), **mats)
    aux = [int(v) for v in cs.scalar_aux()]
    bad = list(aux)
    i = random.Random(0x5EED).randrange(len(bad))
    bad[i] = (bad[i] + 1) % REF_SCALAR.p
    return ref, port, [int(v) for v in cs.scalar_inputs()], [aux, bad]


class _Ranks:
    """The ranks' job, joined once, when a test first needs its results."""

    def __init__(self, job):
        self.job, self._results = job, None

    def results(self):
        if self._results is None:
            self._results = self.job.join(timeout=600)
        return self._results


@pytest.fixture(scope="module")
def case():
    """The inputs, and the ranks started on them (they run while the
    tests compute the references)."""
    row_ref, row_port, row_inputs, row_aux = _row_circuit()
    inp = {
        "sha_batch": SHA_B, "sha_free": _words(SHA_B // 32, 512),
        "c3_batch": C3_B, "c3_free": _words(C3_B // 32, 128),
        "row_r1cs": row_port, "row_inputs": row_inputs, "row_aux": row_aux,
        "overflow": OVERFLOW, "overflow_span": SPAN,
    }
    r = _Ranks(RankJob(ranks.sharding_rank, W, inp, backend="gloo", device="cpu"))
    yield inp, r, row_ref
    r.results()


def _packed_ref(tape, template, batch, free):
    step, sharding = ref_packed(RefProgram(tape), template, batch, default_mesh(W), use_pallas=False)
    nb, first, vals = step(jax.device_put(jnp.asarray(free), sharding))
    return (int(nb), int(first)), np.asarray(vals)


def _check_packed(results, key, want):
    (verdict, vals) = want
    for r in results:
        assert r[key][0] == verdict, (key, r["rank"])
    np.testing.assert_array_equal(np.concatenate([to_numpy_u32(r[key][1]) for r in results]), vals)


def test_packed_step_sha256_matches_reference(case):
    inp, r, _ = case
    t, tape = sha256_template()
    want = _packed_ref(tape, t, SHA_B, inp["sha_free"])
    assert want[0] == (0, SENT)
    results = r.results()
    assert [x["rank"] for x in results] == list(range(W)) and all(x["world"] == W for x in results)
    assert all(x["foreign"] == [] for x in results), "a rank loaded jax or the JAX package"
    _check_packed(results, "sha256", want)


def test_packed_step_config3_mixed_matches_reference(case):
    inp, r, _ = case
    t, tape = ranks.config3()
    for key, tp in (("config3", tape), ("config3_bad", corrupted(tape, "pack", swap=True))):
        want = _packed_ref(tp, t, C3_B, inp["c3_free"])
        assert (want[0] == (0, SENT)) == (key == "config3"), (key, want[0])
        _check_packed(r.results(), key, want)


def test_row_sharded_across_ranks_matches_reference(case):
    inp, r, row_ref = case
    sat = RefRowSharded(row_ref, default_mesh(W), use_pallas=False)
    want = [(sat.is_satisfied(z), sat.which_is_unsatisfied(z))
            for z in (sat.z_from_assignments(inp["row_inputs"], aux) for aux in inp["row_aux"])]
    host_ok, host_row = row_ref.eval_host(inp["row_inputs"], inp["row_aux"][1])
    assert want == [(True, None), (host_ok, None if host_ok else row_ref.names[host_row])]
    for res in r.results():
        assert res["row_shards"] == [1, W]  # its own shard's tables only
        assert res["row"] == want


def test_global_first_past_2_32_is_exact(case):
    """Rank 1's first violation, offset by one rank's share of the
    flagship batch's rows, lies past 2^32: the verdict is the Python int
    (the reference adds the offset in uint32, sharding.py:270-272, and
    wraps)."""
    _inp, r, _ = case
    want_first = 1 * SPAN + OVERFLOW[1][1]
    assert want_first > 1 << 32
    for res in r.results():
        assert res["overflow"] == (OVERFLOW[0][0] + OVERFLOW[1][0], want_first)


def test_replicate_matches_reference():
    """The port's R1CS.replicate (the dry run's 3-copy system) equals the
    reference's on the same template, array for array."""
    t, _tape = ranks.config3()
    got, want = t.replicate(3), RefR1CS.replicate(t, 3)
    assert (got.num_inputs, got.num_aux, got.num_constraints, got.names) == (
        want.num_inputs, want.num_aux, want.num_constraints, want.names)
    assert got.coeff_table == want.coeff_table
    for m in "abc":
        for key in ("rows", "cols", "coeff_ids"):
            a, b = getattr(getattr(got, m), key), getattr(getattr(want, m), key)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
