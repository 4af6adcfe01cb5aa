"""The port's Merkle tree step against the JAX package's
build_merkle_tree_step at 2 leaves on the CPU: the root bits and the
violation total, exactly (tolerance 0), on seeded random leaf digests
(the reference runs op by op, about 40 s a level on the CPU, so one
level); then the port's root of 8 leaves (three levels) against
tests/torch_circuits.py's pure-Python sha256 compression oracle (FIPS 180-4), and
the step's refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellpepper_tpu.compile.pipeline import build_merkle_tree_step as ref_step
from bellpepper_tpu.compile.witness_program import WitnessProgram as RefProgram
from bellpepper_tpu.native import NativeBuilder as RefBuilder
from bellpepper_tpu_torch import NativeBuilder, WitnessProgram
from bellpepper_tpu_torch.compile.pipeline import _STATE_TO_MSG_PERM, build_merkle_tree_step
from torch_circuits import SHA256_IV, sha256_compress, state_words

N_REF_LEAVES = 2
N_LEAVES = 8


def _const_iv_template(builder_cls):
    """One compression of 512 free message bits under the sha256 IV:
    (template, tape, digest views)."""
    nb = builder_cls()
    msg = [nb.alloc_bit() for _ in range(512)]
    out = nb.sha256_compression(msg, nb.sha256_iv())
    template, tape = nb.finish()
    return template, tape, [nb.view(v) for v in out]


@pytest.fixture(scope="module")
def leaves():
    return np.random.default_rng(0x5EED_0009).integers(0, 2, size=(N_LEAVES, 256)).astype(np.int32)


def _port_tree(leaves):
    template, tape, views = _const_iv_template(NativeBuilder)
    step = build_merkle_tree_step(WitnessProgram(tape), template, views, len(leaves), device="cpu")
    root, total = step(torch.from_numpy(leaves))
    return root.numpy(), int(total)


@pytest.fixture(scope="module")
def port_tree(leaves):
    return _port_tree(leaves)


def test_merkle_tree_matches_reference(leaves):
    """The reference runs op by op (jax.disable_jit): the same function,
    without its long compile on the CPU (about 55 s a level)."""
    ref_leaves = leaves[:N_REF_LEAVES]
    template, tape, views = _const_iv_template(RefBuilder)
    step = ref_step(RefProgram(tape), template, views, N_REF_LEAVES, use_pallas=False)
    with jax.disable_jit():
        root, total = step(jnp.asarray(ref_leaves.astype(np.uint32)))
        want = (np.asarray(root), int(total))
    root, total = _port_tree(ref_leaves)
    assert root.dtype == np.int32 and root.shape == (256,)
    assert np.array_equal(root.view(np.uint32), want[0]) and total == want[1] == 0


def test_merkle_root_matches_python_compressions(leaves, port_tree):
    """Each node is the compression of its children's digests, each word
    big-endian, under the sha256 IV; the digest bits are 8 words × 32,
    LSB first."""
    level = [state_words(row) for row in leaves]
    while len(level) > 1:
        level = [sha256_compress(SHA256_IV, level[i] + level[i + 1]) for i in range(0, len(level), 2)]
    assert state_words(port_tree[0]) == level[0] and port_tree[1] == 0


def test_state_to_msg_perm_is_the_reference_perm():
    from bellpepper_tpu.compile.pipeline import _STATE_TO_MSG_PERM as ref_perm

    assert np.array_equal(_STATE_TO_MSG_PERM, np.asarray(ref_perm))


def test_merkle_step_refusals():
    template, tape, views = _const_iv_template(NativeBuilder)
    prog = WitnessProgram(tape)
    for n in (1, 6):
        with pytest.raises(ValueError):
            build_merkle_tree_step(prog, template, views, n, device="cpu")
    step = build_merkle_tree_step(prog, template, views, 2, device="cpu")
    with pytest.raises(ValueError):
        step(torch.zeros((4, 256), dtype=torch.int32))
