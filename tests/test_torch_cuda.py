"""The port's CUDA kernels and step on the card (marker `cuda`; each test
skips where torch sees no CUDA device). This file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every kernel is held bit-exact to its plain version at ragged sizes (the
kernels mask the edge themselves), its launch is counted, the field
backend's inversion is a ladder of mul launches that Python's pow agrees
with, and the packed sha256 step, the config-1 field step in the mixed and
the limbs forms, the bits form at a ragged batch, config 3's mixed packed
step, a step with free field inputs and the Satisfier on the card give
the CPU's verdicts, clean and corrupted (the Satisfier on both of its
routes: the templated limbs check and, given use_pallas=False, the
DeviceR1CS route); the tracer's `check` span reads the verdict's device
time, and a phase a device time. The chained witness replays one
CUDA graph a block, equal to an eager loop of the same evaluator, cached
for each batch; the Merkle step and the num family's mixed block equal
the CPU. mul and mul_digits hold on operands in [p, 2^256) (config 5's
raw witness values), reduce_digits on limb-major and element-major sums
and at their corners against Python ints, and config 5's check at 2^16
rows gives the CPU's verdicts on both routes and in RowShardedSatisfier.
The dry run of the sharded steps and checkers passes on one rank of an
NCCL group. Circuits of the Python frontend (ShapeCS, TapeCS,
TestConstraintSystem) give the CPU's verdicts on the card, and the card's
Satisfier names what TestConstraintSystem names. Below 253 bits
(tests/torch_small_fields.py: Goldilocks, 2^127 − 1, P-192's prime,
Jubjub's scalar field): the canonical bits form of the fold matvec, mul,
mul_digits (raw a), reduce_digits, chain and the canonical limbs_matvec
equal their plain versions and Python ints, and the flagship packed step,
config 1 in the mixed and limbs forms, both Satisfier routes and config
5's check give the CPU's verdicts on the card. The packed check's verdict
fold equals its plain version and a Python loop over bits on every case
of tests/torch_verdict_cases.py, on column slices (vector and scalar
loads), at the benchmark's fold shapes and past 2^31 words. The product
rows' operand_mulcmp equals its plain version and Python ints on rows of
every operand shape (tests/torch_operand_cases.py) over Pallas, Vesta and
BLS12-381, with and without u32 values, past 2^31 limb words, and gives
a faulted MinRoot chunk the verdict of the eager route it replaces. The
packed evaluator's addmany kernel equals its plain version at every
addmany stage of the sha256, blake2s, config 2 and config 3 templates (on
random words, all-ones words and with negated and constant views) from
Bw 1 to the cells' 65,536, and at shapes no template emits, one launch a
stage in every packed step.

At each path's own tables the kernels equal their plain versions (the
packed checks of sha256, blake2s and configs 2 and 3, the sha256 and
config-1 limbs checks, the num block's rest and product rows, config 5's
chunks and row shard), also at the paths' own sizes: the benchmark's
sha256 and blake2s chunks of 2^21 instances (with the launches of their
steps), mul and reduce_digits at 2^20, mul_digits up to 2^21 raw
operands, config 4's chain of 1,024 blocks and tree of 1,024 leaves, and
the sha256 limbs step at 4,096 a chunk under a 40 GiB peak. Each path's
probes hold: planted faults found at their instance and row, the field
evaluator against Python ints, the chained and Merkle steps against the
sha256 oracle of tests/torch_circuits.py, the sharded paths on two gloo
ranks sharing the card against one device, and the reference's API
called with no device launching what the calls with a device launch."""

import hashlib
import random
import statistics
import time

import numpy as np
import pytest
import torch

import torch_sharding_ranks as ranks
from bellpepper_tpu_torch import (
    PALLAS_SCALAR,
    SCALAR,
    VESTA_SCALAR,
    NativeBuilder,
    PipelinedSatisfier,
    Satisfier,
    TemplatedSatisfier,
    WitnessProgram,
    build_chained_production_step,
    build_chained_witness,
    build_chunked_check,
    build_merkle_tree_step,
    build_packed_chunked_witness,
    build_packed_production_step,
    build_production_step,
    build_row_chunked_eval,
    build_templated_check,
    pack_bits,
    which_from_flat,
)
from bellpepper_tpu_torch.backend import field_kernels as fk, op_rate
from bellpepper_tpu_torch.backend.check_common import Products
from bellpepper_tpu_torch.backend.field_backend import FieldBackend, get_backend
from bellpepper_tpu_torch.backend.limbs import LimbsCheck
from bellpepper_tpu_torch.backend.matvec import ROW_CLASSES, build_packed_parts
from bellpepper_tpu_torch.backend.row_chunked import _chunk, _ell_digit_sums, _gather_rows
from bellpepper_tpu_torch.backend.words import from_numpy_u32, to_numpy_u32
from bellpepper_tpu_torch.compile.tape import SnapshotTape, TapeCS, corrupted
from bellpepper_tpu_torch.compile.witness_program import SCAN_OPS, SRC_ROW, _detect_linear_chain
from bellpepper_tpu_torch.config import Config, default_config, set_default_config
from bellpepper_tpu_torch import RowShardedSatisfier, build_row_chunked_check, build_row_chunked_product
from bellpepper_tpu_torch.tools.config5 import config5_r1cs, config5_z, flipped_first_row
from bellpepper_tpu_torch.tools.dryrun_multichip import RankJob, dryrun_multichip
from bellpepper_tpu_torch import R1CS, TestConstraintSystem
from bellpepper_tpu_torch.gadgets.multieq import MultiEq
from bellpepper_tpu_torch.gadgets.uint32 import UInt32
from bellpepper_tpu_torch.r1cs import ShapeCS
from bellpepper_tpu_torch.utils import load_r1cs, load_witness, profiling, save_r1cs, save_witness
from perfbench.kinds.field_step import add_mod_p
from perfbench.lib import bench
from torch_circuits import (
    FRONTEND,
    SHA256_IV,
    blake2s_circuit,
    chain_steps,
    col_int,
    config1,
    config1_tape,
    config2_circuit,
    config3_circuit,
    counted,
    digit_sum_corners,
    eager_chain,
    eager_product_bad,
    fe_config2,
    fe_sha256,
    native_prog,
    native_sha256,
    oracle_chain,
    python_int_first_bad,
    row_sums_int,
    sha256_compress,
    state_words,
    z_ints,
)
from torch_operand_cases import operand_rows, shift_field_rows
from torch_small_fields import GOLDILOCKS, JUBJUB_FR, SMALL_FIELDS
from torch_verdict_cases import CASES, folds, python_verdict

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
                                            (64, 4, 3, 2, 1), (256, 2, 1, 1, 1025), (256, 2, 1, 3, 33),
                                            (256, 3, 1, 4, 97)])
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


def _limb_cols(vals, n_limbs):
    """uint32[n_limbs, len(vals)] 16-bit limbs of Python ints."""
    return np.asarray([[(v >> (16 * l)) & 0xFFFF for v in vals] for l in range(n_limbs)], np.uint32)


def _mulcmp_edge_columns(field, N, seed):
    """(a, b, c) columns at the edges of mulcmp's domain (a, b < 2^266,
    c ≤ p·2^11), cycled to N: every limb at its maximum, c = 0 and c =
    p·2^11, a + k·p beside a, a·b − c one off a multiple of p; then
    random columns."""
    p = field.p
    rnd = random.Random(seed)
    top, cmax = (1 << 266) - 1, p << 11
    cols = []
    for a in (0, 1, p - 1, top, (p - 1) + p * ((top - p) // p)):
        for b in (1, p - 1, top):
            prod = a * b % p
            for c in (0, cmax, prod, prod + p * ((cmax - prod) // p), (prod + 1) % p, (prod + p - 1) % p,
                      cmax - (cmax - prod) % p - p):
                cols.append((a, b, c))
    while len(cols) < N:
        a, b = rnd.randrange(1 << 266), rnd.randrange(1 << 266)
        cols.append((a, b, (a * b + rnd.choice((-1, 0, 0, 1))) % p + p * rnd.randrange(2000)))
    return cols[:N] if N > 1 else [(top, top, cmax)]


@pytest.mark.cuda
@pytest.mark.parametrize("field", [SCALAR, PALLAS_SCALAR], ids=lambda f: f.name)
@pytest.mark.parametrize("N", [1, 255, 257, 1001])
def test_mulcmp_edges_on_card(cuda, field, N):
    """The domain's edges against the plain version and Python ints, at N
    of one column and N that is not a multiple of the block (256)."""
    cols = _mulcmp_edge_columns(field, N, N)
    ops = [from_numpy_u32(_limb_cols([col[t] for col in cols], 17), cuda) for t in range(3)]
    got = fk.mulcmp(*ops, field)
    torch.cuda.synchronize()
    want = [int((a * b - c) % field.p != 0) for a, b, c in cols]
    assert got.cpu().tolist() == want
    assert torch.equal(got, fk.mulcmp_plain(*ops, field))


@pytest.mark.cuda
@pytest.mark.parametrize("n_reps", [1, 30])
@pytest.mark.parametrize("N", [1, 33, 777])
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
def test_chain_edges_on_card(cuda, descs, n_ext, N, n_reps):
    """Operands 0, 1 and p − 1 in every combination in the first columns
    (x0 and each external operand), N not a multiple of the block (32),
    one repetition and config 1's 30: against the plain version, and each
    column's every step against Python ints."""
    p = SCALAR.p
    rnd = random.Random(N * 31 + n_reps)
    corners = (0, 1, p - 1)
    cols = [[corners[(i // 3**k) % 3] if i < 3 ** (n_ext + 1) else rnd.randrange(p) for i in range(N)]
            for k in range(n_ext + 1)]
    x0 = from_numpy_u32(_limb_cols(cols[0], 16), cuda)
    ext = torch.cat([from_numpy_u32(_limb_cols(cols[1 + k], 16), cuda) for k in range(n_ext)])
    got = fk.chain(x0, ext, descs, n_reps, SCALAR)
    torch.cuda.synchronize()
    assert torch.equal(got, fk.chain_plain(x0, ext, descs, n_reps, SCALAR))
    out = got.cpu().numpy().astype(np.uint32).astype(object)
    for i in range(N):
        x = cols[0][i]
        for step in range(n_reps * len(descs)):
            op, sa, sb = descs[step % len(descs)]
            va, vb = (x if s == "prev" else cols[1 + s][i] for s in (sa, sb))
            x = va * vb % p if op == "fmul" else (va + vb) % p
            assert sum(int(out[16 * step + l, i]) << (16 * l) for l in range(16)) == x, (i, step)


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
    for t in (tape, SnapshotTape(tape.field, (ni, na, bad_ops, free))):
        prog = WitnessProgram(t)
        want = build_packed_production_step(prog, template, 512, device="cpu")(from_numpy_u32(words))
        got = build_packed_production_step(prog, template, 512, device=cuda)(
            from_numpy_u32(words, cuda)
        )
        assert tuple(int(v) for v in got) == tuple(int(v) for v in want)


@pytest.mark.cuda
def test_traced_check_device_time_on_card(cuda):
    """The tracer's `check` span on the sha256 verdict at 2^18 instances:
    its CUDA-event time lies within 5% of a host clock from the call to a
    synchronize (medians of 3), and a phase around the same call reports a
    device time."""
    template, prog = native_sha256()
    B = 1 << 18
    evaluator, check = build_packed_parts(prog, template, B, cuda)
    vals, _ = evaluator.slot_major(_u32((B // 32, len(prog.free_slots)), cuda))
    check.verdict_slot_major(vals)  # warm
    host, device = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        with profiling.tracing():
            t0 = time.perf_counter()
            nb, first = check.verdict_slot_major(vals)
            torch.cuda.synchronize()
            host.append(time.perf_counter() - t0)
        device.append(profiling.trace_report(reset=True)["check"]["device_total_s"])
    assert (int(nb), int(first)) == (0, 0xFFFFFFFF)
    h, d = statistics.median(host), statistics.median(device)
    assert abs(d - h) <= 0.05 * h, (host, device)
    profiling.phase_report(reset=True)
    with profiling.phase("verdict"):
        check.verdict_slot_major(vals)
    rep = profiling.phase_report(reset=True)["verdict"]
    assert rep["device_total_s"] > 0 and rep["device_mean_s"] > 0


def _canonical(field, n, seed, dev):
    """int32[16, n] limb-major canonical values, corners (0, 1, p − 1)
    first."""
    p = field.p
    rnd = random.Random(seed)
    vals = [0, 1, p - 1] + [rnd.randrange(p) for _ in range(n - 3)]
    x = np.asarray([[(v >> (16 * l)) & 0xFFFF for v in vals] for l in range(16)], np.uint32)
    return from_numpy_u32(x, dev)


def _mul_corners(field):
    """0, 1, p − 1, p − 2, and the canonical values whose limbs below the
    top one are all 0xFFFF: top limb 0, and top limb one below p's."""
    p = field.p
    low = (1 << 240) - 1
    return [0, 1, p - 1, p - 2, low, (((p >> 240) - 1) << 240) | low]


def _lm_ints(t):
    """int32[16, N] limb-major → Python ints."""
    x = to_numpy_u32(t).astype(object)
    return [sum(int(x[l, i]) << (16 * l) for l in range(16)) for i in range(x.shape[1])]


FIELDS3 = [SCALAR, PALLAS_SCALAR, VESTA_SCALAR]


@pytest.mark.cuda
@pytest.mark.parametrize("field", FIELDS3, ids=lambda f: f.name)
@pytest.mark.parametrize("N", [1, 3, 31, 32, 33, 1000, 8192, 426920, 1 << 20])
def test_mul_on_card(cuda, field, N):
    """Every corner pair first (as far as N reaches), the rest random;
    bit-exact against mul_plain and, at every column up to 8,192 and at
    the corners and 2,000 random columns above, against Python ints. N
    around one block of 32 threads, the variant's 8,192, the Satisfier's
    426,920 and the row-sharded check's and config 5's 2^20."""
    p = field.p
    c = _mul_corners(field)
    pairs = [(x, y) for x in c for y in c][:N]
    rnd = random.Random(N)
    av = [x for x, _ in pairs] + [rnd.randrange(p) for _ in range(N - len(pairs))]
    bv = [y for _, y in pairs] + [rnd.randrange(p) for _ in range(N - len(pairs))]
    a = from_numpy_u32(FieldBackend.to_limbs(av).T.copy(), cuda)
    b = from_numpy_u32(FieldBackend.to_limbs(bv).T.copy(), cuda)
    before = fk.mul.launches
    got = fk.mul(a, b, field)
    torch.cuda.synchronize()
    assert fk.mul.launches == before + 1
    assert torch.equal(got, fk.mul_plain(a, b, field))
    cols = list(range(N)) if N <= 8192 else list(range(len(pairs))) + rnd.sample(range(N), 2000)
    got_ints = _lm_ints(got[:, cols])
    assert got_ints == [av[i] * bv[i] % p for i in cols]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["last", "dim1"])
@pytest.mark.parametrize("field", FIELDS3, ids=lambda f: f.name)
def test_backend_inv_on_card(cuda, field, layout):
    """FieldBackend.inv on card tensors is the ladder of mul launches:
    Python's pow(x, p − 2, p) at every element (0 maps to 0), the CPU's
    bits, and one launch a squaring and a set bit of p − 2 after the top
    one; mul and square one launch each."""
    p = field.p
    be = get_backend(field)
    vals = _mul_corners(field) + [random.Random(7).randrange(p) for _ in range(1018)]
    x = torch.from_numpy(FieldBackend.to_limbs(vals).view(np.int32))  # [1024, 16]
    dim = -1
    if layout == "dim1":  # [W, 16, B] as the witness evaluator holds it
        x, dim = x.reshape(2, 512, 16).transpose(1, 2).contiguous(), 1
    e = p - 2
    before = fk.mul.launches
    got = be.inv(x.to(cuda), dim)
    torch.cuda.synchronize()
    assert fk.mul.launches == before + e.bit_length() - 1 + bin(e).count("1") - 1
    assert got.shape == x.shape and torch.equal(got.cpu(), be.inv(x, dim))
    flat = got.cpu() if layout == "last" else got.cpu().transpose(1, 2)
    assert FieldBackend.from_limbs(flat) == [pow(v, e, p) for v in vals]
    before = fk.mul.launches
    prod, sq = be.mul(got, x.to(cuda), dim).cpu(), be.square(got, dim).cpu()
    assert fk.mul.launches == before + 2
    assert torch.equal(prod, be.mul(got.cpu(), x, dim)) and torch.equal(sq, be.square(got.cpu(), dim))


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


@pytest.mark.cuda
@pytest.mark.parametrize("nonzero", [False, True], ids=["config1", "nonzero"])
def test_field_step_on_card_matches_cpu(cuda, nonzero):
    """Config 1 (through chain and operand_mulcmp) and its variant (through
    mul) at B = 512 × 2 chunks, clean and with one fadd of the tape
    computing a product."""
    template, tape = config1_tape(nonzero)
    ni, na, ops, free = tape.snapshot()
    i = max(k for k, op in enumerate(ops) if op.opcode == "fadd")
    bad_ops = list(ops)
    bad_ops[i] = type(ops[i])("fmul", ops[i].outs, ops[i].args)
    bits = RNG.integers(0, 2, size=(2, 512, 128)).astype(np.uint32)
    for t, corrupt in ((tape, False), (SnapshotTape(tape.field, (ni, na, bad_ops, free)), True)):
        prog = WitnessProgram(t)
        want = build_production_step(prog, template, 512, device="cpu")(from_numpy_u32(bits))
        fk.reset_launch_counts()
        got = build_production_step(prog, template, 512, device=cuda)(from_numpy_u32(bits, cuda))
        got = tuple(int(v) for v in got)
        assert got == tuple(int(v) for v in want)
        assert (got[0] > 0) == corrupt
        counts = fk.launch_counts()
        assert counts["operand_mulcmp"] == 2 and counts["mulcmp"] == 0
        if nonzero:  # the corrupted tape has one fmul more; finv is the ladder's launches
            e = SCALAR.p - 2
            ladder = e.bit_length() - 1 + bin(e).count("1") - 1
            assert counts["mul"] == 2 * (60 + corrupt + ladder) and counts["chain"] == 0
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
@pytest.mark.parametrize("N", [1000, 1, 426920, 1 << 20, 1258176])
def test_mul_digits_and_reduce_digits_on_card(cuda, field, N):
    """Both kernels against their plain versions; reduce_digits on
    limb-major sums, on the transposed view of element-major ones (read
    as it lies), on such a view 4 bytes off 16-byte alignment (copied
    first), and at the corner sums of test_torch_digit_kernels against
    Python ints in both layouts. N ragged, one, and the paths' own: the
    rows of a 16-block sha256 chain's Satisfier, 426,920 (its
    reduce_digits, limb-major), config 5's 2^20 rows (the row-chunked
    sums, element-major) and that Satisfier's widest mul_digits launch
    (matrix c's entries), 1,258,176."""
    a = _canonical(field, max(N, 3), 5, cuda)[:, :N].contiguous()
    b = _canonical(field, max(N, 3), 6, cuda).flip(1)[:, :N].contiguous()
    before = (fk.mul_digits.launches, fk.reduce_digits.launches)
    got = fk.mul_digits(a, b, field)
    d = _u32((32, N), cuda, 1 << 24)
    d[:, 0] = (1 << 24) - 1
    red = fk.reduce_digits(d, field)
    em = d.t().contiguous()
    red_em = fk.reduce_digits(em.t(), field)
    off = torch.empty(32 * N + 1, dtype=torch.int32, device=cuda)[1:].view(N, 32)
    off.copy_(em)
    red_off = fk.reduce_digits(off.t(), field)
    torch.cuda.synchronize()
    assert (fk.mul_digits.launches, fk.reduce_digits.launches) == (before[0] + 1, before[1] + 3)
    assert torch.equal(got, fk.mul_digits_plain(a, b, field))
    want = fk.reduce_digits_plain(d, field)
    assert torch.equal(red, want) and torch.equal(red_em, want) and torch.equal(red_off, want)
    if N > 1:
        corners = digit_sum_corners(field.p, N)
        want = [sum(int(x) << (8 * j) for j, x in enumerate(col)) % field.p for col in corners]
        em = from_numpy_u32(corners, cuda)
        for sums in (em.t(), em.t().contiguous()):
            assert _lm_ints(fk.reduce_digits(sums, field)) == want


@pytest.mark.cuda
def test_limbs_step_on_card_matches_cpu(cuda):
    """The config-1 limbs step (the fold rows on the fused route) at
    B = 256 × 2 chunks, clean and with one fadd of the tape computing a
    product, against the CPU; then the Satisfier of the template at
    batch 1 (the non-fused route) with a non-bit value in a bit slot."""
    template, tape = config1_tape(False)
    ni, na, ops, free = tape.snapshot()
    i = max(k for k, op in enumerate(ops) if op.opcode == "fadd")
    bad_ops = list(ops)
    bad_ops[i] = type(ops[i])("fmul", ops[i].outs, ops[i].args)
    bits = RNG.integers(0, 2, size=(2, 256, 128)).astype(np.uint32)
    for t, corrupt in ((tape, False), (SnapshotTape(tape.field, (ni, na, bad_ops, free)), True)):
        prog = WitnessProgram(t)
        want = build_production_step(prog, template, 256, device="cpu", witness_form="limbs")(from_numpy_u32(bits))
        fk.reset_launch_counts()
        got = build_production_step(prog, template, 256, device=cuda, witness_form="limbs")(from_numpy_u32(bits, cuda))
        got = tuple(int(v) for v in got)
        assert got == tuple(int(v) for v in want) and (got[0] > 0) == corrupt
        counts = fk.launch_counts()  # the fold rows through mulcmp, the trivial rows through operand_mulcmp
        assert counts["limbs_matvec"] == 6 and counts["mulcmp"] == counts["operand_mulcmp"] == 2
    prog = WitnessProgram(tape)
    z = prog.z_template_limbs(*prog.build(device="cpu")(from_numpy_u32(bits[0, :1])))[0]
    z[prog.free_slots[7]] = z[prog.free_slots[7]].flip(0) + 3  # a non-bit canonical value
    got, want = Satisfier(template, device=cuda), Satisfier(template, device="cpu")
    fk.reset_launch_counts()
    assert got.which_is_unsatisfied(z.to(cuda)) == want.which_is_unsatisfied(z) is not None
    counts = fk.launch_counts()
    assert counts["mul_digits"] == 3 and counts["reduce_digits"] == 3 and counts["mul"] == 1


# --- the bits form, the mixed packed step, free field inputs ---------------------
@pytest.mark.cuda
def test_bits_check_on_card_matches_cpu(cuda):
    """The bits form at B = 33 (one word of 32 instances and one of 1: the
    padding instances cut away) on the sha256 template, clean and with
    one bit flipped, against the CPU's mask and verdict."""
    template, prog = native_sha256()
    B = 33
    free = from_numpy_u32(RNG.integers(0, 2, size=(B, 512)).astype(np.uint32))
    vals, _ = prog.build(device="cpu")(free)
    bad = vals.clone()
    bad[B - 1, 9000] ^= 1
    cpu = build_templated_check(template, B, None, "bits", device="cpu")
    card = build_templated_check(template, B, None, "bits", device=cuda)
    for z in (vals, bad):
        fk.reset_launch_counts()
        got_mask = card(z.to(cuda)).cpu()
        got = tuple(int(v) for v in card.verdict(z.to(cuda)))
        counts = fk.launch_counts()
        assert torch.equal(got_mask, cpu(z))
        assert got == tuple(int(v) for v in cpu.verdict(z))
        assert counts["bitplane_eq"] == 2 and counts["bits_matvec_semi"] >= 2 and counts["mulcmp"] == 2
    assert got[0] > 0 and got[1] // template.num_constraints == B - 1


@pytest.mark.cuda
def test_packed_mixed_step_on_card_matches_cpu(cuda):
    """Config 3 (the mixed packed layout) at B = 512 × 2 chunks, clean and
    with the pack output's first two bits swapped."""
    nb = NativeBuilder()
    words = [nb.alloc_u32() for _ in range(4)]
    nb.multieq_begin()
    acc = words[0]
    for w in words[1:]:
        acc = nb.addmany([acc, w])
    nb.multieq_end()
    nb.pack_bits(acc)
    template, tape = nb.finish()
    ni, na, ops, free = tape.snapshot()
    i = next(k for k, op in enumerate(ops) if op.opcode == "pack")
    bad_ops = list(ops)
    args = list(ops[i].args)
    bad_ops[i] = type(ops[i])("pack", ops[i].outs, [args[1], args[0]] + args[2:])
    fw = RNG.integers(0, 1 << 32, size=(2, 16, 128), dtype=np.uint64).astype(np.uint32)
    for t, corrupt in ((tape, False), (SnapshotTape(tape.field, (ni, na, bad_ops, free)), True)):
        prog = WitnessProgram(t)
        want = build_packed_production_step(prog, template, 512, device="cpu")(from_numpy_u32(fw))
        fk.reset_launch_counts()
        got = build_packed_production_step(prog, template, 512, device=cuda)(from_numpy_u32(fw, cuda))
        got = tuple(int(v) for v in got)
        assert got == tuple(int(v) for v in want) and (got[0] > 0) == corrupt
        assert fk.launch_counts()["bitplane_eq"] == 2
        assert fk.launch_counts()["addmany"] == 2 * 3  # the mixed evaluator's 3 addmany stages, 2 chunks


def _free_field_program():
    """x·pack(bits) + y, squared: free field inputs x and y (the
    production step's free_field argument)."""
    nb = NativeBuilder()
    x, y = nb.alloc_num(), nb.alloc_num()
    a = nb.pack_bits(nb.alloc_u32())
    nb.num_square(nb.num_add(nb.num_mul(x, a), y))
    return nb.finish()


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["mixed", "limbs"])
def test_free_field_step_on_card_matches_cpu(cuda, form):
    """build_production_step with free field inputs at B = 256 × 2 chunks,
    clean and with one fadd of the tape computing a product."""
    template, tape = _free_field_program()
    ni, na, ops, free = tape.snapshot()
    i = next(k for k, op in enumerate(ops) if op.opcode == "fadd")
    bad_ops = list(ops)
    bad_ops[i] = type(ops[i])("fmul", ops[i].outs, ops[i].args)
    B = 256
    bits = from_numpy_u32(RNG.integers(0, 2, size=(2, B, 34)).astype(np.uint32))  # x, y, then 32 bits
    ff = torch.stack([_canonical(SCALAR, 2 * B, 7 + k, "cpu").t().reshape(2, B, 16) for k in range(2)], dim=2)
    for t, corrupt in ((tape, False), (SnapshotTape(tape.field, (ni, na, bad_ops, free)), True)):
        prog = WitnessProgram(t)
        assert len(prog.free_field_slots) == 2
        want = build_production_step(prog, template, B, device="cpu", witness_form=form)(bits, ff)
        got = build_production_step(prog, template, B, device=cuda, witness_form=form)(bits.to(cuda), ff.to(cuda))
        got = tuple(int(v) for v in got)
        assert got == tuple(int(v) for v in want) and (got[0] > 0) == corrupt


# --- the chained and Merkle pipelines, the num family ---------------------------
def _chain_prog():
    """A compression whose IV is 256 free bits before the 512 message bits."""
    nb = NativeBuilder()
    state = [nb.alloc_bit() for _ in range(256)]
    out = nb.sha256_compression([nb.alloc_bit() for _ in range(512)], state)
    template, tape = nb.finish()
    return template, WitnessProgram(tape), [nb.view(v) for v in out]


@pytest.mark.cuda
def test_chained_graph_matches_eager_and_caches(cuda):
    """T = 4, B = 3: the graph-replayed vals and final state equal the
    eager loop's and the CPU's bit for bit; a second call at B = 3 replays
    the cached graph, a call at B = 2 captures a second one."""
    template, prog, views = _chain_prog()
    gen = build_chained_witness(prog, views, device=cuda)
    iv = from_numpy_u32(RNG.integers(0, 2, size=(3, 256)).astype(np.uint32))
    msgs = from_numpy_u32(RNG.integers(0, 2, size=(4, 3, 512)).astype(np.uint32))
    vals, final = gen(iv.to(cuda), msgs.to(cuda))
    graph = gen.graphs[3]
    eager_vals, eager_final = eager_chain(gen, iv.to(cuda), msgs.to(cuda))
    assert torch.equal(vals, eager_vals) and torch.equal(final, eager_final)
    cpu_vals, cpu_final = build_chained_witness(prog, views, device="cpu")(iv, msgs)
    assert torch.equal(vals.cpu(), cpu_vals) and torch.equal(final.cpu(), cpu_final)
    again = gen(final, msgs.flip(0).to(cuda))
    assert list(gen.graphs) == [3] and gen.graphs[3] is graph
    assert torch.equal(again[0].cpu(), build_chained_witness(prog, views, device="cpu")(cpu_final, msgs.flip(0))[0])
    two = gen(iv[:2].to(cuda), msgs[:, :2].to(cuda))
    assert sorted(gen.graphs) == [2, 3] and gen.graphs[3] is graph
    assert torch.equal(two[0].cpu(), cpu_vals[:, :2]) and torch.equal(two[1].cpu(), cpu_final[:2])


@pytest.mark.cuda
def test_merkle_step_on_card_matches_cpu(cuda):
    """16 leaves (4 levels, batches 8 down to 1): root and total equal
    the CPU's, and the levels' checks launch the bits kernels."""
    nb = NativeBuilder()
    out = nb.sha256_compression([nb.alloc_bit() for _ in range(512)], nb.sha256_iv())
    template, tape = nb.finish()
    prog, views = WitnessProgram(tape), [nb.view(v) for v in out]
    leaves = from_numpy_u32(RNG.integers(0, 2, size=(16, 256)).astype(np.uint32))
    want = build_merkle_tree_step(prog, template, views, 16, device="cpu")(leaves)
    fk.reset_launch_counts()
    root, total = build_merkle_tree_step(prog, template, views, 16, device=cuda)(leaves.to(cuda))
    counts = fk.launch_counts()
    assert torch.equal(root.cpu(), want[0]) and int(total) == int(want[1]) == 0
    assert counts["bitplane_eq"] == 4 and counts["mulcmp"] == 4
    assert counts["addmany"] == 0  # the levels run the unpacked evaluator


def _num_mixed_block():
    """sha256 of 512 free bits, pack_bits of 200 digest bits, num_is_zero
    of the pack, and num_to_bits_le_strict of a free num."""
    nb = NativeBuilder()
    digest = nb.sha256_compression([nb.alloc_bit() for _ in range(512)], nb.sha256_iv())
    nb.num_is_zero(nb.pack_bits(digest[:200]))
    nb.num_to_bits_le_strict(nb.alloc_num())
    template, tape = nb.finish()
    return template, WitnessProgram(tape)


@pytest.mark.cuda
def test_num_mixed_block_on_card_matches_cpu(cuda):
    """The mixed block at B = 64: the card's vals and limbs equal the
    CPU evaluator's, and the mixed step's verdict is clean on both."""
    template, prog = _num_mixed_block()
    B = 64
    free = from_numpy_u32(RNG.integers(0, 2, size=(B, len(prog.free_slots))).astype(np.uint32))
    ff = _canonical(SCALAR, B, 11, "cpu").t().reshape(B, 1, 16).contiguous()
    want = prog.build(device="cpu")(free, ff)
    fk.reset_launch_counts()
    got = prog.build(device=cuda)(free.to(cuda), ff.to(cuda))
    assert fk.launch_counts()["mul"] > 0
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    for dev in ("cpu", cuda):
        verdict = build_production_step(prog, template, B, device=dev)(free[None].to(dev), ff[None].to(dev))
        assert tuple(int(v) for v in verdict) == (0, 0xFFFFFFFF)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 33, 4096, 1 << 21])
def test_mul_and_mul_digits_on_non_canonical_operands_on_card(cuda, N):
    """Operands in [p, 2^256), as config 5's raw witness rows are (the
    corners p, 2p, 2^256 − 1 and p + 1 first): mul and mul_digits equal
    their plain versions and, at every column up to 4,096 and at the
    corners and 2,000 random columns above, a·b mod p over the Python
    ints. N up to 2^21, the entries of A that RowShardedSatisfier gathers
    from raw z at config 5's 2^20 rows."""
    p = SCALAR.p
    rnd = random.Random(0x5EED_0009 + N)
    corners = [p, 2 * p, (1 << 256) - 1, p + 1]
    av = (corners + [rnd.randrange(p, 1 << 256) for _ in range(N)])[:N]
    bv = (corners[::-1] + [rnd.randrange(p, 1 << 256) for _ in range(N)])[:N]
    a = from_numpy_u32(FieldBackend.to_limbs(av).T.copy(), cuda)
    b = from_numpy_u32(FieldBackend.to_limbs(bv).T.copy(), cuda)
    got, dig = fk.mul(a, b, SCALAR), fk.mul_digits(a, b, SCALAR)
    torch.cuda.synchronize()
    assert torch.equal(got, fk.mul_plain(a, b, SCALAR))
    assert torch.equal(dig, fk.mul_digits_plain(a, b, SCALAR))
    cols = list(range(N)) if N <= 4096 else list(range(len(corners))) + rnd.sample(range(N), 2000)
    want = [av[i] * bv[i] % p for i in cols]
    assert _lm_ints(got[:, cols]) == want
    d = to_numpy_u32(dig[:, cols]).astype(object)
    assert [sum(int(d[j, i]) << (8 * j) for j in range(32)) for i in range(len(cols))] == want
    # raw a by the canonical corners b, as the limbs checks' coefficients are
    pairs = [(x, y) for x in (p, p + 1, (1 << 256) - 1) for y in (0, 1, p - 1)]
    a, b = (from_numpy_u32(FieldBackend.to_limbs([t[k] for t in pairs]).T.copy(), cuda) for k in (0, 1))
    got, dig = fk.mul(a, b, SCALAR), fk.mul_digits(a, b, SCALAR)
    want = [x * y % p for x, y in pairs]
    assert _lm_ints(got) == want and torch.equal(dig, fk.mul_digits_plain(a, b, SCALAR))
    d = to_numpy_u32(dig).astype(object)
    assert [sum(int(d[j, i]) << (8 * j) for j in range(32)) for i in range(len(pairs))] == want


@pytest.mark.cuda
@pytest.mark.parametrize("use_pallas", [None, False], ids=["semi", "canonical"])
def test_config5_check_on_card_matches_cpu(cuda, use_pallas):
    """Config 5's generator at 2^16 rows: the witness completed on the
    card checks clean on the route; with z[5, 0] flipped the card, the
    CPU and RowShardedSatisfier give one verdict, first at the row numpy
    names."""
    r1cs, zfree, N0, _ = config5_r1cs(16)
    R = r1cs.num_constraints
    check, prep = build_row_chunked_check(r1cs, 4, use_pallas=use_pallas, device=cuda)
    assert check._route == ("semi" if use_pallas is None else "canonical")
    prod, prep_ab = build_row_chunked_product(r1cs, 16, reuse=(check._layout_meta, prep), device=cuda)
    z = config5_z(zfree, R, cuda)
    z[N0 + 1 :] = prod(z, prep_ab)
    assert tuple(int(v) for v in check(z, prep)) == (0, 0xFFFFFFFF)
    z[5, 0] ^= 1
    got = tuple(int(v) for v in check(z, prep))
    cpu_check, cpu_prep = build_row_chunked_check(r1cs, 4, use_pallas=use_pallas, device="cpu")
    assert got == tuple(int(v) for v in cpu_check(z.cpu(), cpu_prep))
    assert got == tuple(int(v) for v in RowShardedSatisfier(r1cs, device=cuda)._check(z))
    assert got[0] > 0 and got[1] == flipped_first_row(r1cs, 5)


@pytest.mark.cuda
def test_sharded_paths_one_rank_on_nccl(cuda):
    """The dry run on one rank of an NCCL group on the card: the sharded
    unpacked and packed steps' shards equal single-rank execution, and the
    row-sharded check locates its flips as on one rank."""
    (res,) = dryrun_multichip(1, backend="nccl")
    assert (res["backend"], res["device"], res["packed"]) == ("nccl", "cuda:0", (0, 0xFFFFFFFF)), res
    assert res["which"] == ["constraint #699", "constraint #53403"], res["which"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sha256", "config2"])
def test_frontend_circuits_on_card_match_cpu(cuda, name):
    """The sha256 compression and config 2 through the port's ShapeCS and
    TapeCS (tests/torch_circuits.py): the packed step at 2 × 512 on the
    card gives the CPU's verdicts, clean and with one xor of the tape
    computing `and`, and its kernels are launched; config 2 with values in
    TestConstraintSystem → R1CS.from_test_cs → Satisfier on the card names
    what TestConstraintSystem names after a cs.set."""
    circuit = {"sha256": fe_sha256, "config2": fe_config2}[name]
    shape, tape = ShapeCS(), TapeCS()
    circuit(shape)
    circuit(tape)
    template = shape.finish()
    words = RNG.integers(0, 1 << 32, size=(2, 16, len(WitnessProgram(tape).free_slots)),
                         dtype=np.uint64).astype(np.uint32)
    for t in (tape, corrupted(tape, "xor", pick="first")):
        prog = WitnessProgram(t)
        want = build_packed_production_step(prog, template, 512, device="cpu")(from_numpy_u32(words))
        fk.reset_launch_counts()
        got = build_packed_production_step(prog, template, 512, device=cuda)(from_numpy_u32(words, cuda))
        assert tuple(int(v) for v in got) == tuple(int(v) for v in want)
        assert fk.launch_counts()["bitplane_eq"] == 2
    assert int(want[0]) > 0
    if name == "config2":
        cs = TestConstraintSystem()
        ops = [UInt32.alloc(cs.namespace(f"op {i}"), int(RNG.integers(0, 1 << 32))) for i in range(8)]
        with MultiEq(cs) as mcs:
            x = ops[0]
            for i in range(1, 8):
                x = x.xor(mcs.namespace(f"x{i}"), ops[i].rotr(5 * i))
                x = UInt32.addmany(mcs.namespace(f"s{i}"), [x, ops[i - 1].shr(3)])
        sat = Satisfier(R1CS.from_test_cs(cs), device=cuda)
        assert sat.is_satisfied(sat.z_from_assignments(cs.scalar_inputs(), cs.scalar_aux()))
        cs.set("s5/result bit 9/boolean", 1 - cs.get("s5/result bit 9/boolean"))
        fk.reset_launch_counts()
        named = sat.which_is_unsatisfied(sat.z_from_assignments(cs.scalar_inputs(), cs.scalar_aux()))
        assert named == cs.which_is_unsatisfied() is not None
        assert fk.launch_counts()["mul_digits"] == 3


@pytest.mark.cuda
def test_device_r1cs_satisfier_route_on_card(cuda):
    """Satisfier(r1cs, False) on the card: the DeviceR1CS route gives the
    CPU's and the templated route's verdicts, clean and with a planted
    fault, through 4 mul launches (3 matrices' entries, then A·z∘B·z) and 3
    reduce_digits launches a check."""
    nb = NativeBuilder()
    bits = [nb.alloc_bit() for _ in range(64)]
    a, b = nb.pack_bits(bits[:32]), nb.pack_bits(bits[32:])
    x = a
    for _ in range(6):
        x = nb.num_square(nb.num_add(nb.num_mul(x, b), a))
    template, tape = nb.finish()
    prog = WitnessProgram(tape)
    z = prog.z_template_limbs(*prog.build(device="cpu")(_u32((1, 64), "cpu", 2)))[0]
    bad = z.clone()
    bad[prog.free_slots[5], 0] ^= 1
    card, cpu = Satisfier(template, False, device=cuda), Satisfier(template, False, device="cpu")
    templated = Satisfier(template, device=cuda)
    for zz in (z, bad):
        fk.reset_launch_counts()
        got = (card.is_satisfied(zz.to(cuda)), card.which_is_unsatisfied(zz.to(cuda)))
        counts = fk.launch_counts()
        assert counts["mul"] == 8 and counts["reduce_digits"] == 6
        assert got == (cpu.is_satisfied(zz), cpu.which_is_unsatisfied(zz))
        assert got == (templated.is_satisfied(zz.to(cuda)), templated.which_is_unsatisfied(zz.to(cuda)))
    assert got[0] is False and got[1] is not None


# --- fields below 253 bits -----------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("field", SMALL_FIELDS + [SCALAR], ids=lambda f: f.name)
@pytest.mark.parametrize("n_rows,K,Bw", [(8, 512, 1024), (8, 1, 1024), (5, 37, 31), (4, 1, 1)])
def test_bits_matvec_canonical_on_card(cuda, field, n_rows, K, Bw):
    """The bits form's canonical output (fold_matvec<true, true>) at the
    sha256 big row's bucket shapes and ragged ones, at every word count of
    the tail: against its plain version and, at a few live columns, the
    Python-int sum mod p."""
    S = 700
    vals = _u32((S, Bw), cuda)
    cols, F = _cols(n_rows, K, S, cuda), _fold(n_rows, K, cuda)
    before = fk.bits_matvec_canonical.launches
    got = fk.bits_matvec_canonical(vals, cols, F, field)
    torch.cuda.synchronize()
    assert fk.bits_matvec_canonical.launches == before + 1
    assert tuple(got.shape) == (16, n_rows, 32 * Bw)
    assert torch.equal(got, fk.bits_matvec_canonical_plain(vals, cols, F, field))
    assert not got[:, n_rows - 3 :].any()
    v, c, f = to_numpy_u32(vals).astype(object), cols.cpu().numpy(), F.cpu().numpy().astype(object)
    g = to_numpy_u32(got).astype(object)
    for r, b in ((0, 0), (0, 32 * Bw - 1), (1, 32 * Bw // 2)):
        want = sum(int(f[r, d, e]) << (8 * d) for e in range(K) if c[r, e] >= 0
                   if (v[c[r, e], b // 32] >> (b % 32)) & 1 for d in range(32)) % field.p
        assert sum(int(g[l, r, b]) << (16 * l) for l in range(16)) == want, (r, b)


@pytest.mark.cuda
@pytest.mark.parametrize("field", SMALL_FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("N", [1, 33, 8192])
def test_word_kernels_below_253_bits_on_card(cuda, field, N):
    """mul and mul_digits (a canonical, and raw in [p, 2^256) as config
    5's z is), reduce_digits at its corner sums in both layouts, chain on
    config 1's pattern and limbs_matvec's canonical output: against their
    plain versions and Python ints."""
    p = field.p
    rnd = random.Random(N + p % 1000)
    raws = [p, p + 1, (1 << 256) - 1, 2 * p]
    av = ([0, 1, p - 1] + raws + [rnd.randrange(1 << 256) if i % 2 else rnd.randrange(p) for i in range(N)])[:N]
    bv = ([p - 1, 1, 0, p - 1, 1, p - 2, p - 1] + [rnd.randrange(p) for _ in range(N)])[:N]
    a = from_numpy_u32(FieldBackend.to_limbs(av).T.copy(), cuda)
    b = from_numpy_u32(FieldBackend.to_limbs(bv).T.copy(), cuda)
    got, dig = fk.mul(a, b, field), fk.mul_digits(a, b, field)
    torch.cuda.synchronize()
    want = [x * y % p for x, y in zip(av, bv)]
    assert torch.equal(got, fk.mul_plain(a, b, field)) and _lm_ints(got) == want
    assert torch.equal(dig, fk.mul_digits_plain(a, b, field))
    d = to_numpy_u32(dig).astype(object)
    assert [sum(int(d[j, i]) << (8 * j) for j in range(32)) for i in range(N)] == want
    corners = digit_sum_corners(p, N)
    em = from_numpy_u32(corners, cuda)
    want = [sum(int(x) << (8 * j) for j, x in enumerate(col)) % p for col in corners]
    for sums in (em.t(), em.t().contiguous()):
        red = fk.reduce_digits(sums, field)
        assert _lm_ints(red) == want and torch.equal(red, fk.reduce_digits_plain(sums, field))
    descs = (("fmul", "prev", 0), ("fadd", "prev", 1), ("fmul", "prev", "prev"))
    x0, e0, e1 = (_canonical(field, max(N, 3), seed, cuda)[:, :N].contiguous() for seed in (7, 8, 9))
    ext = torch.cat([e0, e1])
    out = fk.chain(x0, ext, descs, 30, field)
    assert torch.equal(out, fk.chain_plain(x0, ext, descs, 30, field))
    x, e0i, e1i = _lm_ints(x0[:, -1:]), _lm_ints(e0[:, -1:]), _lm_ints(e1[:, -1:])
    xv = x[0]
    for _ in range(30):
        xv = (xv * e0i[0] % p + e1i[0]) % p
        xv = xv * xv % p
    assert _lm_ints(out[-16:, -1:]) == [xv]
    zt = _u32((300, 16, min(N, 1000)), cuda, 1 << 16)
    cols, F = _cols(8, 64, 300, cuda), _fold(8, 32 * 64, cuda)
    lm = fk.limbs_matvec(zt, cols, F, field, "canonical")
    assert torch.equal(lm, fk.limbs_matvec_plain(zt, cols, F, field, "canonical"))
    assert (lm >= 0).all() and not lm[:, 5:].any()


def _small_field_sha256(field):
    nb = NativeBuilder(field)
    bits = [nb.alloc_bit() for _ in range(512)]
    nb.sha256_compression(bits, nb.sha256_iv())
    return nb.finish()


@pytest.mark.cuda
@pytest.mark.parametrize("field", [GOLDILOCKS, JUBJUB_FR], ids=lambda f: f.name)
def test_small_field_flagship_on_card_matches_cpu(cuda, field):
    """The packed sha256 step at 2 × 1,024 over Goldilocks (its big rows
    through bits_matvec_canonical and mul) and Jubjub's scalar field (semi
    rows and mulcmp): the CPU's verdicts, clean and with one xor of the
    tape computing `and`."""
    template, tape = _small_field_sha256(field)
    words = _u32((2, 32, len(WitnessProgram(tape).free_slots)), "cpu")
    semi = field.NUM_BITS >= 250
    for p in (WitnessProgram(tape), WitnessProgram(corrupted(tape, "xor", pick="first"))):
        want = build_packed_production_step(p, template, 1024, device="cpu")(words)
        fk.reset_launch_counts()
        got = build_packed_production_step(p, template, 1024, device=cuda)(words.to(cuda))
        counts = fk.launch_counts()
        assert tuple(int(v) for v in got) == tuple(int(v) for v in want)
        assert (counts["bits_matvec_semi"] > 0, counts["mulcmp"] > 0) == (semi, semi), counts
        assert (counts["bits_matvec_canonical"] > 0, counts["mul"] > 0) == (not semi, not semi), counts
    assert int(want[0]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("nonzero", [False, True], ids=["config1", "variant"])
@pytest.mark.parametrize("field", [GOLDILOCKS, JUBJUB_FR], ids=lambda f: f.name)
def test_small_field_config1_on_card_matches_cpu(cuda, field, nonzero):
    """Config 1 (and its num_assert_nonzero variant) at 2 × 128 in the
    mixed and limbs forms: the CPU's verdicts, clean and with the last
    fadd of the tape computing a product."""
    template, tape = config1_tape(nonzero, field)
    free = _u32((2, 128, 128), "cpu", 2)
    for t in (tape, corrupted(tape, "fadd", pick="last", into="fmul")):
        prog = WitnessProgram(t)
        for form in ("mixed", "limbs"):
            want = build_production_step(prog, template, 128, None, form, device="cpu")(free)
            got = build_production_step(prog, template, 128, None, form, device=cuda)(free.to(cuda))
            assert tuple(int(v) for v in got) == tuple(int(v) for v in want), form
    assert int(want[0]) > 0


@pytest.mark.cuda
def test_goldilocks_satisfier_and_config5_on_card(cuda):
    """Over Goldilocks: both Satisfier routes on config 1's template at
    batch 1 give the CPU's verdicts and names, clean and with a flipped
    limb; config 5's generator at 2^14 rows completes and checks on the
    canonical route, and a flip of z[5, 0] is found at the row numpy
    names, as on the CPU and by RowShardedSatisfier."""
    template, tape = config1_tape(False, GOLDILOCKS)
    prog = WitnessProgram(tape)
    z = prog.z_template_limbs(*prog.build(device="cpu")(_u32((1, 128), "cpu", 2)))[0]
    bad = z.clone()
    bad[sorted(prog.field_rows, key=prog.field_rows.get)[3], 1] ^= 1
    for route in (None, False):
        card, cpu = Satisfier(template, route, device=cuda), Satisfier(template, route, device="cpu")
        for zz in (z, bad):
            got = (card.is_satisfied(zz.to(cuda)), card.which_is_unsatisfied(zz.to(cuda)))
            assert got == (cpu.is_satisfied(zz), cpu.which_is_unsatisfied(zz))
        assert got[0] is False
    r1cs, zfree, N0, _ = config5_r1cs(14, field=GOLDILOCKS)
    R = r1cs.num_constraints
    check, prep = build_row_chunked_check(r1cs, 4, device=cuda)
    assert check._route == "canonical"
    prod, prep_ab = build_row_chunked_product(r1cs, 16, reuse=(check._layout_meta, prep), device=cuda)
    zc = config5_z(zfree, R, cuda)
    zc[N0 + 1 :] = prod(zc, prep_ab)
    cpu_prod, cpu_pp = build_row_chunked_product(r1cs, 16, device="cpu")
    assert torch.equal(zc[N0 + 1 :].cpu(), cpu_prod(config5_z(zfree, R, "cpu"), cpu_pp))
    assert tuple(int(v) for v in check(zc, prep)) == (0, 0xFFFFFFFF)
    zc[5, 0] ^= 1
    got = tuple(int(v) for v in check(zc, prep))
    assert got[0] > 0 and got[1] == flipped_first_row(r1cs, 5)
    assert got == tuple(int(v) for v in RowShardedSatisfier(r1cs, device=cuda)._check(zc))


# --- the verdict fold ------------------------------------------------------------
def _fold_card_and_plain(case_folds):
    """The folds run through the kernel on the card and through the plain
    version on CPU copies: both running verdicts as (n_bad, first), and
    the kernel's launches."""
    before = fk.verdict_fold.launches
    acc, ref = fk.verdict_acc(case_folds[0][0].device), fk.verdict_acc("cpu")
    for bad, rows, R, n_inst in case_folds:
        fk.verdict_fold(acc, bad, rows, R, n_inst)
        fk.verdict_fold(ref, bad.cpu(), rows.cpu(), R, n_inst)
    torch.cuda.synchronize()
    return tuple(acc.tolist()), tuple(ref.tolist()), fk.verdict_fold.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["words", "mask"])
@pytest.mark.parametrize("case", CASES)
def test_verdict_fold_on_card(cuda, case, form):
    case_folds = folds(case, form, cuda)
    got, ref, launches = _fold_card_and_plain(case_folds)
    assert got == ref == python_verdict(case_folds)
    assert launches == len(case_folds)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["words", "mask"])
@pytest.mark.parametrize("offset", [0, 1, 4, 16])
def test_verdict_fold_column_slices_on_card(cuda, form, offset):
    """Strided rows and misaligned pointers (a column slice): the vector
    loads where base, row stride and width are 16-byte multiples, the
    scalar ones otherwise, both equal to the plain version."""
    rng = np.random.default_rng(0x5EED_0F02 + offset)
    words = rng.integers(0, 1 << 32, size=(37, 1024 + 32), dtype=np.uint64).astype(np.uint32)
    words &= rng.integers(0, 1 << 32, size=words.shape, dtype=np.uint64).astype(np.uint32)
    words[rng.random(words.shape) < 0.9] = 0
    full = torch.from_numpy(words.view(np.int32)).to(cuda)
    if form == "mask":
        full = full.ne(0)
    bad = full[:, offset:offset + 1024]
    rows = torch.from_numpy(np.sort(rng.choice(50_000, 37, replace=False))).to(cuda)
    n_inst = 32 * 1024 - 9 if form == "words" else 1024
    got, ref, launches = _fold_card_and_plain([(bad, rows, 50_000, n_inst)])
    assert got == ref and got[0] > 0 and launches == 1


def _planted_verdict(bad, sites, rows_h, R):
    """Words or mask `bad` on the card with violations set at (row,
    instance) sites, and their exact verdict."""
    for r, b in sites:
        if bad.dtype == torch.bool:
            bad[r, b] = True
        else:
            bit = 1 << (b % 32)
            bad[r, b // 32] |= bit - (1 << 32) if bit >> 31 else bit
    return len(sites), min(b * R + rows_h[r] for r, b in sites)


@pytest.mark.cuda
def test_verdict_fold_at_the_check_shapes_on_card(cuda):
    """Sparse faults at the benchmark's fold shapes: sha256's xor family
    [13,584, 65,536] words and blake2s's big rows' [46, 2^21] mask, held to
    the planted verdict and to the plain version (on the rows with a
    fault: the others add nothing)."""
    rng = np.random.default_rng(0x5EED_0F03)
    R = 26_352
    for shape, dtype in (((13_584, 65_536), torch.int32), ((46, 1 << 21), torch.bool)):
        n = shape[0]
        n_inst = shape[1] * (32 if dtype == torch.int32 else 1)
        rows_h = sorted(rng.choice(R, n, replace=False).tolist())
        rows = torch.tensor(rows_h, dtype=torch.int64, device=cuda)
        sites = {(int(rng.integers(n)), int(rng.integers(n_inst))) for _ in range(64)}
        bad = torch.zeros(shape, dtype=dtype, device=cuda)
        want = _planted_verdict(bad, sites, rows_h, R)
        got = tuple(fk.verdict_fold(fk.verdict_acc(cuda), bad, rows, R).tolist())
        hit = torch.tensor(sorted({r for r, _b in sites}), device=cuda)
        plain = fk.verdict_fold_plain(fk.verdict_acc(cuda), bad[hit], rows[hit], R, n_inst)
        assert got == tuple(plain.tolist()) == want
        del bad
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_verdict_fold_64bit_indexing_on_card(cuda):
    """n·Bw ≥ 2^31 words, faults only past word 2^31: the vector path (the
    whole rows) and the scalar path (a column slice, n·(Bw − 1) ≥ 2^31
    words too)."""
    n, Bw, R = 32_770, 65_536, 40_000
    rows_h = list(range(n))
    rows = torch.arange(n, dtype=torch.int64, device=cuda)
    words = torch.zeros((n, Bw), dtype=torch.int32, device=cuda)
    sites = {(n - 1, 32 * Bw - 1), (n - 1, 32 * 5 + 31), (n - 2, 32 * 40_000 + 3)}
    want = _planted_verdict(words, sites, rows_h, R)
    assert (n - 2) * Bw >= 1 << 31
    got = tuple(fk.verdict_fold(fk.verdict_acc(cuda), words, rows, R).tolist())
    hit = torch.tensor([n - 2, n - 1], device=cuda)
    plain = fk.verdict_fold_plain(fk.verdict_acc(cuda), words[hit], rows[hit], R, 32 * Bw)
    assert got == tuple(plain.tolist()) == want
    sl = words[:, 1:]  # scalar loads: the pointer is 4 bytes past a 16-byte boundary
    want_sl = (3, min((b - 32) * R + r for r, b in sites))
    got_sl = tuple(fk.verdict_fold(fk.verdict_acc(cuda), sl, rows, R).tolist())
    assert got_sl == want_sl
    del words, sl
    torch.cuda.empty_cache()


# --- the product rows: operand_mulcmp ----------------------------------------
def _operand_card_and_plain(specs, flimbs, vals, field, cuda):
    """operand_mulcmp on the card (and its launches) and its plain version
    on the CPU, over the same rows and values."""
    prods = Products(specs, field, cuda)
    before = fk.operand_mulcmp.launches
    got = fk.operand_mulcmp(prods.table, flimbs.to(cuda), None if vals is None else vals.to(cuda), field)
    torch.cuda.synchronize()
    plain = fk.operand_mulcmp(Products(specs, field, "cpu").table, flimbs, vals, field)
    return got.cpu(), plain, fk.operand_mulcmp.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,B", [(90, 37), (300, 256), (7, 1)])
@pytest.mark.parametrize("u32", [True, False], ids=["mixed", "limbs"])
@pytest.mark.parametrize("field", [PALLAS_SCALAR, VESTA_SCALAR, SCALAR], ids=lambda f: f.name)
def test_operand_mulcmp_on_card(cuda, field, u32, n_rows, B):
    """Every operand shape, values 0, 1, p − 1 and random, planted faults;
    without u32 values as the limbs checks call it; B not a multiple of a
    warp."""
    specs, flimbs, vals, want = operand_rows(field, n_rows, B, n_rows * 7 + B + u32, u32=u32)
    got, plain, launches = _operand_card_and_plain(specs, flimbs, vals, field, cuda)
    assert torch.equal(got, torch.from_numpy(want)) and torch.equal(got, plain)
    assert launches == 1 and want.any() and (B == 1 or not want.all())


@pytest.mark.cuda
def test_operand_mulcmp_64bit_offsets_on_card(cuda):
    """Field rows read at f·16·B past 2^31 words (the rows lie at the top
    of an 8.6 GB limb buffer)."""
    B, k = 64, (1 << 21) + 3
    specs, flimbs, vals, want = operand_rows(PALLAS_SCALAR, 40, B, 21)
    assert k * 16 * B >= 1 << 31
    big = torch.zeros((k + flimbs.shape[0], 16, B), dtype=torch.int32, device=cuda)
    big[k:] = flimbs.to(cuda)
    table = Products(shift_field_rows(specs, k), PALLAS_SCALAR, cuda).table
    got = fk.operand_mulcmp(table, big, vals.to(cuda), PALLAS_SCALAR)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), torch.from_numpy(want))
    del big
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_operand_mulcmp_refuses_rather_than_fall_back(cuda):
    specs, flimbs, vals, _want = operand_rows(PALLAS_SCALAR, 20, 40, 22)
    table = Products(specs, PALLAS_SCALAR, cuda).table
    fl, v = flimbs.to(cuda), vals.to(cuda)
    with pytest.raises(TypeError):
        fk.operand_mulcmp(table, fl.to(torch.int64), v, PALLAS_SCALAR)
    with pytest.raises(ValueError):  # strided instances
        fk.operand_mulcmp(table, fl[:, :, ::2], v[:, ::2].contiguous(), PALLAS_SCALAR)
    with pytest.raises(ValueError):  # the values lie on the CPU
        fk.operand_mulcmp(table, fl, vals, PALLAS_SCALAR)
    with pytest.raises(ValueError):  # the table lies on the CPU
        fk.operand_mulcmp(Products(specs, PALLAS_SCALAR, "cpu").table, fl, v, PALLAS_SCALAR)
    with pytest.raises(ValueError):  # u32 terms and no values
        fk.operand_mulcmp(table, fl, None, PALLAS_SCALAR)


@pytest.mark.cuda
def test_minroot_chunk_verdict_on_card_matches_eager_route(cuda):
    """MixedCheck.verdict_slot_major on a MinRoot chunk (1,024 iterations,
    256 instances of random advice: every iteration's last row fails) with
    additive faults planted in its field values: (n_bad, first) equal to
    the eager route's (operands assembled by _Operand, mulcmp), through
    one operand_mulcmp launch and no mulcmp."""
    cfg = bench.load_module(f"{bench.HERE}/configs/minroot-65536.py", "minroot_config")
    template, prog = cfg.build(1024)
    B, p, R = 256, PALLAS_SCALAR.p, template.num_constraints
    check = build_templated_check(template, B, None, "mixed", field_slots=prog.field_slots, device=cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(23)
    n_ff = len(prog.free_field_slots)
    ff = torch.randint(0, 1 << 16, (B, n_ff, 16), generator=gen, device=cuda, dtype=torch.int32)
    ff[..., 15] %= p >> 240
    ff_index = {s: i for i, s in enumerate(prog.free_field_slots)}
    low = ff[:, [ff_index[s] for s in prog.free_slots]]
    vals_p, flimbs_p = prog.build(device=cuda).slot_major((low[..., 0] | (low[..., 1] << 16)).contiguous(), ff,
                                                          free_rows=True)
    rng = np.random.default_rng(24)
    sites = rng.choice(prog.n_field_rows * B, 64, replace=False)
    add_mod_p(flimbs_p, (sites % B).tolist(), (sites // B).tolist(), rng.integers(1, 1 << 62, 64).tolist(), p)
    fk.reset_launch_counts()
    got = tuple(int(v) for v in check.verdict_slot_major(vals_p, flimbs_p))
    counts = fk.launch_counts()
    mask = eager_product_bad(check.mul, vals_p, flimbs_p, PALLAS_SCALAR)
    rows = check.rows[ROW_CLASSES.index("mul")]
    inst = torch.arange(B, device=cuda)[None, :] * R
    want = (int(mask.sum()), int(torch.where(mask, inst + rows[:, None], 1 << 62).min()))
    assert got == want and got[0] > 1024 * B, (got, want)
    assert counts["operand_mulcmp"] == 1 and counts["mulcmp"] == 0, counts


# --- the paths' own tables, probes and oracles ----------------------------------
CLEAN = (0, 0xFFFFFFFF)


def _verdict(v):
    return tuple(int(x) for x in v)


def _both_verdicts(mask):
    """A plain version's 0/1 mask that holds both verdicts, so that the
    kernel's agreeing with it shows it flags violations and passes the
    rest."""
    n_bad = int((mask != 0).sum())
    assert 0 < n_bad < mask.numel(), (n_bad, mask.numel())


def _mulcmp_plain(a, b, c, field):
    """mulcmp's plain version over slices of 2^18 columns, which bounds its
    int64 temporaries."""
    step = 1 << 18
    return torch.cat([fk.mulcmp_plain(*(o[:, s : s + step].contiguous() for o in (a, b, c)), field)
                      for s in range(0, a.shape[1], step)])


def _every_fifth_flipped(fl_p):
    """A copy of limbs int32[F, 16, B] with bit 16 of each value (bit 0 of
    limb 1) cleared at every fifth instance: the values stay below p, and
    the rows that read a value that had the bit set fail there."""
    out = fl_p.clone(memory_format=torch.contiguous_format)
    out[:, 1, ::5] &= ~1
    return out


def _packed_circuit(name):
    """(template, program) of one of the packed step's circuits."""
    if name == "sha256":
        return native_sha256()
    return native_prog({"blake2s": blake2s_circuit, "config2": config2_circuit, "config3": config3_circuit}[name]())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sha256", "blake2s", "config2", "config3"])
def test_packed_step_probes_and_kernels_at_its_tables_on_card(cuda, name):
    """The packed step at 2 × 1,024 (config 3 in the mixed packed layout):
    a clean verdict and the path's launches; chunk 0's words (and limbs)
    equal to the CPU evaluator's; a flipped bit found at its instance and
    at the row the CPU check of its word names (config 3 also a flipped
    pack-output limb bit, at the multipack row, and a flipped addend bit).
    Then the kernels at the check's own tables, on chunk 0's words with
    the odd words random: bitplane_eq at the plane table, bits_matvec_semi
    at every bucket of the big rows and mulcmp on their A·z, B·z and C·z,
    each equal to its plain version (the masks holding both verdicts), and
    verdict_fold over the check's folds equal to its plain version."""
    template, prog = _packed_circuit(name)
    field, R, B = template.field, template.num_constraints, 1024
    Bw = B // 32
    mixed = not prog.is_packable
    free = _u32((2, Bw, len(prog.free_slots)), "cpu")
    fk.reset_launch_counts()
    assert _verdict(build_packed_production_step(prog, template, B, device=cuda)(free.to(cuda))) == CLEAN
    counts = fk.launch_counts()
    assert counts["bitplane_eq"] == (0 if name == "blake2s" else 2) and counts["verdict_fold"] > 0, counts
    assert counts["addmany"] == 2 * sum(st.opcode == "addmany" for st in prog.stages), counts  # one a stage a chunk
    if name == "sha256":
        assert counts["bits_matvec_semi"] > 0 and counts["mulcmp"] == 2, counts
    if name == "blake2s":
        assert (counts["bits_matvec_semi"], counts["mulcmp"]) == (8, 2), counts

    field_slots = sorted(prog.field_rows, key=prog.field_rows.get) if mixed else None
    check = build_templated_check(template, B, None, "bits_packed", field_slots=field_slots, device=cuda)
    cpu_check = build_templated_check(template, 32, None, "bits_packed", field_slots=field_slots, device="cpu")
    if mixed:
        vals0, fl0 = prog.build_packed_mixed(device=cuda)(free[0].to(cuda))
        cpu_vals, cpu_fl = prog.build_packed_mixed(device="cpu")(free[0])
        assert torch.equal(fl0.cpu(), cpu_fl)
    else:
        vals0, fl0 = prog.build_packed(device=cuda)(free[0].to(cuda)), None
        cpu_vals = prog.build_packed(device="cpu")(free[0])
    assert torch.equal(vals0.cpu(), cpu_vals)
    assert _verdict(check.verdict(vals0, fl0)) == CLEAN

    def probe(word, bit, slot=None, limb=None):
        """Flip bit `bit` of packed word (word, slot), or bit limb[1] of
        limb limb[0] of instance 32·word + bit's first field row: found at
        that instance and at the row the CPU check of the word names."""
        v, f = vals0.clone(), None if fl0 is None else fl0.clone()
        inst = 32 * word + bit
        if limb is None:
            v[word, slot] ^= 1 << bit
        else:
            f[inst, 0, limb[0]] ^= 1 << limb[1]
        nbad, first = _verdict(check.verdict(v, f))
        _cnb, cfirst = _verdict(cpu_check.verdict(
            v[word : word + 1].cpu(), None if f is None else f[32 * word : 32 * word + 32].cpu()))
        assert nbad > 0 and first // R == inst and cfirst // R == bit and first % R == cfirst % R, (nbad, first, cfirst)
        return first % R

    probe(Bw // 2, 7, slot=prog.num_slots // 2)
    if mixed:
        assert probe(Bw // 3, 11, limb=(1, 4)) == int(check.pf_rows[0])  # the multipack row
        probe(5, 30, slot=prog.free_slots[40])

    vals_p = vals0.t().contiguous()
    vals_p[:, 1::2] = _u32((vals_p.shape[0], Bw // 2), cuda)
    _packed_kernels_hold(check, vals_p, mixed, field)


def _by_words(plain, vals_p, words, *args):
    """A plain version run over slices of `words` packed words (the
    instances of its output along its last dimension), which bounds its
    temporaries."""
    return torch.cat([plain(vals_p[:, s : s + words].contiguous(), *args)
                      for s in range(0, vals_p.shape[1], words)], dim=-1)


def _packed_kernels_hold(check, vals_p, mixed, field, words=1024):
    """The packed check's kernels at its own tables, on slot-major words
    vals_p int32[S, Bw] whose odd words are random, each equal to its
    plain version (run over slices of `words` words, the fold's over
    slices of as many rows): bitplane_eq at the plane table,
    bits_matvec_semi at every bucket of the big rows and mulcmp on their
    A·z, B·z and C·z (the masks holding both verdicts); for a pure-bit
    check, verdict_fold over the check's folds, one launch a fold, into a
    verdict that counts violations."""
    inner = check.inner if mixed else check
    if inner.pow2_spec is not None:
        spec = inner.pow2_spec
        n, m_a, m_c = spec["a_cols"].shape[0], spec["a_cols"].shape[2], spec["c_cols"].shape[2]
        P = fk.padded_positions(spec["n_pos"])
        want = _by_words(fk.bitplane_eq_plain, vals_p, words, inner.plane_idx, n, P, m_a, m_c)
        _both_verdicts(want)
        assert torch.equal(fk.bitplane_eq(vals_p, inner.plane_idx, n, P, m_a, m_c), want)
        del want
    if inner.big is not None:
        for m in "abc":
            for cols, F in inner.big.mats[m]:
                assert torch.equal(fk.bits_matvec_semi(vals_p, cols, F, field),
                                   _by_words(fk.bits_matvec_semi_plain, vals_p, words, cols, F, field)), \
                    (m, tuple(cols.shape))
        a, b, c = (inner.big._matvec(m, vals_p) for m in "abc")
        want = _mulcmp_plain(a, b, c, field)
        _both_verdicts(want)
        assert torch.equal(fk.mulcmp(a, b, c, field), want)
        del a, b, c, want
    if mixed:
        return
    R, B = check.Rt0, check.batch
    ins = list(check._fam_bad_words(vals_p))
    if check.n_left:
        ins.append((check._left_bad(vals_p), check.rows_left))
    if check.pow2_spec is not None:
        ins.append((check._pow2_bad_words(vals_p), check.pow2_rows))
    if check.big is not None:
        ins.append((check._big_bad(vals_p), check.rest_big_idx))
    acc, plain = fk.verdict_acc(vals_p.device), fk.verdict_acc(vals_p.device)
    before = fk.verdict_fold.launches
    for bad, rows in ins:
        fk.verdict_fold(acc, bad, rows, R, B)
        for s in range(0, bad.shape[0], words):
            fk.verdict_fold_plain(plain, bad[s : s + words], rows[s : s + words], R, B)
    assert fk.verdict_fold.launches == before + len(ins)
    assert acc[0] > 0 and torch.equal(acc, plain), (acc, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sha256", "blake2s"])
def test_packed_step_and_kernels_at_the_cells_batch_on_card(cuda, name):
    """The packed step at the step_2m cells' chunk, 2^21 instances
    (perfbench/traffic/step_2m.json): clean, launching per kernel what the
    same step launches at 1,024 instances, one addmany launch a stage (155
    sha256, 80 blake2s); then the check's kernels at its own tables on
    that chunk's words with the odd words random, each equal to its plain
    version (_packed_kernels_hold)."""
    template, prog = _packed_circuit(name)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0x5EED_0022)
    launched = {}
    for B in (1024, 1 << 21):
        free = torch.randint(-(1 << 31), 1 << 31, (1, B // 32, len(prog.free_slots)), generator=gen,
                             dtype=torch.int32, device=cuda)
        step = build_packed_production_step(prog, template, B, device=cuda)
        verdict, launched[B] = counted(lambda: _verdict(step(free)))
        del step
        assert verdict == CLEAN, (B, verdict)
    assert launched[1 << 21] == launched[1024], launched
    assert launched[1024]["mulcmp"] == 1 and launched[1024].get("bitplane_eq", 0) == (name == "sha256"), launched
    assert launched[1024]["addmany"] == {"sha256": 155, "blake2s": 80}[name], launched
    evaluator, check = build_packed_parts(prog, template, 1 << 21, cuda)
    vals_p, _ = evaluator.slot_major(free[0])
    del evaluator, free
    vals_p[:, 1::2] = torch.randint(-(1 << 31), 1 << 31, (vals_p.shape[0], vals_p.shape[1] // 2), generator=gen,
                                    dtype=torch.int32, device=cuda)
    _packed_kernels_hold(check, vals_p, False, template.field)
    del vals_p, check
    torch.cuda.empty_cache()


# --- the packed evaluator's addmany stage ----------------------------------------
def _varied_views(arrs, rng):
    """A copy of a stage's view arrays with about a quarter of the views
    negated and a sixth made constant (0 or 1)."""
    a = {k: np.array(v) for k, v in arrs.items()}
    shape = a["idx"].shape
    isc = (a["isc"] != 0) | (rng.random(shape) < 1 / 6)
    a["cv"] = np.where(isc & (a["isc"] == 0), rng.integers(0, 2, shape), a["cv"]).astype(np.uint32)
    a["neg"] = np.where(isc, 0, a["neg"] ^ (rng.random(shape) < 0.25)).astype(np.uint32)
    a["isc"] = isc.astype(np.uint32)
    return a


def _addmany_card_and_plain(vals, tables, n_words, n_out, ones):
    """One stage through the kernel on `vals` and through the plain
    version on a copy (both refilled with all-ones words first where
    `ones`): the two buffers after it."""
    if ones:
        vals.fill_(-1)
    plain = fk.addmany_plain(vals.clone(), tables, n_words, n_out)
    return fk.addmany(vals, tables, n_words, n_out), plain


@pytest.mark.cuda
@pytest.mark.parametrize("Bw", [1, 3, 1024, 65536])
@pytest.mark.parametrize("name", ["sha256", "blake2s", "config2", "config3"])
def test_addmany_on_card_at_each_template_stage(cuda, name, Bw):
    """Every addmany stage of the template, in plan order, on the card
    against the plain version, bit for bit, at Bw 1, 3 (no 8- or 16-byte
    accesses), 1,024 and the step_2m cells' 65,536: on random words (each
    stage reading the sums before it), with every stage's addends all
    ones (the longest carry chains), and on copies of the stages' views
    with negated and constant views; one launch a stage."""
    template, prog = _packed_circuit(name)
    stages = [st for st in prog.stages if st.opcode == "addmany"]
    rng = np.random.default_rng(0x5EED_0023)
    for mode in ("random", "ones", "views"):
        vals = torch.randint(-(1 << 31), 1 << 31, (prog.num_slots, Bw), dtype=torch.int32,
                             generator=torch.Generator(device=cuda).manual_seed(23), device=cuda)
        before = fk.addmany.launches
        for st in stages:
            arrs = _varied_views(st.arrs, rng) if mode == "views" else st.arrs
            tables = fk.addmany_tables(arrs, st.outs, cuda)
            got, want = _addmany_card_and_plain(vals, tables, *st.meta, mode == "ones")
            assert torch.equal(got, want), (name, Bw, mode, st.meta)
        assert fk.addmany.launches == before + len(stages)
        del vals, got, want
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("W,n_words,n_out,Bw,skip,vec", [
    (1, 1, 32, 5, 0, 1), (3, 2, 40, 7, 0, 1), (2, 9, 36, 1024, 0, 4), (1, 17, 37, 33, 0, 1),
    (3, 5, 35, 65538, 0, 2), (2, 4, 34, 1028, 1, 4), (2, 4, 34, 1026, 1, 2), (8, 3, 34, 1 << 16, 0, 4),
    (1, 40, 38, 1 << 18, 0, 4)])
def test_addmany_any_shape_on_card(cuda, W, n_words, n_out, Bw, skip, vec):
    """Shapes no template of the benchmark emits: one word, sums of 9, 17
    and 40 words (the chunked kernel), n_out past the sum's width (planes
    that read zero), ragged Bw, a buffer that starts `skip` rows into its
    allocation, and each width of access (1, 2 and 4 words a thread, the
    widest that base and row length allow); random and all-ones words,
    with negated and constant views, against the plain version."""
    rng = np.random.default_rng(W * 1000 + n_words)
    S = 8 + W * (n_words * 32 + n_out)
    shape = (W, n_words, 32)
    arrs = {"idx": rng.integers(0, S - W * n_out, shape), "neg": rng.integers(0, 2, shape),
            "isc": rng.random(shape) < 0.1, "cv": rng.integers(0, 2, shape)}
    outs = S - W * n_out + np.arange(W * n_out).reshape(W, n_out)
    tables = fk.addmany_tables(arrs, outs, cuda)
    vals = torch.randint(-(1 << 31), 1 << 31, (skip + S, Bw), dtype=torch.int32, device=cuda)[skip:]
    assert fk._addmany_vec(vals) == vec
    for ones in (False, True):
        got, want = _addmany_card_and_plain(vals, tables, n_words, n_out, ones)
        assert torch.equal(got, want), ones


@pytest.mark.cuda
@pytest.mark.parametrize("nonzero", [False, True], ids=["config1", "variant"])
def test_field_evaluator_on_card_matches_cpu_and_python_ints(cuda, nonzero):
    """Config 1 and its num_assert_nonzero variant at B = 256: the card's
    vals and limbs equal the CPU evaluator's; config 1's chain rows at
    four instances equal x <- ((x·b + a) mod p)² mod p over the Python
    ints, the variant's finv pow(x, p − 2, p) of the chain's last x (and
    the field backend's inv on the card); the mixed check is clean, and a
    flipped bit of a field row is found at its instance and at the row
    the Python ints name; operand_mulcmp at the check's product-row table,
    on the limbs with bit 16 cleared at every fifth instance, equals its
    plain version, whose mask holds both verdicts."""
    template, prog = config1(nonzero)
    R, B, p = template.num_constraints, 256, SCALAR.p
    free_np = RNG.integers(0, 2, size=(B, 128)).astype(np.uint32)
    free = from_numpy_u32(free_np, cuda)
    ev = prog.build(device=cuda)
    vals, fl = ev(free)
    cpu_vals, cpu_fl = prog.build(device="cpu")(from_numpy_u32(free_np))
    assert torch.equal(vals.cpu(), cpu_vals) and torch.equal(fl.cpu(), cpu_fl)
    insts = (0, 1, B // 2, B - 1)
    if nonzero:
        fin = next(st for st in prog.stages if st.opcode == "finv")
        assert int(fin.arrs["a_kind"][0]) == SRC_ROW
        x_row, inv_row = int(fin.arrs["a_idx"][0]), int(fin.outs[0])
        for i in insts:
            x = chain_steps(free_np[i])[-1][2]
            assert [col_int(fl[i, row].reshape(16, 1), 0) for row in (x_row, inv_row)] == [x, pow(x, p - 2, p)], i
    else:
        rows = _detect_linear_chain([st for st in prog.stages if st.opcode in SCAN_OPS])["out_rows"]
        for i in insts:
            for r, want in enumerate(chain_steps(free_np[i])):
                assert [col_int(fl[i, int(rows[3 * r + j])].reshape(16, 1), 0) for j in range(3)] == want, (i, r)
    check = build_templated_check(template, B, None, "mixed", field_slots=prog.field_slots, device=cuda)
    assert check.n_mul == 60 + nonzero
    assert _verdict(check.verdict(vals, fl)) == CLEAN
    i, mid = B // 2, sorted(prog.field_rows.values())[45]
    fbad = fl.clone()
    fbad[i, mid, 0] ^= 1
    nbad, first = _verdict(check.verdict(vals, fbad))
    row, _n = python_int_first_bad(template, to_numpy_u32(prog.z_template_limbs(vals, fbad)[i]), prog.field_slots[mid])
    assert row is not None and nbad > 0 and first == i * R + row, (nbad, first, row)
    vals_p, fl_p = ev.slot_major(free)
    assert int(check.verdict_slot_major(vals_p, fl_p)[0]) == 0
    if nonzero:
        x = fl_p[x_row : x_row + 1]  # [1, 16, B], as the evaluator hands it to inv
        assert torch.equal(get_backend(SCALAR).inv(x, 1), fl_p[inv_row : inv_row + 1])
    fl5 = _every_fifth_flipped(fl_p)
    want = fk.operand_mulcmp_plain(check.mul.table, fl5, vals_p, SCALAR)
    _both_verdicts(want)
    assert torch.equal(fk.operand_mulcmp(check.mul.table, fl5, vals_p, SCALAR), want)


@pytest.mark.cuda
def test_sha256_limbs_step_on_card_matches_the_packed_check(cuda):
    """The sha256 compression in the limbs form (the fused route, 17 ELL
    buckets) at 2 × 128: a clean verdict through 17 limbs_matvec launches
    and one mulcmp a chunk; chunk 0's verdict equal to the packed check's
    on the same instances, clean and with an intermediate bit flipped
    (found at its instance); a random field element in a message-bit slot
    found at its instance. Then the kernels at the check's own tables on
    that witness: limbs_matvec at every bucket, and mulcmp on its A·z, B·z
    and C·z with C's odd columns zeroed, each equal to its plain version
    (the mask holding both verdicts)."""
    template, prog = native_sha256()
    R, B = template.num_constraints, 128
    free = from_numpy_u32(RNG.integers(0, 2, size=(2, B, 512)).astype(np.uint32), cuda)
    fk.reset_launch_counts()
    step = build_production_step(prog, template, B, device=cuda, witness_form="limbs")
    assert _verdict(step(free)) == CLEAN
    counts = fk.launch_counts()
    assert counts["limbs_matvec"] == 2 * 17 and counts["mulcmp"] == 2, counts
    check = build_templated_check(template, B, None, "limbs", device=cuda)
    packed = build_templated_check(template, B, None, "bits_packed", device=cuda)
    assert check.fused and check.Rtp == 26360
    z = prog.z_template_limbs(*prog.build(device=cuda)(free[0]))
    words = prog.build_packed(device=cuda)(pack_bits(free[0]))
    slot, inst = 9000, B // 3  # an intermediate slot: its bit flipped in both forms
    zf, wf = z.clone(), words.clone()
    zf[inst, slot, 0] ^= 1
    wf[inst // 32, slot] ^= 1 << (inst % 32)
    for zz, ww in ((z, words), (zf, wf)):
        got = _verdict(check.verdict(zz))
        assert got == _verdict(packed.verdict(ww))
    assert got[0] > 0 and got[1] // R == inst, got
    bad = z.clone()
    bad[B // 2, prog.free_slots[100]] = _canonical(SCALAR, 4, 12, cuda)[:, 3]
    nb, first = _verdict(check.verdict(bad))
    assert nb > 0 and first // R == B // 2, (nb, first)
    zt = z.permute(1, 2, 0).contiguous()
    for m in "abc":
        for cols, F in check.mats[m]:
            assert torch.equal(fk.limbs_matvec(zt, cols, F, SCALAR), fk.limbs_matvec_plain(zt, cols, F, SCALAR)), m
    a, b, c = (check._matvec_fused(m, zt) for m in "abc")
    c[:, 1::2] = 0
    want = _mulcmp_plain(a, b, c, SCALAR)
    _both_verdicts(want)
    assert torch.equal(fk.mulcmp(a, b, c, SCALAR), want)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [2048, 4096])
def test_sha256_limbs_step_at_larger_batches_on_card(cuda, B):
    """The sha256 limbs step at larger chunks, 2 × B: a clean verdict
    through 17 limbs_matvec launches and one mulcmp a chunk, the card's
    peak allocation over the run under 40 GiB (at 8,192 it peaks at
    68.6 GiB on an 80 GB H100: its A·z, B·z and C·z are int32
    [17, 26,360 × 8,192], 14.7 GB each)."""
    template, prog = native_sha256()
    free = from_numpy_u32(RNG.integers(0, 2, size=(2, B, 512)).astype(np.uint32), cuda)
    step = build_production_step(prog, template, B, device=cuda, witness_form="limbs")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    verdict, counts = counted(lambda: _verdict(step(free)))
    peak = torch.cuda.max_memory_allocated() / 2**30
    del step, free
    torch.cuda.empty_cache()
    assert verdict == CLEAN and (counts["limbs_matvec"], counts["mulcmp"]) == (2 * 17, 2), (verdict, counts)
    assert peak < 40, f"peak {peak:.2f} GiB"


@pytest.mark.cuda
def test_config1_limbs_satisfiers_and_their_tables_on_card(cuda):
    """Config 1's TemplatedSatisfier at B = 128 (90 trivial rows through
    operand_mulcmp, 8 fold rows): clean; a random field element in a bit
    slot and a flipped limb of a pack output each named at its instance;
    operand_mulcmp at the trivial rows' table, on z with bit 16 cleared at
    every fifth instance, equal to its plain version (the mask holding
    both verdicts). Then the Satisfier at batch 1 (its fold rows on the
    non-fused limbs route) at its own tables: mul_digits on each matrix's
    gathered z and coefficients, reduce_digits on the bucket row sums and
    mul on A·z and B·z, each equal to its plain version."""
    template, prog = config1(False)
    B = 128
    free = from_numpy_u32(RNG.integers(0, 2, size=(B, 128)).astype(np.uint32), cuda)
    z = prog.z_template_limbs(*prog.build(device=cuda)(free))
    sat = TemplatedSatisfier(template, B, device=cuda)
    assert (sat.check.n_triv, sat.check.fold.Rtp) == (90, 8)
    assert sat.is_satisfied(z)
    bad = z.clone()
    bad[B // 2, prog.free_slots[77]] = _canonical(SCALAR, 4, 13, cuda)[:, 3]
    assert sat.which_is_unsatisfied(bad).startswith(f"instance {B // 2}: ")
    pack = sorted(prog.field_rows, key=prog.field_rows.get)[0]  # the first pack output
    flip = z.clone()
    flip[B // 4, pack, 2] ^= 1
    assert sat.which_is_unsatisfied(flip).startswith(f"instance {B // 4}: ")
    z5 = _every_fifth_flipped(z.permute(1, 2, 0))
    want = fk.operand_mulcmp_plain(sat.check.ops.table, z5, None, SCALAR)
    _both_verdicts(want)
    assert torch.equal(fk.operand_mulcmp(sat.check.ops.table, z5, None, SCALAR), want)

    lc = Satisfier(template, device=cuda)._check.fold  # the rows outside the booleanity and trivial ones
    assert isinstance(lc, LimbsCheck) and not lc.fused
    zl = z[0][:, :, None].permute(1, 2, 0)  # [16, 1, S_t], the check's limb-major view
    for m in "abc":
        cols, coeffs, buckets = lc.mats[m]
        zv = zl.index_select(2, cols).reshape(16, cols.shape[0]).contiguous()
        cv = coeffs.contiguous()
        dig = fk.mul_digits(zv, cv, SCALAR)
        assert torch.equal(dig, fk.mul_digits_plain(zv, cv, SCALAR)), m
        sums = torch.cat([dig[:, s : s + nr * k].reshape(32, nr, k).sum(-1, dtype=torch.int32)
                          for k, s, nr in buckets], dim=1).contiguous()
        assert sums.shape[1] == lc.Rtp
        assert torch.equal(fk.reduce_digits(sums, SCALAR), fk.reduce_digits_plain(sums, SCALAR)), m
    az, bz = (lc._matvec(m, zl) for m in "ab")
    assert torch.equal(fk.mul(az, bz, SCALAR), fk.mul_plain(az, bz, SCALAR))


@pytest.mark.cuda
@pytest.mark.parametrize("T,CB,blk,leaves", [(8, 4, 5, 16), (1024, 512, 700, 1024)], ids=["small", "config4"])
def test_chained_and_merkle_steps_on_card_match_the_oracle(cuda, T, CB, blk, leaves):
    """The chained and Merkle pipelines against the Python sha256 oracle
    of tests/torch_circuits.py, small and at config 4's own size
    (benchmarks/config4_merkle_1024.py: chains of 1,024 blocks, check
    batch 512, a tree of 1,024 leaves): a 64-byte message as two chained
    blocks gives hashlib's digest; one chain of T blocks (check batch CB)
    is clean through one bitplane_eq launch a check batch and ends in the
    oracle's state; a flipped witness bit of block `blk` is named by
    which_from_flat at the row the CPU check of that instance names, and
    PipelinedSatisfier on the same witness is satisfied clean and names
    the flip in its chunk; 3 chains of T blocks end in the oracle's
    states; the Merkle root of `leaves` leaves is the oracle's tree's."""
    template, prog, views = _chain_prog()
    S = prog.num_slots
    nb = NativeBuilder()
    iv = torch.tensor([nb.view(v)[1] for v in nb.sha256_iv()], dtype=torch.int32, device=cuda)
    assert state_words(iv.tolist()) == SHA256_IV

    m = bytes(range(64))
    padded = m + b"\x80" + b"\x00" * 61 + (512).to_bytes(2, "big")
    blocks = [[[(byte >> (7 - i)) & 1 for byte in padded[k : k + 64] for i in range(8)]] for k in (0, 64)]
    step = build_chained_production_step(prog, template, views, check_batch=2, device=cuda)
    total, first, final = step(iv[None], torch.tensor(blocks, dtype=torch.int32, device=cuda))
    digest = b"".join(w.to_bytes(4, "big") for w in state_words(final[0].tolist()))
    assert (int(total), int(first)) == CLEAN and digest == hashlib.sha256(m).digest()

    msgs_np = RNG.integers(0, 2, size=(T, 1, 512)).astype(np.uint32)
    msgs = from_numpy_u32(msgs_np, cuda)
    step = build_chained_production_step(prog, template, views, check_batch=CB, device=cuda)
    fk.reset_launch_counts()
    assert _verdict(step(iv[None], msgs)[:2]) == CLEAN
    assert fk.launch_counts()["bitplane_eq"] == T // CB
    vals, final = step.gen(iv[None], msgs)
    assert _verdict(step.verdict(vals)) == CLEAN
    assert state_words(final[0].tolist()) == oracle_chain(msgs_np, 0)
    bad = vals.clone()
    bad[blk, 0, S - 5] ^= 1
    z4 = bad.reshape(T // CB, CB, S)
    nbad, fbad = _verdict(build_chunked_check(template, CB, T // CB, device=cuda, witness_form="bits")(z4))
    cpu_first = _verdict(build_templated_check(template, 1, None, "bits", device="cpu").verdict(bad[blk].cpu()))[1]
    assert nbad > 0 and which_from_flat(template, fbad) == f"instance {blk}: constraint #{cpu_first}"
    sat = PipelinedSatisfier(template, CB, T // CB, device=cuda, witness_form="bits")
    assert sat.is_satisfied(vals.reshape(z4.shape))
    assert sat.which_is_unsatisfied(z4) == f"chunk {blk // CB}: instance {blk % CB}: constraint #{cpu_first}"

    msgs_np = RNG.integers(0, 2, size=(T, 3, 512)).astype(np.uint32)
    vals, final = step.gen(iv[None].expand(3, 256).contiguous(), from_numpy_u32(msgs_np, cuda))
    assert _verdict(step.verdict(vals)) == CLEAN
    assert [state_words(final[b].tolist()) for b in range(3)] == [oracle_chain(msgs_np, b) for b in range(3)]

    nb = NativeBuilder()
    out = nb.sha256_compression([nb.alloc_bit() for _ in range(512)], nb.sha256_iv())
    template, tape = nb.finish()
    leaves_np = RNG.integers(0, 2, size=(leaves, 256)).astype(np.uint32)
    root, total = build_merkle_tree_step(WitnessProgram(tape), template, [nb.view(v) for v in out], leaves,
                                         device=cuda)(from_numpy_u32(leaves_np, cuda))
    level = [state_words(row) for row in leaves_np]
    while len(level) > 1:
        level = [sha256_compress(SHA256_IV, level[i] + level[i + 1]) for i in range(0, len(level), 2)]
    assert int(total) == 0 and state_words(root.tolist()) == level[0]


@pytest.mark.cuda
def test_num_mixed_block_step_faults_and_tables_on_card(cuda):
    """The num family's mixed block through build_production_step at 2 ×
    128: clean, through mul (the inversions) and one operand_mulcmp and
    one mulcmp launch a chunk; a flipped bit of the sha256 part and a
    flipped limb of the inverse found at their instance. Then the kernels
    at its tables on chunk 0's witness: limbs_matvec at every bucket of
    the mixed check's rest rows (the fused limbs check), operand_mulcmp at
    its product rows' table on the limbs with bit 16 cleared at every
    fifth instance, and mulcmp on the rest rows' A·z, B·z and C·z with C's
    odd columns zeroed, each equal to its plain version (the masks holding
    both verdicts)."""
    template, prog = _num_mixed_block()
    R, B = template.num_constraints, 128
    free = from_numpy_u32(RNG.integers(0, 2, size=(2, B, len(prog.free_slots))).astype(np.uint32), cuda)
    ff = torch.stack([_canonical(SCALAR, B, 21 + k, cuda).t().reshape(B, 1, 16) for k in range(2)]).contiguous()
    fk.reset_launch_counts()
    assert _verdict(build_production_step(prog, template, B, device=cuda)(free, ff)) == CLEAN
    counts = fk.launch_counts()
    assert counts["mul"] > 0 and counts["operand_mulcmp"] == counts["mulcmp"] == 2, counts
    vals, fl = prog.build(device=cuda)(free[0], ff[0])
    check = build_templated_check(template, B, None, "mixed", field_slots=prog.field_slots, device=cuda)
    fl_check = torch.cat([fl, ff[0]], dim=1)
    assert _verdict(check.verdict(vals, fl_check)) == CLEAN
    inv_row = int(next(st.outs[0] for st in prog.stages if st.opcode == "num_inv_or_one"))
    for inst, edit in ((B // 3, lambda v, f, i: v[i, 9000].bitwise_xor_(1)),
                       (5, lambda v, f, i: f[i, inv_row, 3].bitwise_xor_(1))):
        v, f = vals.clone(), fl_check.clone()
        edit(v, f, inst)
        nbad, first = _verdict(check.verdict(v, f))
        assert nbad > 0 and first // R == inst, (inst, nbad, first)
    vals_p, fl_p = vals.t().contiguous(), fl_check.permute(1, 2, 0).contiguous()
    zt = check.rest_z(vals_p, fl_p)
    assert check.rest.fused
    for m in "abc":
        for cols, F in check.rest.mats[m]:
            assert torch.equal(fk.limbs_matvec(zt, cols, F, SCALAR), fk.limbs_matvec_plain(zt, cols, F, SCALAR)), m
    fl5 = _every_fifth_flipped(fl_p)
    want = fk.operand_mulcmp_plain(check.mul.table, fl5, vals_p, SCALAR)
    _both_verdicts(want)
    assert torch.equal(fk.operand_mulcmp(check.mul.table, fl5, vals_p, SCALAR), want)
    a, b, c = (check.rest._matvec_fused(m, zt) for m in "abc")
    c[:, 1::2] = 0
    want = _mulcmp_plain(a, b, c, SCALAR)
    _both_verdicts(want)
    assert torch.equal(fk.mulcmp(a, b, c, SCALAR), want)


@pytest.mark.cuda
def test_config5_launches_product_and_kernels_on_card(cuda):
    """Config 5's generator at 2^16 rows: one completion and one check
    launch exactly mul (one a product chunk, two a premul slice),
    reduce_digits (two a product chunk) and mulcmp (one a check chunk); a
    second completion gives the same z; the product at 512 sampled rows
    equals A·z · B·z over the Python ints; RowShardedSatisfier checks
    through 3 mul_digits, 3 reduce_digits and 1 mul launches and gives the
    semi and canonical routes' verdicts, clean and with z[5, 0] flipped.
    Then the kernels at its shapes and operands, each equal to its plain
    version: mulcmp on the check's chunk 0 semi blocks with C's odd
    columns zeroed (the mask holding both verdicts), mul on a premul slice
    of the raw z (values in [p, 2^256)) and on the product's chunk 0 (held
    to Python ints too), reduce_digits on that chunk's A digit sums in
    both layouts, and the row shard's mul_digits on A's gathered raw z,
    reduce_digits on its digit sums and mul on its A·z and B·z."""
    r1cs, zfree, N0, _ = config5_r1cs(16)
    R, p, n_chk, n_wit = r1cs.num_constraints, SCALAR.p, 4, 16
    check, prep = build_row_chunked_check(r1cs, n_chk, device=cuda)
    meta = check._layout_meta
    prod, prep_ab = build_row_chunked_product(r1cs, n_wit, reuse=(meta, prep), device=cuda)
    z = config5_z(zfree, R, cuda)
    fk.reset_launch_counts()
    z[N0 + 1 :] = prod(z, prep_ab)
    assert _verdict(check(z, prep)) == CLEAN
    n_pm = len(meta["span"])
    assert fk.launch_counts() == {**dict.fromkeys(fk.KERNELS, 0), "mul": n_wit + 2 * n_pm,
                                  "reduce_digits": 2 * n_wit, "mulcmp": n_chk}
    z2 = z.clone()
    z2[N0 + 1 :] = prod(z2, prep_ab)
    assert torch.equal(z2, z)
    rows = np.sort(np.random.default_rng(0x5EED_0016).choice(R, 512, replace=False))
    slots = np.concatenate([r1cs.a.cols[2 * rows], r1cs.a.cols[2 * rows + 1], r1cs.b.cols[rows], N0 + 1 + rows])
    sums = row_sums_int(r1cs, z_ints(z, slots), rows)
    assert all(sa * sb % p == sc for sa, sb, sc in zip(sums["a"], sums["b"], sums["c"]))

    rsat = RowShardedSatisfier(r1cs, device=cuda)
    canon, _ = build_row_chunked_check(r1cs, n_chk, use_pallas=False, reuse=(meta, prep), device=cuda)
    fk.reset_launch_counts()
    got = _verdict(rsat._check(z))
    assert fk.launch_counts() == {**dict.fromkeys(fk.KERNELS, 0), "mul_digits": 3, "reduce_digits": 3, "mul": 1}
    zb = z.clone()
    zb[5, 0] ^= 1
    for zz, want in ((z, CLEAN), (zb, None)):
        got = [_verdict(f(zz)) for f in (rsat._check, lambda t: check(t, prep), lambda t: canon(t, prep))]
        assert got[0] == got[1] == got[2] and (want is None or got[0] == want), got
    assert got[0][0] > 0 and got[0][1] == flipped_first_row(r1cs, 5)

    ev, _ = build_row_chunked_eval(r1cs, n_chk, reuse=(meta, prep), device=cuda)
    cl = prep["coeff_limbs"]
    zsrc = ev._zsrc(z, cl)
    a, b, c = ev._blocks_semi(zsrc, cl, _chunk(ev._xs(prep, ("a", "b", "c")), 0), ("a", "b", "c"))
    c[:, 1::2] = 0
    want = _mulcmp_plain(a, b, c, SCALAR)
    _both_verdicts(want)
    assert torch.equal(fk.mulcmp(a, b, c, SCALAR), want)
    k = max(ev.span)  # the last premul slice
    n = ev.span[k]
    zk = z[:n].t().contiguous()
    ck = cl[k][:, None].expand(16, n).contiguous()
    vals = [col_int(zk, i) for i in range(64)]
    assert any(v >= p for v in vals)
    got = fk.mul(zk, ck, SCALAR)
    cv = col_int(cl[k][:, None], 0)
    assert [col_int(got, i) for i in range(64)] == [v * cv % p for v in vals]
    assert torch.equal(got, fk.mul_plain(zk, ck, SCALAR))
    ew, _ = build_row_chunked_eval(r1cs, n_wit, names=("a", "b"), reuse=(meta, prep), device=cuda)
    x0 = _chunk(ew._xs(prep, ("a", "b")), 0)
    az, bz = ew._blocks(zsrc, cl, x0, ("a", "b"))
    assert torch.equal(fk.mul(az, bz, SCALAR), fk.mul_plain(az, bz, SCALAR))
    em = _ell_digit_sums(ew._gathered(zsrc, cl, x0[0], "a"), 2)  # [n, 32], as _block passes it
    for d in (em.t(), em.t().contiguous()):
        assert torch.equal(fk.reduce_digits(d, SCALAR), fk.reduce_digits_plain(d, SCALAR))

    local, _origin = rsat._shards[0]
    e = local["a"]
    zv = _gather_rows(z, e["cols"]).t().contiguous()
    cv = rsat._coeff_lm.index_select(1, e["cids"]).contiguous()
    dig = fk.mul_digits(zv, cv, SCALAR)
    assert torch.equal(dig, fk.mul_digits_plain(zv, cv, SCALAR))
    d = to_numpy_u32(dig).astype(object)
    for i in (0, 1, 2, zv.shape[1] - 1):
        assert sum(int(d[j, i]) << (8 * j) for j in range(32)) == col_int(zv, i) * col_int(cv, i) % p
    dsum = dig.reshape(32, -1, 2).sum(2, dtype=torch.int32)
    assert torch.equal(fk.reduce_digits(dsum, SCALAR), fk.reduce_digits_plain(dsum, SCALAR))
    az, bz = (rsat._matvec_local(m, z, local) for m in "ab")
    assert torch.equal(fk.mul(az, bz, SCALAR), fk.mul_plain(az, bz, SCALAR))


@pytest.mark.cuda
def test_sharded_paths_two_gloo_ranks_on_one_card(cuda):
    """Two gloo ranks sharing the one card (the rank logic, not scaling):
    each runs the dry run's checks, then the packed step at 4,096 and the
    bits step at 256 instances (clean, and with one xor of two free bits
    computing `and`, those bits zeroed in the first half of the batch so
    that the first failure lies on the last rank), the limbs
    ShardedSatisfier at 256 (clean and with a flipped limb) and
    RowShardedSatisfier on config 5 at 2^16 rows (clean, z[5, 0] flipped
    and a product slot of the last quarter flipped). Every verdict and
    name equals single-rank execution on the card in this process, the
    witness shards in rank order equal its witness, and each path
    launches its kernels on each rank as one rank does."""
    inp = ranks.card_inputs()
    want = ranks.card_paths(cuda, inp, None)
    results = RankJob(ranks.card_rank, 2, inp, backend="gloo", device=cuda.type).join(timeout=600)
    for r, res in enumerate(results):
        assert res["rank"] == r and res["device"].split(":")[0] == cuda.type, res["device"]
        assert res["verdict"] == want["verdict"], (r, res["verdict"], want["verdict"])
        assert res["launches"] == want["launches"], (r, res["launches"], want["launches"])
        d = res["dryrun"]
        assert (d["world"], d["backend"], d["packed"]) == (2, "gloo", CLEAN), d
        assert d["which"] == ["constraint #699", "constraint #53403"], d["which"]
    for path in ("packed", "bits"):
        assert torch.equal(torch.cat([res["shard"][path] for res in results]), want["shard"][path]), path
    v = want["verdict"]
    assert v["packed"] == v["limbs"] == v["row"][0] == CLEAN and v["bits"] == 0, v
    assert v["packed_bad"][0] > 0 and v["packed_bad"][1] // 26352 >= 2048 and v["bits_bad"] > 0, v
    assert v["limbs_bad"][0][0] > 0 and v["limbs_bad"][0][1] // 26352 == 200, v
    r1cs = config5_r1cs(ranks.CARD_ROW_LOG2_R)[0]
    R = r1cs.num_constraints
    assert [flip[0][1] for flip in v["row"][1:]] == [flipped_first_row(r1cs, 5), 3 * R // 4 + 1], v["row"]


@pytest.mark.cuda
def test_reference_style_calls_on_card_launch_what_their_paths_launch(cuda, tmp_path):
    """The reference's device-layer API called as a program written against
    bellpepper_tpu calls it, with no device argument (the card), launching
    what the call with device= launches and giving its verdicts: both
    Satisfier routes on a two-block sha256 chain (clean, and a bit slot set
    to a random field element named at the row the Python ints name;
    Satisfier(r, False) 4 mul and 3 reduce_digits launches a check, the
    templated route 3 mul_digits, 3 reduce_digits and 1 mul); the chain
    through save_r1cs, save_witness, load_r1cs and load_witness (z
    bit-equal, the loaded Satisfier's verdicts the same); the flagship
    packed step at 1,024 under set_default_config(Config(use_pallas=True)),
    clean and corrupted; PipelinedSatisfier(config 1, 128, 2,
    config=Config(use_pallas=True)) in the limbs form, clean and a flipped
    limb named at its chunk, instance and Python-int row;
    WitnessProgram.run equal to build()'s evaluator; FieldBackend.mul_pow2
    at the corner values against Python ints."""
    p = SCALAR.p
    nb = NativeBuilder()
    state = nb.sha256_iv()
    for _ in range(2):
        state = nb.sha256_compression([nb.alloc_bit() for _ in range(512)], state)
    template, tape = nb.finish()
    prog = WitnessProgram(tape)
    z = prog.z_template_limbs(*prog.build(device=cuda)(_u32((1, 1024), cuda, 2)))[0]
    slot = prog.free_slots[512 + 77]
    bad = z.clone()
    bad[slot] = _canonical(SCALAR, 4, 14, cuda)[:, 3]
    row, _n = python_int_first_bad(template, to_numpy_u32(bad), slot)
    assert row is not None
    for use_pallas, launches in ((False, {"mul": 4, "reduce_digits": 3}),
                                 (True, {"mul_digits": 3, "reduce_digits": 3, "mul": 1})):
        ref, dev = Satisfier(template, use_pallas), Satisfier(template, use_pallas, device=cuda)
        for sat in (ref, dev):
            ok, counts = counted(lambda: sat.is_satisfied(z))
            assert ok and counts == launches, (use_pallas, counts)
            assert sat.which_is_unsatisfied(bad) == f"constraint #{row}"
    fp = save_r1cs(str(tmp_path / "chain_r1cs.npz"), template)
    save_witness(str(tmp_path / "chain_z.npz"), z, fp)
    loaded = load_r1cs(str(tmp_path / "chain_r1cs.npz"), expect_fingerprint=fp)
    zl_np, meta = load_witness(str(tmp_path / "chain_z.npz"), expect_fingerprint=fp)
    zl = from_numpy_u32(zl_np, cuda)
    assert torch.equal(zl, z) and meta["r1cs_fingerprint"] == fp
    sat = Satisfier(loaded, False)
    assert (sat.is_satisfied(zl), sat.which_is_unsatisfied(zl), sat.is_satisfied(bad),
            sat.which_is_unsatisfied(bad)) == (True, None, False, f"constraint #{row}")

    sha_template, sha_prog = native_sha256()
    free = _u32((2, 32, 512), cuda)
    before = default_config()
    set_default_config(Config(use_pallas=True))
    try:
        cfg = default_config()
        step = build_packed_production_step(sha_prog, sha_template, 1024, cfg.use_pallas)
        check = build_templated_check(sha_template, 1024, cfg.use_pallas, "bits_packed")
        vals0 = build_packed_chunked_witness(sha_prog)(free)[0]
    finally:
        set_default_config(before)
    vbad = vals0.clone()
    vbad[16, 600] ^= 1 << 7
    dev_step = build_packed_production_step(sha_prog, sha_template, 1024, device=cuda)
    dev_check = build_templated_check(sha_template, 1024, None, "bits_packed", device=cuda)
    got, want = counted(lambda: _verdict(step(free))), counted(lambda: _verdict(dev_step(free)))
    assert got == want and got[0] == CLEAN, (got, want)
    got, want = counted(lambda: _verdict(check.verdict(vbad))), counted(lambda: _verdict(dev_check.verdict(vbad)))
    assert got == want and got[0][0] > 0 and got[0][1] // sha_template.num_constraints == 32 * 16 + 7, got

    template, prog = config1(False)
    free_np = RNG.integers(0, 2, size=(2, 128, 128)).astype(np.uint32)
    ev = prog.build(True)
    z4 = torch.stack([prog.z_template_limbs(*ev(f)) for f in from_numpy_u32(free_np, cuda)])
    psat = PipelinedSatisfier(template, 128, 2, config=Config(use_pallas=True))
    dev_psat = PipelinedSatisfier(template, 128, 2, True, device=cuda)
    got, want = counted(lambda: psat.is_satisfied(z4)), counted(lambda: dev_psat.is_satisfied(z4))
    assert psat.witness_form == "limbs" and got == want and got[0], (got, want)
    pack = sorted(prog.field_rows, key=prog.field_rows.get)[0]
    z4[1, 42, pack, 2] ^= 1
    row, _n = python_int_first_bad(template, to_numpy_u32(z4[1, 42]), pack)
    assert psat.which_is_unsatisfied(z4) == f"chunk 1: instance 42: constraint #{row}"
    (vals, flimbs), got = counted(lambda: prog.run(free_np[0]))
    want_v, want_f = ev(from_numpy_u32(free_np[0], cuda))
    assert torch.equal(vals, want_v) and torch.equal(flimbs, want_f) and got.get("chain") == 1, got

    be = get_backend(SCALAR)
    corners = [0, 1, 2, p - 1, p - 2, (p + 1) // 2, (1 << 240) - 1, (((p >> 240) - 1) << 240) | ((1 << 240) - 1)]
    vals_a = corners + [random.Random(15).randrange(p) for _ in range(4096 - len(corners))]
    a = torch.from_numpy(FieldBackend.to_limbs(vals_a).view(np.int32)).to(cuda)  # [4096, 16]
    for k in (0, 1, 16, 255, 256, 511):
        assert be.from_limbs(be.mul_pow2(a, k)) == [v * pow(2, k, p) % p for v in vals_a], k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["config1", "config3"])
def test_frontend_programs_on_card_equal_native(cuda, name):
    """Config 1 (the mixed step at 2 × 256) and config 3 (the mixed
    packed step at 2 × 512) through the port's ShapeCS and TapeCS: a clean
    verdict through the path's kernels (config 1's chain and
    operand_mulcmp, config 3's bitplane_eq), chunk 0's evaluator output on
    the card equal to NativeBuilder's program's; config 1's mixed check
    finds a flipped bit of a chain row at its instance."""
    _name, circuit, native, _want = next(c for c in FRONTEND if c[0] == name)
    shape, tape = ShapeCS(), TapeCS()
    circuit(shape)
    circuit(tape)
    template, prog = shape.finish(), WitnessProgram(tape)
    n_prog = native()[1]
    fk.reset_launch_counts()
    if name == "config1":
        B = 256
        free = from_numpy_u32(RNG.integers(0, 2, size=(2, B, 128)).astype(np.uint32), cuda)
        assert _verdict(build_production_step(prog, template, B, device=cuda)(free)) == CLEAN
        counts = fk.launch_counts()
        assert counts["chain"] == counts["operand_mulcmp"] == 2, counts
        got, want = prog.build(device=cuda)(free[0]), n_prog.build(device=cuda)(free[0])
        check = build_templated_check(template, B, None, "mixed", field_slots=prog.field_slots, device=cuda)
        row = int(_detect_linear_chain([st for st in prog.stages if st.opcode in SCAN_OPS])["out_rows"][45])
        fbad = got[1].clone()
        fbad[B // 3, row, 0] ^= 1
        nbad, first = _verdict(check.verdict(got[0], fbad))
        assert nbad > 0 and first // template.num_constraints == B // 3, (nbad, first)
    else:
        free = _u32((2, 16, len(prog.free_slots)), cuda)
        assert _verdict(build_packed_production_step(prog, template, 512, device=cuda)(free)) == CLEAN
        assert fk.launch_counts()["bitplane_eq"] == 2
        got, want = prog.build_packed_mixed(device=cuda)(free[0]), n_prog.build_packed_mixed(device=cuda)(free[0])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
