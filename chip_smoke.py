#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one CUDA card, and check
their eight kernels (and the op-rate probe) against their plain versions.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (one line each, or a few):

  * the card's name and power limit; the kernel build (all nvcc processes
    at once) and ptxas's register and spill report;
  * native synthesis of one sha256 compression (26,352 rows, 26,327
    slots), of config 1 (pack → (mul, add, square) × 30: 220 rows, 221
    slots) and of its variant with num_assert_nonzero (221 rows, 222
    slots), with the mixed row classes of both;
  * each kernel against its plain PyTorch version at its path's shapes and
    real tables (bit-exact): bitplane_eq through the sha256 pow2 plane
    table and bits_matvec_semi through the big row's ELL buckets, on one
    packed chunk whose odd words are random; limbs_matvec on config 1's
    a-bucket and the sha256 limbs check's widest a-bucket (random limbs),
    and at the K = 2,064 bound with every digit and fold entry 255; with
    the kernel's, the plain version's and, where one PyTorch call computes
    the same work, that call's times, and the least time the card could
    take (``bound``, below);
  * the op-rate probe (the counterpart of benchmarks/probe_vpu_ops.py):
    G op/s of each of its seven op classes;
  * the packed sha256 step at 4 chunks of 32,768 instances, the config-1
    step and the variant's step at 4 chunks of 8,192 instances: clean
    verdicts, each path's kernels launched (counts reset just before the
    path's run and read just after), words equal to the CPU evaluator's,
    planted corruptions found at their instance, a Python-int recurrence
    for the chain;
  * each step's time, rate and peak memory; the config-1 witness and
    check seconds per chunk and the check's split by row class;
  * the limbs witness form: config 1's step at 4 × 8,192 and the sha256
    step at 4 × 1,024 in the limbs form (verdicts, launches, a non-bit
    value planted in a bit slot found at its instance, the sha256 chunk's
    verdict equal to the packed check's), the sha256 limbs step again at
    2,048, 4,096 and 8,192 instances a chunk in turn while its peak,
    extrapolated from the runs before, stays under 40 GiB, and the
    ``Satisfier`` of a 16-block sha256 chain (426,912 rows) at batch 1,
    whose ``which_is_unsatisfied`` names the row a Python-int evaluation
    finds; each with its time (and the steps' rate and peak memory).

``bound``: the larger of the bytes a kernel's function must move (each
input read once, each output written once: for the kernels that read the
witness through a table, the distinct slots the table names, the fold
planes as stored and the output) over 3.35 TB/s and the 32-bit integer
products that function needs on these inputs (not those of the kernel's
own design; see ``modmul_products``) over 64 lanes × 132 SMs × the card's
maximum SM clock. The line before last names the card again; the last
line is {"ok": true, "device": {...}}. Any failed phase raises and the
script exits non-zero. Without a CUDA device it exits 1 at once."""

import json
import random
import subprocess
import sys
import time

import numpy as np
import torch

from bellpepper_tpu_torch import (
    SCALAR,
    NativeBuilder,
    Satisfier,
    TemplatedSatisfier,
    WitnessProgram,
    build_packed_chunked_witness,
    build_packed_production_step,
    build_production_step,
    build_templated_check,
    pack_bits,
)
from bellpepper_tpu_torch.backend import cuda_lib, field_kernels as fk, op_rate
from bellpepper_tpu_torch.backend.layout import MAX_FUSED_LIMBS_K, _classify_mixed_rows
from bellpepper_tpu_torch.backend.matvec import ROW_CLASSES
from bellpepper_tpu_torch.backend.words import from_numpy_u32, to_u32
from bellpepper_tpu_torch.compile.witness_program import SCAN_OPS, _detect_linear_chain

B = 32768  # sha256 instances per chunk
N_CHUNKS = 4
B_FIELD = 8192  # config-1 instances per chunk (benchmarks/configs_1_2_3.py:123)
B_SHA_LIMBS = 1024  # sha256 instances per chunk in the limbs form
CHAIN_BLOCKS = 16  # compressions of the Satisfier's chain (a 1 KiB message)
MUL_WIDE_N = 1 << 20  # mul's second shape: one launch wide enough to fill the card
# the Satisfier's widest mul_digits launch (matrix c of the 16-block chain)
# and the chain's padded rows, the N of its reduce_digits and mul launches
MUL_DIGITS_N = 1258176
CHAIN_ROWS_N = 426920
# the rows of mulcmp's launches on the limbs paths (times the chunk's
# batch): config 1's 90 trivial rows and its 2 fold rows padded to 8, and
# the sha256 template's 26,352 rows padded to 26,360
CONFIG1_TRIVIAL_ROWS, CONFIG1_FOLD_ROWS, SHA256_LIMBS_ROWS = 90, 8, 26360
# the sha256 limbs step's larger batches, run in turn while the peak
# memory extrapolated from the runs before stays under PEAK_GIB
B_SHA_LIMBS_BIG = (2048, 4096, 8192)
PEAK_GIB = 40
# the op-rate probe: rows (ILP), rounds and elements of each launch
PROBE_R, PROBE_K, PROBE_N = 8, 256, 1 << 20
SEED = 0x5962BE3D
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12
INT32_LANES = 64 * 132  # per clock: 64 INT32 lanes on each of the 132 SMs
KERNEL_INFO = {
    "bitplane_eq": ("bellpepper_tpu_torch/csrc/bitplane_eq.cu",
                    "bellpepper_tpu/backend/field_pallas.py:489"),
    "bits_matvec_semi": ("bellpepper_tpu_torch/csrc/fold_matvec.cu",
                         "bellpepper_tpu/backend/field_pallas.py:828"),
    "mulcmp": ("bellpepper_tpu_torch/csrc/mulcmp.cu",
               "bellpepper_tpu/backend/field_pallas.py:1009"),
    "chain": ("bellpepper_tpu_torch/csrc/chain.cu",
              "bellpepper_tpu/backend/field_pallas.py:407"),
    "mul": ("bellpepper_tpu_torch/csrc/mul16.cu",
            "bellpepper_tpu/backend/field_pallas.py:704"),
    "limbs_matvec": ("bellpepper_tpu_torch/csrc/fold_matvec.cu",
                     "bellpepper_tpu/backend/field_pallas.py:975"),
    "mul_digits": ("bellpepper_tpu_torch/csrc/mul16.cu",
                   "bellpepper_tpu/backend/field_pallas.py:711"),
    "reduce_digits": ("bellpepper_tpu_torch/csrc/reduce_digits.cu",
                      "bellpepper_tpu/backend/field_pallas.py:720"),
}


def reduction_products(words: int, words_p: int = 8) -> int:
    """32-bit multiplies of a Montgomery reduction of a words-word value
    below p: one quotient word and words_p products a word reduced, each
    32×32 → 64-bit product counted as two 32-bit multiplies (its low and
    high words)."""
    return 2 * (words - words_p) * (1 + words_p)


def modmul_products(words_a: int, words_b: int, words_p: int = 8) -> int:
    """32-bit multiplies that a·b mod p needs at the least: a schoolbook
    product of 32-bit words (two multiplies a word pair) and a Montgomery
    reduction of it. The operations side of `bound` counts only products:
    the adds and logic ops fuse around them, so their count gives a time the
    card cannot beat whatever limb size a kernel chooses."""
    return 2 * words_a * words_b + reduction_products(words_a + words_b, words_p)


# Products per element. A canonical modmul (chain's fmul steps, mul,
# mul_digits) takes two 8-word residues; mulcmp's a·b − c takes 17-limb
# semi values below 2^265, 9 words each. bits_matvec_semi multiplies 0/1
# bits by digits (a select, no product) and folds 4 × 32 digit sums by
# constants in its semi reduction, for each live row. limbs_matvec needs
# one 8 × 8-word product a live ELL entry and one reduction of a live
# row's 17-word sum, whatever the 1,024 digit multiply-adds an entry of
# its design. reduce_digits
# reduces a sum of 32 digit sums below 2^24 (a 10-word value). bitplane_eq
# does logic ops only.
MODMUL_MULS = modmul_products(8, 8)
MULCMP_MULS = modmul_products(9, 9)
SEMI_REDUCE_MULS = 4 * 32
ENTRY_MULS = 2 * 8 * 8
ROW_REDUCE_MULS = reduction_products(17)
REDUCE_MULS = reduction_products(10)


def nvidia_smi(query: str) -> str:
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def card_line() -> str:
    return nvidia_smi("name,power.limit")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_s(fn, reps: int) -> float:
    """Mean host-clock seconds of fn() over reps calls, after one warm-up,
    with one synchronize at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.time() - t0) / reps


def max_abs_err(x: torch.Tensor, y: torch.Tensor) -> int:
    return int((to_u32(x) - to_u32(y)).abs().max())


class Bound:
    """The least time the card could take for a kernel's work."""

    def __init__(self, max_sm_mhz: float):
        self.int_ops_per_s = INT32_LANES * max_sm_mhz * 1e6

    def __call__(self, n_bytes: float, n_ops: float):
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / self.int_ops_per_s * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, kernel, plain, bound, reps=20, plain_reps=3, library=None):
    """Kernel vs plain version on the same card inputs:
    dict(err, ms, plain_ms, bound_ms, bound_by, library_ms)."""
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = max_abs_err(out, ref)
    ms, plain_ms = cuda_ms(kernel, reps), cuda_ms(plain, plain_reps)
    lib_ms = cuda_ms(library, reps) if library is not None else None
    lib = f" library {lib_ms:.4f} ms" if lib_ms is not None else ""
    print(f"[kernel] {name}: shape {tuple(out.shape)} max_abs_err {err} kernel {ms:.4f} ms "
          f"plain {plain_ms:.4f} ms{lib} bound {bound[0]:.4f} ms ({bound[1]})")
    assert err == 0, f"{name} disagrees with its plain version"
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": lib_ms}


def limbs(v, n=17):
    return [(v >> (16 * l)) & 0xFFFF for l in range(n)]


def canonical_lm(values, dev):
    """int32[16, N] limb-major canonical limbs of Python ints."""
    return from_numpy_u32(np.asarray([limbs(v, 16) for v in values], np.uint32).T.copy(), dev)


def limb_int(row) -> int:
    return sum(int(x) << (16 * l) for l, x in enumerate(row))


def col_int(t: torch.Tensor, i: int) -> int:
    return limb_int(to_u32(t[:, i]).tolist())


def config1(nonzero: bool):
    nb = NativeBuilder()
    bits = [nb.alloc_bit() for _ in range(128)]
    a, b = nb.pack_bits(bits[:64]), nb.pack_bits(bits[64:])
    x = a
    for _ in range(30):
        x = nb.num_square(nb.num_add(nb.num_mul(x, b), a))
    if nonzero:
        nb.num_assert_nonzero(x)
    template, tape = nb.finish()
    return template, WitnessProgram(tape)


def path_run(step, *args):
    """One run of a path's step with every launch count reset just before
    and read just after: (verdict, counts)."""
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    total, first = step(*args)
    verdict = (int(total), int(first))
    return verdict, fk.launch_counts()


def time_step(step, free, reps):
    torch.cuda.synchronize()
    t0 = time.time()
    totals = [step(free)[0] for _ in range(reps)]
    torch.cuda.synchronize()
    dt = (time.time() - t0) / reps
    assert sum(int(t) for t in totals) == 0
    return dt


def perf_step(name, step, free, batch, n_rows, card, reps):
    """Time a step of N_CHUNKS × batch instances (its verdict must stay
    clean) and print its rate and peak memory; returns the peak in GiB."""
    torch.cuda.reset_peak_memory_stats()
    t_step = time_step(step, free, reps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[perf] {name} step {t_step:.4f} s for {N_CHUNKS}x{batch} instances = "
          f"{N_CHUNKS * batch * n_rows / t_step:.4e} constraint-evals/s, peak {peak:.2f} GiB, on {card}")
    return peak


def mulcmp_operands(N: int, dev):
    """a, b, c int32[17, N] on the card: random semi values below 2^265
    (the range of the semi-reduced matvec outputs and of the assembled
    trivial-row operands, which stay below 4p), with the corner operands
    (0, p, 2p, 2^265 − 1) in all combinations and 1,024 true products
    (c = a·b mod p, plus p at odd columns) in the first columns; and the
    verdicts of those columns (True where a·b ≢ c)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + N)
    ops = [torch.randint(0, 1 << 16, (17, N), generator=gen, device=dev, dtype=torch.int32) for _ in range(3)]
    for o in ops:
        o[16] &= 0x1FF  # values < 2^265
    p = SCALAR.p
    corners = [0, p, 2 * p, (1 << 265) - 1]
    cols = [(va, vb, vc) for va in corners for vb in corners for vc in corners]
    want = [(va * vb - vc) % p != 0 for va, vb, vc in cols]
    rnd = np.random.default_rng(SEED + 1)
    for i in range(1024):
        va, vb = (int.from_bytes(rnd.bytes(32), "little") % p for _ in range(2))
        cols.append((va, vb, (va * vb) % p + (p if i % 2 else 0)))
        want.append(False)
    for k, o in enumerate(ops):
        o[:, : len(cols)] = from_numpy_u32(np.asarray([limbs(col[k]) for col in cols], np.uint32).T.copy(), dev)
    return ops, np.asarray(want)


def mulcmp_at(N: int, dev):
    """mulcmp at one more of its paths' shapes: the planted columns'
    verdicts, and every column bit-exact against the plain version (run
    over slices of 2^20 columns, which bounds its int64 temporaries)."""
    (a, b, c), want = mulcmp_operands(N, dev)
    out = fk.mulcmp(a, b, c, SCALAR)
    assert ((out[: len(want)] != 0).cpu().numpy() == want).all(), ("mulcmp planted columns", N)
    step = 1 << 20
    err = max(max_abs_err(out[s : s + step], fk.mulcmp_plain(
        *(o[:, s : s + step].contiguous() for o in (a, b, c)), SCALAR)) for s in range(0, N, step))
    ms = cuda_ms(lambda: fk.mulcmp(a, b, c, SCALAR), 5)
    print(f"[kernel] mulcmp N={N}: max_abs_err {err} kernel {ms:.4f} ms")
    assert err == 0, f"mulcmp disagrees with its plain version at N={N}"


def gathered_bytes(cols: torch.Tensor, slot_bytes: int) -> int:
    """The bytes of the distinct witness slots a column or plane table
    reads (each read once)."""
    live = cols[cols >= 0]
    return int(torch.unique(live).numel()) * slot_bytes


def sha256_kernels(dev, bound, template, prog):
    """bitplane_eq, bits_matvec_semi and mulcmp at the sha256 step's shapes
    and tables: the packed check's pow2 plane table and its big row's ELL
    buckets, read from one chunk's packed witness whose odd words are
    random (so both verdicts occur)."""
    rng = np.random.default_rng(SEED)
    Bw = B // 32
    results = {}
    check = build_templated_check(template, B, device=dev)
    free = from_numpy_u32(rng.integers(0, 1 << 32, size=(Bw, 512), dtype=np.uint64).astype(np.uint32), dev)
    vals_p = prog.build_packed(dev)(free).t().contiguous()  # [S_t, Bw]
    vals_p[:, 1::2] = from_numpy_u32(rng.integers(0, 1 << 32, size=(vals_p.shape[0], Bw // 2),
                                                  dtype=np.uint64).astype(np.uint32), dev)
    del free
    # bitplane_eq: the 25 MultiEq rows, P = 256, m_a = 7, m_c = 1, over
    # the plane table (empty planes −1); the library has no counterpart
    spec, planes = check.pow2_spec, check.plane_idx
    n, m_a, m_c = spec["a_cols"].shape[0], spec["a_cols"].shape[2], spec["c_cols"].shape[2]
    P = fk.padded_positions(spec["n_pos"])
    bad = fk.bitplane_eq(vals_p, planes, n, P, m_a, m_c)
    assert not bad[:, ::2].any() and bad[:, 1::2].all(), "bitplane_eq verdicts"
    results["bitplane_eq"] = compare(
        f"bitplane_eq n={n} P={P} m_a={m_a} m_c={m_c} Bw={Bw} ({int((planes < 0).sum())} of "
        f"{planes.numel()} planes empty)",
        lambda: fk.bitplane_eq(vals_p, planes, n, P, m_a, m_c),
        lambda: fk.bitplane_eq_plain(vals_p, planes, n, P, m_a, m_c),
        bound(gathered_bytes(planes, Bw * 4) + n * Bw * 4, 0))
    # bits_matvec_semi: the big row's ELL buckets, one a matrix, (K, rows) =
    # (512, 8), (1, 8), (256, 8), 7 rows of each padding. The library
    # yardstick is torch.bmm in float32 over the gathered bits' 32 digit
    # sums only (no reduction).
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "ops": 0}
    for name in "abc":
        (cols, F), = check.big.mats[name]
        n_rows, K = cols.shape
        xf = fk._gather_bits(vals_p, cols).float()
        Ff = F[:, :, :K].float()
        n_bytes = gathered_bytes(cols, Bw * 4) + F.numel() + 17 * n_rows * B * 4
        n_ops = int((cols >= 0).any(1).sum()) * B * SEMI_REDUCE_MULS
        r = compare(
            f"bits_matvec_semi K={K} rows={n_rows} ({int((cols >= 0).any(1).sum())} live)",
            lambda: fk.bits_matvec_semi(vals_p, cols, F, SCALAR),
            lambda: fk.bits_matvec_semi_plain(vals_p, cols, F, SCALAR), bound(n_bytes, n_ops),
            library=lambda: torch.bmm(Ff, xf))
        for k in ("ms", "plain_ms", "library_ms"):
            tot[k] += r[k]
        tot["bytes"] += n_bytes
        tot["ops"] += n_ops
        del xf, Ff
    b_ms, b_by = max(bound(tot["bytes"], 0), bound(0, tot["ops"]))
    results["bits_matvec_semi"] = {"max_abs_err": 0, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                                   "bound_ms": b_ms, "bound_by": b_by,
                                   "library_ms": tot["library_ms"]}
    del vals_p, check
    # mulcmp: N = 8 padded rows × B
    N = 8 * B
    (a, b, c), want = mulcmp_operands(N, dev)
    got = (fk.mulcmp(a, b, c, SCALAR)[: len(want)] != 0).cpu().numpy()
    assert (got == want).all(), "mulcmp corner/product columns wrong"
    results["mulcmp"] = compare(
        "mulcmp", lambda: fk.mulcmp(a, b, c, SCALAR),
        lambda: fk.mulcmp_plain(a, b, c, SCALAR), bound(N * 4 * (3 * 17 + 1), N * MULCMP_MULS),
        plain_reps=2)
    torch.cuda.empty_cache()
    return results


def field_kernels(dev, bound):
    """chain and mul at the config-1 path's shapes, against their plain
    versions and Python ints."""
    p = SCALAR.p
    results = {}
    rnd = random.Random(SEED)
    N = B_FIELD
    x0v = [rnd.randrange(p) for _ in range(N)]
    av = [0, 1, p - 1] + [rnd.randrange(p) for _ in range(N - 3)]
    bv = [p - 1, 0, 1] + [rnd.randrange(p) for _ in range(N - 3)]
    x0, a, b = (canonical_lm(v, dev) for v in (x0v, av, bv))
    ext = torch.cat([b, a])  # the config-1 pattern's ext 0 = b, ext 1 = a
    descs = (("fmul", "prev", 0), ("fadd", "prev", 1), ("fmul", "prev", "prev"))
    out = fk.chain(x0, ext, descs, 30, SCALAR)
    for i in (0, 1, 2, 3, N - 1):
        x = x0v[i]
        for r in range(30):
            m = x * bv[i] % p
            s = (m + av[i]) % p
            x = s * s % p
            got = [col_int(out[(3 * r + j) * 16 : (3 * r + j + 1) * 16], i) for j in range(3)]
            assert got == [m, s, x], ("chain", i, r)
    n_bytes = (16 + 32 + 90 * 16) * 4 * N
    results["chain"] = compare(
        "chain", lambda: fk.chain(x0, ext, descs, 30, SCALAR),
        lambda: fk.chain_plain(x0, ext, descs, 30, SCALAR),
        bound(n_bytes, N * 60 * MODMUL_MULS), plain_reps=2)
    del out
    rng = np.random.default_rng(SEED)
    top = p >> 240
    for n in (N, MUL_WIDE_N, CHAIN_ROWS_N):
        # random canonical operands (top limb below p's), then the corner
        # pairs of 0, 1 and p − 1 in the first 9 columns
        ops = []
        for k in range(2):
            x = rng.integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
            x[15] = rng.integers(0, top, size=n, dtype=np.uint32)
            for i in range(9):
                x[:, i] = limbs([0, 1, p - 1][i // 3 if k else i % 3], 16)
            ops.append(from_numpy_u32(x, dev))
        ma, mb = ops
        got = fk.mul(ma, mb, SCALAR)
        for i in list(range(9)) + [n // 2, n - 1]:
            assert col_int(got, i) == col_int(ma, i) * col_int(mb, i) % p, ("mul", n, i)
        r = compare(f"mul N={n}", lambda: fk.mul(ma, mb, SCALAR),
                    lambda: fk.mul_plain(ma, mb, SCALAR),
                    bound(3 * 16 * 4 * n, n * MODMUL_MULS), plain_reps=2)
        if n == N:
            results["mul"] = r
        del ma, mb, got
    torch.cuda.empty_cache()
    return results


def sha256_path(dev, card):
    t0 = time.time()
    nb = NativeBuilder()
    bits = [nb.alloc_bit() for _ in range(512)]
    nb.sha256_compression(bits, nb.sha256_iv())
    template, tape = nb.finish()
    prog = WitnessProgram(tape)
    R, S = template.num_constraints, prog.num_slots
    assert (R, S) == (26352, 26327), (R, S)
    print(f"[synth] sha256 template: {R} rows, {S} slots, {len(prog.stages)} stages "
          f"in {time.time() - t0:.2f} s (native build included)")
    return template, prog


def sha256_step(dev, card, template, prog):
    R = template.num_constraints
    Bw = B // 32
    rng = np.random.default_rng(SEED)
    free_np = rng.integers(0, 1 << 32, size=(N_CHUNKS, Bw, 512), dtype=np.uint64).astype(np.uint32)
    free = from_numpy_u32(free_np, dev)
    t0 = time.time()
    step = build_packed_production_step(prog, template, B, device=dev)
    print(f"[step] sha256 built in {time.time() - t0:.2f} s")
    step(free)  # warm-up
    verdict, launches = path_run(step, free)
    print(f"[step] sha256 verdict {verdict} launches {launches}")
    assert verdict == (0, 0xFFFFFFFF), verdict
    assert all(launches[k] > 0 for k in ("bitplane_eq", "bits_matvec_semi", "mulcmp")), launches

    gen = build_packed_chunked_witness(prog, device=dev)
    vals0 = gen(free)[0]
    cpu_words = prog.build_packed("cpu")(torch.from_numpy(free_np[0, :16].view(np.int32)))
    assert torch.equal(vals0[:16].cpu(), cpu_words), "chunk 0 words differ from the CPU evaluator"
    check = build_templated_check(template, B, device=dev)
    assert tuple(int(v) for v in check.verdict(vals0)) == (0, 0xFFFFFFFF)
    vbad = vals0.clone()
    vbad[Bw // 2, 600] ^= 1 << 7
    nbad, fbad = (int(v) for v in check.verdict(vbad))
    assert nbad > 0 and fbad // R == 32 * (Bw // 2) + 7, (nbad, fbad)
    print(f"[probe] sha256 chunk-0 words match the CPU evaluator; corruption at "
          f"vp[{Bw // 2}, 600] bit 7 found: n_bad {nbad}, instance {fbad // R}")
    del vals0, vbad, gen, check

    perf_step("sha256", step, free, B, R, card, 5)
    return launches


def field_synth():
    t0 = time.time()
    built = {}
    for name, nonzero, want_rs, want_cls in (
        ("config1", False, (220, 221), (128, 30, 60, 2, 0)),
        ("variant", True, (221, 222), (128, 30, 61, 2, 0)),
    ):
        template, prog = config1(nonzero)
        rs = (template.num_constraints, prog.num_slots)
        cls = _classify_mixed_rows(template, prog.field_slots)
        counts = tuple(len(cls[k]) for k in ("bool_u32", "lin", "mul", "pow2", "rest"))
        assert rs == want_rs and counts == want_cls, (name, rs, counts)
        print(f"[synth] {name}: {rs[0]} rows, {rs[1]} slots, {len(prog.stages)} stages, "
              f"row classes bool/lin/mul/pow2/rest {'/'.join(map(str, counts))}")
        built[name] = (template, prog)
    print(f"[synth] field templates in {time.time() - t0:.2f} s")
    return built


def field_steps(dev, card, built):
    p = SCALAR.p
    free_np = np.random.default_rng(5).integers(0, 2, size=(N_CHUNKS, B_FIELD, 128)).astype(np.uint32)
    free = from_numpy_u32(free_np, dev)
    launches = {}
    steps = {}
    for name in ("config1", "variant"):
        template, prog = built[name]
        step = steps[name] = build_production_step(prog, template, B_FIELD, device=dev)
        step(free)  # warm-up
        verdict, counts = path_run(step, free)
        launches[name] = counts
        print(f"[step] {name} verdict {verdict} launches {counts}")
        assert verdict == (0, 0xFFFFFFFF), verdict
        if name == "config1":
            assert counts["chain"] == N_CHUNKS and counts["mulcmp"] == N_CHUNKS, counts
        else:
            assert counts["mul"] == 60 * N_CHUNKS and counts["mulcmp"] == N_CHUNKS, counts

    # probes on config 1's chunk 0
    template, prog = built["config1"]
    R = template.num_constraints
    ev = prog.build(dev)
    vals0, fl0 = ev(free[0])
    cpu_vals, cpu_fl = prog.build("cpu")(torch.from_numpy(free_np[0, :16].view(np.int32)))
    assert torch.equal(vals0[:16].cpu(), cpu_vals) and torch.equal(fl0[:16].cpu(), cpu_fl), \
        "config-1 chunk 0 differs from the CPU evaluator"
    spec = _detect_linear_chain([st for st in prog.stages if st.opcode in SCAN_OPS])
    rows = spec["out_rows"]
    for i in (0, 1, B_FIELD // 2, B_FIELD - 1):
        a = sum(int(free_np[0, i, k]) << k for k in range(64))
        b = sum(int(free_np[0, i, 64 + k]) << k for k in range(64))
        x = a
        for r in range(30):
            m = x * b % p
            s = (m + a) % p
            x = s * s % p
            got = [col_int(fl0[i, int(rows[3 * r + j])].reshape(16, 1), 0) for j in range(3)]
            assert got == [m, s, x], ("chain probe", i, r)
    check = build_templated_check(template, B_FIELD, "mixed", field_slots=prog.field_slots, device=dev)
    assert tuple(int(v) for v in check.verdict(vals0, fl0)) == (0, 0xFFFFFFFF)
    fbad = fl0.clone()
    mid = int(rows[45])
    fbad[B_FIELD // 2, mid, 0] ^= 1
    nbad, first = (int(v) for v in check.verdict(vals0, fbad))
    assert nbad > 0 and first // R == B_FIELD // 2, (nbad, first)
    print(f"[probe] config1 chunk-0 vals and flimbs match the CPU evaluator for 16 instances; "
          f"the chain of 4 instances matches x <- ((x*b + a) mod p)^2 mod p; a flipped bit of "
          f"field row {mid} at instance {B_FIELD // 2} found: n_bad {nbad}, instance {first // R}")
    del vals0, fl0, fbad

    # per-chunk witness and check seconds (and the check's split by row
    # class), each step's time and peak memory
    reps = 5
    vals_p, fl_p = ev.slot_major(free[0])
    assert int(check.verdict_slot_major(vals_p, fl_p)[0]) == 0
    t_wit = wall_s(lambda: ev.slot_major(free[0]), reps)
    t_chk = wall_s(lambda: check.verdict_slot_major(vals_p, fl_p), reps)
    split = ", ".join(f"{c} rows {wall_s(lambda: check.class_bad(c, vals_p, fl_p), reps):.5f} s"
                      for c, rows in zip(ROW_CLASSES, check.rows) if rows.numel())
    print(f"[perf] config1 per chunk of {B_FIELD}: witness {t_wit:.5f} s, check {t_chk:.5f} s "
          f"({split}), on {card}")
    del vals_p, fl_p
    for name in ("config1", "variant"):
        perf_step(name, steps[name], free, B_FIELD, built[name][0].num_constraints, card,
                  reps if name == "config1" else 2)
    return launches


def limbs_matvec_at(name, zt, cols, F, forms, bound, exact_ints=True):
    """limbs_matvec on one bucket, each output form against its plain
    version, and (exact_ints) two live (row, instance) columns against
    Python ints; the library yardstick is torch.matmul in float64 over the
    gathered digits' 32 sums only (exact: every sum is below 2^53). At the
    K = 2,064 bound the reduction's carries wrap 32 bits as the TPU's do,
    so there the plain version alone is the reference."""
    p = SCALAR.p
    n_rows, K = cols.shape
    Bm = zt.shape[2]
    xf = fk._gather_digits(zt, cols).double()
    Ff = F.double()
    live = torch.nonzero((cols >= 0).any(1)).flatten().tolist()
    out = None
    for form in forms:
        got = fk.limbs_matvec(zt, cols, F, SCALAR, form)
        for r, b in ((live[0], 0), (live[-1], Bm - 1)) if exact_ints else ():
            sums = torch.matmul(Ff[r], xf[r, :, b]).to(torch.int64).tolist()
            exact = sum(int(v) << (8 * d) for d, v in enumerate(sums))
            val = col_int(got[:, r].contiguous(), b)
            assert val % p == exact % p and (form == "semi" or val < p), ("limbs_matvec", name, form, r, b)
        out_rows = 17 if form == "semi" else 16
        n_bytes = gathered_bytes(cols, 16 * Bm * 4) + F.numel() + out_rows * n_rows * Bm * 4
        n_ops = Bm * (int((cols >= 0).sum()) * ENTRY_MULS + len(live) * ROW_REDUCE_MULS)
        r = compare(f"limbs_matvec {form} {name} rows={n_rows} ({len(live)} live) K={K} B={Bm}",
                    lambda: fk.limbs_matvec(zt, cols, F, SCALAR, form),
                    lambda: fk.limbs_matvec_plain(zt, cols, F, SCALAR, form), bound(n_bytes, n_ops),
                    reps=10, plain_reps=2, library=lambda: torch.matmul(Ff, xf))
        out = out or r
        del got
    del xf, Ff
    torch.cuda.empty_cache()
    return out


def limbs_kernels(dev, bound, sha_limbs, config1_fold):
    """limbs_matvec at its paths' real buckets (config 1's a-bucket, semi
    and canonical; the sha256 limbs check's widest a-bucket, semi) on
    random limbs, and at the K = 2,064 bound with every digit and fold
    entry 255 (both forms); mul_digits and reduce_digits at the
    Satisfier's shapes, corner columns first, against their plain
    versions and Python ints; then mulcmp at the limbs paths' shapes."""
    p = SCALAR.p
    rng = np.random.default_rng(SEED + 2)
    results = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    for name, check, Bm, forms in (("config1 a-bucket", config1_fold, B_FIELD, ("semi", "canonical")),
                                   ("sha256 widest a-bucket", sha_limbs, B_SHA_LIMBS, ("semi",))):
        cols, F = max(check.mats["a"], key=lambda t: t[0].shape[1])
        zt = torch.randint(0, 1 << 16, (check.S_t, 16, Bm), generator=gen, device=dev, dtype=torch.int32)
        r = limbs_matvec_at(name, zt, cols, F, forms, bound)
        results.setdefault("limbs_matvec", r)  # the line's numbers: config 1's a-bucket, semi
        del zt
    K, n_rows = MAX_FUSED_LIMBS_K, 8
    zt = torch.full((2, 16, B_SHA_LIMBS), 0xFFFF, dtype=torch.int32, device=dev)
    cols = torch.ones((n_rows, K), dtype=torch.int32, device=dev)
    cols[n_rows - 3 :] = -1  # a segment's padding rows
    F = torch.full((n_rows, 32, 32 * K), 255, dtype=torch.uint8, device=dev)
    limbs_matvec_at("all 255", zt, cols, F, ("semi", "canonical"), bound, exact_ints=False)
    del zt, cols, F
    # mul_digits: random canonical operands, the corner pairs of 0, 1 and
    # p − 1 in the first 9 columns
    n = MUL_DIGITS_N
    rnd = random.Random(SEED + 3)
    av = [0, 1, p - 1] * 3 + [rnd.randrange(p) for _ in range(64)]
    bv = [v for v in (0, 1, p - 1) for _ in range(3)] + [rnd.randrange(p) for _ in range(64)]
    top = p >> 240
    ops = []
    for vs in (av, bv):
        x = rng.integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
        x[15] = rng.integers(0, top, size=n, dtype=np.uint32)
        x[:, : len(vs)] = np.asarray([limbs(v, 16) for v in vs], np.uint32).T
        ops.append(from_numpy_u32(x, dev))
    ma, mb = ops
    got = fk.mul_digits(ma, mb, SCALAR)
    for i in range(len(av)):
        assert sum(int(d) << (8 * j) for j, d in enumerate(to_u32(got[:, i]).tolist())) == av[i] * bv[i] % p
    results["mul_digits"] = compare(
        f"mul_digits N={n}", lambda: fk.mul_digits(ma, mb, SCALAR), lambda: fk.mul_digits_plain(ma, mb, SCALAR),
        bound((2 * 16 + 32) * 4 * n, n * MODMUL_MULS), plain_reps=2)
    del ma, mb, got, ops
    # reduce_digits: digit sums of 2^24 − 1, 0 and 1 first, then random
    # sums below 2^24
    n = CHAIN_ROWS_N
    dn = rng.integers(0, 1 << 24, size=(32, n), dtype=np.uint32)
    dn[:, 0], dn[:, 1], dn[:, 2] = (1 << 24) - 1, 0, 1
    d = from_numpy_u32(dn, dev)
    got = fk.reduce_digits(d, SCALAR)
    for i in (0, 1, 2, 3, n - 1):
        assert col_int(got, i) == sum(int(dn[j, i]) << (8 * j) for j in range(32)) % p, ("reduce", i)
    results["reduce_digits"] = compare(
        f"reduce_digits N={n}", lambda: fk.reduce_digits(d, SCALAR), lambda: fk.reduce_digits_plain(d, SCALAR),
        bound((32 + 16) * 4 * n, n * REDUCE_MULS), plain_reps=2)
    del d, got
    torch.cuda.empty_cache()
    for rows, batch in ((CONFIG1_TRIVIAL_ROWS, B_FIELD), (CONFIG1_FOLD_ROWS, B_FIELD),
                        (SHA256_LIMBS_ROWS, B_SHA_LIMBS)):
        mulcmp_at(rows * batch, dev)
        torch.cuda.empty_cache()
    return results


def config1_limbs_step(dev, card, built):
    """Config 1 in the limbs form on the mixed step's free bits, then the
    TemplatedSatisfier probes: a non-bit field element in a bit slot (the
    mutation the mixed form cannot represent) and a flipped limb of a pack
    row's field slot, each found at its instance."""
    p = SCALAR.p
    template, prog = built["config1"]
    R = template.num_constraints
    free_np = np.random.default_rng(5).integers(0, 2, size=(N_CHUNKS, B_FIELD, 128)).astype(np.uint32)
    free = from_numpy_u32(free_np, dev)
    step = build_production_step(prog, template, B_FIELD, device=dev, witness_form="limbs")
    step(free)  # warm-up
    verdict, counts = path_run(step, free)
    print(f"[step] config1 limbs verdict {verdict} launches {counts}")
    assert verdict == (0, 0xFFFFFFFF), verdict
    assert (counts["limbs_matvec"], counts["mulcmp"], counts["chain"]) == (
        3 * N_CHUNKS, 2 * N_CHUNKS, N_CHUNKS), counts

    sat = TemplatedSatisfier(template, B_FIELD, device=dev)
    # the limbs check's mulcmp launches run at the shapes compared above
    assert (sat.check.n_triv, sat.check.fold.Rtp) == (CONFIG1_TRIVIAL_ROWS, CONFIG1_FOLD_ROWS)
    z = prog.z_template_limbs(*prog.build(dev)(free[0]))
    assert sat.is_satisfied(z)
    slot = prog.free_slots[int(np.random.default_rng(SEED).integers(0, 128))]
    bad = z.clone()
    bad[B_FIELD // 2, slot] = canonical_lm([random.Random(SEED).randrange(p)], dev)[:, 0]
    name = sat.which_is_unsatisfied(bad)
    assert name.startswith(f"instance {B_FIELD // 2}: "), name
    pack = sorted(prog.field_rows, key=prog.field_rows.get)[0]  # the first pack output
    flip = z.clone()
    flip[B_FIELD // 4, pack, 2] ^= 1
    name2 = sat.which_is_unsatisfied(flip)
    assert name2.startswith(f"instance {B_FIELD // 4}: "), name2
    print(f"[probe] config1 limbs: a random field element in bit slot {slot} at instance "
          f"{B_FIELD // 2} found ({name}); a flipped limb of pack slot {pack} found ({name2})")
    del z, bad, flip, sat
    perf_step("config1 limbs", step, free, B_FIELD, R, card, 5)
    return counts


def sha256_limbs_step(dev, card, template, prog):
    """The sha256 compression in the limbs form (the fused route, 17 ELL
    buckets) at 4 × 1,024; chunk 0's verdict against the packed check on
    the same instances, clean and with one intermediate bit flipped; a
    non-bit value in a message-bit slot found at its instance. Then the step at the batches
    of B_SHA_LIMBS_BIG in turn while the peak extrapolated from the runs
    before stays under PEAK_GIB: each one's verdict, time and peak."""
    p = SCALAR.p
    R = template.num_constraints
    Bl = B_SHA_LIMBS
    rng = np.random.default_rng(SEED + 4)
    free_np = rng.integers(0, 2, size=(N_CHUNKS, Bl, 512)).astype(np.uint32)
    free = from_numpy_u32(free_np, dev)
    t0 = time.time()
    step = build_production_step(prog, template, Bl, device=dev, witness_form="limbs")
    print(f"[step] sha256 limbs built in {time.time() - t0:.2f} s (fold tables included)")
    step(free)  # warm-up
    verdict, counts = path_run(step, free)
    print(f"[step] sha256 limbs verdict {verdict} launches {counts}")
    assert verdict == (0, 0xFFFFFFFF), verdict
    assert counts["limbs_matvec"] == 17 * N_CHUNKS and counts["mulcmp"] == N_CHUNKS, counts

    check = build_templated_check(template, Bl, "limbs", device=dev)
    assert check.Rtp == SHA256_LIMBS_ROWS, check.Rtp  # mulcmp's shape, compared above
    packed = build_templated_check(template, Bl, device=dev)
    z = prog.z_template_limbs(*prog.build(dev)(free[0]))
    words = prog.build_packed(dev)(pack_bits(free[0]))
    slot, inst = 9000, Bl // 3  # an intermediate slot: its bit flipped in both forms
    zf, wf = z.clone(), words.clone()
    zf[inst, slot, 0] ^= 1
    wf[inst // 32, slot] ^= 1 << (inst % 32)
    for zz, ww in ((z, words), (zf, wf)):
        got = tuple(int(v) for v in check.verdict(zz))
        want = tuple(int(v) for v in packed.verdict(ww))
        assert got == want, (got, want)
    assert got[0] > 0 and got[1] // R == inst, got
    bad = z.clone()
    msg = prog.free_slots[100]
    bad[Bl // 2, msg] = canonical_lm([random.Random(SEED + 1).randrange(p)], dev)[:, 0]
    nb, first = (int(v) for v in check.verdict(bad))
    assert nb > 0 and first // R == Bl // 2, (nb, first)
    print(f"[probe] sha256 limbs chunk 0 equals the packed check clean and with slot {slot} flipped at "
          f"instance {inst} ({got}); a random field element in message bit {msg} at instance {Bl // 2} "
          f"found: n_bad {nb}, first row {first % R}")
    del check, packed, z, words, zf, wf, bad
    torch.cuda.empty_cache()
    peak = perf_step("sha256 limbs", step, free, Bl, R, card, 3)
    assert peak < PEAK_GIB, f"peak memory {peak:.2f} GiB"
    del step, free
    torch.cuda.empty_cache()

    # the larger batches in turn while the peak, extrapolated from the
    # runs so far (linearly from one, along the last two after), stays
    # under PEAK_GIB
    peaks = [(Bl, peak)]
    for Bb in B_SHA_LIMBS_BIG:
        (b1, p1), (b2, p2) = peaks[-2] if len(peaks) > 1 else (0, 0.0), peaks[-1]
        est = p2 + (p2 - p1) / (b2 - b1) * (Bb - b2)
        if est >= PEAK_GIB:
            print(f"[perf] sha256 limbs at {Bb}: peak estimated {est:.2f} GiB, not run")
            break
        free = from_numpy_u32(rng.integers(0, 2, size=(N_CHUNKS, Bb, 512)).astype(np.uint32), dev)
        step = build_production_step(prog, template, Bb, device=dev, witness_form="limbs")
        step(free)  # warm-up
        verdict, big_counts = path_run(step, free)
        print(f"[step] sha256 limbs at {N_CHUNKS}x{Bb} verdict {verdict} launches {big_counts}")
        assert verdict == (0, 0xFFFFFFFF), verdict
        peaks.append((Bb, perf_step(f"sha256 limbs {Bb}", step, free, Bb, R, card, 2)))
        assert peaks[-1][1] < PEAK_GIB, f"peak memory {peaks[-1][1]:.2f} GiB at {Bb} (estimated {est:.2f})"
        del step, free
        torch.cuda.empty_cache()
    return counts


def op_rate_probe(bound):
    """The op-rate probe on the card: per class, the kernel against its
    plain version (integer classes bit-exact at PROBE_K rounds, f32 ones
    within a relative 10^-5 at 4 rounds, where they stay finite) and its
    rate, R·K·N rounds over the kernel's time."""
    rng = np.random.default_rng(SEED + 6)
    x_np = rng.integers(1, 100, size=(PROBE_R, PROBE_N)).astype(np.int32)
    rates = {}
    for op in op_rate.OPS:
        flt = op in op_rate.FLOAT_OPS
        x = torch.from_numpy(x_np).to(DEVICE)
        if flt:
            x = x.float()
            got = op_rate.op_rate(x, op, 4)
            torch.testing.assert_close(got, op_rate.op_rate_plain(x, op, 4), rtol=1e-5, atol=0)
            err = 0.0
        else:
            err = max_abs_err(op_rate.op_rate(x, op, PROBE_K), op_rate.op_rate_plain(x, op, PROBE_K))
            assert err == 0, f"op_rate {op} disagrees with its plain version"
        ms = cuda_ms(lambda: op_rate.op_rate(x, op, PROBE_K), 10)
        plain_ms = cuda_ms(lambda: op_rate.op_rate_plain(x, op, PROBE_K), 1)
        rounds = PROBE_R * PROBE_K * PROBE_N
        # rounds a clock an SM: 128 f32 lanes; 16 conversions, two a round;
        # the 64 integer lanes of `bound` for the rest
        lanes = {"f32_mul": 128, "f32_fma": 128, "cvt_u32_f32": 8}.get(op, 64)
        b_ms, b_by = bound(4 * (PROBE_R + 1) * PROBE_N, rounds * 64 / lanes)
        rates[op] = {"gops": rounds / ms / 1e6, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "max_abs_err": err}
        del x
    print(f"[probe] op-rate R={PROBE_R} K={PROBE_K} N={PROBE_N}: " + ", ".join(
        f"{op} {v['gops']:.1f} G op/s" for op, v in rates.items()))
    print("[probe] op-rate detail " + json.dumps(rates))


def python_int_first_bad(template, z_limbs, slot):
    """The least row referencing `slot` that fails A·z · B·z = C·z over the
    Python ints (z_limbs: int64[S, 16] limbs), and how many rows reference
    it."""
    p = template.field.p
    rows = sorted({int(r) for m in "abc" for r in np.asarray(getattr(template, m).rows)[
        np.asarray(getattr(template, m).cols) == slot]})
    sums = {}
    for m in "abc":
        mat = getattr(template, m)
        sel = np.isin(np.asarray(mat.rows), rows)
        s = dict.fromkeys(rows, 0)
        for r, c, cid in zip(np.asarray(mat.rows)[sel], np.asarray(mat.cols)[sel], np.asarray(mat.coeff_ids)[sel]):
            s[int(r)] = (s[int(r)] + int(template.coeff_table[cid]) * limb_int(z_limbs[int(c)])) % p
        sums[m] = s
    bad = [r for r in rows if (sums["a"][r] * sums["b"][r] - sums["c"][r]) % p]
    return (bad[0] if bad else None), len(rows)


def satisfier_chain(dev, card):
    """The Satisfier of a 16-block sha256 chain at batch 1 (the non-fused
    limbs route): z from instance 0 of the chain's evaluator, satisfied;
    then one bit slot of block 9 set to a random field element and named
    as the Python-int evaluation names it."""
    p = SCALAR.p
    t0 = time.time()
    nb = NativeBuilder()
    state = nb.sha256_iv()
    for _ in range(CHAIN_BLOCKS):
        state = nb.sha256_compression([nb.alloc_bit() for _ in range(512)], state)
    template, tape = nb.finish()
    prog = WitnessProgram(tape)
    R, S = template.num_constraints, prog.num_slots
    sat = Satisfier(template, device=dev)
    if CHAIN_BLOCKS == 16:  # reduce_digits' and mul's N, compared above
        assert (R, S, sat._check.Rtp) == (426912, 426497, CHAIN_ROWS_N), (R, S, sat._check.Rtp)
    print(f"[synth] sha256 chain of {CHAIN_BLOCKS}: {R} rows, {S} slots; Satisfier built in "
          f"{time.time() - t0:.2f} s (native build included)")
    free = from_numpy_u32(np.random.default_rng(SEED + 5).integers(0, 2, size=(1, 512 * CHAIN_BLOCKS))
                          .astype(np.uint32), dev)
    z = prog.z_template_limbs(*prog.build(dev)(free))[0]
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    ok = sat.is_satisfied(z)
    counts = fk.launch_counts()
    print(f"[step] satisfier chain is_satisfied {ok} launches {counts}")
    assert ok and (counts["mul_digits"], counts["reduce_digits"], counts["mul"]) == (3, 3, 1), counts
    block = min(9, CHAIN_BLOCKS - 1)
    slot = prog.free_slots[512 * block + int(np.random.default_rng(SEED).integers(0, 512))]
    bad = z.clone()
    bad[slot] = canonical_lm([random.Random(SEED + 2).randrange(p)], dev)[:, 0]
    name = sat.which_is_unsatisfied(bad)
    row, n_ref = python_int_first_bad(template, to_u32(bad).cpu().numpy(), slot)
    assert row is not None and name == f"constraint #{row}", (name, row)
    print(f"[probe] satisfier chain: bit slot {slot} of block {block} set to a random field element; "
          f"which_is_unsatisfied names {name!r}, the least of the {n_ref} rows on the slot that fails "
          f"over the Python ints")
    t_chk = wall_s(lambda: sat.is_satisfied(z), 3)
    print(f"[perf] satisfier chain check {t_chk:.4f} s for {R} rows, on {card}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: nothing runs on the CPU", file=sys.stderr)
        return 1
    card = card_line()
    print(f"[card] {card}")
    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    max_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} device {name}; "
          f"max SM clock {max_mhz:.0f} MHz, SM clock now {nvidia_smi('clocks.sm')}")
    bound = Bound(max_mhz)

    t0 = time.time()
    lib = cuda_lib.load_kernels()
    ptxas = [f"{src}: " + " | ".join(ln.strip() for ln in log.splitlines()
                                     if "registers" in ln or "spill" in ln)
             for src, log in sorted(lib.build_log.items())]
    print(f"[build] kernels built in {time.time() - t0:.1f} s; ptxas: {' || '.join(ptxas)}")

    template, prog = sha256_path(dev, card)
    built = field_synth()
    t0 = time.time()
    sha_limbs = build_templated_check(template, B_SHA_LIMBS, "limbs", device=dev)
    config1_fold = build_templated_check(built["config1"][0], B_FIELD, "limbs", device=dev).fold
    print(f"[step] limbs checks of sha256 at {B_SHA_LIMBS} and config 1 at {B_FIELD} built in "
          f"{time.time() - t0:.2f} s (fold tables included)")
    results = sha256_kernels(dev, bound, template, prog)
    results.update(field_kernels(dev, bound))
    results.update(limbs_kernels(dev, bound, sha_limbs, config1_fold))
    del sha_limbs, config1_fold  # the steps' peaks count only their own tables
    op_rate_probe(bound)
    torch.cuda.empty_cache()
    launches = {"sha256": sha256_step(dev, card, template, prog)}
    torch.cuda.empty_cache()
    launches.update(field_steps(dev, card, built))
    torch.cuda.empty_cache()
    launches["config1_limbs"] = config1_limbs_step(dev, card, built)
    torch.cuda.empty_cache()
    launches["sha256_limbs"] = sha256_limbs_step(dev, card, template, prog)
    torch.cuda.empty_cache()
    launches["satisfier"] = satisfier_chain(dev, card)

    kernels = []
    for k in fk.KERNELS:
        by_path = {path: counts[k] for path, counts in launches.items() if counts[k]}
        kernels.append({
            "name": k, "route": "cuda", "source": KERNEL_INFO[k][0],
            "replaces": KERNEL_INFO[k][1], "launches": sum(by_path.values()),
            "launches_by_path": by_path, **{key: results[k][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        })
        assert by_path, f"{k} was not launched on any path"
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
