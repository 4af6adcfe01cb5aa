#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's two paths once on one CUDA card, and check
their five kernels against their plain versions.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (one line each, or a few):

  * the card's name and power limit; the kernel build (all nvcc processes
    at once) and ptxas's register and spill report;
  * native synthesis of one sha256 compression (26,352 rows, 26,327
    slots), of config 1 (pack → (mul, add, square) × 30: 220 rows, 221
    slots) and of its variant with num_assert_nonzero (221 rows, 222
    slots), with the mixed row classes of both;
  * each kernel against its plain PyTorch version at its path's shapes
    (bit-exact), with the kernel's, the plain version's and, where one
    PyTorch call computes the same work, that call's times, and the
    least time the card could take (``bound``, below);
  * the packed sha256 step at 4 chunks of 32,768 instances, the config-1
    step and the variant's step at 4 chunks of 8,192 instances: clean
    verdicts, each path's kernels launched (counts reset just before the
    path's run and read just after), words equal to the CPU evaluator's,
    planted corruptions found at their instance, a Python-int recurrence
    for the chain;
  * each step's time, rate and peak memory; the config-1 witness and
    check seconds per chunk and the check's split by row class.

``bound``: the larger of the bytes a kernel's function must move (each
input read once, each output written once) over 3.35 TB/s and the 32-bit
integer products that function needs on these inputs (not those of the
kernel's own design; see ``modmul_products``) over 64 lanes × 132 SMs ×
the card's maximum SM clock. The line before last names the card again;
the last line is {"ok": true, "device": {...}}.
Any failed phase raises and the script exits non-zero. Without a CUDA
device it exits 1 at once."""

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
    WitnessProgram,
    build_packed_chunked_witness,
    build_packed_production_step,
    build_production_step,
    build_templated_check,
)
from bellpepper_tpu_torch.backend import cuda_lib, field_kernels as fk
from bellpepper_tpu_torch.backend.layout import _classify_mixed_rows
from bellpepper_tpu_torch.backend.matvec import ROW_CLASSES
from bellpepper_tpu_torch.backend.words import from_numpy_u32, to_u32
from bellpepper_tpu_torch.compile.witness_program import SCAN_OPS, _detect_linear_chain

B = 32768  # sha256 instances per chunk
N_CHUNKS = 4
B_FIELD = 8192  # config-1 instances per chunk (benchmarks/configs_1_2_3.py:123)
MUL_WIDE_N = 1 << 20  # mul's second shape: one launch wide enough to fill the card
SEED = 0x5962BE3D
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12
INT32_LANES = 64 * 132  # per clock: 64 INT32 lanes on each of the 132 SMs
KERNEL_INFO = {
    "bitplane_eq": ("bellpepper_tpu_torch/csrc/bitplane_eq.cu",
                    "bellpepper_tpu/backend/field_pallas.py:489"),
    "bits_matvec_semi": ("bellpepper_tpu_torch/csrc/bits_matvec_semi.cu",
                         "bellpepper_tpu/backend/field_pallas.py:828"),
    "mulcmp": ("bellpepper_tpu_torch/csrc/mulcmp.cu",
               "bellpepper_tpu/backend/field_pallas.py:1009"),
    "chain": ("bellpepper_tpu_torch/csrc/chain.cu",
              "bellpepper_tpu/backend/field_pallas.py:407"),
    "mul": ("bellpepper_tpu_torch/csrc/mul16.cu",
            "bellpepper_tpu/backend/field_pallas.py:704"),
}


def modmul_products(words_a: int, words_b: int, words_p: int = 8) -> int:
    """32-bit multiplies that a·b mod p needs at the least: a schoolbook
    product of 32-bit words and a Montgomery reduction of it (one quotient
    word and words_p products a word reduced), each 32×32 → 64-bit product
    counted as two 32-bit multiplies (its low and high words). The
    operations side of `bound` counts only products: the adds and logic
    ops fuse around them, so their count gives a time the card cannot
    beat whatever limb size a kernel chooses."""
    n_reduce = words_a + words_b - words_p
    return 2 * (words_a * words_b + n_reduce * (1 + words_p))


# Products per element. A canonical modmul (chain's fmul steps, mul) takes
# two 8-word residues; mulcmp's a·b − c takes 17-limb semi values below
# 2^265, 9 words each. bits_matvec_semi multiplies 0/1 bits by digits (a
# select, no product) and folds 4 × 32 digit sums by constants in its semi
# reduction. bitplane_eq does logic ops only.
MODMUL_MULS = modmul_products(8, 8)
MULCMP_MULS = modmul_products(9, 9)
SEMI_REDUCE_MULS = 4 * 32


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


def col_int(t: torch.Tensor, i: int) -> int:
    v = to_u32(t[:, i]).tolist()
    return sum(x << (16 * l) for l, x in enumerate(v))


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


def sha256_kernels(dev, bound):
    """bitplane_eq, bits_matvec_semi and mulcmp at the sha256 step's shapes."""
    rng = np.random.default_rng(SEED)
    Bw = B // 32
    results = {}
    # bitplane_eq: the 25 MultiEq rows, P = 256, m_a = 7, m_c = 1, W = 25·Bw;
    # every third column made equal so both verdicts occur.
    P, m_a, m_c, W = 256, 7, 1, 25 * Bw
    A = rng.integers(0, 1 << 32, size=(m_a * P, W), dtype=np.uint64).astype(np.uint32)
    C = rng.integers(0, 1 << 32, size=(m_c * P, W), dtype=np.uint64).astype(np.uint32)
    A[P:, ::3] = 0
    C[:, ::3] = A[:P, ::3]
    A, C = from_numpy_u32(A, dev), from_numpy_u32(C, dev)
    bad = fk.bitplane_eq(A, C, P, m_a, m_c)
    assert not bad[::3].any() and bad[1::3].all()
    results["bitplane_eq"] = compare(
        "bitplane_eq", lambda: fk.bitplane_eq(A, C, P, m_a, m_c),
        lambda: fk.bitplane_eq_plain(A, C, P, m_a, m_c),
        bound((m_a + m_c) * P * W * 4 + W * 4, 0))
    # bits_matvec_semi: the big row's three ELL buckets, (K, n_rows) =
    # (512, 8), (1, 8), (256, 8), at the chunk's B. The library yardstick
    # is torch.bmm in float32 over the 32 digit sums only (no reduction).
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "ops": 0}
    for K in (512, 1, 256):
        x = from_numpy_u32(rng.integers(0, 2, size=(8, K, B)).astype(np.uint32), dev)
        F = from_numpy_u32(rng.integers(0, 256, size=(32, 8, K)).astype(np.uint32), dev)
        xf, Ff = x.float(), F.permute(1, 0, 2).float().contiguous()
        n_bytes = (8 * K * B + 32 * 8 * K + 17 * 8 * B) * 4
        n_ops = 8 * B * SEMI_REDUCE_MULS
        r = compare(
            f"bits_matvec_semi K={K}", lambda: fk.bits_matvec_semi(x, F, SCALAR),
            lambda: fk.bits_matvec_semi_plain(x, F, SCALAR), bound(n_bytes, n_ops),
            library=lambda: torch.bmm(Ff, xf))
        for k in ("ms", "plain_ms", "library_ms"):
            tot[k] += r[k]
        tot["bytes"] += n_bytes
        tot["ops"] += n_ops
        del x, F, xf, Ff
    b_ms, b_by = max(bound(tot["bytes"], 0), bound(0, tot["ops"]))
    results["bits_matvec_semi"] = {"max_abs_err": 0, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                                   "bound_ms": b_ms, "bound_by": b_by,
                                   "library_ms": tot["library_ms"]}
    # mulcmp: N = 8 padded rows × B; random semi values, corner operands
    # (0, p, 2p, 2^265 − 1) in all combinations, and true products.
    N = 8 * B
    ops = [rng.integers(0, 1 << 16, size=(17, N), dtype=np.uint32) for _ in range(3)]
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
    for j, vals in enumerate(cols):
        for o, v in zip(ops, vals):
            o[:, j] = limbs(v)
    a, b, c = (from_numpy_u32(o, dev) for o in ops)
    mask = fk.mulcmp(a, b, c, SCALAR)
    got = (mask[: len(cols)] != 0).cpu().numpy()
    assert (got == np.asarray(want)).all(), "mulcmp corner/product columns wrong"
    results["mulcmp"] = compare(
        "mulcmp", lambda: fk.mulcmp(a, b, c, SCALAR),
        lambda: fk.mulcmp_plain(a, b, c, SCALAR), bound(N * 4 * (3 * 17 + 1), N * MULCMP_MULS),
        plain_reps=2)
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
    for n in (N, MUL_WIDE_N):
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

    torch.cuda.reset_peak_memory_stats()
    t_step = time_step(step, free, 5)
    rate = N_CHUNKS * B * R / t_step
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[perf] sha256 step {t_step:.4f} s for {N_CHUNKS}x{B} instances = {rate:.4e} "
          f"constraint-evals/s, peak {peak:.2f} GiB, on {card}")
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
        template = built[name][0]
        torch.cuda.reset_peak_memory_stats()
        t_step = time_step(steps[name], free, reps if name == "config1" else 2)
        peak = torch.cuda.max_memory_allocated() / 2**30
        rate = N_CHUNKS * B_FIELD * template.num_constraints / t_step
        print(f"[perf] {name} step {t_step:.4f} s for {N_CHUNKS}x{B_FIELD} instances = "
              f"{rate:.4e} constraint-evals/s, peak {peak:.2f} GiB, on {card}")
    return launches


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
    results = sha256_kernels(dev, bound)
    results.update(field_kernels(dev, bound))
    torch.cuda.empty_cache()
    launches = {"sha256": sha256_step(dev, card, template, prog)}
    torch.cuda.empty_cache()
    launches.update(field_steps(dev, card, built))

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
