#!/usr/bin/env python3
"""A/B of the word-arithmetic field kernels (``mulcmp``, ``chain``,
``mul``, ``mul_digits``, ``reduce_digits``) against an older tree of the
port, on one CUDA card, one process per side: parent, change, change,
parent.

    python3 bellpepper_tpu_torch/tools/ab_field.py --parent DIR

DIR holds another checkout of the repository (for example unpacked from
``git archive <commit>``). Each side makes the same inputs from the same
seeds on the card and times each call on the card's clock: CUDA events
around a loop of calls (which includes the host's time to launch them),
and the kernels' own device time as torch.profiler reads it. The shapes:

  * ``mulcmp`` at every N the paths launch it at: the packed sha256 check
    (8 padded rows × 32,768), config 1's limbs check (8 padded fold rows ×
    8,192), and the sha256 limbs check (26,360 padded rows × 1,024, 2,048
    and 4,096), on random semi values below 2^265 (the mixed checks'
    product rows and the limbs checks' trivial rows take
    ``operand_mulcmp``);
  * ``chain`` at config 1's shape (x0 [16, 8,192], two external operands,
    (fmul, fadd, fmul) × 30), and, to show what bounds it, at 4,096 and
    16,384 instances;
  * ``mul`` at one block (N = 32, its launch floor), the variant's
    [16, 8,192], the Satisfier's [16, 426,920] and [16, 2^20];
  * ``FieldBackend.inv`` at the variant's [1, 16, 8,192] (dim 1), the
    inversion ladder of its ``finv``;
  * ``mul_digits`` at the chain ``Satisfier``'s [16, 1,258,176] (canonical
    operands) and the row-sharded check's [16, 2,097,152] (a raw, below
    2^256, by canonical b);
  * ``reduce_digits`` at config 5's product chunk [32, 131,072], the chain
    ``Satisfier``'s [32, 426,920] and the row-sharded check's [32, 2^20]
    on random sums below 2^24: limb-major on both sides, and from
    element-major sums ([N, 32], as the row-chunked evaluator builds
    them), which this tree reads as they lie and an older one, whose
    wrapper takes only limb-major sums, copies to limb-major first (as its
    callers did); for both kernels also the kernel's own device time with
    L2 flushed before each call;
  * config 5's witness completion at 2^24 rows (``tools/config5.py``; the
    host clock around calls that end in a synchronize, the median of 7
    rounds of 3 calls, before any profiler session and again after them
    all, and the device work a call: every kernel's device time summed);
  * the steps that launch ``mulcmp``, ``chain`` or ``mul`` (host clock
    around calls that end in a synchronize, seconds a step): the packed
    sha256 step at 4 × 32,768, config 1's at 4 × 8,192 in the mixed and
    the limbs forms, the variant's (config 1 with num_assert_nonzero) at
    4 × 8,192, and the sha256 limbs step at 4 × 1,024.

The host's clock comes first on each side (config 5's completion, then
the steps), before any profiler session, since one slows the process's
later launches. Both sides must agree on every output (a digest a shape:
the count of mulcmp's nonzero words, the sum of chain's, mul's,
mul_digits' and reduce_digits' words, each step's verdict; inv's sum of
words; the sum of the completed product's words). Prints one ``[ab]``
line a shape and, last, one JSON object with every side's
numbers; writes the same JSON to ``chiprun_out/ab_field.json``."""

import argparse
import sys

from ab_gather import cuda_ms, device_ms, fmt, run_sides, write_report

SEED = 0x5962BE3D
MULCMP_N = {
    "sha256 packed": 8 * 32768,
    "config1 limbs fold": 8 * 8192,
    "sha256 limbs 1024": 26360 * 1024,
    "sha256 limbs 2048": 26360 * 2048,
    "sha256 limbs 4096": 26360 * 4096,
}
CHAIN_N = (8192, 4096, 16384)
MUL_N = (32, 8192, 426920, 1 << 20)
MUL_DIGITS_N = (1258176, 2097152)  # the second with a raw a, as the row-sharded check gathers it
REDUCE_N = (131072, 426920, 1 << 20)


def side() -> dict:
    """Time this process's tree (the one on sys.path)."""
    import numpy as np
    import torch

    from bellpepper_tpu_torch import SCALAR
    from bellpepper_tpu_torch.backend import field_kernels as fk
    from bellpepper_tpu_torch.backend.field_backend import get_backend
    from bellpepper_tpu_torch.backend.words import from_numpy_u32

    dev = torch.device("cuda")
    out = {"events": {}, "device": {}, "cold": {}, "digest": {}, "steps": {}, "after_profiler": {}}
    # the host's clock first: a torch.profiler session slows the process's later launches
    key5, completion = config5_completion(out, dev)
    steps(out, dev)
    torch.cuda.empty_cache()

    def shape(key, fn, digest, reps=10, kernel=None):
        out["digest"][key] = digest
        out["events"][key] = cuda_ms(torch, fn, reps)
        out["device"][key] = device_ms(torch, fn, reps)
        if kernel is not None:  # the named kernel alone, its inputs from device memory
            out["cold"][key] = device_ms(torch, fn, reps, kernel=kernel, cold=True)

    gen = torch.Generator(device=dev)
    for label, N in MULCMP_N.items():
        gen.manual_seed(SEED + N)
        ops = [torch.randint(0, 1 << 16, (17, N), generator=gen, device=dev, dtype=torch.int32) for _ in range(3)]
        for o in ops:
            o[16] &= 0x1FF  # values < 2^265
        a, b, c = ops
        digest = int((fk.mulcmp(a, b, c, SCALAR) != 0).sum())
        shape(f"mulcmp {label} N={N}", lambda: fk.mulcmp(a, b, c, SCALAR), digest)
        del ops, a, b, c
        torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED)
    top = SCALAR.p >> 240

    def canonical(n):
        x = rng.integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
        x[15] = rng.integers(0, top, size=n, dtype=np.uint32)
        return from_numpy_u32(x, dev)

    descs = (("fmul", "prev", 0), ("fadd", "prev", 1), ("fmul", "prev", "prev"))
    for N in CHAIN_N:
        x0, ext = canonical(N), torch.cat([canonical(N), canonical(N)])
        digest = int(fk.chain(x0, ext, descs, 30, SCALAR).to(torch.int64).sum())
        shape(f"chain x0 [16, {N}] x 90 steps", lambda: fk.chain(x0, ext, descs, 30, SCALAR), digest)
    for N in MUL_N:
        ma, mb = canonical(N), canonical(N)
        digest = int(fk.mul(ma, mb, SCALAR).to(torch.int64).sum())
        shape(f"mul [16, {N}]", lambda: fk.mul(ma, mb, SCALAR), digest, reps=20)
    be = get_backend(SCALAR)
    x = canonical(8192).reshape(16, 1, 8192).transpose(0, 1).contiguous()
    digest = int(be.inv(x, 1).to(torch.int64).sum())
    shape("FieldBackend.inv [1, 16, 8192]", lambda: be.inv(x, 1), digest, reps=2)
    del x0, ext, ma, mb, x
    for N in MUL_DIGITS_N:
        if N == MUL_DIGITS_N[-1]:
            ma = from_numpy_u32(rng.integers(0, 1 << 16, size=(16, N), dtype=np.uint32), dev)
        else:
            ma = canonical(N)
        mb = canonical(N)
        digest = int(fk.mul_digits(ma, mb, SCALAR).to(torch.int64).sum())
        shape(f"mul_digits [16, {N}]", lambda: fk.mul_digits(ma, mb, SCALAR), digest, reps=20,
              kernel=("mul_kernel", "mul_digits_kernel"))  # this tree's name, the older tree's
    del ma, mb
    for N in REDUCE_N:
        em = from_numpy_u32(rng.integers(0, 1 << 24, size=(N, 32), dtype=np.uint32), dev)
        lm = em.t().contiguous()
        digest = int(fk.reduce_digits(lm, SCALAR).to(torch.int64).sum())
        shape(f"reduce_digits [32, {N}] limb-major", lambda: fk.reduce_digits(lm, SCALAR), digest, reps=20,
              kernel="reduce_digits_kernel")
        try:
            fk.reduce_digits(em.t(), SCALAR)
            em_call = lambda: fk.reduce_digits(em.t(), SCALAR)  # noqa: E731
        except ValueError:  # an older tree: its callers copied to limb-major first
            em_call = lambda: fk.reduce_digits(em.t().contiguous(), SCALAR)  # noqa: E731
        shape(f"reduce_digits [{N}, 32] element-major sums", em_call, digest, reps=20, kernel="reduce_digits_kernel")
    del em, lm
    out["device"][key5] = device_ms(torch, completion, 5)
    out["after_profiler"][key5] = median_wall(completion)
    return out


def median_wall(run) -> float:
    """Seconds a call of run() on the host's clock: the median of 7 rounds
    of 3 calls and one synchronize."""
    import time

    import torch

    rounds = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        rounds.append((time.time() - t0) / 3)
    return sorted(rounds)[3]


def config5_completion(out: dict, dev):
    """Config 5's witness completion at 2^24 rows: its seconds a call
    (median_wall) into out; returns its key and a call of it."""
    import torch

    from bellpepper_tpu_torch import build_row_chunked_check, build_row_chunked_product
    from bellpepper_tpu_torch.tools import config5 as c5

    r1cs, zfree, _, _ = c5.config5_r1cs(c5.LOG2_R)
    R = r1cs.num_constraints
    check, prep = build_row_chunked_check(r1cs, R >> c5.LOG2_RPC_CHECK, device=dev)
    prod, pprep = build_row_chunked_product(r1cs, R >> c5.LOG2_RPC_WIT, reuse=(check._layout_meta, prep),
                                            device=dev)
    z = c5.config5_z(zfree, R, dev)
    key = f"config5 witness completion R={R}"
    out["digest"][key] = int(prod(z, pprep).to(torch.int64).sum())  # warm-up
    out["steps"][key] = median_wall(lambda: prod(z, pprep))
    return key, lambda: prod(z, pprep)


def steps(out: dict, dev) -> None:
    """Seconds a step of the paths that launch mulcmp, chain or mul."""
    import time

    import numpy as np
    import torch

    from bellpepper_tpu_torch import (NativeBuilder, WitnessProgram, build_packed_production_step,
                                      build_production_step)
    from bellpepper_tpu_torch.backend.words import from_numpy_u32

    def timed(key, step, free, reps):
        out["digest"][key] = [int(v) for v in step(free)]  # warm-up
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(reps):
            step(free)
        torch.cuda.synchronize()
        out["steps"][key] = (time.time() - t0) / reps

    def config1(nonzero):
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

    free = from_numpy_u32(np.random.default_rng(5).integers(0, 2, size=(4, 8192, 128)).astype(np.uint32), dev)
    template, prog = config1(False)
    for form in (None, "limbs"):
        step = build_production_step(prog, template, 8192, device=dev, witness_form=form)
        timed(f"config1 {form or 'mixed'} step 4 x 8192", step, free, 5)
    template, prog = config1(True)
    timed("variant mixed step 4 x 8192", build_production_step(prog, template, 8192, device=dev), free, 2)
    nb = NativeBuilder()
    nb.sha256_compression([nb.alloc_bit() for _ in range(512)], nb.sha256_iv())
    template, tape = nb.finish()
    prog = WitnessProgram(tape)
    rng = np.random.default_rng(SEED)
    words = from_numpy_u32(rng.integers(0, 1 << 32, size=(4, 1024, 512), dtype=np.uint64).astype(np.uint32), dev)
    timed("sha256 packed step 4 x 32768", build_packed_production_step(prog, template, 32768, device=dev), words, 3)
    del words
    free = from_numpy_u32(rng.integers(0, 2, size=(4, 1024, 512)).astype(np.uint32), dev)
    timed("sha256 limbs step 4 x 1024", build_production_step(prog, template, 1024, device=dev,
                                                              witness_form="limbs"), free, 3)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="root of the older tree")
    ap.add_argument("--side", action="store_true", help="time the tree on sys.path (internal)")
    args = ap.parse_args()
    if args.side:
        import json

        print(json.dumps(side()))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    runs = run_sides(__file__, args.parent)
    for key in runs["change"][0]["digest"]:
        got = {repr(r["digest"][key]) for side_runs in runs.values() for r in side_runs}
        assert len(got) == 1, (key, got)

        def both(group):
            return {label: fmt([r[group][key] for r in side_runs]) for label, side_runs in runs.items()}
        if key in runs["change"][0]["steps"]:
            st = both("steps")
            dv = f"; device parent {both('device')['parent']} ms, change {both('device')['change']} ms" if (
                key in runs["change"][0]["device"]) else ""
            if key in runs["change"][0]["after_profiler"]:
                ap = both("after_profiler")
                dv += f"; after the profiler sessions parent {ap['parent']} s, change {ap['change']} s"
            print(f"[ab] {key}: parent {st['parent']} s, change {st['change']} s{dv}")
        else:
            ev, dv = both("events"), both("device")
            cold = ""
            if key in runs["change"][0]["cold"]:
                cd = both("cold")
                cold = f"; the kernel alone, L2 flushed: parent {cd['parent']} ms, change {cd['change']} ms"
            print(f"[ab] {key}: events parent {ev['parent']} ms, change {ev['change']} ms; "
                  f"device parent {dv['parent']} ms, change {dv['change']} ms{cold}")
    write_report("ab_field", runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
