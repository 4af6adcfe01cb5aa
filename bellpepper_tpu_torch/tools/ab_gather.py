#!/usr/bin/env python3
"""A/B of the witness-reading kernels against an older tree of the port,
on one CUDA card, in one process per side: parent, change, change, parent.

    python3 bellpepper_tpu_torch/tools/ab_gather.py --parent DIR

DIR holds another checkout of the repository (for example unpacked from
``git archive <commit>``), whose ``bitplane_eq``, ``bits_matvec_semi`` and
``limbs_matvec`` take the witness gathered (plane rows, unpacked bits,
int32 digits); this tree's kernels read it through a table of slots.
Each side builds the same checks from the same seeds and times, on the
card's clock (CUDA events around a loop of calls, which includes the
host's time to launch them, and the kernels' own device time as
torch.profiler reads it):

  * per shape the paths launch: the older tree's gather plus kernel, this
    tree's kernel alone: ``bitplane_eq`` on the packed sha256 chunk (4 ×
    32,768 instances); ``bits_matvec_semi`` on the big row's three ELL
    buckets; ``limbs_matvec`` on config 1's three fold buckets (B = 8,192)
    and the sha256 limbs check's 17 buckets (B = 1,024);
  * the per-call copy the older tree shares between buckets (the unpacked
    used slots of the big row; the int32 digits of the limbs check),
    timed apart;
  * the whole check each of those sits in (the big row's mask, the limbs
    check's mask), the same call on both sides;
  * the peak device memory of the limbs check's mask at B = 1,024;
  * for this tree's ``bitplane_eq`` alone, what bounds it: the same launch
    with every plane empty (no loads), with every plane one slot (no empty
    plane, the loads from L2), and over twice the columns (twice the
    warps).

Prints one ``[ab]`` line a shape and, last, one JSON object with every
side's numbers; writes the same JSON to ``chiprun_out/ab_gather.json``."""

import argparse
import json
import os
import subprocess
import sys

SEED = 0x5962BE3D
B = 32768  # sha256 packed instances a chunk
B_FIELD = 8192
B_SHA_LIMBS = 1024
REPS = 10


def cuda_ms(torch, fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps=REPS, kernel=None, cold=False):
    """Device time of fn() as torch.profiler reads it over reps calls, free
    of the host's time to launch (None where it reads none). Without
    kernel: every CUDA kernel's time summed, a call (divided by reps; an
    event the profiler drops reads low). With kernel, a name or a tuple of
    names one of which the kernel's name holds, launched once a call: that
    kernel's time a launch, divided by the launches the profiler recorded,
    since it sometimes drops some. cold=True (with kernel) writes 128 MB,
    past the card's 50 MB L2, before each call, so the kernel reads its
    inputs from device memory as a bytes bound counts them; else they stay
    in L2 between calls where they fit. A profiler session slows the
    host's later launches in the same process: time the host's clock
    first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    assert kernel is not None or not cold, "the flush's own kernel would count"
    scratch = torch.empty(32 << 20, dtype=torch.int32, device="cuda") if cold else None
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if cold:
                scratch.fill_(1)
            fn()
        torch.cuda.synchronize()
    names = (kernel,) if isinstance(kernel, str) else kernel
    found = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
             and (names is None or any(n in e.key for n in names))]
    us = sum(e.self_device_time_total for e in found)
    count = reps if names is None else sum(e.count for e in found)
    return us / 1e3 / count if us else None


def side() -> dict:
    """Time this process's tree (the one on sys.path)."""
    import numpy as np
    import torch

    from bellpepper_tpu_torch import NativeBuilder, WitnessProgram, build_templated_check
    from bellpepper_tpu_torch.backend import field_kernels as fk
    from bellpepper_tpu_torch.backend.words import from_numpy_u32

    new = hasattr(fk, "fold_operand")  # this tree's API: the kernels gather
    dev = torch.device("cuda")
    out = {"shapes": {}, "device": {}, "shared": {}, "checks": {}, "diag": {}}

    def shape(key, fn):
        out["shapes"][key] = cuda_ms(torch, fn)
        out["device"][key] = device_ms(torch, fn)
    L8 = 32

    def unpack(words):
        sh = torch.arange(32, dtype=torch.int32, device=words.device)
        return ((words[:, :, None] >> sh) & 1).reshape(words.shape[0], -1)

    nb = NativeBuilder()
    bits = [nb.alloc_bit() for _ in range(512)]
    nb.sha256_compression(bits, nb.sha256_iv())
    template, tape = nb.finish()
    prog = WitnessProgram(tape)
    rng = np.random.default_rng(SEED)
    Bw = B // 32
    free = from_numpy_u32(rng.integers(0, 1 << 32, size=(Bw, 512), dtype=np.uint64).astype(np.uint32), dev)
    vals_p = prog.build_packed(device=dev)(free).t().contiguous()
    vals_p[:, 1::2] = from_numpy_u32(rng.integers(0, 1 << 32, size=(vals_p.shape[0], Bw // 2),
                                                  dtype=np.uint64).astype(np.uint32), dev)
    check = build_templated_check(template, B, None, "bits_packed", device=dev)

    # bitplane_eq: the whole kernel form is the same call on both sides
    ref = check._pow2_bad_words(vals_p)
    shape("bitplane_eq n=25 P=256 Bw=1024", lambda: check._pow2_bad_words(vals_p))
    out["digest_bitplane"] = int(ref.to(torch.int64).sum())
    if new:  # what bounds this tree's bitplane_eq: loads, the walk, or too few warps
        spec, planes = check.pow2_spec, check.plane_idx
        n, P = spec["a_cols"].shape[0], fk.padded_positions(spec["n_pos"])
        ma, mc = spec["a_cols"].shape[2], spec["c_cols"].shape[2]
        empty = torch.full_like(planes, -1)
        one = torch.ones_like(planes)
        wide = torch.cat([vals_p, vals_p], dim=1)
        for label, v, t in (("every plane empty (no loads)", vals_p, empty),
                            ("every plane slot 1 (no empty plane, loads from L2)", vals_p, one),
                            ("Bw 2,048 (twice the warps)", wide, planes)):
            fn = lambda v=v, t=t: fk.bitplane_eq(v, t, n, P, ma, mc)  # noqa: E731
            out["diag"][f"bitplane_eq, {label}"] = cuda_ms(torch, fn)
            out["diag"][f"bitplane_eq, {label}, device time"] = device_ms(torch, fn)
        del wide

    # bits_matvec_semi: the big row's buckets
    big = check.big
    if new:
        for name in "abc":
            (cols, F), = big.mats[name]
            shape(f"bits_matvec_semi {name} K={cols.shape[1]}", lambda: fk.bits_matvec_semi(vals_p, cols, F, big.field))
    else:
        bits_T = unpack(vals_p.index_select(0, check.used))
        out["shared"]["bits unpack of the used slots"] = cuda_ms(
            torch, lambda: unpack(vals_p.index_select(0, check.used)))
        for name in "abc":
            cols_all, buckets = big.mats[name]
            (k, start, n_rows, cd_b), = buckets

            def run():
                x = bits_T.index_select(0, cols_all)[start : start + n_rows * k].reshape(n_rows, k, B)
                return fk.bits_matvec_semi(x, cd_b, big.field)
            shape(f"bits_matvec_semi {name} K={k}", run)
        del bits_T
    out["checks"]["big row mask"] = cuda_ms(torch, lambda: check._big_bad(vals_p))
    out["digest_big"] = int(check._big_bad(vals_p).sum())
    del vals_p, check, free
    torch.cuda.empty_cache()

    # limbs_matvec: config 1's fold buckets and the sha256 limbs check's
    nb = NativeBuilder()
    bits = [nb.alloc_bit() for _ in range(128)]
    a, b = nb.pack_bits(bits[:64]), nb.pack_bits(bits[64:])
    x = a
    for _ in range(30):
        x = nb.num_square(nb.num_add(nb.num_mul(x, b), a))
    c1_template, _tape = nb.finish()
    gen = torch.Generator(device=dev)
    for label, lcheck, Bm in (("config1", build_templated_check(c1_template, B_FIELD, None, "limbs", device=dev).fold,
                               B_FIELD),
                              ("sha256", build_templated_check(template, B_SHA_LIMBS, None, "limbs", device=dev),
                               B_SHA_LIMBS)):
        gen.manual_seed(SEED)
        zt = torch.randint(0, 1 << 16, (lcheck.S_t, 16, Bm), generator=gen, device=dev, dtype=torch.int32)
        field = lcheck.field

        def digits():
            return torch.stack([zt & 0xFF, (zt >> 8) & 0xFF], dim=2).reshape(lcheck.S_t, L8, Bm)
        if not new:
            zd = digits()
            out["shared"][f"{label} int32 digits"] = cuda_ms(torch, digits)
        for name in "abc":
            for i, bucket in enumerate(lcheck.mats[name]):
                if new:
                    cols, F = bucket
                    n_rows, k = cols.shape
                    fn = lambda cols=cols, F=F: fk.limbs_matvec(zt, cols, F, field)  # noqa: E731
                else:
                    k, n_rows, cols, F = bucket
                    fn = lambda k=k, n_rows=n_rows, cols=cols, F=F: fk.limbs_matvec(  # noqa: E731
                        zd.index_select(0, cols).reshape(n_rows, k * L8, Bm), F, field)
                shape(f"limbs_matvec {label} {name}{i} rows={n_rows} K={k} B={Bm}", fn)
        if not new:
            del zd
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out[f"digest_{label}"] = int(lcheck.mask_slot_major(zt).sum())
        out["checks"][f"{label} limbs mask peak GiB above its inputs"] = (
            torch.cuda.max_memory_allocated() - base) / 2**30
        out["checks"][f"{label} limbs mask"] = cuda_ms(torch, lambda: lcheck.mask_slot_major(zt), 3)
        del zt, lcheck
        torch.cuda.empty_cache()
    return out


def run_sides(script: str, parent: str) -> dict:
    """Run ``script --side`` in one process per turn (parent, change,
    change, parent), each with its tree's root on PYTHONPATH, and collect
    the JSON each prints last: {"parent": [run, run], "change": [...]}."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    roots = {"parent": os.path.abspath(parent), "change": here}
    runs = {"parent": [], "change": []}
    for label in ("parent", "change", "change", "parent"):
        env = dict(os.environ, PYTHONPATH=roots[label])
        res = subprocess.run([sys.executable, os.path.abspath(script), "--side"], cwd=roots[label], env=env,
                             capture_output=True, text=True, check=False)
        if res.returncode:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"the {label} side failed")
        runs[label].append(json.loads(res.stdout.strip().splitlines()[-1]))
    return runs


def fmt(v) -> str:
    return " / ".join("not measured" if x is None else f"{x:.4f}" for x in v)


def write_report(name: str, runs: dict) -> None:
    """Print and write chiprun_out/<name>.json: the card and every run."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    report = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                     capture_output=True, text=True).stdout.strip(), "runs": runs}
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", f"{name}.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="root of the older tree")
    ap.add_argument("--side", action="store_true", help="time the tree on sys.path (internal)")
    args = ap.parse_args()
    if args.side:
        print(json.dumps(side()))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    runs = run_sides(__file__, args.parent)
    for key in ("digest_bitplane", "digest_big", "digest_config1", "digest_sha256"):
        got = {r[key] for side_runs in runs.values() for r in side_runs}
        assert len(got) == 1, (key, got)
    for shape in runs["change"][0]["shapes"]:
        p = [r["shapes"][shape] for r in runs["parent"]]
        c = [r["shapes"][shape] for r in runs["change"]]
        pd = [r["device"][shape] for r in runs["parent"]]
        cd = [r["device"][shape] for r in runs["change"]]
        print(f"[ab] {shape}: parent (gather + kernel) {p[0]:.4f} / {p[1]:.4f} ms, "
              f"change (kernel) {c[0]:.4f} / {c[1]:.4f} ms; device time {fmt(pd)} and {fmt(cd)} ms")
    for group in ("shared", "checks", "diag"):
        for label, side_runs in runs.items():
            for key in side_runs[0][group]:
                print(f"[ab] {label} {key}: {fmt([r[group][key] for r in side_runs])}")
    write_report("ab_gather", runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
