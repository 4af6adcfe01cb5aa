#!/usr/bin/env python3
"""The packed check's verdict fold (``field_kernels.verdict_fold``) on one
CUDA card, at every fold of the sha256 and blake2s packed checks: the
kernel against its plain version, and both timed.

    python3 -m bellpepper_tpu_torch.tools.fold_times [--batch 2097152]

Each template's check is built at the batch, and each fold of its verdict
gets an input of the shape that fold receives: the bad words of each
structured family and of the MultiEq pow2 rows (int32 [rows, batch/32])
and the big rows' mask (bool [rows, batch]). They are zero, as an honest
batch's are, but for 16 violations planted at seeded (row, instance)
sites. Each fold must give the plain version's verdict and the planted
sites' exact (n_bad, first). Times are CUDA events around a loop of calls
after one warm-up (20 kernel calls, 2 plain ones), beside the bound: the
input's bytes read once at 3.35 TB/s. Prints a ``[fold]`` line a fold and
a total a template, then all of it as one JSON line."""

import argparse
import json
import subprocess

import numpy as np
import torch

from bellpepper_tpu_torch import NativeBuilder
from bellpepper_tpu_torch.backend import field_kernels as fk
from bellpepper_tpu_torch.backend.matvec import PackedBitsCheck

HBM_BYTES_PER_S = 3.35e12
N_FAULTS = 16


def sha256_template():
    nb = NativeBuilder()
    bits = [nb.alloc_bit() for _ in range(512)]
    nb.sha256_compression(bits, nb.sha256_iv())
    return nb.finish()[0]


def blake2s_template():
    nb = NativeBuilder()
    h = [nb.alloc_bit() for _ in range(256)]
    nb.blake2s_compression(h, [nb.alloc_bit() for _ in range(512)], 64, True)
    return nb.finish()[0]


def fold_shapes(check: PackedBitsCheck):
    """[(name, rows int64 tensor, mask?)] of the verdict's folds, in its order."""
    out = [(kind, rows, False) for kind, _opcols, rows, _span in check.fam]
    if check.n_left:
        out.append(("leftover", check.rows_left, True))
    if check.pow2_spec is not None:
        out.append(("pow2", check.pow2_rows, False))
    if check.big is not None:
        out.append(("big", check.rest_big_idx, True))
    return out


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def planted(rng, n: int, batch: int, mask: bool, dev):
    """A zero input of the fold's shape with N_FAULTS violations at seeded
    sites, and the sites (row, instance)."""
    sites = {(int(rng.integers(n)), int(rng.integers(batch))) for _ in range(N_FAULTS)}
    bad = torch.zeros((n, batch) if mask else (n, batch // 32), dtype=torch.bool if mask else torch.int32,
                      device=dev)
    for r, b in sites:
        if mask:
            bad[r, b] = True
        else:
            bit = 1 << (b % 32)
            bad[r, b // 32] |= bit - (1 << 32) if bit >> 31 else bit  # the int32 of the bit's uint32
    return bad, sites


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1 << 21)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: the fold is timed on the card only")
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    B = args.batch
    rng = np.random.default_rng(0x5EED_0F01)
    report = {"card": card, "batch": B, "templates": {}}
    for name, make in (("sha256", sha256_template), ("blake2s", blake2s_template)):
        template = make()
        check = PackedBitsCheck(template, B, dev)
        R = template.num_constraints
        folds = []
        for fold, rows, mask in fold_shapes(check):
            n = rows.shape[0]
            bad, sites = planted(rng, n, B, mask, dev)
            rows_h = rows.cpu().tolist()
            want = (len(sites), min(b * R + rows_h[r] for r, b in sites))
            got = fk.verdict_fold(fk.verdict_acc(dev), bad, rows, R)
            plain = fk.verdict_fold_plain(fk.verdict_acc(dev), bad, rows, R, B)
            assert tuple(got.tolist()) == tuple(plain.tolist()) == want, (name, fold, got, plain, want)
            acc = fk.verdict_acc(dev)  # the timed calls add into one verdict
            ms = cuda_ms(lambda: fk.verdict_fold(acc, bad, rows, R), 20)
            plain_ms = cuda_ms(lambda: fk.verdict_fold_plain(acc, bad, rows, R, B), 2)
            nbytes = bad.numel() * bad.element_size()
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            folds.append({"fold": fold, "shape": list(bad.shape), "dtype": str(bad.dtype), "bytes": nbytes,
                          "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms})
            print(f"[fold] {name} {fold}: {str(bad.dtype)[6:]}{list(bad.shape)} kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_ms / ms:.1%}); verdict {want} on both")
            del bad
            torch.cuda.empty_cache()
        tot = {k: sum(f[k] for f in folds) for k in ("ms", "plain_ms", "bound_ms", "bytes")}
        print(f"[fold] {name} all {len(folds)} folds: kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, "
              f"bound {tot['bound_ms']:.4f} ms ({tot['bound_ms'] / tot['ms']:.1%}), {tot['bytes'] / 1e9:.3f} GB")
        report["templates"][name] = {"folds": folds, "total": tot}
        del check
        torch.cuda.empty_cache()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
