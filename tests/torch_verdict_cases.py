"""Cases of the packed check's verdict fold (``field_kernels.verdict_fold``),
shared by its CPU tests and its card tests, and a Python loop over bits
that computes the verdict they must give.

A case is a list of folds (bad, rows, R, n_inst) applied in order to one
running verdict; each has a words form (int32 [n, Bw] packed words) and a
mask form (the same instances as bool [n, 32·Bw])."""

import numpy as np
import torch

from bellpepper_tpu_torch.backend.field_kernels import NONE

SIGN = np.uint32(1 << 31)  # the int32 sign bit


def _sparse(rng, n, Bw, per_mille):
    """uint32 [n, Bw] words with about per_mille ‰ of their bits set."""
    bits = rng.random((n, Bw, 32)) < per_mille / 1000
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def _rows(rng, n, R):
    return np.sort(rng.choice(R, n, replace=False)).astype(np.int64)


def word_folds(name: str, seed: int = 0):
    """[(uint32 words [n, Bw], rows int64[n], R, n_inst)] of case `name`."""
    rng = np.random.default_rng(seed)
    if name == "zero":
        return [(np.zeros((5, 8), np.uint32), _rows(rng, 5, 40), 40, 256)]
    if name == "sign_bit":
        w = np.zeros((4, 8), np.uint32)
        w[2, 5] = SIGN
        return [(w, _rows(rng, 4, 30), 30, 256)]
    if name == "all_ones":
        return [(np.full((3, 9), 0xFFFFFFFF, np.uint32), _rows(rng, 3, 11), 11, 288)]
    if name == "ragged_n_inst":  # bits set past n_inst must not count
        w = _sparse(rng, 6, 12, 80)
        w[:, 9] |= np.uint32(0xFFFF0000)
        w[:, 10:] = 0xFFFFFFFF
        return [(w, _rows(rng, 6, 50), 50, 300)]
    if name == "bw_mod4":
        return [(_sparse(rng, 5, 7, 30), _rows(rng, 5, 20), 20, 221)]
    if name == "running":  # the least index comes from the last fold
        a = np.zeros((3, 8), np.uint32)
        a[1, 6] = 1 << 4
        b = _sparse(rng, 4, 8, 5)
        b[:, :3] = 0
        c = np.zeros((2, 8), np.uint32)
        c[0, 0] = SIGN
        c[1, 0] = 1 << 30
        return [(a, np.asarray([2, 5, 9], np.int64), 16, 256), (b, np.asarray([0, 1, 3, 4], np.int64), 16, 256),
                (c, np.asarray([7, 15], np.int64), 16, 256)]
    if name == "above_2_32":  # flat indices b·R + row past 2^32
        R = (1 << 31) + 11
        w = np.zeros((3, 8), np.uint32)
        w[0, 3] = 1 << 7
        w[2, 3] = 1 << 6
        w[1, 7] = SIGN
        return [(w, np.asarray([R - 3, 5, R - 1], np.int64), R, 256)]
    raise KeyError(name)


CASES = ("zero", "sign_bit", "all_ones", "ragged_n_inst", "bw_mod4", "running", "above_2_32")


def as_mask(words: np.ndarray) -> np.ndarray:
    """uint32 [n, Bw] → bool [n, 32·Bw]: column b is bit b % 32 of word
    b // 32."""
    return ((words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(bool).reshape(words.shape[0], -1)


def folds(name: str, form: str, device, seed: int = 0):
    """The case's folds as tensors on `device`: (bad, rows, R, n_inst)."""
    out = []
    for w, rows, R, n_inst in word_folds(name, seed):
        bad = torch.from_numpy(w.view(np.int32).copy()) if form == "words" else torch.from_numpy(as_mask(w))
        out.append((bad.to(device), torch.from_numpy(rows).to(device), R, n_inst))
    return out


def python_verdict(case_folds):
    """(n_bad, first) by a Python loop over every live bit of every fold,
    first NONE while there is none."""
    n_bad, first = 0, NONE
    for bad, rows, R, n_inst in case_folds:
        bad = bad.cpu().numpy()
        for r in range(bad.shape[0]):
            for b in range(n_inst):
                if bad.dtype == bool:
                    hit = bool(bad[r, b])
                else:
                    hit = (int(bad[r, b // 32]) >> (b % 32)) & 1
                if hit:
                    n_bad += 1
                    first = min(first, b * R + int(rows[r]))
    return n_bad, first
