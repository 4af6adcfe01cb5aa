"""The control: the reference put in the program's place with its field
arithmetic cut to the next lower precision, wrapping 64-bit integers (one
machine word in place of the 255-bit BLS12-381 scalar). Every coefficient
is taken in its signed form mod 2^64 and A·z, B·z, C·z and the product
wrap mod 2^64: the step a later change might take to keep the big
MultiEq rows in one word. An honest witness still passes (its rows hold
over the integers), and a fault whose only witness is a coefficient of
2^64 or more goes unseen, so the control must come out not correct."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.circuit import SENTINEL, Circuit

M64 = 1 << 64
NONE = 1 << 62  # above every instance-major index


def _signed64(c: int, p: int) -> int:
    s = c if c <= p // 2 else c - p
    s %= M64
    return s - M64 if s >= 1 << 63 else s


class Int64Check:
    """verdict_slot_major(W int32[S, Bw]) → (n_bad, first) as int64 0-d
    tensors, over every instance, in wrapping int64 arithmetic."""

    def __init__(self, cs: Circuit, device, block_words: int = 128):
        self.R = len(cs.rows)
        self.block = block_words
        self.sides = []
        for m in range(3):
            rows, cols, coeffs = [], [], []
            for r, row in enumerate(cs.rows):
                for v, c in row[m].items():
                    rows.append(r)
                    cols.append(v)
                    coeffs.append(_signed64(c, cs.p))
            self.sides.append(tuple(torch.tensor(np.asarray(x, np.int64), device=device)
                                    for x in (rows, cols, coeffs)))

    def verdict_slot_major(self, W: torch.Tensor, flimbs=None):
        dev = W.device
        lanes = torch.arange(32, dtype=torch.int64, device=dev)
        rows_idx = torch.arange(self.R, dtype=torch.int64, device=dev)[:, None]
        n_bad = torch.zeros((), dtype=torch.int64, device=dev)
        first = torch.full((), NONE, dtype=torch.int64, device=dev)
        for w0 in range(0, W.shape[1], self.block):
            words = W[:, w0 : w0 + self.block].to(torch.int64)
            z = ((words[:, :, None] >> lanes) & 1).reshape(W.shape[0], -1)  # [S, n]
            sums = []
            for rows, cols, coeffs in self.sides:
                s = torch.zeros((self.R, z.shape[1]), dtype=torch.int64, device=dev)
                s.index_add_(0, rows, coeffs[:, None] * z.index_select(0, cols))
                sums.append(s)
            bad = sums[0] * sums[1] - sums[2] != 0
            inst = torch.arange(z.shape[1], dtype=torch.int64, device=dev) + 32 * w0
            n_bad += bad.sum()
            cand = torch.where(bad, inst[None, :] * self.R + rows_idx, NONE)
            first = torch.minimum(first, cand.min())
        return n_bad, torch.where(first == NONE, SENTINEL, first)
