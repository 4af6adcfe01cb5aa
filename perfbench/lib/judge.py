"""What decides `correct`: the inputs made from the seed, the faults planted
in a witness, the program's template held against the reference's rows,
and each number compared beside its limit."""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.reference.circuit import RowChecker, canonical_rows, instance_bits


def random_words(shape, seed: int, device) -> torch.Tensor:
    """Uniform 32-bit words as int32, drawn on `device` from the seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randint(0, 1 << 32, shape, generator=gen, dtype=torch.int64, device=device)
    return (x - (1 << 31)).to(torch.int32)


def fault_sites(seed: int, n_instances: int, n_vars: int, n_faults: int):
    """Distinct instances, each with one variable other than ONE to flip."""
    rng = np.random.default_rng([seed, 0xFA17])
    inst = np.sort(rng.choice(n_instances, size=min(n_faults, n_instances), replace=False))
    return inst, rng.integers(1, n_vars, size=inst.shape[0])


def flip(W: torch.Tensor, inst, var) -> None:
    """Flip bit (instance % 32) of word W[var, instance // 32], in place."""
    inst = np.asarray(inst, np.int64)
    bit = (np.int64(1) << (inst % 32)).astype(np.int64)
    mask = torch.tensor(np.where(bit >= 1 << 31, bit - (1 << 32), bit).astype(np.int32), device=W.device)
    v = torch.as_tensor(np.asarray(var, np.int64), device=W.device)
    w = torch.as_tensor(inst // 32, device=W.device)
    W.index_put_((v, w), W[v, w] ^ mask)


def sample(seed: int, n_instances: int, n: int):
    rng = np.random.default_rng([seed, 0x5A3])
    return np.sort(rng.choice(n_instances, size=min(n, n_instances), replace=False))


def template_rows(template):
    """The program's template as the reference writes its rows."""
    p = template.field.p
    rows = [[{}, {}, {}] for _ in range(template.num_constraints)]
    for mi, m in enumerate((template.a, template.b, template.c)):
        coeffs = template.coeff_table
        for r, c, k in zip(m.rows.tolist(), m.cols.tolist(), m.coeff_ids.tolist()):
            d = rows[r][mi]
            d[c] = (d.get(c, 0) + coeffs[k]) % p
    return [tuple(tuple(sorted((v, k) for v, k in d.items() if k)) for d in row) for row in rows]


def template_rows_wrong(cs, template, free_slots) -> int:
    """Rows of the program's template that differ from the reference's,
    plus one for a different slot count or free-slot order."""
    ref, got = canonical_rows(cs), template_rows(template)
    wrong = sum(a != b for a, b in zip(ref, got)) + abs(len(ref) - len(got))
    n_slots = template.num_inputs + template.num_aux
    return wrong + int(n_slots != cs.n_vars or list(free_slots) != list(cs.free))


def expected_faulted(checker: RowChecker, W_ref: torch.Tensor, inst, var) -> tuple:
    """The reference's verdict on the honest witness W_ref with the faults
    planted: only the faulted instances can violate a row."""
    Z = instance_bits(W_ref, inst)
    Z[np.asarray(var), np.arange(len(inst))] ^= 1
    return checker.verdict(Z, inst)


def reference_bad_rows(checker: RowChecker, W_ref: torch.Tensor, inst) -> int:
    """Rows the reference's own witness violates in the sampled instances."""
    return checker.verdict(instance_bits(W_ref, inst), inst)[0]


class Stopwatch:
    """Seconds of each stage of set-up, synchronized with the card."""

    def __init__(self):
        self.laps, self.t = {}, time.monotonic()

    def lap(self, name: str) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        now = time.monotonic()
        self.laps[name] = round(now - self.t, 3)
        self.t = now


def check(value, limit) -> dict:
    return {"value": value, "limit": limit}
