"""Config 5's synthetic system (benchmarks/config5_synthetic_r1cs.py:58-105,
the same draws of default_rng(7)): one R1CS of R rows, (c1·z[i1] +
c2·z[i2])·z[i3] = z[N0 + 1 + r], and its witness.

    from bellpepper_tpu_torch.tools.config5 import config5_r1cs, config5_z
    r1cs, zfree, n0, _ = config5_r1cs(24)   # 2^24 rows; config5_r1cs(12) for a quick CPU run
    config5_r1cs(20, field=goldilocks)          # the same system over another field
    z = config5_z(zfree, r1cs.num_constraints, "cuda")

The constants are the benchmark's: log2 of its rows, the seed of its
draws, log2 of the row-chunked check's and the witness completion's rows a
chunk (R >> 19 and R >> 17 chunks), and the slot whose low bit its
corruption probe flips."""

import time

import numpy as np
import torch

from bellpepper_tpu_torch import R1CS, SCALAR, COOMatrix, PrimeField
from bellpepper_tpu_torch.backend.words import from_numpy_u32

LOG2_R, SEED = 24, 7
LOG2_RPC_CHECK, LOG2_RPC_WIT = 19, 17
FLIP_SLOT = 5


def config5_r1cs(log2_r: int, field: PrimeField = SCALAR):
    """Config 5's system at 2^log2_r rows over `field` (the benchmark's
    BLS12-381 scalar field by default): A two entries a row with
    coefficient ids 0-3 of [1, 2, 2^17 mod p, p − 1, 0], B one with id 0,
    C the identity on the product segment. Returns (r1cs, the free rows of
    z0 as uint32[1 + N0, 16], N0, the host build's seconds): z0 is random
    16-bit limbs (about half the values in [p, 2^256) at BLS12-381, nearly
    all of them at a smaller field), slot 0 ONE, the product segment zero. The reference draws all 1 + N0 + R rows and
    zeroes the product segment; the first (1 + N0)·16 draws are the same
    numbers."""
    R = 1 << log2_r
    N0 = min(R, 1 << 20)
    rng = np.random.default_rng(SEED)
    t0 = time.time()
    coeff_table = [1, 2, (1 << 17) % field.p, field.p - 1, 0]
    rows = np.arange(R, dtype=np.int32)
    a = COOMatrix(rows=np.repeat(rows, 2), cols=rng.integers(1, N0, size=2 * R, dtype=np.int32),
                  coeff_ids=rng.integers(0, 4, size=2 * R, dtype=np.int32))
    b = COOMatrix(rows=rows.copy(), cols=rng.integers(1, N0, size=R, dtype=np.int32),
                  coeff_ids=np.zeros(R, np.int32))
    c = COOMatrix(rows=rows.copy(), cols=N0 + 1 + np.arange(R, dtype=np.int32), coeff_ids=np.zeros(R, np.int32))
    r1cs = R1CS(field=field, num_inputs=1, num_aux=N0 + R, num_constraints=R, a=a, b=b, c=c,
                coeff_table=coeff_table)
    t_build = time.time() - t0
    zfree = rng.integers(0, 1 << 16, size=(1 + N0, 16)).astype(np.uint32)
    zfree[0] = 0
    zfree[0, 0] = 1  # ONE
    return r1cs, zfree, N0, t_build


def config5_z(zfree, R: int, dev) -> torch.Tensor:
    """z int32[1 + N0 + R, 16] on `dev`: the free rows, then R zero rows."""
    z = torch.zeros((zfree.shape[0] + R, 16), dtype=torch.int32, device=dev)
    z[: zfree.shape[0]] = from_numpy_u32(zfree, dev)
    return z


def flipped_first_row(r1cs, slot: int) -> int:
    """The least row whose A or B reads `slot` with a nonzero net
    coefficient (numpy over the COO arrays): the row a flip of that slot's
    low bit must be reported at."""
    p = r1cs.field.p
    rows = set()
    for name in "ab":
        m = getattr(r1cs, name)
        at = np.nonzero(m.cols == slot)[0]
        net = {}
        for r, k in zip(m.rows[at], m.coeff_ids[at]):
            net[int(r)] = (net.get(int(r), 0) + r1cs.coeff_table[k]) % p
        rows |= {r for r, v in net.items() if v}
    return min(rows)
