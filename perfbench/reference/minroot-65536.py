"""The reference of `minroot-65536`: the step circuit of Nova's MinRoot VDF
(microsoft/Nova ``examples/minroot.rs``, ``MinRootCircuit::synthesize``)
at 65,536 iterations, as bellpepper synthesizes it: z_in = (x_0, y_0)
allocated first, then per iteration the advice x_{i+1}, ``square`` (row
x_{i+1} · x_{i+1} = sq), ``square`` (sq · sq = quad) and the row
quad · x_{i+1} = x_i + y_i; y_{i+1} = x_i, with no row.

Advice is made backward from the seed, where MinRoot is cheap: x_{i−1} =
x_{i+1}^5 − x_i mod p. A chain s of values with s[k+2]^5 = s[k+1] + s[k]
is grown down from two seeded end values, and the window at offset o is
one valid step: y_0 = s[o], x_0 = s[o+1], x_{i+1} = s[o+i+2].

Field values are Python integers on the host and, on the device, int64
tensors of 16 limbs of 16 bits, limb-major [16, n]; products are exact
schoolbook sums reduced by Montgomery's REDC, written here in plain
PyTorch. This module imports nothing of the program under test."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.circuit import SENTINEL, Circuit

N_ITERS = 65536
MASK = 0xFFFF


def limbs_of(values) -> np.ndarray:
    """Python integers below 2^256 → uint16[len, 16], least significant first."""
    raw = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(raw, np.uint16).reshape(-1, 16)


def ints_of(limbs) -> list:
    """int[n, 16] 16-bit limbs (any integer dtype) → Python integers."""
    arr = np.ascontiguousarray(np.asarray(limbs, np.int64).astype(np.uint16))
    return [int.from_bytes(arr[i].tobytes(), "little") for i in range(arr.shape[0])]


class PlainField:
    """Arithmetic mod p on int64 limb-major tensors [16, n] of canonical
    16-bit limbs."""

    def __init__(self, p: int, device):
        self.p = p
        self.device = torch.device(device)
        self.p_limbs = self._const(p)
        self.m = (-pow(p, -1, 1 << 16)) % (1 << 16)  # −p^-1 mod 2^16
        self.r2 = self._const(pow(2, 512, p))  # R^2 mod p, R = 2^256

    def _const(self, v: int) -> torch.Tensor:
        return torch.tensor([(v >> (16 * j)) & MASK for j in range(16)], dtype=torch.int64,
                            device=self.device)[:, None]

    def _product(self, a, b) -> torch.Tensor:
        """Schoolbook a·b into 33 unnormalized limbs (each below 2^37)."""
        t = torch.zeros((33, a.shape[1]), dtype=torch.int64, device=a.device)
        for i in range(16):
            t[i:i + 16] += a[i] * b
        return t

    def _redc(self, t) -> torch.Tensor:
        """t·R^-1 mod p for t < p·R in 33 unnormalized limbs → [16, n]."""
        for i in range(16):
            m = (t[i] * self.m) & MASK
            t[i:i + 16] += m * self.p_limbs
            t[i + 1] += t[i] >> 16  # t[i] is now a multiple of 2^16
        u = t[16:]
        for j in range(16):
            u[j + 1] += u[j] >> 16
            u[j] &= MASK
        return self._below_p(u)  # u < 2p

    def _below_p(self, u) -> torch.Tensor:
        """u [17, n] normalized limbs, u < 2p → u mod p as [16, n]."""
        d = torch.empty_like(u)
        borrow = torch.zeros_like(u[0])
        for j in range(17):
            pj = self.p_limbs[j] if j < 16 else 0
            x = u[j] - pj - borrow
            borrow = (x < 0).to(torch.int64)
            d[j] = x + (borrow << 16)
        return torch.where(borrow.bool(), u, d)[:16]

    def mul(self, a, b) -> torch.Tensor:
        """a·b mod p: REDC(REDC(a·b)·R^2)."""
        return self._redc(self._product(self._redc(self._product(a, b)), self.r2.expand(-1, a.shape[1])))

    def add(self, a, b) -> torch.Tensor:
        u = torch.zeros((17, a.shape[1]), dtype=torch.int64, device=a.device)
        u[:16] = a + b
        for j in range(16):
            u[j + 1] += u[j] >> 16
            u[j] &= MASK
        return self._below_p(u)


class MinRoot(Circuit):
    """The step circuit's rows and variables: 0 is ONE, 1 x_0, 2 y_0, then
    (x_{i+1}, sq, quad) of each iteration."""

    def __init__(self, p: int, capacity: int, n_iters: int):
        super().__init__(p, capacity)
        self.n_iters = n_iters
        x_i, y_i = self._alloc_free(), self._alloc_free()
        for _ in range(n_iters):
            x_next = self._alloc_free()
            sq, quad = self._alloc(), self._alloc()
            self.enforce({x_next: 1}, {x_next: 1}, {sq: 1})
            self.enforce({sq: 1}, {sq: 1}, {quad: 1})
            self.enforce({quad: 1}, {x_next: 1}, {x_i: 1, y_i: 1})
            y_i, x_i = x_i, x_next
        # each free variable's offset in its chain window: x_0, y_0, then the advice
        self.free_offsets = [1, 0] + list(range(2, n_iters + 2))
        self.x_vars = [3 + 3 * i for i in range(n_iters)]  # x_1 .. x_N
        self.sq_vars = [4 + 3 * i for i in range(n_iters)]
        self.quad_vars = [5 + 3 * i for i in range(n_iters)]

    def _alloc_free(self) -> int:
        v = self._alloc()
        self.free.append(v)
        return v

    # -- advice --------------------------------------------------------------
    def chains(self, seed: int, n_chains: int, windows: int) -> list:
        """n_chains chains of n_iters + 1 + windows values, each grown down
        from two end values drawn from the seed."""
        p, length = self.p, self.n_iters + 1 + windows
        out = []
        for g in range(n_chains):
            rng = np.random.default_rng([seed, 0x3117, g])
            ends = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(2)]
            s = [0] * length
            s[-2], s[-1] = ends
            for k in range(length - 3, -1, -1):
                s[k] = (pow(s[k + 2], 5, p) - s[k + 1]) % p
            out.append(s)
        return out

    def chain_limbs(self, chains) -> np.ndarray:
        """The chains' values as uint16[G, L, 16] limbs."""
        return np.stack([limbs_of(c) for c in chains])

    def advice(self, chain_limbs: np.ndarray, instances, windows: int, device) -> torch.Tensor:
        """The free variables of the given instances (instance g·windows + o
        is chain g's window at offset o) as int64[n_free, 16, n]."""
        inst = np.asarray(instances, np.int64)
        pos = (inst % windows)[None, :] + np.asarray(self.free_offsets, np.int64)[:, None]
        vals = chain_limbs[(inst // windows)[None, :], pos]  # [n_free, n, 16]
        return torch.from_numpy(vals.astype(np.int64)).to(device).permute(0, 2, 1).contiguous()

    def plain_field(self, device) -> PlainField:
        return PlainField(self.p, device)

    def plant(self, z: torch.Tensor, var, deltas) -> None:
        """Add deltas[j] mod p to variable var[j] of instance j of z, in place."""
        for j, (v, d) in enumerate(zip(var, deltas)):
            (x,) = ints_of(z[int(v), :, j].cpu().numpy()[None])
            z[int(v), :, j] = torch.from_numpy(limbs_of([(x + d) % self.p]).astype(np.int64)[0])

    # -- witness and rows on the device ----------------------------------------
    def witness(self, advice: torch.Tensor, field: PlainField) -> torch.Tensor:
        """advice int64[n_free, 16, n] (the free variables' limbs in
        allocation order) → z int64[n_vars, 16, n]."""
        n = advice.shape[2]
        z = torch.zeros((self.n_vars, 16, n), dtype=torch.int64, device=advice.device)
        z[0, 0] = 1
        z[torch.tensor(self.free, device=advice.device)] = advice
        sq, quad = self.powers(advice[2:].transpose(0, 1).reshape(16, -1), field)  # of x_1 .. x_N
        k = torch.arange(self.n_iters, device=advice.device)
        z[4 + 3 * k] = sq.reshape(16, self.n_iters, n).transpose(0, 1)
        z[5 + 3 * k] = quad.reshape(16, self.n_iters, n).transpose(0, 1)
        return z

    def powers(self, x: torch.Tensor, field: PlainField):
        """x int64[16, n] → (x^2, x^4) mod p."""
        sq = field.mul(x, x)
        return sq, field.mul(sq, sq)

    def _terms(self, r0: int, r1: int):
        """Per side, per term position, (variables, coefficients or None
        where every one is 1) of rows r0..r1, padded with ONE × 0."""
        out = []
        for m in range(3):
            lcs = [sorted(row[m].items()) for row in self.rows[r0:r1]]
            side = []
            for t in range(max(len(lc) for lc in lcs)):
                terms = [lc[t] if t < len(lc) else (0, 0) for lc in lcs]
                coeffs = [c for _, c in terms]
                side.append((torch.tensor([v for v, _ in terms]),
                             None if all(c == 1 for c in coeffs) else limbs_of(coeffs).astype(np.int64)))
            out.append(side)
        return out

    def row_bad(self, z: torch.Tensor, field: PlainField, rows_per_block: int = 1 << 16) -> torch.Tensor:
        """bool[R, n]: the rows each instance (z int64[n_vars, 16, n])
        violates, every side summed and multiplied mod p."""
        n, dev = z.shape[2], z.device
        out = []
        for r0 in range(0, len(self.rows), rows_per_block):
            r1 = min(r0 + rows_per_block, len(self.rows))
            sides = []
            for side in self._terms(r0, r1):
                acc = torch.zeros((16, (r1 - r0) * n), dtype=torch.int64, device=dev)
                for var, coeff in side:
                    val = z.index_select(0, var.to(dev)).permute(1, 0, 2).reshape(16, -1)
                    if coeff is not None:
                        cf = torch.tensor(coeff, device=dev).t()[:, :, None].expand(-1, -1, n).reshape(16, -1)
                        val = field.mul(cf, val)
                    acc = field.add(acc, val)
                sides.append(acc)
            a, b, c = sides
            out.append((field.mul(a, b) != c).any(0).reshape(r1 - r0, n))
        return torch.cat(out)

    def verdict(self, z: torch.Tensor, instances, field: PlainField) -> tuple:
        """(n_bad, first) over the given instances, as the program reports
        a verdict; instances not given count as satisfying every row."""
        bad = self.row_bad(z, field).cpu().numpy()
        n_bad = int(bad.sum())
        if not n_bad:
            return 0, SENTINEL
        r, i = np.nonzero(bad)
        return n_bad, int((np.asarray(instances, np.int64)[i] * len(self.rows) + r).min())


def synthesize(p: int, capacity: int, n_iters: int = N_ITERS) -> MinRoot:
    return MinRoot(p, capacity, n_iters)
