"""The plain reference: bellpepper's bit gadgets, recorded as an R1CS and a
list of witness operations, the witness computed with plain PyTorch, and
an exact check of R1CS rows over chosen instances.

This module imports nothing of the program under test. It follows
bellpepper's gadget code (``crates/bellpepper-core/src/gadgets/boolean.rs``,
``crates/bellpepper/src/gadgets/{uint32,multieq}.rs``): the same
allocations and constraints in the same order, so variable k and row r
here are variable k and row r of a circuit that bellpepper synthesizes.

Variables: 0 is ONE, then every allocation in order. A linear combination
is a dict {variable: coefficient mod p}, terms of one variable merged as
bellpepper's ``LinearCombination`` merges them.

A Boolean is a pair (kind, x): (IS, v) the bit v, (NOT, v) its negation,
(CONST, 0 or 1) a constant. A UInt32 is a list of 32 Booleans, least
significant first.

Witness words: int32 tensors W[S, Bw], bit j of W[v, w] the value of
variable v in instance 32·w + j (the bit-sliced layout of the benchmark's
inputs)."""

from __future__ import annotations

import numpy as np
import torch

IS, NOT, CONST = 0, 1, 2
FALSE = (CONST, 0)
TRUE = (CONST, 1)
SENTINEL = 0xFFFFFFFF  # the verdict's `first` when no row is violated


def lc_of(bit, coeff: int = 1) -> dict:
    """A Boolean times `coeff` as a linear combination (boolean.rs:437-455)."""
    kind, x = bit
    if kind == CONST:
        return {0: coeff} if x else {}
    if kind == IS:
        return {x: coeff}
    return {0: coeff, x: -coeff}


def negate(bit):
    kind, x = bit
    if kind == CONST:
        return (CONST, 1 - x)
    return (NOT if kind == IS else IS, x)


class Circuit:
    """A constraint system that records rows and witness operations."""

    def __init__(self, p: int, capacity: int):
        self.p = p
        self.capacity = capacity
        self.n_vars = 1
        self.rows = []  # (a, b, c) linear combinations
        self.ops = []  # witness operations in allocation order
        self.free = []  # the free bits, in allocation order

    # -- recording --------------------------------------------------------
    def _alloc(self) -> int:
        self.n_vars += 1
        return self.n_vars - 1

    def enforce(self, a: dict, b: dict, c: dict) -> None:
        p = self.p
        self.rows.append(tuple({v: k % p for v, k in lc.items() if k % p} for lc in (a, b, c)))

    def _boolean_row(self, v: int) -> None:
        self.enforce({0: 1, v: -1}, {v: 1}, {})  # (1 - v) * v = 0

    def alloc_bit(self):
        """A free bit with its booleanity row (AllocatedBit::alloc)."""
        v = self._alloc()
        self._boolean_row(v)
        self.free.append(v)
        return (IS, v)

    def alloc_u32(self):
        return [self.alloc_bit() for _ in range(32)]

    # -- AllocatedBit ops (boolean.rs:101-272) ------------------------------
    def _bit_op(self, op: str, a: int, b: int) -> int:
        c = self._alloc()
        if op == "xor":  # (2a) * b = a + b - c
            self.enforce(_add({a: 1}, {a: 1}), {b: 1}, _add(_add({a: 1}, {b: 1}), {c: -1}))
        elif op == "and":  # a * b = c
            self.enforce({a: 1}, {b: 1}, {c: 1})
        elif op == "and_not":  # a * (1 - b) = c
            self.enforce({a: 1}, {0: 1, b: -1}, {c: 1})
        else:  # nor: (1 - a) * (1 - b) = c
            self.enforce({0: 1, a: -1}, {0: 1, b: -1}, {c: 1})
        self.ops.append((op, c, a, b))
        return c

    # -- Boolean ops (boolean.rs:472-533) -----------------------------------
    def xor(self, a, b):
        if a == FALSE:
            return b
        if b == FALSE:
            return a
        if a == TRUE:
            return negate(b)
        if b == TRUE:
            return negate(a)
        if a[0] != b[0]:  # a xor (not b) = not (a xor b)
            is_, not_ = (a, b) if a[0] == IS else (b, a)
            return negate(self.xor(is_, negate(not_)))
        return (IS, self._bit_op("xor", a[1], b[1]))

    def and_(self, a, b):
        if a == FALSE or b == FALSE:
            return FALSE
        if a == TRUE:
            return b
        if b == TRUE:
            return a
        if a[0] == IS and b[0] == NOT:
            return (IS, self._bit_op("and_not", a[1], b[1]))
        if a[0] == NOT and b[0] == IS:
            return (IS, self._bit_op("and_not", b[1], a[1]))
        if a[0] == NOT:
            return (IS, self._bit_op("nor", a[1], b[1]))
        return (IS, self._bit_op("and", a[1], b[1]))

    def ch(self, a, b, c):
        """(a and b) xor ((not a) and c) (boolean.rs:536-641)."""
        if a[0] == b[0] == c[0] == CONST:
            return (CONST, (a[1] & b[1]) ^ ((1 - a[1]) & c[1]))
        if a == FALSE:
            return c
        if b == FALSE:
            return self.and_(negate(a), c)
        if c == FALSE:
            return self.and_(a, b)
        if c == TRUE:
            return negate(self.and_(a, negate(b)))
        if b == TRUE:
            return negate(self.and_(negate(a), negate(c)))
        v = self._alloc()
        # (b - c) * a = ch - c
        self.enforce(_add(lc_of(b), lc_of(c, -1)), lc_of(a), _add({v: 1}, lc_of(c, -1)))
        self.ops.append(("ch", v, a, b, c))
        return (IS, v)

    def maj(self, a, b, c):
        """(a and b) xor (a and c) xor (b and c) (boolean.rs:644-759)."""
        if a[0] == b[0] == c[0] == CONST:
            return (CONST, (a[1] & b[1]) ^ (a[1] & c[1]) ^ (b[1] & c[1]))
        if a == FALSE:
            return self.and_(b, c)
        if b == FALSE:
            return self.and_(a, c)
        if c == FALSE:
            return self.and_(a, b)
        if c == TRUE:
            return negate(self.and_(negate(a), negate(b)))
        if b == TRUE:
            return negate(self.and_(negate(a), negate(c)))
        if a == TRUE:
            return negate(self.and_(negate(b), negate(c)))
        v = self._alloc()
        bc = self.and_(b, c)
        # (2bc - b - c) * a = bc - maj
        self.enforce(_add(_add(lc_of(bc, 2), lc_of(b, -1)), lc_of(c, -1)), lc_of(a),
                     _add(lc_of(bc), {v: -1}))
        self.ops.append(("maj", v, a, b, c))
        return (IS, v)

    # -- UInt32 (uint32.rs) ---------------------------------------------------
    def xor32(self, x, y):
        return [self.xor(a, b) for a, b in zip(x, y)]

    def ch32(self, x, y, z):
        return [self.ch(a, b, c) for a, b, c in zip(x, y, z)]

    def maj32(self, x, y, z):
        return [self.maj(a, b, c) for a, b, c in zip(x, y, z)]

    def addmany(self, meq: "MultiEq", operands):
        """The sum mod 2^32 of 2 to 10 words (uint32.rs:304-406): result
        bits as wide as the largest sum, each with its booleanity row, and
        one equality handed to the MultiEq."""
        max_value = len(operands) * 0xFFFFFFFF
        if all(b[0] == CONST for w in operands for b in w):
            return const32(sum(value_of_const32(w) for w in operands))
        lhs = {}
        for w in operands:
            for i, b in enumerate(w):
                lhs = _add(lhs, lc_of(b, 1 << i))
        outs = []
        rhs = {}
        n = max_value.bit_length()
        for i in range(n):
            v = self._alloc()
            self._boolean_row(v)
            outs.append(v)
            rhs[v] = 1 << i
        meq.enforce_equal(n, lhs, rhs)
        self.ops.append(("addmany", outs, [list(w) for w in operands]))
        return [(IS, v) for v in outs[:32]]


class MultiEq:
    """Batched equalities, one row `lhs * 1 = rhs` each time the next
    equality would pass the field's capacity (multieq.rs:25-67)."""

    def __init__(self, cs: Circuit):
        self.cs = cs
        self.bits_used = 0
        self.lhs, self.rhs = {}, {}

    def _flush(self) -> None:
        self.cs.enforce(self.lhs, {0: 1}, self.rhs)
        self.bits_used = 0
        self.lhs, self.rhs = {}, {}

    def enforce_equal(self, num_bits: int, lhs: dict, rhs: dict) -> None:
        if self.cs.capacity <= self.bits_used + num_bits:
            self._flush()
        k = 1 << self.bits_used
        self.lhs = _add(self.lhs, {v: c * k for v, c in lhs.items()})
        self.rhs = _add(self.rhs, {v: c * k for v, c in rhs.items()})
        self.bits_used += num_bits

    def finish(self) -> None:
        if self.bits_used:
            self._flush()


def _add(x: dict, y: dict) -> dict:
    out = dict(x)
    for v, c in y.items():
        out[v] = out.get(v, 0) + c
    return out


def const32(value: int):
    return [(CONST, (value >> i) & 1) for i in range(32)]


def value_of_const32(word) -> int:
    return sum(b[1] << i for i, b in enumerate(word))


def rotr(word, n: int):
    return [word[(i + n) % 32] for i in range(32)]


def shr(word, n: int):
    return list(word[n:]) + [FALSE] * n


# -- the witness, on any device ------------------------------------------------
def _operand(bit):
    """A Boolean as (variable, AND mask, XOR mask): value = (W[v] & am) ^ xm."""
    kind, x = bit
    if kind == CONST:
        return 0, 0, -x
    return x, -1, -1 if kind == NOT else 0


def _runs(ops):
    """Consecutive operations of one kind that read nothing another of
    them writes, so that each run computes as a few tensor operations."""
    runs = []
    for op in ops:
        if op[0] == "addmany":
            runs.append((op[0], [op]))
            continue
        reads = {op[2], op[3]} if op[0] in ("xor", "and", "and_not", "nor") else {b[1] for b in op[2:] if b[0] != CONST}
        if runs and runs[-1][0] == op[0] and not reads & runs[-1][2]:
            runs[-1][1].append(op)
            runs[-1][2].add(op[1])
        else:
            runs.append((op[0], [op], {op[1]}))
    return [(r[0], r[1]) for r in runs]


class WitnessProgram:
    """The circuit's witness operations as tables on `device`."""

    def __init__(self, cs: Circuit, device):
        self.n_vars = cs.n_vars
        self.free = torch.tensor(cs.free, dtype=torch.int64, device=device)
        self.steps = []
        dev = device
        for kind, ops in _runs(cs.ops):
            if kind == "addmany":
                (_, outs, words), = ops
                tab = np.asarray([[_operand(b) for b in w] for w in words], np.int64)  # [K, 32, 3]
                self.steps.append((kind, torch.tensor(outs, dtype=torch.int64, device=dev),
                                   torch.tensor(tab, device=dev)))
            elif kind in ("xor", "and", "and_not", "nor"):
                arr = torch.tensor([op[1:] for op in ops], dtype=torch.int64, device=dev)
                self.steps.append((kind, arr[:, 0], arr[:, 1:]))
            else:
                tab = np.asarray([[_operand(b) for b in op[2:]] for op in ops], np.int64)  # [n, 3, 3]
                outs = torch.tensor([op[1] for op in ops], dtype=torch.int64, device=dev)
                self.steps.append((kind, outs, torch.tensor(tab, device=dev)))

    @staticmethod
    def _gather(W, tab):
        """Boolean operand words for a table [..., 3] of (v, am, xm)."""
        v = W.index_select(0, tab[..., 0].reshape(-1)).reshape(tab.shape[:-1] + (W.shape[1],))
        am = tab[..., 1, None].to(torch.int32)
        xm = tab[..., 2, None].to(torch.int32)
        return (v & am) ^ xm

    def __call__(self, free_words: torch.Tensor) -> torch.Tensor:
        """free_words int32[n_free, Bw] → W int32[S, Bw]."""
        Bw = free_words.shape[1]
        W = torch.zeros((self.n_vars, Bw), dtype=torch.int32, device=free_words.device)
        W[0] = -1
        W[self.free] = free_words
        for kind, outs, tab in self.steps:
            if kind == "addmany":
                r = _sum_words(self._gather(W, tab), outs.shape[0])
            elif kind in ("xor", "and", "and_not", "nor"):
                a = W.index_select(0, tab[:, 0])
                b = W.index_select(0, tab[:, 1])
                r = {"xor": lambda: a ^ b, "and": lambda: a & b,
                     "and_not": lambda: a & ~b, "nor": lambda: ~(a | b)}[kind]()
            else:
                x = self._gather(W, tab)
                a, b, c = x[:, 0], x[:, 1], x[:, 2]
                r = (a & b) ^ (~a & c) if kind == "ch" else (a & b) ^ (a & c) ^ (b & c)
            W[outs] = r
        return W


def _sum_words(planes: torch.Tensor, n_out: int) -> torch.Tensor:
    """planes int32[K, 32, Bw] (bit i of K words, bit-sliced) → the n_out
    low bits of each instance's integer sum, as int32[n_out, Bw] words."""
    lanes = torch.arange(32, dtype=torch.int64, device=planes.device)
    total = torch.zeros((planes.shape[2], 32), dtype=torch.int64, device=planes.device)
    for word in planes:  # [32, Bw]: per instance, Σ bit_i · 2^i
        bits = (word.to(torch.int64)[:, :, None] >> lanes) & 1  # [32 bits, Bw, 32 lanes]
        total += (bits << lanes[:, None, None]).sum(0)
    k = torch.arange(n_out, dtype=torch.int64, device=planes.device)
    out_bits = (total[None] >> k[:, None, None]) & 1  # [n_out, Bw, 32 lanes]
    return to_int32((out_bits << lanes).sum(-1))


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → int32 words with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def instance_bits(W: torch.Tensor, instances) -> torch.Tensor:
    """The 0/1 values of every variable in the given instances: int64[S, n]
    on the CPU."""
    inst = torch.as_tensor(np.asarray(instances, np.int64), device=W.device)
    words = W.index_select(1, inst // 32).to(torch.int64)
    return ((words >> (inst % 32)) & 1).cpu()


# -- the exact check -------------------------------------------------------------
class RowChecker:
    """A·z ∘ B·z = C·z of every row, exact: each coefficient in its signed
    form below p/2 in magnitude, split into 32-bit limbs, so that each
    limb's sum over 0/1 values is an exact int64; rows whose sides stay
    below 2^31 compare as int64 (their product differs from C·z by less
    than p unless it equals it), the others as Python integers mod
    `modulus` (p; 2^64 for the control)."""

    def __init__(self, cs: Circuit, modulus: int | None = None):
        self.p = cs.p
        self.modulus = cs.p if modulus is None else modulus
        self.R = len(cs.rows)
        self.sides = []
        big = np.zeros(self.R, bool)
        for m in range(3):
            rows, cols, limbs = [], [], []
            for r, row in enumerate(cs.rows):
                for v, c in row[m].items():
                    s = c if c <= self.p // 2 else c - self.p
                    mag, sign = abs(s), 1 if s >= 0 else -1
                    ls = [sign * ((mag >> (32 * j)) & 0xFFFFFFFF) for j in range(8)]
                    rows.append(r)
                    cols.append(v)
                    limbs.append(ls)
                    if mag >= 1 << 16:
                        big[r] = True
            limbs = np.asarray(limbs, np.int64).reshape(-1, 8)
            used = [j for j in range(8) if limbs.shape[0] and limbs[:, j].any()]
            self.sides.append((torch.tensor(rows, dtype=torch.int64), torch.tensor(cols, dtype=torch.int64),
                               torch.from_numpy(limbs), used))
        self.big = big

    def _limb_sums(self, Z: torch.Tensor):
        """Z int64[S, n] → per side, {limb j: int64[R, n]}."""
        out = []
        for rows, cols, limbs, used in self.sides:
            zc = Z.index_select(0, cols)
            sums = {}
            for j in used:
                s = torch.zeros((self.R, Z.shape[1]), dtype=torch.int64)
                s.index_add_(0, rows, limbs[:, j, None] * zc)
                sums[j] = s
            out.append(sums)
        return out

    def bad(self, Z: torch.Tensor) -> np.ndarray:
        """bool[R, n]: the rows each instance (a column of Z) violates."""
        sums = [{j: t.numpy() for j, t in s.items()} for s in self._limb_sums(Z)]
        zero = np.zeros((self.R, Z.shape[1]), np.int64)
        a0, b0, c0 = (s.get(0, zero) for s in sums)
        wide = self.big.copy()
        for s in sums:
            for j, t in s.items():
                if j:
                    wide |= (t != 0).any(1)
        wide |= ~((np.abs(a0) < 1 << 31) & (np.abs(b0) < 1 << 31) & (np.abs(c0) < 1 << 62)).all(1)
        bad = a0 * b0 != c0
        for r in np.nonzero(wide)[0]:
            a, b, c = (sum((t[r].astype(object) << (32 * j) for j, t in s.items()), np.zeros(Z.shape[1], object))
                       for s in sums)
            bad[r] = (a * b - c) % self.modulus != 0
        return bad

    def verdict(self, Z: torch.Tensor, instances) -> tuple:
        """(n_bad, first) over the given instances, first the least b·R +
        row of a violated row (SENTINEL when none), as the program reports
        a verdict; instances not given count as satisfying every row."""
        bad = self.bad(Z)
        n_bad = int(bad.sum())
        if not n_bad:
            return 0, SENTINEL
        r, i = np.nonzero(bad)
        inst = np.asarray(instances, np.int64)[i]
        return n_bad, int((inst * self.R + r).min())


def canonical_rows(cs: Circuit):
    """Each row as three sorted tuples of (variable, coefficient mod p)."""
    return [tuple(tuple(sorted(lc.items())) for lc in row) for row in cs.rows]
