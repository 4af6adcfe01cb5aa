"""The field kernels of the port: wrappers, plain versions, counts.

Counterparts of the ``bellpepper_tpu/backend/field_pallas.py`` kernels on
the ported paths, each a CUDA kernel in ``csrc/``:

  ============================  ==========================================
  wrapper                       replaces (field_pallas.py)
  ============================  ==========================================
  ``bitplane_eq``               ``make_bitplane_eq_kernel`` (:489)
  ``bits_matvec_semi``          ``make_fold_matvec_bucket`` (:828) via
                                ``make_bits_matvec_bucket(out_form="semi")``
  ``bits_matvec_canonical``     the same, ``out_form="canonical"`` (fields
                                below 250 bits)
  ``mulcmp``                    ``make_mulcmp`` (:1009)
  ``chain``                     ``make_chain_kernel`` (:407)
  ``mul`` (``pow_ladder``: a     ``PallasFieldOps.mul`` → ``_mul_kernel``
  loop of its launches)         (:704, :727)
  ``limbs_matvec``              ``make_fold_matvec_bucket`` (:828) via
                                ``make_limbs_matvec_bucket`` (:975), both
                                output forms
  ``mul_digits``                ``PallasFieldOps.mul_digits`` →
                                ``_mul_digits_kernel`` (:711)
  ``reduce_digits``             ``PallasFieldOps.reduce_digits`` →
                                ``_reduce_kernel`` (:720)
  ``verdict_fold``              no Pallas kernel: the jnp fold of
                                ``matvec.py`` ``verdict_packed`` (:3002),
                                which XLA fuses into one reduction
  ``operand_mulcmp``            no Pallas kernel: the jnp operand assembly
                                of the trivial product rows (``matvec.py``
                                ``_operand_spec``, :1686), which XLA fuses,
                                feeding ``make_mulcmp``
  ``addmany``                   no Pallas kernel: the jnp CSA layers and
                                prefix add of the packed evaluator's
                                addmany stage (``witness_program.py``
                                ``_build_packed_impl``, :1245), which XLA
                                fuses
  ============================  ==========================================

``bits_matvec_semi``, ``bits_matvec_canonical`` and ``limbs_matvec``
launch one CUDA kernel (``csrc/fold_matvec.cu``) and count apart, so each
form shows on its path. They and ``bitplane_eq`` read the witness through
a table of slots (−1 for an empty entry) and gather inside the kernel;
their plain versions gather first.

Every wrapper checks device, dtype, shape and contiguity, then runs its
plain PyTorch version when the inputs lie on the CPU, or launches its CUDA
kernel on the current stream when they lie on a CUDA device (it never
falls back), and counts that launch in ``<wrapper>.launches``. Words are
int32 tensors holding uint32 bit patterns (see ``words``); the plain
versions compute in int64 and mask with 2^32 - 1 wherever the TPU
kernels rely on uint32 wraparound, so they are bit-exact against both
the Pallas kernels and the CUDA ones. ``mulcmp`` is the one exception:
it returns the 0/1 mask of the Pallas kernel's nonzero word, since the
CUDA kernel computes in 32-bit words, not the TPU's fold integers.

The row helpers below (``_conv16_rows`` … ``_add_canon_rows``) are the
torch versions of the Pallas kernels' row pipeline: a "row" is an int64
tensor holding one limb or digit position of every element."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..fields import PrimeField
from .cuda_lib import load_kernels
from .field_consts import L8, L16, SEMI, _digits, consts_for, kernel_consts
from .words import FULL, U32, ctz32, popcount32, to_i32, to_u32, unpack_rows

KERNELS = ("bitplane_eq", "bits_matvec_semi", "mulcmp", "chain", "mul",
           "limbs_matvec", "mul_digits", "reduce_digits", "bits_matvec_canonical", "verdict_fold",
           "operand_mulcmp", "addmany")


def _on_cuda(*ts: torch.Tensor) -> bool:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel for device {dev}")


def _check_words(name: str, t: torch.Tensor, shape=None) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 words, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")


def _launch(fn, *args, stream) -> None:
    err = getattr(load_kernels(), fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError {err}")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def reset_launch_counts() -> None:
    for name in KERNELS:
        globals()[name].launches = 0


def launch_counts() -> dict:
    return {name: globals()[name].launches for name in KERNELS}


# ---------------------------------------------------------------------------
# Kernel 2: bit-plane integer equality
# ---------------------------------------------------------------------------
def padded_positions(n_pos: int) -> int:
    """n_pos rounded up to a power of two (at least 8), the kernel's P."""
    P = 8
    while P < n_pos:
        P *= 2
    return P


def _aligned16(t: torch.Tensor, row_words: int) -> int:
    """1 where the kernels may copy t's rows in 16-byte pieces."""
    return int(t.data_ptr() % 16 == 0 and row_words % 4 == 0)


def bitplane_eq(vals_p: torch.Tensor, planes: torch.Tensor, n: int, P: int, m_a: int, m_c: int) -> torch.Tensor:
    """Packed slot-major words vals_p int32[S, Bw] and a plane table
    planes int32[(m_a + m_c)·P·n] (entry (k·P + e)·n + i: the slot of
    addend k's plane for exponent e of row i, addends k < m_a on the A
    side, the others on the C side; −1 for an empty plane, which reads as
    zero words; every other entry must be a slot below S) → bad
    int32[n, Bw]: bit j of word (i, w) set iff Σ 2^e·A-bits ≢ Σ 2^e·C-bits
    (mod 2^P) for instance 32·w + j of row i."""
    if vals_p.dim() != 2:
        raise ValueError("vals_p must be [S, Bw]")
    _check_words("vals_p", vals_p)
    _check_words("planes", planes, ((m_a + m_c) * P * n,))
    if P < 8 or P & (P - 1):
        raise ValueError(f"P must be a power of two >= 8, got {P}")
    if m_a + m_c + 1 > 31:
        raise ValueError("bitplane_eq supports m_a + m_c <= 30 addends")
    if not _on_cuda(vals_p, planes):
        return bitplane_eq_plain(vals_p, planes, n, P, m_a, m_c)
    Bw = vals_p.shape[1]
    bad = torch.empty((n, Bw), dtype=torch.int32, device=vals_p.device)
    if n and Bw:
        if n * -(-Bw // 32) >= 1 << 31:
            raise ValueError(f"{n} rows × {Bw} words exceed the kernel's grid")
        _launch("bp_bitplane_eq", vals_p.data_ptr(), planes.data_ptr(), bad.data_ptr(), n, Bw, P,
                m_a, m_c, _aligned16(vals_p, Bw), stream=_stream(vals_p))
        bitplane_eq.launches += 1
    return bad


def bitplane_eq_plain(vals_p: torch.Tensor, planes: torch.Tensor, n: int, P: int, m_a: int, m_c: int) -> torch.Tensor:
    """Plain version: ONE gather of every plane (an empty one from an
    appended zero row), then ``_bitplane_planes_plain`` over W = n·Bw
    columns."""
    S, Bw = vals_p.shape
    vz = torch.cat([vals_p, torch.zeros_like(vals_p[:1])], dim=0)
    g = vz.index_select(0, torch.where(planes < 0, S, planes).to(torch.int64))
    A = g[: m_a * P * n].reshape(m_a * P, n * Bw)
    C = g[m_a * P * n :].reshape(m_c * P, n * Bw)
    return _bitplane_planes_plain(A, C, P, m_a, m_c).reshape(n, Bw)


def _bitplane_planes_plain(A: torch.Tensor, C: torch.Tensor, P: int, m_a: int, m_c: int) -> torch.Tensor:
    """A int32[m_a·P, W], C int32[m_c·P, W] exponent planes (addend k's
    plane for exponent e is row k·P + e) → bad int32[W], as the Pallas
    kernel computes it: its carry-save reduction to two vectors x, y and
    its position-local carry rule (k == sh(maj(x, y, k)), or the
    two's-complement form k == sh(x | y) when m_c > 1)."""
    W = A.shape[1]

    def shpos(x, d=1):  # row e of the result is x[e - d]
        return torch.cat([torch.zeros_like(x[:d]), x[: P - d]], dim=0)

    def csa2(addends):
        while len(addends) > 2:
            nxt = []
            for i in range(0, len(addends) - 2, 3):
                a1, b1, c1 = addends[i : i + 3]
                nxt.append(a1 ^ b1 ^ c1)
                nxt.append(shpos((a1 & b1) | (c1 & (a1 ^ b1))))
            rem = len(addends) % 3
            if rem:
                nxt.extend(addends[-rem:])
            addends = nxt
        if len(addends) == 1:
            addends.append(torch.zeros_like(addends[0]))
        return addends

    addends = [A[k * P : (k + 1) * P] for k in range(m_a)]
    if m_c == 1:
        x, y = csa2(addends)
        k = x ^ y ^ C
        bad = k ^ shpos((x & y) | (k & (x | y)))
    else:
        addends += [~C[k * P : (k + 1) * P] for k in range(m_c)]
        mc_plane = torch.zeros((P, W), dtype=torch.int32, device=A.device)
        for e in range(m_c.bit_length()):
            if (m_c >> e) & 1:
                mc_plane[e] = FULL
        addends.append(mc_plane)
        x, y = csa2(addends)
        k = x ^ y
        bad = k ^ shpos(x | y)
    r, kk = bad, P
    while kk > 1:
        kk //= 2
        r = r[:kk] | r[kk : 2 * kk]
    return r[0].contiguous()


bitplane_eq.launches = 0


# ---------------------------------------------------------------------------
# Shared plain helpers: rows are int64 tensors holding uint32 values.
# ---------------------------------------------------------------------------
def _carry_rows(rows: List[torch.Tensor], n_out: int, bits: int) -> List[torch.Tensor]:
    """field_pallas._carry8_rows / _carry16_rows in uint32 arithmetic."""
    mask = (1 << bits) - 1
    out = []
    carry = None
    for i in range(n_out):
        limb = rows[i] if i < len(rows) else None
        if limb is None and carry is None:
            out.append(torch.zeros_like(rows[0]))
            continue
        tot = limb if carry is None else (carry if limb is None else (limb + carry) & U32)
        out.append(tot & mask)
        carry = tot >> bits
    return out


def _mac_rows(acc: List[torch.Tensor], m: torch.Tensor, row: List[int]) -> None:
    """acc[l] += m·row[l] (uint32), skipping zero constants."""
    for l, c in enumerate(row):
        if c:
            acc[l] = (acc[l] + m * c) & U32


def _semi_reduce_rows(digit_rows: List[torch.Tensor], consts) -> List[torch.Tensor]:
    """field_pallas._semi_reduce_rows: 32 digit sums → 17 semi limbs."""
    d = _carry_rows(digit_rows, 36, 8)
    out = list(d[:32])
    for i in range(4):
        _mac_rows(out, d[32 + i], consts.fold[i])
    d2 = _carry_rows(out, 34, 8)
    x16 = [d2[2 * i] | (d2[2 * i + 1] << 8) for i in range(16)]
    x16.append(d2[32] | (d2[33] << 8))
    return x16


def _mont_zero_rows(x: List[torch.Tensor], consts) -> torch.Tensor:
    """field_pallas._mont_zero_rows: 0 iff the 17-limb x ≡ 0 (mod p).
    Precondition x < 2^16·p (the quotient must fit 16 bits); every value
    below 2^266 meets it for p ≥ 2^250."""
    mh = (x[0] * consts.p0inv) & 0xFFFF
    bad = torch.zeros_like(x[0])
    carry = torch.zeros_like(x[0])
    for i in range(17):
        if i < L16:
            t = mh * consts.p16[i]
            lo, hi = t & 0xFFFF, t >> 16
        else:
            lo = hi = 0
        tot = lo + carry
        bad = bad | ((tot & 0xFFFF) ^ x[i])
        carry = (tot >> 16) + hi
    return bad


def _fold8_rows(d: List[torch.Tensor], consts) -> List[torch.Tensor]:
    """field_pallas._fold_rows: the low 32 digits plus Σ_i d[32+i]·fold[i].
    The digits are below 2^8 after a carry, so every sum is below 2^22 and
    a float64 matmul is exact."""
    n = len(d) - L8
    hi = torch.stack(d[L8:])
    shape = hi.shape[1:]
    table = _table(_p_of(consts), f"fold8_{n}", consts.fold[:n], hi.device)  # [n, 32]
    add = torch.matmul(table.t().to(torch.float64), hi.reshape(n, -1).to(torch.float64))
    add = add.to(torch.int64).reshape((L8,) + tuple(shape))
    return [d[l] + add[l] for l in range(L8)]


def _reduce_rows(digit_rows: List[torch.Tensor], consts) -> List[torch.Tensor]:
    """field_pallas._reduce_rows: 32 digit sums (8-bit basis, < 2^32) →
    16 canonical limbs: carry to 66 positions, fold, carry, fold, carry,
    join digit pairs (17 limbs, a value below 2^265 for every field),
    then ``_canon_rows`` where the TPU runs its shift-subtract chain
    (_chain_rows, 266 − NUM_BITS steps: 202 for Goldilocks); the
    canonical residue is unique, so the bits are the same."""
    d = _carry_rows(digit_rows, 66, 8)
    f1 = _carry_rows(_fold8_rows(d, consts), 34, 8)
    f2 = _carry_rows(_fold8_rows(f1, consts), 34, 8)
    return _canon_rows([f2[2 * i] | (f2[2 * i + 1] << 8) for i in range(17)], consts)


def _canon_rows(x: List[torch.Tensor], consts) -> List[torch.Tensor]:
    """x, int64 rows of 16-bit limbs (17 here; any count below 19 works)
    → its 16 canonical limbs mod any odd p < 2^256 (those past L zero).
    The limbs at and above L = ceil(NUM_BITS/16) fold by 2^(16·i) mod p
    (one float64 matmul, exact: every sum is below 2^37) and carry to L + 2
    limbs, x' < 2^(16L) + 17·2^16·p ≤ 18·2^16·p (2^(16L) ≤ 2^16·p); the
    estimate q̂ = floor(h·mu/2^31) of h = x' >> s < 2^30, s = max(0,
    NUM_BITS − 9), mu = floor(2^(s+31)/p), satisfies q − 1 ≤ q̂ ≤ q (q −
    q̂ < 2^s/p + h/2^31 + 1 < 1.51); then x' − q̂·p < 2p by one signed
    carry chain, and one conditional subtract of p."""
    p = _p_of(consts)
    n = p.bit_length()
    L = -(-n // 16)
    low = list(x[:L]) + [torch.zeros_like(x[0])] * (L - min(L, len(x)))
    hi = x[L:]
    if hi:
        table = _table(p, f"canon_fold_{len(hi)}",
                       [_digits(pow(2, 16 * (L + i), p), 16, L) for i in range(len(hi))], hi[0].device)
        h = torch.stack(hi)
        add = torch.matmul(table.t().to(torch.float64), h.reshape(len(hi), -1).to(torch.float64))
        add = add.to(torch.int64).reshape((L,) + tuple(h.shape[1:]))
        low = [low[l] + add[l] for l in range(L)]
    xs, _ = _signed_carry(torch.stack(low + [torch.zeros_like(low[0])] * 2))
    s = max(0, n - 9)
    i0, r = s // 16, s % 16
    h = (xs[i0] | (xs[i0 + 1] << 16) | (xs[i0 + 2] << 32)) >> r
    qh = (h * ((1 << (s + 31)) // p)) >> 31
    pl = _table(p, f"p{L + 2}", _digits(p, 16, L + 2), qh.device).reshape((L + 2,) + (1,) * qh.dim())
    out, _ = _signed_carry(torch.stack(xs) - qh.unsqueeze(0) * pl)
    out = _cond_sub_rows(out, _digits(p, 16, L + 2))[:L]
    return out + [torch.zeros_like(out[0])] * (L16 - L)


# ---------------------------------------------------------------------------
# Kernel 4: the fold matvec, in its bits form (semi output) and its limbs
# form (semi or canonical output). The kernel gathers its own witness
# through the bucket's column table (int32[n_rows, K], −1 for an empty
# entry, which reads as zero), so no gathered copy exists; the fold planes
# are bytes in the kernel's operand layout (``fold_operand``).
# ---------------------------------------------------------------------------
def fold_operand(planes: np.ndarray) -> np.ndarray:
    """Fold planes u32[32, n_rows, C] (each below 256; digit d of the
    weight of contraction column c at [d, r, c]) → the kernel's operand
    uint8[n_rows, 32, Cp]: K-major, Cp = C rounded up to 32, zero
    padded."""
    d, n_rows, C = planes.shape
    if d != L8 or (planes.size and planes.max() > 0xFF):
        raise ValueError("fold planes must be [32, n_rows, C] of values below 256")
    out = np.zeros((n_rows, L8, -(-C // 32) * 32), np.uint8)
    out[:, :, :C] = planes.transpose(1, 0, 2)
    return out


def _check_matvec(w: torch.Tensor, cols: torch.Tensor, F: torch.Tensor, per_entry: int) -> None:
    """Checks of the fold matvecs' inputs; an entry spans per_entry
    contraction columns (1 bit, or 32 digits)."""
    _check_words("cols", cols)
    if cols.dim() != 2:
        raise ValueError("cols must be [n_rows, K]")
    n_rows, C = cols.shape[0], per_entry * cols.shape[1]
    _check_words("witness", w)
    if F.dtype != torch.uint8 or not F.is_contiguous():
        raise TypeError(f"F must be contiguous uint8 fold planes, got {F.dtype}")
    if tuple(F.shape) != (n_rows, L8, -(-C // 32) * 32):
        raise ValueError(f"F must have shape {(n_rows, L8, -(-C // 32) * 32)}, got {tuple(F.shape)}")
    if C * 255 * 255 >= (1 << 32):
        raise ValueError(f"contraction width {C} overflows the digit sums")


def _fold_matvec(wrapper, w, cols, F, B: int, row_words: int, field, bits: bool, canonical: bool) -> torch.Tensor:
    """Launch bp_fold_matvec for inputs that lie on the card."""
    n_rows, K = cols.shape
    if n_rows * -(-B // _MATVEC_TB) >= 1 << 31:
        raise ValueError(f"{n_rows} rows × batch {B} exceed the kernel's grid")
    if F.data_ptr() % 16:
        raise ValueError("F must be 16-byte aligned")
    k = kernel_consts(field)["reduce"]
    out = torch.empty((L16 if canonical else SEMI, n_rows, B), dtype=torch.int32, device=w.device)
    if n_rows and B:
        _launch("bp_fold_matvec", w.data_ptr(), cols.data_ptr(), F.data_ptr(), out.data_ptr(), n_rows, K,
                F.shape[2], B, row_words, int(bits), int(canonical), _aligned16(w, row_words),
                k.ctypes.data, stream=_stream(w))
        wrapper.launches += 1
    return out


_MATVEC_TB = 64  # csrc/fold_matvec.cu kTB: the instances of one block


def _live(cols: torch.Tensor) -> torch.Tensor:
    return (cols >= 0).reshape(-1)


def _gather_bits(vals_p: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """x int32[n_rows, K, 32·Bw] of 0/1: bit b of entry (r, e)'s slot,
    zero for an empty entry."""
    n_rows, K = cols.shape
    g = vals_p.index_select(0, cols.clamp(min=0).reshape(-1).to(torch.int64))
    g = torch.where(_live(cols)[:, None], g, 0)
    return unpack_rows(g).reshape(n_rows, K, -1)


def _gather_digits(zt: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """x int32[n_rows, 32K, B]: digit j of entry (r, e)'s slot at column
    32e + j (the two bytes of each 16-bit limb), zero for an empty
    entry."""
    n_rows, K = cols.shape
    g = zt.index_select(0, cols.clamp(min=0).reshape(-1).to(torch.int64))
    g = torch.where(_live(cols)[:, None, None], g, 0)  # [n_rows·K, 16, B]
    return torch.stack([g & 0xFF, (g >> 8) & 0xFF], dim=2).reshape(n_rows, K * L8, -1)


def _digit_sums(x: torch.Tensor, F: torch.Tensor) -> List[torch.Tensor]:
    """The 32 exact digit sums Σ_c F[r, d, c]·x[r, c, b] as int64 rows
    [n_rows, B], through a float64 matmul (every partial sum is an integer
    below 2^32, exact in float64)."""
    acc = torch.matmul(F[:, :, : x.shape[1]].to(torch.float64), x.to(torch.float64))  # [n_rows, 32, B]
    return [acc[:, d].to(torch.int64) for d in range(L8)]


def _reduce_sums(rows: List[torch.Tensor], field: PrimeField, canonical: bool) -> torch.Tensor:
    consts = consts_for(field)
    return to_i32(torch.stack(_reduce_rows(rows, consts) if canonical else _semi_reduce_rows(rows, consts)))


def bits_matvec_semi(vals_p: torch.Tensor, cols: torch.Tensor, F: torch.Tensor, field: PrimeField) -> torch.Tensor:
    """Packed slot-major words vals_p int32[S, Bw], a bucket's column
    table cols int32[n_rows, K] (slots below S, −1 for an empty entry) and
    its coefficients' digit planes F uint8[n_rows, 32, Cp]
    (``fold_operand``) → int32[17, n_rows, 32·Bw] semi-reduced limbs of
    Σ_e coeff_e·bit_b(vals_p[cols[r, e]]) (a value < 2^265 congruent mod
    p)."""
    if vals_p.dim() != 2:
        raise ValueError("vals_p must be [S, Bw]")
    _check_matvec(vals_p, cols, F, 1)
    if not _on_cuda(vals_p, cols, F):
        return bits_matvec_semi_plain(vals_p, cols, F, field)
    Bw = vals_p.shape[1]
    return _fold_matvec(bits_matvec_semi, vals_p, cols, F, 32 * Bw, Bw, field, True, False)


def bits_matvec_semi_plain(vals_p: torch.Tensor, cols: torch.Tensor, F: torch.Tensor, field: PrimeField) -> torch.Tensor:
    """Plain version: the gather of the entries' bits, the exact digit
    sums, then the semi reduction."""
    n_rows, B = cols.shape[0], 32 * vals_p.shape[1]
    if n_rows == 0 or B == 0:
        return torch.zeros((SEMI, n_rows, B), dtype=torch.int32, device=vals_p.device)
    return _reduce_sums(_digit_sums(_gather_bits(vals_p, cols), F), field, False)


bits_matvec_semi.launches = 0


def bits_matvec_canonical(vals_p: torch.Tensor, cols: torch.Tensor, F: torch.Tensor,
                          field: PrimeField) -> torch.Tensor:
    """``bits_matvec_semi``'s inputs → int32[16, n_rows, 32·Bw] canonical
    limbs of Σ_e coeff_e·bit_b(vals_p[cols[r, e]]) mod p: the bits form's
    output below 250 bits, where p·2^11 does not bound the semi values and
    the check compares ``mul``'s canonical products instead of ``mulcmp``
    (``make_bits_matvec_bucket(..., out_form="canonical")``)."""
    if vals_p.dim() != 2:
        raise ValueError("vals_p must be [S, Bw]")
    _check_matvec(vals_p, cols, F, 1)
    if not _on_cuda(vals_p, cols, F):
        return bits_matvec_canonical_plain(vals_p, cols, F, field)
    Bw = vals_p.shape[1]
    return _fold_matvec(bits_matvec_canonical, vals_p, cols, F, 32 * Bw, Bw, field, True, True)


def bits_matvec_canonical_plain(vals_p: torch.Tensor, cols: torch.Tensor, F: torch.Tensor,
                                field: PrimeField) -> torch.Tensor:
    """Plain version: the gather of the entries' bits, the exact digit
    sums, then _reduce_rows."""
    n_rows, B = cols.shape[0], 32 * vals_p.shape[1]
    if n_rows == 0 or B == 0:
        return torch.zeros((L16, n_rows, B), dtype=torch.int32, device=vals_p.device)
    return _reduce_sums(_digit_sums(_gather_bits(vals_p, cols), F), field, True)


bits_matvec_canonical.launches = 0


def limbs_matvec(zt: torch.Tensor, cols: torch.Tensor, F: torch.Tensor, field: PrimeField,
                 out_form: str = "semi") -> torch.Tensor:
    """Slot-major limbs zt int32[S, 16, B] (16-bit limbs: limb l holds
    digits 2l and 2l + 1), a bucket's column table cols int32[n_rows, K]
    (slots below S, −1 for an empty entry) and its fold planes F
    uint8[n_rows, 32, 32K] (``fold_operand`` of planes whose [d, r, 32e +
    j] is digit d of c_e·2^(8j) mod p) → Σ_e c_e·z_e reduced:
    int32[17, n_rows, B] semi limbs (a value < 2^265 congruent mod p) for
    out_form "semi", int32[16, n_rows, B] canonical limbs for
    "canonical". Needs K ≤ MAX_FUSED_LIMBS_K (C·255² < 2^32)."""
    if out_form not in ("semi", "canonical"):
        raise ValueError(f"out_form must be 'semi' or 'canonical', got {out_form!r}")
    if zt.dim() != 3 or zt.shape[1] != L16:
        raise ValueError("zt must be [S, 16, B]")
    _check_matvec(zt, cols, F, L8)
    if not _on_cuda(zt, cols, F):
        return limbs_matvec_plain(zt, cols, F, field, out_form)
    B = zt.shape[2]
    return _fold_matvec(limbs_matvec, zt, cols, F, B, B, field, False, out_form == "canonical")


def limbs_matvec_plain(zt: torch.Tensor, cols: torch.Tensor, F: torch.Tensor, field: PrimeField,
                       out_form: str = "semi") -> torch.Tensor:
    """Plain version: the gather of the entries' digits, the exact digit
    sums, then the semi reduction or _reduce_rows."""
    n_rows, B = cols.shape[0], zt.shape[2]
    canonical = out_form == "canonical"
    if n_rows == 0 or B == 0:
        return torch.zeros((L16 if canonical else SEMI, n_rows, B), dtype=torch.int32, device=zt.device)
    return _reduce_sums(_digit_sums(_gather_digits(zt, cols), F), field, canonical)


limbs_matvec.launches = 0


# ---------------------------------------------------------------------------
# Kernel 5: fused mul-compare
# ---------------------------------------------------------------------------
def mulcmp(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, field: PrimeField) -> torch.Tensor:
    """Semi-reduced a, b, c int32[17, N] (16-bit limbs; a, b < 2^266,
    c ≤ p·2^11) → int32[N] mask: 1 where a·b ≢ c (mod p), 0 where a·b ≡ c.
    The TPU kernel returns a word that is nonzero where this mask is 1 (an
    OR of limb XORs of its own fold integers); every caller reads only
    whether it is zero, so the port returns the mask. Needs 250 ≤
    field.NUM_BITS ≤ 256 (p·2^11 must exceed every semi value; the kernel
    holds p in 8 words)."""
    if not 250 <= field.NUM_BITS <= 256:
        raise ValueError("mulcmp needs 2^249 ≤ p < 2^256")
    if a.dim() != 2:
        raise ValueError("a must be [17, N]")
    N = a.shape[1]
    for name, t in (("a", a), ("b", b), ("c", c)):
        _check_words(name, t, (SEMI, N))
    if not _on_cuda(a, b, c):
        return mulcmp_plain(a, b, c, field)
    out = torch.empty(N, dtype=torch.int32, device=a.device)
    if N:
        k = kernel_consts(field)["mulcmp"]
        _launch("bp_mulcmp", a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(), N,
                k.ctypes.data, stream=_stream(a))
        mulcmp.launches += 1
    return out


def mulcmp_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, field: PrimeField) -> torch.Tensor:
    """Plain version: field_pallas._mulcmp_rows in int64 (uint32 wrap
    emulated by masking), its nonzero word reduced to the 0/1 mask."""
    consts = consts_for(field)
    a, b, c = to_u32(a), to_u32(b), to_u32(c)
    N = a.shape[1]
    # neg ≡ −c (mod p): borrow-free because p·2^11 > any semi value.
    neg = []
    borrow = 0
    for i in range(SEMI):
        d = (consts.p2_17[i] - c[i] - borrow) & U32
        borrow = d >> 31
        neg.append(d & 0xFFFF)
    # 17×17 convolution, lo/hi halves of each product accumulated apart.
    t = (a[:, None, :] * b[None, :, :]) & U32  # [17, 17, N]
    k = torch.arange(SEMI, device=a.device)
    pos = (k[:, None] + k[None, :]).reshape(-1)
    acc = torch.zeros((2 * SEMI, N), dtype=torch.int64, device=a.device)
    acc.index_add_(0, pos, (t & 0xFFFF).reshape(-1, N))
    acc.index_add_(0, pos + 1, (t >> 16).reshape(-1, N))
    rows = [acc[i] & U32 for i in range(2 * SEMI)]
    for i in range(SEMI):
        rows[i] = (rows[i] + neg[i]) & U32
    d = _carry_rows(rows, 2 * SEMI, 16)
    # fold positions 16..33 with split 8-bit multipliers
    f = list(d[:L16])
    for i in range(18):
        _mac_rows(f, d[L16 + i] & 0xFF, consts.fold16[i])
        _mac_rows(f, d[L16 + i] >> 8, consts.fold16_hi[i])
    d2 = _carry_rows(f, 18, 16)
    fin = list(d2[:L16])
    for m, row in zip((d2[L16] & 0xFF, d2[L16] >> 8, d2[17]), consts.fold16b):
        _mac_rows(fin, m, row)
    x17 = _carry_rows(fin, SEMI, 16)
    return (_mont_zero_rows(x17, consts) != 0).to(torch.int32)


mulcmp.launches = 0


# ---------------------------------------------------------------------------
# The product rows' operands and mul-compare in one pass (no Pallas
# counterpart: the reference's jnp operand assembly, fused by XLA, feeding
# make_mulcmp)
# ---------------------------------------------------------------------------
DESC_WORDS = 18  # csrc/operand_mulcmp.cu kDescWords: 3 operands × 6 words


class OperandTable:
    """The operands (a, b, c) of n product rows packed for
    ``operand_mulcmp``. Each operand is a constant plus up to two field
    terms and up to two u32 terms, each with a sign (the tables of
    ``check_common._Operand``, given as numpy arrays: ``const`` int64[n,
    17] 16-bit limbs, ``f_idx``, ``u_col`` int64[n, 2], ``f_on``,
    ``f_neg``, ``u_on``, ``u_neg`` bool[n, 2]).

    ``desc`` int32[n, 18]: per row and operand six words, flags (bit t
    on, bit 4 + t negated, for the field terms t = 0, 1 and the u32 terms
    t = 2, 3), the constant's id in ``consts``, the two field terms'
    limb-buffer rows and the two u32 terms' value rows (0 where off).
    ``consts`` int32[K, 9]: the distinct constants as 32-bit words (word 8
    holds limb 16), the zero constant first. ``f_max`` and ``u_max``: the
    largest row each kind of term reads (−1 for none)."""

    def __init__(self, operands, device):
        n = self.n = len(operands[0]["const"])
        const = np.concatenate([np.zeros((1, SEMI), np.int64)] + [o["const"] for o in operands])
        uniq, cid = np.unique(const, axis=0, return_inverse=True)  # the zero row sorts first
        cid = cid.reshape(-1)[1:].reshape(3, n)
        desc = np.zeros((n, 3, 6), np.int64)
        self.f_max = self.u_max = -1
        for o, op in enumerate(operands):
            on = np.concatenate([op["f_on"], op["u_on"]], axis=1).astype(np.int64)
            neg = np.concatenate([op["f_neg"], op["u_neg"]], axis=1) & (on != 0)
            idx = np.where(on != 0, np.concatenate([op["f_idx"], op["u_col"]], axis=1), -1)
            desc[:, o, 0] = (on << np.arange(4)).sum(1) | (neg << np.arange(4, 8)).sum(1)
            desc[:, o, 1] = cid[o]
            desc[:, o, 2:] = np.maximum(idx, 0)
            self.f_max = max(self.f_max, int(idx[:, :2].max(initial=-1)))
            self.u_max = max(self.u_max, int(idx[:, 2:].max(initial=-1)))
        if desc.max(initial=0) > 0x7FFFFFFF:
            raise ValueError("operand tables index at most 2^31 rows")
        words = uniq[:, 0:16:2] | (uniq[:, 1:16:2] << 16)
        consts = np.concatenate([words, uniq[:, 16:]], axis=1).astype(np.uint32)
        self.desc = torch.from_numpy(desc.reshape(n, DESC_WORDS).astype(np.int32)).to(device)
        self.consts = torch.from_numpy(consts.view(np.int32)).to(device)


def operand_mulcmp(table: OperandTable, flimbs_p: torch.Tensor, vals_p, field: PrimeField) -> torch.Tensor:
    """bool[n, B]: a·b ≢ c (mod p) for the operands of `table`'s n rows,
    each assembled from canonical limbs flimbs_p int32[F, 16, B] and u32
    values vals_p int32[S, B] (None where the table has no u32 term).
    Needs 250 ≤ field.NUM_BITS ≤ 256, as ``mulcmp``."""
    if not 250 <= field.NUM_BITS <= 256:
        raise ValueError("operand_mulcmp needs 2^249 ≤ p < 2^256")
    if flimbs_p.dim() != 3 or flimbs_p.shape[1] != L16:
        raise ValueError(f"flimbs_p must be [F, 16, B], got {tuple(flimbs_p.shape)}")
    _check_words("flimbs_p", flimbs_p)
    F, _, B = flimbs_p.shape
    if table.f_max >= F:
        raise ValueError(f"the table reads limb row {table.f_max}, flimbs_p has {F}")
    ts = [table.desc, table.consts, flimbs_p]
    if vals_p is not None:
        if vals_p.dim() != 2 or vals_p.shape[1] != B:
            raise ValueError(f"vals_p must be [S, {B}], got {tuple(vals_p.shape)}")
        _check_words("vals_p", vals_p)
        ts.append(vals_p)
    if table.u_max >= (0 if vals_p is None else vals_p.shape[0]):
        raise ValueError(f"the table reads u32 row {table.u_max}: vals_p is missing or short")
    if not _on_cuda(*ts):
        return operand_mulcmp_plain(table, flimbs_p, vals_p, field)
    out = torch.empty((table.n, B), dtype=torch.bool, device=flimbs_p.device)
    if table.n and B:
        k = kernel_consts(field)["mulcmp"]
        _launch("bp_operand_mulcmp", table.desc.data_ptr(), table.consts.data_ptr(), flimbs_p.data_ptr(),
                None if vals_p is None else vals_p.data_ptr(), out.data_ptr(), table.n, B, k.ctypes.data,
                stream=_stream(flimbs_p))
        operand_mulcmp.launches += 1
    return out


def operand_mulcmp_plain(table: OperandTable, flimbs_p: torch.Tensor, vals_p, field: PrimeField) -> torch.Tensor:
    """Plain version: the eager route. The table's terms read back as
    tensors, each operand assembled by ``assemble_operand`` in int64
    [n, 17, B], copied limb-major, then ``mulcmp_plain``."""
    n, B = table.n, flimbs_p.shape[-1]
    if not (n and B):
        return torch.zeros((n, B), dtype=torch.bool, device=flimbs_p.device)
    d = table.desc.to(torch.int64).reshape(n, 3, 6)
    w = to_u32(table.consts)
    const = torch.stack([w & 0xFFFF, w >> 16], 2).reshape(-1, 18)[:, :SEMI, None]  # [K, 17, 1] limbs
    p17 = _table(field.p, "p17", _digits(field.p, 16, SEMI), d.device).reshape(1, SEMI, 1)
    operands = []
    for o in range(3):
        flags = d[:, o, 0]
        terms = [(d[:, o, 2 + t], ((flags >> t) & 1 != 0)[:, None, None],
                  ((flags >> (4 + t)) & 1 != 0)[:, None, None]) for t in range(4)]
        x = assemble_operand(const.index_select(0, d[:, o, 1]), terms[:2], terms[2:] if vals_p is not None else [],
                             vals_p, flimbs_p, p17)
        operands.append(to_i32(x.transpose(0, 1).reshape(SEMI, n * B)).contiguous())
    return (mulcmp_plain(*operands, field) != 0).reshape(n, B)


operand_mulcmp.launches = 0


# ---------------------------------------------------------------------------
# The packed check's verdict fold (no Pallas counterpart: the reference's
# jnp fold in verdict_packed, which XLA fuses)
# ---------------------------------------------------------------------------
NONE = torch.iinfo(torch.int64).max  # a running verdict's "no violation yet"


def verdict_acc(device) -> torch.Tensor:
    """A running verdict int64[2] = (n_bad, first) = (0, NONE) on
    `device`, made by fills (no host copy, no sync)."""
    acc = torch.full((2,), NONE, dtype=torch.int64, device=device)
    acc[0] = 0
    return acc


def verdict_fold(acc: torch.Tensor, bad: torch.Tensor, rows: torch.Tensor, R: int, n_inst=None) -> torch.Tensor:
    """Fold the violations of template rows `rows` int64[n] into the
    running verdict acc int64[2] = (n_bad, first), in place: n_bad gains
    their count, first falls to the least instance-major index b·R + row
    of one (NONE while there is none). `bad` is either packed words
    int32[n, Bw] (bit j of word w: instance 32·w + j; only instances below
    n_inst count, 32·Bw by default) or a mask bool[n, W] (column b:
    instance b; only the first n_inst columns, W by default). Its rows may
    be strided (a column slice needs no copy); its columns must be
    contiguous. Returns acc."""
    if acc.dtype != torch.int64 or tuple(acc.shape) != (2,) or not acc.is_contiguous():
        raise TypeError("acc must be a contiguous int64[2] running verdict")
    if bad.dtype not in (torch.int32, torch.bool) or bad.dim() != 2:
        raise TypeError(f"bad must be int32 words or a bool mask of shape [n, width], got {bad.dtype}"
                        f"{tuple(bad.shape)}")
    n, width = bad.shape
    if width > 1 and bad.stride(1) != 1:
        raise ValueError("bad's columns must be contiguous")
    if rows.dtype != torch.int64 or tuple(rows.shape) != (n,) or not rows.is_contiguous():
        raise ValueError(f"rows must be contiguous int64[{n}]")
    mask = bad.dtype == torch.bool
    cap = width if mask else 32 * width
    n_inst = cap if n_inst is None else n_inst
    if not 0 <= n_inst <= cap:
        raise ValueError(f"n_inst {n_inst} outside [0, {cap}]")
    if not _on_cuda(acc, bad, rows):
        return verdict_fold_plain(acc, bad, rows, R, n_inst)
    read = n_inst if mask else -(-n_inst // 32)  # the columns that hold live instances
    if n and read:
        size = bad.element_size()
        ld = bad.stride(0)
        vec = int(bad.data_ptr() % 16 == 0 and (n == 1 or ld * size % 16 == 0) and read * size % 16 == 0)
        _launch("bp_verdict_fold", bad.data_ptr(), ld, n, read, int(mask), n_inst, rows.data_ptr(), R,
                acc.data_ptr(), vec, stream=_stream(bad))
        verdict_fold.launches += 1
    return acc


def verdict_fold_plain(acc: torch.Tensor, bad: torch.Tensor, rows: torch.Tensor, R: int, n_inst: int) -> torch.Tensor:
    """Plain version: the eager fold. Words: the live bits, a SWAR
    popcount and ctz (``words``) and the int64 candidate index of every
    nonzero word; a mask: its sum and the candidate of every set entry;
    then the candidates' minimum."""
    n, width = bad.shape
    if bad.dtype == torch.bool:
        bad = bad[:, :n_inst]
        inst = torch.arange(n_inst, dtype=torch.int64, device=bad.device)
        nb = bad.sum()
        cand = torch.where(bad, inst[None, :] * R + rows[:, None], NONE)
    else:
        winst = torch.arange(width, dtype=torch.int64, device=bad.device) * 32
        words = bad & to_i32((U32 >> (32 - (n_inst - winst).clamp(0, 32))) & U32)
        nb = popcount32(words).sum()
        cand = torch.where(words != 0, (winst[None, :] + ctz32(words)) * R + rows[:, None], NONE)
    if cand.numel():
        acc[0] += nb
        acc[1] = torch.minimum(acc[1], cand.min())
    return acc


verdict_fold.launches = 0


# ---------------------------------------------------------------------------
# The packed evaluator's addmany stage (no Pallas counterpart: the
# reference's jnp adder in _build_packed_impl, which XLA fuses)
# ---------------------------------------------------------------------------
def addmany_tables(arrs, outs, device) -> tuple:
    """One addmany stage's views packed for ``addmany``: (desc int32[W,
    n_words, 32], outs int32[W, n_out]). ``arrs`` holds the stage's view
    arrays as ``WitnessProgram`` compiles them (``idx``, ``neg``, ``isc``,
    ``cv``, each [W, n_words, 32]); a plane's descriptor is (slot << 1) |
    neg for a variable view, −1 − value for a constant one."""
    idx = np.asarray(arrs["idx"], np.int64)
    if idx.size and idx.max() >= 1 << 30:
        raise ValueError("addmany descriptors hold slots below 2^30")
    desc = np.where(np.asarray(arrs["isc"]) != 0, -1 - np.asarray(arrs["cv"], np.int64),
                    (idx << 1) | np.asarray(arrs["neg"], np.int64))
    return (torch.from_numpy(desc.astype(np.int32)).to(device),
            torch.from_numpy(np.ascontiguousarray(outs, np.int32)).to(device))


def _addmany_vec(vals: torch.Tensor) -> int:
    """The words a thread of the addmany kernel takes: the widest access,
    4, 2 or 1 words, that the buffer's base and row length allow (the
    widest was the fastest at every stage shape of the step_2m cells on
    the H100, W = 1 included)."""
    for v in (4, 2):
        if vals.data_ptr() % (4 * v) == 0 and vals.shape[1] % v == 0:
            return v
    return 1


def addmany(vals: torch.Tensor, tables: tuple, n_words: int, n_out: int) -> torch.Tensor:
    """One addmany stage in place: for each of the W sums, the n_words
    addend words that desc names (``addmany_tables``), added mod 2^n_out
    for every instance, and sum bit k written into slot outs[w, k] of the
    slot-major packed buffer vals int32[S, Bw]. The output slots must be
    distinct and no addend's. Returns vals."""
    desc, outs = tables
    if vals.dim() != 2:
        raise ValueError(f"vals must be [S, Bw], got {tuple(vals.shape)}")
    _check_words("vals", vals)
    W = desc.shape[0] if desc.dim() == 3 else -1
    _check_words("desc", desc, (W, n_words, 32))
    _check_words("outs", outs, (W, n_out))
    if not (0 < n_words < 1 << 15 and n_out >= 32):
        raise ValueError(f"addmany takes 1 to 2^15 − 1 words and n_out ≥ 32, got {n_words}, {n_out}")
    if not _on_cuda(vals, desc, outs):
        return addmany_plain(vals, tables, n_words, n_out)
    Bw = vals.shape[1]
    if W and Bw:
        _launch("bp_addmany_packed", vals.data_ptr(), Bw, desc.data_ptr(), outs.data_ptr(), W, n_words, n_out,
                _addmany_vec(vals), stream=_stream(vals))
        addmany.launches += 1
    return vals


def addmany_plain(vals: torch.Tensor, tables: tuple, n_words: int, n_out: int) -> torch.Tensor:
    """Plain version: the views decoded from desc and gathered whole
    ([W, n_words, 32, Bw]), then ``_addmany``'s CSA layers and prefix add,
    then the sum planes copied into their slots."""
    desc, outs = tables
    W, Bw = desc.shape[0], vals.shape[1]
    d = desc[..., None]
    v = vals.index_select(0, (desc.clamp(min=0) >> 1).reshape(-1).to(torch.int64)).reshape(W, n_words, 32, Bw)
    bv = torch.where(d < 0, -(d == -2).to(torch.int32), v ^ -(d & 1))
    vals.index_copy_(0, outs.reshape(-1).to(torch.int64), _addmany(bv, n_out).reshape(-1, Bw))
    return vals


addmany.launches = 0


def _sh(x: torch.Tensor, d: int, n_out: int) -> torch.Tensor:
    """Shift toward the MSB along the position axis (dim 1)."""
    z = torch.zeros_like(x[:, :d])
    return torch.cat([z, x[:, : n_out - d]], dim=1)


def _addmany(bv: torch.Tensor, n_out: int) -> torch.Tensor:
    """bv int32[W, n_words, 32, Bw] addend bit planes → int32[W, n_out, Bw]
    sum bit planes (mod 2^n_out)."""
    if n_out > 32:
        bv = torch.nn.functional.pad(bv, (0, 0, 0, n_out - 32))
    addends = [bv[:, w] for w in range(bv.shape[1])]
    # CSA 3:2 layers reduce the addends to two, then one Kogge-Stone
    # prefix add resolves the carries in log2(n_out) levels.
    while len(addends) > 2:
        nxt = []
        for i in range(0, len(addends) - 2, 3):
            a1, b1, c1 = addends[i : i + 3]
            nxt.append(a1 ^ b1 ^ c1)
            nxt.append(_sh((a1 & b1) | (c1 & (a1 ^ b1)), 1, n_out))
        rem = len(addends) % 3
        if rem:
            nxt.extend(addends[-rem:])
        addends = nxt
    if len(addends) == 1:
        return addends[0]
    a1, b1 = addends
    g = a1 & b1
    p = a1 ^ b1
    gk, pk, d = g, p, 1
    while d < n_out:
        gk = gk | (pk & _sh(gk, d, n_out))
        pk = pk & _sh(pk, d, n_out)
        d *= 2
    return p ^ _sh(gk, 1, n_out)


# ---------------------------------------------------------------------------
# The 16-bit-limb multiply pipeline (field_pallas.py:214-389) in torch.
# ---------------------------------------------------------------------------
_TABLES: Dict[tuple, torch.Tensor] = {}


def _table(field_p: int, name: str, rows, device) -> torch.Tensor:
    """A constant table of one field as an int64 tensor on `device`
    (cached)."""
    key = (field_p, name, str(device))
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = torch.tensor(rows, dtype=torch.int64, device=device)
    return t


def _p_of(consts) -> int:
    return sum(v << (16 * j) for j, v in enumerate(consts.p16))


def _conv16_rows(a16: List[torch.Tensor], b16: List[torch.Tensor]) -> List[torch.Tensor]:
    """field_pallas._conv16_rows: 32 positions of 16-bit-basis digits
    (each < 2^21) of a·b. Each 16×16-bit product is exact in 32 bits; its
    lo and hi halves accumulate at positions i+j and i+j+1."""
    a = torch.stack(a16)
    shape = a.shape[1:]
    a = a.reshape(L16, 1, -1)
    b = torch.stack(b16).reshape(1, L16, -1)
    t = a * b  # [16, 16, n]
    n = t.shape[-1]
    pos = _table(0, "conv16_pos", [i + j for i in range(L16) for j in range(L16)], t.device)
    acc = torch.zeros((2 * L16, n), dtype=torch.int64, device=t.device)
    acc.index_add_(0, pos, (t & 0xFFFF).reshape(-1, n))
    acc.index_add_(0, pos + 1, (t >> 16).reshape(-1, n))
    return list(acc.reshape((2 * L16,) + tuple(shape)).unbind(0))


def _carry16_rows(rows: List[torch.Tensor], n_out: int) -> List[torch.Tensor]:
    """field_pallas._carry16_rows: carry to n_out 16-bit limbs (positions
    past the input take the carry alone; the last carry drops). Every
    caller's rows stay below 2^31, where the uint32 sums of the TPU
    kernels never wrap."""
    x = torch.stack(rows[:n_out])
    if n_out > len(rows):
        x = torch.cat([x, torch.zeros_like(x[:1]).expand((n_out - len(rows),) + x.shape[1:])])
    return _signed_carry(x)[0]


def _fold_rows_const(acc: List[torch.Tensor], ms: List[torch.Tensor], table: torch.Tensor) -> List[torch.Tensor]:
    """acc[l] + Σ_i ms[i]·table[i, l] for a constant [len(ms), 16] table
    (every product < 2^24, so the sums are exact; uint32 as in the TPU
    kernels)."""
    m = torch.stack(ms)
    shape = m.shape[1:]
    m = m.reshape(m.shape[0], 1, -1)
    add = (m * table[:, :, None]).sum(0).reshape((L16,) + tuple(shape))
    return [(acc[l] + add[l]) & U32 for l in range(L16)]


def _fold1_split(d: List[torch.Tensor], consts, n_rows: int) -> List[torch.Tensor]:
    """field_pallas._fold1_split: fold positions 16..16+n_rows−1 into
    0..15 with each multiplier split as m0 + 2^8·m1 (16 positions, not
    carried)."""
    hi = d[L16 : L16 + n_rows]
    p = _p_of(consts)
    table = _table(p, f"fold1_{n_rows}", consts.fold16[:n_rows] + consts.fold16_hi[:n_rows], hi[0].device)
    return _fold_rows_const(list(d[:L16]), [h & 0xFF for h in hi] + [h >> 8 for h in hi], table)


def _signed_carry(d: torch.Tensor) -> tuple:
    """Limbs d [L, ...] of a signed multi-limb value (each |d_i| < 2^40)
    → (its 16-bit limbs, the final carry): an arithmetic-shift carry
    chain, exact in int64. The final carry is -1 where the value is
    negative (a borrow) and 0 where it fits L limbs."""
    out = []
    carry = None
    for i in range(d.shape[0]):
        tot = d[i] if carry is None else d[i] + carry
        out.append(tot & 0xFFFF)
        carry = tot >> 16
    return out, carry


def _neg_const(x: torch.Tensor, const: torch.Tensor) -> torch.Tensor:
    """const − x in 16-bit limbs along dim 1, the last borrow dropped (x ≤
    const; int64 [n, L, B] and [1, L, 1])."""
    return torch.stack(_signed_carry((const - x).transpose(0, 1))[0], dim=1)


def _carry_limbs(x: torch.Tensor) -> torch.Tensor:
    """Carry to 16-bit limbs along dim 1, the last carry dropped (limbs of
    the assembled operands stay far below 2^31, where the reference's
    uint32 sums never wrap)."""
    return torch.stack(_signed_carry(x.transpose(0, 1))[0], dim=1)


def assemble_operand(const, f_terms, u_terms, vals_p, flimbs_p, p17) -> torch.Tensor:
    """int64[n, 17, B]: an operand of n rows (a value below 4p) in 16-bit
    limbs, const int64[n, 17, 1] plus each term (idx int64[n], on and neg
    bool[n, 1, 1]) where on: a field term's canonical limbs flimbs_p[idx]
    ([F, 16, B]), a u32 term's value vals_p[idx] ([S, B]) as two limbs,
    p17 − x where negated; the sum carried, its last carry dropped."""
    B = flimbs_p.shape[-1]
    acc = const.expand(-1, -1, B)
    for idx, on, neg in f_terms:
        x = torch.nn.functional.pad(to_u32(flimbs_p.index_select(0, idx)), (0, 0, 0, 1))
        acc = acc + torch.where(on, torch.where(neg, _neg_const(x, p17), x), 0)
    for idx, on, neg in u_terms:
        v = to_u32(vals_p.index_select(0, idx))  # [n, B]
        x = torch.zeros_like(acc)
        x[:, 0] = v & 0xFFFF
        x[:, 1] = v >> 16
        acc = acc + torch.where(on, torch.where(neg, _neg_const(x, p17), x), 0)
    return _carry_limbs(acc)


def _cond_sub_rows(x: List[torch.Tensor], ps: List[int]) -> List[torch.Tensor]:
    """x − ps when that does not borrow, else x (len(ps) limbs,
    branch-free)."""
    xs = torch.stack(x[: len(ps)])
    c = _table(0, tuple(ps), ps, xs.device).reshape((-1,) + (1,) * (xs.dim() - 1))
    diff, borrow = _signed_carry(xs - c)
    return list(torch.where(borrow == 0, torch.stack(diff), xs).unbind(0))


def _canon_tail_v2(x: List[torch.Tensor], consts) -> List[torch.Tensor]:
    """field_pallas._canon_tail_v2: 17-limb x < 2^266 → 16 canonical limbs
    by the quotient estimate q̂ (≤ q, off by at most 6), the subtraction
    of q̂·p, and conditional subtracts of 4p, 2p and p. The q̂·p limbs
    subtract as lo/hi halves and one signed carry chain resolves them; x
    − q̂·p ≥ 0, so the limbs are the reference's exactly."""
    r = consts.qe
    qh = ((x[15] * r) >> 28) + ((x[16] * r) >> 12)
    p = _p_of(consts)
    p16 = _table(p, "p16", consts.p16, qh.device).reshape((L16,) + (1,) * qh.dim())
    t = qh.unsqueeze(0) * p16  # [16, ...]
    zero = torch.zeros_like(t[:1])
    sub = torch.cat([t & 0xFFFF, zero]) + torch.cat([zero, t >> 16])
    out, _ = _signed_carry(torch.stack(x[:17]) - sub)
    for k in (2, 1, 0):
        out = _cond_sub_rows(out, _digits(p << k, 16, 17))
    return out[:L16]


def _reduce16_rows(digit_rows: List[torch.Tensor], consts) -> List[torch.Tensor]:
    """field_pallas._reduce16_rows: 32 16-bit-basis positions (each
    < 2^21) → 16 canonical limbs: carry, split fold, carry, fold at 8-bit
    multiplier granularity, carry (17 limbs below 2^256 + 3·2^8·p), then
    the quotient-estimate canonicalization of a 253..256-bit field, or
    ``_canon_rows`` where the TPU runs its shift-subtract chain."""
    d = _carry16_rows(digit_rows, 2 * L16)
    acc = _fold1_split(d, consts, L16)
    d2 = _carry16_rows(acc, 18)
    table = _table(_p_of(consts), "fold16b", consts.fold16b, d2[0].device)
    out = _fold_rows_const(list(d2[:L16]), [d2[L16] & 0xFF, d2[L16] >> 8, d2[17]], table)
    x17 = _carry16_rows(out, 17)
    return _canon_tail_v2(x17, consts) if consts.qe is not None else _canon_rows(x17, consts)


def _add_canon_rows(a16: List[torch.Tensor], b16: List[torch.Tensor], consts) -> List[torch.Tensor]:
    """field_pallas._add_canon_rows: canonical + canonical → canonical
    (carry to 17 limbs, then one conditional subtract of p)."""
    s = _carry16_rows([a16[i] + b16[i] for i in range(L16)], 17)
    return _cond_sub_rows(s, consts.ps[-1])[:L16]


def _mul_rows(a16: List[torch.Tensor], b16: List[torch.Tensor], consts) -> List[torch.Tensor]:
    """Canonical a·b mod p of canonical 16-limb rows (the _mul_kernel
    body)."""
    return _reduce16_rows(_conv16_rows(a16, b16), consts)


# ---------------------------------------------------------------------------
# Kernel 1: the fused periodic field chain
# ---------------------------------------------------------------------------
MAX_PATTERN = 8  # longest chain pattern: the kernel takes one byte a position
_PREV = 0xFF  # the kernel's source byte for "prev"


def _chain_code(descs, n_ext: int):
    """Validate descs and pack them for the CUDA kernel as (fmul_mask,
    a_src, b_src): bit j of fmul_mask set for an fmul, byte j of a_src and
    b_src the sources (0xFF for "prev", else the external index)."""
    if not 1 <= len(descs) <= MAX_PATTERN:
        raise ValueError(f"chain patterns have 1..{MAX_PATTERN} ops, got {len(descs)}")
    fmul_mask = a_src = b_src = 0
    for j, (op, a, b) in enumerate(descs):
        if op not in ("fmul", "fadd"):
            raise ValueError(f"chain op {op!r} is not fmul or fadd")
        srcs = []
        for s in (a, b):
            if s == "prev":
                srcs.append(_PREV)
            elif isinstance(s, int) and 0 <= s < min(n_ext, _PREV):
                srcs.append(s)
            else:
                raise ValueError(f"chain source {s!r} is not 'prev' or an external index < {n_ext}")
        fmul_mask |= (op == "fmul") << j
        a_src |= srcs[0] << (8 * j)
        b_src |= srcs[1] << (8 * j)
    return fmul_mask, a_src, b_src


def chain(x0: torch.Tensor, ext: torch.Tensor, descs, n_reps: int, field: PrimeField) -> torch.Tensor:
    """x0 int32[16, N] and ext int32[n_ext·16, N] canonical limb-major
    (external operand k is rows 16k..16k+15) → int32[n_reps·d·16, N]:
    the canonical output of every step of n_reps repetitions of the d
    ops ``descs`` = ((opcode, a_src, b_src), ...), in chain order. A
    source is "prev" (the previous step's output; x0 before the first
    step) or an external index."""
    if x0.dim() != 2:
        raise ValueError("x0 must be [16, N]")
    N = x0.shape[1]
    _check_words("x0", x0, (L16, N))
    if ext.dim() != 2 or ext.shape[0] % L16 or not ext.shape[0]:
        raise ValueError("ext must be [n_ext·16, N] with n_ext >= 1")
    n_ext = ext.shape[0] // L16
    _check_words("ext", ext, (n_ext * L16, N))
    code = _chain_code(descs, n_ext)
    if not _on_cuda(x0, ext):
        return chain_plain(x0, ext, descs, n_reps, field)
    k = kernel_consts(field)["chain"]
    d = len(descs)
    out = torch.empty((n_reps * d * L16, N), dtype=torch.int32, device=x0.device)
    if N and n_reps:
        _launch("bp_chain", x0.data_ptr(), ext.data_ptr(), out.data_ptr(), N, n_reps, d,
                *code, k.ctypes.data, stream=_stream(x0))
        chain.launches += 1
    return out


def chain_plain(x0: torch.Tensor, ext: torch.Tensor, descs, n_reps: int, field: PrimeField) -> torch.Tensor:
    """Plain version: the Pallas chain body (field_pallas.py:439-450)
    step by step on int64 rows."""
    consts = consts_for(field)
    cur = list(to_u32(x0).unbind(0))
    e = to_u32(ext)
    exts = [list(e[k * L16 : (k + 1) * L16].unbind(0)) for k in range(ext.shape[0] // L16)]
    outs = []
    for _r in range(n_reps):
        for op, asrc, bsrc in descs:
            a = cur if asrc == "prev" else exts[asrc]
            b = cur if bsrc == "prev" else exts[bsrc]
            cur = _mul_rows(a, b, consts) if op == "fmul" else _add_canon_rows(a, b, consts)
            outs.extend(cur)
    if not outs:
        return torch.zeros((0, x0.shape[1]), dtype=torch.int32, device=x0.device)
    return to_i32(torch.stack(outs))


chain.launches = 0


# ---------------------------------------------------------------------------
# Kernel 3a: canonical modmul (PallasFieldOps.mul), and the exponent
# ladder that the field backend's inversion runs on it
# ---------------------------------------------------------------------------
def mul(a: torch.Tensor, b: torch.Tensor, field: PrimeField) -> torch.Tensor:
    """a, b int32[16, N] limb-major 16-bit limbs, a < 2^256 (canonical, or
    a raw witness value in [p, 2^256)) and b canonical → int32[16, N]
    canonical a·b mod p, for every odd p < 2^256."""
    if a.dim() != 2:
        raise ValueError("a must be [16, N]")
    N = a.shape[1]
    _check_words("a", a, (L16, N))
    _check_words("b", b, (L16, N))
    if not _on_cuda(a, b):
        return mul_plain(a, b, field)
    k = kernel_consts(field)["chain"]
    out = torch.empty((L16, N), dtype=torch.int32, device=a.device)
    if N:
        _launch("bp_mul16", a.data_ptr(), b.data_ptr(), out.data_ptr(), N, k.ctypes.data,
                stream=_stream(a))
        mul.launches += 1
    return out


def mul_plain(a: torch.Tensor, b: torch.Tensor, field: PrimeField) -> torch.Tensor:
    """Plain version of _mul_kernel: _reduce16_rows(_conv16_rows(a, b))."""
    if a.shape[1] == 0:
        return torch.zeros_like(a)
    rows = _mul_rows(list(to_u32(a).unbind(0)), list(to_u32(b).unbind(0)), consts_for(field))
    return to_i32(torch.stack(rows))


mul.launches = 0


def pow_ladder(x: torch.Tensor, bits: List[int], field: PrimeField) -> torch.Tensor:
    """Canonical x int32[16, N] → int32[16, N] canonical x^e, for the
    exponent e ≥ 1 whose MSB-first bits are ``bits`` (bits[0] = 1):
    square-and-multiply starting from x at the top bit, each squaring and
    each multiply by x one ``mul`` (e is known on the host, so its 0 bits
    skip the multiply): len(bits) − 1 + sum(bits) − 1 products. On the CPU
    each is ``mul_plain``. On the card the input is checked once, and then
    each step only launches the mul kernel, into two buffers it
    alternates; each launch counts in ``mul.launches``."""
    if x.dim() != 2:
        raise ValueError("x must be [16, N]")
    N = x.shape[1]
    _check_words("x", x, (L16, N))
    if not bits or bits[0] != 1:
        raise ValueError("bits must be the MSB-first bits of an exponent >= 1")
    by_x = [m for bit in bits[1:] for m in ((False, True) if bit else (False,))]
    if not _on_cuda(x):
        r = x
        for m in by_x:
            r = mul_plain(r, x if m else r, field)
        return r.clone() if r is x else r
    if not N or not by_x:
        return x.clone()
    k = kernel_consts(field)["chain"].ctypes.data
    bufs = (torch.empty_like(x), torch.empty_like(x))
    fn, stream = load_kernels().bp_mul16, _stream(x)
    xp = src = x.data_ptr()
    dst = [t.data_ptr() for t in bufs]
    for j, m in enumerate(by_x):
        err = fn(src, xp if m else src, dst[j & 1], N, k, stream)
        if err != 0:
            raise RuntimeError(f"bp_mul16: CUDA launch failed with cudaError {err}")
        mul.launches += 1
        src = dst[j & 1]
    return bufs[(len(by_x) - 1) & 1]


# ---------------------------------------------------------------------------
# Kernels 3b: PallasFieldOps.mul_digits and reduce_digits
# ---------------------------------------------------------------------------
def mul_digits(a: torch.Tensor, b: torch.Tensor, field: PrimeField) -> torch.Tensor:
    """a, b int32[16, N] limb-major, a < 2^256 (canonical, or a raw
    witness value in [p, 2^256)) and b canonical → int32[32, N]: the 8-bit
    digits of the canonical a·b mod p (digit 2l + h is byte h of limb l),
    for every odd p < 2^256 (``mul``'s range)."""
    if a.dim() != 2:
        raise ValueError("a must be [16, N]")
    N = a.shape[1]
    _check_words("a", a, (L16, N))
    _check_words("b", b, (L16, N))
    if not _on_cuda(a, b):
        return mul_digits_plain(a, b, field)
    k = kernel_consts(field)["chain"]
    out = torch.empty((L8, N), dtype=torch.int32, device=a.device)
    if N:
        _launch("bp_mul_digits", a.data_ptr(), b.data_ptr(), out.data_ptr(), N, k.ctypes.data,
                stream=_stream(a))
        mul_digits.launches += 1
    return out


def mul_digits_plain(a: torch.Tensor, b: torch.Tensor, field: PrimeField) -> torch.Tensor:
    """Plain version of _mul_digits_kernel: _split8_rows of the product."""
    r = to_u32(mul_plain(a, b, field))
    return to_i32(torch.stack([r & 0xFF, r >> 8], dim=1).reshape(L8, -1))


mul_digits.launches = 0


def _element_major(d: torch.Tensor) -> bool:
    """d [32, N] is the transposed view of a contiguous [N, 32] tensor,
    16-byte aligned: the kernel reads each element's 128 bytes as one
    line."""
    return d.stride() == (1, L8) and d.data_ptr() % 16 == 0


def reduce_digits(d: torch.Tensor, field: PrimeField) -> torch.Tensor:
    """d int32[32, N] digit sums (8-bit basis, each below 2^24; the caller
    holds that bound) → int32[16, N] canonical limbs of Σ d[j]·2^(8j) mod
    p. d may be contiguous or the transposed view of a contiguous
    int32[N, 32] (element-major, as the row-chunked evaluator builds its
    sums), which the kernel reads as it lies; any other layout is copied
    to contiguous once. Every odd p < 2^256 (``mul``'s range)."""
    if d.dim() != 2:
        raise ValueError("d must be [32, N]")
    N = d.shape[1]
    if d.dtype != torch.int32:
        raise TypeError(f"d must be int32 words, got {d.dtype}")
    if tuple(d.shape) != (L8, N):
        raise ValueError(f"d must have shape {(L8, N)}, got {tuple(d.shape)}")
    if not _on_cuda(d):
        return reduce_digits_plain(d, field)
    k = kernel_consts(field)["chain"]
    element_major = N > 1 and _element_major(d)
    if not element_major:
        d = d.contiguous()
    out = torch.empty((L16, N), dtype=torch.int32, device=d.device)
    if N:
        _launch("bp_reduce_digits", d.data_ptr(), out.data_ptr(), N, int(element_major), k.ctypes.data,
                stream=_stream(d))
        reduce_digits.launches += 1
    return out


def reduce_digits_plain(d: torch.Tensor, field: PrimeField) -> torch.Tensor:
    """Plain version of _reduce_kernel: _reduce_rows."""
    if d.shape[1] == 0:
        return torch.zeros((L16, 0), dtype=torch.int32, device=d.device)
    return to_i32(torch.stack(_reduce_rows(list(to_u32(d).unbind(0)), consts_for(field))))


reduce_digits.launches = 0
