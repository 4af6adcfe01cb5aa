"""One huge R1CS on one card: the monolithic COO evaluator and the
row-chunked evaluator, product and check.

Counterpart of ``bellpepper_tpu/backend/matvec.py``:

  * ``DeviceR1CS``, ``sparse_matvec``, ``r1cs_eval``, ``violation_mask``
    (``:33-109``, ``:750-753``): gather, multiply, 8-bit split, segment
    sum (``index_add_`` in int32), canonical reduction. The parity oracle
    of the chunked evaluator;
  * ``build_row_chunked_eval`` (``:126-419``) and
    ``_finish_row_chunked_eval`` (``:422-587``): the host layout (ELL with
    the uniform row-sorted fast path, slice mode for a contiguous identity
    matrix, the segment-sum fallback for skewed rows, the span-bounded
    coefficient premul) and the per-chunk blocks, canonical and
    semi-reduced;
  * ``build_row_chunked_product`` (``:590-650``): (A·z)∘(B·z) a chunk, the
    witness completion of product-form systems;
  * ``build_row_chunked_check`` (``:653-747``): the verdict ``(n_bad,
    first)``, through ``mulcmp`` on semi-reduced blocks or ``mul`` on
    canonical ones.

The reference's ``lax.scan`` over chunks is a Python loop that launches
each chunk's work on the current stream with no host sync; the verdict is
read back once, by the caller. Index tables live on the device as int32
(at 2^24 rows they are hundreds of MB), and torch's gathers take them as
they are. Witnesses are ``int32[N, 16]`` rows of 16-bit limbs (the word
contract of ``words``); a value may be any 256-bit integer, not only a
canonical one: every multiply and reduction below gives the canonical
residue of what it is handed. Inside, a chunk's blocks are limb-major
(``int32[16, rpc]`` canonical, ``int32[17, rpc]`` semi-reduced), the
layout the kernels read.

TPU-only details that are not ported: the ``TILE`` padding of the
Pallas adapters (``:1019-1055``) and the ``rpc % TILE`` gate of the fast
check (``:685-690``); the strided-slice row sum of ``_ell_rowsum``
(``:481-497``), which works around XLA's padding of a small minor axis;
passing the layout as a jit argument so it is not embedded as HLO
literals (``:45-51``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import check_use_pallas, resolve
from ..r1cs import R1CS
from .check_common import SENTINEL
from .field_backend import FieldBackend
from .field_consts import L8, L16, SEMI
from .field_kernels import mul, mulcmp, reduce_digits
from .layout import MAX_ROW_NNZ, _assert_row_density
from .words import device_table, from_numpy_u32

# The span-bounded premul (reference :111-123): identity and zero
# coefficients gather straight from z, and each other coefficient k
# multiplies only z[:span_k], the columns its entries touch. On while the
# extra rows stay small.
_PREMUL_MAX_TABLE = 16
_PREMUL_MAX_ROWS = 1 << 22


def _gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src[idx] for int32[N, 16] rows and an int32 row table, as a gather
    of single words (each row's 16 word indices made here): on the H100
    it ran several times faster than torch's row gathers (index_select,
    indexing, gather, embedding) at config 5's chunk of 2^20 rows; with it
    the check's device work fell from 54.1 to 31.1 ms (NVIDIA H100 80GB
    HBM3, 700 W; torch.profiler)."""
    dt = torch.int32 if src.shape[0] * L16 < (1 << 31) else torch.int64
    words = idx.to(dt)[:, None] * L16 + torch.arange(L16, dtype=dt, device=idx.device)
    return src.reshape(-1, 1).index_select(0, words.reshape(-1)).view(-1, L16)


def _digit_bytes(v: torch.Tensor) -> torch.Tensor:
    """int32[..., 16] 16-bit limbs → a uint8 view [..., 16, 2] of their low
    two bytes (little-endian): digit 2l + h of the reference's ``_split8``
    is byte h of limb l, and the bits above 16 it masks off are bytes 2
    and 3, which the view leaves out."""
    return v.contiguous().view(torch.uint8).unflatten(-1, (L16, 4))[..., :2]


def _split8(v: torch.Tensor) -> torch.Tensor:
    """int32[..., 16] 16-bit limbs → int32[..., 32] 8-bit digits."""
    return _digit_bytes(v).to(torch.int32).reshape(v.shape[:-1] + (L8,))


def _ell_digit_sums(v: torch.Tensor, deg: int) -> torch.Tensor:
    """The 8-bit digits of ELL entries v[rpc·deg, 16] summed over each
    row's deg slots → int32[rpc, 32], split and sum in one op."""
    if deg == 1:
        return _split8(v)
    return _digit_bytes(v).unflatten(0, (-1, deg)).sum(1, dtype=torch.int32).reshape(-1, L8)


def _check_z(z: torch.Tensor, n_rows: int) -> None:
    if z.dtype != torch.int32 or z.dim() != 2 or z.shape[1] != L16:
        raise ValueError(f"z must be int32[N, 16] limbs, got {z.dtype}{tuple(z.shape)}")
    if z.shape[0] != n_rows:
        raise ValueError(
            f"z has {z.shape[0]} rows; expected num_inputs + num_aux "
            f"= {n_rows} (a padded z would silently shift every premul "
            f"gather offset)"
        )


# ---------------------------------------------------------------------------
# The monolithic evaluator
# ---------------------------------------------------------------------------
class DeviceMatrix(NamedTuple):
    rows: torch.Tensor  # int32[E]
    cols: torch.Tensor  # int32[E]
    coeff_ids: torch.Tensor  # int32[E]


@dataclass(frozen=True)
class DeviceR1CS:
    """An R1CS on the device: three COO matrices and the coefficient table
    as limbs ``int32[K, 16]``."""

    a: DeviceMatrix
    b: DeviceMatrix
    c: DeviceMatrix
    coeff_limbs: torch.Tensor
    num_constraints: int
    num_inputs: int
    num_aux: int

    @staticmethod
    def from_r1cs(r: R1CS, *, device=None) -> "DeviceR1CS":
        """`r` on `device` (the CUDA card by default)."""
        device = resolve(device)
        for name in ("a", "b", "c"):
            _assert_row_density(np.asarray(getattr(r, name).rows), r.num_constraints, f"matrix {name}")

        def dm(m):
            return DeviceMatrix(*(device_table(a, device, torch.int32) for a in (m.rows, m.cols, m.coeff_ids)))

        return DeviceR1CS(
            a=dm(r.a), b=dm(r.b), c=dm(r.c),
            coeff_limbs=from_numpy_u32(FieldBackend.to_limbs([int(c) % r.field.p for c in r.coeff_table]), device),
            num_constraints=r.num_constraints, num_inputs=r.num_inputs, num_aux=r.num_aux,
        )


def _sparse_matvec_lm(be: FieldBackend, mat: DeviceMatrix, coeff_limbs, z, num_rows: int) -> torch.Tensor:
    """M·z as limb-major canonical int32[16, num_rows]."""
    zv = _gather_rows(z, mat.cols).t().contiguous()  # [16, E]
    cv = coeff_limbs.t().index_select(1, mat.coeff_ids).contiguous()
    digits = _split8(mul(zv, cv, be.field).t())  # [E, 32], each < 256
    rowsum = torch.zeros((num_rows, L8), dtype=torch.int32, device=z.device)
    rowsum.index_add_(0, mat.rows, digits)  # < 2^24 by _assert_row_density
    return reduce_digits(rowsum.t(), be.field)  # element-major: the kernel reads it as it lies


def sparse_matvec(be: FieldBackend, mat: DeviceMatrix, coeff_limbs: torch.Tensor, z: torch.Tensor,
                  num_rows: int) -> torch.Tensor:
    """M·z over 𝔽_p: int32[num_rows, 16] canonical limbs."""
    return _sparse_matvec_lm(be, mat, coeff_limbs, z, num_rows).t().contiguous()


def r1cs_eval(be: FieldBackend, d: DeviceR1CS, z: torch.Tensor):
    """(A·z, B·z, C·z), each int32[R, 16]."""
    return tuple(sparse_matvec(be, m, d.coeff_limbs, z, d.num_constraints) for m in (d.a, d.b, d.c))


def violation_mask(be: FieldBackend, d: DeviceR1CS, z: torch.Tensor) -> torch.Tensor:
    """bool[R]: True where A·z ∘ B·z ≠ C·z."""
    az, bz, cz = (_sparse_matvec_lm(be, m, d.coeff_limbs, z, d.num_constraints) for m in (d.a, d.b, d.c))
    return (mul(az, bz, be.field) != cz).any(0)


# ---------------------------------------------------------------------------
# The row-chunked evaluator
# ---------------------------------------------------------------------------
def _ell_rowsum(v: torch.Tensor, deg: int) -> torch.Tensor:
    """The ELL slot axis of v[rpc·deg, K] summed → int32[rpc, K]."""
    if deg == 1:
        return v
    return v.reshape(-1, deg, v.shape[-1]).sum(1, dtype=torch.int32)


def _carry16_semi(x: torch.Tensor) -> torch.Tensor:
    """int32[rpc, 16] (limbs possibly above 16 bits, from row sums) →
    limb-major semi-reduced int32[17, rpc]: one carry pass, the final
    carry as limb 17."""
    xt = x.t().contiguous()
    out = torch.empty((SEMI, xt.shape[1]), dtype=torch.int32, device=x.device)
    carry = None
    for i in range(L16):
        tot = xt[i] if carry is None else xt[i] + carry
        torch.bitwise_and(tot, 0xFFFF, out=out[i])
        carry = tot >> 16
    out[L16] = carry
    return out


def _chunk(xs, k: int):
    """Chunk k's entries of the per-name tables ``xs``."""
    return tuple({key: v[k] for key, v in x.items()} for x in xs)


class RowChunkedEval:
    """A·z, B·z, C·z of one R1CS a block of ``rpc`` rows at a time
    (returned by ``build_row_chunked_eval``). ``eval_fn(z, prep)`` →
    (az, bz, cz), each int32[R, 16] canonical. The attributes and methods
    keep the reference's closure attributes' names: ``_zsrc``,
    ``_blocks``, ``_blocks_semi``, ``_xs``, ``_semi_ok``, ``_rpc``,
    ``_layout_meta``."""

    def __init__(self, r: R1CS, rpc: int, n_chunks: int, names, meta):
        self.field = r.field
        self.R = r.num_constraints
        self.N = r.num_inputs + r.num_aux
        self.names = tuple(names)
        self._rpc = rpc
        self.n_chunks = n_chunks
        self._layout_meta = meta
        modes = {n: meta["modes"][n] for n in self.names if n in meta["modes"]}
        self.ell_deg = {n: m[1] for n, m in modes.items() if m[0] == "ell"}
        self.slice_names = {n for n, m in modes.items() if m[0] == "slice"}
        self.span = meta.get("span", {})
        self.premul = meta["premul"]
        # Semi-reduced blocks feed mulcmp. Identity-coefficient entries
        # gather RAW witness values, which need not be canonical: bound deg
        # by the worst case (entries < 2^256), so a row sum stays under
        # mulcmp's semi bound p·2^11 (reference :539).
        self._SEMI_MAX_DEG = max(1, (self.field.p << 11) >> 256)
        self._semi_ok = bool(self.R) and all(m[0] != "seg" for m in modes.values()) and (
            max(self.ell_deg.values(), default=1) <= self._SEMI_MAX_DEG
        )

    def _zsrc(self, z: torch.Tensor, cl: torch.Tensor) -> torch.Tensor:
        """The call's source buffer the chunks gather from: z, then
        coeff_k·z[:span_k] for each premultiplied coefficient k (three
        ``mul`` launches for config 5)."""
        if not self.R:
            return z
        _check_z(z, self.N)
        if not self.premul or not self.span:
            return z
        rows = [z]
        for k in sorted(self.span):
            n = self.span[k]
            zk = z[:n].t().contiguous()
            ck = cl[k][:, None].expand(L16, n).contiguous()
            rows.append(mul(zk, ck, self.field).t())
        return torch.cat(rows)

    def _gathered(self, zsrc, cl, mx, name) -> torch.Tensor:
        """One chunk's per-entry values of matrix `name`: int32[rpc·deg,
        16] (a view of [rpc, 16] in slice mode), canonical where a
        coefficient multiplied them, raw z where it is 1."""
        if name in self.slice_names:
            s = mx["start"]
            return zsrc[s : s + self._rpc]
        if self.premul:
            v = _gather_rows(zsrc, mx["src"])
        else:
            zv = _gather_rows(zsrc, mx["cols"]).t().contiguous()
            cv = cl.t().index_select(1, mx["cids"]).contiguous()
            v = mul(zv, cv, self.field).t()
        if "mask" not in mx:  # uploaded only where an entry is padding or zero
            return v
        return v * mx["mask"][:, None]

    def _block(self, zsrc, cl, mx, name) -> torch.Tensor:
        """One chunk of M·z, limb-major canonical int32[16, rpc]. Slice
        mode keeps the reduction: raw witness values need not be
        canonical."""
        v = self._gathered(zsrc, cl, mx, name)
        if name in self.ell_deg or name in self.slice_names:
            digits = _ell_digit_sums(v, self.ell_deg.get(name, 1))
        else:
            digits = torch.zeros((self._rpc, L8), dtype=torch.int32, device=v.device)
            digits.index_add_(0, mx["lrow"], _split8(v))
        return reduce_digits(digits.t(), self.field)  # element-major, read as it lies

    def _blocks(self, zsrc, cl, xs, nm):
        return tuple(self._block(zsrc, cl, x, n) for n, x in zip(nm, xs))

    def _blocks_semi(self, zsrc, cl, xs, nm):
        """One chunk's blocks as int32[17, rpc] semi-reduced limbs: plain
        16-bit limb sums and one carry pass, no canonical reduction."""
        outs = []
        for n, x in zip(nm, xs):
            v = self._gathered(zsrc, cl, x, n)
            if n in self.ell_deg:
                v = _ell_rowsum(v, self.ell_deg[n])
            outs.append(_carry16_semi(v))
        return tuple(outs)

    def _xs(self, prep, nm):
        """The per-chunk tables of names `nm`, each with a leading chunk
        axis: ELL entries are stored flat, so one prep serves any chunk
        count; they are viewed on this evaluator's chunk grid here."""
        out = []
        for name in nm:
            e = prep[name]
            if name in self.ell_deg:
                e = {k: v.reshape(self.n_chunks, -1) for k, v in e.items()}
            out.append(e)
        return tuple(out)

    def __call__(self, z: torch.Tensor, prep):
        if not self.R:
            return tuple(torch.zeros((0, L16), dtype=torch.int32, device=z.device) for _ in self.names)
        cl = prep["coeff_limbs"]
        zsrc = self._zsrc(z, cl)
        xs = self._xs(prep, self.names)
        outs = [torch.empty((self.R, L16), dtype=torch.int32, device=z.device) for _ in self.names]
        rpc = self._rpc
        for k in range(self.n_chunks):
            for o, blk in zip(outs, self._blocks(zsrc, cl, _chunk(xs, k), self.names)):
                o[k * rpc : (k + 1) * rpc] = blk.t()
        return tuple(outs)


def build_row_chunked_eval(r: R1CS, n_chunks: int, names=("a", "b", "c"), premul_table: Optional[bool] = None,
                           reuse=None, *, device=None):
    """Row-chunked A·z/B·z/C·z for one huge system: only one block's
    per-entry intermediates are live at a time.

    With `premul_table` (on by default while the non-trivial coefficient
    spans are small) no chunk multiplies per entry: coeff_k·z[:span_k] is
    computed once a call, identity and zero coefficients fold away, and
    each entry is one gather from concat([z] + premuls).

    Returns (eval_fn, prep): eval_fn(z, prep) → (az, bz, cz), each
    int32[R, 16]; prep holds the device tables (on `device`, the CUDA card
    by default). ELL entries are stored flat ([R·deg]), so one prep serves
    any chunk count.

    ``reuse=(meta, prep)``, from another call's ``eval_fn._layout_meta``
    and prep, skips the host layout build and the uploads: the witness
    completion's product and the check share one layout at their own
    chunk counts, and the reused entries are the same tensors. Only ELL
    and slice layouts can be reused (segment-sum layouts are chunk-count
    specific).

    Reference hot loop: test_cs.rs:239-253 (eval per constraint row)."""
    device = resolve(device)
    R_ = r.num_constraints
    if R_ == 0:
        return RowChunkedEval(r, 0, 0, names, {"modes": {}, "premul": False}), {}
    if n_chunks <= 0 or R_ % n_chunks:
        raise ValueError(f"n_chunks ({n_chunks}) must evenly divide num_constraints ({R_})")
    rpc = R_ // n_chunks
    N = r.num_inputs + r.num_aux  # == len(z) rows (input 0 is ONE)
    coeff_vals = [c % r.field.p for c in r.coeff_table]

    if reuse is not None:
        meta, shared = reuse
        missing = [n for n in names if n not in meta["modes"]]
        assert not missing, f"reused layout lacks matrices {missing}"
        assert all(
            meta["modes"][n][0] in ("ell", "slice") for n in names
        ), "segment-sum layouts are chunk-count-specific; cannot reuse"
        prep = {"coeff_limbs": shared["coeff_limbs"]}
        for n in names:
            mode = meta["modes"][n]
            prep[n] = {"start": [mode[1] + rpc * k for k in range(n_chunks)]} if mode[0] == "slice" else shared[n]
        return RowChunkedEval(r, rpc, n_chunks, names, meta), prep

    # Column span touched by each non-trivial coefficient, across all the
    # requested matrices: one masked max a non-trivial table entry.
    span = {}
    n_table = len(coeff_vals)
    nontrivial = np.asarray([cv not in (0, 1) for cv in coeff_vals])
    if premul_table is None or premul_table:
        for name in names:
            m = getattr(r, name)
            cids = np.asarray(m.coeff_ids)
            cols = np.asarray(m.cols)
            for k in np.nonzero(nontrivial)[0]:
                sel_k = cids == k
                if not sel_k.any():
                    continue
                mx_k = int(cols[sel_k].max())
                span[int(k)] = max(span.get(int(k), 0), mx_k + 1)
    sum_span = sum(span.values())
    if premul_table is None:
        premul_table = len(span) <= _PREMUL_MAX_TABLE and sum_span <= _PREMUL_MAX_ROWS
    # offset of each coefficient's premul slice in the gather source
    offset, cursor = {}, N
    for k in sorted(span):
        offset[k] = cursor
        cursor += span[k]
    is_zero = np.asarray([cv == 0 for cv in coeff_vals])
    is_one = np.asarray([cv == 1 for cv in coeff_vals])

    prep = {}
    modes = {}
    for name in names:
        m = getattr(r, name)
        rows_np = np.asarray(m.rows)
        degrees = np.bincount(rows_np, minlength=R_) if len(rows_np) else np.zeros(R_, np.int64)
        deg = max(int(degrees.max()), 1)
        if deg > MAX_ROW_NNZ:
            raise ValueError(
                f"matrix {name}: a row has {deg} entries; the digit "
                f"accumulation is exact only up to {MAX_ROW_NNZ} per row"
            )
        n_entries = len(rows_np)
        # ELL mode ([row, slot] entries, a dense row sum), unless one dense
        # row would blow the padding up: then the segment sum.
        use_ell = deg * R_ <= max(2 * n_entries, R_ * 4)
        if use_ell:
            # Uniform-degree row-sorted entries are the dense ELL layout
            # already: no lexsort, no position scatter.
            sorted_rows = n_entries == 0 or bool((rows_np[1:] >= rows_np[:-1]).all())
            uniform = sorted_rows and n_entries == R_ * deg
            if uniform:
                flat_cols = np.ascontiguousarray(m.cols, np.int32)
                flat_cids = np.ascontiguousarray(m.coeff_ids, np.int32)
                flat_mask = np.ones(R_ * deg, np.int32)
            else:
                if sorted_rows:
                    order = None
                    rows_s = rows_np
                else:
                    order = np.lexsort((np.arange(n_entries), rows_np))
                    rows_s = rows_np[order]
                ptr = np.zeros(R_ + 1, np.int64)
                np.cumsum(degrees, out=ptr[1:])
                slot = np.arange(n_entries) - ptr[rows_s]
                pos = rows_s * deg + slot  # dense ELL position of each entry
                flat_cols = np.zeros(R_ * deg, np.int32)
                flat_cids = np.zeros(R_ * deg, np.int32)
                flat_mask = np.zeros(R_ * deg, np.int32)
                if order is None:
                    flat_cols[pos] = np.asarray(m.cols)
                    flat_cids[pos] = np.asarray(m.coeff_ids)
                else:
                    flat_cols[pos] = np.asarray(m.cols)[order]
                    flat_cids[pos] = np.asarray(m.coeff_ids)[order]
                flat_mask[pos] = 1
            # A contiguous identity matrix (C rows selecting a dense aux
            # segment, cols = base + row): a chunk reads one slice of z.
            if (
                deg == 1
                and bool(flat_mask.all())
                and bool(is_one[flat_cids].all())
                and bool(np.array_equal(flat_cols, flat_cols[:1] + np.arange(R_, dtype=flat_cols.dtype)))
            ):
                modes[name] = ("slice", int(flat_cols[0]))
                prep[name] = {"start": [int(flat_cols[0]) + rpc * k for k in range(n_chunks)]}
                continue
            cols_p, cids_p, mask_p = flat_cols, flat_cids, flat_mask
            lrow_p = None
        else:
            order = np.argsort(rows_np, kind="stable")
            rows_s = rows_np[order]
            cols_s = np.asarray(m.cols)[order]
            cids_s = np.asarray(m.coeff_ids)[order]
            bounds = np.searchsorted(rows_s, np.arange(0, R_ + 1, rpc))
            counts = np.diff(bounds)
            e_max = max(int(counts.max()) if counts.size else 0, 1)
            cols_p = np.zeros((n_chunks, e_max), np.int32)
            cids_p = np.zeros((n_chunks, e_max), np.int32)
            lrow_p = np.zeros((n_chunks, e_max), np.int32)
            mask_p = np.zeros((n_chunks, e_max), np.int32)
            for k in range(n_chunks):
                s, e = int(bounds[k]), int(bounds[k + 1])
                n = e - s
                cols_p[k, :n] = cols_s[s:e]
                cids_p[k, :n] = cids_s[s:e]
                lrow_p[k, :n] = rows_s[s:e] - k * rpc
                mask_p[k, :n] = 1
        entry = {} if lrow_p is None else {"lrow": device_table(lrow_p, device, torch.int32)}
        if premul_table:
            # Host-side remap: identity → col, zero → masked out, other →
            # its premul slice. The raw cols and cids are not uploaded.
            assert cursor < (1 << 31)
            off_lut = np.zeros(n_table, np.int32)
            for k in span:
                off_lut[k] = offset[k]
            src_p = cols_p + off_lut[cids_p]
            full = bool(mask_p.all())
            if bool(is_zero[cids_p].any()):
                mask_p = mask_p.copy()
                mask_p[is_zero[cids_p]] = 0
                full = False
            if not full:
                src_p[mask_p == 0] = 0
            entry["src"] = device_table(src_p, device, torch.int32)
            if not full:
                entry["mask"] = device_table(mask_p, device, torch.int32)
        else:
            full = bool(mask_p.all())
            entry["cols"] = device_table(cols_p, device, torch.int32)
            entry["cids"] = device_table(cids_p, device, torch.int32)
            if not full:
                entry["mask"] = device_table(mask_p, device, torch.int32)
        prep[name] = entry
        modes[name] = ("ell", deg, full) if use_ell else ("seg",)
    # canonical: mul reads its multiplier as the field's ceil(NUM_BITS/32) words
    prep["coeff_limbs"] = from_numpy_u32(FieldBackend.to_limbs([int(c) % r.field.p for c in r.coeff_table]), device)
    meta = {"premul": premul_table, "span": span, "offset": offset, "modes": modes}
    return RowChunkedEval(r, rpc, n_chunks, names, meta), prep


def build_row_chunked_product(r: R1CS, n_chunks: int, premul_table: Optional[bool] = None,
                              use_pallas: Optional[bool] = None, reuse=None, *, device=None):
    """(A·z)∘(B·z) row-chunked: the witness completion of product-form
    systems. Each chunk's canonical blocks go through ``mul``; only the
    product is kept. `use_pallas` swaps the reference's jnp multiply for
    its Pallas one; the port has one route, so it is checked and ``mul``
    runs.

    Returns (prod_fn, prep); prod_fn(z, prep) → a new int32[R, 16]. It
    reads every chunk of z before its caller writes the product anywhere:
    a caller that completes z in place does so after the call.
    ``reuse=(check_fn._layout_meta, prep)`` shares another call's layout
    and device tables."""
    check_use_pallas(use_pallas)
    eval_fn, prep = build_row_chunked_eval(r, n_chunks, names=("a", "b"), premul_table=premul_table,
                                           reuse=reuse, device=device)
    R_ = r.num_constraints
    rpc = eval_fn._rpc

    def prod_fn(z, prep):
        if not R_:
            return torch.zeros((0, L16), dtype=torch.int32, device=z.device)
        cl = prep["coeff_limbs"]
        zsrc = eval_fn._zsrc(z, cl)
        xs = eval_fn._xs(prep, ("a", "b"))
        out = torch.empty((R_, L16), dtype=torch.int32, device=z.device)
        for k in range(eval_fn.n_chunks):
            az, bz = eval_fn._blocks(zsrc, cl, _chunk(xs, k), ("a", "b"))
            out[k * rpc : (k + 1) * rpc] = mul(az, bz, r.field).t()
        return out

    prod_fn._layout_meta = eval_fn._layout_meta
    return prod_fn, prep


def build_row_chunked_check(r: R1CS, n_chunks: int, premul_table: Optional[bool] = None,
                            use_pallas: Optional[bool] = None, reuse=None, *, device=None):
    """Row-chunked satisfiability of one huge system on one device: only
    (n_bad, first) survives a chunk.

    Two routes, both on the port's kernels on the card (their plain
    versions on the CPU); `use_pallas` keeps the reference's keyword so
    call sites port one for one:
      * None or True: the semi route wherever the layout allows it
        (``_semi_ok``) and 250 ≤ NUM_BITS ≤ 256: semi-reduced blocks into
        one ``mulcmp`` a chunk;
      * False (or where the semi route does not apply): canonical blocks
        (``reduce_digits`` a matrix), ``mul``, and a limb compare.
    ``check_fn._route`` names the route taken.

    Returns (check_fn, prep); check_fn(z, prep) → (n_bad, first) as int64
    0-d tensors on the device, first the least violated row or 0xFFFFFFFF;
    nothing syncs with the host. ``check_fn._layout_meta`` and prep can be
    passed as `reuse` to build_row_chunked_product."""
    check_use_pallas(use_pallas)
    eval_fn, prep = build_row_chunked_eval(r, n_chunks, premul_table=premul_table, reuse=reuse, device=device)
    R_ = r.num_constraints
    rpc = eval_fn._rpc
    field = r.field
    semi = use_pallas is not False and eval_fn._semi_ok and 250 <= field.NUM_BITS <= 256
    names = ("a", "b", "c")

    def check_fn(z, prep):
        if not R_:
            zero = torch.zeros((), dtype=torch.int64, device=z.device)
            return zero, zero + SENTINEL
        ar = torch.arange(rpc, dtype=torch.int64, device=z.device)
        cl = prep["coeff_limbs"]
        zsrc = eval_fn._zsrc(z, cl)
        xs = eval_fn._xs(prep, names)
        nbs, firsts = [], []
        for k in range(eval_fn.n_chunks):
            x = _chunk(xs, k)
            if semi:
                bad = mulcmp(*eval_fn._blocks_semi(zsrc, cl, x, names), field) != 0
            else:
                az, bz, cz = eval_fn._blocks(zsrc, cl, x, names)
                bad = (mul(az, bz, field) != cz).any(0)
            nbs.append(bad.sum())
            firsts.append(torch.where(bad, ar + k * rpc, SENTINEL).min())
        return torch.stack(nbs).sum(), torch.stack(firsts).min()

    check_fn._layout_meta = eval_fn._layout_meta
    check_fn._route = "semi" if semi else "canonical"
    return check_fn, prep
