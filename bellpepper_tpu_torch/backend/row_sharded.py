"""One huge R1CS split along its constraint axis: the row-sharded layout
and checker.

Counterpart of ``bellpepper_tpu/backend/matvec.py``
``build_row_sharded_parts`` (``:798-934``) and
``bellpepper_tpu/backend/sharding.py`` ``RowShardedSatisfier``
(``:286-415``), with ``_PallasAdapter``'s ``mul_to_digits``,
``reduce_digits_lm`` and ``mul_lm`` (``matvec.py:1019-1055``) as the
kernels ``mul_digits``, ``reduce_digits`` and ``mul``.

The rows split into contiguous ranges, one a shard, with one shared ELL
bucket signature, so one function (``RowShardedSatisfier.check_local``)
evaluates any shard. The reference runs that function under
``shard_map`` on a mesh and reduces the verdict with ``psum``/``pmin``.
Without a mesh or a process group every shard runs on one device, one
after the other, and the shards' verdicts reduce on that device:
``n_bad`` by a sum, ``first`` by a min. Given a ``mesh`` or a ``group``,
each rank holds its own shard on its own device and the verdict reduces
over the ranks (``sharding.global_verdict``). The TILE padding of the Pallas adapters is
a TPU detail and is not ported."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import check_use_pallas, resolve
from ..r1cs import R1CS
from .check_common import SENTINEL
from .field_backend import FieldBackend
from .field_consts import L8, L16
from .field_kernels import mul, mul_digits, reduce_digits
from .layout import _assert_row_density
from .row_chunked import _gather_rows
from .words import from_numpy_u32


def build_row_sharded_parts(r1cs: R1CS, n_shards: int, with_coeff_digits: bool = True):
    """Partition an R1CS along the CONSTRAINT axis into n_shards row
    ranges with a SHARED ELL bucket signature.

    Returns (parts, meta): parts[name] holds numpy arrays stacked on a
    leading shard axis — cols and cids (per entry slot), and cd (the
    coefficient's 32 8-bit digits per slot) with `with_coeff_digits`;
    meta carries the bucket signature ((K, start_slot, n_rows) per
    matrix), rows_per_shard, rows_padded, row_origin (bucket position →
    local row id, −1 on padding), the coefficient table (0 appended when
    it has none) and zero_id. Every array equals the reference's."""
    R = r1cs.num_constraints
    rs = -(-R // n_shards)  # rows per shard (last padded with empty rows)
    for name in ("a", "b", "c"):
        _assert_row_density(np.asarray(getattr(r1cs, name).rows), R, f"matrix {name}")

    table = list(r1cs.coeff_table)
    try:
        zero_id = table.index(0)
    except ValueError:
        zero_id = len(table)
        table.append(0)
    coeff_limbs = FieldBackend.to_limbs(table)
    lo = coeff_limbs & np.uint32(0xFF)
    hi = (coeff_limbs >> 8) & np.uint32(0xFF)
    coeff_digits = np.stack([lo, hi], axis=-1).reshape(len(table), L8)  # [K, 32]

    # Per (shard, matrix): row nnz and sorted entries.
    shards = []
    for d in range(n_shards):
        lo_r, hi_r = d * rs, min((d + 1) * rs, R)
        shard = {}
        for name in ("a", "b", "c"):
            m = getattr(r1cs, name)
            m_rows, m_cols, m_cids = np.asarray(m.rows), np.asarray(m.cols), np.asarray(m.coeff_ids)
            sel = (m_rows >= lo_r) & (m_rows < hi_r)
            rows_l = m_rows[sel] - lo_r
            order = np.argsort(rows_l, kind="stable")
            nnz = np.bincount(rows_l, minlength=rs).astype(np.int64)
            K = np.maximum(1, 2 ** np.ceil(np.log2(np.maximum(nnz, 1))).astype(np.int64))
            shard[name] = (rows_l[order], m_cols[sel][order], m_cids[sel][order], nnz, K)
        shards.append(shard)

    # Shared signature: rows bucketed by the (Ka, Kb, Kc) triple; the
    # per-triple row count is padded to the max across shards. Triples
    # pack into one int64 key (K ≤ 2^20: nnz a row < 2^20).
    keys = []
    for shard in shards:
        ka, kb, kc = (shard[n][4] for n in ("a", "b", "c"))
        keys.append((ka << 40) | (kb << 20) | kc)
    uniq_keys = np.unique(np.concatenate(keys))
    uniq = np.stack(
        [(uniq_keys >> 40) & 0xFFFFF, (uniq_keys >> 20) & 0xFFFFF, uniq_keys & 0xFFFFF], axis=1
    )
    counts = np.zeros((n_shards, len(uniq)), np.int64)
    assign = []
    for d, k in enumerate(keys):
        idx = np.searchsorted(uniq_keys, k)
        assign.append(idx)
        counts[d] = np.bincount(idx, minlength=len(uniq))
    max_counts = counts.max(axis=0)  # rows a bucket, shared

    rs_padded = int(max_counts.sum())
    buckets = {n: [] for n in "abc"}
    slot_off = {n: 0 for n in "abc"}
    for bi, trip in enumerate(uniq):
        for mi, n in enumerate("abc"):
            buckets[n].append((int(trip[mi]), slot_off[n], int(max_counts[bi])))
            slot_off[n] += int(trip[mi]) * int(max_counts[bi])
    totals = {n: slot_off[n] for n in "abc"}

    parts = {
        n: {
            "cols": np.zeros((n_shards, totals[n]), np.int32),
            "cids": np.full((n_shards, totals[n]), zero_id, np.int32),
            **({"cd": np.zeros((n_shards, totals[n], L8), np.uint32)} if with_coeff_digits else {}),
        }
        for n in "abc"
    }
    row_origin = np.full((n_shards, rs_padded), -1, np.int32)

    row_base = np.concatenate([[0], np.cumsum(max_counts)[:-1]])
    for d, shard in enumerate(shards):
        idx = assign[d]
        n_rows_local = len(idx)
        # Rows ordered by (bucket, local id); a row's position in its
        # bucket is its running index less the bucket's start.
        order = np.lexsort((np.arange(n_rows_local), idx))
        cnt_d = np.bincount(idx, minlength=len(uniq))
        starts_sorted = np.concatenate([[0], np.cumsum(cnt_d)[:-1]])
        pos_sorted = np.arange(n_rows_local) - np.repeat(starts_sorted, cnt_d)
        pos_in_bucket = np.empty(n_rows_local, np.int64)
        pos_in_bucket[order] = pos_sorted
        row_origin[d, row_base[idx[order]] + pos_sorted] = order
        for n in "abc":
            rows_s, cols_s, cids_s, nnz, _K = shard[n]
            if len(rows_s) == 0:
                continue
            ptr = np.zeros(rs + 1, np.int64)
            np.cumsum(nnz, out=ptr[1:])
            bucket_k = np.array([b[0] for b in buckets[n]], np.int64)
            bucket_start = np.array([b[1] for b in buckets[n]], np.int64)
            row_slot0 = bucket_start[idx] + pos_in_bucket * bucket_k[idx]
            within = np.arange(len(rows_s)) - ptr[rows_s]
            target = row_slot0[rows_s] + within
            parts[n]["cols"][d, target] = cols_s
            if with_coeff_digits:
                parts[n]["cd"][d, target] = coeff_digits[cids_s]
            parts[n]["cids"][d, target] = cids_s
    meta = {
        "buckets": {n: tuple(buckets[n]) for n in "abc"},
        "rows_per_shard": rs,
        "rows_padded": rs_padded,
        "row_origin": row_origin,
        "coeff_table": table,
        "zero_id": zero_id,
    }
    return parts, meta


class RowShardedSatisfier:
    """Constraint-axis sharding of ONE huge (non-templated) R1CS — the
    reference's answer for config 5 below the row-chunked scan's sizes.
    The rows split into contiguous ranges with a shared ELL bucket
    signature, and ``check_local`` evaluates one shard.

    Given a `mesh` (a ``DeviceMesh``: its group along `axis`) or a
    process `group`, there is one shard a rank: each rank keeps only its
    own shard's tables, on its device (``sharding.rank_device``), z is
    replicated on every rank, and every rank gets the same answers
    (`n_shards`, if given, must be the group's size). Without either,
    `n_shards` shards (1 by default) run one after the other on `device`
    (the CUDA card by default). A `config` gives `mesh`
    (``config.make_mesh()``, unless a group or `n_shards` is given),
    `use_pallas`, `axis` and `witness_form` where they are None.

    witness_form ``"limbs"`` (the default; z int32[N, 16] limbs of any
    256-bit values): every entry's product with its coefficient by
    ``mul_digits``, bucket row sums, ``reduce_digits``, then ``mul`` and a
    limb compare: 3, 3 and 1 launches a shard. ``"bits"`` (z int32[N] of
    0/1 values): the coefficient's digit planes masked by the witness bit
    in place of ``mul_digits``. The reference's `use_pallas` swaps its jnp
    adapter for its Pallas one; here it is checked and the same kernels
    run."""

    def __init__(self, r1cs: R1CS, mesh=None, use_pallas: bool | None = None, axis: str | None = None,
                 witness_form: str | None = None, config=None, *, n_shards: Optional[int] = None, group=None,
                 device=None):
        from .sharding import mesh_group, rank_device

        if config is not None:
            if mesh is None and group is None and n_shards is None:
                mesh = config.make_mesh()
            use_pallas = config.use_pallas if use_pallas is None else use_pallas
            axis = config.mesh_axis if axis is None else axis
            witness_form = config.witness_form if witness_form is None else witness_form
        axis = axis or "data"
        witness_form = witness_form or "limbs"
        if witness_form not in ("limbs", "bits"):
            raise ValueError(f"witness_form must be 'limbs' or 'bits', got {witness_form!r}")
        self.use_pallas = check_use_pallas(use_pallas)
        if mesh is not None:
            group = mesh_group(mesh, axis)
        self.mesh = mesh
        self.group = group
        if group is None:
            n_shards = n_shards or 1
            self.device = resolve(device)
            own = range(n_shards)
        else:
            world = dist.get_world_size(group)
            if n_shards not in (None, world):
                raise ValueError(f"a group of {world} ranks checks {world} shards, not {n_shards}")
            n_shards = world
            self.device = rank_device(group, device)
            own = [dist.get_rank(group)]
        self.r1cs = r1cs
        self.field = r1cs.field
        self.n_shards = n_shards
        self.witness_form = witness_form
        self.num_slots = r1cs.num_inputs + r1cs.num_aux
        self._shards = []
        if not r1cs.num_constraints:  # vacuously satisfied; no layout to build
            return
        parts, meta = build_row_sharded_parts(r1cs, n_shards, with_coeff_digits=(witness_form == "bits"))
        self._meta = meta
        dev = self.device
        p = r1cs.field.p  # canonical multipliers: mul reads ceil(NUM_BITS/32) words of them
        self._coeff_lm = from_numpy_u32(FieldBackend.to_limbs([int(c) % p for c in meta["coeff_table"]]).T, dev)
        self._shard_ids = list(own)
        for d in own:
            local = {}
            for name in "abc":
                p = parts[name]
                e = {"cols": torch.from_numpy(p["cols"][d]).to(dev)}
                if witness_form == "bits":
                    e["cd"] = from_numpy_u32(p["cd"][d].T, dev)  # [32, total] limb-major
                else:
                    e["cids"] = torch.from_numpy(p["cids"][d]).to(dev)
                local[name] = e
            self._shards.append((local, torch.from_numpy(meta["row_origin"][d]).to(dev)))

    def _matvec_local(self, name: str, z: torch.Tensor, local) -> torch.Tensor:
        """One shard's rows of M·z: canonical int32[16, rows_padded]."""
        e = local[name]
        if self.witness_form == "bits":
            digits = e["cd"] * z.index_select(0, e["cols"])[None]  # [32, total]
        else:
            zv = _gather_rows(z, e["cols"]).t().contiguous()  # [16, total]
            cv = self._coeff_lm.index_select(1, e["cids"]).contiguous()
            digits = mul_digits(zv, cv, self.field)  # [32, total]
        sums = [
            digits[:, start : start + n_rows * k].reshape(L8, n_rows, k).sum(2, dtype=torch.int32)
            for k, start, n_rows in self._meta["buckets"][name]
        ]
        return reduce_digits(torch.cat(sums, dim=1), self.field)

    def check_local(self, z: torch.Tensor, local, origin: torch.Tensor, shard: int):
        """The verdict of one shard's rows, (n_bad, first) as int64 0-d
        tensors: first is the least global row index it violates (its
        origin plus shard·rows_per_shard, in int64), or 0xFFFFFFFF.
        Padded rows have origin −1 and all-zero entries (0·0 = 0), so they
        are never bad."""
        az, bz, cz = (self._matvec_local(n, z, local) for n in "abc")
        bad = (mul(az, bz, self.field) != cz).any(0)  # [rows_padded], bucket order
        orig = origin.to(torch.int64) + shard * self._meta["rows_per_shard"]
        return bad.sum(), torch.where(bad, orig, SENTINEL).min()

    def _check(self, z: torch.Tensor):
        """(n_bad, first) of z over every shard, reduced on the device (or
        over the group's ranks)."""
        want = (self.num_slots,) if self.witness_form == "bits" else (self.num_slots, L16)
        if z.dtype != torch.int32 or tuple(z.shape) != want:
            raise ValueError(f"z must be int32{list(want)}, got {z.dtype}{tuple(z.shape)}")
        if not self.r1cs.num_constraints:
            zero = torch.zeros((), dtype=torch.int64, device=z.device)
            return zero, zero + SENTINEL
        verdicts = [self.check_local(z, local, origin, d) for d, (local, origin) in zip(self._shard_ids, self._shards)]
        if self.group is not None:  # check_local has added rank · rows_per_shard
            from .sharding import global_verdict

            return global_verdict(*verdicts[0], 0, self.group)
        nbs, firsts = zip(*verdicts)
        return torch.stack(nbs).sum(), torch.stack(firsts).min()

    def z_from_assignments(self, inputs, aux) -> torch.Tensor:
        """Host witness → z = inputs ++ aux as limbs int32[N, 16] on the
        checker's device."""
        return from_numpy_u32(FieldBackend.to_limbs(list(inputs) + list(aux)), self.device)

    def is_satisfied(self, z: torch.Tensor) -> bool:
        n_bad, _ = self._check(z)
        return int(n_bad) == 0

    def which_is_unsatisfied(self, z: torch.Tensor) -> Optional[str]:
        n_bad, first = self._check(z)
        if int(n_bad) == 0:
            return None
        row = int(first)
        return self.r1cs.names[row] if self.r1cs.names is not None else f"constraint #{row}"
