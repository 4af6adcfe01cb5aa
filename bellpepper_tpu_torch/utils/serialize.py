"""Checkpoint / resume: R1CS and witness-shard serialization.

A copy of ``bellpepper_tpu/utils/serialize.py`` in the same npz format and
``_FORMAT_VERSION``: compiled R1CS matrices and witness shards round-trip
through npz files with a Blake2s shape fingerprint verified on load. The
fingerprint of an R1CS equals the reference's fingerprint of the same
R1CS (it hashes the COO arrays' bytes, so they are int32 in both
packages), and a file written by either package loads in the other.

``save_witness`` also takes the port's int32 word tensors (``words``) and
stores their uint32 bit pattern; ``load_witness`` returns uint32 numpy
limbs, as the reference does (``words.from_numpy_u32`` puts them on a
device)."""

from __future__ import annotations

import hashlib
import json
from typing import Optional, Tuple

import numpy as np
import torch

from ..backend.words import to_numpy_u32
from ..fields import FIELDS, PrimeField  # noqa: F401  (the reference module's names)
from ..r1cs import COOMatrix, R1CS

_FORMAT_VERSION = 1


def shape_fingerprint(r: R1CS) -> str:
    """Blake2s digest over the compiled shape: counts, COO triples, and
    coefficient table (canonical little-endian bytes)."""
    h = hashlib.blake2s()
    h.update(
        json.dumps(
            [
                _FORMAT_VERSION,
                r.field.name,
                r.num_inputs,
                r.num_aux,
                r.num_constraints,
            ]
        ).encode()
    )
    for name in ("a", "b", "c"):
        m = getattr(r, name)
        h.update(np.ascontiguousarray(m.rows).tobytes())
        h.update(np.ascontiguousarray(m.cols).tobytes())
        h.update(np.ascontiguousarray(m.coeff_ids).tobytes())
    for c in r.coeff_table:
        h.update(int(c).to_bytes(32, "little"))
    return h.hexdigest()


def save_r1cs(path: str, r: R1CS) -> str:
    """Write a compiled R1CS checkpoint; returns its fingerprint."""
    fp = shape_fingerprint(r)
    coeffs = np.frombuffer(
        b"".join(int(c).to_bytes(32, "little") for c in r.coeff_table),
        dtype=np.uint8,
    ).reshape(-1, 32)
    meta = {
        "version": _FORMAT_VERSION,
        "field": r.field.name,
        "num_inputs": r.num_inputs,
        "num_aux": r.num_aux,
        "num_constraints": r.num_constraints,
        "fingerprint": fp,
        "names": r.names,
    }
    np.savez_compressed(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        coeffs=coeffs,
        **{
            f"{n}_{f}": np.ascontiguousarray(getattr(getattr(r, n), f))
            for n in ("a", "b", "c")
            for f in ("rows", "cols", "coeff_ids")
        },
    )
    return fp


def load_r1cs(path: str, expect_fingerprint: Optional[str] = None) -> R1CS:
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        assert meta["version"] == _FORMAT_VERSION, "unknown checkpoint version"
        field = FIELDS[meta["field"]]
        coeffs_raw = z["coeffs"]
        coeff_table = [
            int.from_bytes(coeffs_raw[i].tobytes(), "little")
            for i in range(coeffs_raw.shape[0])
        ]
        mats = {
            n: COOMatrix(
                rows=z[f"{n}_rows"], cols=z[f"{n}_cols"], coeff_ids=z[f"{n}_coeff_ids"]
            )
            for n in ("a", "b", "c")
        }
        r = R1CS(
            field=field,
            num_inputs=meta["num_inputs"],
            num_aux=meta["num_aux"],
            num_constraints=meta["num_constraints"],
            a=mats["a"],
            b=mats["b"],
            c=mats["c"],
            coeff_table=coeff_table,
            names=meta["names"],
        )
    fp = shape_fingerprint(r)
    assert fp == meta["fingerprint"], "checkpoint fingerprint mismatch"
    if expect_fingerprint is not None:
        assert fp == expect_fingerprint, (
            f"loaded R1CS fingerprint {fp} != expected {expect_fingerprint}"
        )
    return r


def save_witness(
    path: str,
    z_limbs: np.ndarray,
    r1cs_fingerprint: str,
    shard: Tuple[int, int] = (0, 1),
) -> None:
    """Persist a witness (or witness shard) as limb planes with provenance:
    which R1CS it belongs to and which shard (index, count) it is.
    `z_limbs` is uint32 numpy or an int32 word tensor (on any device)."""
    if isinstance(z_limbs, torch.Tensor):
        z_limbs = to_numpy_u32(z_limbs)
    meta = {
        "version": _FORMAT_VERSION,
        "r1cs_fingerprint": r1cs_fingerprint,
        "shard_index": shard[0],
        "shard_count": shard[1],
    }
    np.savez_compressed(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        z=np.ascontiguousarray(np.asarray(z_limbs, dtype=np.uint32)),
    )


def load_witness(
    path: str, expect_fingerprint: Optional[str] = None
) -> Tuple[np.ndarray, dict]:
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        assert meta["version"] == _FORMAT_VERSION
        if expect_fingerprint is not None:
            assert meta["r1cs_fingerprint"] == expect_fingerprint, (
                "witness belongs to a different R1CS"
            )
        return z["z"], meta
