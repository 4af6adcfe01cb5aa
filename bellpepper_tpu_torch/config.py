"""Runtime configuration of the port's device layer.

A copy of ``bellpepper_tpu/config.py``: the same frozen dataclass with the
same fields, defaults and checks, so one ``Config`` can be shared by the
satisfiers, the witness programs and the steps. Every consumer that takes
``config=`` falls back to its own defaults where the config leaves a field
unset, with the reference's precedence: an argument given explicitly
wins over the config.

``use_pallas`` picks a route through the port's CUDA kernels, never a
device and never the plain PyTorch versions (see the consumers'
docstrings). ``tile`` and ``limb_bits`` document the word contract: a
field element is 16 limbs of 16 bits (``int32[..., 16]``), and only those
values are accepted. ``make_mesh`` builds a ``torch.distributed``
``DeviceMesh`` over the ranks of the initialized process group
(``backend.sharding.default_mesh``); the port has one device a rank."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from .fields import SCALAR, PrimeField


@dataclass(frozen=True)
class Config:
    # Field choice (any PrimeField ≤ 255 bits; BLS12-381 Fr default).
    field: PrimeField = SCALAR
    # Kernel route: None = the port's default route; True/False as each
    # consumer documents (Satisfier: False is the DeviceR1CS route).
    use_pallas: Optional[bool] = None
    # Witness value domain: "limbs" (general field values) or "bits"
    # (0/1-valued witnesses — hash circuits).
    witness_form: str = "limbs"
    # Mesh geometry: number of ranks (None = every rank of the process
    # group) and axis name.
    mesh_devices: Optional[int] = None
    mesh_axis: str = "data"
    # Instance-batch size for templated satisfiers; must divide over the
    # mesh. Constraint-axis shard count for row-sharded checks (None =
    # one shard per mesh rank).
    batch: int = 1
    row_shards: Optional[int] = None
    # Batch tile and limb precision: only the shipped values are
    # implemented (the kernels bake in 16-bit limbs).
    tile: int = 1024
    limb_bits: int = 16

    def __post_init__(self):
        if self.witness_form not in ("limbs", "bits"):
            raise ValueError(f"witness_form: {self.witness_form!r}")
        if self.tile != 1024:
            raise ValueError("tile: only 1024 (8×128) is implemented")
        if self.limb_bits != 16:
            raise ValueError("limb_bits: only 16-bit limbs are implemented")
        if self.batch < 1:
            raise ValueError("batch must be >= 1")

    # -- derived ----------------------------------------------------------
    def make_mesh(self):
        from .backend.sharding import default_mesh

        return default_mesh(self.mesh_devices, self.mesh_axis)

    def with_(self, **kw) -> "Config":
        return replace(self, **kw)


_DEFAULT: Optional[Config] = None


def default_config() -> Config:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Config()
    return _DEFAULT


def set_default_config(cfg: Config) -> None:
    global _DEFAULT
    _DEFAULT = cfg
