"""Process-level utilities of the port: serialization (checkpoint and
resume), phase profiling, and ``multihost`` (process groups and meshes
across hosts and ranks)."""

from .serialize import (
    load_r1cs,
    load_witness,
    save_r1cs,
    save_witness,
    shape_fingerprint,
)
from .profiling import phase, phase_report

__all__ = [
    "save_r1cs",
    "load_r1cs",
    "save_witness",
    "load_witness",
    "shape_fingerprint",
    "phase",
    "phase_report",
]
