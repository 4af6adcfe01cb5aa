"""Prime-field definitions: the host-side scalar oracle of the port.

A copy of ``bellpepper_tpu/fields.py`` (the port imports nothing of the
JAX package). Field elements on the host are plain Python ints in
``[0, p)`` (canonical form, no Montgomery representation), and a field is
a ``PrimeField`` object carrying the modulus and the trait-level metadata
the gadgets need (``NUM_BITS``, ``CAPACITY``, bit decompositions, byte
reprs).

Bulk field arithmetic runs on limb-decomposed torch tensors
(``bellpepper_tpu_torch.backend.field_backend`` and the CUDA kernels);
this class is the oracle they are tested against.
"""

from __future__ import annotations

from typing import List


class PrimeField:
    """A prime field 𝔽_p with the `ff::PrimeField`-equivalent constants.

    Mirrors the parts of the `ff` trait surface bellpepper actually uses:
      - ``NUM_BITS`` / ``CAPACITY``   (constraint_system + multieq packing)
      - ``to_repr`` little-endian bytes (TestConstraintSystem::hash,
        reference: crates/bellpepper-core/src/util_cs/test_cs.rs:108-111)
      - ``to_le_bits`` / ``char_le_bits`` (boolean.rs:320-364 decomposition)
      - scalar ops: add/sub/mul/neg/invert/pow/double/square
    """

    __slots__ = ("name", "p", "NUM_BITS", "CAPACITY", "REPR_BYTES", "ZERO", "ONE")

    def __init__(self, name: str, modulus: int, repr_bytes: int | None = None):
        self.name = name
        self.p = modulus
        self.NUM_BITS = modulus.bit_length()
        # ff defines CAPACITY as NUM_BITS - 1: how many bits always fit.
        self.CAPACITY = self.NUM_BITS - 1
        self.REPR_BYTES = repr_bytes if repr_bytes is not None else (self.NUM_BITS + 7) // 8
        self.ZERO = 0
        self.ONE = 1

    # -- scalar ops (canonical ints) ------------------------------------
    def add(self, a: int, b: int) -> int:
        s = a + b
        return s - self.p if s >= self.p else s

    def sub(self, a: int, b: int) -> int:
        d = a - b
        return d + self.p if d < 0 else d

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def neg(self, a: int) -> int:
        return (self.p - a) if a != 0 else 0

    def double(self, a: int) -> int:
        return self.add(a, a)

    def square(self, a: int) -> int:
        return (a * a) % self.p

    def invert(self, a: int) -> int | None:
        """Multiplicative inverse, or None for zero (like ff's CtOption)."""
        if a % self.p == 0:
            return None
        return pow(a, -1, self.p)

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def normalize(self, a: int) -> int:
        return a % self.p

    def from_u64(self, v: int) -> int:
        return v % self.p

    # -- representations -------------------------------------------------
    def to_repr(self, a: int) -> bytes:
        """Canonical little-endian byte representation (blstrs layout)."""
        return int(a).to_bytes(self.REPR_BYTES, "little")

    def from_repr(self, b: bytes) -> int:
        v = int.from_bytes(b, "little")
        if v >= self.p:
            raise ValueError("non-canonical field repr")
        return v

    def to_be_bytes(self, a: int) -> bytes:
        """Big-endian bytes as used in the CS shape hash (test_cs.rs:108-111)."""
        return int(a).to_bytes(self.REPR_BYTES, "big")

    def to_le_bits(self, a: int, n: int | None = None) -> List[bool]:
        """Little-endian bit decomposition, default length = repr bits."""
        if n is None:
            n = self.REPR_BYTES * 8
        return [bool((a >> i) & 1) for i in range(n)]

    def char_le_bits(self) -> List[bool]:
        return self.to_le_bits(self.p)

    # -- misc -------------------------------------------------------------
    def rand(self, rng) -> int:
        """Uniform field element from a python `random.Random`-like rng."""
        return rng.randrange(self.p)

    def __repr__(self) -> str:  # pragma: no cover
        return f"PrimeField({self.name}, {self.NUM_BITS} bits)"

    def __eq__(self, other) -> bool:
        return isinstance(other, PrimeField) and other.p == self.p

    def __hash__(self) -> int:
        return hash(self.p)


# BLS12-381 scalar field Fr (the field used throughout bellpepper's tests;
# NUM_BITS = 255, CAPACITY = 254 — multieq packing and the pinned sha256
# constraint counts depend on CAPACITY = 254).
SCALAR = PrimeField(
    "bls12_381_fr",
    0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    repr_bytes=32,
)

# Pasta curves (Nova/Lurk production fields).  pallas::Scalar == vesta::Base
# is Fq; vesta::Scalar == pallas::Base is Fp.
PALLAS_SCALAR = PrimeField(
    "pallas_fq",
    0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001,
    repr_bytes=32,
)
VESTA_SCALAR = PrimeField(
    "vesta_fp",
    0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001,
    repr_bytes=32,
)

FIELDS = {f.name: f for f in (SCALAR, PALLAS_SCALAR, VESTA_SCALAR)}
