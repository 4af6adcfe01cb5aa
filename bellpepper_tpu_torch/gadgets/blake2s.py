"""BLAKE2s (RFC 7693) circuit with 8-byte personalization support.

Re-design of reference crates/bellpepper/src/gadgets/blake2s.rs. The
mixing-G structure, SIGMA schedule, per-compression MultiEq scoping, and
final-block flag handling are preserved exactly; a 512-bit input costs the
pinned 21,518 constraints (blake2s.rs:456,479)."""

from __future__ import annotations

from typing import List

from ..constraint_system import ConstraintSystem
from .boolean import Boolean
from .multieq import MultiEq
from .uint32 import UInt32

R1 = 16
R2 = 12
R3 = 8
R4 = 7

SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]

BLAKE2S_IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]


def mixing_g(cs, v: List[UInt32], a: int, b: int, c: int, d: int, x: UInt32, y: UInt32) -> None:
    """The G mixing primitive (RFC 7693 §3.1; blake2s.rs:86-121).
    `cs` must have a MultiEq root."""
    v[a] = UInt32.addmany(cs.namespace("mixing step 1"), [v[a], v[b], x])
    v[d] = v[d].xor(cs.namespace("mixing step 2"), v[a]).rotr(R1)
    v[c] = UInt32.addmany(cs.namespace("mixing step 3"), [v[c], v[d]])
    v[b] = v[b].xor(cs.namespace("mixing step 4"), v[c]).rotr(R2)
    v[a] = UInt32.addmany(cs.namespace("mixing step 5"), [v[a], v[b], y])
    v[d] = v[d].xor(cs.namespace("mixing step 6"), v[a]).rotr(R3)
    v[c] = UInt32.addmany(cs.namespace("mixing step 7"), [v[c], v[d]])
    v[b] = v[b].xor(cs.namespace("mixing step 8"), v[c]).rotr(R4)


def blake2s_compression(
    cs: ConstraintSystem, h: List[UInt32], m: List[UInt32], t: int, f: bool
) -> None:
    """Compression function F (RFC 7693 §3.2; blake2s.rs:171-315)."""
    assert len(h) == 8
    assert len(m) == 16

    v = list(h) + [UInt32.constant(iv) for iv in BLAKE2S_IV]
    assert len(v) == 16

    v[12] = v[12].xor(cs.namespace("first xor"), UInt32.constant(t & 0xFFFFFFFF))
    v[13] = v[13].xor(cs.namespace("second xor"), UInt32.constant((t >> 32) & 0xFFFFFFFF))

    if f:
        v[14] = v[14].xor(cs.namespace("third xor"), UInt32.constant(0xFFFFFFFF))

    with MultiEq(cs) as mcs:
        for i in range(10):
            ns = mcs.namespace(f"round {i}")
            s = SIGMA[i % 10]
            mixing_g(ns.namespace("mixing invocation 1"), v, 0, 4, 8, 12, m[s[0]], m[s[1]])
            mixing_g(ns.namespace("mixing invocation 2"), v, 1, 5, 9, 13, m[s[2]], m[s[3]])
            mixing_g(ns.namespace("mixing invocation 3"), v, 2, 6, 10, 14, m[s[4]], m[s[5]])
            mixing_g(ns.namespace("mixing invocation 4"), v, 3, 7, 11, 15, m[s[6]], m[s[7]])
            mixing_g(ns.namespace("mixing invocation 5"), v, 0, 5, 10, 15, m[s[8]], m[s[9]])
            mixing_g(ns.namespace("mixing invocation 6"), v, 1, 6, 11, 12, m[s[10]], m[s[11]])
            mixing_g(ns.namespace("mixing invocation 7"), v, 2, 7, 8, 13, m[s[12]], m[s[13]])
            mixing_g(ns.namespace("mixing invocation 8"), v, 3, 4, 9, 14, m[s[14]], m[s[15]])

    for i in range(8):
        ns = cs.namespace(f"h[{i}] ^ v[{i}] ^ v[{i} + 8]")
        h[i] = h[i].xor(ns.namespace("first xor"), v[i])
        h[i] = h[i].xor(ns.namespace("second xor"), v[i + 8])


def blake2s(
    cs: ConstraintSystem, input_bits: List[Boolean], personalization: bytes
) -> List[Boolean]:
    """BLAKE2s-256 over little-endian bit input, with the 8-byte
    personalization XORed into h[6..8] (blake2s.rs:344-406)."""
    assert len(personalization) == 8
    assert len(input_bits) % 8 == 0

    p_lo = int.from_bytes(personalization[0:4], "little")
    p_hi = int.from_bytes(personalization[4:8], "little")

    h = [
        UInt32.constant(0x6A09E667 ^ 0x01010000 ^ 32),
        UInt32.constant(0xBB67AE85),
        UInt32.constant(0x3C6EF372),
        UInt32.constant(0xA54FF53A),
        UInt32.constant(0x510E527F),
        UInt32.constant(0x9B05688C),
        UInt32.constant(0x1F83D9AB ^ p_lo),
        UInt32.constant(0x5BE0CD19 ^ p_hi),
    ]

    blocks: List[List[UInt32]] = []
    for off in range(0, len(input_bits), 512):
        block = input_bits[off : off + 512]
        this_block = []
        for woff in range(0, len(block), 32):
            tmp = list(block[woff : woff + 32])
            while len(tmp) < 32:
                tmp.append(Boolean.constant(False))
            this_block.append(UInt32.from_bits(tmp))
        while len(this_block) < 16:
            this_block.append(UInt32.constant(0))
        blocks.append(this_block)

    if not blocks:
        blocks.append([UInt32.constant(0) for _ in range(16)])

    for i, block in enumerate(blocks[:-1]):
        blake2s_compression(cs.namespace(f"block {i}"), h, block, (i + 1) * 64, False)

    blake2s_compression(
        cs.namespace("final block"), h, blocks[-1], len(input_bits) // 8, True
    )

    out: List[Boolean] = []
    for word in h:
        out.extend(word.into_bits())
    return out
