"""The reference of `sha256-compress`: one SHA-256 compression of 512 free
message bits from the constant IV, as bellpepper's
``sha256_compression_function`` (crates/bellpepper/src/gadgets/sha256.rs)
synthesizes it, the input bits allocated first, each word's bits big-endian."""

from perfbench.reference.circuit import Circuit, MultiEq, const32, rotr, shr

ROUND_CONSTANTS = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]


def synthesize(p: int, capacity: int) -> Circuit:
    cs = Circuit(p, capacity)
    bits = [cs.alloc_bit() for _ in range(512)]
    w = [list(reversed(bits[i : i + 32])) for i in range(0, 512, 32)]
    state = [const32(v) for v in IV]
    meq = MultiEq(cs)
    for i in range(16, 64):
        s0 = cs.xor32(cs.xor32(rotr(w[i - 15], 7), rotr(w[i - 15], 18)), shr(w[i - 15], 3))
        s1 = cs.xor32(cs.xor32(rotr(w[i - 2], 17), rotr(w[i - 2], 19)), shr(w[i - 2], 10))
        w.append(cs.addmany(meq, [w[i - 16], s0, w[i - 7], s1]))

    # a and e are deferred sums: their operands join the next addmany that
    # reads them (sha256.rs:128-148); a list is a deferred sum.
    a, b, c, d, e, f, g, h = state
    a, e = ("word", a), ("word", e)

    def compute(x, others=()):
        return x[1] if x[0] == "word" else cs.addmany(meq, list(x[1]) + list(others))

    for i in range(64):
        new_e = compute(e)
        s1 = cs.xor32(cs.xor32(rotr(new_e, 6), rotr(new_e, 11)), rotr(new_e, 25))
        ch = cs.ch32(new_e, f, g)
        temp1 = [h, s1, ch, const32(ROUND_CONSTANTS[i]), w[i]]
        new_a = compute(a)
        s0 = cs.xor32(cs.xor32(rotr(new_a, 2), rotr(new_a, 13)), rotr(new_a, 22))
        maj = cs.maj32(new_a, b, c)
        h, g, f = g, f, new_e
        e = ("sum", temp1 + [d])
        d, c, b = c, b, new_a
        a = ("sum", temp1 + [s0, maj])
    compute(a, [state[0]])
    cs.addmany(meq, [state[1], b])
    cs.addmany(meq, [state[2], c])
    cs.addmany(meq, [state[3], d])
    compute(e, [state[4]])
    cs.addmany(meq, [state[5], f])
    cs.addmany(meq, [state[6], g])
    cs.addmany(meq, [state[7], h])
    meq.finish()
    return cs
