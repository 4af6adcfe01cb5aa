"""The reference of `blake2s-compress`: one BLAKE2s compression of a free
state h (256 bits, allocated first) and a free message m (512 bits), byte
offset t = 64 and the final-block flag set, as bellpepper's
``blake2s_compression`` (crates/bellpepper/src/gadgets/blake2s.rs)
synthesizes it; words little-endian in bits."""

from perfbench.reference.circuit import Circuit, MultiEq, const32, rotr

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
IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]
T, FINAL = 64, True


def synthesize(p: int, capacity: int) -> Circuit:
    cs = Circuit(p, capacity)
    h = [cs.alloc_u32() for _ in range(8)]
    m = [cs.alloc_u32() for _ in range(16)]
    v = h + [const32(x) for x in IV]
    v[12] = cs.xor32(v[12], const32(T & 0xFFFFFFFF))
    v[13] = cs.xor32(v[13], const32(T >> 32))
    if FINAL:
        v[14] = cs.xor32(v[14], const32(0xFFFFFFFF))
    meq = MultiEq(cs)

    def g(a, b, c, d, x, y):  # the mixing function G (RFC 7693 3.1)
        v[a] = cs.addmany(meq, [v[a], v[b], x])
        v[d] = rotr(cs.xor32(v[d], v[a]), 16)
        v[c] = cs.addmany(meq, [v[c], v[d]])
        v[b] = rotr(cs.xor32(v[b], v[c]), 12)
        v[a] = cs.addmany(meq, [v[a], v[b], y])
        v[d] = rotr(cs.xor32(v[d], v[a]), 8)
        v[c] = cs.addmany(meq, [v[c], v[d]])
        v[b] = rotr(cs.xor32(v[b], v[c]), 7)

    for i in range(10):
        s = SIGMA[i]
        for k, (a, b, c, d) in enumerate([(0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
                                          (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14)]):
            g(a, b, c, d, m[s[2 * k]], m[s[2 * k + 1]])
    meq.finish()
    for i in range(8):
        cs.xor32(cs.xor32(h[i], v[i]), v[i + 8])
    return cs
