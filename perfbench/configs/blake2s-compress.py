"""`blake2s-compress` through the program's public builder: one BLAKE2s
compression of a free state h (256 bits, allocated first) and message m
(512 bits), t = 64, the final-block flag set."""

from bellpepper_tpu_torch import NativeBuilder


def build():
    """→ (template R1CS, witness tape) of the circuit."""
    nb = NativeBuilder()
    h = [nb.alloc_bit() for _ in range(256)]
    nb.blake2s_compression(h, [nb.alloc_bit() for _ in range(512)], 64, True)
    return nb.finish()
