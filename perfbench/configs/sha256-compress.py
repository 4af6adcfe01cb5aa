"""`sha256-compress` through the program's public builder: one SHA-256
compression of 512 free message bits (allocated first) from the IV."""

from bellpepper_tpu_torch import NativeBuilder


def build():
    """→ (template R1CS, witness tape) of the circuit."""
    nb = NativeBuilder()
    bits = [nb.alloc_bit() for _ in range(512)]
    nb.sha256_compression(bits, nb.sha256_iv())
    return nb.finish()
