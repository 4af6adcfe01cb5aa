"""The word contract of the port.

A word is 32 bits: either 32 bit-sliced instances (bit j of word w is
instance 32·w + j) or one 16-bit limb / 8-bit digit sum. Torch has no
usable uint32 arithmetic on the CPU, so words are stored as ``torch.int32``
tensors holding the uint32 bit pattern. Bitwise ops (``& | ^ ~``) are exact
on that pattern; a right shift needs masking (``>>`` on int32 is
arithmetic); sums and products that may pass 2^31 are done in int64 and
masked with ``U32``. The CUDA kernels read the same buffers as
``uint32_t*``; numpy sees them as uint32 through ``.view(np.uint32)``.

Reference: ``bellpepper_tpu/compile/witness_program.py:329-345``
(pack_bits / unpack_bits) and ``bellpepper_tpu/backend/matvec.py:2998-3000``
(the popcount-based ctz of the packed verdict)."""

from __future__ import annotations

import numpy as np
import torch

U32 = 0xFFFFFFFF
FULL = -1  # all-ones word as int32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor → int32 tensor holding the low 32 bits (two's
    complement), defined for every int64 value."""
    return (((x & U32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 word tensor → int64 tensor of the uint32 value."""
    return x.to(torch.int64) & U32


def from_numpy_u32(a: np.ndarray, device=None) -> torch.Tensor:
    """uint32 numpy array → int32 word tensor (same bits)."""
    a = np.ascontiguousarray(np.asarray(a, np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def to_numpy_u32(x: torch.Tensor) -> np.ndarray:
    """int32 word tensor → uint32 numpy array (same bits)."""
    return x.detach().cpu().contiguous().numpy().view(np.uint32)


def device_table(a, device, dtype=torch.int64) -> torch.Tensor:
    """A host numpy index/constant table as a contiguous tensor on
    `device` (int64 by default, the index type of torch gathers)."""
    return torch.as_tensor(np.ascontiguousarray(a, np.int64), device=device).to(dtype)


def shr32(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32 words by a constant 0 <= k < 32."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (32 - k)) - 1)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[B, n] of 0/1 values → packed int32 [B//32, n]: bit j of word w =
    instance 32·w + j. B must be a multiple of 32."""
    B = bits.shape[0]
    if B % 32:
        raise ValueError("packed batch must be a multiple of 32")
    r = bits.to(torch.int64).reshape(B // 32, 32, -1)
    sh = torch.arange(32, dtype=torch.int64, device=bits.device)[None, :, None]
    return to_i32((r << sh).sum(dim=1))


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """packed int32 [Bw, n] → int32 [Bw·32, n] of 0/1 values."""
    sh = torch.arange(32, dtype=torch.int32, device=packed.device)[None, :, None]
    b = (packed.to(torch.int32)[:, None, :] >> sh) & 1
    return b.reshape(packed.shape[0] * 32, -1)


def unpack_rows(words: torch.Tensor) -> torch.Tensor:
    """int32[n, Bw] packed words → int32[n, Bw·32] of 0/1 (instance
    32·w + j), slot-major where unpack_bits is batch-major."""
    sh = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[:, :, None] >> sh) & 1).reshape(words.shape[0], -1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR population count of each 32-bit word → int64 counts."""
    v = to_u32(x) if x.dtype != torch.int64 else x & U32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & U32) >> 24


def ctz32(x: torch.Tensor) -> torch.Tensor:
    """Count of trailing zeros of each 32-bit word → int64 (32 for a zero
    word, as popcount((w & -w) - 1) gives in uint32)."""
    v = to_u32(x) if x.dtype != torch.int64 else x & U32
    return popcount32(((v & -v) - 1) & U32)
