"""The card's op-rate probe: wrapper, plain version, launch count.

Counterpart of ``benchmarks/probe_vpu_ops.py`` (the TPU VPU probe, a
Pallas kernel at :87): R independent rows of N elements, K rounds of one
op class on every element, the rows summed into one output row. The
kernel (``csrc/op_rate.cu``) keeps an element's R rows in registers, so
the rounds of one row depend on each other and the R rows do not (R-way
ILP): the time of a launch gives the card's issue rate of the op class,
R·K·N rounds over the time. It lies on no path of the system; it measures
the card's integer issue rate.

The op classes and their round bodies are the probe's (u32 words are
int32 tensors holding the bit pattern, as in ``words``):

  ==================  ==============================================
  class               round
  ==================  ==============================================
  ``u32_add``         v + (v | 1)
  ``u32_mul``         v·(v | 1)
  ``u16_mul``         (v & 0xFFFF)·3
  ``u32_shift_and``   (v >> 3) & 0xFFFF
  ``f32_mul``         v·v
  ``f32_fma``         v·v + v (one rounding on the card, two in the
                      plain version)
  ``cvt_u32_f32``     u32 → i32 → f32 → i32 → u32 (exact for values
                      below 2^24; the probe's inputs are 1..99)
  ==================  ==============================================

Integer sums over the rows wrap at 2^32; f32 sums run in row order."""

from __future__ import annotations

import torch

from .field_kernels import _check_words, _launch, _on_cuda, _stream
from .words import U32, to_i32, to_u32

OPS = ("u32_add", "u32_mul", "u16_mul", "u32_shift_and", "f32_mul", "f32_fma", "cvt_u32_f32")
FLOAT_OPS = ("f32_mul", "f32_fma")
ROWS = (1, 2, 4, 8, 16)  # the kernel's instantiations of R


def _round(op: str, v: torch.Tensor) -> torch.Tensor:
    """One round on int64-held u32 values or float32 values."""
    if op == "u32_add":
        return (v + (v | 1)) & U32
    if op == "u32_mul":
        return (v * (v | 1)) & U32
    if op == "u16_mul":
        return (v & 0xFFFF) * 3
    if op == "u32_shift_and":
        return (v >> 3) & 0xFFFF
    if op == "f32_mul":
        return v * v
    if op == "f32_fma":
        return v * v + v
    # cvt: the u32 pattern as i32, to f32, truncated back to i32, as u32
    return to_u32(to_i32(v).to(torch.float32).to(torch.int32))


def op_rate(x: torch.Tensor, op: str, rounds: int) -> torch.Tensor:
    """x [R, N] (int32 words, or float32 for the f32 classes; R in
    ``ROWS``) → [N], the sum over the rows of each row after `rounds`
    rounds of `op`."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if x.dim() != 2 or x.shape[0] not in ROWS:
        raise ValueError(f"x must be [R, N] with R in {ROWS}, got {tuple(x.shape)}")
    if op in FLOAT_OPS:
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise TypeError(f"{op} takes contiguous float32 rows, got {x.dtype}")
    else:
        _check_words("x", x)
    if not 0 <= rounds < 1 << 31:
        raise ValueError(f"rounds must be a non-negative int32, got {rounds}")
    if not _on_cuda(x):
        return op_rate_plain(x, op, rounds)
    R, N = x.shape
    out = torch.empty(N, dtype=x.dtype, device=x.device)
    if N:
        if -(-N // 256) >= 1 << 31:
            raise ValueError(f"N = {N} exceeds the kernel's grid")
        _launch("bp_op_rate", x.data_ptr(), out.data_ptr(), R, N, OPS.index(op), rounds, stream=_stream(x))
        op_rate.launches += 1
    return out


def op_rate_plain(x: torch.Tensor, op: str, rounds: int) -> torch.Tensor:
    """Plain version: the same rounds on each row, int64 with uint32
    masking for the integer classes, float32 for the f32 ones."""
    flt = op in FLOAT_OPS
    rows = [r.clone() if flt else to_u32(r) for r in x.unbind(0)]
    for _ in range(rounds):
        rows = [_round(op, v) for v in rows]
    acc = rows[0]
    for v in rows[1:]:
        acc = acc + v if flt else (acc + v) & U32
    return acc if flt else to_i32(acc)


op_rate.launches = 0
