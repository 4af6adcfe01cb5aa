"""The device of the port's entry points.

Every entry point (the evaluators, the checks, the production steps and
the chunked witness builders) runs on the CUDA card unless its caller
names another device: the CPU tests pass ``device="cpu"``. Without a card,
an entry point called without a device raises; it never falls back to
the CPU."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`device` as a torch.device, or the CUDA card when it is None."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
