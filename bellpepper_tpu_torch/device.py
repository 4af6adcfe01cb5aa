"""The device of the port's entry points.

Every entry point (the evaluators, the checks, the production steps and
the chunked witness builders) runs on the CUDA card unless its caller
names another device: the CPU tests pass ``device="cpu"``. Without a card,
an entry point called without a device raises; it never falls back to
the CPU.

An entry point takes the reference's parameters first, in the
reference's order and with its defaults, and the port's own (``device``,
and ``group`` or ``n_shards`` where it shards) after them, keyword-only.
The reference's ``use_pallas`` picks a route through the port's kernels,
never a device: each entry point says what its values mean.
``check_use_pallas`` refuses any other value than None, True or False."""

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


def check_use_pallas(use_pallas):
    """`use_pallas` as given, once it is None, True or False: anything else
    (a device, a witness form passed where the reference's argument now
    stands) raises TypeError, so a call written against an older signature
    fails loudly instead of meaning something else."""
    if use_pallas is not None and use_pallas is not True and use_pallas is not False:
        raise TypeError(f"use_pallas must be None, True or False, got {use_pallas!r}")
    return use_pallas
