"""Multi-process and multi-host glue on ``torch.distributed``.

Counterpart of ``bellpepper_tpu/utils/multihost.py:37-95``, with its
signatures. The reference joins processes with
``jax.distributed.initialize`` into one device set that one mesh spans;
here every process is one rank of a process group with one device
(``backend.sharding.rank_device``), ``global_mesh`` is a 1-D
``DeviceMesh`` over the ranks, and the sharded steps reduce their
verdicts with ``all_reduce`` over the mesh's group. The port's ``group``
and ``device`` come after the reference's parameters, keyword-only; a
caller passes ``mesh=None`` with a ``group``. The launcher
contract is the reference's: ``COORDINATOR_ADDRESS`` (host:port of rank
0's TCP store), ``NUM_PROCESSES`` and ``PROCESS_ID``.

The process group's backend is the one the caller names; without a name
it is ``nccl`` for a CUDA device (the card, the default) and ``gloo`` for
the CPU (``device="cpu"``). A backend that fails to initialize raises:
nothing falls back to another. NCCL refuses two ranks on one card, so
ranks that share a card take ``backend="gloo"`` from their caller."""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..backend.sharding import (
    default_group,
    default_mesh,
    mesh_group,
    rank_device,
    rank_mesh,
    sharded_witness_and_check,
)
from ..backend.words import as_words
from ..device import resolve


def init_group(address: str, world_size: int, rank: int, backend: Optional[str] = None, device=None) -> str:
    """``init_process_group`` over TCP at `address` (host:port) as `rank`
    of `world_size`, with `backend`, or nccl for a CUDA `device` (the card
    when None) and gloo for the CPU. Returns the backend."""
    if backend is None:
        backend = "nccl" if resolve(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world_size, rank=rank)
    return backend


def initialize_multihost(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, backend: Optional[str] = None, device=None) -> bool:
    """Join this process into a process group of `num_processes` ranks
    (``init_group``). Arguments default to the launcher variables
    COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID. Returns True when a
    group was initialized, False for the single-process case (no
    coordinator, fewer than two processes or no process id), as the
    reference does."""
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", "0") or 0)
    if process_id is None:
        process_id = int(os.environ.get("PROCESS_ID", "-1") or -1)
    if not coordinator_address or num_processes <= 1 or process_id < 0:
        return False
    init_group(coordinator_address, num_processes, process_id, backend, device)
    return True


def global_group():
    """The group of every rank (local and remote after
    ``initialize_multihost``), the group of ``global_mesh()``. Ranks
    are ordered by process id, so a contiguous shard stays on its
    process and only the verdict crosses processes."""
    return default_group()


def global_mesh(axis: str = "data", devices=None):
    """1-D ``DeviceMesh`` named `axis` over every rank of the process group
    (local and remote after ``initialize_multihost``), or over the ranks
    listed in `devices`. Ranks are ordered by process id, so a contiguous
    shard stays on its process and only the verdict crosses processes.
    Collective, as ``backend.sharding.default_mesh``."""
    return default_mesh(None, axis) if devices is None else rank_mesh(devices, axis)


def make_global_batch(local_batch, mesh, axis: str = "data", *, group=None, device=None) -> torch.Tensor:
    """This rank's share of the instance batch (numpy uint32 or a tensor
    of words), which the process passes, as int32 on the rank's device
    (`mesh`'s group along `axis`, else `group`, else the world's): the
    global batch is the ranks' shares in rank order and is never
    materialized in one place (``make_array_from_process_local_data``)."""
    dev = rank_device(mesh_group(mesh, axis, group), device)
    return as_words(local_batch, dev)


def multihost_verdict_step(prog, template, global_batch: int, mesh, axis: str = "data", *, group=None,
                           device=None):
    """The production step over the ranks of a (possibly multi-host) mesh
    or group: ``sharded_witness_and_check``; the same code on one host or
    many. Returns (step, shard)."""
    return sharded_witness_and_check(prog, template, global_batch, mesh, axis=axis, group=group, device=device)
