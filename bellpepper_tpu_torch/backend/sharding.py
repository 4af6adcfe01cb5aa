"""Multi-GPU scaling on ``torch.distributed``: the sharded steps and the
sharded templated checker.

Counterpart of ``bellpepper_tpu/backend/sharding.py``, with its
signatures: ``default_mesh`` (``:35``) is a 1-D ``torch.distributed``
``DeviceMesh`` over the ranks of the process group, and every ``mesh``
argument takes one (``mesh.get_group(axis)`` is the group it shards
over); ``default_group`` and ``rank_device`` are the port's own.
``ShardedSatisfier`` (``:42-136``), ``sharded_witness_and_check``
(``:139-193``) and ``sharded_packed_witness_and_check`` (``:196-283``)
keep their names and parameters, with the port's ``group`` and ``device``
after them, keyword-only: a caller names a mesh or a group (neither: the
world group). ``RowShardedSatisfier`` (``:286-415``) is
``backend/row_sharded.py``'s class, re-exported here. The reference's
``use_pallas`` swaps jnp code for Pallas kernels; here it is checked and
the same kernels run.

One shard a rank and one device a rank. Where the reference runs one SPMD
program under ``shard_map`` over a mesh, every rank of a process group
runs the single-device function on its contiguous share of the instance
batch (or of the rows), and ``global_verdict`` reduces the verdict with
``all_reduce``: the violation counts by SUM, the first violation by MIN
(``global_count``, the SUM alone, where a step reports no first one).
Instances are the leading axis and shards are contiguous, so the merge
order is the instance order and a sharded result equals the single-rank
one (the extend associativity of ``constraint_system.rs:138-148``).

The caller creates the process group (``utils/multihost.py``) and names
its backend; nothing here picks a backend or a device by itself. The
reference adds a shard's base to its first violation in uint32
(``:102-104``, ``:270-272``, ``:381-383``), which wraps and can collide
with the 0xFFFFFFFF sentinel once batch × rows nears 2^32; here every
index is int64 up to the MIN."""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import check_use_pallas, resolve
from ..r1cs import R1CS
from .check_common import NONE, SENTINEL
from .matvec import build_packed_parts, build_templated_check
from .satisfier import which_from_flat
from .words import as_words


def default_group(n_ranks: Optional[int] = None):
    """The world process group, or the subgroup of its first `n_ranks`
    ranks (``dist.new_group``: every rank of the world must make the same
    call, and a rank outside the subgroup gets ``GroupMember.NON_GROUP_
    MEMBER``). The group must exist: ``utils.multihost`` creates it."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: initialize one first (utils.multihost.initialize_multihost)")
    if n_ranks is None or n_ranks == dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(list(range(n_ranks)))


def rank_mesh(ranks, axis: str = "data"):
    """A 1-D ``DeviceMesh`` named `axis` over `ranks` of the process group:
    one device a rank, so a mesh of n ranks shards over n devices. Its
    device type follows the group's backend (``cuda`` for NCCL, ``cpu`` for
    gloo); the port reads only its group. Building a mesh is collective:
    every rank of the world makes the same call, and a rank outside the
    mesh gets one whose ``get_coordinate()`` is None. Without a process
    group it raises, as ``default_group`` does."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: initialize one first (utils.multihost.initialize_multihost)")
    from torch.distributed.device_mesh import DeviceMesh

    ranks = [int(r) for r in ranks]
    if not ranks or not all(0 <= r < dist.get_world_size() for r in ranks):
        raise ValueError(f"a mesh takes ranks in 0..{dist.get_world_size() - 1}, got {ranks}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, ranks, mesh_dim_names=(axis,))


def default_mesh(n_devices: Optional[int] = None, axis: str = "data"):
    """``rank_mesh`` over the first `n_devices` ranks (every rank when
    None): the counterpart of the reference's mesh over the first
    `n_devices` devices."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    return rank_mesh(range(world if n_devices is None else n_devices), axis)


def mesh_group(mesh=None, axis: str = "data", group=None):
    """The process group a sharded entry point runs over: `mesh`'s group
    along `axis`, else `group`, else the world group. A rank outside the
    mesh, a mesh without that axis or both a mesh and a group raise."""
    if mesh is None:
        return default_group() if group is None else group
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh or None, got {type(mesh).__name__}")
    if group is not None:
        raise ValueError("pass a mesh or a group, not both")
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no axis {axis!r} (it has {mesh.mesh_dim_names})")
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    return mesh.get_group(axis)


def rank_device(group=None, device=None) -> torch.device:
    """This rank's device: `device` when the caller names one other than a
    bare ``"cuda"`` (``"cpu"`` for the CPU), else ``cuda:{local_rank %
    device_count}`` with local_rank from ``LOCAL_RANK`` or the rank in
    `group`, made the current CUDA device (NCCL's communicators use it). So
    on a machine with several cards each rank gets its own, and on one card
    every rank shares it. Without a card it raises, as every entry point
    does."""
    if device is not None:
        d = torch.device(device)
        if d.type != "cuda" or d.index is not None:
            return d
    resolve(device)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank(group)))
    d = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(d)
    return d


def global_count(n_bad: torch.Tensor, group=None) -> torch.Tensor:
    """The SUM over the ranks of `group` of each rank's violation count
    n_bad (a 0-d tensor), as an int64 0-d tensor on its device: one
    ``all_reduce``, for the steps that report no first violation."""
    nb = n_bad.to(torch.int64).reshape(1).clone()
    dist.all_reduce(nb, op=dist.ReduceOp.SUM, group=group)
    return nb[0]


def global_verdict(n_bad: torch.Tensor, first: torch.Tensor, local_span: int, group=None):
    """The verdict over the ranks of `group` from each rank's own: n_bad
    and first (0-d tensors, first 0xFFFFFFFF when the rank found nothing)
    with first relative to the rank's share, whose index span is
    `local_span`; this rank's offset rank · local_span is added in int64
    (0 where first is global already). Returns (total, first) as int64 0-d
    tensors on first's device: the SUM of the counts and the MIN of the
    firsts, 0xFFFFFFFF when no rank found a violation."""
    off = dist.get_rank(group) * local_span
    nb = n_bad.to(torch.int64).reshape(1).clone()
    glob = torch.where(nb > 0, first.to(torch.int64).reshape(1) + off, NONE)
    dist.all_reduce(nb, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(glob, op=dist.ReduceOp.MIN, group=group)
    return nb[0], torch.where(glob[0] == NONE, SENTINEL, glob[0])


def shard_rows(x, n_global: int, group, device) -> torch.Tensor:
    """This rank's contiguous share of x's leading axis (n_global long,
    numpy uint32 or a tensor of words) as int32 on `device`: the
    counterpart of ``NamedSharding(mesh, P(axis))``."""
    if x.shape[0] != n_global:
        raise ValueError(f"the global array's leading axis must be {n_global}, got {tuple(x.shape)}")
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    n = n_global // world
    part = x[rank * n : (rank + 1) * n]
    return as_words(part, device)


def _world(group, batch: int):
    world = dist.get_world_size(group)
    if batch % world:
        raise ValueError(f"batch {batch} must divide evenly over the {world} ranks")
    return group, batch // world


class ShardedSatisfier:
    """Templated satisfiability over the ranks of a mesh or process group:
    the global batch of `batch` instances splits into contiguous shares of
    batch / world, each rank checks its own with the single-device
    templated check (``build_templated_check`` at the local batch) on its
    device, and the verdict reduces over the ranks. ``witness_form``:
    ``"limbs"`` (the default; z int32[B, S_t, 16]) or ``"bits"`` (z
    int32[B, S_t] of 0/1 values). A `config` gives `batch`, `mesh`
    (``config.make_mesh()``, unless a `group` is given), `use_pallas`,
    `axis` and `witness_form` where they are None. Every rank gets the same
    answers."""

    def __init__(self, template: R1CS, batch: int | None = None, mesh=None, use_pallas: bool | None = None,
                 axis: str | None = None, witness_form: str | None = None, config=None, *, group=None,
                 device=None):
        if config is not None:
            batch = config.batch if batch is None else batch
            if mesh is None and group is None:
                mesh = config.make_mesh()
            use_pallas = config.use_pallas if use_pallas is None else use_pallas
            axis = config.mesh_axis if axis is None else axis
            witness_form = config.witness_form if witness_form is None else witness_form
        if batch is None:
            raise ValueError("batch required (directly or via config)")
        axis = axis or "data"
        witness_form = witness_form or "limbs"
        if witness_form not in ("limbs", "bits"):
            raise ValueError(f"witness_form must be 'limbs' or 'bits', got {witness_form!r}")
        self.use_pallas = check_use_pallas(use_pallas)
        self.group, self.local_b = _world(mesh_group(mesh, axis, group), batch)
        self.mesh = mesh
        self.axis = axis
        self.r1cs = template
        self.batch = batch
        self.witness_form = witness_form
        self.device = rank_device(self.group, device)
        self._check = build_templated_check(template, self.local_b, use_pallas, witness_form, device=self.device)
        self._span = self.local_b * template.num_constraints
        self.num_constraints_total = batch * template.num_constraints

    def shard_z(self, z3) -> torch.Tensor:
        """The global witness (numpy uint32 or a host tensor, instances
        leading) → this rank's contiguous share on its device."""
        return shard_rows(z3, self.batch, self.group, self.device)

    def _verdict(self, z_local: torch.Tensor):
        nb, first = self._check.verdict(z_local)
        nb, first = global_verdict(nb, first, self._span, self.group)
        return int(nb), int(first)

    def is_satisfied(self, z3: torch.Tensor) -> bool:
        """z3: this rank's share, as ``shard_z`` gives it."""
        return int(global_count(self._check.verdict(z3)[0], self.group)) == 0

    def which_is_unsatisfied(self, z3: torch.Tensor) -> Optional[str]:
        """'instance {inst}: {name}' of the first violation over every
        rank, or None; z3 is this rank's share."""
        nb, first = self._verdict(z3)
        return which_from_flat(self.r1cs, first) if nb else None


def sharded_witness_and_check(prog, template: R1CS, batch: int, mesh, use_pallas: bool | None = None,
                              axis: str = "data", *, group=None, device=None):
    """The sharded production step: free inputs → witness generation
    (``prog.build``) → the templated check, on every rank for its share.

    Returns (step, shard). step(free_bits int32[local_b, n_free],
    free_field int32[local_b, nf, 16] or None) → (n_bad, z_local): n_bad
    summed over the ranks (int64 0-d), z_local this rank's witness, the
    0/1 values int32[local_b, S] of a pure-bit program (the bits form) or
    limbs int32[local_b, S, 16] (the limbs form). The witness stays
    sharded. shard(x) puts this rank's share of a global host array on its
    device."""
    check_use_pallas(use_pallas)
    group, local_b = _world(mesh_group(mesh, axis, group), batch)
    dev = rank_device(group, device)
    pure_bits = prog.is_pure_bits
    check = build_templated_check(template, local_b, use_pallas, "bits" if pure_bits else "limbs", device=dev)
    evaluator = prog.build(use_pallas, device=dev)

    def step(free_bits: torch.Tensor, free_field=None):
        if free_bits.shape[0] != local_b:
            raise ValueError(f"free_bits must hold this rank's {local_b} instances, got {tuple(free_bits.shape)}")
        vals, flimbs = evaluator(free_bits, free_field)
        z = vals if pure_bits else prog.z_template_limbs(vals, flimbs, free_field)
        return global_count(check.verdict(z)[0], group), z

    return step, lambda x: shard_rows(x, batch, group, dev)


def sharded_packed_witness_and_check(prog, template: R1CS, batch: int, mesh, use_pallas: bool | None = None,
                                     axis: str = "data", *, group=None, device=None):
    """The bit-sliced production step over the ranks: packed free bits →
    packed witness generation (32 instances a word) → the ``bits_packed``
    check's verdict, reduced over the ranks. The multi-device program of
    the flagship path; it runs the pieces of ``build_packed_production_
    step`` (``matvec.build_packed_parts``: a ``pack``-output template,
    config 3, takes the mixed packed layout as there).

    Returns (step, shard). step(free_packed int32[local_b/32, n_free]) →
    (n_bad, first, vals_local): the global count and the global instance-
    major first index instance·R + row (int64 0-d; 0xFFFFFFFF when
    clean), and this rank's packed witness int32[local_b/32, S]. shard(x)
    puts this rank's share of the global words [batch/32, n_free] on its
    device."""
    check_use_pallas(use_pallas)
    group, local_b = _world(mesh_group(mesh, axis, group), batch)
    if local_b % 512:
        raise ValueError("packed sharding needs >= 512 instances (16 packed words) a rank, a multiple of 512")
    dev = rank_device(group, device)
    evaluator, check = build_packed_parts(prog, template, local_b, dev)
    span = local_b * template.num_constraints

    def step(free_packed: torch.Tensor):
        if free_packed.shape[0] != local_b // 32:
            raise ValueError(
                f"free_packed must hold this rank's {local_b // 32} words, got {tuple(free_packed.shape)}"
            )
        vals_p, flimbs_p = evaluator.slot_major(free_packed)
        total, first = global_verdict(*check.verdict_slot_major(vals_p, flimbs_p), span, group)
        return total, first, vals_p.t().contiguous()

    return step, lambda x: shard_rows(x, batch // 32, group, dev)


# The reference module's row-sharded checker. Imported last: row_sharded
# imports this module's reductions.
from .row_sharded import RowShardedSatisfier  # noqa: E402
