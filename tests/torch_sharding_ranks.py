"""The rank side of tests/test_torch_sharding.py, tests/test_torch_multihost.py
and tests/test_torch_sharded_limbs.py (not collected by pytest): functions that the port's rank launcher
(bellpepper_tpu_torch.tools.dryrun_multichip.RankJob) runs on each
rank of a gloo group on the CPU. This module imports no JAX and nothing
of the JAX package, so neither does a rank; the test files hold what the
ranks return against the JAX reference in the parent process.

The ranks synthesize their templates through the port's NativeBuilder
(the parent builds the same ones), take their inputs as numpy arrays and
return int verdicts, strings and CPU tensors (their shards)."""

import sys

import numpy as np
import torch
import torch.distributed as dist

from bellpepper_tpu_torch import NativeBuilder, RowShardedSatisfier, WitnessProgram
from bellpepper_tpu_torch.backend.sharding import (
    ShardedSatisfier,
    default_group,
    default_mesh,
    global_verdict,
    sharded_packed_witness_and_check,
)
from bellpepper_tpu_torch.backend.words import from_numpy_u32, to_numpy_u32
from bellpepper_tpu_torch.compile.tape import corrupted
from bellpepper_tpu_torch.tools.dryrun_multichip import sha256_template
from bellpepper_tpu_torch.utils.multihost import global_group, global_mesh, make_global_batch, multihost_verdict_step


def config3():
    """Config 3 (benchmarks/configs_1_2_3.py:209-258): four u32 words,
    three addmany under one MultiEq, the sum packed into a field element."""
    nb = NativeBuilder()
    words = [nb.alloc_u32() for _ in range(4)]
    nb.multieq_begin()
    acc = words[0]
    for w in words[1:]:
        acc = nb.addmany([acc, w])
    nb.multieq_end()
    nb.pack_bits(acc)
    return nb.finish()


def config2():
    """A config-2 shape (benchmarks/configs_1_2_3.py:162-206): xor of two
    u32 words, rotated, and an addmany of three under one MultiEq."""
    nb = NativeBuilder()
    ops = [nb.alloc_u32() for _ in range(3)]
    nb.multieq_begin()
    x = [nb.xor(a, ops[1][(k + 7) % 32]) for k, a in enumerate(ops[0])]
    nb.addmany([x, ops[2][3:] + [nb.constant(False)] * 3, ops[0]])
    nb.multieq_end()
    return nb.finish()


def field_template():
    """A config-1 shape: 16 bits packed twice, then (mul, add, square) × 4."""
    nb = NativeBuilder()
    bits = [nb.alloc_bit() for _ in range(32)]
    a, b = nb.pack_bits(bits[:16]), nb.pack_bits(bits[16:])
    x = a
    for _ in range(4):
        x = nb.num_square(nb.num_add(nb.num_mul(x, b), a))
    return nb.finish()


def free_field_template():
    """x·pack(bits) + y, squared: free field inputs x and y (the step's
    free_field argument) beside 32 free bits; not pure bits, so the
    unpacked step takes the limbs form."""
    nb = NativeBuilder()
    x, y = nb.alloc_num(), nb.alloc_num()
    a = nb.pack_bits(nb.alloc_u32())
    nb.num_square(nb.num_add(nb.num_mul(x, a), y))
    return nb.finish()


def field_z3(rng, batch: int, flips):
    """The field template and its witness limbs uint32[batch, S, 16] from
    random free bits, clean, then with one limb of its first pack output
    flipped at each (instance, limb) of `flips`."""
    t, tape = field_template()
    prog = WitnessProgram(tape)
    free = from_numpy_u32(rng.integers(0, 2, size=(batch, 32)).astype(np.uint32), "cpu")
    z3 = to_numpy_u32(prog.z_template_limbs(*prog.build(device="cpu")(free)))
    pack = sorted(prog.field_rows, key=prog.field_rows.get)[0]
    out = [z3]
    for inst, limb in flips:
        z = z3.copy()
        z[inst, pack, limb] ^= 1
        out.append(z)
    return t, out


def free_field_inputs(rng, batch: int, p: int) -> dict:
    """The free-field template's free bits uint32[batch, 34] (0 in the
    two field slots) and its free field limbs uint32[batch, 2, 16] of
    random values below p."""
    prog = WitnessProgram(free_field_template()[1])
    bits = rng.integers(0, 2, size=(batch, len(prog.free_slots))).astype(np.uint32)
    bits[:, [prog.free_slots.index(s) for s in prog.free_field_slots]] = 0
    vals = [[int.from_bytes(rng.bytes(32), "little") % p for _ in prog.free_field_slots] for _ in range(batch)]
    limbs = np.asarray([[[(v >> (16 * k)) & 0xFFFF for k in range(16)] for v in row] for row in vals], np.uint32)
    return {"ff_bits": bits, "ff_limbs": limbs}


def foreign_modules() -> list:
    """The jax and JAX-package modules this process has loaded."""
    return sorted(m for m in sys.modules if m in ("jax", "bellpepper_tpu")
                  or m.startswith(("jax.", "jaxlib", "bellpepper_tpu.")))


def _packed(prog, template, batch, free, dev):
    step, shard = sharded_packed_witness_and_check(prog, template, batch, None, group=default_group(), device=dev)
    nb, first, vals = step(shard(free))
    return (int(nb), int(first)), vals.cpu()


def sharding_rank(dev, inp: dict) -> dict:
    """tests/test_torch_sharding.py's cases on one rank of the world."""
    torch.set_num_threads(1)
    out = {"world": dist.get_world_size(), "rank": dist.get_rank()}
    t, tape = sha256_template()
    out["sha256"] = _packed(WitnessProgram(tape), t, inp["sha_batch"], inp["sha_free"], dev)
    t, tape = config3()
    for name, tp in (("config3", tape), ("config3_bad", corrupted(tape, "pack", swap=True))):
        out[name] = _packed(WitnessProgram(tp), t, inp["c3_batch"], inp["c3_free"], dev)

    r1cs = inp["row_r1cs"]
    rsat = RowShardedSatisfier(r1cs, witness_form="limbs", device=dev, group=default_group())
    out["row_shards"] = [len(rsat._shards), rsat.n_shards]
    out["row"] = [(rsat.is_satisfied(z), rsat.which_is_unsatisfied(z))
                  for z in (rsat.z_from_assignments(inp["row_inputs"], aux) for aux in inp["row_aux"])]

    nb, first = inp["overflow"][dist.get_rank()]
    total, gfirst = global_verdict(torch.tensor(nb), torch.tensor(first), inp["overflow_span"])
    out["overflow"] = (int(total), int(gfirst))
    out["foreign"] = foreign_modules()
    return out


def multihost_rank(dev, inp: dict) -> dict:
    """tests/test_torch_multihost.py's cases on one rank: the production
    step through the multihost API on sha256 (called as the reference is,
    on ``global_mesh()``) and on a corrupted config-2 program (on the
    group), each rank passing its shard of the free bits as this process's
    local data; the meshes ``default_mesh`` builds (every rank, and the
    first alone); and RowShardedSatisfier on ``default_mesh()``, one row
    shard a rank, on one replicated witness of config 2."""
    torch.set_num_threads(1)
    group = global_group()
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    mesh = global_mesh()
    first_only = default_mesh(1)  # collective: every rank builds it; the others are outside it
    out = {"world": world, "mesh": (mesh.size(), tuple(mesh.mesh_dim_names), mesh.get_group("data") is group,
                                    first_only.size(), first_only.get_coordinate() is None)}
    t2, tape2 = config2()
    for name, (t, tape), free in (("sha256", sha256_template(), inp["sha_free"]),
                                  ("config2_bad", (t2, corrupted(tape2, "xor")), inp["c2_free"])):
        prog = WitnessProgram(tape)
        B = free.shape[0]
        share = free[rank * B // world : (rank + 1) * B // world]
        if name == "sha256":
            step, _shard = multihost_verdict_step(prog, t, B, mesh, device=dev)
            local = make_global_batch(share, mesh, device=dev)
        else:
            step, _shard = multihost_verdict_step(prog, t, B, None, group=group, device=dev)
            local = make_global_batch(share, None, group=group, device=dev)
        n_bad, z = step(local)
        out[name] = (int(n_bad), z.cpu())
    rsat = RowShardedSatisfier(t2, default_mesh(), witness_form="bits", device=dev)
    zr = from_numpy_u32(inp["c2_row_z"], dev)
    out["row_mesh"] = (rsat.n_shards, len(rsat._shards), rsat.is_satisfied(zr), rsat.which_is_unsatisfied(zr))
    out["foreign"] = foreign_modules()
    return out


def limbs_rank(dev, inp: dict) -> dict:
    """tests/test_torch_sharded_limbs.py's cases on one rank: the
    production step in the limbs form, with free field inputs, on the
    free-field template clean and with a corrupted pack (each input's
    share passed as this process's local data); ShardedSatisfier in the
    limbs form on the field template's global witnesses."""
    torch.set_num_threads(1)
    group = global_group()
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    out = {"world": world}
    t, tape = free_field_template()
    B = inp["ff_bits"].shape[0]
    share = slice(rank * B // world, (rank + 1) * B // world)
    for name, tp in (("free_field", tape), ("free_field_bad", corrupted(tape, "pack", swap=True))):
        step, _shard = multihost_verdict_step(WitnessProgram(tp), t, B, None, group=group, device=dev)
        n_bad, z = step(make_global_batch(inp["ff_bits"][share], None, group=group, device=dev),
                        make_global_batch(inp["ff_limbs"][share], None, group=group, device=dev))
        out[name] = (int(n_bad), z.cpu())
    t, _tape = field_template()
    sat = ShardedSatisfier(t, inp["field_batch"], group=group, device=dev)
    out["satisfier"] = [(sat.is_satisfied(sat.shard_z(z)), sat.which_is_unsatisfied(sat.shard_z(z)))
                        for z in inp["field_z3"]]
    out["foreign"] = foreign_modules()
    return out
