"""The rank side of tests/test_torch_sharding.py, tests/test_torch_multihost.py
and tests/test_torch_sharded_limbs.py (not collected by pytest): functions that the port's rank launcher
(bellpepper_tpu_torch.tools.dryrun_multichip.RankJob) runs on each
rank of a gloo group on the CPU; and those of the sharded card test of
tests/test_torch_cuda.py (``card_rank``: two gloo ranks sharing the card,
held to ``card_paths`` run whole on the card). This module imports no JAX
and nothing of the JAX package, so neither does a rank; the CPU test files
hold what the ranks return against the JAX reference in the parent
process.

The ranks synthesize their templates through the port's NativeBuilder
(the parent builds the same ones), take their inputs as numpy arrays and
return int verdicts, strings and CPU tensors (their shards)."""

import sys

import numpy as np
import torch
import torch.distributed as dist

from bellpepper_tpu_torch import (
    NativeBuilder,
    RowShardedSatisfier,
    TemplatedSatisfier,
    WitnessProgram,
    build_packed_production_step,
    build_production_step,
    build_row_chunked_check,
    build_row_chunked_product,
)
from bellpepper_tpu_torch.backend.sharding import (
    ShardedSatisfier,
    default_group,
    default_mesh,
    global_verdict,
    sharded_packed_witness_and_check,
    sharded_witness_and_check,
)
from bellpepper_tpu_torch.backend.words import from_numpy_u32, to_numpy_u32
from bellpepper_tpu_torch.compile.tape import corrupted
from bellpepper_tpu_torch.tools.config5 import config5_r1cs, config5_z
from bellpepper_tpu_torch.tools.dryrun_multichip import dryrun_rank, sha256_template
from bellpepper_tpu_torch.utils.multihost import global_group, global_mesh, make_global_batch, multihost_verdict_step
from torch_circuits import corrupt_free_xor, counted as launches


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


# --- the sharded card test ---------------------------------------------------------
CARD_LIMBS_FLIP = (200, 9000, 0)  # (instance, slot, limb) of the limbs path's flipped limb
CARD_ROW_LOG2_R = 16  # config 5's rows in the row-sharded path


def card_inputs() -> dict:
    """The sharded card test's global inputs, from a seed: the packed
    step's free words [128, 512] (4,096 instances) and the bits step's free
    bits [256, 512], each clean and with the corrupted xor's two free bits
    zeroed in the first half of the batch (so that its first failing
    instance lies in the second half, the last rank's), and the limbs
    path's free bits [256, 512]."""
    rng = np.random.default_rng(0x5EED_0C4D)
    _t, tape = sha256_template()
    _bad, (i, j) = corrupt_free_xor(tape)
    inp = {"packed": rng.integers(0, 1 << 32, size=(128, 512), dtype=np.uint64).astype(np.uint32),
           "bits": rng.integers(0, 2, size=(256, 512)).astype(np.uint32),
           "limbs": rng.integers(0, 2, size=(256, 512)).astype(np.uint32)}
    for key in ("packed", "bits"):
        bad = inp[key].copy()
        bad[: bad.shape[0] // 2, [i, j]] = 0
        inp[key + "_bad"] = bad
    return inp


def _ints(v) -> tuple:
    return tuple(int(x) for x in v)


def card_paths(dev, inp: dict, group) -> dict:
    """The sharded card test's paths on `dev`: over the ranks of `group`
    (this rank's shard), or with group None whole on one device. Returns
    the verdicts (and names) of each path, clean and corrupted, the packed
    and bits witness (this rank's rows) and the launches of each path's
    calls."""
    template, tape = sha256_template()
    tape_bad, _ = corrupt_free_xor(tape)
    progs = {"": WitnessProgram(tape), "_bad": WitnessProgram(tape_bad)}
    out = {"verdict": {}, "shard": {}, "launches": {}}

    def counted(path, fn):
        res, out["launches"][path] = launches(fn)
        return res

    Bp, Bb = 32 * inp["packed"].shape[0], inp["bits"].shape[0]
    for sfx, prog in progs.items():
        if group is None:
            step = build_packed_production_step(prog, template, Bp, device=dev)
            f = from_numpy_u32(inp["packed" + sfx], dev)
            out["verdict"]["packed" + sfx] = _ints(counted("packed" + sfx, lambda: step(f[None])))
            vals = prog.build_packed(device=dev)(f)
            step = build_production_step(prog, template, Bb, device=dev)
            f = from_numpy_u32(inp["bits" + sfx], dev)
            out["verdict"]["bits" + sfx] = int(counted("bits" + sfx, lambda: step(f[None]))[0])
            z = prog.build(device=dev)(f)[0]
        else:
            step, shard = sharded_packed_witness_and_check(prog, template, Bp, None, group=group, device=dev)
            fp = shard(inp["packed" + sfx])
            nb, first, vals = counted("packed" + sfx, lambda: step(fp))
            out["verdict"]["packed" + sfx] = (int(nb), int(first))
            step, shard = sharded_witness_and_check(prog, template, Bb, None, group=group, device=dev)
            fb = shard(inp["bits" + sfx])
            nb, z = counted("bits" + sfx, lambda: step(fb))
            out["verdict"]["bits" + sfx] = int(nb)
        if not sfx:
            out["shard"]["packed"], out["shard"]["bits"] = vals.cpu(), z.cpu()

    prog = progs[""]
    Bl = inp["limbs"].shape[0]
    z3 = prog.z_template_limbs(*prog.build(device=dev)(from_numpy_u32(inp["limbs"], dev)))
    inst, slot, limb = CARD_LIMBS_FLIP
    z3b = z3.clone()
    z3b[inst, slot, limb] ^= 1
    if group is None:
        sat = TemplatedSatisfier(template, Bl, device=dev)
        out["verdict"]["limbs"] = _ints(counted("limbs", lambda: sat.check.verdict(z3)))
        out["verdict"]["limbs_bad"] = (_ints(sat.check.verdict(z3b)), sat.which_is_unsatisfied(z3b))
    else:
        sat = ShardedSatisfier(template, Bl, group=group, witness_form="limbs", device=dev)
        zl, zlb = sat.shard_z(z3.cpu()), sat.shard_z(z3b.cpu())
        out["verdict"]["limbs"] = _ints(counted("limbs", lambda: sat._verdict(zl)))
        out["verdict"]["limbs_bad"] = (_ints(sat._verdict(zlb)), sat.which_is_unsatisfied(zlb))

    r1cs, zfree, N0, _ = config5_r1cs(CARD_ROW_LOG2_R)
    R = r1cs.num_constraints
    check, prep = build_row_chunked_check(r1cs, 4, device=dev)
    prod, prep_ab = build_row_chunked_product(r1cs, 16, reuse=(check._layout_meta, prep), device=dev)
    z = config5_z(zfree, R, dev)
    z[N0 + 1 :] = prod(z, prep_ab)
    rsat = RowShardedSatisfier(r1cs, device=dev, group=group)
    if group is not None:
        assert len(rsat._shards) == 1, "a rank holds its own shard only"
    row = [_ints(counted("row", lambda: rsat._check(z)))]
    for s in (5, N0 + 1 + 3 * R // 4 + 1):  # z[5, 0], first read in the first half; a product slot of the last quarter
        zb = z.clone()
        zb[s, 0] ^= 1
        row.append((_ints(rsat._check(zb)), rsat.which_is_unsatisfied(zb)))
    out["verdict"]["row"] = row
    return out


def card_rank(dev, inp: dict) -> dict:
    """One rank of the sharded card test (the group is the world): the
    dry run's checks, then ``card_paths`` over the group."""
    group = default_group()
    out = card_paths(dev, inp, group)
    out.update(rank=dist.get_rank(group), device=str(dev), dryrun=dryrun_rank(dev))
    return out
