"""The port's Config and the reference-compatible switches of its checkers.

tests/test_api_parity.py's test_config_object, run against both
packages; the Config fields and defaults against the reference's; the
``config=`` precedence of Satisfier, TemplatedSatisfier,
PipelinedSatisfier (its ``witness_form or config.witness_form`` quirk held
equal to the reference's), ShardedSatisfier and RowShardedSatisfier (the
last two in a W = 1 gloo group in this process, their mesh made by
``config.make_mesh()``); the default form of build_templated_check; and
the TypeError of every entry point given a ``use_pallas`` other than
None, True or False. Everything runs on the CPU at a few rows."""

import dataclasses
import importlib
import inspect

import numpy as np
import pytest
import torch
import torch.distributed as dist

import bellpepper_tpu_torch as bpt
from bellpepper_tpu.compile.pipeline import PipelinedSatisfier as RefPipelined
from bellpepper_tpu.config import Config as RefConfig
from bellpepper_tpu_torch import R1CS, NativeBuilder, TestConstraintSystem, WitnessProgram
from bellpepper_tpu_torch.backend.limbs import LimbsCheck, TrivialLimbsCheck
from bellpepper_tpu_torch.backend.matvec import build_templated_check
from bellpepper_tpu_torch.backend.sharding import ShardedSatisfier, default_mesh
from bellpepper_tpu_torch.config import Config, default_config, set_default_config
from bellpepper_tpu_torch.gadgets.num import AllocatedNum
from bellpepper_tpu_torch.tools.dryrun_multichip import free_port
from bellpepper_tpu_torch.utils.multihost import init_group

PKGS = {"reference": "bellpepper_tpu", "port": "bellpepper_tpu_torch"}


def _square_template(root):
    shape = importlib.import_module(f"{root}.r1cs").ShapeCS()
    num = importlib.import_module(f"{root}.gadgets.num")
    a = num.AllocatedNum.alloc(shape.namespace("a"), None)
    a.square(shape.namespace("b"))
    return shape.finish()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_config_object(pkg):
    """tests/test_api_parity.py::test_config_object in either package (the
    port's checker on the CPU)."""
    root = PKGS[pkg]
    Cfg = importlib.import_module(f"{root}.config").Config
    default = importlib.import_module(f"{root}.config").default_config
    Templated = importlib.import_module(f"{root}.backend.matvec").TemplatedSatisfier
    kw = {"device": "cpu"} if pkg == "port" else {}

    assert default().witness_form == "limbs"
    with pytest.raises(ValueError):
        Cfg(witness_form="nope")
    with pytest.raises(ValueError):
        Cfg(limb_bits=32)

    cfg = Cfg(batch=2, use_pallas=False)
    template = _square_template(root)
    sat = Templated(template, config=cfg, **kw)
    assert sat.batch == 2 and sat.witness_form == "limbs"

    be = sat.backend
    assert be.field.p == template.field.p
    z = np.zeros((2, template.num_inputs + template.num_aux, 16), np.uint32)
    z[:, 0, 0] = 1  # ONE
    z[:, 1, 0] = 3  # a
    z[:, 2, 0] = 9  # a^2
    assert sat.is_satisfied(sat.z_from_instances(z))
    z[1, 2, 0] = 8
    assert not sat.is_satisfied(sat.z_from_instances(z))


def test_config_matches_reference():
    """The same fields, defaults, checks and helpers as the reference's."""
    ref = [(f.name, repr(f.default)) for f in dataclasses.fields(RefConfig)]
    assert [(f.name, repr(f.default)) for f in dataclasses.fields(Config)] == ref
    for bad in ({"witness_form": "bits_packed"}, {"tile": 512}, {"limb_bits": 8}, {"batch": 0}):
        with pytest.raises(ValueError):
            Config(**bad)
        with pytest.raises(ValueError):
            RefConfig(**bad)
    cfg = Config(batch=4)
    assert cfg.with_(witness_form="bits") == Config(batch=4, witness_form="bits") and cfg.batch == 4
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.batch = 2
    before = default_config()
    try:
        set_default_config(cfg)
        assert default_config() is cfg
    finally:
        set_default_config(before)
    assert default_config() is before
    with pytest.raises(RuntimeError, match="no process group"):
        Config().make_mesh()


def _mul_cs(bad: bool):
    cs = TestConstraintSystem()
    a = AllocatedNum.alloc(cs.namespace("a"), 3)
    b = AllocatedNum.alloc(cs.namespace("b"), 5)
    a.mul(cs.namespace("ab"), b).inputize(cs.namespace("out"))
    if bad:
        cs.set("ab/product num", 7)
    return cs


def test_satisfier_config_precedence():
    """Satisfier: use_pallas from the config only where the argument is
    None; False is the DeviceR1CS route, None and True the templated one;
    both give the same answers."""
    cs = _mul_cs(bad=True)
    r1cs = R1CS.from_test_cs(cs)
    routes = {
        (None, None): "templated",
        (None, Config(use_pallas=False)): "device_r1cs",
        (True, Config(use_pallas=False)): "templated",
        (False, Config(use_pallas=True)): "device_r1cs",
        (None, Config(use_pallas=True)): "templated",
        (False, None): "device_r1cs",
    }
    for (use_pallas, cfg), route in routes.items():
        sat = bpt.Satisfier(r1cs, use_pallas, cfg, device="cpu")
        assert sat.route == route and sat.use_pallas == (cfg.use_pallas if use_pallas is None and cfg else use_pallas)
        z = sat.z_from_assignments(cs.scalar_inputs(), cs.scalar_aux())
        assert (sat.is_satisfied(z), sat.which_is_unsatisfied(z)) == (False, cs.which_is_unsatisfied())


def test_templated_satisfier_config_precedence():
    t = _square_template("bellpepper_tpu_torch")
    tr = _square_template("bellpepper_tpu")
    RefTemplated = importlib.import_module("bellpepper_tpu.backend.matvec").TemplatedSatisfier
    cases = [
        ((), {"config": Config(batch=3, witness_form="bits")}),
        ((2,), {"config": Config(batch=3, witness_form="bits")}),
        ((2, None, "limbs"), {"config": Config(batch=3, witness_form="bits")}),
        ((None, True), {"config": Config(batch=5, use_pallas=False)}),
        ((4,), {}),
    ]
    for args, kw in cases:
        sat = bpt.TemplatedSatisfier(t, *args, **kw, device="cpu")
        rkw = dict(kw)
        if "config" in kw:
            c = kw["config"]
            rkw["config"] = RefConfig(batch=c.batch, witness_form=c.witness_form,
                                      use_pallas=False if c.use_pallas is None else c.use_pallas)
        rargs = tuple(False if (i == 1 and a is None) else a for i, a in enumerate(args))
        ref = RefTemplated(tr, *rargs, **rkw)
        assert (sat.batch, sat.witness_form) == (ref.batch, ref.witness_form), (args, kw)
        assert sat.num_constraints_total == ref.num_constraints_total
    with pytest.raises(ValueError, match="batch required"):
        bpt.TemplatedSatisfier(t, device="cpu")


def test_pipelined_satisfier_witness_form_quirk():
    """``witness_form or config.witness_form``: the default "limbs" stands
    against a config's "bits"; only a falsy argument takes the config's,
    as in the reference."""
    t = _square_template("bellpepper_tpu_torch")
    tr = _square_template("bellpepper_tpu")
    for wf, cfg_wf, want in (("limbs", "bits", "limbs"), (None, "bits", "bits"), ("bits", "limbs", "bits")):
        args = () if wf == "limbs" else (None, wf)
        port = bpt.PipelinedSatisfier(t, 2, 1, *args, config=Config(witness_form=cfg_wf), device="cpu")
        rargs = () if wf == "limbs" else (False, wf)
        ref = RefPipelined(tr, 2, 1, *rargs, config=RefConfig(witness_form=cfg_wf, use_pallas=False))
        assert port.witness_form == ref.witness_form == want
    sat = bpt.PipelinedSatisfier(t, 2, 1, config=Config(use_pallas=True), device="cpu")
    assert sat.use_pallas is True
    assert bpt.PipelinedSatisfier(t, 2, 1, False, config=Config(use_pallas=True), device="cpu").use_pallas is False


@pytest.fixture(scope="module")
def world1():
    """A W = 1 gloo group in this process; its mesh is every rank."""
    assert init_group(f"127.0.0.1:{free_port()}", 1, 0, device="cpu") == "gloo"
    try:
        yield
    finally:
        dist.destroy_process_group()


def _bits_template():
    nb = NativeBuilder()
    ws = [nb.alloc_u32() for _ in range(2)]
    nb.xor(ws[0][0], ws[1][3])
    t, tape = nb.finish()
    return t, WitnessProgram(tape)


def test_sharded_satisfiers_config_precedence(world1):
    """ShardedSatisfier and RowShardedSatisfier: batch, mesh
    (config.make_mesh()), use_pallas, axis and witness_form from the config
    where the arguments are None; an explicit group (or n_shards) skips the
    config's mesh; a mesh must be a DeviceMesh, and not given with a
    group."""
    t, prog = _bits_template()
    cfg = Config(batch=2, witness_form="bits", mesh_axis="rows")
    sat = ShardedSatisfier(t, config=cfg, device="cpu")
    assert (sat.batch, sat.witness_form, sat.axis) == (2, "bits", "rows")
    assert sat.mesh is not None and sat.mesh.mesh_dim_names == ("rows",) and sat.group is dist.group.WORLD
    vals, _ = prog.build(device="cpu")(torch.zeros((2, len(prog.free_slots)), dtype=torch.int32))
    assert sat.is_satisfied(sat.shard_z(vals))
    grouped = ShardedSatisfier(t, 4, config=cfg, group=dist.group.WORLD, device="cpu")
    assert grouped.mesh is None and grouped.batch == 4 and grouped.witness_form == "bits"
    with pytest.raises(ValueError, match="not both"):
        ShardedSatisfier(t, 2, default_mesh(), group=dist.group.WORLD, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        ShardedSatisfier(t, 2, dist.group.WORLD, device="cpu")
    with pytest.raises(ValueError, match="axis"):
        ShardedSatisfier(t, 2, default_mesh(axis="rows"), device="cpu")

    cs = _mul_cs(bad=True)
    r1cs = R1CS.from_test_cs(cs)
    rs = bpt.RowShardedSatisfier(r1cs, config=Config(), device="cpu")
    assert rs.mesh is not None and rs.group is dist.group.WORLD and rs.n_shards == 1
    one = bpt.RowShardedSatisfier(r1cs, config=Config(), n_shards=2, device="cpu")
    assert one.mesh is None and one.group is None and one.n_shards == 2
    for s in (rs, one):
        z = s.z_from_assignments(cs.scalar_inputs(), cs.scalar_aux())
        assert s.which_is_unsatisfied(z) == cs.which_is_unsatisfied()
    assert bpt.RowShardedSatisfier(r1cs, default_mesh(), use_pallas=True, device="cpu").use_pallas is True


def test_build_templated_check_defaults_to_limbs():
    assert inspect.signature(build_templated_check).parameters["witness_form"].default == "limbs"
    t = _square_template("bellpepper_tpu_torch")
    default = build_templated_check(t, 2, None, device="cpu")
    assert type(default) is type(build_templated_check(t, 2, None, "limbs", device="cpu"))
    assert isinstance(default, (LimbsCheck, TrivialLimbsCheck))


def _entry_points():
    """(name, call with use_pallas="cpu" where the reference's argument
    stands) of every entry point that takes use_pallas."""
    t = _square_template("bellpepper_tpu_torch")
    bt, prog = _bits_template()
    r1cs = R1CS.from_test_cs(_mul_cs(bad=False))
    bad = "cpu"  # a device where use_pallas now stands
    return {
        "build_templated_check": lambda: build_templated_check(t, 2, bad, device="cpu"),
        "build_production_step": lambda: bpt.build_production_step(prog, bt, 32, bad, device="cpu"),
        "build_chunked_check": lambda: bpt.build_chunked_check(t, 2, 1, bad, device="cpu"),
        "build_chunked_witness": lambda: bpt.build_chunked_witness(prog, bad, device="cpu"),
        "build_packed_production_step": lambda: bpt.build_packed_production_step(prog, bt, 32, bad, device="cpu"),
        "build_chained_witness": lambda: bpt.build_chained_witness(prog, [], bad, device="cpu"),
        "build_chained_production_step": lambda: bpt.build_chained_production_step(prog, bt, [], 32, bad,
                                                                                   device="cpu"),
        "build_merkle_tree_step": lambda: bpt.build_merkle_tree_step(prog, bt, [], 2, bad, device="cpu"),
        "build_row_chunked_check": lambda: bpt.build_row_chunked_check(r1cs, 1, None, bad, device="cpu"),
        "build_row_chunked_product": lambda: bpt.build_row_chunked_product(r1cs, 1, None, bad, device="cpu"),
        "WitnessProgram.build": lambda: prog.build(bad),
        "Satisfier": lambda: bpt.Satisfier(r1cs, bad, device="cpu"),
        "Satisfier(config)": lambda: bpt.Satisfier(r1cs, config=Config(use_pallas=1), device="cpu"),
        "TemplatedSatisfier": lambda: bpt.TemplatedSatisfier(t, 2, bad, device="cpu"),
        "PipelinedSatisfier": lambda: bpt.PipelinedSatisfier(t, 2, 1, bad, device="cpu"),
        "RowShardedSatisfier": lambda: bpt.RowShardedSatisfier(r1cs, None, bad, device="cpu"),
        "ShardedSatisfier": lambda: ShardedSatisfier(t, 2, None, bad, device="cpu"),
        "sharded_witness_and_check": lambda: bpt.sharded_witness_and_check(prog, bt, 2, None, bad, device="cpu"),
        "sharded_packed_witness_and_check": lambda: bpt.sharded_packed_witness_and_check(prog, bt, 512, None, bad,
                                                                                         device="cpu"),
    }


ENTRY_POINTS = ["build_templated_check", "build_production_step", "build_chunked_check", "build_chunked_witness",
                "build_packed_production_step", "build_chained_witness", "build_chained_production_step",
                "build_merkle_tree_step", "build_row_chunked_check", "build_row_chunked_product",
                "WitnessProgram.build", "Satisfier", "Satisfier(config)", "TemplatedSatisfier", "PipelinedSatisfier",
                "RowShardedSatisfier", "ShardedSatisfier", "sharded_witness_and_check",
                "sharded_packed_witness_and_check"]


def test_entry_point_list_is_whole():
    assert sorted(_entry_points()) == sorted(ENTRY_POINTS)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_use_pallas_refuses_other_values(name):
    with pytest.raises(TypeError, match="use_pallas must be None, True or False"):
        _entry_points()[name]()
