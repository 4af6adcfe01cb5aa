"""The port must load where JAX is not installed: importing the package
and its modules (and tests/torch_circuits.py), building and running the sha256 and
config-1 templates on the CPU (the packed, mixed and limbs steps, the
chunked check and both satisfiers), configs 2 and 3 and blake2s (the
bits form, the mixed packed step and the packed step), and the chained
and Merkle steps and a num gadget, config 5's row-chunked check and
product and the row-sharded checker, the Python circuit frontend (every
module, and config 2 through ShapeCS, TapeCS and TestConstraintSystem into
its packed step and Satisfier, on both of the Satisfier's routes), and the
device-layer modules of the reference's API (config, utils.profiling,
utils.serialize: an R1CS saved and loaded back), pulls in no
`jax` and nothing of the JAX package, and the native library builds
from the port's own C++ source; nor does importing the sharding, multihost and dry-run modules
and running the dry run on one CPU rank. Without a card, an entry point
called without a device raises."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_without_jax(code: str) -> None:
    """Run `code` in a fresh interpreter from the repository root; it
    must print "ok" last."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")


def test_port_never_imports_jax():
    _run_without_jax(
        """
        import os
        import sys
        import bellpepper_tpu_torch
        import bellpepper_tpu_torch.native
        import bellpepper_tpu_torch.compile
        import bellpepper_tpu_torch.compile.pipeline
        import bellpepper_tpu_torch.compile.witness_program
        import bellpepper_tpu_torch.backend
        import bellpepper_tpu_torch.backend.cuda_lib
        import bellpepper_tpu_torch.backend.field_kernels
        import bellpepper_tpu_torch.backend.op_rate
        import bellpepper_tpu_torch.backend.check_common
        import bellpepper_tpu_torch.backend.layout
        import bellpepper_tpu_torch.backend.limbs
        import bellpepper_tpu_torch.backend.matvec
        import bellpepper_tpu_torch.backend.satisfier
        import bellpepper_tpu_torch.backend.row_chunked
        import bellpepper_tpu_torch.backend.row_sharded
        import bellpepper_tpu_torch.backend.sharding
        import bellpepper_tpu_torch.utils.multihost
        import bellpepper_tpu_torch.tools.dryrun_multichip
        import bellpepper_tpu_torch.backend.field_backend
        import bellpepper_tpu_torch.backend.field_consts
        import bellpepper_tpu_torch.backend.words
        import bellpepper_tpu_torch.compile.tape
        import bellpepper_tpu_torch.device
        import bellpepper_tpu_torch.fields
        import bellpepper_tpu_torch.r1cs
        import bellpepper_tpu_torch.config
        import bellpepper_tpu_torch.utils
        import bellpepper_tpu_torch.utils.profiling
        import bellpepper_tpu_torch.utils.serialize
        import torch
        from bellpepper_tpu_torch import (
            NativeBuilder, Satisfier, TemplatedSatisfier, WitnessProgram, build_chunked_check,
            build_packed_production_step, build_production_step,
        )
        from bellpepper_tpu_torch.native import SOURCE
        sys.path.insert(0, "tests")
        import torch_circuits  # the tests' circuits and oracles, which the card's tests import

        nb = NativeBuilder()
        bits = [nb.alloc_bit() for _ in range(512)]
        nb.sha256_compression(bits, nb.sha256_iv())
        template, tape = nb.finish()
        prog = WitnessProgram(tape)
        assert template.num_constraints == 26352 and prog.num_slots == 26327
        free = torch.zeros((1, 1, 512), dtype=torch.int32)
        assert [int(v) for v in build_packed_production_step(prog, template, 32, device="cpu")(free)] == [0, 0xFFFFFFFF]

        nb = NativeBuilder()
        bits = [nb.alloc_bit() for _ in range(128)]
        a, b = nb.pack_bits(bits[:64]), nb.pack_bits(bits[64:])
        x = a
        for _ in range(30):
            x = nb.num_square(nb.num_add(nb.num_mul(x, b), a))
        template, tape = nb.finish()
        prog = WitnessProgram(tape)
        assert (template.num_constraints, prog.num_slots) == (220, 221)
        free = torch.randint(0, 2, (1, 32, 128), dtype=torch.int32)
        assert [int(v) for v in build_production_step(prog, template, 32, device="cpu")(free)] == [0, 0xFFFFFFFF]
        limbs_step = build_production_step(prog, template, 128, device="cpu", witness_form="limbs")
        free = torch.randint(0, 2, (1, 128, 128), dtype=torch.int32)
        assert [int(v) for v in limbs_step(free)] == [0, 0xFFFFFFFF]
        z = prog.z_template_limbs(*prog.build(device="cpu")(free[0]))
        assert TemplatedSatisfier(template, 128, device="cpu").is_satisfied(z)
        assert [int(v) for v in build_chunked_check(template, 128, 1, device="cpu")(z[None])] == [0, 0xFFFFFFFF]
        sat = Satisfier(template, device="cpu")
        assert sat.is_satisfied(z[0])
        z[0, prog.free_slots[3], 5] = 7
        assert sat.which_is_unsatisfied(z[0]) is not None

        # configs 2 and 3 and blake2s through the bit gadgets: the bits
        # form, the mixed packed step and the packed step
        nb = NativeBuilder()
        ops = [nb.alloc_u32() for _ in range(8)]
        nb.multieq_begin()
        x = ops[0]
        for i in range(1, 8):
            x = nb.addmany([[nb.xor(a, ops[i][(k + 5 * i) % 32]) for k, a in enumerate(x)],
                            ops[i - 1][3:] + [nb.constant(False)] * 3])
        nb.multieq_end()
        template, tape = nb.finish()
        prog = WitnessProgram(tape)
        free = torch.randint(0, 2, (1, 33, 256), dtype=torch.int32)
        assert [int(v) for v in build_production_step(prog, template, 33, device="cpu")(free)] == [0, 0xFFFFFFFF]
        nb = NativeBuilder()
        words = [nb.alloc_u32() for _ in range(4)]
        nb.multieq_begin()
        acc = words[0]
        for w in words[1:]:
            acc = nb.addmany([acc, w])
        nb.multieq_end()
        nb.pack_bits(acc)
        template, tape = nb.finish()
        prog = WitnessProgram(tape)
        free = torch.randint(-2**31, 2**31 - 1, (1, 1, 128), dtype=torch.int32)
        assert [int(v) for v in build_packed_production_step(prog, template, 32, device="cpu")(free)] == [0, 0xFFFFFFFF]
        nb = NativeBuilder()
        nb.blake2s_compression([nb.alloc_bit() for _ in range(256)], [nb.alloc_bit() for _ in range(512)], 64, True)
        template, tape = nb.finish()
        prog = WitnessProgram(tape)
        free = torch.randint(-2**31, 2**31 - 1, (1, 1, 768), dtype=torch.int32)
        assert [int(v) for v in build_packed_production_step(prog, template, 32, device="cpu")(free)] == [0, 0xFFFFFFFF]

        # one huge R1CS: config 5's generator at 2^10 rows through the
        # row-chunked product and check and RowShardedSatisfier
        from bellpepper_tpu_torch import RowShardedSatisfier, build_row_chunked_check, build_row_chunked_product
        from bellpepper_tpu_torch.tools.config5 import config5_r1cs, config5_z
        r1cs, zfree, n0, _ = config5_r1cs(10)
        z = config5_z(zfree, 1 << 10, "cpu")
        check, prep = build_row_chunked_check(r1cs, 4, device="cpu")
        prod, pprep = build_row_chunked_product(r1cs, 8, reuse=(check._layout_meta, prep), device="cpu")
        z[n0 + 1 :] = prod(z, pprep)
        assert [int(v) for v in check(z, prep)] == [0, 0xFFFFFFFF]
        z[5, 0] ^= 1
        assert RowShardedSatisfier(r1cs, n_shards=2, device="cpu").which_is_unsatisfied(z) is not None

        # the Python circuit frontend: every module, then config 2
        # (benchmarks/configs_1_2_3.py's circuit) through ShapeCS, TapeCS
        # and TestConstraintSystem, its packed step and its Satisfier
        import bellpepper_tpu_torch.lc
        import bellpepper_tpu_torch.constraint_system
        import bellpepper_tpu_torch.util_cs
        import bellpepper_tpu_torch.util_cs.test_cs
        import bellpepper_tpu_torch.util_cs.witness_cs
        import bellpepper_tpu_torch.util_cs.metric_cs
        import bellpepper_tpu_torch.util_cs.bench_cs
        import bellpepper_tpu_torch.gadgets
        import bellpepper_tpu_torch.gadgets.boolean
        import bellpepper_tpu_torch.gadgets.num
        import bellpepper_tpu_torch.gadgets.boolean_utils
        import bellpepper_tpu_torch.gadgets.multieq
        import bellpepper_tpu_torch.gadgets.uint32
        import bellpepper_tpu_torch.gadgets.multipack
        import bellpepper_tpu_torch.gadgets.lookup
        import bellpepper_tpu_torch.gadgets.sha256
        import bellpepper_tpu_torch.gadgets.blake2s
        from bellpepper_tpu_torch import R1CS, TestConstraintSystem
        from bellpepper_tpu_torch.compile import TapeCS
        from bellpepper_tpu_torch.gadgets.multieq import MultiEq
        from bellpepper_tpu_torch.gadgets.uint32 import UInt32
        from bellpepper_tpu_torch.r1cs import ShapeCS

        def config2(cs, words):
            ops = [UInt32.alloc(cs.namespace(f"op {i}"), words[i]) for i in range(8)]
            with MultiEq(cs) as mcs:
                x = ops[0]
                for i in range(1, 8):
                    x = x.xor(mcs.namespace(f"x{i}"), ops[i].rotr(5 * i))
                    x = UInt32.addmany(mcs.namespace(f"s{i}"), [x, ops[i - 1].shr(3)])

        shape, tcs, cs = ShapeCS(), TapeCS(), TestConstraintSystem()
        config2(shape, [None] * 8)
        config2(tcs, [None] * 8)
        config2(cs, [0x9E3779B9 * (i + 1) & 0xFFFFFFFF for i in range(8)])
        template, prog = shape.finish(), WitnessProgram(tcs)
        assert template.num_constraints == cs.num_constraints() == 712 and prog.is_packable
        free = torch.randint(-2**31, 2**31 - 1, (2, 1, len(prog.free_slots)), dtype=torch.int32)
        assert [int(v) for v in build_packed_production_step(prog, template, 32, device="cpu")(free)] == [0, 0xFFFFFFFF]
        sat = Satisfier(R1CS.from_test_cs(cs), device="cpu")
        assert cs.is_satisfied() and sat.is_satisfied(sat.z_from_assignments(cs.scalar_inputs(), cs.scalar_aux()))
        cs.set("s3/result bit 4/boolean", 1 - cs.get("s3/result bit 4/boolean"))
        z = sat.z_from_assignments(cs.scalar_inputs(), cs.scalar_aux())
        assert sat.which_is_unsatisfied(z) == cs.which_is_unsatisfied() is not None

        # the reference's device-layer API: the DeviceR1CS route of the
        # Satisfier, and the R1CS through save_r1cs / load_r1cs
        import tempfile
        from bellpepper_tpu_torch.config import Config
        from bellpepper_tpu_torch.utils import load_r1cs, phase, phase_report, save_r1cs
        r_cs = R1CS.from_test_cs(cs)
        with phase("device_r1cs", trace=True):
            dsat = Satisfier(r_cs, False, device="cpu")
            assert dsat.route == "device_r1cs" and dsat.which_is_unsatisfied(z) == cs.which_is_unsatisfied()
        assert phase_report(reset=True)["device_r1cs"]["count"] == 1
        with tempfile.TemporaryDirectory() as d:
            fp = save_r1cs(os.path.join(d, "r.npz"), r_cs)
            loaded = load_r1cs(os.path.join(d, "r.npz"), expect_fingerprint=fp)
        assert Satisfier(loaded, config=Config(use_pallas=False), device="cpu").which_is_unsatisfied(z) \
            == cs.which_is_unsatisfied()

        bad = sorted(
            m for m in sys.modules
            if m in ("jax", "bellpepper_tpu") or m.startswith(("jax.", "jaxlib", "bellpepper_tpu."))
        )
        assert not bad, bad
        pkg = os.path.dirname(os.path.abspath(bellpepper_tpu_torch.__file__))
        assert os.path.abspath(SOURCE) == os.path.join(pkg, "native", "synthesis.cpp"), SOURCE
        print("ok")
        """
    )


def test_chained_merkle_and_num_gadgets_without_jax():
    _run_without_jax(
        """
        import sys
        import torch
        from bellpepper_tpu_torch import (
            NativeBuilder, PipelinedSatisfier, WitnessProgram, build_chained_production_step,
            build_chained_witness, build_merkle_tree_step, build_production_step,
        )

        nb = NativeBuilder()
        state = [nb.alloc_bit() for _ in range(256)]
        out = nb.sha256_compression([nb.alloc_bit() for _ in range(512)], state)
        template, tape = nb.finish()
        prog, views = WitnessProgram(tape), [nb.view(v) for v in out]
        iv = torch.tensor([[nb.view(v)[1] for v in nb.sha256_iv()]], dtype=torch.int32)
        msgs = torch.randint(0, 2, (2, 1, 512), dtype=torch.int32)
        total, first, final = build_chained_production_step(prog, template, views, 2, device="cpu")(iv, msgs)
        assert (int(total), int(first)) == (0, 0xFFFFFFFF) and final.shape == (1, 256)
        vals, _ = build_chained_witness(prog, views, device="cpu")(iv, msgs)
        sat = PipelinedSatisfier(template, 2, 1, device="cpu", witness_form="bits")
        assert sat.is_satisfied(vals.reshape(1, 2, -1))

        nb = NativeBuilder()
        out = nb.sha256_compression([nb.alloc_bit() for _ in range(512)], nb.sha256_iv())
        template, tape = nb.finish()
        step = build_merkle_tree_step(WitnessProgram(tape), template, [nb.view(v) for v in out], 2, device="cpu")
        root, total = step(torch.randint(0, 2, (2, 256), dtype=torch.int32))
        assert root.shape == (256,) and int(total) == 0

        nb = NativeBuilder()
        nb.num_is_zero(nb.pack_bits([nb.alloc_bit() for _ in range(40)]))
        template, tape = nb.finish()
        free = torch.randint(0, 2, (1, 4, 40), dtype=torch.int32)
        step = build_production_step(WitnessProgram(tape), template, 4, device="cpu")
        assert [int(v) for v in step(free)] == [0, 0xFFFFFFFF]

        bad = sorted(
            m for m in sys.modules
            if m in ("jax", "bellpepper_tpu") or m.startswith(("jax.", "jaxlib", "bellpepper_tpu."))
        )
        assert not bad, bad
        print("ok")
        """
    )


def test_sharding_and_dryrun_without_jax():
    """The sharded steps and checkers, the multihost glue and the dry run
    (one rank, a gloo group on the CPU, spawned by the tool's launcher)
    run without JAX; tests/test_torch_sharding.py,
    tests/test_torch_multihost.py and tests/test_torch_sharded_limbs.py
    check their ranks the same way."""
    _run_without_jax(
        """
        import os
        import sys
        from bellpepper_tpu_torch import initialize_multihost
        from bellpepper_tpu_torch.tools.dryrun_multichip import dryrun_multichip

        assert initialize_multihost() is False
        os.environ["OMP_NUM_THREADS"] = "1"  # the rank's threads, beside the suite's other workers
        (res,) = dryrun_multichip(1, device="cpu")
        assert (res["backend"], res["device"], res["packed"]) == ("gloo", "cpu", (0, 0xFFFFFFFF)), res
        assert res["which"] == ["constraint #699", "constraint #53403"], res["which"]

        bad = sorted(
            m for m in sys.modules
            if m in ("jax", "bellpepper_tpu") or m.startswith(("jax.", "jaxlib", "bellpepper_tpu."))
        )
        assert not bad, bad
        print("ok")
        """
    )


def test_entry_points_need_a_device_without_a_card(monkeypatch):
    """Every entry point runs on the card unless it is given a device;
    where torch sees no card it raises and does not fall back."""
    from bellpepper_tpu_torch import (
        NativeBuilder,
        PipelinedSatisfier,
        RowShardedSatisfier,
        Satisfier,
        TemplatedSatisfier,
        WitnessProgram,
        build_chained_production_step,
        build_chained_witness,
        build_chunked_check,
        build_chunked_witness,
        build_merkle_tree_step,
        build_packed_chunked_witness,
        build_packed_production_step,
        build_production_step,
        build_row_chunked_check,
        build_row_chunked_eval,
        build_row_chunked_product,
        build_templated_check,
    )
    from bellpepper_tpu_torch.backend.limbs import build_limbs_check
    from bellpepper_tpu_torch.backend.row_chunked import DeviceR1CS
    from bellpepper_tpu_torch.backend.matvec import BitsCheck, MixedCheck, PackedBitsCheck, PackedFieldCheck

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nb = NativeBuilder()
    bits = [nb.alloc_bit() for _ in range(64)]
    nb.num_square(nb.pack_bits(bits))
    field_t, field_tape = nb.finish()
    field_prog = WitnessProgram(field_tape)
    fs = field_prog.field_slots
    nb = NativeBuilder()
    bits = [nb.alloc_bit() for _ in range(512)]
    nb.sha256_compression(bits, nb.sha256_iv())
    sha_t, sha_tape = nb.finish()
    sha_prog = WitnessProgram(sha_tape)
    nb = NativeBuilder()
    nb.pack_bits(nb.alloc_u32())
    pack_t, pack_tape = nb.finish()
    pack_prog = WitnessProgram(pack_tape)
    for make in (
        lambda: pack_prog.build_packed_mixed(),
        lambda: build_templated_check(pack_t, 32, None, "bits_packed", field_slots=pack_prog.field_slots),
        lambda: PackedFieldCheck(pack_t, 32, pack_prog.field_slots),
        lambda: build_packed_production_step(pack_prog, pack_t, 32),
        lambda: build_templated_check(sha_t, 32, None, "bits"),
        lambda: BitsCheck(sha_t, 32),
        lambda: build_production_step(sha_prog, sha_t, 32),
        lambda: build_chunked_check(sha_t, 32, 1, witness_form="bits"),
        lambda: TemplatedSatisfier(sha_t, 32, witness_form="bits"),
        lambda: field_prog.build(),
        lambda: sha_prog.build_packed(),
        lambda: build_templated_check(sha_t, 32, None, "bits_packed"),
        lambda: build_templated_check(field_t, 32, None, "mixed", field_slots=fs),
        lambda: PackedBitsCheck(sha_t, 32),
        lambda: MixedCheck(field_t, 32, fs),
        lambda: build_production_step(field_prog, field_t, 32),
        lambda: build_packed_production_step(sha_prog, sha_t, 32),
        lambda: build_chunked_witness(field_prog),
        lambda: build_packed_chunked_witness(sha_prog),
        lambda: build_templated_check(field_t, 32, None, "limbs"),
        lambda: build_limbs_check(field_t, 32),
        lambda: build_production_step(field_prog, field_t, 32, witness_form="limbs"),
        lambda: build_chunked_check(field_t, 32, 1),
        lambda: Satisfier(field_t),
        lambda: TemplatedSatisfier(field_t, 32),
        lambda: build_chained_witness(sha_prog, []),
        lambda: build_chained_production_step(sha_prog, sha_t, [], 32),
        lambda: build_merkle_tree_step(sha_prog, sha_t, [], 2),
        lambda: PipelinedSatisfier(sha_t, 32, 1, witness_form="bits"),
        lambda: DeviceR1CS.from_r1cs(field_t),
        lambda: build_row_chunked_eval(field_t, 1),
        lambda: build_row_chunked_check(field_t, 1),
        lambda: build_row_chunked_product(field_t, 1),
        lambda: RowShardedSatisfier(field_t),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert field_prog.build(device="cpu").device == torch.device("cpu")
