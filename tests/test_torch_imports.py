"""The port must load where JAX is not installed: importing the package
and its modules (and chip_smoke.py), building and running the sha256 and
config-1 templates on the CPU (the packed, mixed and limbs steps, the
chunked check and both satisfiers) pulls in no `jax` and nothing of the
JAX package, and the
native library builds from the port's own C++ source. Without a card, an
entry point called without a device raises."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_never_imports_jax():
    code = textwrap.dedent(
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
        import bellpepper_tpu_torch.backend.field_backend
        import bellpepper_tpu_torch.backend.field_consts
        import bellpepper_tpu_torch.backend.words
        import bellpepper_tpu_torch.compile.tape
        import bellpepper_tpu_torch.device
        import bellpepper_tpu_torch.fields
        import bellpepper_tpu_torch.r1cs
        import torch
        from bellpepper_tpu_torch import (
            NativeBuilder, Satisfier, TemplatedSatisfier, WitnessProgram, build_chunked_check,
            build_packed_production_step, build_production_step,
        )
        from bellpepper_tpu_torch.native import SOURCE
        import chip_smoke  # the card script: its imports, not its run

        nb = NativeBuilder()
        bits = [nb.alloc_bit() for _ in range(512)]
        nb.sha256_compression(bits, nb.sha256_iv())
        template, tape = nb.finish()
        prog = WitnessProgram(tape)
        assert template.num_constraints == 26352 and prog.num_slots == 26327
        free = torch.zeros((1, 1, 512), dtype=torch.int32)
        assert [int(v) for v in build_packed_production_step(prog, template, 32, "cpu")(free)] == [0, 0xFFFFFFFF]

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
        assert [int(v) for v in build_production_step(prog, template, 32, "cpu")(free)] == [0, 0xFFFFFFFF]
        limbs_step = build_production_step(prog, template, 128, "cpu", witness_form="limbs")
        free = torch.randint(0, 2, (1, 128, 128), dtype=torch.int32)
        assert [int(v) for v in limbs_step(free)] == [0, 0xFFFFFFFF]
        z = prog.z_template_limbs(*prog.build("cpu")(free[0]))
        assert TemplatedSatisfier(template, 128, device="cpu").is_satisfied(z)
        assert [int(v) for v in build_chunked_check(template, 128, 1, device="cpu")(z[None])] == [0, 0xFFFFFFFF]
        sat = Satisfier(template, device="cpu")
        assert sat.is_satisfied(z[0])
        z[0, prog.free_slots[3], 5] = 7
        assert sat.which_is_unsatisfied(z[0]) is not None

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
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")


def test_entry_points_need_a_device_without_a_card(monkeypatch):
    """Every entry point runs on the card unless it is given a device;
    where torch sees no card it raises and does not fall back."""
    from bellpepper_tpu_torch import (
        NativeBuilder,
        Satisfier,
        TemplatedSatisfier,
        WitnessProgram,
        build_chunked_check,
        build_chunked_witness,
        build_packed_chunked_witness,
        build_packed_production_step,
        build_production_step,
        build_templated_check,
    )
    from bellpepper_tpu_torch.backend.limbs import build_limbs_check
    from bellpepper_tpu_torch.backend.matvec import MixedCheck, PackedBitsCheck

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
    for make in (
        lambda: field_prog.build(),
        lambda: sha_prog.build_packed(),
        lambda: build_templated_check(sha_t, 32),
        lambda: build_templated_check(field_t, 32, "mixed", field_slots=fs),
        lambda: PackedBitsCheck(sha_t, 32),
        lambda: MixedCheck(field_t, 32, fs),
        lambda: build_production_step(field_prog, field_t, 32),
        lambda: build_packed_production_step(sha_prog, sha_t, 32),
        lambda: build_chunked_witness(field_prog),
        lambda: build_packed_chunked_witness(sha_prog),
        lambda: build_templated_check(field_t, 32, "limbs"),
        lambda: build_limbs_check(field_t, 32),
        lambda: build_production_step(field_prog, field_t, 32, witness_form="limbs"),
        lambda: build_chunked_check(field_t, 32, 1),
        lambda: Satisfier(field_t),
        lambda: TemplatedSatisfier(field_t, 32),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert field_prog.build("cpu").device == torch.device("cpu")
