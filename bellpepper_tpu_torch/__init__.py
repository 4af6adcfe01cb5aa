"""bellpepper_tpu_torch — the PyTorch + CUDA port of bellpepper_tpu.

The JAX package ``bellpepper_tpu`` stays the reference. This package
imports ``torch`` and never ``jax``, and nothing of the JAX package: it
carries its own host layer (the fields, the R1CS data types, the native
builder with its C++ source, the tape types, the stage compile, the row
classifiers and the field constants) and its own copy of the Python
circuit frontend, with the reference's names and signatures:
``LinearCombination``, ``ConstraintSystem`` and ``Circuit``; the
``util_cs`` systems (``TestConstraintSystem``, ``WitnessCS``,
``MetricCS``, ``BenchCS``); ``r1cs.ShapeCS`` and ``compile.TapeCS``; and
the gadgets (``gadgets.boolean``, ``num``, ``boolean_utils``, ``multieq``,
``uint32``, ``multipack``, ``lookup``, ``sha256``, ``blake2s``).

A circuit is written the bellpepper way, against a ``ConstraintSystem``,
and synthesized once into ``ShapeCS`` (its R1CS template) and once into
``TapeCS`` (its witness tape) for the steps below; or it is synthesized
with values into ``TestConstraintSystem`` and checked on the card through
``R1CS.from_test_cs`` and ``Satisfier``. ``NativeBuilder`` builds the same
templates and tapes of the fixed gadget set from C++. The port's functions
read templates and tapes by their fields alone, so the JAX package's
``R1CS`` objects and ``TapeCS`` tapes work too.

Every entry point runs on the CUDA card unless it is given another
device (``device="cpu"`` runs the plain PyTorch versions of the kernels).

The device layer keeps the reference's public API: ``config`` (``Config``,
``default_config``, ``set_default_config``), ``utils.profiling``
(``phase``, ``phase_report``), ``utils.serialize`` (``save_r1cs``,
``load_r1cs``, ``save_witness``, ``load_witness``, ``shape_fingerprint``,
in the reference's npz format), and every builder and checker of
``backend.matvec``, ``backend.sharding``, ``compile.pipeline``,
``compile.witness_program`` and ``utils.multihost`` with the reference's
parameters in the reference's order and defaults (``use_pallas``,
``config=``, ``mesh``, ``axis``). The port's own ``device``, ``group`` and
``n_shards`` come after them, keyword-only, so a program written against
``bellpepper_tpu`` runs here once its imports name this package (and,
on the CPU, its calls add ``device="cpu"``). ``use_pallas`` picks a route
through the kernels and accepts only None, True or False; a ``mesh`` is a
``torch.distributed`` ``DeviceMesh`` (``default_mesh``, ``global_mesh``).

Ported paths:

  * the packed sha256 step: ``NativeBuilder`` → ``WitnessProgram.
    build_packed`` → ``build_templated_check(..., "bits_packed")`` →
    ``build_packed_production_step``, with the kernels ``bitplane_eq``,
    ``bits_matvec_semi`` and ``mulcmp``;
  * the field path (config 1, AllocatedNum mul/add): ``NativeBuilder``'s
    num gadgets → ``WitnessProgram.build`` → ``build_templated_check(...,
    "mixed")`` → ``build_production_step``, with the kernels ``chain``,
    ``mul`` and ``mulcmp``;
  * configs 2 and 3 and blake2s on the packed step: ``NativeBuilder``'s
    u32 gadgets (``alloc_u32``, ``xor``, ``addmany`` under
    ``multieq_begin``/``multieq_end``, ``blake2s_compression``); config 3's
    ``pack`` output through ``WitnessProgram.build_packed_mixed`` and
    ``build_templated_check(..., "bits_packed", field_slots=...)``, with
    the kernels ``bitplane_eq``, ``bits_matvec_semi`` and ``mulcmp``;
  * the generic bits witness form (0/1 values, one per word):
    ``build_templated_check(..., "bits")``, ``build_production_step`` (the
    default for pure-bit programs), ``build_chunked_check(...,
    witness_form="bits")`` and ``TemplatedSatisfier(..., "bits")``, on the
    packed check's kernels;
  * the chained and Merkle pipelines (configs 4 and 4b):
    ``build_chained_witness`` (on the card each block one replay of a CUDA
    graph), ``build_chained_production_step`` and
    ``build_merkle_tree_step`` on the bits check's kernels, with
    ``PipelinedSatisfier`` and ``which_from_flat``;
  * NativeBuilder's num family (``num_to_bits_le_strict``,
    ``num_conditionally_reverse``, ``num_is_zero``, ``lookup3_xy``,
    ``lookup3_xy_with_conditional_negation``) through
    ``WitnessProgram.build``, its inversions on the kernel ``mul``;
  * the limbs witness form (any value in any slot): ``Satisfier`` (one
    R1CS), ``TemplatedSatisfier``, ``build_templated_check(..., "limbs")``,
    ``build_production_step(..., witness_form="limbs")`` and
    ``build_chunked_check``, with the kernels ``limbs_matvec``,
    ``mul_digits``, ``reduce_digits``, ``mul`` and ``mulcmp``;
  * one huge R1CS (config 5): the row-chunked evaluator, product and
    check (``build_row_chunked_eval``, ``build_row_chunked_product``,
    ``build_row_chunked_check``) on ``mul``, ``reduce_digits`` and
    ``mulcmp``, and ``RowShardedSatisfier`` (one device, any number of
    row shards) on ``mul_digits``, ``reduce_digits`` and ``mul``;
  * the sharded steps and checkers on ``torch.distributed``, one shard and
    one device a rank of a process group (``default_group``,
    ``rank_device``): ``sharded_packed_witness_and_check`` (the flagship's
    multi-device program, the mixed packed layout included),
    ``sharded_witness_and_check``, ``ShardedSatisfier`` and
    ``RowShardedSatisfier(..., group=...)``, their verdicts reduced over
    the ranks by ``global_count`` (a SUM) or ``global_verdict`` (SUM and
    MIN in int64); the multi-process glue of ``utils.multihost``
    (``initialize_multihost``, ``global_group``, ``make_global_batch``,
    ``multihost_verdict_step``) and the dry run ``tools.dryrun_multichip``,
    on the kernels of the paths they shard;
  * the second route of ``Satisfier``: ``Satisfier(r1cs, False)`` checks
    through ``DeviceR1CS`` and ``violation_mask`` on ``mul`` and
    ``reduce_digits``, with no row classifier to build.

The kernels are CUDA C++ (``csrc/``)."""

from .backend.matvec import build_templated_check
from .constraint_system import (
    BELLPEPPER_TPU_VERSION,
    Circuit,
    ConstraintSystem,
    Namespace,
    SynthesisError,
)
from .backend.row_chunked import build_row_chunked_check, build_row_chunked_eval, build_row_chunked_product
from .backend.row_sharded import RowShardedSatisfier
from .backend.satisfier import Satisfier, TemplatedSatisfier, which_from_flat
from .backend.sharding import (
    ShardedSatisfier,
    default_group,
    default_mesh,
    global_count,
    global_verdict,
    rank_device,
    sharded_packed_witness_and_check,
    sharded_witness_and_check,
)
from .backend.words import pack_bits, unpack_bits
from .compile.pipeline import (
    PipelinedSatisfier,
    build_chained_production_step,
    build_chained_witness,
    build_chunked_check,
    build_chunked_witness,
    build_packed_chunked_witness,
    build_packed_production_step,
    build_merkle_tree_step,
    build_production_step,
)
from .compile.witness_program import WitnessProgram
from .config import Config, default_config, set_default_config
from .fields import FIELDS, PALLAS_SCALAR, SCALAR, VESTA_SCALAR, PrimeField
from .lc import Index, LinearCombination, Variable
from .native import NativeBuilder
from .r1cs import R1CS, COOMatrix
from .util_cs import (
    BenchCS,
    Comparable,
    Constraint,
    Delta,
    MetricCS,
    SizedWitness,
    TestConstraintSystem,
    WitnessCS,
)
from .utils import load_r1cs, load_witness, phase, phase_report, save_r1cs, save_witness, shape_fingerprint
from .utils.multihost import global_group, global_mesh, initialize_multihost, make_global_batch, multihost_verdict_step

__version__ = BELLPEPPER_TPU_VERSION

__all__ = [
    "BELLPEPPER_TPU_VERSION",
    "BenchCS",
    "COOMatrix",
    "Circuit",
    "Comparable",
    "Config",
    "Constraint",
    "ConstraintSystem",
    "Delta",
    "FIELDS",
    "Index",
    "LinearCombination",
    "MetricCS",
    "Namespace",
    "NativeBuilder",
    "PALLAS_SCALAR",
    "PipelinedSatisfier",
    "PrimeField",
    "R1CS",
    "RowShardedSatisfier",
    "SCALAR",
    "Satisfier",
    "ShardedSatisfier",
    "SizedWitness",
    "SynthesisError",
    "TemplatedSatisfier",
    "TestConstraintSystem",
    "VESTA_SCALAR",
    "Variable",
    "WitnessCS",
    "WitnessProgram",
    "build_chained_production_step",
    "build_chained_witness",
    "build_chunked_check",
    "build_chunked_witness",
    "build_merkle_tree_step",
    "build_packed_chunked_witness",
    "build_packed_production_step",
    "build_production_step",
    "build_row_chunked_check",
    "build_row_chunked_eval",
    "build_row_chunked_product",
    "build_templated_check",
    "default_config",
    "default_group",
    "default_mesh",
    "global_count",
    "global_group",
    "global_mesh",
    "global_verdict",
    "initialize_multihost",
    "load_r1cs",
    "load_witness",
    "make_global_batch",
    "multihost_verdict_step",
    "pack_bits",
    "phase",
    "phase_report",
    "rank_device",
    "save_r1cs",
    "save_witness",
    "set_default_config",
    "shape_fingerprint",
    "sharded_packed_witness_and_check",
    "sharded_witness_and_check",
    "unpack_bits",
    "which_from_flat",
]
