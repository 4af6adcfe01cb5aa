#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one CUDA card, and check
their eleven kernels (and the op-rate probe) against their plain versions.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (one line each, or a few):

  * the card's name and power limit; the kernel build (all nvcc processes
    at once) and ptxas's register and spill report, with the lines of mul,
    mul_digits and the two reduce_digits instantiations apart;
  * native synthesis of one sha256 compression (26,352 rows, 26,327
    slots), of config 1 (pack → (mul, add, square) × 30: 220 rows, 221
    slots) and of its variant with num_assert_nonzero (221 rows, 222
    slots), with the mixed row classes of both;
  * each kernel against its plain PyTorch version at its path's shapes and
    real tables (bit-exact): bitplane_eq through the sha256 pow2 plane
    table, bits_matvec_semi through the big row's ELL buckets and
    verdict_fold through the verdict's eight folds, on one packed chunk
    whose odd words are random; limbs_matvec on config 1's
    a-bucket and the sha256 limbs check's widest a-bucket (random limbs),
    and at the K = 2,064 bound with every digit and fold entry 255; mulcmp
    (its 0/1 mask) at every N a path launches it at, the sha256 limbs
    step's larger batches right after each one runs; operand_mulcmp (the
    product rows' operands assembled and compared in one pass) at the
    product-row tables of config 1's and the variant's mixed checks and of
    config 1's limbs check, on their chunk's witness; mul at one block
    (N = 32, its launch floor), the variant's 8,192, 2^20 and the
    Satisfier's 426,920, bit-exact also against Python ints at the corner
    pairs; mul_digits (raw operands in [p, 2^256) among its corners) and
    reduce_digits (limb-major at the Satisfier's 426,920, element-major at
    2^20, each with the corner sums of digit_sum_corners) against Python
    ints too (their profiler device times come last); with the kernel's,
    the plain version's and, where one PyTorch call computes the same
    work, that call's times, and the least time the card could take
    (``bound``, below);
  * the op-rate probe (the counterpart of benchmarks/probe_vpu_ops.py):
    G op/s of each of its seven op classes;
  * the packed sha256 step at 4 chunks of 32,768 instances, the config-1
    step and the variant's step at 4 chunks of 8,192 instances: clean
    verdicts, each path's kernels launched (counts reset just before the
    path's run and read just after; the variant's mul exactly 60 fmul
    launches plus its finv's inversion ladder a chunk), words equal to the
    CPU evaluator's, planted corruptions found at their instance, a
    Python-int recurrence for the chain, and the variant's finv equal to
    Python's pow(x, p − 2, p);
  * MinRoot's product rows at the benchmark's chunk (Nova's MinRoot step
    circuit at 65,536 iterations, perfbench/configs/minroot-65536.py:
    196,608 rows × 256 instances, random advice, so every iteration's last
    row fails): MixedCheck's verdict and its launches (one operand_mulcmp,
    no mulcmp), operand_mulcmp against its plain version over slices of
    rows, its time beside its bound, the eager route's (operands assembled
    by _Operand.assemble, then mulcmp) and the check's a chunk;
  * each step's time, rate and peak memory; the config-1 witness and
    check seconds per chunk and the check's split by row class; the
    variant's witness seconds per chunk, its finv's alone, and its check's;
  * the limbs witness form: config 1's step at 4 × 8,192 and the sha256
    step at 4 × 1,024 in the limbs form (verdicts, launches, a non-bit
    value planted in a bit slot found at its instance, the sha256 chunk's
    verdict equal to the packed check's), the sha256 limbs step again at
    2,048, 4,096 and 8,192 instances a chunk in turn while its peak,
    extrapolated from the runs before, stays under 40 GiB, and the
    ``Satisfier`` of a 16-block sha256 chain (426,912 rows) at batch 1,
    whose ``which_is_unsatisfied`` names the row a Python-int evaluation
    finds; each with its time (and the steps' rate and peak memory);
  * configs 2 and 3 (benchmarks/configs_1_2_3.py; 712 and 229 rows) and
    one blake2s compression (22,158 rows) through NativeBuilder's bit
    gadgets, each on the packed step at 4 × 32,768 (config 3 in the mixed
    packed layout, its pack output in a limb sidecar): clean verdicts and
    launches, chunk 0 equal to the CPU evaluator, planted corruptions (a
    flipped bit; config 3 also a pack-output limb bit and an addend bit)
    found at their instance and at the row the CPU check names, and the
    kernels at each path's own tables (bitplane_eq's generic instantiation
    at configs 2 and 3, bits_matvec_semi at blake2s's 46-row buckets,
    mulcmp at its N);
  * the Python circuit frontend: the flagship (one sha256 compression
    over 512 allocated bits) and configs 1-3 written with the port's
    gadgets as benchmarks/configs_1_2_3.py writes them, recorded into
    ShapeCS and TapeCS (host seconds of each beside NativeBuilder's build
    of the same circuit); each template equal to NativeBuilder's array for
    array and each program's free slots and stages equal to its program's;
    the flagship on the packed step at 4 × 32,768 and configs 2 and 3 (3
    in the mixed packed layout) there too, config 1 at 4 × 8,192 on the
    mixed step: clean verdicts, launches, chunk 0 equal to NativeBuilder's
    program's, planted corruptions found at their instance, time and rate
    (their kernel tables are NativeBuilder's, compared above); then the
    Satisfier loop: the full sha256 of 64 bytes in TestConstraintSystem
    (45,386 rows, digest equal to hashlib's) → R1CS.from_test_cs →
    Satisfier on the card, satisfied, its launches and seconds, mul_digits,
    reduce_digits and mul at its own tables, and after cs.set of a bit
    (flipped, then a random field element in another) the card's
    which_is_unsatisfied equal to TestConstraintSystem's;
  * sha256 in the generic bits form (build_production_step's default for
    a pure-bit program) at 4 × 1,024, then 2,048 and 4,096 while the
    extrapolated peak stays under 40 GiB: verdicts, launches, chunk 0's
    mask and verdict equal to the packed check's (clean and with one bit
    flipped), and at each batch bitplane_eq, bits_matvec_semi and mulcmp
    at its tables;
  * the chained pipeline (benchmarks/config4_merkle_1024.py): sha256 of a
    64-byte message as two chained blocks equal to hashlib's; the chain's
    CUDA-graph replays equal to an eager loop of the same evaluator (T 8,
    B 4); config 4 (one chain of 1,024 blocks, check_batch 512, message
    bits from default_rng(11)): the final state equal to a pure-Python
    sha256 compression oracle, a clean verdict, one flipped witness bit of
    block 700 named by which_from_flat at the row the CPU check of that
    instance names, and PipelinedSatisfier on the same witness; config 4b
    (8 and 64 chains of 1,024 blocks): chains 0 and B − 1 equal to the
    oracle; each with its step seconds, rate, check share, replay time a
    block and peak; the replay of one block at 1 to 4,096 chains (the
    chains-versus-throughput curve); bitplane_eq at the chain's table (26
    pow2 rows, Bw 16);
  * the Merkle tree over 1,024 random leaf digests (10 levels): the root
    equal to the oracle's tree, a clean total, its seconds; bitplane_eq,
    bits_matvec_semi and mulcmp at every level's tables (batches 512 down
    to 1: Bw 16 down to 1, the last five in one partial word), on that
    level's witness;
  * the num family's mixed block (sha256, pack_bits of 200 digest bits,
    num_is_zero of the pack, num_to_bits_le_strict of a free num) through
    build_production_step's mixed form at 4 × 1,024, doubled while a step
    stays under 5 s and twice its peak under 40 GiB: clean verdicts and
    launches (mul in the inversions), chunk 0 equal to the CPU evaluator,
    two planted faults found at their instance; at each batch
    limbs_matvec at every bucket of the mixed check's rest rows on chunk
    0's witness, operand_mulcmp at its product rows' table on that
    witness, mulcmp at the N of its rest rows, and mul at [16, B] (the
    inversion ladder's shape);
  * config 5 (benchmarks/config5_synthetic_r1cs.py) at 2^24 rows, none
    cut: the row-chunked check's layout (32 chunks), the witness
    completion's product reusing it (128 chunks), the completion twice
    (the second timed), the check once, once warm and 10 times with one
    sync; its host build, layout, completion and check seconds, rate and
    peak; exact launch counts; the completed product at 4,096 sampled
    rows against Python ints; z[5, 0] flipped reported at the row numpy
    names; mulcmp, mul (on a premul slice of the raw, non-canonical z and
    on a product chunk) and reduce_digits at its shapes (the product
    chunk's A digit sums element-major, as the completion passes them,
    and limb-major);
  * config 5's generator at 2^20 rows (the benchmark's default size):
    RowShardedSatisfier (limbs, one shard) on the completed witness, its
    launches and time, its verdicts equal to the row-chunked check's semi
    and canonical routes', clean and with z[5, 0] flipped; mul_digits on
    A's gathered raw z and coefficients, reduce_digits on its digit sums
    and mul on the shard's A·z and B·z;
  * the sharded steps and checkers on torch.distributed, on one rank over
    NCCL and on two ranks over gloo that share the one card (spawned by
    tools/dryrun_multichip.RankJob; the two-rank times measure the
    rank logic, not scaling): each rank runs the dry run's checks
    (dryrun_rank), then the packed step at 131,072 instances (the
    flagship's 4 × 32,768 in one call) and the bits step at 4,096, each
    clean and with one xor of two free bits computing `and` (those bits
    zeroed in the batch's first half, so the first failure lies on the
    last rank), the limbs ShardedSatisfier on sha256 at 1,024 (clean and
    with a flipped limb at instance 700) and RowShardedSatisfier at 2^20
    rows (clean, z[5, 0] flipped, and a product slot of the last quarter
    flipped); every verdict and (n_bad, first), and the witness shards in
    rank order (their sha256 digests), equal to single-rank execution of
    the same inputs, run first in this process; each path's launches
    counted on every rank; then, one rank at a time, each kernel of those
    paths against its plain version at the rank's shapes, on the operands
    the rank's check gives it;
  * the reference's device-layer API (api_path), every call written as a
    program against bellpepper_tpu writes it, with no device argument
    (the card by default): Satisfier(r, False) and Satisfier(r, True) on
    the 16-block sha256 chain (the DeviceR1CS route against the templated
    limbs route): both clean, the planted fault of the satisfier phase
    named at the Python-int row by both, each route's build and check
    seconds and peak, the False route's launches (4 mul, 3 reduce_digits a
    check) and its mul at [16, E] and element-major reduce_digits against
    their plain versions; the chain's R1CS and witness through save_r1cs,
    save_witness, load_r1cs and load_witness (its fingerprint, the loaded
    z bit-equal, Satisfier(loaded, False) with the same verdicts); the
    flagship as set_default_config(Config(use_pallas=True)) and
    build_packed_production_step(prog, template, 32768, True) inside
    phase("sha256 step", trace=True), its verdict and the corrupted
    chunk's equal to the sha256 phase's; PipelinedSatisfier(config 1,
    8192, 4, config=Config(use_pallas=True)) clean and with a flipped limb
    named at its chunk, instance and Python-int row; WitnessProgram.run
    on config 1 at 8,192 equal to build()'s evaluator; FieldBackend.
    mul_pow2 at [2^20, 16] against Python ints at the corner values; and
    the phase_report of its phases (no profiler session starts here);
  * fields below 253 bits (fields_path), over Goldilocks (2^64 − 2^32 + 1:
    every check canonical) and Jubjub's scalar field (252 bits: the semi
    routes, with no quotient estimate in the TPU's 16-bit pipeline): the
    flagship packed sha256 step at 4 × 32,768 (its big rows through
    bits_matvec_canonical and mul over Goldilocks), config 1 and its
    variant in the mixed and limbs forms at 4 × 8,192, each clean, its
    launches, time, rate and peak, and a flipped bit found at its instance
    and at the row the Python-int evaluation of that instance names; over
    Goldilocks the 16-block sha256 chain's Satisfier by both routes (build
    and check seconds, peak, the planted fault named at the Python-int
    row) and config 5's completion and check at 2^20 rows (the canonical
    route; product at sampled rows against Python ints, z[5, 0] flipped
    found at the row numpy names); the fold matvec's buckets of each
    flagship (torch.bmm beside them), mul, chain, mul_digits (raw a) and
    reduce_digits (both layouts, corner sums) at the paths' shapes at
    both fields, limbs_matvec at config 1's a-bucket, each bit-exact
    against its plain version and, where noted, Python ints;
  * last, device_times: torch.profiler's device time a launch of every
    mul_digits and reduce_digits table above, with L2 flushed and warm,
    beside its event time (after every timed step: a profiler session
    slows the process's later launches).

``bound``: the larger of the bytes a kernel's function must move (each
input read once, each output written once: for the kernels that read the
witness through a table, the distinct slots the table names, the fold
planes as stored and the output) over 3.35 TB/s and the 32-bit integer
products that function needs on these inputs (not those of the kernel's
own design; see ``modmul_products``) over 64 lanes × 132 SMs × the card's
maximum SM clock. A kernel timed below its bound fails its compare: the
bound then counts work these inputs do not need. The line before last names the card again; the last
line is {"ok": true, "device": {...}}; the kernels line gives each
kernel's numbers at its first table and, under ``other_tables``, those at
the later paths' tables. Any failed phase raises and the script exits
non-zero. Without a CUDA device it exits 1 at once."""

import copy
import functools
import hashlib
import importlib.util
import json
import os
import random
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from bellpepper_tpu_torch import (
    PALLAS_SCALAR,
    SCALAR,
    NativeBuilder,
    PrimeField,
    PipelinedSatisfier,
    RowShardedSatisfier,
    Satisfier,
    TemplatedSatisfier,
    WitnessProgram,
    build_chained_production_step,
    build_chained_witness,
    build_chunked_check,
    build_merkle_tree_step,
    build_packed_chunked_witness,
    build_packed_production_step,
    build_production_step,
    build_row_chunked_check,
    build_row_chunked_eval,
    build_row_chunked_product,
    build_templated_check,
    pack_bits,
    which_from_flat,
)
from bellpepper_tpu_torch.backend import cuda_lib, field_kernels as fk, op_rate
from bellpepper_tpu_torch.backend.check_common import Products
from bellpepper_tpu_torch.backend.field_backend import get_backend
from bellpepper_tpu_torch.backend.field_consts import SEMI, word_count
from bellpepper_tpu_torch.backend.layout import MAX_FUSED_LIMBS_K, _classify_mixed_rows
from bellpepper_tpu_torch.backend.limbs import LimbsCheck
from bellpepper_tpu_torch.backend.matvec import ROW_CLASSES
from bellpepper_tpu_torch.backend.row_chunked import _chunk, _ell_digit_sums, _gather_rows, _split8
from bellpepper_tpu_torch.backend.sharding import (
    ShardedSatisfier,
    default_group,
    sharded_packed_witness_and_check,
    sharded_witness_and_check,
)
from bellpepper_tpu_torch.backend.words import from_numpy_u32, pack_rows, to_i32, to_numpy_u32, to_u32
from bellpepper_tpu_torch.compile.pipeline import _STATE_TO_MSG_PERM, _carry_extractor
from bellpepper_tpu_torch.compile.tape import TapeCS, corrupted
from bellpepper_tpu_torch.compile.witness_program import SCAN_OPS, SRC_ROW, _detect_linear_chain
from bellpepper_tpu_torch.config import Config, default_config, set_default_config
from bellpepper_tpu_torch.gadgets.boolean import AllocatedBit, Boolean
from bellpepper_tpu_torch.gadgets.multieq import MultiEq
from bellpepper_tpu_torch.gadgets.multipack import pack_bits as gpack_bits
from bellpepper_tpu_torch.gadgets.sha256 import get_sha256_iv, sha256 as gsha256, sha256_compression_function
from bellpepper_tpu_torch.gadgets.uint32 import UInt32
from bellpepper_tpu_torch.r1cs import R1CS, ShapeCS
from bellpepper_tpu_torch.util_cs import TestConstraintSystem
from bellpepper_tpu_torch.tools import config5 as c5
from bellpepper_tpu_torch.tools.ab_gather import device_ms
from bellpepper_tpu_torch.tools.dryrun_multichip import RankJob, dryrun_rank, sha256_template
from bellpepper_tpu_torch.utils import load_r1cs, load_witness, phase, phase_report, save_r1cs, save_witness

B = 32768  # sha256 instances per chunk
N_CHUNKS = 4
B_FIELD = 8192  # config-1 instances per chunk (benchmarks/configs_1_2_3.py:123)
B_SHA_LIMBS = 1024  # sha256 instances per chunk in the limbs form
CHAIN_BLOCKS = 16  # compressions of the Satisfier's chain (a 1 KiB message)
MUL_WIDE_N = 1 << 20  # mul's second shape: one launch wide enough to fill the card
MUL_FLOOR_N = 32  # one block of mul: its time is the launch's floor
# the Satisfier's widest mul_digits launch (matrix c of the 16-block chain)
# and the chain's padded rows, the N of its reduce_digits and mul launches
MUL_DIGITS_N = 1258176
CHAIN_ROWS_N = 426920
# the rows of mulcmp's launches (times the chunk's batch): the product
# rows of config 1's and the variant's mixed checks; config 1's 90 trivial
# rows and its 2 fold rows padded to 8 in the limbs form; the sha256
# template's 26,352 rows padded to 26,360 in the limbs form (and the big
# row's 8 padded rows of the packed check, at B)
CONFIG1_MUL_ROWS, VARIANT_MUL_ROWS = 60, 61
# the variant's launches of mul a chunk: its 60 fmul stages, then its finv,
# a ladder of one launch a squaring and one a set bit of p − 2 after the top
_E_INV = SCALAR.p - 2
INV_LADDER_MULS = _E_INV.bit_length() - 1 + bin(_E_INV).count("1") - 1
VARIANT_MUL_LAUNCHES = 60 + INV_LADDER_MULS
CONFIG1_TRIVIAL_ROWS, CONFIG1_FOLD_ROWS, SHA256_LIMBS_ROWS = 90, 8, 26360
# the sha256 limbs step's larger batches, run in turn while the peak
# memory extrapolated from the runs before stays under PEAK_GIB
B_SHA_LIMBS_BIG = (2048, 4096, 8192)
PEAK_GIB = 40
# the sha256 step in the bits form: instances per chunk, then the larger
# batches run in turn while the extrapolated peak stays under PEAK_GIB
B_SHA_BITS = 1024
B_SHA_BITS_BIG = (2048, 4096)
# config 4 (benchmarks/config4_merkle_1024.py): blocks a chain, the check's
# batch and the message bits' seed; config 4b's chain counts
CHAIN_T, CHAIN_CHECK_BATCH, CHAIN_SEED = 1024, 512, 11
CHAIN_FLIP_BLOCK = 700  # the block whose witness bit the config-4 probe flips
CHAIN_MULTI_B = (8, 64)
CHAIN_CURVE_B = (1, 8, 64, 256, 1024, 4096)  # the replay of one block at these chain counts
MERKLE_LEAVES = 1024
MUL_POW2_N = 1 << 20  # FieldBackend.mul_pow2's operand rows in the api phase
MUL_POW2_K = (0, 1, 16, 255, 256, 511)
# config 5 (its generator and sizes in tools/config5.py): the rows whose
# completed product is held to Python ints; the row-sharded check's log2
# rows (the benchmark's default size)
CONFIG5_SAMPLES = 4096
ROW_SHARDED_LOG2_R = 20
# the num family's mixed block: instances a chunk, doubled while a step
# stays under NUM_STEP_S seconds and twice the peak under PEAK_GIB, up to
# NUM_B_MAX
NUM_B, NUM_B_MAX, NUM_STEP_S = 1024, 4096, 5.0
# the free words' seeds of configs 2 and 3 (benchmarks/configs_1_2_3.py:194, :246)
CONFIG2_SEED, CONFIG3_SEED = 6, 7
# the op-rate probe: rows (ILP), rounds and elements of each launch
PROBE_R, PROBE_K, PROBE_N = 8, 256, 1 << 20
# the sharding phase: the packed step's global batch (the flagship's 4 ×
# 32,768 instances in one call), the bits step's, the limbs
# ShardedSatisfier's, and each run's ranks and backend (one card: NCCL
# refuses two ranks on one device, so the 2-rank run takes gloo)
SHARD_PACKED_B, SHARD_BITS_B, SHARD_LIMBS_B = 4 * 32768, 4096, 1024
SHARD_RUNS = ((1, "nccl"), (2, "gloo"))
SHARD_LIMBS_FLIP = (700, 9000, 0)  # (instance, slot, limb) of the flipped limb
# fields below 253 bits (fields_path): public primes, defined here and in
# the tests only (the package ships the reference's three fields).
# Goldilocks, Plonky2's and Polygon zkEVM's field (64 bits: every check
# canonical); Jubjub's scalar field, the order of the Sapling embedded
# curve's subgroup (252 bits: the semi routes, no 16-bit quotient estimate)
GOLDILOCKS = PrimeField("goldilocks", 2**64 - 2**32 + 1)
JUBJUB_FR = PrimeField("jubjub_fr", 0x0E7DB4EA6533AFA906673B0101343B00A6682093CCC81082D0970E5ED6F72CB7)
SMALL_FIELDS = (GOLDILOCKS, JUBJUB_FR)
FIELDS_C5_LOG2_R = 20  # config 5 over Goldilocks (the 2^24 run stays on BLS12-381)
SEED = 0x5962BE3D
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12
INT32_LANES = 64 * 132  # per clock: 64 INT32 lanes on each of the 132 SMs
KERNEL_INFO = {
    "bitplane_eq": ("bellpepper_tpu_torch/csrc/bitplane_eq.cu",
                    "bellpepper_tpu/backend/field_pallas.py:489"),
    "bits_matvec_semi": ("bellpepper_tpu_torch/csrc/fold_matvec.cu",
                         "bellpepper_tpu/backend/field_pallas.py:828"),
    "mulcmp": ("bellpepper_tpu_torch/csrc/mulcmp.cu",
               "bellpepper_tpu/backend/field_pallas.py:1009"),
    "chain": ("bellpepper_tpu_torch/csrc/chain.cu",
              "bellpepper_tpu/backend/field_pallas.py:407"),
    "mul": ("bellpepper_tpu_torch/csrc/mul16.cu",
            "bellpepper_tpu/backend/field_pallas.py:704"),
    "limbs_matvec": ("bellpepper_tpu_torch/csrc/fold_matvec.cu",
                     "bellpepper_tpu/backend/field_pallas.py:975"),
    "mul_digits": ("bellpepper_tpu_torch/csrc/mul16.cu",
                   "bellpepper_tpu/backend/field_pallas.py:711"),
    "reduce_digits": ("bellpepper_tpu_torch/csrc/reduce_digits.cu",
                      "bellpepper_tpu/backend/field_pallas.py:720"),
    "bits_matvec_canonical": ("bellpepper_tpu_torch/csrc/fold_matvec.cu",
                              "bellpepper_tpu/backend/field_pallas.py:828"),
    "verdict_fold": ("bellpepper_tpu_torch/csrc/verdict_fold.cu",
                     "no Pallas kernel: the XLA fusion of bellpepper_tpu/backend/matvec.py:3002 verdict_packed"),
    "operand_mulcmp": ("bellpepper_tpu_torch/csrc/operand_mulcmp.cu",
                       "no Pallas kernel: the XLA fusion of the operand assembly of bellpepper_tpu/backend/"
                       "matvec.py:1686 _operand_spec feeding bellpepper_tpu/backend/field_pallas.py:1009"),
}


def reduction_products(words: int, words_p: int = 8) -> int:
    """32-bit multiplies of a Montgomery reduction of a words-word value
    below p: one quotient word and words_p products a word reduced, each
    32×32 → 64-bit product counted as two 32-bit multiplies (its low and
    high words)."""
    return 2 * (words - words_p) * (1 + words_p)


def modmul_products(words_a: int, words_b: int, words_p: int = 8) -> int:
    """32-bit multiplies that a·b mod p needs at the least: a schoolbook
    product of 32-bit words (two multiplies a word pair) and a Montgomery
    reduction of it. The operations side of `bound` counts only products:
    the adds and logic ops fuse around them, so their count gives a time the
    card cannot beat whatever limb size a kernel chooses."""
    return 2 * words_a * words_b + reduction_products(words_a + words_b, words_p)


# Products per element. A canonical modmul (chain's fmul steps, mul,
# mul_digits) takes two 8-word residues; mulcmp's a·b − c takes 17-limb
# semi values below 2^265, 9 words each. bits_matvec_semi multiplies 0/1
# bits by digits (a select, no product) and folds 4 × 32 digit sums by
# constants in its semi reduction, for each live row. limbs_matvec needs
# one 8 × 8-word product a live ELL entry and one reduction of a live
# row's 17-word sum, whatever the 1,024 digit multiply-adds an entry of
# its design. reduce_digits
# reduces a sum of 32 digit sums below 2^24 (a 10-word value). bitplane_eq
# does logic ops only.
MODMUL_MULS = modmul_products(8, 8)
MULCMP_MULS = modmul_products(9, 9)
SEMI_REDUCE_MULS = 4 * 32
ENTRY_MULS = 2 * 8 * 8
ROW_REDUCE_MULS = reduction_products(17)
REDUCE_MULS = reduction_products(10)


def digit_reduce_products(field) -> int:
    """REDUCE_MULS at the field's word count: a sum of 32 digit sums below
    2^32 (10 words) reduced mod a W-word p."""
    return reduction_products(10, word_count(field.p))


def mul_bytes(field, n: int, out_rows: int = 16) -> int:
    """The bytes mul (out_rows 16) or mul_digits (32) must move for n
    elements: a's 16 limbs (a raw a may fill them), b's 2W (a canonical b
    is zero above them) and the output rows."""
    return (16 + 2 * word_count(field.p) + out_rows) * 4 * n


def kernel_ptxas(log: str, kernel: str, targs: str = "") -> str:
    """ptxas's register and spill lines for one kernel of an nvcc -Xptxas
    -v log (its mangled name holds the length-prefixed kernel name, then
    targs, the mangled template arguments of one instantiation, as "ILb1E"
    for <true>)."""
    found, on = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            on = f"{len(kernel)}{kernel}{targs}" in ln
        elif on and ("registers" in ln or "spill" in ln):
            found.append(ln.strip())
    return " | ".join(found) or "no ptxas report (library built before this run)"


def nvidia_smi(query: str) -> str:
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def card_line() -> str:
    return nvidia_smi("name,power.limit")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_s(fn, reps: int) -> float:
    """Mean host-clock seconds of fn() over reps calls, after one warm-up,
    with one synchronize at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.time() - t0) / reps


def max_abs_err(x: torch.Tensor, y: torch.Tensor) -> int:
    return int((to_u32(x) - to_u32(y)).abs().max())


class Bound:
    """The least time the card could take for a kernel's work."""

    def __init__(self, max_sm_mhz: float):
        self.int_ops_per_s = INT32_LANES * max_sm_mhz * 1e6

    def __call__(self, n_bytes: float, n_ops: float):
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / self.int_ops_per_s * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, kernel, plain, bound, reps=20, plain_reps=3, library=None, device=None):
    """Kernel vs plain version on the same card inputs:
    dict(err, ms, plain_ms, bound_ms, bound_by, library_ms). With device,
    (wrapper, n, layout) of a mul_digits or reduce_digits table, the table
    also waits in DEVICE_TIMED for device_times."""
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = max_abs_err(out, ref)
    ms, plain_ms = cuda_ms(kernel, reps), cuda_ms(plain, plain_reps)
    lib_ms = cuda_ms(library, reps) if library is not None else None
    lib = f" library {lib_ms:.4f} ms" if lib_ms is not None else ""
    print(f"[kernel] {name}: shape {tuple(out.shape)} max_abs_err {err} kernel {ms:.4f} ms "
          f"plain {plain_ms:.4f} ms{lib} bound {bound[0]:.4f} ms ({bound[1]})")
    assert err == 0, f"{name} disagrees with its plain version"
    assert ms >= bound[0], f"{name} beat its bound: the bound counts work these inputs do not need"
    out = {"table": name, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
           "bound_by": bound[1], "library_ms": lib_ms}
    if device:
        DEVICE_TIMED.append((out, device))
    return out


DEVICE_TIMED = []  # (table, (wrapper, n, layout)) of compare(device=...), for device_times


def device_times(dev) -> None:
    """The profiler's device time a launch, free of the host's launch, of
    every table in DEVICE_TIMED, taken after every path: a profiler
    session slows the process's later launches, and no step is timed
    after one. On fresh seeded inputs of the table's shape and layout
    (the kernels' time does not depend on the values: mul_digits' a below
    2^256, b canonical; reduce_digits' sums below 2^24), with L2 flushed
    before each call (device_ms: the inputs from device memory, as bound
    counts them; held to the bound) and warm (device_warm_ms: the inputs
    left in L2 where they fit, as a caller that has just written them
    finds them; it may read below the bound, which counts device-memory
    bytes). Adds both to each table."""
    gen = torch.Generator(device=dev)
    for table, (wrapper, n, layout) in DEVICE_TIMED:
        gen.manual_seed(SEED + n)
        if wrapper == "mul_digits":
            a, b = (torch.randint(0, 1 << 16, (16, n), generator=gen, device=dev, dtype=torch.int32)
                    for _ in range(2))
            b[15] %= SCALAR.p >> 240
            call, kernel = (lambda: fk.mul_digits(a, b, SCALAR)), "mul_kernel"
        else:
            em = torch.randint(0, 1 << 24, (n, 32), generator=gen, device=dev, dtype=torch.int32)
            d = em.t() if layout == "element-major" else em.t().contiguous()
            call, kernel = (lambda: fk.reduce_digits(d, SCALAR)), "reduce_digits_kernel"
        cold, warm = (device_ms(torch, call, 20, kernel=kernel, cold=c) for c in (True, False))
        print(f"[device] {table['table']}: kernel {table['ms']:.4f} ms event, device "
              + ", ".join("not measured" if t is None else f"{t:.4f} ms" for t in (cold, warm))
              + f" with L2 flushed, warm; bound {table['bound_ms']:.4f} ms")
        assert cold is None or cold >= table["bound_ms"], f"{table['table']} beat its bound in device time"
        table.update(device_ms=cold, device_warm_ms=warm)
    DEVICE_TIMED.clear()
    torch.cuda.empty_cache()


def digit_sum_corners(p: int, seed: int) -> np.ndarray:
    """uint32[N, 32] element-major digit sums at reduce_digits' corners:
    every sum 0, 1 or 2^24 − 1 (the callers' bound); each position at each
    of those among random sums; values p and p − 1; values ≡ 0 and ≡ −1
    (mod p) made of large sums (random sums of at least 256, less the
    bytes of the excess); then random sums below 2^24."""
    top = (1 << 24) - 1
    rnd = random.Random(seed)

    def value(col):
        return sum(x << (8 * j) for j, x in enumerate(col))

    cols = [[v] * 32 for v in (0, 1, top)]
    for j in range(32):
        for v in (0, 1, top):
            col = [rnd.randrange(top + 1) for _ in range(32)]
            col[j] = v
            cols.append(col)
    cols += [[(x >> (8 * j)) & 0xFF for j in range(32)] for x in (p, p - 1)]
    for _ in range(4):
        for target in (0, p - 1):
            col = [rnd.randrange(256, top + 1) for _ in range(32)]
            r = (value(col) - target) % p
            cols.append([x - ((r >> (8 * j)) & 0xFF) for j, x in enumerate(col)])
    cols += [[rnd.randrange(top + 1) for _ in range(32)] for _ in range(25)]
    return np.asarray(cols, np.uint32)


def digit_sums_at(n: int, p: int, seed: int) -> np.ndarray:
    """uint32[n, 32] element-major: digit_sum_corners first, then random
    sums below 2^24."""
    corners = digit_sum_corners(p, seed)
    rest = np.random.default_rng(seed).integers(0, 1 << 24, size=(n - len(corners), 32), dtype=np.uint32)
    return np.concatenate([corners, rest])


def check_reduced(got: torch.Tensor, sums: np.ndarray, p: int, what: str) -> None:
    """reduce_digits' output on digit_sums_at's sums, its corner columns
    and its last, against Python's Σ d_j·2^(8j) mod p."""
    for i in [*range(len(digit_sum_corners(p, 0))), len(sums) - 1]:
        assert col_int(got, i) == sum(int(sums[i, j]) << (8 * j) for j in range(32)) % p, (what, i)


def limbs(v, n=17):
    return [(v >> (16 * l)) & 0xFFFF for l in range(n)]


def canonical_lm(values, dev):
    """int32[16, N] limb-major canonical limbs of Python ints."""
    return from_numpy_u32(np.asarray([limbs(v, 16) for v in values], np.uint32).T.copy(), dev)


def limb_int(row) -> int:
    return sum(int(x) << (16 * l) for l, x in enumerate(row))


def col_int(t: torch.Tensor, i: int) -> int:
    return limb_int(to_u32(t[:, i]).tolist())


def config1(nonzero: bool, field=SCALAR):
    nb = NativeBuilder(field)
    bits = [nb.alloc_bit() for _ in range(128)]
    a, b = nb.pack_bits(bits[:64]), nb.pack_bits(bits[64:])
    x = a
    for _ in range(30):
        x = nb.num_square(nb.num_add(nb.num_mul(x, b), a))
    if nonzero:
        nb.num_assert_nonzero(x)
    template, tape = nb.finish()
    return template, WitnessProgram(tape)


def chain_steps(bits, field=SCALAR):
    """Config 1's chain over Python ints for one instance's 128 free
    bits (a, then b; pack_bits keeps the field's CAPACITY of each 64):
    [m, s, x] of each of the 30 repetitions of x <- ((x·b + a) mod p)² mod
    p."""
    p, cap = field.p, min(64, field.CAPACITY)
    a = sum(int(bits[k]) << k for k in range(cap))
    b = sum(int(bits[64 + k]) << k for k in range(cap))
    x, out = a, []
    for _ in range(30):
        m = x * b % p
        s = (m + a) % p
        x = s * s % p
        out.append([m, s, x])
    return out


def path_run(step, *args):
    """One run of a path's step with every launch count reset just before
    and read just after: (verdict, counts)."""
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    total, first = step(*args)
    verdict = (int(total), int(first))
    return verdict, fk.launch_counts()


def time_step(step, free, reps):
    torch.cuda.synchronize()
    t0 = time.time()
    totals = [step(free)[0] for _ in range(reps)]
    torch.cuda.synchronize()
    dt = (time.time() - t0) / reps
    assert sum(int(t) for t in totals) == 0
    return dt


def perf_step(name, step, free, batch, n_rows, card, reps):
    """Time a step of N_CHUNKS × batch instances (its verdict must stay
    clean) and print its rate and peak memory; returns the peak in GiB."""
    torch.cuda.reset_peak_memory_stats()
    t_step = time_step(step, free, reps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[perf] {name} step {t_step:.4f} s for {N_CHUNKS}x{batch} instances = "
          f"{N_CHUNKS * batch * n_rows / t_step:.4e} constraint-evals/s, peak {peak:.2f} GiB, on {card}")
    return peak


def mulcmp_operands(N: int, dev):
    """a, b, c int32[17, N] on the card: random semi values below 2^265
    (the range of the semi-reduced matvec outputs and of the assembled
    trivial-row operands, which stay below 4p), with the corner operands
    (0, p, 2p, 2^265 − 1) in all combinations and 1,024 true products
    (c = a·b mod p, plus p at odd columns) in the first columns (as many
    as N holds); and the verdicts of those columns (True where a·b ≢ c)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + N)
    ops = [torch.randint(0, 1 << 16, (17, N), generator=gen, device=dev, dtype=torch.int32) for _ in range(3)]
    for o in ops:
        o[16] &= 0x1FF  # values < 2^265
    p = SCALAR.p
    corners = [0, p, 2 * p, (1 << 265) - 1]
    cols = [(va, vb, vc) for va in corners for vb in corners for vc in corners]
    want = [(va * vb - vc) % p != 0 for va, vb, vc in cols]
    rnd = np.random.default_rng(SEED + 1)
    for i in range(1024):
        va, vb = (int.from_bytes(rnd.bytes(32), "little") % p for _ in range(2))
        cols.append((va, vb, (va * vb) % p + (p if i % 2 else 0)))
        want.append(False)
    cols, want = cols[:N], want[:N]
    for k, o in enumerate(ops):
        o[:, : len(cols)] = from_numpy_u32(np.asarray([limbs(col[k]) for col in cols], np.uint32).T.copy(), dev)
    return ops, np.asarray(want)


def mulcmp_bound(bound, N: int):
    return bound(N * 4 * (3 * SEMI + 1), N * MULCMP_MULS)


def mulcmp_at(name: str, N: int, dev, bound):
    """mulcmp at one more of its paths' shapes: the planted columns'
    verdicts, and every column's 0/1 mask bit-exact against the plain
    version (run over slices of 2^20 columns, which bounds its int64
    temporaries); its time beside its bound."""
    (a, b, c), want = mulcmp_operands(N, dev)
    out = fk.mulcmp(a, b, c, SCALAR)
    assert ((out[: len(want)] != 0).cpu().numpy() == want).all(), ("mulcmp planted columns", N)
    del out
    return mulcmp_on(name, a, b, c, bound)


def mulcmp_on(name: str, a, b, c, bound, field=SCALAR):
    """mulcmp on operands int32[17, N] in which both verdicts occur: its
    0/1 mask bit-exact against the plain version (run over slices of 2^20
    columns, which bounds its int64 temporaries), whose mask holds both
    verdicts; its time beside its bound."""
    N = a.shape[1]
    out = fk.mulcmp(a, b, c, field)
    step = 1 << 20
    plain = torch.cat([fk.mulcmp_plain(*(o[:, s : s + step].contiguous() for o in (a, b, c)), field)
                       for s in range(0, N, step)])
    both_verdicts(f"mulcmp {name}", plain)
    err = max_abs_err(out, plain)
    del plain
    ms = cuda_ms(lambda: fk.mulcmp(a, b, c, field), 5)
    b_ms, b_by = mulcmp_bound(bound, N)
    print(f"[kernel] mulcmp {name} N={N}: max_abs_err {err} kernel {ms:.4f} ms bound {b_ms:.4f} ms ({b_by})")
    assert err == 0, f"mulcmp disagrees with its plain version at N={N}"
    assert ms >= b_ms, f"mulcmp {name} beat its bound: the bound counts work these inputs do not need"
    del a, b, c, out
    torch.cuda.empty_cache()
    return {"table": f"{name} N={N}", "max_abs_err": err, "ms": ms, "bound_ms": b_ms, "bound_by": b_by}


def eager_product_bad(prods: Products, vals_p, flimbs_p, field):
    """The product rows' route before operand_mulcmp: each operand
    assembled by _Operand.assemble in int64 [n, 17, B], copied limb-major,
    then mulcmp; bool[n, B]."""
    n, B = prods.n, flimbs_p.shape[-1]
    p17 = torch.tensor(limbs(field.p), dtype=torch.int64, device=flimbs_p.device).reshape(1, SEMI, 1)
    a, b, c = (to_i32(o.assemble(vals_p, flimbs_p, p17).transpose(0, 1).reshape(SEMI, n * B)).contiguous()
               for o in prods.ops)
    return (fk.mulcmp(a, b, c, field) != 0).reshape(n, B)


def table_rows(table, lo: int, hi: int):
    """Rows lo..hi of an OperandTable (its descriptors sliced)."""
    part = copy.copy(table)
    part.desc = table.desc[lo:hi]
    part.n = part.desc.shape[0]
    return part


def operand_mulcmp_bound(bound, table, B: int):
    """Bytes: each distinct field row's 16 limb words and u32 row's word
    of every instance read once, the mask written, the tables read;
    operations: mulcmp's word products a column."""
    d = table.desc.cpu().numpy().reshape(-1, 3, 6)
    on = (d[:, :, :1] >> np.arange(4)) & 1
    n_f = len(np.unique(d[:, :, 2:4][on[:, :, :2] == 1]))
    n_u = len(np.unique(d[:, :, 4:6][on[:, :, 2:] == 1]))
    n_bytes = (64 * n_f + 4 * n_u + table.n) * B + 4 * (table.desc.numel() + table.consts.numel())
    return bound(n_bytes, table.n * B * MULCMP_MULS)


def every_fifth_flipped(fl_p: torch.Tensor) -> torch.Tensor:
    """A copy of limbs int32[F, 16, B] with bit 16 of each value (bit 0
    of limb 1) cleared at every fifth instance: the values stay below p,
    and the rows that read a value that had the bit set fail there."""
    out = fl_p.clone(memory_format=torch.contiguous_format)
    out[:, 1, ::5] &= ~1
    return out


def operand_mulcmp_on(name: str, table, vals_p, flimbs_p, bound, field=SCALAR, plain_reps=3) -> dict:
    """operand_mulcmp at a path's product-row table on its witness: the
    mask bit-exact against the plain version (over slices of rows, which
    bounds its int64 temporaries), both verdicts in it; its time beside
    its bound and the plain version's (all slices, timed plain_reps
    times)."""
    B = flimbs_p.shape[-1]
    step = max(1, (1 << 20) // B)
    out = fk.operand_mulcmp(table, flimbs_p, vals_p, field)

    def plain():
        return torch.cat([fk.operand_mulcmp_plain(table_rows(table, s, s + step), flimbs_p, vals_p, field)
                          for s in range(0, table.n, step)])

    ref = plain()
    both_verdicts(f"operand_mulcmp {name}", ref)
    err = max_abs_err(out, ref)
    del out, ref
    ms = cuda_ms(lambda: fk.operand_mulcmp(table, flimbs_p, vals_p, field), 10)
    plain_ms = cuda_ms(plain, plain_reps)
    b_ms, b_by = operand_mulcmp_bound(bound, table, B)
    print(f"[kernel] operand_mulcmp {name} [{table.n}, {B}]: max_abs_err {err} kernel {ms:.4f} ms plain "
          f"{plain_ms:.4f} ms bound {b_ms:.4f} ms ({b_by})")
    assert err == 0, f"operand_mulcmp disagrees with its plain version at {name}"
    assert ms >= b_ms, f"operand_mulcmp {name} beat its bound: the bound counts work these inputs do not need"
    torch.cuda.empty_cache()
    return {"table": f"{name} [{table.n}, {B}]", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def gathered_bytes(cols: torch.Tensor, slot_bytes: int) -> int:
    """The bytes of the distinct witness slots a column or plane table
    reads (each read once)."""
    live = cols[cols >= 0]
    return int(torch.unique(live).numel()) * slot_bytes


def semi_buckets(label, vals_p, semi_check, bound, library: bool, slice_words=None):
    """bits_matvec_semi at every ELL bucket of a BitsSemiCheck, on packed
    words vals_p int32[S, Bw] (bits_matvec_canonical where the check's
    field is below 250 bits): each bucket against its plain version (run
    over slices of slice_words words where the full batch's float64
    digit planes would not fit) and, with `library`, torch.bmm in float32
    over the gathered bits' 32 digit sums only (no reduction); the sums
    over the buckets of the kernel's, the plain version's and the
    library's times and of the bounds' bytes and products."""
    field = semi_check.field
    if semi_check.semi:
        kname, kern, plain, out_rows, row_ops = (
            "bits_matvec_semi", fk.bits_matvec_semi, fk.bits_matvec_semi_plain, SEMI, SEMI_REDUCE_MULS)
    else:
        kname, kern, plain, out_rows, row_ops = (
            "bits_matvec_canonical", fk.bits_matvec_canonical, fk.bits_matvec_canonical_plain, 16,
            digit_reduce_products(field))
    Bw = vals_p.shape[1]
    B_ = 32 * Bw
    step_w = slice_words or Bw
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0 if library else None, "bytes": 0, "ops": 0}
    for name in "abc":
        for cols, F in semi_check.mats[name]:
            n_rows, K = cols.shape
            n_live = int((cols >= 0).any(1).sum())
            n_bytes = gathered_bytes(cols, Bw * 4) + F.numel() + out_rows * n_rows * B_ * 4
            n_ops = n_live * B_ * row_ops
            lib = None
            if library:
                xf = fk._gather_bits(vals_p, cols).float()
                Ff = F[:, :, :K].float()
                lib = lambda: torch.bmm(Ff, xf)  # noqa: E731
            r = compare(
                f"{kname} {label} {name} K={K} rows={n_rows} ({n_live} live)",
                lambda: kern(vals_p, cols, F, field),
                lambda: torch.cat([plain(vals_p[:, s : s + step_w].contiguous(), cols, F, field)
                                   for s in range(0, Bw, step_w)], dim=2),
                bound(n_bytes, n_ops), library=lib)
            for k in ("ms", "plain_ms") + (("library_ms",) if library else ()):
                tot[k] += r[k]
            tot["bytes"] += n_bytes
            tot["ops"] += n_ops
            if library:
                del xf, Ff
    torch.cuda.empty_cache()
    b_ms, b_by = max(bound(tot["bytes"], 0), bound(0, tot["ops"]))
    return {"table": f"{label} buckets", "max_abs_err": 0, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": tot["library_ms"]}


def bitplane_at(label, vals_p, spec, planes, bound):
    """bitplane_eq at one path's plane table, against its plain version;
    the library has no counterpart."""
    n, m_a, m_c = spec["a_cols"].shape[0], spec["a_cols"].shape[2], spec["c_cols"].shape[2]
    P = fk.padded_positions(spec["n_pos"])
    Bw = vals_p.shape[1]
    return compare(
        f"bitplane_eq {label} n={n} P={P} m_a={m_a} m_c={m_c} Bw={Bw} ({int((planes < 0).sum())} of "
        f"{planes.numel()} planes empty)",
        lambda: fk.bitplane_eq(vals_p, planes, n, P, m_a, m_c),
        lambda: fk.bitplane_eq_plain(vals_p, planes, n, P, m_a, m_c),
        bound(gathered_bytes(planes, Bw * 4) + n * Bw * 4, 0))


def verdict_fold_at(label, vals_p, check, bound):
    """verdict_fold over every fold of a packed check's verdict on vals_p
    (its families' and pow2 rows' bad words, its big rows' mask), into one
    running verdict, against the plain version: the two int64 words
    compared as four 32-bit halves."""
    R, B = check.Rt0, check.batch
    ins = [(words, rows) for words, rows in check._fam_bad_words(vals_p)]
    ins.append((check._pow2_bad_words(vals_p), check.pow2_rows))
    ins.append((check._big_bad(vals_p), check.rest_big_idx))
    acc0 = fk.verdict_acc(vals_p.device)

    def run(fold):
        acc = acc0.clone()
        for bad, rows in ins:
            fold(acc, bad, rows, R, B)
        return acc.view(torch.int32)

    out = run(fk.verdict_fold)
    assert out.view(torch.int64)[0] > 0, "verdict_fold: the random odd words violate rows"
    n_bytes = sum(bad.numel() * bad.element_size() for bad, _rows in ins)
    return compare(f"verdict_fold {label} {len(ins)} folds at B={B}", lambda: run(fk.verdict_fold),
                   lambda: run(fk.verdict_fold_plain), bound(n_bytes, 0), plain_reps=2)


def sha256_kernels(dev, bound, template, prog):
    """bitplane_eq, bits_matvec_semi, verdict_fold and mulcmp at the sha256
    step's shapes and tables: the packed check's pow2 plane table, its big
    row's ELL buckets and its verdict's eight folds, read from one chunk's
    packed witness whose odd words are random (so both verdicts occur)."""
    rng = np.random.default_rng(SEED)
    Bw = B // 32
    results = {}
    check = build_templated_check(template, B, None, "bits_packed", device=dev)
    free = from_numpy_u32(rng.integers(0, 1 << 32, size=(Bw, 512), dtype=np.uint64).astype(np.uint32), dev)
    vals_p = prog.build_packed(device=dev)(free).t().contiguous()  # [S_t, Bw]
    vals_p[:, 1::2] = from_numpy_u32(rng.integers(0, 1 << 32, size=(vals_p.shape[0], Bw // 2),
                                                  dtype=np.uint64).astype(np.uint32), dev)
    del free
    # bitplane_eq: the 25 MultiEq rows, P = 256, m_a = 7, m_c = 1, over
    # the plane table (empty planes −1); the library has no counterpart
    spec, planes = check.pow2_spec, check.plane_idx
    n, m_a, m_c = spec["a_cols"].shape[0], spec["a_cols"].shape[2], spec["c_cols"].shape[2]
    P = fk.padded_positions(spec["n_pos"])
    bad = fk.bitplane_eq(vals_p, planes, n, P, m_a, m_c)
    assert not bad[:, ::2].any() and bad[:, 1::2].all(), "bitplane_eq verdicts"
    results["bitplane_eq"] = bitplane_at("sha256", vals_p, spec, planes, bound)
    # bits_matvec_semi: the big row's ELL buckets, one a matrix, (K, rows) =
    # (512, 8), (1, 8), (256, 8), 7 rows of each padding
    results["bits_matvec_semi"] = semi_buckets("sha256", vals_p, check.big, bound, library=True)
    results["verdict_fold"] = verdict_fold_at("sha256", vals_p, check, bound)
    del vals_p, check
    # mulcmp: N = 8 padded rows × B
    N = 8 * B
    (a, b, c), want = mulcmp_operands(N, dev)
    got = (fk.mulcmp(a, b, c, SCALAR)[: len(want)] != 0).cpu().numpy()
    assert (got == want).all(), "mulcmp corner/product columns wrong"
    results["mulcmp"] = compare(
        f"mulcmp sha256 packed N={N}", lambda: fk.mulcmp(a, b, c, SCALAR),
        lambda: fk.mulcmp_plain(a, b, c, SCALAR), mulcmp_bound(bound, N), plain_reps=2)
    torch.cuda.empty_cache()
    return results


def chain_at(label, dev, bound, field=SCALAR, N=None):
    """chain at the config-1 path's shape (x0 [16, N], B_FIELD by default,
    config 1's pattern, 30 repetitions) against its plain version and, at
    five instances (operands 0, 1 and p − 1 among them), Python ints."""
    p = field.p
    N = N or B_FIELD
    rnd = random.Random(SEED)
    x0v = [rnd.randrange(p) for _ in range(N)]
    av = [0, 1, p - 1] + [rnd.randrange(p) for _ in range(N - 3)]
    bv = [p - 1, 0, 1] + [rnd.randrange(p) for _ in range(N - 3)]
    x0, a, b = (canonical_lm(v, dev) for v in (x0v, av, bv))
    ext = torch.cat([b, a])  # the config-1 pattern's ext 0 = b, ext 1 = a
    descs = (("fmul", "prev", 0), ("fadd", "prev", 1), ("fmul", "prev", "prev"))
    out = fk.chain(x0, ext, descs, 30, field)
    for i in (0, 1, 2, 3, N - 1):
        x = x0v[i]
        for r in range(30):
            m = x * bv[i] % p
            s = (m + av[i]) % p
            x = s * s % p
            got = [col_int(out[(3 * r + j) * 16 : (3 * r + j + 1) * 16], i) for j in range(3)]
            assert got == [m, s, x], ("chain", i, r)
    W = word_count(p)
    n_bytes = (2 * W + 2 * 2 * W + 90 * 16) * 4 * N  # x0's and ext's 2W limbs, every step's 16
    return compare(
        label, lambda: fk.chain(x0, ext, descs, 30, field),
        lambda: fk.chain_plain(x0, ext, descs, 30, field),
        bound(n_bytes, N * 60 * modmul_products(W, W, W)), plain_reps=2)


def field_kernels(dev, bound):
    """chain and mul at the config-1 path's shapes, against their plain
    versions and Python ints."""
    results = {"chain": chain_at("chain", dev, bound)}
    N = B_FIELD
    rng = np.random.default_rng(SEED)
    for n in (MUL_FLOOR_N, N, MUL_WIDE_N, CHAIN_ROWS_N):
        r = mul_at(f"mul N={n}", n, dev, bound, rng)
        if n == N:
            results["mul"] = r
    torch.cuda.empty_cache()
    return results


def canonical_limbs_np(p: int, n: int, rng) -> np.ndarray:
    """uint32[16, n] random limbs of canonical values: p's top limb's
    position below p's top limb, zero above it."""
    t = (p.bit_length() - 1) // 16
    x = rng.integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
    x[t] = rng.integers(0, p >> (16 * t), size=n, dtype=np.uint32)
    x[t + 1 :] = 0
    return x


def mul_at(name, n, dev, bound, rng, field=SCALAR):
    """mul on [16, n]: random canonical operands (top limb below p's), the
    corner pairs of 0, 1, p − 1, p − 2 and the values whose limbs below
    the top one are all 0xFFFF in the first 36 columns; columns against
    Python ints, then the whole against the plain version."""
    p = field.p
    t = 16 * ((p.bit_length() - 1) // 16)
    top = p >> t
    corners = [0, 1, p - 1, p - 2, (1 << t) - 1, ((top - 1) << t) | ((1 << t) - 1)]
    nc = len(corners)
    ops = []
    for k in range(2):
        x = canonical_limbs_np(p, n, rng)
        for i in range(min(n, nc * nc)):
            x[:, i] = limbs(corners[i // nc if k else i % nc], 16)
        ops.append(from_numpy_u32(x, dev))
    ma, mb = ops
    got = fk.mul(ma, mb, field)
    for i in list(range(min(n, nc * nc))) + [n // 2, n - 1]:
        assert col_int(got, i) == col_int(ma, i) * col_int(mb, i) % p, ("mul", n, i)
    return compare(name, lambda: fk.mul(ma, mb, field), lambda: fk.mul_plain(ma, mb, field),
                   bound(mul_bytes(field, n), n * modmul_products(*(3 * [word_count(p)]))), plain_reps=2)


def sha256_path(dev, card):
    t0 = time.time()
    nb = NativeBuilder()
    bits = [nb.alloc_bit() for _ in range(512)]
    nb.sha256_compression(bits, nb.sha256_iv())
    template, tape = nb.finish()
    prog = WitnessProgram(tape)
    R, S = template.num_constraints, prog.num_slots
    assert (R, S) == (26352, 26327), (R, S)
    print(f"[synth] sha256 template: {R} rows, {S} slots, {len(prog.stages)} stages "
          f"in {time.time() - t0:.2f} s (native build included)")
    return template, prog


PROBES = {}  # path → the verdicts its phase found, which the api phase's reference-style calls must equal


def sha256_free(dev):
    """The sha256 steps' packed free bits [N_CHUNKS, B/32, 512] (seed SEED)."""
    rng = np.random.default_rng(SEED)
    free_np = rng.integers(0, 1 << 32, size=(N_CHUNKS, B // 32, 512), dtype=np.uint64).astype(np.uint32)
    return free_np, from_numpy_u32(free_np, dev)


def sha256_step(dev, card, template, prog, name="sha256", same_as=None):
    """The packed sha256 step at N_CHUNKS × B: the clean verdict and its
    launches, chunk 0 equal to the CPU evaluator on 16 words (and, with
    `same_as`, to that program's words on the card), a flipped bit found
    at its instance; its time, rate and peak."""
    R = template.num_constraints
    Bw = B // 32
    free_np, free = sha256_free(dev)
    t0 = time.time()
    step = build_packed_production_step(prog, template, B, device=dev)
    print(f"[step] {name} built in {time.time() - t0:.2f} s")
    step(free)  # warm-up
    verdict, launches = path_run(step, free)
    print(f"[step] {name} verdict {verdict} launches {launches}")
    assert verdict == (0, 0xFFFFFFFF), verdict
    assert all(launches[k] > 0 for k in ("bitplane_eq", "bits_matvec_semi", "mulcmp", "verdict_fold")), launches

    gen = build_packed_chunked_witness(prog, device=dev)
    vals0 = gen(free)[0]
    cpu_words = prog.build_packed(device="cpu")(torch.from_numpy(free_np[0, :16].view(np.int32)))
    assert torch.equal(vals0[:16].cpu(), cpu_words), "chunk 0 words differ from the CPU evaluator"
    if same_as is not None:
        assert torch.equal(vals0, same_as.build_packed(device=dev)(free[0])), \
            f"{name} chunk 0 differs from the other program"
    check = build_templated_check(template, B, None, "bits_packed", device=dev)
    assert tuple(int(v) for v in check.verdict(vals0)) == (0, 0xFFFFFFFF)
    vbad = vals0.clone()
    vbad[Bw // 2, 600] ^= 1 << 7
    nbad, fbad = (int(v) for v in check.verdict(vbad))
    assert nbad > 0 and fbad // R == 32 * (Bw // 2) + 7, (nbad, fbad)
    same = " and, all of it, NativeBuilder's program's" if same_as is not None else ""
    print(f"[probe] {name} chunk-0 words match the CPU evaluator{same}; corruption at "
          f"vp[{Bw // 2}, 600] bit 7 found: n_bad {nbad}, instance {fbad // R}")
    PROBES[name] = {"verdict": verdict, "corrupt": (nbad, fbad)}
    del vals0, vbad, gen, check

    perf_step(name, step, free, B, R, card, 5)
    return launches


def field_synth():
    t0 = time.time()
    built = {}
    for name, nonzero, want_rs, want_cls in (
        ("config1", False, (220, 221), (128, 30, CONFIG1_MUL_ROWS, 2, 0)),
        ("variant", True, (221, 222), (128, 30, VARIANT_MUL_ROWS, 2, 0)),
    ):
        template, prog = config1(nonzero)
        rs = (template.num_constraints, prog.num_slots)
        cls = _classify_mixed_rows(template, prog.field_slots)
        counts = tuple(len(cls[k]) for k in ("bool_u32", "lin", "mul", "pow2", "rest"))
        assert rs == want_rs and counts == want_cls, (name, rs, counts)
        print(f"[synth] {name}: {rs[0]} rows, {rs[1]} slots, {len(prog.stages)} stages, "
              f"row classes bool/lin/mul/pow2/rest {'/'.join(map(str, counts))}")
        built[name] = (template, prog)
    print(f"[synth] field templates in {time.time() - t0:.2f} s")
    return built


def field_steps(dev, card, built, bound, tables):
    p = SCALAR.p
    free_np = np.random.default_rng(5).integers(0, 2, size=(N_CHUNKS, B_FIELD, 128)).astype(np.uint32)
    free = from_numpy_u32(free_np, dev)
    launches = {}
    steps = {}
    for name in ("config1", "variant"):
        template, prog = built[name]
        step = steps[name] = build_production_step(prog, template, B_FIELD, device=dev)
        step(free)  # warm-up
        verdict, counts = path_run(step, free)
        launches[name] = counts
        print(f"[step] {name} verdict {verdict} launches {counts}")
        assert verdict == (0, 0xFFFFFFFF), verdict
        assert counts["operand_mulcmp"] == N_CHUNKS and not counts["mulcmp"], counts
        if name == "config1":
            assert counts["chain"] == N_CHUNKS, counts
        else:
            assert counts["mul"] == VARIANT_MUL_LAUNCHES * N_CHUNKS, counts

    # probes on config 1's chunk 0
    template, prog = built["config1"]
    R = template.num_constraints
    ev = prog.build(device=dev)
    vals0, fl0 = ev(free[0])
    cpu_vals, cpu_fl = prog.build(device="cpu")(torch.from_numpy(free_np[0, :16].view(np.int32)))
    assert torch.equal(vals0[:16].cpu(), cpu_vals) and torch.equal(fl0[:16].cpu(), cpu_fl), \
        "config-1 chunk 0 differs from the CPU evaluator"
    spec = _detect_linear_chain([st for st in prog.stages if st.opcode in SCAN_OPS])
    rows = spec["out_rows"]
    for i in (0, 1, B_FIELD // 2, B_FIELD - 1):
        for r, want in enumerate(chain_steps(free_np[0, i])):
            got = [col_int(fl0[i, int(rows[3 * r + j])].reshape(16, 1), 0) for j in range(3)]
            assert got == want, ("chain probe", i, r)
    check = build_templated_check(template, B_FIELD, None, "mixed", field_slots=prog.field_slots, device=dev)
    assert check.n_mul == CONFIG1_MUL_ROWS  # operand_mulcmp's rows on this path, compared below
    assert tuple(int(v) for v in check.verdict(vals0, fl0)) == (0, 0xFFFFFFFF)
    fbad = fl0.clone()
    mid = int(rows[45])
    fbad[B_FIELD // 2, mid, 0] ^= 1
    nbad, first = (int(v) for v in check.verdict(vals0, fbad))
    assert nbad > 0 and first // R == B_FIELD // 2, (nbad, first)
    print(f"[probe] config1 chunk-0 vals and flimbs match the CPU evaluator for 16 instances; "
          f"the chain of 4 instances matches x <- ((x*b + a) mod p)^2 mod p; a flipped bit of "
          f"field row {mid} at instance {B_FIELD // 2} found: n_bad {nbad}, instance {first // R}")
    del vals0, fl0, fbad

    # probe on the variant's chunk 0: its finv, the ladder of mul launches
    _, prog_v = built["variant"]
    fin = next(st for st in prog_v.stages if st.opcode == "finv")
    assert int(fin.arrs["a_kind"][0]) == SRC_ROW
    x_row, inv_row = int(fin.arrs["a_idx"][0]), int(fin.outs[0])
    ev_v = prog_v.build(device=dev)
    vals_v, fl_v = ev_v(free[0])
    cpu_vals, cpu_fl = prog_v.build(device="cpu")(torch.from_numpy(free_np[0, :16].view(np.int32)))
    assert torch.equal(vals_v[:16].cpu(), cpu_vals) and torch.equal(fl_v[:16].cpu(), cpu_fl), \
        "variant chunk 0 differs from the CPU evaluator"
    for i in (0, 1, B_FIELD // 2, B_FIELD - 1):
        x = chain_steps(free_np[0, i])[-1][2]
        got = [col_int(fl_v[i, row].reshape(16, 1), 0) for row in (x_row, inv_row)]
        assert got == [x, pow(x, p - 2, p)], ("inv probe", i)
    print(f"[probe] variant chunk-0 vals and flimbs match the CPU evaluator for 16 instances; "
          f"its finv (field row {inv_row}) of 4 instances equals pow(x, p - 2, p) of the chain's "
          f"last x (row {x_row})")
    del vals_v, fl_v

    # per-chunk witness and check seconds (and the check's split by row
    # class), each step's time and peak memory
    reps = 5
    vals_p, fl_p = ev.slot_major(free[0])
    assert int(check.verdict_slot_major(vals_p, fl_p)[0]) == 0
    tables["operand_mulcmp"].append(operand_mulcmp_on("config1 mixed", check.mul.table, vals_p,
                                                      every_fifth_flipped(fl_p), bound))
    t_wit = wall_s(lambda: ev.slot_major(free[0]), reps)
    t_chk = wall_s(lambda: check.verdict_slot_major(vals_p, fl_p), reps)
    split = ", ".join(f"{c} rows {wall_s(lambda: check.class_bad(c, vals_p, fl_p), reps):.5f} s"
                      for c, rows in zip(ROW_CLASSES, check.rows) if rows.numel())
    print(f"[perf] config1 per chunk of {B_FIELD}: witness {t_wit:.5f} s, check {t_chk:.5f} s "
          f"({split}), on {card}")
    # the variant's: witness, its finv alone (the ladder of mul launches)
    # and check
    check_v = build_templated_check(built["variant"][0], B_FIELD, None, "mixed", field_slots=prog_v.field_slots,
                                    device=dev)
    vals_p, fl_p = ev_v.slot_major(free[0])
    assert int(check_v.verdict_slot_major(vals_p, fl_p)[0]) == 0
    assert check_v.n_mul == VARIANT_MUL_ROWS
    tables["operand_mulcmp"].append(operand_mulcmp_on("variant mixed", check_v.mul.table, vals_p,
                                                      every_fifth_flipped(fl_p), bound))
    x = fl_p[x_row : x_row + 1]  # [1, 16, B], as the evaluator hands it to inv
    be = get_backend(SCALAR)
    assert torch.equal(be.inv(x, 1), fl_p[inv_row : inv_row + 1])
    t_wit = wall_s(lambda: ev_v.slot_major(free[0]), reps)
    t_inv = wall_s(lambda: be.inv(x, 1), reps)
    t_chk = wall_s(lambda: check_v.verdict_slot_major(vals_p, fl_p), reps)
    print(f"[perf] variant per chunk of {B_FIELD}: witness {t_wit:.5f} s (its finv alone {t_inv:.5f} s, "
          f"{INV_LADDER_MULS} mul launches), check {t_chk:.5f} s, on {card}")
    del vals_p, fl_p, x
    for name in ("config1", "variant"):
        perf_step(name, steps[name], free, B_FIELD, built[name][0].num_constraints, card, reps)
    return launches


def limbs_matvec_at(name, zt, cols, F, forms, bound, exact_ints=True, field=SCALAR):
    """limbs_matvec on one bucket, each output form against its plain
    version, and (exact_ints) two live (row, instance) columns against
    Python ints; the library yardstick is torch.matmul in float64 over the
    gathered digits' 32 sums only (exact: every sum is below 2^53). At the
    K = 2,064 bound the reduction's carries wrap 32 bits as the TPU's do,
    so there the plain version alone is the reference."""
    p = field.p
    n_rows, K = cols.shape
    Bm = zt.shape[2]
    xf = fk._gather_digits(zt, cols).double()
    Ff = F.double()
    live = torch.nonzero((cols >= 0).any(1)).flatten().tolist()
    out = None
    for form in forms:
        got = fk.limbs_matvec(zt, cols, F, field, form)
        for r, b in ((live[0], 0), (live[-1], Bm - 1)) if exact_ints else ():
            sums = torch.matmul(Ff[r], xf[r, :, b]).to(torch.int64).tolist()
            exact = sum(int(v) << (8 * d) for d, v in enumerate(sums))
            val = col_int(got[:, r].contiguous(), b)
            assert val % p == exact % p and (form == "semi" or val < p), ("limbs_matvec", name, form, r, b)
        out_rows = 17 if form == "semi" else 16
        n_bytes = gathered_bytes(cols, 16 * Bm * 4) + F.numel() + out_rows * n_rows * Bm * 4
        n_ops = Bm * (int((cols >= 0).sum()) * ENTRY_MULS + len(live) * ROW_REDUCE_MULS)
        r = compare(f"limbs_matvec {form} {name} rows={n_rows} ({len(live)} live) K={K} B={Bm}",
                    lambda: fk.limbs_matvec(zt, cols, F, field, form),
                    lambda: fk.limbs_matvec_plain(zt, cols, F, field, form), bound(n_bytes, n_ops),
                    reps=10, plain_reps=2, library=lambda: torch.matmul(Ff, xf))
        out = out or r
        del got
    del xf, Ff
    torch.cuda.empty_cache()
    return out


def limbs_buckets(label, zt, lcheck, bound, slice_b):
    """limbs_matvec (semi) at every bucket of a fused LimbsCheck on zt
    int32[S_t, 16, B], each against its plain version (run over slices of
    slice_b instances, which bounds its float64 digit planes); the sums
    over the buckets of the times and of the bounds' bytes and products,
    as one table."""
    Bm = zt.shape[2]
    tot = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0}
    for name in "abc":
        for cols, F in lcheck.mats[name]:
            n_rows, K = cols.shape
            n_live = int((cols >= 0).any(1).sum())
            n_bytes = gathered_bytes(cols, 16 * Bm * 4) + F.numel() + 17 * n_rows * Bm * 4
            n_ops = Bm * (int((cols >= 0).sum()) * ENTRY_MULS + n_live * ROW_REDUCE_MULS)
            r = compare(
                f"limbs_matvec semi {label} {name} K={K} rows={n_rows} ({n_live} live) B={Bm}",
                lambda: fk.limbs_matvec(zt, cols, F, SCALAR),
                lambda: torch.cat([fk.limbs_matvec_plain(zt[:, :, s : s + slice_b].contiguous(), cols, F, SCALAR)
                                   for s in range(0, Bm, slice_b)], dim=2),
                bound(n_bytes, n_ops), reps=5, plain_reps=1)
            tot["ms"] += r["ms"]
            tot["plain_ms"] += r["plain_ms"]
            tot["bytes"] += n_bytes
            tot["ops"] += n_ops
    torch.cuda.empty_cache()
    b_ms, b_by = max(bound(tot["bytes"], 0), bound(0, tot["ops"]))
    return {"table": f"{label} buckets", "max_abs_err": 0, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def mul_digits_at(label, n, dev, bound, rng, field=SCALAR, device_timed=True):
    """mul_digits on [16, n]: random canonical operands, the corner pairs
    of 0, 1 and p − 1 in the first 9 columns, then raw a in {p, p + 1,
    2^256 − 1} (config 5's and the limbs checks' gathered z) by b in {0,
    1, p − 1}; those columns against Python ints, the whole against the
    plain version."""
    p = field.p
    rnd = random.Random(SEED + 3)
    av = [0, 1, p - 1] * 3 + [p, p + 1, (1 << 256) - 1] * 3 + [rnd.randrange(p) for _ in range(64)]
    bv = [v for v in (0, 1, p - 1) for _ in range(3)] * 2 + [rnd.randrange(p) for _ in range(64)]
    ops = []
    for vs in (av, bv):
        x = canonical_limbs_np(p, n, rng)
        x[:, : len(vs)] = np.asarray([limbs(v, 16) for v in vs], np.uint32).T
        ops.append(from_numpy_u32(x, dev))
    ma, mb = ops
    got = fk.mul_digits(ma, mb, field)
    for i in range(len(av)):
        assert sum(int(d) << (8 * j) for j, d in enumerate(to_u32(got[:, i]).tolist())) == av[i] * bv[i] % p
    W = word_count(p)
    return compare(
        label, lambda: fk.mul_digits(ma, mb, field), lambda: fk.mul_digits_plain(ma, mb, field),
        bound(mul_bytes(field, n, 32), n * modmul_products(8, W, W)), plain_reps=2,
        device=("mul_digits", n, "limb-major") if device_timed else None)


def reduce_digits_at(label, n, layout, dev, bound, field=SCALAR, device_timed=True):
    """reduce_digits on [32, n] digit sums (digit_sums_at: the corner sums
    first, then random sums below 2^24) in one layout, the corners and
    the last column against Python ints, the whole against the plain
    version."""
    p = field.p
    sums = digit_sums_at(n, p, SEED + n)
    em = from_numpy_u32(sums, dev)
    d = em.t().contiguous() if layout == "limb-major" else em.t()
    got = fk.reduce_digits(d, field)
    check_reduced(got, sums, p, layout)
    return compare(
        f"{label} {layout} N={n}", lambda: fk.reduce_digits(d, field),
        lambda: fk.reduce_digits_plain(d, field), bound((32 + 16) * 4 * n, n * digit_reduce_products(field)),
        plain_reps=2, device=("reduce_digits", n, layout) if device_timed else None)


def limbs_kernels(dev, bound, sha_limbs, config1_fold, tables):
    """limbs_matvec at its paths' real buckets (config 1's a-bucket, semi
    and canonical; the sha256 limbs check's widest a-bucket, semi) on
    random limbs, and at the K = 2,064 bound with every digit and fold
    entry 255 (both forms); mul_digits and reduce_digits at the
    Satisfier's shapes, corner columns first, against their plain
    versions and Python ints; then mulcmp at the limbs paths' shapes
    (config 1's fold rows and the sha256 limbs check; the trivial rows
    take operand_mulcmp, compared in config1_limbs_step)."""
    rng = np.random.default_rng(SEED + 2)
    results = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    for name, check, Bm, forms in (("config1 a-bucket", config1_fold, B_FIELD, ("semi", "canonical")),
                                   ("sha256 widest a-bucket", sha_limbs, B_SHA_LIMBS, ("semi",))):
        cols, F = max(check.mats["a"], key=lambda t: t[0].shape[1])
        zt = torch.randint(0, 1 << 16, (check.S_t, 16, Bm), generator=gen, device=dev, dtype=torch.int32)
        r = limbs_matvec_at(name, zt, cols, F, forms, bound)
        results.setdefault("limbs_matvec", r)  # the line's numbers: config 1's a-bucket, semi
        del zt
    K, n_rows = MAX_FUSED_LIMBS_K, 8
    zt = torch.full((2, 16, B_SHA_LIMBS), 0xFFFF, dtype=torch.int32, device=dev)
    cols = torch.ones((n_rows, K), dtype=torch.int32, device=dev)
    cols[n_rows - 3 :] = -1  # a segment's padding rows
    F = torch.full((n_rows, 32, 32 * K), 255, dtype=torch.uint8, device=dev)
    limbs_matvec_at("all 255", zt, cols, F, ("semi", "canonical"), bound, exact_ints=False)
    del zt, cols, F
    results["mul_digits"] = mul_digits_at(f"mul_digits N={MUL_DIGITS_N}", MUL_DIGITS_N, dev, bound, rng)
    # reduce_digits: limb-major at the Satisfier's N (its layout),
    # element-major (the transposed view the row-chunked evaluator passes)
    # at 2^20
    results["reduce_digits"] = reduce_digits_at("reduce_digits", CHAIN_ROWS_N, "limb-major", dev, bound)
    tables["reduce_digits"].append(reduce_digits_at("reduce_digits", MUL_WIDE_N, "element-major", dev, bound))
    torch.cuda.empty_cache()
    for name, rows, batch in (("config1 limbs fold", CONFIG1_FOLD_ROWS, B_FIELD),
                              (f"sha256 limbs {B_SHA_LIMBS}", SHA256_LIMBS_ROWS, B_SHA_LIMBS)):
        mulcmp_at(name, rows * batch, dev, bound)
    return results


MINROOT_B = 256  # the benchmark's chunk (perfbench/traffic/field_step_1k.json)


def minroot_synth():
    """Nova's MinRoot step circuit at 65,536 iterations over Pallas, as the
    benchmark's configuration builds it (perfbench/configs/minroot-65536.py)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "perfbench", "configs", "minroot-65536.py")
    spec = importlib.util.spec_from_file_location("minroot_config", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build()


def minroot_path(dev, card, bound):
    """MinRoot's product rows at the benchmark's chunk: the evaluator on
    random advice (the squarings hold; each iteration's last row, x^4 ·
    x_{i+1} = x_i + y_i, fails), MixedCheck's verdict and its launches,
    operand_mulcmp against its plain version and its bound, and the eager
    route's time (operands assembled by _Operand.assemble, then mulcmp:
    the check before operand_mulcmp) beside the check's. Returns the
    check's launches and the kernel's table."""
    p = PALLAS_SCALAR.p
    t0 = time.time()
    template, prog = minroot_synth()
    R = template.num_constraints
    check = build_templated_check(template, MINROOT_B, None, "mixed", field_slots=prog.field_slots, device=dev)
    ev = prog.build(device=dev)
    print(f"[synth] minroot: {R} rows, {prog.num_slots} slots, {check.n_mul} product rows; template, program "
          f"and check built in {time.time() - t0:.2f} s")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 21)
    ff = torch.randint(0, 1 << 16, (MINROOT_B, len(prog.free_field_slots), 16), generator=gen, device=dev,
                       dtype=torch.int32)
    ff[..., 15] %= p >> 240  # canonical: below p's top limb
    ff_index = {s: i for i, s in enumerate(prog.free_field_slots)}
    low = ff[:, [ff_index[s] for s in prog.free_slots]]
    fb = (low[..., 0] | (low[..., 1] << 16)).contiguous()
    del low
    vals_p, fl_p = ev.slot_major(fb, ff, free_rows=True)
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    verdict = tuple(int(v) for v in check.verdict_slot_major(vals_p, fl_p))
    counts = fk.launch_counts()
    print(f"[step] minroot chunk of {MINROOT_B} verdict {verdict} launches {counts}")
    assert verdict == (R // 3 * MINROOT_B, 2), verdict
    assert counts["operand_mulcmp"] == 1 and not counts["mulcmp"], counts
    result = operand_mulcmp_on("minroot", check.mul.table, vals_p, fl_p, bound, PALLAS_SCALAR, plain_reps=1)
    torch.cuda.reset_peak_memory_stats()
    t_chk = cuda_ms(lambda: check.verdict_slot_major(vals_p, fl_p), 5)
    peak_chk = torch.cuda.max_memory_allocated() / 2**30
    eager = eager_product_bad(check.mul, vals_p, fl_p, PALLAS_SCALAR)
    assert torch.equal(eager, fk.operand_mulcmp(check.mul.table, fl_p, vals_p, PALLAS_SCALAR)), "eager route"
    del eager
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_eager = cuda_ms(lambda: eager_product_bad(check.mul, vals_p, fl_p, PALLAS_SCALAR), 2)
    peak_eager = torch.cuda.max_memory_allocated() / 2**30
    print(f"[perf] minroot chunk of {MINROOT_B}: check {t_chk:.4f} ms (peak {peak_chk:.2f} GiB), operand_mulcmp "
          f"{result['ms']:.4f} ms, bound {result['bound_ms']:.4f} ms ({result['bound_by']}); the eager route "
          f"{t_eager:.4f} ms (peak {peak_eager:.2f} GiB), on {card}")
    result["eager_ms"] = t_eager
    del vals_p, fl_p, check, ev
    torch.cuda.empty_cache()
    return counts, result


def config1_limbs_step(dev, card, built, bound, tables):
    """Config 1 in the limbs form on the mixed step's free bits, then the
    TemplatedSatisfier probes: a non-bit field element in a bit slot (the
    mutation the mixed form cannot represent) and a flipped limb of a pack
    row's field slot, each found at its instance."""
    p = SCALAR.p
    template, prog = built["config1"]
    R = template.num_constraints
    free_np = np.random.default_rng(5).integers(0, 2, size=(N_CHUNKS, B_FIELD, 128)).astype(np.uint32)
    free = from_numpy_u32(free_np, dev)
    step = build_production_step(prog, template, B_FIELD, device=dev, witness_form="limbs")
    step(free)  # warm-up
    verdict, counts = path_run(step, free)
    print(f"[step] config1 limbs verdict {verdict} launches {counts}")
    assert verdict == (0, 0xFFFFFFFF), verdict
    assert (counts["limbs_matvec"], counts["mulcmp"], counts["operand_mulcmp"], counts["chain"]) == (
        3 * N_CHUNKS, N_CHUNKS, N_CHUNKS, N_CHUNKS), counts

    sat = TemplatedSatisfier(template, B_FIELD, device=dev)
    # the fold rows' mulcmp launches run at the shape compared above; the
    # trivial rows' operand_mulcmp at this chunk's table
    assert (sat.check.n_triv, sat.check.fold.Rtp) == (CONFIG1_TRIVIAL_ROWS, CONFIG1_FOLD_ROWS)
    z = prog.z_template_limbs(*prog.build(device=dev)(free[0]))
    assert sat.is_satisfied(z)
    tables["operand_mulcmp"].append(operand_mulcmp_on("config1 limbs trivial", sat.check.ops.table, None,
                                                      every_fifth_flipped(z.permute(1, 2, 0)), bound))
    slot = prog.free_slots[int(np.random.default_rng(SEED).integers(0, 128))]
    bad = z.clone()
    bad[B_FIELD // 2, slot] = canonical_lm([random.Random(SEED).randrange(p)], dev)[:, 0]
    name = sat.which_is_unsatisfied(bad)
    assert name.startswith(f"instance {B_FIELD // 2}: "), name
    pack = sorted(prog.field_rows, key=prog.field_rows.get)[0]  # the first pack output
    flip = z.clone()
    flip[B_FIELD // 4, pack, 2] ^= 1
    name2 = sat.which_is_unsatisfied(flip)
    assert name2.startswith(f"instance {B_FIELD // 4}: "), name2
    print(f"[probe] config1 limbs: a random field element in bit slot {slot} at instance "
          f"{B_FIELD // 2} found ({name}); a flipped limb of pack slot {pack} found ({name2})")
    del z, bad, flip, sat
    perf_step("config1 limbs", step, free, B_FIELD, R, card, 5)
    return counts


def sha256_limbs_step(dev, card, bound, template, prog):
    """The sha256 compression in the limbs form (the fused route, 17 ELL
    buckets) at 4 × 1,024; chunk 0's verdict against the packed check on
    the same instances, clean and with one intermediate bit flipped; a
    non-bit value in a message-bit slot found at its instance. Then the step at the batches
    of B_SHA_LIMBS_BIG in turn while the peak extrapolated from the runs
    before stays under PEAK_GIB: each one's verdict, time and peak."""
    p = SCALAR.p
    R = template.num_constraints
    Bl = B_SHA_LIMBS
    rng = np.random.default_rng(SEED + 4)
    free_np = rng.integers(0, 2, size=(N_CHUNKS, Bl, 512)).astype(np.uint32)
    free = from_numpy_u32(free_np, dev)
    t0 = time.time()
    step = build_production_step(prog, template, Bl, device=dev, witness_form="limbs")
    print(f"[step] sha256 limbs built in {time.time() - t0:.2f} s (fold tables included)")
    step(free)  # warm-up
    verdict, counts = path_run(step, free)
    print(f"[step] sha256 limbs verdict {verdict} launches {counts}")
    assert verdict == (0, 0xFFFFFFFF), verdict
    assert counts["limbs_matvec"] == 17 * N_CHUNKS and counts["mulcmp"] == N_CHUNKS, counts

    check = build_templated_check(template, Bl, None, "limbs", device=dev)
    assert check.Rtp == SHA256_LIMBS_ROWS, check.Rtp  # mulcmp's shape, compared above
    packed = build_templated_check(template, Bl, None, "bits_packed", device=dev)
    z = prog.z_template_limbs(*prog.build(device=dev)(free[0]))
    words = prog.build_packed(device=dev)(pack_bits(free[0]))
    slot, inst = 9000, Bl // 3  # an intermediate slot: its bit flipped in both forms
    zf, wf = z.clone(), words.clone()
    zf[inst, slot, 0] ^= 1
    wf[inst // 32, slot] ^= 1 << (inst % 32)
    for zz, ww in ((z, words), (zf, wf)):
        got = tuple(int(v) for v in check.verdict(zz))
        want = tuple(int(v) for v in packed.verdict(ww))
        assert got == want, (got, want)
    assert got[0] > 0 and got[1] // R == inst, got
    bad = z.clone()
    msg = prog.free_slots[100]
    bad[Bl // 2, msg] = canonical_lm([random.Random(SEED + 1).randrange(p)], dev)[:, 0]
    nb, first = (int(v) for v in check.verdict(bad))
    assert nb > 0 and first // R == Bl // 2, (nb, first)
    print(f"[probe] sha256 limbs chunk 0 equals the packed check clean and with slot {slot} flipped at "
          f"instance {inst} ({got}); a random field element in message bit {msg} at instance {Bl // 2} "
          f"found: n_bad {nb}, first row {first % R}")
    del check, packed, z, words, zf, wf, bad
    torch.cuda.empty_cache()
    peak = perf_step("sha256 limbs", step, free, Bl, R, card, 3)
    assert peak < PEAK_GIB, f"peak memory {peak:.2f} GiB"
    del step, free
    torch.cuda.empty_cache()

    # the larger batches in turn while the peak, extrapolated from the
    # runs so far (linearly from one, along the last two after), stays
    # under PEAK_GIB
    peaks = [(Bl, peak)]
    for Bb in B_SHA_LIMBS_BIG:
        (b1, p1), (b2, p2) = peaks[-2] if len(peaks) > 1 else (0, 0.0), peaks[-1]
        est = p2 + (p2 - p1) / (b2 - b1) * (Bb - b2)
        if est >= PEAK_GIB:
            print(f"[perf] sha256 limbs at {Bb}: peak estimated {est:.2f} GiB, not run")
            break
        free = from_numpy_u32(rng.integers(0, 2, size=(N_CHUNKS, Bb, 512)).astype(np.uint32), dev)
        step = build_production_step(prog, template, Bb, device=dev, witness_form="limbs")
        step(free)  # warm-up
        verdict, big_counts = path_run(step, free)
        print(f"[step] sha256 limbs at {N_CHUNKS}x{Bb} verdict {verdict} launches {big_counts}")
        assert verdict == (0, 0xFFFFFFFF), verdict
        peaks.append((Bb, perf_step(f"sha256 limbs {Bb}", step, free, Bb, R, card, 2)))
        assert peaks[-1][1] < PEAK_GIB, f"peak memory {peaks[-1][1]:.2f} GiB at {Bb} (estimated {est:.2f})"
        del step, free
        torch.cuda.empty_cache()
        mulcmp_at(f"sha256 limbs {Bb}", SHA256_LIMBS_ROWS * Bb, dev, bound)  # the N this batch launched
    return counts


def op_rate_probe(bound):
    """The op-rate probe on the card: per class, the kernel against its
    plain version (integer classes bit-exact at PROBE_K rounds, f32 ones
    within a relative 10^-5 at 4 rounds, where they stay finite) and its
    rate, R·K·N rounds over the kernel's time."""
    rng = np.random.default_rng(SEED + 6)
    x_np = rng.integers(1, 100, size=(PROBE_R, PROBE_N)).astype(np.int32)
    rates = {}
    for op in op_rate.OPS:
        flt = op in op_rate.FLOAT_OPS
        x = torch.from_numpy(x_np).to(DEVICE)
        if flt:
            x = x.float()
            got = op_rate.op_rate(x, op, 4)
            torch.testing.assert_close(got, op_rate.op_rate_plain(x, op, 4), rtol=1e-5, atol=0)
            err = 0.0
        else:
            err = max_abs_err(op_rate.op_rate(x, op, PROBE_K), op_rate.op_rate_plain(x, op, PROBE_K))
            assert err == 0, f"op_rate {op} disagrees with its plain version"
        ms = cuda_ms(lambda: op_rate.op_rate(x, op, PROBE_K), 10)
        plain_ms = cuda_ms(lambda: op_rate.op_rate_plain(x, op, PROBE_K), 1)
        rounds = PROBE_R * PROBE_K * PROBE_N
        # rounds a clock an SM: 128 f32 lanes; 16 conversions, two a round;
        # the 64 integer lanes of `bound` for the rest
        lanes = {"f32_mul": 128, "f32_fma": 128, "cvt_u32_f32": 8}.get(op, 64)
        b_ms, b_by = bound(4 * (PROBE_R + 1) * PROBE_N, rounds * 64 / lanes)
        rates[op] = {"gops": rounds / ms / 1e6, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "max_abs_err": err}
        del x
    print(f"[probe] op-rate R={PROBE_R} K={PROBE_K} N={PROBE_N}: " + ", ".join(
        f"{op} {v['gops']:.1f} G op/s" for op, v in rates.items()))
    print("[probe] op-rate detail " + json.dumps(rates))


def python_int_first_bad(template, z_limbs, slot):
    """The least row referencing `slot` that fails A·z · B·z = C·z over the
    Python ints (z_limbs: int64[S, 16] limbs), and how many rows reference
    it."""
    p = template.field.p
    rows = sorted({int(r) for m in "abc" for r in np.asarray(getattr(template, m).rows)[
        np.asarray(getattr(template, m).cols) == slot]})
    sums = {}
    for m in "abc":
        mat = getattr(template, m)
        sel = np.isin(np.asarray(mat.rows), rows)
        s = dict.fromkeys(rows, 0)
        for r, c, cid in zip(np.asarray(mat.rows)[sel], np.asarray(mat.cols)[sel], np.asarray(mat.coeff_ids)[sel]):
            s[int(r)] = (s[int(r)] + int(template.coeff_table[cid]) * limb_int(z_limbs[int(c)])) % p
        sums[m] = s
    bad = [r for r in rows if (sums["a"][r] * sums["b"][r] - sums["c"][r]) % p]
    return (bad[0] if bad else None), len(rows)


@functools.cache
def satisfier_chain_synth(field=SCALAR):
    """The 16-block sha256 chain's template and program (NativeBuilder),
    built once a field."""
    nb = NativeBuilder(field)
    state = nb.sha256_iv()
    for _ in range(CHAIN_BLOCKS):
        state = nb.sha256_compression([nb.alloc_bit() for _ in range(512)], state)
    template, tape = nb.finish()
    return template, WitnessProgram(tape)


def satisfier_chain_witness(template, prog, dev):
    """Instance 0 of the chain's evaluator as limbs z, and z with one bit
    slot of block 9 set to a random field element: (z, bad, slot, block,
    the least row on the slot that fails over the Python ints, the rows on
    the slot)."""
    free = from_numpy_u32(np.random.default_rng(SEED + 5).integers(0, 2, size=(1, 512 * CHAIN_BLOCKS))
                          .astype(np.uint32), dev)
    z = prog.z_template_limbs(*prog.build(device=dev)(free))[0]
    block = min(9, CHAIN_BLOCKS - 1)
    slot = prog.free_slots[512 * block + int(np.random.default_rng(SEED).integers(0, 512))]
    bad = z.clone()
    bad[slot] = canonical_lm([random.Random(SEED + 2).randrange(template.field.p)], dev)[:, 0]
    row, n_ref = python_int_first_bad(template, to_u32(bad).cpu().numpy(), slot)
    assert row is not None
    return z, bad, slot, block, row, n_ref


def satisfier_chain(dev, card):
    """The Satisfier of a 16-block sha256 chain at batch 1 (the non-fused
    limbs route): z from instance 0 of the chain's evaluator, satisfied;
    then one bit slot of block 9 set to a random field element and named
    as the Python-int evaluation names it."""
    t0 = time.time()
    template, prog = satisfier_chain_synth()
    R, S = template.num_constraints, prog.num_slots
    sat = Satisfier(template, device=dev)
    if CHAIN_BLOCKS == 16:  # reduce_digits' and mul's N, compared above
        assert (R, S, sat._check.Rtp) == (426912, 426497, CHAIN_ROWS_N), (R, S, sat._check.Rtp)
    print(f"[synth] sha256 chain of {CHAIN_BLOCKS}: {R} rows, {S} slots; Satisfier built in "
          f"{time.time() - t0:.2f} s (native build included)")
    z, bad, slot, block, row, n_ref = satisfier_chain_witness(template, prog, dev)
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    ok = sat.is_satisfied(z)
    counts = fk.launch_counts()
    print(f"[step] satisfier chain is_satisfied {ok} launches {counts}")
    assert ok and (counts["mul_digits"], counts["reduce_digits"], counts["mul"]) == (3, 3, 1), counts
    name = sat.which_is_unsatisfied(bad)
    assert name == f"constraint #{row}", (name, row)
    print(f"[probe] satisfier chain: bit slot {slot} of block {block} set to a random field element; "
          f"which_is_unsatisfied names {name!r}, the least of the {n_ref} rows on the slot that fails "
          f"over the Python ints")
    t_chk = wall_s(lambda: sat.is_satisfied(z), 3)
    print(f"[perf] satisfier chain check {t_chk:.4f} s for {R} rows, on {card}")
    return counts


def config2_circuit():
    """Config 2 (benchmarks/configs_1_2_3.py:162-206) through NativeBuilder:
    8 allocated u32 words, then 7 × (xor with rotr(5i), addmany with
    shr(3)) under one MultiEq; rotr and shr are index shifts, shr filled
    with constant(False)."""
    nb = NativeBuilder()
    ops = [nb.alloc_u32() for _ in range(8)]
    nb.multieq_begin()
    x = ops[0]
    for i in range(1, 8):
        x = [nb.xor(a, ops[i][(k + 5 * i) % 32]) for k, a in enumerate(x)]
        x = nb.addmany([x, ops[i - 1][3:] + [nb.constant(False)] * 3])
    nb.multieq_end()
    return nb.finish()


def config3_circuit():
    """Config 3 (benchmarks/configs_1_2_3.py:209-258): 4 allocated u32
    words, 3 addmany under one MultiEq, then pack_bits of the sum's 32
    bits into one field element."""
    nb = NativeBuilder()
    words = [nb.alloc_u32() for _ in range(4)]
    nb.multieq_begin()
    acc = words[0]
    for w in words[1:]:
        acc = nb.addmany([acc, w])
    nb.multieq_end()
    nb.pack_bits(acc)
    return nb.finish()


def blake2s_circuit():
    """One blake2s compression of free h (256) and m (512) bits, t = 64,
    f = True (the JAX package's tests/test_native_synthesis.py:102-140)."""
    nb = NativeBuilder()
    h = [nb.alloc_bit() for _ in range(256)]
    nb.blake2s_compression(h, [nb.alloc_bit() for _ in range(512)], 64, True)
    return nb.finish()


def bit_synth():
    """Configs 2 and 3 and blake2s through NativeBuilder's bit gadgets."""
    built = {}
    for name, make, want in (("config2", config2_circuit, (712, 712, 256)),
                             ("config3", config3_circuit, (229, 229, 128)),
                             ("blake2s", blake2s_circuit, (22158, 22113, 768))):
        t0 = time.time()
        template, tape = make()
        prog = WitnessProgram(tape)
        got = (template.num_constraints, prog.num_slots, len(prog.free_slots))
        assert got == want, (name, got)
        print(f"[synth] {name}: {got[0]} rows, {got[1]} slots, {got[2]} free bits, {len(prog.stages)} stages "
              f"(packable {prog.is_packable}, mixed packable {prog.is_packable_mixed}) in {time.time() - t0:.2f} s")
        built[name] = (template, prog)
    return built


def packed_bit_step(dev, card, bound, name, template, prog, seed, tables, same_as=None):
    """Config 2, config 3 (the mixed packed layout) or blake2s on
    build_packed_production_step at N_CHUNKS × B with random free words:
    the clean verdict and the path's launches; chunk 0 equal to the CPU
    evaluator on 16 words (and, with `same_as`, to that program's words on
    the card); planted corruptions found at their instance and at the row
    the CPU check names for that word's 32 instances alone; with `tables`,
    the kernels at the path's own tables (on chunk 0's words with random
    odd words, so both verdicts occur); the step's time, rate and peak."""
    R = template.num_constraints
    Bw = B // 32
    mixed = not prog.is_packable
    free_np = np.random.default_rng(seed).integers(
        0, 1 << 32, size=(N_CHUNKS, Bw, len(prog.free_slots)), dtype=np.uint64).astype(np.uint32)
    free = from_numpy_u32(free_np, dev)
    t0 = time.time()
    step = build_packed_production_step(prog, template, B, device=dev)
    print(f"[step] {name} built in {time.time() - t0:.2f} s")
    step(free)  # warm-up
    verdict, counts = path_run(step, free)
    print(f"[step] {name} verdict {verdict} launches {counts}")
    assert verdict == (0, 0xFFFFFFFF), verdict

    field_slots = sorted(prog.field_rows, key=prog.field_rows.get) if mixed else None
    check = build_templated_check(template, B, None, "bits_packed", field_slots=field_slots, device=dev)
    cpu_check = build_templated_check(template, 32, None, "bits_packed", field_slots=field_slots, device="cpu")
    if mixed:
        vals0, fl0 = prog.build_packed_mixed(device=dev)(free[0])
        cpu_vals, cpu_fl = prog.build_packed_mixed(device="cpu")(torch.from_numpy(free_np[0, :16].view(np.int32)))
        assert torch.equal(fl0[: 16 * 32].cpu(), cpu_fl), f"{name} chunk-0 limbs differ from the CPU evaluator"
    else:
        vals0, fl0 = prog.build_packed(device=dev)(free[0]), None
        cpu_vals = prog.build_packed(device="cpu")(torch.from_numpy(free_np[0, :16].view(np.int32)))
    assert torch.equal(vals0[:16].cpu(), cpu_vals), f"{name} chunk-0 words differ from the CPU evaluator"
    if same_as is not None:
        other = (same_as.build_packed_mixed(device=dev)(free[0]) if mixed
                 else (same_as.build_packed(device=dev)(free[0]), None))
        assert torch.equal(vals0, other[0]) and (fl0 is None or torch.equal(fl0, other[1])), \
            f"{name} chunk 0 differs from the other program"
    assert tuple(int(v) for v in check.verdict(vals0, fl0)) == (0, 0xFFFFFFFF)

    def probe(what, word, bit, slot=None, limb=None):
        """Flip bit `bit` of packed word (word, slot), or bit limb[1] of
        limb limb[0] of instance 32·word + bit's first field row."""
        v, f = vals0.clone(), None if fl0 is None else fl0.clone()
        inst = 32 * word + bit
        if limb is None:
            v[word, slot] ^= 1 << bit
        else:
            f[inst, 0, limb[0]] ^= 1 << limb[1]
        nbad, first = (int(x) for x in check.verdict(v, f))
        cnb, cfirst = (int(x) for x in cpu_check.verdict(
            v[word : word + 1].cpu(), None if f is None else f[32 * word : 32 * word + 32].cpu()))
        assert nbad > 0 and first // R == inst and cfirst // R == bit and first % R == cfirst % R, \
            (name, what, nbad, first, cfirst)
        print(f"[probe] {name}: {what} at instance {inst} found: n_bad {nbad}, row {first % R} "
              f"(the CPU check of its word: n_bad {cnb}, row {cfirst % R})")
        return first % R

    probe(f"a flipped bit of slot {prog.num_slots // 2}", Bw // 2, 7, slot=prog.num_slots // 2)
    if mixed:
        row = probe("a flipped bit (limb 1, bit 4) of the pack output", Bw // 3, 11, limb=(1, 4))
        assert row == int(check.pf_rows[0]), row  # the multipack row
        probe(f"a flipped addend bit (free slot {prog.free_slots[40]})", 5, 30, slot=prog.free_slots[40])
    same = " and, all of it, NativeBuilder's program's" if same_as is not None else ""
    print(f"[probe] {name} chunk-0 words match the CPU evaluator on 16 words{same}"
          f"{' (limbs too)' if mixed else ''}; the chunk's verdict is clean")

    if tables is not None:
        vals_p = vals0.t().contiguous()
        rng = np.random.default_rng(seed + 1)
        vals_p[:, 1::2] = from_numpy_u32(rng.integers(0, 1 << 32, size=(vals_p.shape[0], Bw // 2),
                                                      dtype=np.uint64).astype(np.uint32), dev)
        inner = check.inner if mixed else check
        if inner.pow2_spec is not None:
            tables["bitplane_eq"].append(bitplane_at(name, vals_p, inner.pow2_spec, inner.plane_idx, bound))
        if inner.big is not None:
            tables["bits_matvec_semi"].append(semi_buckets(name, vals_p, inner.big, bound, library=False,
                                                           slice_words=256))
            tables["mulcmp"].append(mulcmp_at(f"{name} packed", inner.big.Rtp * B, dev, bound))
        del vals_p
    del vals0, fl0, check, cpu_check
    torch.cuda.empty_cache()
    perf_step(name, step, free, B, R, card, 5)
    return counts


def sha256_bits_step(dev, card, bound, template, prog, tables):
    """The sha256 compression in the bits form, the default of
    build_production_step for a pure-bit program, at N_CHUNKS ×
    B_SHA_BITS: the clean verdict and launches; chunk 0's mask and verdict
    equal to the packed check's on the same instances, clean and with one
    intermediate bit flipped (found at its instance). Then the step at the
    batches of B_SHA_BITS_BIG in turn while the peak extrapolated from the
    runs before stays under PEAK_GIB: each one's verdict, time and peak.
    At every batch its kernels against their plain versions at the shapes
    it launches them at (bits_kernels_at on chunk 0's witness)."""
    R = template.num_constraints
    Bb = B_SHA_BITS
    rng = np.random.default_rng(SEED + 7)

    free = from_numpy_u32(rng.integers(0, 2, size=(N_CHUNKS, Bb, 512)).astype(np.uint32), dev)
    t0 = time.time()
    step = build_production_step(prog, template, Bb, device=dev)
    print(f"[step] sha256 bits built in {time.time() - t0:.2f} s")
    step(free)  # warm-up
    verdict, counts = path_run(step, free)
    print(f"[step] sha256 bits verdict {verdict} launches {counts}")
    assert verdict == (0, 0xFFFFFFFF), verdict
    assert (counts["bitplane_eq"], counts["bits_matvec_semi"], counts["mulcmp"]) == (
        N_CHUNKS, 3 * N_CHUNKS, N_CHUNKS), counts

    bits = build_templated_check(template, Bb, None, "bits", device=dev)
    packed = build_templated_check(template, Bb, None, "bits_packed", device=dev)
    vals, _ = prog.build(device=dev)(free[0])
    words = pack_bits(vals)
    slot, inst = 9000, Bb // 3
    vf, wf = vals.clone(), words.clone()
    vf[inst, slot] ^= 1
    wf[inst // 32, slot] ^= 1 << (inst % 32)
    for v, w in ((vals, words), (vf, wf)):
        assert torch.equal(bits(v), packed(w)), "the bits mask differs from the packed check's"
        got = tuple(int(x) for x in bits.verdict(v))
        assert got == tuple(int(x) for x in packed.verdict(w)), got
    assert got[0] > 0 and got[1] // R == inst, got
    print(f"[probe] sha256 bits chunk 0: mask and verdict equal the packed check's, clean and with slot "
          f"{slot} flipped at instance {inst} ({got})")
    del bits, packed, words, vf, wf
    bits_kernels_at(f"sha256 bits {Bb}", template, vals, dev, bound, tables, SEED + Bb)
    del vals
    peaks = [(Bb, perf_step("sha256 bits", step, free, Bb, R, card, 3))]
    del step, free
    torch.cuda.empty_cache()
    for Bn in B_SHA_BITS_BIG:
        (b1, p1), (b2, p2) = peaks[-2] if len(peaks) > 1 else (0, 0.0), peaks[-1]
        est = p2 + (p2 - p1) / (b2 - b1) * (Bn - b2)
        if est >= PEAK_GIB:
            print(f"[perf] sha256 bits at {Bn}: peak estimated {est:.2f} GiB, not run")
            break
        free = from_numpy_u32(rng.integers(0, 2, size=(N_CHUNKS, Bn, 512)).astype(np.uint32), dev)
        step = build_production_step(prog, template, Bn, device=dev)
        step(free)  # warm-up
        verdict, big_counts = path_run(step, free)
        print(f"[step] sha256 bits at {N_CHUNKS}x{Bn} verdict {verdict} launches {big_counts}")
        assert verdict == (0, 0xFFFFFFFF), verdict
        peaks.append((Bn, perf_step(f"sha256 bits {Bn}", step, free, Bn, R, card, 2)))
        assert peaks[-1][1] < PEAK_GIB, f"peak memory {peaks[-1][1]:.2f} GiB at {Bn} (estimated {est:.2f})"
        bits_kernels_at(f"sha256 bits {Bn}", template, prog.build(device=dev)(free[0])[0], dev, bound, tables,
                        SEED + Bn)
        del step, free
        torch.cuda.empty_cache()
    return counts


# --- the chained and Merkle pipelines (configs 4 and 4b), the num family ----------
_K256 = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
SHA256_IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]


def sha256_compress(h, w16):
    """The oracle: one sha256 compression (FIPS 180-4) of 16 message
    words into the 8-word state h, in Python ints."""
    rotr = lambda x, n: ((x >> n) | (x << (32 - n))) & 0xFFFFFFFF  # noqa: E731
    w = list(w16)
    for t in range(16, 64):
        s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & 0xFFFFFFFF)
    a, b, c, d, e, f, g, hh = h
    for t in range(64):
        t1 = (hh + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g)) + _K256[t] + w[t]) & 0xFFFFFFFF
        t2 = ((rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c))) & 0xFFFFFFFF
        a, b, c, d, e, f, g, hh = (t1 + t2) & 0xFFFFFFFF, a, b, c, (d + t1) & 0xFFFFFFFF, e, f, g
    return [(x + y) & 0xFFFFFFFF for x, y in zip(h, (a, b, c, d, e, f, g, hh))]


def msg_words(bits):
    """512 message bits, big-endian within each word (the gadget's order)
    → 16 words."""
    return [sum(int(bits[32 * w + t]) << (31 - t) for t in range(32)) for w in range(16)]


def state_words(bits):
    """256 state bits, 8 words × 32 LSB first → 8 words."""
    return [sum(int(bits[32 * w + i]) << i for i in range(32)) for w in range(8)]


def oracle_chain(msgs_np, b):
    """Chain b of msgs int[T, B, 512] from the sha256 IV → its final
    state words."""
    h = SHA256_IV
    for t in range(msgs_np.shape[0]):
        h = sha256_compress(h, msg_words(msgs_np[t, b]))
    return h


def chain_synth():
    """The chain-step template (a compression whose IV is 256 free bits
    before the 512 message bits) and the Merkle template (512 free message
    bits under the constant IV), with their digest views, and the IV's
    256 bits from NativeBuilder.sha256_iv()."""
    t0 = time.time()
    built = {}
    for name, free_iv, want in (("chain", True, (26960, 26935)), ("merkle", False, (26352, 26327))):
        nb = NativeBuilder()
        state = [nb.alloc_bit() for _ in range(256)] if free_iv else nb.sha256_iv()
        out = nb.sha256_compression([nb.alloc_bit() for _ in range(512)], state)
        template, tape = nb.finish()
        prog = WitnessProgram(tape)
        got = (template.num_constraints, prog.num_slots)
        assert got == want and prog.is_pure_bits, (name, got)
        built[name] = (template, prog, [nb.view(v) for v in out])
        print(f"[synth] {name} template: {got[0]} rows, {got[1]} slots, {len(prog.free_slots)} free bits, "
              f"{len(prog.stages)} stages")
    nb = NativeBuilder()
    iv = np.asarray([nb.view(v)[1] for v in nb.sha256_iv()], np.uint32)
    assert state_words(iv) == SHA256_IV
    print(f"[synth] chain and Merkle templates in {time.time() - t0:.2f} s")
    return built, iv


def eager_chain(gen, init_state, msgs):
    """The chain as an eager block-by-block loop of gen's own evaluator
    and carry extraction (no graph)."""
    free = torch.empty((msgs.shape[1], gen.n_free), dtype=torch.int32, device=msgs.device)
    free[:, : gen.n_carry] = init_state
    vals = []
    for m in msgs:
        free[:, gen.n_carry :] = m
        vals.append(gen.block(free).t().clone())
    return torch.stack(vals), free[:, : gen.n_carry].clone()


def timed(fn):
    """(fn()'s result, host seconds around it ending in a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def bits_kernels_at(label, template, vals_bm, dev, bound, tables, seed):
    """bitplane_eq, and where the template has a big row
    bits_matvec_semi and mulcmp, at the bits check of vals_bm int32[B, S]'s
    batch, on its words as BitsCheck packs them (Bw = ceil(B/32) words an
    instance row, lanes past B zero). So that both verdicts occur, the odd
    words are random, or where Bw is 1 the word's upper 16 lanes (padding
    lanes where B ≤ 16: the kernels read them all the same)."""
    Bn = vals_bm.shape[0]
    check = build_templated_check(template, Bn, None, "bits", device=dev)
    packed, words = check.packed, pack_rows(vals_bm.t(), check.Bw)
    S_w, Bw = words.shape
    rnd = np.random.default_rng(seed).integers(0, 1 << 32, size=(S_w, max(Bw // 2, 1)), dtype=np.uint64)
    if Bw > 1:
        words[:, 1::2] = from_numpy_u32(rnd.astype(np.uint32), dev)
    else:
        words = (words & 0xFFFF) | from_numpy_u32((rnd & 0xFFFF0000).astype(np.uint32), dev)
    tables["bitplane_eq"].append(bitplane_at(label, words, packed.pow2_spec, packed.plane_idx, bound))
    if packed.big is not None:
        tables["bits_matvec_semi"].append(semi_buckets(label, words, packed.big, bound, library=False))
        tables["mulcmp"].append(mulcmp_at(label, packed.big.Rtp * packed.batch, dev, bound))
    del words, packed, check
    torch.cuda.empty_cache()


def chained_paths(dev, card, bound, tables, built, iv_np):
    """The chained pipeline: the hashlib digest of a two-block message;
    the graph-replayed chain against an eager loop (T 8, B 4); config 4 (T
    CHAIN_T, B 1: the final state against the oracle, a planted fault at
    block 700 found at its instance and at the row the CPU check names,
    PipelinedSatisfier on the same witness) and config 4b (B 8 and 64:
    chains 0 and B − 1 against the oracle), each with its time, rate,
    replay time a block and peak. Returns the config-4 step's launches."""
    template, prog, views = built["chain"]
    R, S = template.num_constraints, prog.num_slots
    iv = torch.from_numpy(iv_np.view(np.int32)).to(dev)

    m = bytes(range(64))
    padded = m + b"\x80" + b"\x00" * 61 + (512).to_bytes(2, "big")
    blocks = [[[(byte >> (7 - i)) & 1 for byte in padded[k : k + 64] for i in range(8)]] for k in (0, 64)]
    step = build_chained_production_step(prog, template, views, check_batch=2, device=dev)
    total, first, final = step(iv[None], torch.tensor(blocks, dtype=torch.int32, device=dev))
    digest = b"".join(w.to_bytes(4, "big") for w in state_words(final[0].tolist()))
    assert (int(total), int(first)) == (0, 0xFFFFFFFF) and digest == hashlib.sha256(m).digest(), digest.hex()
    print(f"[probe] chained: sha256 of a 64-byte message as two chained blocks = {digest.hex()} (hashlib's), "
          f"verdict {(int(total), int(first))}")

    gen = build_chained_witness(prog, views, device=dev)
    rng = np.random.default_rng(SEED + 11)
    iv4 = from_numpy_u32(rng.integers(0, 2, size=(4, 256)).astype(np.uint32), dev)
    msgs8 = from_numpy_u32(rng.integers(0, 2, size=(8, 4, 512)).astype(np.uint32), dev)
    got, want = gen(iv4, msgs8), eager_chain(gen, iv4, msgs8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), "the graph differs from the eager loop"
    print("[probe] chained: the graph-replayed vals and final state at T 8, B 4 equal an eager loop of the "
          "same evaluator, bit for bit")
    del gen, got, want

    rng = np.random.default_rng(CHAIN_SEED)
    msgs_np = rng.integers(0, 2, size=(CHAIN_T, 1, 512)).astype(np.uint32)
    msgs = from_numpy_u32(msgs_np, dev)
    step = build_chained_production_step(prog, template, views, check_batch=CHAIN_CHECK_BATCH, device=dev)
    step.gen(iv[None], msgs[:1])  # captures the block's graph at B = 1
    torch.cuda.reset_peak_memory_stats()
    (verdict, counts), t_step = timed(lambda: path_run(lambda *a: step(*a)[:2], iv[None], msgs))
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[step] chained (config 4) verdict {verdict} launches {counts}")
    assert verdict == (0, 0xFFFFFFFF), verdict
    assert counts["bitplane_eq"] == CHAIN_T // CHAIN_CHECK_BATCH, counts
    (vals, final), t_gen = timed(lambda: step.gen(iv[None], msgs))
    check_v, t_check = timed(lambda: tuple(int(x) for x in step.verdict(vals)))
    assert check_v == (0, 0xFFFFFFFF), check_v
    assert state_words(final[0].tolist()) == oracle_chain(msgs_np, 0), "config 4's final state"
    graph = step.gen.graphs[1]
    replay_ms = cuda_ms(graph.graph.replay, 20)
    print(f"[perf] chained (config 4) step {t_step:.4f} s for {CHAIN_T} blocks x 1 chain = "
          f"{CHAIN_T * R / t_step:.4e} constraint-evals/s (witness {t_gen:.4f} s, check {t_check:.4f} s = "
          f"{t_check / (t_gen + t_check):.1%}), replay {replay_ms:.4f} ms a block, peak {peak:.2f} GiB, on {card}")
    print(f"[probe] chained (config 4): the final state equals the Python oracle after {CHAIN_T} compressions")

    blk, slot = CHAIN_FLIP_BLOCK, S - 5
    bad = vals.clone()
    bad[blk, 0, slot] ^= 1
    z4 = bad.reshape(CHAIN_T // CHAIN_CHECK_BATCH, CHAIN_CHECK_BATCH, S)
    nbad, fbad = (int(x) for x in build_chunked_check(template, CHAIN_CHECK_BATCH, z4.shape[0], device=dev,
                                                       witness_form="bits")(z4))
    cpu_n, cpu_first = (int(x) for x in build_templated_check(template, 1, None, "bits", device="cpu")
                        .verdict(bad[blk].cpu()))
    name = which_from_flat(template, fbad)
    assert nbad > 0 and name == f"instance {blk}: constraint #{cpu_first}", (nbad, name, cpu_first)
    print(f"[probe] chained (config 4): bit slot {slot} of block {blk} flipped: n_bad {nbad}, which_from_flat "
          f"{name!r} (the CPU check of that instance: n_bad {cpu_n}, row {cpu_first})")
    sat = PipelinedSatisfier(template, CHAIN_CHECK_BATCH, z4.shape[0], device=dev, witness_form="bits")
    assert sat.is_satisfied(vals.reshape(z4.shape))
    which = sat.which_is_unsatisfied(z4)
    assert which == f"chunk 1: instance {blk - CHAIN_CHECK_BATCH}: constraint #{cpu_first}", which
    print(f"[probe] PipelinedSatisfier on the config-4 witness: satisfied; after the flip {which!r}")
    bits_kernels_at("chained 512", template, vals[:CHAIN_CHECK_BATCH, 0], dev, bound, tables, SEED + 12)
    del vals, bad, z4, sat, graph

    for Bc in CHAIN_MULTI_B:
        msgs_np = rng.integers(0, 2, size=(CHAIN_T, Bc, 512)).astype(np.uint32)
        msgs = from_numpy_u32(msgs_np, dev)
        iv_b = iv[None].expand(Bc, 256).contiguous()
        step.gen(iv_b, msgs[:1])  # captures the block's graph at B = Bc
        torch.cuda.reset_peak_memory_stats()
        (vals, final), t_gen = timed(lambda: step.gen(iv_b, msgs))
        verdict, t_check = timed(lambda: tuple(int(x) for x in step.verdict(vals)))
        peak = torch.cuda.max_memory_allocated() / 2**30
        assert verdict == (0, 0xFFFFFFFF), (Bc, verdict)
        for b in (0, Bc - 1):
            assert state_words(final[b].tolist()) == oracle_chain(msgs_np, b), f"config 4b chain {b} of {Bc}"
        replay_ms = cuda_ms(step.gen.graphs[Bc].graph.replay, 20)
        t_step = t_gen + t_check
        print(f"[perf] chained (config 4b) step {t_step:.4f} s for {CHAIN_T} blocks x {Bc} chains = "
              f"{CHAIN_T * Bc * R / t_step:.4e} constraint-evals/s (witness {t_gen:.4f} s, check "
              f"{t_check:.4f} s = {t_check / t_step:.1%}), replay {replay_ms:.4f} ms a block, peak {peak:.2f} GiB, "
              f"on {card}")
        print(f"[probe] chained (config 4b, {Bc} chains): verdict {verdict}; chains 0 and {Bc - 1} equal the oracle")
        del vals, final, msgs
        torch.cuda.empty_cache()
    curve = {}
    for Bc in CHAIN_CURVE_B:  # the witness's chains-versus-throughput curve, one block's replay each
        gen = build_chained_witness(prog, views, device=dev)
        gen(iv[None].expand(Bc, 256).contiguous(), torch.zeros((1, Bc, 512), dtype=torch.int32, device=dev))
        curve[Bc] = cuda_ms(gen.graphs[Bc].graph.replay, 10)
        del gen
        torch.cuda.empty_cache()
    print("[perf] chained replay curve, ms a block (blocks x chains / s): " + ", ".join(
        f"{Bc} chains {ms:.4f} ({Bc / ms * 1e3:.4e})" for Bc, ms in curve.items()) + f", on {card}")
    return counts


def merkle_path(dev, card, bound, tables, built):
    """The Merkle tree over MERKLE_LEAVES random leaf digests: the root
    against the oracle's tree, a clean total, the step's time; the kernels
    at every level's tables (batches MERKLE_LEAVES/2 down to 1), on that
    level's witness. Returns the step's launches."""
    template, prog, views = built["merkle"]
    leaves_np = np.random.default_rng(SEED + 13).integers(0, 2, size=(MERKLE_LEAVES, 256)).astype(np.uint32)
    leaves = from_numpy_u32(leaves_np, dev)
    t0 = time.time()
    step = build_merkle_tree_step(prog, template, views, MERKLE_LEAVES, device=dev)
    print(f"[step] merkle built in {time.time() - t0:.2f} s (one bits check a level)")
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    root, total = step(leaves)
    root, total = root.tolist(), int(total)
    counts = fk.launch_counts()
    print(f"[step] merkle total {total} launches {counts}")
    level = [state_words(row) for row in leaves_np]
    while len(level) > 1:
        level = [sha256_compress(SHA256_IV, level[i] + level[i + 1]) for i in range(0, len(level), 2)]
    assert total == 0 and state_words(root) == level[0], "the Merkle root differs from the oracle's"
    print(f"[probe] merkle: the root of {MERKLE_LEAVES} leaves ({MERKLE_LEAVES - 1} compressions) equals "
          f"the Python oracle's")
    torch.cuda.reset_peak_memory_stats()
    _, t_step = timed(lambda: step(leaves))
    peak = torch.cuda.max_memory_allocated() / 2**30
    R = template.num_constraints
    print(f"[perf] merkle step {t_step:.4f} s for {MERKLE_LEAVES} leaves = "
          f"{(MERKLE_LEAVES - 1) * R / t_step:.4e} constraint-evals/s, peak {peak:.2f} GiB, on {card}")
    perm = torch.as_tensor(_STATE_TO_MSG_PERM, device=dev).long()
    evaluator, extract = prog.build(device=dev), _carry_extractor(views, dev)
    d = leaves
    while d.shape[0] > 1:  # the step's levels, each with its own tables
        msg = torch.cat([d[0::2][:, perm], d[1::2][:, perm]], dim=1)
        vals = evaluator(msg)[0]
        bits_kernels_at(f"merkle level {msg.shape[0]}", template, vals, dev, bound, tables, SEED + 14 + msg.shape[0])
        d = extract(vals)
    assert state_words(d[0].tolist()) == level[0]
    return counts


def num_family_synth():
    """The JAX package's mixed block (tests/test_native_num_family.py's
    synthesis target): sha256 of 512 free bits, pack_bits of 200 digest
    bits, num_is_zero of the pack, num_to_bits_le_strict of a free num."""
    nb = NativeBuilder()
    digest = nb.sha256_compression([nb.alloc_bit() for _ in range(512)], nb.sha256_iv())
    nb.num_is_zero(nb.pack_bits(digest[:200]))
    nb.num_to_bits_le_strict(nb.alloc_num())
    template, tape = nb.finish()
    prog = WitnessProgram(tape)
    print(f"[synth] num family block: {template.num_constraints} rows, {prog.num_slots} slots, "
          f"{len(prog.free_slots)} free slots ({len(prog.free_field_slots)} field), {prog.n_field_rows} field rows")
    return template, prog


def num_kernels_at(label, template, prog, free0, ff0, dev, bound, tables):
    """limbs_matvec, operand_mulcmp, mulcmp and mul at the tables the num
    block's step launches them at, batch B = len(free0): limbs_matvec at
    every bucket of the mixed check's rest rows on chunk 0's witness (the
    rest's z as the check assembles it), operand_mulcmp at the product
    rows' table on that witness, mulcmp at the N of the rest rows, mul at
    [16, B] (one step of the inverse's ladder)."""
    Bn = free0.shape[0]
    check = build_templated_check(template, Bn, None, "mixed", field_slots=prog.field_slots, device=dev)
    vals, fl = prog.build(device=dev)(free0, ff0)
    vals_p, fl_p = vals.t().contiguous(), torch.cat([fl, ff0], dim=1).permute(1, 2, 0).contiguous()
    del vals, fl
    zt = check.rest_z(vals_p, fl_p)
    assert check.rest.fused, "the num block's rest rows take the fused limbs check"
    tables["limbs_matvec"].append(limbs_buckets(label, zt, check.rest, bound, 512))
    del zt
    torch.cuda.empty_cache()
    tables["operand_mulcmp"].append(operand_mulcmp_on(f"{label} product rows", check.mul.table, vals_p,
                                                      every_fifth_flipped(fl_p), bound, plain_reps=1))
    del vals_p, fl_p
    tables["mulcmp"].append(mulcmp_at(f"{label} rest rows", check.rest.Rtp * Bn, dev, bound))
    tables["mul"].append(mul_at(f"mul {label} inverse N={Bn}", Bn, dev, bound, np.random.default_rng(SEED + Bn)))
    del check
    torch.cuda.empty_cache()


def num_family_step(dev, card, bound, tables):
    """The num family's mixed block through build_production_step (its
    mixed form) at N_CHUNKS × NUM_B, then at larger batches while the step
    stays under NUM_STEP_S: clean verdicts and launches; chunk 0's vals and
    limbs equal to the CPU evaluator's on 64 instances; a flipped bit of
    the sha256 part and a flipped limb of the inverse found at their
    instance; at every batch its kernels at its tables (num_kernels_at)."""
    template, prog = num_family_synth()
    R = template.num_constraints
    n_bits = len(prog.free_slots)
    counts, Bn = None, NUM_B
    while True:
        free = from_numpy_u32(np.random.default_rng(SEED + 15).integers(0, 2, size=(N_CHUNKS, Bn, n_bits))
                              .astype(np.uint32), dev)
        rnd = random.Random(SEED + 15)
        ff = canonical_lm([rnd.randrange(SCALAR.p) for _ in range(N_CHUNKS * Bn)], dev).t().reshape(
            N_CHUNKS, Bn, 1, 16).contiguous()
        step = build_production_step(prog, template, Bn, device=dev)
        step(free, ff)  # warm-up
        torch.cuda.synchronize()
        fk.reset_launch_counts()
        verdict = tuple(int(x) for x in step(free, ff))
        path_counts = fk.launch_counts()
        print(f"[step] num family at {N_CHUNKS}x{Bn} verdict {verdict} launches {path_counts}")
        assert verdict == (0, 0xFFFFFFFF) and path_counts["mul"] > 0, path_counts
        assert path_counts["operand_mulcmp"] == path_counts["mulcmp"] == N_CHUNKS, path_counts
        counts = counts or path_counts
        if Bn == NUM_B:
            vals, fl = prog.build(device=dev)(free[0], ff[0])
            cvals, cfl = prog.build(device="cpu")(free[0, :64].cpu(), ff[0, :64].cpu())
            assert torch.equal(vals[:64].cpu(), cvals) and torch.equal(fl[:64].cpu(), cfl), "num family chunk 0"
            check = build_templated_check(template, Bn, None, "mixed", field_slots=prog.field_slots, device=dev)
            fl_check = torch.cat([fl, ff[0]], dim=1)
            assert tuple(int(x) for x in check.verdict(vals, fl_check)) == (0, 0xFFFFFFFF)
            inv_row = int(next(st.outs[0] for st in prog.stages if st.opcode == "num_inv_or_one"))
            for what, inst, edit in (("bit slot 9000", Bn // 3, lambda v, f, i: v[i, 9000].bitwise_xor_(1)),
                                     ("bit of limb 3 of the inverse", 5,
                                      lambda v, f, i: f[i, inv_row, 3].bitwise_xor_(1))):
                v, f = vals.clone(), fl_check.clone()
                edit(v, f, inst)
                nbad, first = (int(x) for x in check.verdict(v, f))
                assert nbad > 0 and first // R == inst, (what, nbad, first)
                print(f"[probe] num family: a flipped {what} of instance {inst} found: n_bad {nbad}, "
                      f"row {first % R}")
            print("[probe] num family chunk 0's vals and limbs equal the CPU evaluator's on 64 instances")
            del vals, fl, fl_check, check
        torch.cuda.reset_peak_memory_stats()
        t_step = time_step(lambda fr: step(fr, ff), free, 2)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[perf] num family step {t_step:.4f} s for {N_CHUNKS}x{Bn} instances = "
              f"{N_CHUNKS * Bn * R / t_step:.4e} constraint-evals/s, peak {peak:.2f} GiB, on {card}")
        del step
        torch.cuda.empty_cache()
        num_kernels_at(f"num family {Bn}", template, prog, free[0], ff[0], dev, bound, tables)
        del free, ff
        if 2 * t_step >= NUM_STEP_S or 2 * peak >= PEAK_GIB or Bn >= NUM_B_MAX:
            return counts
        Bn *= 2


def row_sums_int(r1cs, zi: dict, rows) -> dict:
    """{matrix: its Python-int value at each of `rows`} over zi, {slot:
    int} for every slot those rows read."""
    p = r1cs.field.p
    mark = np.zeros(r1cs.num_constraints, bool)
    mark[rows] = True
    out = {}
    for name in "abc":
        m = getattr(r1cs, name)
        sel = mark[m.rows]
        s = {int(r): 0 for r in rows}
        for r, c, k in zip(m.rows[sel], m.cols[sel], m.coeff_ids[sel]):
            s[int(r)] = (s[int(r)] + r1cs.coeff_table[k] * zi[int(c)]) % p
        out[name] = [s[int(r)] for r in rows]
    return out


def z_ints(z: torch.Tensor, slots) -> dict:
    """{slot: the Python int of z's row}, the rows read back at once."""
    slots = sorted({int(s) for s in slots})
    rows = to_u32(z[torch.as_tensor(slots, device=z.device)]).cpu().numpy()
    return {s: limb_int(row) for s, row in zip(slots, rows)}


def config5_kernels(label, r1cs, z, meta, prep, dev, bound, tables):
    """The kernels at config 5's own shapes and operands: mulcmp on chunk
    0's semi blocks (every other C column zeroed, so half the mask is 1),
    mul on one premul slice of the raw (non-canonical) z, mul on the
    product's chunk 0, reduce_digits on its A digit sums in both layouts
    and on the corner sums at its shape."""
    p = SCALAR.p
    R = r1cs.num_constraints
    names = ("a", "b", "c")
    ev, _ = build_row_chunked_eval(r1cs, R >> c5.LOG2_RPC_CHECK, reuse=(meta, prep), device=dev)
    cl = prep["coeff_limbs"]
    zsrc = ev._zsrc(z, cl)
    a, b, c = ev._blocks_semi(zsrc, cl, _chunk(ev._xs(prep, names), 0), names)
    c[:, 1::2] = 0
    want = fk.mulcmp(a, b, c, SCALAR)
    assert int(want[0::2].sum()) == 0 and int(want[1::2].sum()) > 0.99 * want[1::2].numel(), "config5 mulcmp mask"
    N = a.shape[1]
    tables["mulcmp"].append(compare(f"mulcmp {label} chunk 0 semi blocks N={N}", lambda: fk.mulcmp(a, b, c, SCALAR),
                                    lambda: fk.mulcmp_plain(a, b, c, SCALAR), mulcmp_bound(bound, N), plain_reps=2))
    del a, b, c, want
    k = max(ev.span)  # the last premul slice: coefficient p − 1
    n = ev.span[k]
    zk = z[:n].t().contiguous()
    ck = cl[k][:, None].expand(16, n).contiguous()
    got = fk.mul(zk, ck, SCALAR)
    vals = [col_int(zk, i) for i in range(64)]
    assert any(v >= p for v in vals), "config 5's raw z holds values in [p, 2^256)"
    cv = limb_int(to_u32(cl[k]).tolist())
    assert all(col_int(got, i) == v * cv % p for i, v in enumerate(vals)), "mul on raw z"
    tables["mul"].append(compare(f"mul {label} premul raw z N={n}", lambda: fk.mul(zk, ck, SCALAR),
                                 lambda: fk.mul_plain(zk, ck, SCALAR), bound(3 * 16 * 4 * n, n * MODMUL_MULS),
                                 plain_reps=2))
    del zk, ck, got
    ew, _ = build_row_chunked_eval(r1cs, R >> c5.LOG2_RPC_WIT, names=("a", "b"), reuse=(meta, prep), device=dev)
    x0 = _chunk(ew._xs(prep, ("a", "b")), 0)
    az, bz = ew._blocks(zsrc, cl, x0, ("a", "b"))
    n = az.shape[1]
    tables["mul"].append(compare(f"mul {label} product chunk N={n}", lambda: fk.mul(az, bz, SCALAR),
                                 lambda: fk.mul_plain(az, bz, SCALAR), bound(3 * 16 * 4 * n, n * MODMUL_MULS),
                                 plain_reps=2))
    em = _ell_digit_sums(ew._gathered(zsrc, cl, x0[0], "a"), 2)  # [n, 32], as _block passes it
    for layout, d in (("element-major", em.t()), ("limb-major", em.t().contiguous())):
        tables["reduce_digits"].append(compare(
            f"reduce_digits {label} product chunk A digit sums {layout} N={n}", lambda: fk.reduce_digits(d, SCALAR),
            lambda: fk.reduce_digits_plain(d, SCALAR), bound((32 + 16) * 4 * n, n * REDUCE_MULS), plain_reps=2,
            device=("reduce_digits", n, layout)))
    sums = digit_sums_at(n, p, SEED + 17)  # the corner sums at the chunk's shape, element-major
    d = from_numpy_u32(sums, dev).t()
    got = fk.reduce_digits(d, SCALAR)
    check_reduced(got, sums, p, f"{label} corners")
    assert torch.equal(got, fk.reduce_digits_plain(d, SCALAR)), f"reduce_digits {label} corners"
    print(f"[kernel] reduce_digits {label} corner sums element-major N={n}: equal to Python ints and the plain "
          f"version")
    del zsrc, az, bz, em, d, got
    torch.cuda.empty_cache()


def config5_path(dev, card, bound, tables):
    """Config 5 at 2^24 rows on one card, as benchmarks/config5_synthetic_
    r1cs.py:107-200 runs it there (the row-chunked scan): the check's
    layout at 2^19 rows a chunk, the witness completion's product at 2^17
    reusing it, the completion twice (the second timed), the check once,
    once warm and 10 times with one sync; the completed product at 4,096
    sampled rows against Python ints, the flip of z[5, 0] reported at the
    row numpy names; then the kernels at this path's shapes. Returns the
    launches of one completion and one check."""
    r1cs, zfree, N0, t_build = c5.config5_r1cs(c5.LOG2_R)
    R = r1cs.num_constraints
    n_chk, n_wit = R >> c5.LOG2_RPC_CHECK, R >> c5.LOG2_RPC_WIT
    print(f"[synth] config 5: {R} rows, {r1cs.a.nnz + r1cs.b.nnz + r1cs.c.nnz} entries, N0 {N0}; host build "
          f"{t_build:.3f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    check_fn, prep = build_row_chunked_check(r1cs, n_chk, device=dev)
    torch.cuda.synchronize()
    t_layout = time.time() - t0
    meta = check_fn._layout_meta
    assert check_fn._route == "semi" and meta["premul"], (check_fn._route, meta)
    assert meta["modes"] == {"a": ("ell", 2, True), "b": ("ell", 1, True), "c": ("slice", N0 + 1)}, meta["modes"]
    t0 = time.time()
    prod_fn, prep_ab = build_row_chunked_product(r1cs, n_wit, reuse=(meta, prep), device=dev)
    t_wit_layout = time.time() - t0
    assert prep_ab["a"] is prep["a"] and prep_ab["b"] is prep["b"]
    z = c5.config5_z(zfree, R, dev)

    def complete(zz):
        zz[N0 + 1 :] = prod_fn(zz, prep_ab)  # the product reads every chunk first

    torch.cuda.synchronize()
    fk.reset_launch_counts()
    complete(z)
    verdict = tuple(int(x) for x in check_fn(z, prep))
    counts = fk.launch_counts()
    print(f"[step] config5 completion + check: verdict {verdict} launches {counts}")
    n_pm = len(meta["span"])
    assert verdict == (0, 0xFFFFFFFF), verdict
    assert counts == {**dict.fromkeys(fk.KERNELS, 0), "mul": n_wit + 2 * n_pm, "reduce_digits": 2 * n_wit,
                      "mulcmp": n_chk}, counts
    z2 = z.clone()
    torch.cuda.synchronize()
    t0 = time.time()
    complete(z2)
    torch.cuda.synchronize()
    t_wit = time.time() - t0
    assert torch.equal(z2, z), "a second completion differs"
    del z2
    t0 = time.time()
    ok = int(check_fn(z, prep)[0]) == 0
    t_check_first = time.time() - t0
    ok = ok and int(check_fn(z, prep)[0]) == 0
    t0 = time.time()
    nbs = [check_fn(z, prep)[0] for _ in range(10)]
    torch.cuda.synchronize()
    t_check = (time.time() - t0) / 10
    assert ok and sum(int(x) for x in nbs) == 0
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[perf] config5 R={R}: host build {t_build:.3f} s, check layout {t_layout:.3f} s, witness layout "
          f"{t_wit_layout:.4f} s, witness completion {t_wit:.4f} s, check {t_check:.4f} s (first "
          f"{t_check_first:.4f} s) = {R / t_check:.4e} constraint-evals/s, peak {peak:.2f} GiB, on {card}")
    rows = np.sort(np.random.default_rng(SEED + 16).choice(R, CONFIG5_SAMPLES, replace=False))
    slots = np.concatenate([r1cs.a.cols[2 * rows], r1cs.a.cols[2 * rows + 1], r1cs.b.cols[rows], N0 + 1 + rows])
    zi = z_ints(z, slots)
    sums = row_sums_int(r1cs, zi, rows)
    assert all(sa * sb % SCALAR.p == sc for sa, sb, sc in zip(sums["a"], sums["b"], sums["c"])), "config5 product"
    print(f"[probe] config5: the completed product at {CONFIG5_SAMPLES} sampled rows equals A·z · B·z over the "
          f"Python ints")
    zb = z.clone()
    zb[c5.FLIP_SLOT, 0] ^= 1
    bad = tuple(int(x) for x in check_fn(zb, prep))
    row = c5.flipped_first_row(r1cs, c5.FLIP_SLOT)
    zi = z_ints(zb, list(r1cs.a.cols[2 * row : 2 * row + 2]) + [r1cs.b.cols[row], N0 + 1 + row])
    s = row_sums_int(r1cs, zi, [row])
    assert (s["a"][0] * s["b"][0] - s["c"][0]) % SCALAR.p, "the expected row holds over the Python ints"
    assert bad[0] > 0 and bad[1] == row, (bad, row)
    print(f"[probe] config5: z[{c5.FLIP_SLOT}, 0] ^= 1 gives verdict {bad}: first = row {row}, the least row "
          f"whose A or B reads slot {c5.FLIP_SLOT} with a nonzero net coefficient")
    del zb
    torch.cuda.empty_cache()
    config5_kernels("config5", r1cs, z, meta, prep, dev, bound, tables)
    return counts


def row_sharded_path(dev, card, bound, tables):
    """Config 5's generator at 2^20 rows (the benchmark's default size and
    its one-device row-sharded-mesh mode): RowShardedSatisfier (limbs, one
    shard) on the completed witness, its launches, time and verdicts equal
    to the semi and canonical routes' of the row-chunked check, clean and
    with z[5, 0] flipped; mul_digits on A's gathered raw z and
    coefficients, reduce_digits on its digit sums and mul on the shard's
    A·z and B·z, the operands check_local gives it. Returns the launches of one check."""
    r1cs, zfree, N0, t_build = c5.config5_r1cs(ROW_SHARDED_LOG2_R)
    R = r1cs.num_constraints
    t0 = time.time()
    sat = RowShardedSatisfier(r1cs, device=dev)
    torch.cuda.synchronize()
    t_shard_build = time.time() - t0
    n_chk = max(1, R >> c5.LOG2_RPC_CHECK)
    semi, prep = build_row_chunked_check(r1cs, n_chk, device=dev)
    canon, _ = build_row_chunked_check(r1cs, n_chk, use_pallas=False, reuse=(semi._layout_meta, prep), device=dev)
    assert (semi._route, canon._route) == ("semi", "canonical")
    prod_fn, prep_ab = build_row_chunked_product(r1cs, R >> c5.LOG2_RPC_WIT, reuse=(semi._layout_meta, prep),
                                                 device=dev)
    z = c5.config5_z(zfree, R, dev)
    z[N0 + 1 :] = prod_fn(z, prep_ab)
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    verdict = tuple(int(x) for x in sat._check(z))
    counts = fk.launch_counts()
    print(f"[step] row_sharded R={R}: verdict {verdict} launches {counts}")
    assert counts == {**dict.fromkeys(fk.KERNELS, 0), "mul_digits": 3, "reduce_digits": 3, "mul": 1}, counts
    zb = z.clone()
    zb[c5.FLIP_SLOT, 0] ^= 1
    for what, zz in (("clean", z), ("z[5, 0] flipped", zb)):
        got = [tuple(int(x) for x in f(zz)) for f in (sat._check, lambda t: semi(t, prep), lambda t: canon(t, prep))]
        assert got[0] == got[1] == got[2], (what, got)
        assert (got[0] == (0, 0xFFFFFFFF)) == (zz is z), (what, got)
        print(f"[probe] row_sharded R={R} {what}: RowShardedSatisfier, the semi and the canonical routes all "
              f"give {got[0]}")
    assert got[0][1] == c5.flipped_first_row(r1cs, c5.FLIP_SLOT)
    del zb
    ok = sat.is_satisfied(z) and sat.is_satisfied(z)
    t0 = time.time()
    nbs = [sat._check(z)[0] for _ in range(10)]
    torch.cuda.synchronize()
    t_check = (time.time() - t0) / 10
    assert ok and sum(int(x) for x in nbs) == 0
    t_semi = wall_s(lambda: semi(z, prep), 10)
    print(f"[perf] row_sharded R={R}: host build {t_build:.3f} s, shard build {t_shard_build:.3f} s, check "
          f"{t_check:.4f} s = {R / t_check:.4e} constraint-evals/s (the row-chunked semi check at "
          f"{R // n_chk} rows a chunk {t_semi:.4f} s), on {card}")
    for k, table in row_shard_kernels("row_sharded", sat, z, bound).items():
        tables[k].append(table)
    del sat, z
    torch.cuda.empty_cache()
    return counts


def row_shard_kernels(label, sat, z, bound) -> dict:
    """The kernels of RowShardedSatisfier.check_local at its first shard's
    shapes, on the operands it gives them: mul_digits on A's gathered raw
    z and coefficients (a few columns against Python ints too),
    reduce_digits on the digit sums of A's rows (two entries a row) and
    mul on the shard's A·z and B·z. {kernel: its table}."""
    local, _origin = sat._shards[0]
    e = local["a"]
    zv = _gather_rows(z, e["cols"]).t().contiguous()
    cv = sat._coeff_lm.index_select(1, e["cids"]).contiguous()
    n = zv.shape[1]
    got = fk.mul_digits(zv, cv, SCALAR)
    for i in (0, 1, 2, n - 1):
        v = col_int(zv, i) * col_int(cv, i) % SCALAR.p
        assert [int(x) for x in to_u32(got[:, i]).tolist()] == [(v >> (8 * j)) & 0xFF for j in range(32)]
    out = {"mul_digits": compare(
        f"mul_digits {label} A raw z N={n}", lambda: fk.mul_digits(zv, cv, SCALAR),
        lambda: fk.mul_digits_plain(zv, cv, SCALAR), bound((16 + 16 + 32) * 4 * n, n * MODMUL_MULS), plain_reps=2,
        device=("mul_digits", n, "limb-major"))}
    dsum = got.reshape(32, -1, 2).sum(2, dtype=torch.int32)
    n = dsum.shape[1]
    out["reduce_digits"] = compare(
        f"reduce_digits {label} A digit sums N={n}", lambda: fk.reduce_digits(dsum, SCALAR),
        lambda: fk.reduce_digits_plain(dsum, SCALAR), bound((32 + 16) * 4 * n, n * REDUCE_MULS), plain_reps=2,
        device=("reduce_digits", n, "limb-major"))
    az, bz = (sat._matvec_local(m, z, local) for m in "ab")  # the operands check_local gives mul
    n = az.shape[1]
    out["mul"] = compare(f"mul {label} A·z by B·z N={n}", lambda: fk.mul(az, bz, SCALAR),
                         lambda: fk.mul_plain(az, bz, SCALAR), bound(3 * 16 * 4 * n, n * MODMUL_MULS), plain_reps=2)
    del zv, cv, got, dsum, az, bz
    torch.cuda.empty_cache()
    return out


# --- the sharded steps and checkers on torch.distributed ---------------------------
def corrupt_free_xor(tape):
    """The tape with its first xor of two free bits computing `and`, and
    the two bits' positions among the free inputs: that xor's row fails
    at every instance where either bit is 1, and holds where both are 0."""
    _ni, _na, ops, free = tape.snapshot()
    pos = {s: k for k, s in enumerate(free)}
    of_free = lambda op: all(a in pos for a in op.args)  # noqa: E731
    op = next(op for op in ops if op.opcode == "xor" and of_free(op))
    return corrupted(tape, "xor", "first", into="and", where=of_free), [pos[a] for a in op.args]


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(to_numpy_u32(t).tobytes()).hexdigest()


def shard_inputs():
    """The sharding phase's global inputs, made from seeds: the packed
    step's free words [SHARD_PACKED_B/32, 512] and the bits step's free
    bits [SHARD_BITS_B, 512], each clean and with the corrupted xor's two
    free bits zeroed in the first half of the batch (so its first failing
    instance lies in the second half, the last rank's), and the limbs
    check's free bits [SHARD_LIMBS_B, 512]."""
    rng = np.random.default_rng(SEED + 21)
    _t, tape = sha256_template()
    _bad, (i, j) = corrupt_free_xor(tape)
    inp = {"packed": rng.integers(0, 1 << 32, size=(SHARD_PACKED_B // 32, 512), dtype=np.uint64).astype(np.uint32),
           "bits": rng.integers(0, 2, size=(SHARD_BITS_B, 512)).astype(np.uint32),
           "limbs": rng.integers(0, 2, size=(SHARD_LIMBS_B, 512)).astype(np.uint32)}
    for key in ("packed", "bits"):
        bad = inp[key].copy()
        bad[: bad.shape[0] // 2, [i, j]] = 0
        inp[key + "_bad"] = bad
    return inp


def row_shard_witness(dev):
    """Config 5's generator at 2^ROW_SHARDED_LOG2_R rows, its witness
    completed on `dev`, and the (slot, row) of two flips: z[5, 0], first
    read in the first half of the rows, and the product slot of the row
    3R/4 + 1, read by that row alone (C's identity), in the second half."""
    r1cs, zfree, N0, _ = c5.config5_r1cs(ROW_SHARDED_LOG2_R)
    R = r1cs.num_constraints
    semi, prep = build_row_chunked_check(r1cs, max(1, R >> c5.LOG2_RPC_CHECK), device=dev)
    prod_fn, prep_ab = build_row_chunked_product(r1cs, R >> c5.LOG2_RPC_WIT, reuse=(semi._layout_meta, prep),
                                                 device=dev)
    z = c5.config5_z(zfree, R, dev)
    z[N0 + 1 :] = prod_fn(z, prep_ab)
    late = 3 * R // 4 + 1
    return r1cs, z, ((c5.FLIP_SLOT, c5.flipped_first_row(r1cs, c5.FLIP_SLOT)), (N0 + 1 + late, late))


def flipped(z: torch.Tensor, slot: int) -> torch.Tensor:
    zb = z.clone()
    zb[slot, 0] ^= 1
    return zb


def shard_run(fn):
    """fn() once with every launch count reset just before and read just
    after: (its result, the counts, host seconds ending in a synchronize)."""
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, fk.launch_counts(), time.time() - t0


def both_verdicts(name: str, mask: torch.Tensor):
    """A compare's plain 0/1 verdict mask must hold both verdicts, so that
    agreeing with it shows the kernel flags violations and passes the
    rest."""
    n_bad = int((mask != 0).sum())
    assert 0 < n_bad < mask.numel(), f"{name}: the plain mask holds one verdict only ({n_bad} of {mask.numel()})"


def bits_check_kernels(label, packed, words, bound, seed, slice_words=None) -> dict:
    """The kernels of a PackedBitsCheck on its words int32[S, Bw], the
    operands the check gives them with the odd words random (so both
    verdicts occur, which the plain masks show): bitplane_eq at its plane
    table, bits_matvec_semi at its big row's buckets and mulcmp on those
    buckets' A·z, B·z and C·z. {kernel: its table}."""
    S_w, Bw = words.shape
    words = words.clone()
    words[:, 1::2] = from_numpy_u32(np.random.default_rng(seed).integers(
        0, 1 << 32, size=(S_w, Bw // 2), dtype=np.uint64).astype(np.uint32), words.device)
    spec = packed.pow2_spec
    n, m_a, m_c = spec["a_cols"].shape[0], spec["a_cols"].shape[2], spec["c_cols"].shape[2]
    both_verdicts(f"bitplane_eq {label}", fk.bitplane_eq_plain(
        words, packed.plane_idx, n, fk.padded_positions(spec["n_pos"]), m_a, m_c))
    out = {"bitplane_eq": bitplane_at(label, words, spec, packed.plane_idx, bound),
           "bits_matvec_semi": semi_buckets(label, words, packed.big, bound, library=False, slice_words=slice_words)}
    a, b, c = (packed.big._matvec(n, words) for n in "abc")
    out["mulcmp"] = mulcmp_on(label, a, b, c, bound)
    return out


def sharding_rank(dev, inp: dict, max_mhz: float) -> dict:
    """One rank of a sharding run (the group is the world; spawned by
    tools/dryrun_multichip.RankJob): the dry run's checks, then the
    packed step at SHARD_PACKED_B and the bits step at SHARD_BITS_B
    (clean and with the corrupted xor), the limbs ShardedSatisfier at
    SHARD_LIMBS_B (clean and with a flipped limb) and RowShardedSatisfier
    at 2^ROW_SHARDED_LOG2_R rows (clean and two flips), each once warm
    with its launches counted; then, one rank after the other, each
    kernel of those paths at this rank's shapes on this rank's operands.
    Returns the verdicts, the witness shards' digests, the launches, the
    times and the kernel tables."""
    group = default_group()
    W, rank = dist.get_world_size(group), dist.get_rank(group)
    label = f"sharded {dist.get_backend(group)} W={W} rank {rank}"
    cuda_lib.load_kernels()  # built by the parent: a rank only loads it
    bound = Bound(max_mhz)
    out = {"rank": rank, "device": str(dev), "dryrun": dryrun_rank(dev), "verdict": {}, "digest": {},
           "launches": {}, "s": {}}
    template, tape = sha256_template()
    tape_bad, _ = corrupt_free_xor(tape)
    prog, prog_bad = WitnessProgram(tape), WitnessProgram(tape_bad)

    def record(path, fn):
        fn()  # warm-up
        res, counts, dt = shard_run(fn)
        out["launches"][path], out["s"][path] = counts, dt
        return res

    step, shard = sharded_packed_witness_and_check(prog, template, SHARD_PACKED_B, None, group=group, device=dev)
    fp = shard(inp["packed"])
    nb, first, vals = record("packed", lambda: step(fp))
    out["verdict"]["packed"] = (int(nb), int(first))
    out["digest"]["packed"] = digest(vals)
    step_bad, _ = sharded_packed_witness_and_check(prog_bad, template, SHARD_PACKED_B, None, group=group, device=dev)
    out["verdict"]["packed_bad"] = tuple(int(v) for v in step_bad(shard(inp["packed_bad"]))[:2])
    words_packed = vals.t().contiguous()
    del step, step_bad, fp, vals

    step, shard = sharded_witness_and_check(prog, template, SHARD_BITS_B, None, group=group, device=dev)
    fb = shard(inp["bits"])
    nb, z_bits = record("bits", lambda: step(fb))
    out["verdict"]["bits"] = int(nb)
    out["digest"]["bits"] = digest(z_bits)
    step_bad, shard = sharded_witness_and_check(prog_bad, template, SHARD_BITS_B, None, group=group, device=dev)
    out["verdict"]["bits_bad"] = int(step_bad(shard(inp["bits_bad"]))[0])
    del step, step_bad, fb

    sat = ShardedSatisfier(template, SHARD_LIMBS_B, group=group, witness_form="limbs", device=dev)
    z3 = prog.z_template_limbs(*prog.build(device=dev)(from_numpy_u32(inp["limbs"], dev))).cpu()
    zl = sat.shard_z(z3)
    inst, slot, limb = SHARD_LIMBS_FLIP
    z3[inst, slot, limb] ^= 1
    zl_bad = sat.shard_z(z3)
    del z3
    out["verdict"]["limbs"] = record("limbs", lambda: sat._verdict(zl))
    out["verdict"]["limbs_bad"] = (sat._verdict(zl_bad), sat.which_is_unsatisfied(zl_bad))
    del zl_bad

    r1cs, z, flips = row_shard_witness(dev)
    rsat = RowShardedSatisfier(r1cs, device=dev, group=group)
    assert len(rsat._shards) == 1, "a rank holds its own shard only"
    out["verdict"]["row"] = tuple(int(v) for v in record("row", lambda: rsat._check(z)))
    out["verdict"]["row_bad"] = [(tuple(int(v) for v in rsat._check(flipped(z, s))),
                                  rsat.which_is_unsatisfied(flipped(z, s))) for s, _row in flips]

    # the kernels at this rank's shapes, one rank at a time (each timed alone on the card)
    tables = {k: [] for k in fk.KERNELS}
    for r in range(W):
        if r == rank:
            check = build_templated_check(template, SHARD_PACKED_B // W, None, "bits_packed", device=dev)
            for k, t in bits_check_kernels(f"{label} packed", check, words_packed, bound, SEED + 22 + rank,
                                           1024).items():
                tables[k].append(t)
            del check, words_packed
            check = build_templated_check(template, SHARD_BITS_B // W, None, "bits", device=dev)
            words = pack_rows(z_bits.t(), check.Bw)
            for k, t in bits_check_kernels(f"{label} bits", check.packed, words, bound, SEED + 24 + rank).items():
                tables[k].append(t)
            del check, words, z_bits
            lcheck, zt = sat._check, zl.permute(1, 2, 0).contiguous()
            tables["limbs_matvec"].append(limbs_buckets(f"{label} limbs", zt, lcheck, bound, 128))
            a, b, c = (lcheck._matvec_fused(n, zt) for n in "abc")
            c[:, 1::2] = 0  # the odd columns' products no longer match where they are not 0: both verdicts occur
            tables["mulcmp"].append(mulcmp_on(f"{label} limbs", a, b, c, bound))
            del a, b, c, zt, zl, sat
            for k, t in row_shard_kernels(f"{label} row", rsat, z, bound).items():
                tables[k].append(t)
            torch.cuda.empty_cache()
        dist.barrier(group)
    out["tables"] = tables
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def sharding_path(dev, card, tables, max_mhz: float):
    """The sharded steps and checkers at full width, run twice: on one
    rank over NCCL, and on two ranks over gloo that share the one card
    (the rank logic, not scaling). Each run's verdicts, (n_bad, first) of
    every flip and witness shards (their digests, in rank order) equal
    single-rank execution, which this process runs first (the
    single-device step, check and checker on the same inputs); each run's
    launches are counted on every rank; its kernel compares join the
    tables. Returns {path: launches summed over the ranks}."""
    inp = shard_inputs()
    template, tape = sha256_template()
    R = template.num_constraints
    tape_bad, _ = corrupt_free_xor(tape)
    prog, prog_bad = WitnessProgram(tape), WitnessProgram(tape_bad)
    want, slices = {}, {}
    fp = from_numpy_u32(inp["packed"], dev)
    for key, pg in (("packed", prog), ("packed_bad", prog_bad)):
        f = from_numpy_u32(inp[key], dev)
        step = build_packed_production_step(pg, template, SHARD_PACKED_B, device=dev)
        want[key] = tuple(int(v) for v in step(f[None]))
    vals = prog.build_packed(device=dev)(fp)
    slices["packed"] = {W: [digest(v) for v in vals.chunk(W)] for W, _ in SHARD_RUNS}
    del fp, vals
    for key, pg in (("bits", prog), ("bits_bad", prog_bad)):
        f = from_numpy_u32(inp[key], dev)
        want[key] = int(build_production_step(pg, template, SHARD_BITS_B, device=dev)(f[None])[0])
    z_bits = prog.build(device=dev)(from_numpy_u32(inp["bits"], dev))[0]
    slices["bits"] = {W: [digest(v) for v in z_bits.chunk(W)] for W, _ in SHARD_RUNS}
    del z_bits
    sat = TemplatedSatisfier(template, SHARD_LIMBS_B, device=dev)
    z3 = prog.z_template_limbs(*prog.build(device=dev)(from_numpy_u32(inp["limbs"], dev)))
    want["limbs"] = tuple(int(v) for v in sat.check.verdict(z3))
    inst, slot, limb = SHARD_LIMBS_FLIP
    z3[inst, slot, limb] ^= 1
    want["limbs_bad"] = (tuple(int(v) for v in sat.check.verdict(z3)), sat.which_is_unsatisfied(z3))
    del sat, z3
    r1cs, z, flips = row_shard_witness(dev)
    one = RowShardedSatisfier(r1cs, device=dev)
    want["row"] = tuple(int(v) for v in one._check(z))
    want["row_bad"] = [(tuple(int(v) for v in one._check(flipped(z, s))), one.which_is_unsatisfied(flipped(z, s)))
                       for s, _row in flips]
    del one, z
    torch.cuda.empty_cache()
    assert want["packed"] == want["limbs"] == want["row"] == (0, 0xFFFFFFFF) and want["bits"] == 0, want
    assert want["packed_bad"][0] > 0 and want["packed_bad"][1] // R >= SHARD_PACKED_B // 2, want["packed_bad"]
    assert want["bits_bad"] > 0, want["bits_bad"]
    assert want["limbs_bad"][0][0] > 0 and want["limbs_bad"][0][1] // R == inst, want["limbs_bad"]
    assert [v[0][1] for v in want["row_bad"]] == [row for _s, row in flips], want["row_bad"]
    print(f"[shard] single-rank references on one card: {want}")
    print(f"[shard] NCCL across cards not run: torch.cuda.device_count() is {torch.cuda.device_count()}")

    launches = {}
    for W, backend in SHARD_RUNS:
        where = f"{backend}, {W} rank{'s' if W > 1 else ''} on {torch.cuda.device_count()} card"
        t0 = time.time()
        results = RankJob(sharding_rank, W, inp, max_mhz, backend=backend, device=DEVICE).join(timeout=600)
        wall = time.time() - t0
        for r, res in enumerate(results):
            assert res["rank"] == r and res["device"] == f"cuda:{r % torch.cuda.device_count()}", (r, res["device"])
            assert res["verdict"] == want, (where, r, res["verdict"], want)
            d = res["dryrun"]
            assert (d["world"], d["backend"], d["packed"]) == (W, backend, (0, 0xFFFFFFFF)), d
        dry = results[0]["dryrun"]
        assert all(res["dryrun"]["which"] == dry["which"] for res in results)
        print(f"[shard] dryrun_multichip ({where}): unpacked step at {W}, packed step at {512 * W}, each "
              f"shard word-equal to single-rank execution; the {dry['big_rows']}-row row-sharded check clean and "
              f"its flips located as on one rank: {dry['which']}")
        for path in ("packed", "bits"):
            assert [res["digest"][path] for res in results] == slices[path][W], (where, path)
        expect = {"packed": {"bitplane_eq": 1, "bits_matvec_semi": 3, "mulcmp": 1, "verdict_fold": 8},
                  "bits": {"bitplane_eq": 1, "bits_matvec_semi": 3, "mulcmp": 1, "verdict_fold": 8},
                  "limbs": {"limbs_matvec": 17, "mulcmp": 1},
                  "row": {"mul_digits": 3, "reduce_digits": 3, "mul": 1}}
        for path, counts in expect.items():
            for res in results:
                assert res["launches"][path] == {**dict.fromkeys(fk.KERNELS, 0), **counts}, (where, path, res["launches"])
            launches[f"sharded {path} {backend} W={W}"] = {
                k: sum(res["launches"][path][k] for res in results) for k in fk.KERNELS}
        for res in results:
            for k, ts in res["tables"].items():
                tables[k].extend(ts)
        secs = {path: max(res["s"][path] for res in results) for path in expect}
        note = "" if W == 1 else " (two ranks sharing one card: the rank logic, not scaling)"
        print(f"[perf] sharded ({where}){note}: packed step {SHARD_PACKED_B} instances {secs['packed']:.4f} s = "
              f"{SHARD_PACKED_B * R / secs['packed']:.4e} constraint-evals/s, bits step {SHARD_BITS_B} "
              f"{secs['bits']:.4f} s, limbs ShardedSatisfier {SHARD_LIMBS_B} {secs['limbs']:.4f} s, "
              f"RowShardedSatisfier 2^{ROW_SHARDED_LOG2_R} rows {secs['row']:.4f} s (the slowest rank's each); "
              f"peak {max(res['peak_gib'] for res in results):.2f} GiB a rank; {wall:.1f} s for the run with "
              f"its processes' start, on {card}")
        print(f"[shard] {where}: every verdict, flip and witness shard equal to single-rank execution; "
              f"launches {[res['launches'] for res in results]}")
    return launches


# --- the Python circuit frontend ---------------------------------------------
# The flagship and configs 1-3 written with the port's gadgets, as
# tests/test_native_synthesis.py:75-91 and benchmarks/configs_1_2_3.py:88-113,
# 172-186, 222-236 write them, recorded into ShapeCS (the template) and
# TapeCS (the tape); then the Satisfier loop on a TestConstraintSystem.
def fe_sha256(cs):
    """One sha256 compression over 512 allocated bits."""
    bits = [Boolean.from_bit(AllocatedBit.alloc(cs, None)) for _ in range(512)]
    sha256_compression_function(cs, bits, get_sha256_iv())


def fe_config1(cs):
    """Config 1: 128 allocated bits, two packs, (mul, add, square) × 30."""
    bs = [Boolean.from_bit(AllocatedBit.alloc(cs.namespace(f"b{i}"), None)) for i in range(128)]
    a = gpack_bits(cs.namespace("pa"), bs[:64])
    b = gpack_bits(cs.namespace("pb"), bs[64:])
    x = a
    for i in range(30):
        x = x.mul(cs.namespace(f"m{i}"), b)
        x = x.add(cs.namespace(f"a{i}"), a)
        x = x.square(cs.namespace(f"s{i}"))


def fe_config2(cs):
    """Config 2: 8 allocated u32 words, 7 × (xor with rotr(5i), addmany
    with shr(3)) under one MultiEq."""
    ops = [UInt32.alloc(cs.namespace(f"op {i}"), None) for i in range(8)]
    with MultiEq(cs) as mcs:
        x = ops[0]
        for i in range(1, 8):
            x = x.xor(mcs.namespace(f"x{i}"), ops[i].rotr(5 * i))
            x = UInt32.addmany(mcs.namespace(f"s{i}"), [x, ops[i - 1].shr(3)])


def fe_config3(cs):
    """Config 3: 4 allocated u32 words, 3 addmany under one MultiEq, the
    sum's bits packed into one field element."""
    words = [UInt32.alloc(cs.namespace(f"w{i}"), None) for i in range(4)]
    with MultiEq(cs) as mcs:
        acc = words[0]
        for i in range(1, 4):
            acc = UInt32.addmany(mcs.namespace(f"add {i}"), [acc, words[i]])
    gpack_bits(cs.namespace("pack"), acc.into_bits())


def native_sha256():
    nb = NativeBuilder()
    nb.sha256_compression([nb.alloc_bit() for _ in range(512)], nb.sha256_iv())
    template, tape = nb.finish()
    return template, WitnessProgram(tape)


def native_prog(built):
    template, tape = built
    return template, WitnessProgram(tape)


# name, frontend circuit, NativeBuilder build of the same circuit, (rows, slots)
FRONTEND = (("sha256", fe_sha256, native_sha256, (26352, 26327)),
            ("config1", fe_config1, lambda: config1(False), (220, 221)),
            ("config2", fe_config2, lambda: native_prog(config2_circuit()), (712, 712)),
            ("config3", fe_config3, lambda: native_prog(config3_circuit()), (229, 229)))
FE_SHA256_ROWS = 512 + 44874  # the full sha256 of one 512-bit message (tests/test_sha256.py:57-67)


def assert_r1cs_equal(got, want):
    """Rows, cols and coefficient values through each table
    (tests/test_native_synthesis.py:23-35)."""
    assert (got.num_inputs, got.num_aux, got.num_constraints) == \
        (want.num_inputs, want.num_aux, want.num_constraints)
    for m in "abc":
        x, y = getattr(got, m), getattr(want, m)
        assert np.array_equal(x.rows, y.rows) and np.array_equal(x.cols, y.cols), m
        assert [got.coeff_table[i] for i in x.coeff_ids] == [want.coeff_table[i] for i in y.coeff_ids], m


def frontend_synth():
    """Each frontend circuit into ShapeCS and TapeCS, timed beside the
    NativeBuilder build of the same circuit: rows and slots, the template
    equal to NativeBuilder's array for array, the program's free slots
    and stages equal to its program's. {name: ((template, prog), (native
    template, native prog))}."""
    built = {}
    for name, circuit, native, want in FRONTEND:
        t0 = time.time()
        shape = ShapeCS()
        circuit(shape)
        template = shape.finish()
        t1 = time.time()
        tape = TapeCS()
        circuit(tape)
        t2 = time.time()
        prog = WitnessProgram(tape)
        t3 = time.time()
        n_template, n_prog = native()
        t4 = time.time()
        got = (template.num_constraints, prog.num_slots)
        assert got == want, (name, got)
        assert_r1cs_equal(template, n_template)
        assert prog.free_slots == n_prog.free_slots, f"{name}: free slots differ from NativeBuilder's"
        assert [st.opcode for st in prog.stages] == [st.opcode for st in n_prog.stages], name
        print(f"[synth] frontend {name}: {got[0]} rows, {got[1]} slots, {len(prog.free_slots)} free; host seconds "
              f"ShapeCS {t1 - t0:.3f}, TapeCS {t2 - t1:.3f}, WitnessProgram {t3 - t2:.3f} (NativeBuilder with its "
              f"program {t4 - t3:.3f}); template, free slots and stages equal to NativeBuilder's")
        built[name] = ((template, prog), (n_template, n_prog))
    return built


def frontend_config1_step(dev, card, template, prog, native):
    """Config 1 from the frontend on build_production_step at N_CHUNKS ×
    B_FIELD (the mixed form): the clean verdict, chain and operand_mulcmp launched,
    chunk 0 equal to NativeBuilder's program's on the card, a flipped bit
    of a chain row found at its instance; the step's time, rate and peak."""
    R = template.num_constraints
    free = from_numpy_u32(np.random.default_rng(5).integers(0, 2, size=(N_CHUNKS, B_FIELD, 128)).astype(np.uint32),
                          dev)
    step = build_production_step(prog, template, B_FIELD, device=dev)
    step(free)  # warm-up
    verdict, counts = path_run(step, free)
    print(f"[step] frontend config1 verdict {verdict} launches {counts}")
    assert verdict == (0, 0xFFFFFFFF) and counts["chain"] == counts["operand_mulcmp"] == N_CHUNKS, (verdict, counts)
    vals0, fl0 = prog.build(device=dev)(free[0])
    n_vals, n_fl = native.build(device=dev)(free[0])
    assert torch.equal(vals0, n_vals) and torch.equal(fl0, n_fl), "frontend config1 chunk 0 differs from NativeBuilder's"
    check = build_templated_check(template, B_FIELD, None, "mixed", field_slots=prog.field_slots, device=dev)
    assert tuple(int(v) for v in check.verdict(vals0, fl0)) == (0, 0xFFFFFFFF)
    row = int(_detect_linear_chain([st for st in prog.stages if st.opcode in SCAN_OPS])["out_rows"][45])
    inst = B_FIELD // 3
    fbad = fl0.clone()
    fbad[inst, row, 0] ^= 1
    nbad, first = (int(v) for v in check.verdict(vals0, fbad))
    assert nbad > 0 and first // R == inst, (nbad, first)
    print(f"[probe] frontend config1 chunk 0 equals NativeBuilder's program's (vals and flimbs); a flipped bit of "
          f"field row {row} at instance {inst} found: n_bad {nbad}, instance {first // R}")
    del vals0, fl0, n_vals, n_fl, fbad, check
    perf_step("frontend config1", step, free, B_FIELD, R, card, 5)
    return counts


def limbs_check_kernels(label, check, z, bound) -> dict:
    """The kernels of a non-fused LimbsCheck at batch 1 (a Satisfier's
    route) at its own tables, on the operands its mask gives them:
    mul_digits on each matrix's gathered z and coefficients, reduce_digits
    on each matrix's bucket row sums, mul on A·z and B·z. {kernel:
    [tables]}."""
    zl = z[:, :, None].permute(1, 2, 0)  # [16, 1, S_t], the check's limb-major view
    out = {"mul_digits": [], "reduce_digits": [], "mul": []}
    for name in "abc":
        cols, coeffs, buckets = check.mats[name]
        n = cols.shape[0]
        zv = zl.index_select(2, cols).reshape(16, n).contiguous()
        cv = coeffs.contiguous()
        out["mul_digits"].append(compare(
            f"mul_digits {label} {name} entries N={n}", lambda: fk.mul_digits(zv, cv, SCALAR),
            lambda: fk.mul_digits_plain(zv, cv, SCALAR), bound((16 + 16 + 32) * 4 * n, n * MODMUL_MULS), plain_reps=2,
            device=("mul_digits", n, "limb-major")))
        dig = fk.mul_digits(zv, cv, SCALAR)
        sums = torch.cat([dig[:, s : s + nr * k].reshape(32, nr, k).sum(-1, dtype=torch.int32)
                          for k, s, nr in buckets], dim=1).contiguous()
        m = sums.shape[1]
        assert m == check.Rtp, (m, check.Rtp)
        out["reduce_digits"].append(compare(
            f"reduce_digits {label} {name} row sums N={m}", lambda: fk.reduce_digits(sums, SCALAR),
            lambda: fk.reduce_digits_plain(sums, SCALAR), bound((32 + 16) * 4 * m, m * REDUCE_MULS), plain_reps=2,
            device=("reduce_digits", m, "limb-major")))
        del zv, cv, dig, sums
    az, bz = (check._matvec(m, zl) for m in "ab")
    n = az.shape[1]
    out["mul"].append(compare(f"mul {label} A·z by B·z N={n}", lambda: fk.mul(az, bz, SCALAR),
                              lambda: fk.mul_plain(az, bz, SCALAR), bound(3 * 16 * 4 * n, n * MODMUL_MULS), plain_reps=2))
    torch.cuda.empty_cache()
    return out


def frontend_satisfier(dev, card, bound, tables):
    """The Satisfier loop as users debug a circuit: the full sha256 of a
    512-bit message synthesized with values into TestConstraintSystem
    (512 + 44,874 rows), its digest equal to hashlib's; R1CS.from_test_cs
    → Satisfier on the card, satisfied on cs's inputs and aux (its
    launches and seconds); its kernels at its own tables; then one named
    aux value set with cs.set (a flipped bit, then a random field element
    in another bit), each time the card's which_is_unsatisfied equal to
    TestConstraintSystem's."""
    p = SCALAR.p
    data = np.random.default_rng(SEED + 12).integers(0, 256, 64, dtype=np.uint8).tobytes()
    t0 = time.time()
    cs = TestConstraintSystem()
    bits = [Boolean.from_bit(AllocatedBit.alloc(cs.namespace(f"input bit {i}"), bool((data[i // 8] >> (7 - i % 8)) & 1)))
            for i in range(512)]
    out = gsha256(cs.namespace("sha256"), bits)
    t_cs = time.time() - t0
    digest = bytes(sum(int(out[8 * i + j].get_value()) << (7 - j) for j in range(8)) for i in range(32))
    assert cs.num_constraints() == FE_SHA256_ROWS and digest == hashlib.sha256(data).digest(), cs.num_constraints()
    t0 = time.time()
    r1cs = R1CS.from_test_cs(cs)
    t_r1cs = time.time() - t0
    t0 = time.time()
    sat = Satisfier(r1cs, device=dev)
    t_build = time.time() - t0
    assert isinstance(sat._check, LimbsCheck) and not sat._check.fused  # the limbs route at batch 1
    print(f"[synth] frontend sha256 of 64 bytes in TestConstraintSystem: {r1cs.num_constraints} rows, "
          f"{r1cs.num_aux} aux, digest equal to hashlib's; host seconds TestConstraintSystem {t_cs:.3f}, "
          f"from_test_cs {t_r1cs:.3f}, Satisfier build {t_build:.3f}")
    z = sat.z_from_assignments(cs.scalar_inputs(), cs.scalar_aux())
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    ok = sat.is_satisfied(z)
    counts = fk.launch_counts()
    print(f"[step] frontend satisfier is_satisfied {ok} launches {counts}")
    assert ok and (counts["mul_digits"], counts["reduce_digits"], counts["mul"]) == (3, 3, 1), counts
    assert not any(counts[k] for k in ("limbs_matvec", "mulcmp", "bitplane_eq", "bits_matvec_semi", "chain")), counts
    t_chk = wall_s(lambda: sat.is_satisfied(z), 5)
    for k, ts in limbs_check_kernels("frontend sha256 Satisfier", sat._check, z, bound).items():
        tables[k].extend(ts)
    bit_paths = [n for n in cs.aux() if n.startswith("sha256/") and n.endswith("/boolean")]
    rnd = random.Random(SEED + 12)
    for what, path, value in (("a flipped bit", bit_paths[len(bit_paths) // 2], None),
                              ("a random field element", bit_paths[rnd.randrange(len(bit_paths))], rnd.randrange(p))):
        old = cs.get(path)
        cs.set(path, 1 - old if value is None else value)
        name = sat.which_is_unsatisfied(sat.z_from_assignments(cs.scalar_inputs(), cs.scalar_aux()))
        want = cs.which_is_unsatisfied()
        assert want is not None and name == want, (path, name, want)
        print(f"[probe] frontend satisfier: {what} at {path!r}; the card names {name!r}, as TestConstraintSystem does")
        cs.set(path, old)
    print(f"[perf] frontend satisfier check {t_chk:.4f} s for {r1cs.num_constraints} rows, on {card}")
    return counts


def frontend_path(dev, card, bound, tables):
    """The frontend phase: the templates and tapes of the flagship and
    configs 1-3 from the port's gadgets (equal to NativeBuilder's), the
    flagship at N_CHUNKS × B on the packed step, config 1 at N_CHUNKS ×
    B_FIELD on the mixed step, configs 2 and 3 at N_CHUNKS × B on the
    packed step (config 3 mixed packed), and the Satisfier loop. The
    flagship's and configs' kernel tables are NativeBuilder's, compared
    above (the templates are asserted equal); the Satisfier's are compared
    here. {path: launches}."""
    t0 = time.time()
    built = frontend_synth()
    launches = {}
    (template, prog), (_, n_prog) = built["sha256"]
    launches["frontend_sha256"] = sha256_step(dev, card, template, prog, "frontend sha256", same_as=n_prog)
    torch.cuda.empty_cache()
    (template, prog), (_, n_prog) = built["config1"]
    launches["frontend_config1"] = frontend_config1_step(dev, card, template, prog, n_prog)
    torch.cuda.empty_cache()
    for name, seed in (("config2", CONFIG2_SEED), ("config3", CONFIG3_SEED)):
        (template, prog), (_, n_prog) = built[name]
        assert (prog.is_packable, prog.is_packable_mixed) == ((True, True) if name == "config2" else (False, True))
        launches[f"frontend_{name}"] = packed_bit_step(dev, card, bound, f"frontend {name}", template, prog, seed,
                                                       None, same_as=n_prog)
        assert launches[f"frontend_{name}"]["bitplane_eq"] == N_CHUNKS, launches[f"frontend_{name}"]
        torch.cuda.empty_cache()
    launches["frontend_satisfier"] = frontend_satisfier(dev, card, bound, tables)
    torch.cuda.empty_cache()
    print(f"[frontend] phase done in {time.time() - t0:.1f} s")
    return launches


class PathCounts:
    """The launches of a path driven in several calls: each call runs with
    every count set to 0 just before it and read just after, and the
    counts add up; launches made between the calls (the compares) are not
    counted."""

    def __init__(self):
        self.counts = dict.fromkeys(fk.KERNELS, 0)

    def __call__(self, fn):
        torch.cuda.synchronize()
        fk.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = fk.launch_counts()
        for k in self.counts:
            self.counts[k] += got[k]
        return out, got


def api_route(label, make, z, bad, row, run):
    """Build a chain Satisfier with `make` (timed, to a synchronize), check
    the clean and the planted witness and time a check; its peak is the
    device memory it took above what was allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    with phase(f"{label} build"):
        sat = make()
        torch.cuda.synchronize()
    t_build = time.time() - t0
    ok, counts = run(lambda: sat.is_satisfied(z))
    name, _ = run(lambda: sat.which_is_unsatisfied(bad))
    assert ok and name == f"constraint #{row}", (label, ok, name, row)
    with phase(f"{label} check"):
        t_chk = wall_s(lambda: sat.is_satisfied(z), 3)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    return sat, t_build, t_chk, peak, counts


def api_satisfier_routes(dev, card, bound, tables, run):
    """Satisfier(r, False) and Satisfier(r, True) on the 16-block chain,
    the False route's kernels at its shapes, and the chain through the
    serialize round trip."""
    p = SCALAR.p
    template, prog = satisfier_chain_synth()
    R = template.num_constraints
    z, bad, slot, block, row, n_ref = satisfier_chain_witness(template, prog, dev)
    sats = {}
    for use_pallas in (False, True):
        label = f"Satisfier(chain, {use_pallas})"
        sat, t_build, t_chk, peak, counts = api_route(label, lambda: Satisfier(template, use_pallas), z, bad, row, run)
        print(f"[api] {label}: route {sat.route}, built in {t_build:.4f} s, check {t_chk:.4f} s for {R} rows, "
              f"peak {peak:.3f} GiB above its inputs; clean, and bit slot {slot} of block {block} set to a random "
              f"field element named constraint #{row} as over the Python ints; launches a check {counts}; on {card}")
        want = ({"mul": 4, "reduce_digits": 3} if use_pallas is False
                else {"mul_digits": 3, "reduce_digits": 3, "mul": 1})
        assert {k: v for k, v in counts.items() if v} == want, (label, counts)
        sats[use_pallas] = sat
    del sats[True]
    torch.cuda.empty_cache()

    # the False route's kernels on its own operands: the entries of its
    # widest matrix, then their digits' row sums element-major
    sat = sats[False]
    d = sat.device_r1cs
    name, m = max((("a", d.a), ("b", d.b), ("c", d.c)), key=lambda nm: nm[1].cols.numel())
    zv = _gather_rows(z, m.cols).t().contiguous()
    cv = d.coeff_limbs.t().index_select(1, m.coeff_ids).contiguous()
    E = zv.shape[1]
    tables["mul"].append(compare(f"mul api DeviceR1CS {name} entries N={E}", lambda: fk.mul(zv, cv, SCALAR),
                                 lambda: fk.mul_plain(zv, cv, SCALAR), bound(3 * 16 * 4 * E, E * MODMUL_MULS),
                                 plain_reps=2))
    rowsum = torch.zeros((R, 32), dtype=torch.int32, device=dev)
    rowsum.index_add_(0, m.rows, _split8(fk.mul(zv, cv, SCALAR).t()))
    em = rowsum.t()  # element-major, as violation_mask passes it
    tables["reduce_digits"].append(compare(
        f"reduce_digits api DeviceR1CS {name} row sums element-major N={R}", lambda: fk.reduce_digits(em, SCALAR),
        lambda: fk.reduce_digits_plain(em, SCALAR), bound((32 + 16) * 4 * R, R * REDUCE_MULS), plain_reps=2))
    del zv, cv, rowsum, em

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        with phase("serialize chain"):
            fp = save_r1cs(os.path.join(tmp, "chain_r1cs.npz"), template)
            save_witness(os.path.join(tmp, "chain_z.npz"), z, fp)
            loaded = load_r1cs(os.path.join(tmp, "chain_r1cs.npz"), expect_fingerprint=fp)
            zl_np, meta = load_witness(os.path.join(tmp, "chain_z.npz"), expect_fingerprint=fp)
        t_io = time.time() - t0
        sizes = [os.path.getsize(os.path.join(tmp, f)) for f in ("chain_r1cs.npz", "chain_z.npz")]
    zl = from_numpy_u32(zl_np, dev)
    assert torch.equal(zl, z) and meta["r1cs_fingerprint"] == fp
    sat_l = Satisfier(loaded, False)
    got, _ = run(lambda: (sat_l.is_satisfied(zl), sat_l.which_is_unsatisfied(zl), sat_l.is_satisfied(bad),
                          sat_l.which_is_unsatisfied(bad)))
    assert got == (True, None, False, f"constraint #{row}"), got
    print(f"[api] serialize: the chain's R1CS ({sizes[0]} B) and witness ({sizes[1]} B) saved and loaded in "
          f"{t_io:.2f} s, fingerprint {fp}; the loaded z bit-equal, Satisfier(loaded, False) verdicts {got}")


def api_path(dev, card, bound, tables, built, sha_template, sha_prog):
    """The reference's device-layer API, each call as a program written
    against bellpepper_tpu writes it (no device: the card)."""
    p = SCALAR.p
    run = PathCounts()
    phase_report(reset=True)
    api_satisfier_routes(dev, card, bound, tables, run)
    torch.cuda.empty_cache()

    # the flagship, reference-style
    before = default_config()
    set_default_config(Config(use_pallas=True))
    cfg = default_config()
    free_np, free = sha256_free(dev)
    with phase("sha256 step", trace=True):
        step = build_packed_production_step(sha_prog, sha_template, B, cfg.use_pallas)  # B = 32768
        step(free)
        torch.cuda.synchronize()
    verdict, counts = run(lambda: tuple(int(v) for v in step(free)))
    assert verdict == PROBES["sha256"]["verdict"], (verdict, PROBES["sha256"])
    vals0 = build_packed_chunked_witness(sha_prog)(free)[0]
    check = build_templated_check(sha_template, B, cfg.use_pallas, "bits_packed")
    vbad = vals0.clone()
    vbad[(B // 32) // 2, 600] ^= 1 << 7
    corrupt, _ = run(lambda: tuple(int(v) for v in check.verdict(vbad)))
    assert corrupt == PROBES["sha256"]["corrupt"], (corrupt, PROBES["sha256"])
    set_default_config(before)
    print(f"[api] sha256 step written reference-style under Config(use_pallas=True): verdict {verdict}, the "
          f"corrupted chunk's {corrupt}, both equal to the sha256 phase's; launches {counts}")
    del step, vals0, vbad, check
    torch.cuda.empty_cache()

    # config 1 in the limbs form through PipelinedSatisfier, and run()
    template, prog = built["config1"]
    free_np1 = np.random.default_rng(5).integers(0, 2, size=(N_CHUNKS, B_FIELD, 128)).astype(np.uint32)
    free1 = from_numpy_u32(free_np1, dev)
    ev = prog.build(True)
    z4 = torch.stack([prog.z_template_limbs(*ev(f)) for f in free1])
    with phase("PipelinedSatisfier config1 build"):
        psat = PipelinedSatisfier(template, B_FIELD, N_CHUNKS, config=Config(use_pallas=True))
    ok, counts = run(lambda: psat.is_satisfied(z4))
    pack = sorted(prog.field_rows, key=prog.field_rows.get)[0]
    chunk, inst = 2, B_FIELD // 3
    z4[chunk, inst, pack, 2] ^= 1
    name, _ = run(lambda: psat.which_is_unsatisfied(z4))
    row, _n = python_int_first_bad(template, to_u32(z4[chunk, inst]).cpu().numpy(), pack)
    assert ok and psat.witness_form == "limbs" and name == f"chunk {chunk}: instance {inst}: constraint #{row}", (
        ok, name, row)
    t_chk = wall_s(lambda: psat.is_satisfied(z4), 3)
    print(f"[api] PipelinedSatisfier(config1, {B_FIELD}, {N_CHUNKS}, config=Config(use_pallas=True)): clean, a "
          f"flipped limb of pack slot {pack} named {name!r} as over the Python ints; check {t_chk:.4f} s; "
          f"launches of the clean check {counts}, on {card}")
    del z4, psat
    (vals, flimbs), counts = run(lambda: prog.run(free_np1[0]))
    want_v, want_f = ev(free1[0])
    assert torch.equal(vals, want_v) and torch.equal(flimbs, want_f)
    print(f"[api] WitnessProgram.run on config 1 at {B_FIELD}: vals and flimbs equal to build()'s evaluator; "
          f"launches {counts}")

    be = get_backend(SCALAR)
    top = p >> 240
    rng = np.random.default_rng(SEED + 21)
    x = rng.integers(0, 1 << 16, size=(MUL_POW2_N, 16), dtype=np.uint32)
    x[:, 15] = rng.integers(0, top, size=MUL_POW2_N, dtype=np.uint32)
    corners = [0, 1, 2, p - 1, p - 2, (p + 1) // 2, (1 << 240) - 1, ((top - 1) << 240) | ((1 << 240) - 1)]
    for i, c in enumerate(corners):
        x[i] = limbs(c, 16)
    a = from_numpy_u32(x, dev)
    idx = list(range(len(corners))) + [MUL_POW2_N // 2, MUL_POW2_N - 1]
    vals_a = be.from_limbs(a[idx])
    for k in MUL_POW2_K:
        got, _ = run(lambda: be.mul_pow2(a, k))
        assert be.from_limbs(got[idx]) == [v * pow(2, k, p) % p for v in vals_a], ("mul_pow2", k)
    print(f"[api] FieldBackend.mul_pow2 at [{MUL_POW2_N}, 16], k in {MUL_POW2_K}: the corner values and two "
          f"random rows equal to Python ints")
    print(f"[api] phase_report {json.dumps(phase_report(reset=True))}")
    print(f"[api] launches {run.counts}")
    assert run.counts["mul"] and run.counts["reduce_digits"] and run.counts["bitplane_eq"], run.counts
    return run.counts


# ---------------------------------------------------------------------------
# fields below 253 bits
# ---------------------------------------------------------------------------
def fields_flagship(dev, card, bound, tables, results, field):
    """The packed sha256 step over `field` at N_CHUNKS × B: its clean
    verdict and launches (below 250 bits the big rows go through
    bits_matvec_canonical and mul, from 250 bits through bits_matvec_semi
    and mulcmp), a flipped bit found at its instance and at the row the
    Python-int evaluation of that instance names, its time, rate and peak;
    then the fold matvec at every bucket of its big rows and the product
    compare at the step's shape, on a chunk whose odd words are random.
    Returns the step's launches."""
    t0 = time.time()
    nb = NativeBuilder(field)
    nb.sha256_compression([nb.alloc_bit() for _ in range(512)], nb.sha256_iv())
    template, tape = nb.finish()
    prog = WitnessProgram(tape)
    R, S = template.num_constraints, prog.num_slots
    print(f"[fields] sha256 over {field.name} ({field.NUM_BITS} bits, CAPACITY {field.CAPACITY}): {R} rows, "
          f"{S} slots, synthesized in {time.time() - t0:.2f} s")
    free_np, free = sha256_free(dev)
    step = build_packed_production_step(prog, template, B, device=dev)
    step(free)  # warm-up
    verdict, counts = path_run(step, free)
    semi = field.NUM_BITS >= 250
    fold, prod = ("bits_matvec_semi", "mulcmp") if semi else ("bits_matvec_canonical", "mul")
    other = {"bits_matvec_semi", "mulcmp", "bits_matvec_canonical", "mul"} - {fold, prod}
    print(f"[fields] sha256 {field.name} verdict {verdict} launches {counts}")
    assert verdict == (0, 0xFFFFFFFF), verdict
    assert counts["bitplane_eq"] == counts[prod] == N_CHUNKS and counts[fold] > 0, counts
    assert not any(counts[k] for k in other), counts
    Bw = B // 32
    vals0 = build_packed_chunked_witness(prog, device=dev)(free)[0]
    check = build_templated_check(template, B, None, "bits_packed", device=dev)
    assert check.big is not None and check.big.semi == semi
    assert tuple(int(v) for v in check.verdict(vals0)) == (0, 0xFFFFFFFF)
    w, slot, bit = Bw // 2, 600, 7
    vbad = vals0.clone()
    vbad[w, slot] ^= 1 << bit
    nbad, first = (int(v) for v in check.verdict(vbad))
    zi = np.zeros((S, 16), np.int64)
    zi[:, 0] = (to_u32(vbad[w]).cpu().numpy() >> bit) & 1
    row, n_ref = python_int_first_bad(template, zi, slot)
    assert row is not None and nbad > 0 and first == (32 * w + bit) * R + row, (nbad, first, row)
    print(f"[probe] sha256 {field.name}: bit {bit} of word {w} of slot {slot} flipped: n_bad {nbad}, first "
          f"instance {first // R} row {first % R}, the least of the {n_ref} rows on the slot that fails over the "
          f"Python ints")
    del vals0, vbad
    peak = perf_step(f"sha256 {field.name}", step, free, B, R, card, 3)
    del step

    rng = np.random.default_rng(SEED + 31)
    vals_p = prog.build_packed(device=dev)(free[0]).t().contiguous()  # [S_t, Bw]
    vals_p[:, 1::2] = from_numpy_u32(rng.integers(0, 1 << 32, size=(vals_p.shape[0], Bw // 2),
                                                  dtype=np.uint64).astype(np.uint32), dev)
    table = semi_buckets(f"sha256 {field.name}", vals_p, check.big, bound, library=True)
    if fold in results:
        tables[fold].append(table)
    else:
        results[fold] = table
    az, bz, cz = (check.big._matvec(name, vals_p) for name in "abc")
    N = az.shape[1]
    if semi:
        tables["mulcmp"].append(mulcmp_on(f"sha256 {field.name} big rows", az, bz, cz, bound, field))
    else:
        both_verdicts("mul's product compare", (fk.mul(az, bz, field) != cz).any(0))
        W = word_count(field.p)
        tables["mul"].append(compare(
            f"mul sha256 {field.name} big rows N={N}", lambda: fk.mul(az, bz, field),
            lambda: fk.mul_plain(az, bz, field), bound(mul_bytes(field, N), N * modmul_products(W, W, W)),
            plain_reps=2))
    print(f"[fields] sha256 {field.name}: peak {peak:.2f} GiB")
    del vals_p, az, bz, cz, check
    torch.cuda.empty_cache()
    return counts


def fields_config1(dev, card, bound, tables, field):
    """Config 1 and its num_assert_nonzero variant over `field` at
    N_CHUNKS × B_FIELD in the mixed and the limbs forms: clean verdicts,
    launches, time, rate and peak; on chunk 0 the chain held to Python
    ints at two instances, the variant's finv to pow(x, p − 2, p), a
    flipped bit of a chain row's limbs (mixed) and of a pack output's
    (limbs) found at the instance and at the row the Python-int
    evaluation of that instance names; and, for config 1, limbs_matvec at
    its limbs check's a-bucket in the form the field takes. Returns the
    launches of each (variant, form)."""
    p = field.p
    semi = field.NUM_BITS >= 250
    free_np = np.random.default_rng(5).integers(0, 2, size=(N_CHUNKS, B_FIELD, 128)).astype(np.uint32)
    free = from_numpy_u32(free_np, dev)
    launches = {}
    for name, nonzero in (("config1", False), ("variant", True)):
        template, prog = config1(nonzero, field)
        R = template.num_constraints
        for form in ("mixed", "limbs"):
            key = f"{name} {form} {field.name}"
            step = build_production_step(prog, template, B_FIELD, None, form, device=dev)
            step(free)  # warm-up
            verdict, counts = path_run(step, free)
            print(f"[fields] {key} verdict {verdict} launches {counts}")
            assert verdict == (0, 0xFFFFFFFF), verdict
            # config 1's field steps run as the chain kernel, the variant's
            # as 60 fmul launches a chunk and its finv's ladder of mul
            assert (counts["mul"] >= 60 * N_CHUNKS) if nonzero else (counts["chain"] == N_CHUNKS), counts
            assert (counts["mulcmp"] + counts["operand_mulcmp"] > 0) == semi and (semi or counts["mul"] > 0), counts
            launches[key] = counts
            perf_step(key, step, free, B_FIELD, R, card, 3)
            del step
        ev = prog.build(device=dev)
        vals0, fl0 = ev(free[0])
        if nonzero:  # the variant: its last x and its finv
            fin = next(st for st in prog.stages if st.opcode == "finv")
            x_row, inv_row = int(fin.arrs["a_idx"][0]), int(fin.outs[0])
            for i in (0, B_FIELD - 1):
                x = chain_steps(free_np[0, i], field)[-1][2]
                got = [col_int(fl0[i, row].reshape(16, 1), 0) for row in (x_row, inv_row)]
                assert got == [x, pow(x, p - 2, p)], ("finv probe", field.name, i)
        else:  # config 1: every step of the chain kernel's output
            rows = _detect_linear_chain([st for st in prog.stages if st.opcode in SCAN_OPS])["out_rows"]
            for i in (0, B_FIELD - 1):
                for r, want in enumerate(chain_steps(free_np[0, i], field)):
                    got = [col_int(fl0[i, int(rows[3 * r + j])].reshape(16, 1), 0) for j in range(3)]
                    assert got == want, ("chain probe", field.name, i, r)
        mixed = build_templated_check(template, B_FIELD, None, "mixed", field_slots=prog.field_slots, device=dev)
        i, mid = B_FIELD // 2, sorted(prog.field_rows.values())[45]
        fbad = fl0.clone()
        fbad[i, mid, 0] ^= 1
        nbad, first = (int(v) for v in mixed.verdict(vals0, fbad))
        row, _ = python_int_first_bad(template, to_u32(prog.z_template_limbs(vals0, fbad)[i]).cpu().numpy(),
                                      prog.field_slots[mid])
        assert row is not None and nbad > 0 and first == i * R + row, (nbad, first, row)
        z = prog.z_template_limbs(vals0, fl0)
        limbs_check = build_templated_check(template, B_FIELD, None, "limbs", device=dev)
        i2, pack = B_FIELD // 4, sorted(prog.field_rows, key=prog.field_rows.get)[0]
        z[i2, pack, 2] ^= 1
        nbad2, first2 = (int(v) for v in limbs_check.verdict(z))
        row2, _ = python_int_first_bad(template, to_u32(z[i2]).cpu().numpy(), pack)
        assert row2 is not None and nbad2 > 0 and first2 == i2 * R + row2, (nbad2, first2, row2)
        held = ("the finv of 2 instances equals pow(x, p - 2, p) of the chain" if nonzero
                else "the chain of 2 instances equals x <- ((x*b + a) mod p)^2 mod p")
        print(f"[probe] {name} {field.name}: {held}; a flipped bit of field row {mid} at instance "
              f"{i} found by the mixed check at row {first % R}, of pack slot {pack} at instance {i2} by the limbs "
              f"check at row {first2 % R}, the rows the Python ints name")
        if not nonzero:
            cols, F = max(limbs_check.fold.mats["a"], key=lambda t: t[0].shape[1])
            zt = z.permute(1, 2, 0).contiguous()
            tables["limbs_matvec"].append(limbs_matvec_at(
                f"config1 {field.name} a-bucket", zt, cols, F, ("semi" if semi else "canonical",), bound,
                field=field))
            del zt
        del vals0, fl0, fbad, z, mixed, limbs_check
        torch.cuda.empty_cache()
    return launches


def fields_satisfier(dev, card, field):
    """The Satisfier of the 16-block sha256 chain over `field` by both
    routes (the templated limbs route, then DeviceR1CS): build seconds,
    the clean witness satisfied, a bit slot of block 9 set to a random
    field element named at the row the Python-int evaluation names, check
    seconds, peak and launches. Returns the launches of each route's
    clean check."""
    t0 = time.time()
    template, prog = satisfier_chain_synth(field)
    R = template.num_constraints
    z, bad, slot, block, row, n_ref = satisfier_chain_witness(template, prog, dev)
    print(f"[fields] sha256 chain of {CHAIN_BLOCKS} over {field.name}: {R} rows; synthesized and evaluated in "
          f"{time.time() - t0:.2f} s")
    launches = {}
    for use_pallas, label in ((None, "templated"), (False, "DeviceR1CS")):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        sat = Satisfier(template, use_pallas, device=dev)
        torch.cuda.synchronize()
        t_build = time.time() - t0
        fk.reset_launch_counts()
        ok = sat.is_satisfied(z)
        counts = fk.launch_counts()
        name = sat.which_is_unsatisfied(bad)
        assert ok and name == f"constraint #{row}", (label, ok, name, row)
        assert counts["mul"] > 0 and counts["reduce_digits"] > 0 and not counts["mulcmp"], counts
        if use_pallas is False:
            assert (counts["mul"], counts["reduce_digits"]) == (4, 3), counts
        t_chk = wall_s(lambda: sat.is_satisfied(z), 3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[fields] satisfier {label} {field.name}: built in {t_build:.4f} s, check {t_chk:.4f} s, peak "
              f"{peak:.3f} GiB, launches {counts}; bit slot {slot} of block {block} set to a random field element "
              f"named {name!r}, the least of the {n_ref} rows on the slot that fails over the Python ints, on {card}")
        launches[f"satisfier {label} {field.name}"] = counts
        del sat
        torch.cuda.empty_cache()
    return launches


def fields_config5(dev, card, bound, tables, field):
    """Config 5's generator at 2^FIELDS_C5_LOG2_R rows over `field` (below
    250 bits its check takes the canonical route): the completion and the
    check at the benchmark's rows a chunk, clean, their launches and
    seconds, the completed product at sampled rows against Python ints,
    z[5, 0] flipped found at the row numpy names; mul on a premul slice
    of the raw z and on a product chunk, reduce_digits on that chunk's A
    digit sums in both layouts. Returns the launches of one completion
    and one check."""
    p = field.p
    r1cs, zfree, N0, t_build = c5.config5_r1cs(FIELDS_C5_LOG2_R, field=field)
    R = r1cs.num_constraints
    n_chk, n_wit = max(1, R >> c5.LOG2_RPC_CHECK), max(1, R >> c5.LOG2_RPC_WIT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    check_fn, prep = build_row_chunked_check(r1cs, n_chk, device=dev)
    meta = check_fn._layout_meta
    prod_fn, prep_ab = build_row_chunked_product(r1cs, n_wit, reuse=(meta, prep), device=dev)
    torch.cuda.synchronize()
    t_layout = time.time() - t0
    assert check_fn._route == ("semi" if field.NUM_BITS >= 250 else "canonical"), check_fn._route
    z = c5.config5_z(zfree, R, dev)
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    z[N0 + 1 :] = prod_fn(z, prep_ab)
    verdict = tuple(int(x) for x in check_fn(z, prep))
    counts = fk.launch_counts()
    print(f"[fields] config5 {field.name} R={R} ({check_fn._route} route): verdict {verdict} launches {counts}")
    assert verdict == (0, 0xFFFFFFFF), verdict
    assert counts["mul"] >= n_wit and counts["reduce_digits"] >= 2 * n_wit and not counts["mulcmp"], counts
    t_wit = wall_s(lambda: prod_fn(z, prep_ab), 3)
    t_chk = wall_s(lambda: check_fn(z, prep), 5)
    peak = torch.cuda.max_memory_allocated() / 2**30
    rows = np.sort(np.random.default_rng(SEED + 33).choice(R, 1024, replace=False))
    slots = np.concatenate([r1cs.a.cols[2 * rows], r1cs.a.cols[2 * rows + 1], r1cs.b.cols[rows], N0 + 1 + rows])
    sums = row_sums_int(r1cs, z_ints(z, slots), rows)
    assert all(sa * sb % p == sc for sa, sb, sc in zip(sums["a"], sums["b"], sums["c"])), "config5 product"
    zb = z.clone()
    zb[c5.FLIP_SLOT, 0] ^= 1
    bad = tuple(int(x) for x in check_fn(zb, prep))
    row = c5.flipped_first_row(r1cs, c5.FLIP_SLOT)
    assert bad[0] > 0 and bad[1] == row, (bad, row)
    print(f"[fields] config5 {field.name} R={R}: host build {t_build:.3f} s, layouts {t_layout:.3f} s, completion "
          f"{t_wit:.4f} s, check {t_chk:.4f} s = {R / t_chk:.4e} constraint-evals/s, peak {peak:.2f} GiB; the "
          f"product at 1,024 sampled rows equals A·z · B·z over the Python ints; z[{c5.FLIP_SLOT}, 0] ^= 1 gives "
          f"{bad}, row {row} as numpy names it; on {card}")
    del zb
    W = word_count(p)
    cl = prep["coeff_limbs"]
    ew, _ = build_row_chunked_eval(r1cs, n_wit, names=("a", "b"), reuse=(meta, prep), device=dev)
    zsrc = ew._zsrc(z, cl)
    if meta["premul"] and ew.span:
        k = max(ew.span)
        n = ew.span[k]
        zk = z[:n].t().contiguous()
        ck = cl[k][:, None].expand(16, n).contiguous()
        vals = [col_int(zk, i) for i in range(64)]
        assert any(v >= p for v in vals), "config 5's raw z holds values in [p, 2^256)"
        got = fk.mul(zk, ck, field)
        cv = limb_int(to_u32(cl[k]).tolist())
        assert all(col_int(got, i) == v * cv % p for i, v in enumerate(vals)), "mul on raw z"
        tables["mul"].append(compare(f"mul config5 {field.name} premul raw z N={n}", lambda: fk.mul(zk, ck, field),
                                     lambda: fk.mul_plain(zk, ck, field),
                                     bound(mul_bytes(field, n), n * modmul_products(8, W, W)), plain_reps=2))
        del zk, ck, got
    x0 = _chunk(ew._xs(prep, ("a", "b")), 0)
    az, bz = ew._blocks(zsrc, cl, x0, ("a", "b"))
    n = az.shape[1]
    tables["mul"].append(compare(f"mul config5 {field.name} product chunk N={n}", lambda: fk.mul(az, bz, field),
                                 lambda: fk.mul_plain(az, bz, field),
                                 bound(mul_bytes(field, n), n * modmul_products(W, W, W)), plain_reps=2))
    em = _ell_digit_sums(ew._gathered(zsrc, cl, x0[0], "a"), 2)
    for layout, d in (("element-major", em.t()), ("limb-major", em.t().contiguous())):
        tables["reduce_digits"].append(compare(
            f"reduce_digits config5 {field.name} product chunk A digit sums {layout} N={n}",
            lambda: fk.reduce_digits(d, field), lambda: fk.reduce_digits_plain(d, field),
            bound((32 + 16) * 4 * n, n * digit_reduce_products(field)), plain_reps=2))
    del z, zsrc, az, bz, em, d, prep, prep_ab, check_fn, prod_fn, ew
    torch.cuda.empty_cache()
    return counts


def fields_path(dev, card, bound, tables, results):
    """The port over two fields below 253 bits (fields_flagship,
    fields_config1, fields_satisfier, fields_config5): Goldilocks, where
    every check goes canonical, and Jubjub's scalar field, in the
    250-252-bit window where the semi routes apply but the TPU's
    quotient estimate does not; then mul, chain, mul_digits and
    reduce_digits at the paths' shapes at both fields, against their
    plain versions and Python ints. Returns {path: launches}."""
    t_phase = time.time()
    launches = {}
    for field in SMALL_FIELDS:
        launches[f"sha256 {field.name}"] = fields_flagship(dev, card, bound, tables, results, field)
        launches.update(fields_config1(dev, card, bound, tables, field))
    launches.update(fields_satisfier(dev, card, GOLDILOCKS))
    launches[f"config5 {GOLDILOCKS.name}"] = fields_config5(dev, card, bound, tables, GOLDILOCKS)
    for field in SMALL_FIELDS:
        rng = np.random.default_rng(SEED + field.p % 1009)
        # a step's four chunks in one launch: at 8,192 instances a small
        # field's chain writes 47 MB, which the 50 MB L2 can hold across
        # back-to-back launches, under the bytes bound's HBM rate
        tables["chain"].append(chain_at(f"chain {field.name} N={N_CHUNKS * B_FIELD}", dev, bound, field,
                                        N_CHUNKS * B_FIELD))
        for n in (B_FIELD, CHAIN_ROWS_N):
            tables["mul"].append(mul_at(f"mul {field.name} N={n}", n, dev, bound, rng, field))
        tables["mul_digits"].append(mul_digits_at(f"mul_digits {field.name} N={MUL_DIGITS_N}", MUL_DIGITS_N, dev,
                                                  bound, rng, field, device_timed=False))
        for n, layout in ((CHAIN_ROWS_N, "limb-major"), (MUL_WIDE_N, "element-major")):
            tables["reduce_digits"].append(reduce_digits_at(f"reduce_digits {field.name}", n, layout, dev, bound,
                                                            field, device_timed=False))
        torch.cuda.empty_cache()
    print(f"[fields] phase {time.time() - t_phase:.1f} s, on {card}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: nothing runs on the CPU", file=sys.stderr)
        return 1
    card = card_line()
    print(f"[card] {card}")
    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    max_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} device {kind}; "
          f"max SM clock {max_mhz:.0f} MHz, SM clock now {nvidia_smi('clocks.sm')}")
    bound = Bound(max_mhz)

    t0 = time.time()
    lib = cuda_lib.load_kernels()
    ptxas = [f"{src}: " + " | ".join(ln.strip() for ln in log.splitlines()
                                     if "registers" in ln or "spill" in ln)
             for src, log in sorted(lib.build_log.items())]
    print(f"[build] kernels built in {time.time() - t0:.1f} s; ptxas: {' || '.join(ptxas)}")
    for name, src, kernel, targs in (("mul", "mul16.cu", "mul_kernel", "ILb0E"),
                                     ("mul_digits", "mul16.cu", "mul_kernel", "ILb1E"),
                                     ("reduce_digits limb-major", "reduce_digits.cu", "reduce_digits_kernel", "ILb0E"),
                                     ("reduce_digits element-major", "reduce_digits.cu", "reduce_digits_kernel",
                                      "ILb1E")):
        print(f"[build] {name} ({src} {kernel}{targs}): {kernel_ptxas(lib.build_log.get(src, ''), kernel, targs)}")

    template, prog = sha256_path(dev, card)
    built = field_synth()
    t0 = time.time()
    sha_limbs = build_templated_check(template, B_SHA_LIMBS, None, "limbs", device=dev)
    config1_fold = build_templated_check(built["config1"][0], B_FIELD, None, "limbs", device=dev).fold
    print(f"[step] limbs checks of sha256 at {B_SHA_LIMBS} and config 1 at {B_FIELD} built in "
          f"{time.time() - t0:.2f} s (fold tables included)")
    results = sha256_kernels(dev, bound, template, prog)
    results.update(field_kernels(dev, bound))
    tables = {k: [] for k in fk.KERNELS}
    results.update(limbs_kernels(dev, bound, sha_limbs, config1_fold, tables))
    del sha_limbs, config1_fold  # the steps' peaks count only their own tables
    op_rate_probe(bound)
    torch.cuda.empty_cache()
    launches = {"sha256": sha256_step(dev, card, template, prog)}
    torch.cuda.empty_cache()
    launches.update(field_steps(dev, card, built, bound, tables))
    torch.cuda.empty_cache()
    launches["minroot"], results["operand_mulcmp"] = minroot_path(dev, card, bound)
    torch.cuda.empty_cache()
    launches["config1_limbs"] = config1_limbs_step(dev, card, built, bound, tables)
    torch.cuda.empty_cache()
    launches["sha256_limbs"] = sha256_limbs_step(dev, card, bound, template, prog)
    torch.cuda.empty_cache()
    launches["satisfier"] = satisfier_chain(dev, card)
    torch.cuda.empty_cache()
    for path, (template_b, prog_b) in bit_synth().items():
        seed = {"config2": CONFIG2_SEED, "config3": CONFIG3_SEED}.get(path, SEED + 8)
        launches[path] = packed_bit_step(dev, card, bound, path, template_b, prog_b, seed, tables)
        torch.cuda.empty_cache()
    assert launches["config2"]["bitplane_eq"] == launches["config3"]["bitplane_eq"] == N_CHUNKS
    assert (launches["blake2s"]["bits_matvec_semi"], launches["blake2s"]["mulcmp"]) == (4 * N_CHUNKS, N_CHUNKS)
    launches.update(frontend_path(dev, card, bound, tables))
    launches["sha256_bits"] = sha256_bits_step(dev, card, bound, template, prog, tables)
    torch.cuda.empty_cache()
    chain_built, iv_bits = chain_synth()
    launches["chained"] = chained_paths(dev, card, bound, tables, chain_built, iv_bits)
    torch.cuda.empty_cache()
    launches["merkle"] = merkle_path(dev, card, bound, tables, chain_built)
    torch.cuda.empty_cache()
    launches["num_family"] = num_family_step(dev, card, bound, tables)
    torch.cuda.empty_cache()
    launches["config5"] = config5_path(dev, card, bound, tables)
    torch.cuda.empty_cache()
    launches["row_sharded"] = row_sharded_path(dev, card, bound, tables)
    torch.cuda.empty_cache()
    launches.update(sharding_path(dev, card, tables, max_mhz))
    torch.cuda.empty_cache()
    launches["api"] = api_path(dev, card, bound, tables, built, template, prog)
    torch.cuda.empty_cache()
    launches.update(fields_path(dev, card, bound, tables, results))
    torch.cuda.empty_cache()
    device_times(dev)

    kernels = []
    for k in fk.KERNELS:
        by_path = {path: counts[k] for path, counts in launches.items() if counts[k]}
        kernels.append({
            "name": k, "route": "cuda", "source": KERNEL_INFO[k][0],
            "replaces": KERNEL_INFO[k][1], "launches": sum(by_path.values()),
            "launches_by_path": by_path, **{key: results[k][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "other_tables": tables[k],
        })
        assert all(t["max_abs_err"] == 0 for t in tables[k]), k
        assert by_path, f"{k} was not launched on any path"
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
