"""Device layer of the port: the word contract, host-side layouts, the
CUDA field kernels and the templated checks.

  - words.py         — int32 words holding uint32 bit patterns
  - field_consts.py  — per-field integer constants of the kernels
  - layout.py        — numpy row classifiers and ELL layouts
  - field_kernels.py — kernel wrappers, plain versions, launch counts
  - field_backend.py — field arithmetic on [..., 16] limb tensors
  - cuda_lib.py      — nvcc build and ctypes load of ``csrc/``
  - check_common.py  — verdict sentinels and trivial-row limb operands
  - matvec.py        — the bits_packed and mixed checks and their verdicts
  - limbs.py         — the limbs checks
  - satisfier.py     — Satisfier and TemplatedSatisfier
  - row_chunked.py   — one huge R1CS: the monolithic and row-chunked
                       evaluators, the product and the check
  - row_sharded.py   — one huge R1CS split into row shards
"""

from .matvec import MixedCheck, PackedBitsCheck, build_templated_check

__all__ = ["MixedCheck", "PackedBitsCheck", "build_templated_check"]
