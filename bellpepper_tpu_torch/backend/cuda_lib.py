"""Build and load the port's CUDA kernels (``bellpepper_tpu_torch/csrc``).

Each ``.cu`` file compiles with nvcc into its own shared library with a
plain C interface for ``sm_90a``; the nvcc processes of all sources start
together, so the build takes about as long as its slowest file. A library
lands in the package's build directory under a name keyed by a content
hash of its source, the shared headers and the flags, so a changed source
rebuilds and an unchanged one loads at once. Each C entry point takes
device pointers, sizes and the CUDA stream, launches, and returns
``cudaGetLastError()``.

Nothing here runs at import: the first call of ``load_kernels`` builds."""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")  # the native library's build directory too
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_vp, _i64, _i32, _u64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint64
# C entry points and their argument types (pointers and the stream as
# void*, sizes as the C side declares them).
ENTRY_POINTS = {
    "bp_bitplane_eq": [_vp, _vp, _vp, _i32, _i64, _i32, _i32, _i32, _i32, _vp],
    "bp_fold_matvec": [_vp, _vp, _vp, _vp, _i32, _i32, _i32, _i64, _i64, _i32, _i32, _i32, _vp, _vp],
    "bp_mulcmp": [_vp, _vp, _vp, _vp, _i64, _vp, _vp],
    "bp_chain": [_vp, _vp, _vp, _i64, _i32, _i32, _u64, _u64, _u64, _vp, _vp],
    "bp_mul16": [_vp, _vp, _vp, _i64, _vp, _vp],
    "bp_mul_digits": [_vp, _vp, _vp, _i64, _vp, _vp],
    "bp_reduce_digits": [_vp, _vp, _i64, _i32, _vp, _vp],
    "bp_op_rate": [_vp, _vp, _i32, _i64, _i32, _i32, _vp],
    "bp_verdict_fold": [_vp, _i64, _i64, _i64, _i32, _i64, _vp, _i64, _vp, _i32, _vp],
    "bp_operand_mulcmp": [_vp, _vp, _vp, _vp, _vp, _i64, _i64, _vp, _vp],
    "bp_addmany_packed": [_vp, _i64, _vp, _vp, _i64, _i32, _i32, _i32, _vp],
}

_lib = None


class Kernels:
    """The loaded kernel libraries: each entry point is an attribute;
    ``build_log`` maps a source's name to nvcc's output (the ptxas
    register and spill report) when this process built it."""

    def __init__(self, libs, build_log):
        self.build_log = build_log
        for name, args in ENTRY_POINTS.items():
            found = [getattr(lib, name) for lib in libs if hasattr(lib, name)]
            if len(found) != 1:
                raise RuntimeError(f"{name}: defined {len(found)} times in the kernel libraries")
            fn = found[0]
            fn.restype = ctypes.c_int
            fn.argtypes = args
            setattr(self, name, fn)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _library_path(source: str, headers) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source, *headers]:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"bp_{stem}-{h.hexdigest()[:16]}.so")


def load_kernels() -> Kernels:
    """The loaded kernels, building the missing libraries first (all
    nvcc processes in parallel)."""
    global _lib
    if _lib is not None:
        return _lib
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    targets = {src: _library_path(src, headers) for src in sources}
    jobs = {}
    log = {}
    try:
        for src, so in targets.items():
            if os.path.exists(so):
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            jobs[src] = (proc, tmp)
        failed = []
        for src, (proc, tmp) in jobs.items():
            out, _ = proc.communicate()
            log[os.path.basename(src)] = out
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)}:\n{out}")
            else:
                os.replace(tmp, targets[src])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    finally:
        for proc, tmp in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    _lib = Kernels([ctypes.CDLL(so) for so in targets.values()], log)
    return _lib
