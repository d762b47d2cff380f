"""Build and load the port's CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into its own
shared library with a plain C interface, at first use, and loaded with
``ctypes``. Libraries go to ``build/kernels/`` at the repository root, keyed
by a hash of the source and the flags, so an edited source rebuilds and an
unchanged one is reused.

Flags: ``sm_90a`` (Hopper, with its ``wgmma``/``setmaxnreg`` target), and
``--fmad=false`` with no fast math, so that the compress, scan and Mamba-1
discretize kernels round exactly as their plain PyTorch versions do. The
flash-attention kernel, held to a tolerance instead, does its products on
the tensor cores (``wgmma`` for bf16, ``mma.sync`` 3xTF32 for fp32), which
the flag does not touch; it gets ``cuTensorMapEncodeTiled`` through the
runtime's ``cudaGetDriverEntryPoint``, so no library links ``libcuda``.
``-Xptxas=-v`` writes each kernel's registers and spills into the build log.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xptxas=-v",  # registers, shared memory and spills into the build log
    "-shared", "-Xcompiler", "-fPIC",
)
# C signatures: every pointer and the stream as c_void_p (a ctypes array of
# int64 strides too), ints as c_int.
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "compress": {
        "compress_rows_f32": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
        "compress_rows_dp_f32": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
        "compress_body_info": ([_I, _P], _I),
        "cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "flash_attention": {
        "flash_attention_fwd": ([_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _I, _P], _I),
        "cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "mamba1_discretize": {
        "mamba1_discretize_fwd": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P], _I),
        "mamba1_discretize_bwd": ([_P] * 12 + [_I] * 7 + [_P, _P], _I),
        "cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "ssm_scan": {
        "ssm_scan_fwd": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
        "ssm_scan_bwd": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
        "cuda_error_string": ([_I], ctypes.c_char_p),
    },
}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def nvcc_command(source, output, nvcc: str = "nvcc") -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> float:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    seconds nvcc took (0.0 for a library already built)."""
    out = library_path(name)
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = nvcc_command(CSRC / f"{name}.cu", tmp, find_nvcc())
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    out.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a library
    return seconds


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/shared-memory report) of the last build."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build(name)
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib
