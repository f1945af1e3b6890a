"""Build and load the CUDA kernels: ``nvcc`` into a shared library with a
plain C interface, bound with ``ctypes``.

Counterpart of what XLA's compile cache did for the JAX package
(``tpuminter.xla_cache``), with one difference that matters: the
kernels take the job's message template as a runtime argument, so a
machine builds them once, not once per job. The library goes into
``build/tpuminter_torch/`` at the repository root, named by a hash of
the source and the flags, and is built at first use: importing this
module builds nothing. No CUDA toolkit means a clear ``RuntimeError``;
there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = ["BuildInfo", "build", "library", "TmTemplate", "TmTarget"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "sha256.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpuminter_torch"
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class TmTemplate(ctypes.Structure):
    """Mirror of ``struct TmTemplate`` in ``csrc/sha256.cu``."""

    _fields_ = [
        ("mid", ctypes.c_uint32 * 8),
        ("tail", ctypes.c_uint32 * 32),
        ("pos_word", ctypes.c_int32 * 8),
        ("pos_wshift", ctypes.c_int32 * 8),
        ("pos_nshift", ctypes.c_int32 * 8),
        ("n_pos", ctypes.c_int32),
        ("n_blocks", ctypes.c_int32),
        ("dbl", ctypes.c_int32),
    ]


class TmTarget(ctypes.Structure):
    """Mirror of ``struct TmTarget``: msb-first target words."""

    _fields_ = [("w", ctypes.c_uint32 * 8)]


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc/ptxas output (registers, spills) of this build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


@functools.lru_cache(maxsize=None)
def build() -> BuildInfo:
    """Compile ``csrc/sha256.cu`` unless this source and these flags are
    already built. The output is written under a temporary name and
    renamed, so processes building at once never load a partial file."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"tm_sha256_{tag}.so"
    if path.exists():
        return BuildInfo(path, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    start = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return BuildInfo(path, time.perf_counter() - start, proc.stdout + proc.stderr)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point declared."""
    lib = ctypes.CDLL(str(build().path))
    ptr, u32, i32, i64 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int, ctypes.c_int64
    tmpl = ctypes.POINTER(TmTemplate)
    signatures = {
        "tm_sha256_batch": [tmpl, ptr, ptr, ptr, i64, i32, ptr],
        "tm_search_candidates": [tmpl, u32, u32, u32, ptr, i32, i32, ptr],
        "tm_search_target": [
            tmpl, ctypes.POINTER(TmTarget), u32, u32, ptr, ptr, i32, i32, ptr,
        ],
        "tm_min_toy": [tmpl, u32, u32, u32, ptr, ptr, i32, i32, ptr],
        "tm_search_candidates_hdr": [ptr, ptr, u32, u32, u32, ptr, i32, i32, ptr],
        "tm_search_candidates_hdr_batch": [
            ptr, ptr, ptr, ptr, i32, u32, u32, i32, ptr, i32, i32, ptr,
        ],
        "tm_extranonce_roll": [ptr, i32, i32, i32, ptr, ptr, ptr, ptr, i32, i32, ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
