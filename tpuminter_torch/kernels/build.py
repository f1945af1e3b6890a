"""Build and load the CUDA kernels: ``nvcc`` into shared libraries with a
plain C interface, bound with ``ctypes``.

Counterpart of what XLA's compile cache did for the JAX package
(``tpuminter.xla_cache``), with one difference that matters: the
kernels take the job's message template as a runtime argument, so a
machine builds them once, not once per job. Each source under
``csrc/`` becomes its own library in ``build/tpuminter_torch/`` at the
repository root, named by a hash of that source and the flags; the
first use builds every library not built yet, one ``nvcc`` per source,
all started together. Importing this module builds nothing. No CUDA
toolkit means a clear ``RuntimeError``; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

__all__ = ["BuildInfo", "build", "library", "SOURCES", "TmTemplate", "TmTarget", "TmHeader",
           "TmToy", "TmScryptHeader", "TmScryptKey"]

_CSRC = Path(__file__).resolve().parent / "csrc"
#: library name -> its source
SOURCES = {"sha256": _CSRC / "sha256.cu", "splitmix": _CSRC / "splitmix.cu",
           "scrypt": _CSRC / "scrypt.cu", "probes": _CSRC / "probes.cu"}
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
    """Mirror of ``struct TmTarget`` (``csrc/sha256.cu``, ``csrc/scrypt.cu``):
    msb-first target words."""

    _fields_ = [("w", ctypes.c_uint32 * 8)]


class TmHeader(ctypes.Structure):
    """Mirror of ``struct TmHeader`` in ``csrc/sha256.cu``: an 80-byte
    header's midstate and tail words t0..t2."""

    _fields_ = [("mid", ctypes.c_uint32 * 8), ("t", ctypes.c_uint32 * 3)]


class TmToy(ctypes.Structure):
    """Mirror of ``struct TmToy`` in ``csrc/sha256.cu``: a toy template
    with its high nonce word fixed (``ops.sha256.ToyLaunch``)."""

    _fields_ = [("mid", ctypes.c_uint32 * 8), ("m", ctypes.c_uint32 * 16),
                ("m1", ctypes.c_uint32 * 3), ("shift", ctypes.c_uint32)]


class TmScryptHeader(ctypes.Structure):
    """Mirror of ``struct TmScryptHeader`` in ``csrc/scrypt.cu``: the
    76-byte header prefix as 19 big-endian words."""

    _fields_ = [("w", ctypes.c_uint32 * 19)]


class TmScryptKey(ctypes.Structure):
    """Mirror of ``struct TmScryptKey`` in ``csrc/scrypt.cu``: SHA-256's
    state after the header's first 64 bytes (``ops.scrypt.key_state``)."""

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


def _path(name: str) -> Path:
    # the headers of csrc/ that the source includes are hashed with it
    source = SOURCES[name].read_bytes()
    headers = re.findall(rb'^#include "([^"]+)"', source, re.M)
    text = b"".join([source, *((_CSRC / h.decode()).read_bytes() for h in headers)])
    tag = hashlib.sha256(text + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"tm_{name}_{tag}.so"


@functools.lru_cache(maxsize=None)
def build() -> Dict[str, BuildInfo]:
    """Compile every source whose library (for this source and these
    flags) is not built yet, one ``nvcc`` each, all at once. Each output
    is written under a temporary name and renamed, so processes building
    at once never load a partial file."""
    infos, running = {}, {}
    for name in SOURCES:
        path = _path(name)
        if path.exists():
            infos[name] = BuildInfo(path, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = tempfile.TemporaryFile("w+")
        proc = subprocess.Popen([_nvcc(), *FLAGS, "-o", str(tmp), str(SOURCES[name])],
                                stdout=log, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, log, tmp, path, time.perf_counter())
    failed = []
    while running:
        for name, (proc, log, tmp, path, start) in list(running.items()):
            if proc.poll() is None:
                continue
            seconds = time.perf_counter() - start
            del running[name]
            with log:
                log.seek(0)
                text = log.read()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {SOURCES[name].name} ({proc.returncode}):\n{text}")
                continue
            os.replace(tmp, path)
            infos[name] = BuildInfo(path, seconds, text)
        time.sleep(0.05)
    if failed:
        raise RuntimeError("\n".join(failed))
    return infos


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``SOURCES[name]``, with every entry
    point declared."""
    lib = ctypes.CDLL(str(build()[name].path))
    ptr, u32, i32, i64 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int, ctypes.c_int64
    tmpl = ctypes.POINTER(TmTemplate)
    signatures = {
        "sha256": {
            "tm_sha256_batch": [tmpl, ptr, ptr, ptr, i64, i32, ptr],
            "tm_search_candidates": [tmpl, u32, u32, u32, ptr, i32, i32, ptr],
            "tm_search_candidates_header": [
                ctypes.POINTER(TmHeader), u32, u32, u32, ptr, i32, i32, ptr,
            ],
            "tm_search_target": [
                tmpl, ctypes.POINTER(TmTarget), u32, u32, ptr, ptr, i32, i32, ptr,
            ],
            "tm_search_target_header": [
                ctypes.POINTER(TmHeader), ctypes.POINTER(TmTarget), u32, u32, ptr, ptr, i32,
                i32, ptr,
            ],
            "tm_min_toy": [tmpl, u32, u32, u32, ptr, ptr, i32, i32, ptr],
            "tm_min_toy_toy": [
                ctypes.POINTER(TmToy), ctypes.POINTER(TmToy), i32, u32, u32, u32, ptr, ptr,
                i32, i32, i32, ptr,
            ],
            "tm_search_candidates_hdr": [ptr, ptr, u32, u32, u32, ptr, i32, i32, ptr],
            "tm_search_candidates_hdr_batch": [
                ptr, ptr, ptr, ptr, i32, u32, u32, i32, ptr, i32, i32, ptr,
            ],
            "tm_extranonce_roll": [ptr, i32, i32, ptr, ptr, ptr, ptr, i32, i32, ptr],
            "tm_sha256_serial_floor": [i32, i32, ptr, i32, ptr],
            "tm_sha256_occupancy": [i32, i32, ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)],
        },
        "splitmix": {
            "tm_splitmix_batch": [ctypes.c_uint64, ptr, ptr, ptr, ptr, i64, i32, i32, ptr],
        },
        "scrypt": {
            "tm_scrypt_front": [ctypes.POINTER(TmScryptHeader), ptr, ptr, ptr, i32, i32, i32,
                                i32, ptr],
            "tm_romix_walk": [ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr],
            "tm_scrypt_back": [ctypes.POINTER(TmScryptHeader), ctypes.POINTER(TmScryptKey),
                               ctypes.POINTER(TmTarget), ptr, ptr, ptr, ptr, ptr, i32, i32,
                               ptr],
            "tm_row_gather": [ptr, i64, ptr, ptr, i32, i32, i32, i32, i64, i32, ptr],
            "tm_scrypt_occupancy": [i32, i32, ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)],
        },
        "probes": {
            "tm_xor_const": [ptr, ptr, i64, u32, i32, i32, i32, ptr],
            "tm_transpose_u32": [ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr],
            "tm_walk_step": [i32, i32, ptr, ptr, ptr, i32, i32, i32, i32, ptr],
        },
    }
    for fn_name, argtypes in signatures[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
