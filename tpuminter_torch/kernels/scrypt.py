"""The scrypt kernels' wrappers, their plain versions and launch counts.

Counterpart of the SCRYPT path of ``tpuminter.ops.scrypt`` and of two
Pallas probes: S1 :func:`scrypt_front` (PBKDF2-in and the ROMix fill),
kernel 19 :func:`romix_walk` (the walk, ``fused_step`` of
``scripts/walk_pallas_probe.py``), S2 :func:`scrypt_back` (PBKDF2-out
and the batch fold) and kernel 11 :func:`row_gather` (the row-gather
probe of ``scripts/romix_pallas_probe.py``, which the miner never
runs). Each runs its CUDA kernel (``csrc/scrypt.cu``) for tensors on the
card and its plain version (``ops.scrypt``) for tensors on the CPU,
chosen only by where its inputs lie; a CUDA request launches the kernel
or raises.

u32 words travel as contiguous ``int64`` tensors holding ``[0, 2^32)``:
nonces ``(B,)``, X ``(B, 32)``, digests ``(B, 8)``, the batch handle
(:data:`ops.scrypt.HANDLE_WORDS` words). V, the ROMix scratch, is the
caller's (:func:`romix_scratch`): ``(N, S, 32)`` for a lane stride ``S
>= B``, int32 bit patterns on the card (128 bytes a row, the kernels'
layout), int64 lanes on the CPU. Each wrapper's ``launches`` attribute
counts its kernel launches (plain runs are not counted).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from tpuminter_torch.kernels import build
from tpuminter_torch.kernels.sha256 import _cuda_device, _same_device, _sm_count, _stream
from tpuminter_torch.ops import scrypt as ops

__all__ = [
    "romix_scratch", "scrypt_front", "romix_walk", "scrypt_back", "row_gather",
    "scrypt_front_plain", "romix_walk_plain", "scrypt_back_plain", "row_gather_plain",
    "occupancy", "KERNELS", "THREADS", "FRONT_THREADS_PER_HASH", "WALK_THREADS_PER_HASH",
    "BACK_THREADS_PER_HASH", "THREADS_PER_HASH", "BACK_PARTIAL", "GatherGeometry",
    "gather_geometry", "GATHER_THREADS", "GATHER_PIECES", "GATHER_SLOTS_PER_SM",
]

_I64, _I32 = torch.int64, torch.int32
#: the largest lane count the kernels index with 32-bit lanes
MAX_LANES = 1 << 30
#: threads per block of every scrypt kernel (``kThreads`` in the source)
THREADS = 128
#: threads a hash of the fill (S1) and of the walk (19); S2 runs one a hash
FRONT_THREADS_PER_HASH = 4
WALK_THREADS_PER_HASH = 4
BACK_THREADS_PER_HASH = 1
#: u32 words of an S2 block's partial (``kBackPartial``)
BACK_PARTIAL = 10


def _launch(name: str, *args) -> None:
    err = getattr(build.library("scrypt"), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def _check(name: str, t: torch.Tensor, shape, dtype=_I64) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {tuple(shape)}")


def _count(nonces: torch.Tensor) -> int:
    if nonces.dim() != 1 or not 1 <= nonces.shape[0] <= MAX_LANES:
        raise ValueError(f"nonces must be 1-D with 1 to {MAX_LANES} lanes")
    _check("nonces", nonces, nonces.shape)
    return nonces.shape[0]


def _check_v(v: torch.Tensor, n_log2: int, count: int) -> int:
    """V's lane stride, after checking its shape, type and layout."""
    if not 1 <= n_log2 <= 20:
        raise ValueError("n_log2 must be in [1, 20]")
    stride = v.shape[1] if v.dim() == 3 else -1
    if stride < count:
        raise ValueError(f"V must be (2^{n_log2}, S >= {count}, 32), got {tuple(v.shape)}")
    _check("V", v, (1 << n_log2, stride, 32), _I32 if v.device.type == "cuda" else _I64)
    return stride


def _header_struct(header_words: Sequence[int]) -> build.TmScryptHeader:
    hd = build.TmScryptHeader()
    hd.w[:] = ops._header(header_words)
    return hd


def romix_scratch(n_log2: int, batch: int, device) -> torch.Tensor:
    """An uninitialised V for up to ``batch`` lanes at ``N = 2^n_log2``:
    ``batch × N × 128`` bytes on the card (8 GiB at 2^16 lanes, N =
    1024), twice that on the CPU."""
    device = torch.device(device)
    dtype = _I32 if device.type == "cuda" else _I64
    return torch.empty((1 << n_log2, batch, 32), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# S1: PBKDF2-in and the ROMix fill
# ---------------------------------------------------------------------------

def scrypt_front_plain(header_words: Sequence[int], nonces: torch.Tensor, n_log2: int,
                       v: torch.Tensor) -> torch.Tensor:
    return ops.romix_fill(ops.pbkdf2_in(header_words, nonces), v, n_log2)


def scrypt_front(header_words: Sequence[int], nonces: torch.Tensor, n_log2: int,
                 v: torch.Tensor) -> torch.Tensor:
    """PBKDF2-in and the ROMix fill: 19 header words and ``(B,)`` nonce
    lanes → X after the fill, ``(B, 32)``; writes ``V[i, b] =
    BlockMix^i(X_b)`` for ``i < 2^n_log2`` into the caller's V."""
    count = _count(nonces)
    stride = _check_v(v, n_log2, count)
    device = _same_device(nonces, v)
    if device.type == "cpu":
        return scrypt_front_plain(header_words, nonces, n_log2, v)
    device = _cuda_device(device)
    x = torch.empty((count, 32), dtype=_I64, device=device)
    _launch("tm_scrypt_front", ctypes.byref(_header_struct(header_words)), nonces.data_ptr(),
            x.data_ptr(), v.data_ptr(), count, stride, n_log2, device.index, _stream(device))
    scrypt_front.launches += 1
    return x


# ---------------------------------------------------------------------------
# 19: the walk
# ---------------------------------------------------------------------------

romix_walk_plain = ops.romix_walk


def romix_walk(x: torch.Tensor, v: torch.Tensor, n_log2: int, steps: int) -> torch.Tensor:
    """``steps`` walk steps, ``X ← BlockMix(X ⊕ V[X[16] mod N, lane])``,
    on ``(B, 32)`` X against the V :func:`scrypt_front` filled; the
    whole walk is ``steps = 2^n_log2``. Returns the new X."""
    count = x.shape[0] if x.dim() == 2 else -1
    if not 1 <= count <= MAX_LANES:
        raise ValueError(f"X must be (B, 32) with 1 to {MAX_LANES} lanes")
    _check("X", x, (count, 32))
    stride = _check_v(v, n_log2, count)
    if not 0 <= steps < 1 << 31:
        raise ValueError("steps must be in [0, 2^31)")
    device = _same_device(x, v)
    if device.type == "cpu":
        return romix_walk_plain(x, v, n_log2, steps)
    device = _cuda_device(device)
    out = torch.empty_like(x)
    _launch("tm_romix_walk", x.data_ptr(), out.data_ptr(), v.data_ptr(), count, stride,
            n_log2, steps, device.index, _stream(device))
    romix_walk.launches += 1
    return out


# ---------------------------------------------------------------------------
# S2: PBKDF2-out and the batch fold
# ---------------------------------------------------------------------------

def scrypt_back_plain(header_words: Sequence[int], nonces: torch.Tensor, x: torch.Tensor,
                      target_words: Sequence[int],
                      key: Sequence[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``key``, the header's :func:`ops.scrypt.key_state`, skips the
    key's first compression, as the kernel does."""
    digest = ops.pbkdf2_out(header_words, nonces, x, key)
    return digest, ops.batch_fold(digest, target_words)


@functools.lru_cache(maxsize=64)
def _key_struct(header_words: tuple) -> build.TmScryptKey:
    key = build.TmScryptKey()
    key.w[:] = ops.key_state(header_words)
    return key


def scrypt_back(header_words: Sequence[int], nonces: torch.Tensor, x: torch.Tensor,
                target_words: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """PBKDF2-out of X after the walk, and the batch against msb-first
    ``target_words``: ``(digest (B, 8), handle)``, the handle packed as
    :func:`ops.scrypt.batch_fold` packs it (found, first winning lane,
    the lexicographic minimum's hash words and lane, the first winner's
    hash words). One launch: the key's first block comes from the host
    (:func:`ops.scrypt.key_state`, once a header), and the last block to
    finish folds the blocks' partials into the handle."""
    count = _count(nonces)
    _check("X", x, (count, 32))
    words = [int(t) for t in target_words]
    if len(words) != 8 or any(not 0 <= w <= ops.M32 for w in words):
        raise ValueError("target_words must be 8 msb-first u32 words")
    device = _same_device(nonces, x)
    key = _key_struct(tuple(int(w) for w in header_words))
    if device.type == "cpu":
        return scrypt_back_plain(header_words, nonces, x, words, tuple(key.w))
    device = _cuda_device(device)
    if x.data_ptr() % 16:
        raise ValueError("X must start on a 16-byte boundary (the kernel loads 16 bytes)")
    digest = torch.empty((count, 8), dtype=_I64, device=device)
    handle = torch.empty(ops.HANDLE_WORDS, dtype=_I64, device=device)
    partial = torch.empty(-(-count // THREADS) * BACK_PARTIAL, dtype=_I32, device=device)
    target = build.TmTarget()
    target.w[:] = words
    _launch("tm_scrypt_back", ctypes.byref(_header_struct(header_words)), ctypes.byref(key),
            ctypes.byref(target), nonces.data_ptr(), x.data_ptr(), digest.data_ptr(),
            handle.data_ptr(), partial.data_ptr(), count, device.index, _stream(device))
    scrypt_back.launches += 1
    return digest, handle


# ---------------------------------------------------------------------------
# 11: the row-gather probe
# ---------------------------------------------------------------------------

row_gather_plain = ops.row_gather

#: threads a block of the gather (``kGatherThreads``) and threads a row,
#: each reading one 16-byte piece of it (``kGatherPieces``)
GATHER_THREADS = 256
GATHER_PIECES = 8
#: row slots (of GATHER_PIECES threads) a launch aims to give each SM: 32
#: slices at the probe's 8192 lanes on 132 SMs, which read fastest
GATHER_SLOTS_PER_SM = 2048


@dataclass(frozen=True)
class GatherGeometry:
    """11's launch: ``slices`` runs of ``per`` passes (the last may be
    shorter), each a row slot for every lane, on ``grid`` blocks."""

    count: int
    reps: int
    slices: int
    per: int
    grid: int


def gather_geometry(count: int, reps: int, sms: int) -> GatherGeometry:
    """11's launch for ``count`` lanes of ``reps`` passes on ``sms`` SMs:
    the passes split into as many slices as it takes for ``count ×
    slices`` row slots to reach :data:`GATHER_SLOTS_PER_SM` an SM (one
    slice when one pass already does; never more slices than passes, and
    never an empty one)."""
    if not 1 <= count <= MAX_LANES or not 0 <= reps < 1 << 31 or sms < 1:
        raise ValueError("count must be in [1, 2^30], reps in [0, 2^31) and sms >= 1")
    slices = max(1, min(-(-sms * GATHER_SLOTS_PER_SM // count), reps))
    per = -(-reps // slices)
    slices = -(-reps // per) if per else 1
    grid = -(-slices * count * GATHER_PIECES // GATHER_THREADS)
    return GatherGeometry(count, reps, slices, per, grid)


def row_gather(v: torch.Tensor, idx: torch.Tensor, reps: int) -> torch.Tensor:
    """``(rows, 32)`` words and ``(B,)`` row indices in ``[0, rows)`` →
    ``(B,)`` lanes: the xor of every word of rows ``(idx + r · 977) mod
    rows``, ``r < reps`` (one 128-byte row read a lane a pass). V is
    int32 bit patterns on the card, int64 lanes on the CPU. On the card
    the launch is :func:`gather_geometry`'s for this card."""
    count = _count(idx)
    rows = v.shape[0] if v.dim() == 2 else -1
    if rows < 1:
        raise ValueError("V must be (rows, 32) with rows >= 1")
    _check("V", v, (rows, 32), _I32 if v.device.type == "cuda" else _I64)
    if not 0 <= reps < 1 << 31:
        raise ValueError("reps must be in [0, 2^31)")
    device = _same_device(v, idx)
    if device.type == "cpu":
        return row_gather_plain(v, idx, reps)
    device = _cuda_device(device)
    g = gather_geometry(count, reps, _sm_count(device.index))
    out = torch.empty(count, dtype=_I64, device=device)
    _launch("tm_row_gather", v.data_ptr(), rows, idx.data_ptr(), out.data_ptr(), count, reps,
            g.slices, g.per, g.grid, device.index, _stream(device))
    row_gather.launches += 1
    return out


#: threads a hash of each kernel with a wave (``occupancy``)
THREADS_PER_HASH = {"scrypt_front": FRONT_THREADS_PER_HASH,
                    "romix_walk": WALK_THREADS_PER_HASH, "scrypt_back": BACK_THREADS_PER_HASH}


def occupancy(device) -> dict:
    """Resident blocks of :data:`THREADS` threads per SM, and registers a
    thread, of the fill, the walk and S2: ``{name: (blocks, registers)}``.
    The hashes in flight a wave are ``blocks × THREADS × SMs`` over
    :data:`THREADS_PER_HASH`."""
    device = _cuda_device(device)
    out = {}
    for which, name in enumerate(THREADS_PER_HASH):
        blocks, regs = ctypes.c_int(0), ctypes.c_int(0)
        _launch("tm_scrypt_occupancy", which, device.index, ctypes.byref(blocks),
                ctypes.byref(regs))
        out[name] = (blocks.value, regs.value)
    return out


#: every scrypt kernel wrapper, in table order (S1, 19, S2, 11)
KERNELS = (scrypt_front, romix_walk, scrypt_back, row_gather)
for _fn in KERNELS:
    _fn.launches = 0
