"""The SHA-256 kernels' wrappers, their plain versions and launch counts.

Counterpart of ``tpuminter.kernels.sha256``. Each wrapper runs its CUDA
kernel (``csrc/sha256.cu``) for the card and its plain PyTorch version
for the CPU, chosen only by where its input lies: the nonce tensors for
:func:`sha256_batch`, the header tensors for the rolled searches and
the extranonce tensors for :func:`extranonce_roll`, the ``device``
argument for the fixed-template searches (whose inputs are scalars). A
CUDA request launches the kernel or raises; nothing falls back to the
plain version.

u32 values travel as ``int64`` tensors holding ``[0, 2^32)`` (torch's
CPU backend has no uint32 arithmetic). A search returns a small
``int64`` tensor, its *handle*, that the kernel writes; nothing waits
for the device until the caller reads it:

- :func:`search_candidates` and its header arm
  :func:`search_candidates_header`: ``[found, first_off]``
- :func:`search_target` and its header arm :func:`search_target_header`:
  ``[found, first_off, min_words[8], min_off]`` (the min fields cover
  the whole range only when ``found == 0``)
- :func:`min_toy` and its toy arm :func:`min_toy_toy`: ``[fold_hi,
  fold_lo, argmin_off]``
- :func:`search_candidates_hdr`: ``[found, first_off]``
- :func:`search_candidates_hdr_batch` and its ``_sched`` arm: ``(B, 2)``,
  ``[found, first_off]`` per row

The rolled kernels read their headers from device memory, where
:func:`extranonce_roll` writes them: ``(B, 8)`` midstates and ``(B, 3)``
tail words (Merkle word 7, time, bits), so no header crosses to the
host while a rolled job is swept.

Offsets are relative to the base; ``first_off`` is ``0x7FFFFFFF`` when
nothing was found. Each wrapper's ``launches`` attribute counts its
kernel launches (plain runs are not counted). The plain versions run on
any device (their ``device`` argument); the on-card smoke test runs them
on the card to hold each kernel against its plain version there.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from tpuminter_torch.chain import SHA256_H0
from tpuminter_torch.kernels import build
from tpuminter_torch.ops import merkle
from tpuminter_torch.ops import sha256 as ops

__all__ = [
    "sha256_batch", "search_target", "search_target_header", "search_candidates",
    "search_candidates_header", "min_toy", "min_toy_toy", "search_candidates_hdr",
    "search_candidates_hdr_batch", "search_candidates_hdr_batch_sched", "extranonce_roll",
    "sha256_batch_plain", "search_target_plain", "search_target_header_plain",
    "search_candidates_plain", "search_candidates_header_plain", "min_toy_plain",
    "min_toy_toy_plain", "search_candidates_hdr_plain", "search_candidates_hdr_batch_plain",
    "extranonce_roll_plain", "KERNELS", "NOT_FOUND", "occupancy", "hdr_grid", "hdr_offsets",
    "OCCUPANCY_KERNELS", "OCCUPANCY_TOY", "HDR_WAVES", "serial_floor", "serial_floor_plain",
]

#: ``first_off`` when no offset of the range hit
NOT_FOUND = 0x7FFFFFFF
#: lanes per step of a plain version, by device type: bounds its memory
#: (a message schedule is 64 words per lane); the card's larger step
#: keeps its launch count low enough to time the plain version at the
#: main path's slab
PLAIN_CHUNK = {"cpu": 1 << 16, "cuda": 1 << 22}
#: threads per block of every kernel (``kThreads`` in the source)
THREADS = 256
#: resident blocks aimed for per SM; grids are capped at this many (K4's
#: is whole waves of its resident blocks instead: :func:`hdr_grid`)
BLOCKS_PER_SM = 8

_I64 = torch.int64


def _check_n(n: int) -> None:
    if not 1 <= n <= 1 << 30:
        raise ValueError("n must be in [1, 2^30]")


def _check_u32(**values: int) -> None:
    for name, v in values.items():
        if not 0 <= v <= 0xFFFFFFFF:
            raise ValueError(f"{name}={v} is not a u32")


def _cuda_device(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"device must be cpu or cuda, got {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but torch sees none")
    return torch.device("cuda", torch.cuda.current_device() if device.index is None
                        else device.index)


@functools.lru_cache(maxsize=64)
def _template_struct(template: ops.NonceTemplate) -> build.TmTemplate:
    if not 1 <= len(template.tail) <= 2 or not 1 <= len(template.positions) <= 8:
        raise ValueError("a template has 1-2 tail blocks and 1-8 nonce bytes")
    t = build.TmTemplate()
    t.mid[:] = list(template.midstate)
    tail = [w for block in template.tail for w in block]
    t.tail[:] = tail + [0] * (32 - len(tail))
    for p, (block, word, wshift, nshift) in enumerate(template.positions):
        t.pos_word[p] = block * 16 + word
        t.pos_wshift[p] = wshift
        t.pos_nshift[p] = nshift
    t.n_pos = len(template.positions)
    t.n_blocks = len(template.tail)
    t.dbl = int(template.double)
    return t


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _grid(n: int, device_index: int) -> int:
    return min(-(-n // THREADS), _sm_count(device_index) * BLOCKS_PER_SM)


#: ``which`` of ``tm_sha256_occupancy`` for each grid-stride search
#: kernel; K6's toy arm ``<k>`` is ``OCCUPANCY_TOY + k``
OCCUPANCY_KERNELS = {"search_candidates_hdr": 0, "search_candidates_header": 1,
                     "search_target_header": 2, "search_candidates_hdr_batch": 3,
                     "search_candidates_hdr_batch_sched": 4}
OCCUPANCY_TOY = 5


@functools.lru_cache(maxsize=None)
def occupancy(which: int, device_index: int) -> tuple:
    """(resident blocks of :data:`THREADS` threads per SM, registers a
    thread) of search kernel ``which`` (:data:`OCCUPANCY_KERNELS`) on the
    card, as the CUDA runtime reports them for the built kernel."""
    blocks, regs = ctypes.c_int(0), ctypes.c_int(0)
    _launch("tm_sha256_occupancy", which, device_index, ctypes.byref(blocks),
            ctypes.byref(regs))
    return blocks.value, regs.value


#: waves of K4's grid: its blocks sweep the range grid-stride, so each
#: block's share is equal, and more waves let an SM that finishes early
#: take a block a slower one would have run (on an H100, 4 waves ran
#: faster than 1 or 2)
HDR_WAVES = 4


def hdr_grid(n: int, resident: int, sms: int) -> int:
    """K4's grid for ``n`` nonces: :data:`HDR_WAVES` whole waves of
    ``resident`` blocks an SM on ``sms`` SMs, or one block for each
    :data:`THREADS` offsets where the range is smaller. The blocks sweep
    the range grid-stride, so each block's share is equal but for its
    last step, and no wave runs part-empty at the end."""
    if n < 1 or resident < 1 or sms < 1:
        raise ValueError("n, resident and sms must be positive")
    return min(-(-n // THREADS), HDR_WAVES * resident * sms)


def hdr_offsets(n: int, grid: int, threads=None) -> np.ndarray:
    """The offsets K4's launch of ``grid`` blocks sweeps, thread by thread
    (``threads``: global thread indices, all by default), as the kernel's
    u32 loop walks them: ``(threads, steps)``, -1 where a step is masked
    (its offset at or past ``n``) or not taken. A warp starts at its
    first 32 offsets and steps ``grid × THREADS`` at a time while its
    step is below ``n``; it stops where the next step would reach ``n``,
    so its u32 step never wraps past 2^32. One step more than the range
    needs is modelled, so a loop that overran would show."""
    stride = grid * THREADS
    tid = np.arange(grid * THREADS) if threads is None else np.asarray(threads)
    w0 = (tid - tid % 32).astype(np.uint64)
    steps = -(-n // stride) + 1
    k = np.arange(steps, dtype=np.uint64)
    step = (w0[:, None] + k[None, :] * np.uint64(stride)) % np.uint64(1 << 32)
    taken = step < n
    # the next step is taken only when n - w0 > stride (u32: w0 < n here)
    more = (np.uint64(n) - step) % np.uint64(1 << 32) > stride
    taken[:, 1:] &= np.logical_and.accumulate(taken[:, :-1] & more[:, :-1], axis=1)
    off = step + (tid % 32).astype(np.uint64)[:, None]
    return np.where(taken & (off < n), off.astype(np.int64), -1)


def _launch(name: str, *args) -> None:
    err = getattr(build.library("sha256"), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def _check_lanes(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != _I64 or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int64 tensor of shape {tuple(shape)}")


def _same_device(*tensors: torch.Tensor) -> torch.device:
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError("inputs must lie on one device")
    return device


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _offsets(n: int, device):
    """Ascending offset chunks of at most PLAIN_CHUNK lanes."""
    device = torch.device(device)
    step = PLAIN_CHUNK[device.type]
    for start in range(0, n, step):
        yield torch.arange(start, min(n, start + step), dtype=_I64, device=device)


def _candidate_hits(e60, e61, hw1_cap: int) -> torch.Tensor:
    """Indices of the lanes that pass the candidate test: digest word 7
    zero and hash word 1 ``<= hw1_cap``."""
    hw1 = ops.byteswap32((ops.DIGEST6_BIAS + e61) & ops.M32)
    return torch.nonzero((e60 == ops.CAND_E60) & (hw1 <= hw1_cap))


def _argmin_lex(keys: Sequence[torch.Tensor]) -> int:
    """Index of the lexicographic minimum over key lanes; the lowest
    index among equals (min + mask passes, one per key)."""
    mask = torch.ones_like(keys[0], dtype=torch.bool)
    big = torch.iinfo(_I64).max
    for k in keys:
        col = torch.where(mask, k, big)
        mask &= col == col.min()
    return int(torch.nonzero(mask)[0])


# ---------------------------------------------------------------------------
# K1: digests for explicit nonces
# ---------------------------------------------------------------------------

def sha256_batch_plain(template: ops.NonceTemplate, nonce_hi: torch.Tensor,
                       nonce_lo: torch.Tensor) -> torch.Tensor:
    out = torch.empty((nonce_lo.shape[0], 8), dtype=_I64, device=nonce_lo.device)
    step = PLAIN_CHUNK[nonce_lo.device.type]
    for start in range(0, nonce_lo.shape[0], step):
        sl = slice(start, start + step)
        out[sl] = torch.stack(ops.digest_words(template, nonce_hi[sl], nonce_lo[sl]), 1)
    return out


def sha256_batch(template: ops.NonceTemplate, nonce_hi: torch.Tensor,
                 nonce_lo: torch.Tensor) -> torch.Tensor:
    """Digest words for explicit nonces ``hi << 32 | lo``: ``(N,) × 2 →
    (N, 8)`` big-endian u32 words, single or double SHA per
    ``template.double`` (≡ the JAX package's ``pallas_sha256_batch``)."""
    for t in (nonce_hi, nonce_lo):
        if t.dtype != _I64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("nonce lanes must be contiguous 1-D int64 tensors")
    if nonce_hi.shape != nonce_lo.shape or nonce_hi.device != nonce_lo.device:
        raise ValueError("nonce_hi and nonce_lo must match in shape and device")
    if nonce_lo.device.type == "cpu":
        return sha256_batch_plain(template, nonce_hi, nonce_lo)
    device = _cuda_device(nonce_lo.device)
    n = nonce_lo.shape[0]
    out = torch.empty((n, 8), dtype=_I64, device=device)
    if n:
        _launch(
            "tm_sha256_batch", ctypes.byref(_template_struct(template)),
            nonce_hi.data_ptr(), nonce_lo.data_ptr(), out.data_ptr(), n,
            device.index, _stream(device),
        )
        sha256_batch.launches += 1
    return out


# ---------------------------------------------------------------------------
# K3: candidate search (the production TARGET sweep)
# ---------------------------------------------------------------------------

def search_candidates_plain(template: ops.NonceTemplate, base: int, n: int,
                            hw1_cap: int, device="cpu") -> torch.Tensor:
    for offs in _offsets(n, device):
        e60, e61 = ops.e60_e61(template, 0, (base + offs) & ops.M32)
        hits = _candidate_hits(e60, e61, hw1_cap)
        if len(hits):
            return torch.tensor([1, int(offs[hits[0, 0]])], dtype=_I64, device=device)
    return torch.tensor([0, NOT_FOUND], dtype=_I64, device=device)


def search_candidates(template: ops.NonceTemplate, base: int, n: int,
                      hw1_cap: int = 0xFFFFFFFF, *, device) -> torch.Tensor:
    """First offset in ``[0, n)`` whose nonce ``base + off`` (mod 2^32)
    is a *candidate*: double-SHA digest word 7 is zero (the hash's top 32
    bits) and the hash's word 1 is ``<= hw1_cap``. Offsets past the first
    candidate may be left unsearched. Handle ``[found, first_off]``.

    A template of :func:`ops.header_template`'s shape
    (:func:`ops.header_words`) runs the header arm,
    :func:`search_candidates_header`; any other double-SHA template runs
    the generic kernel, counted here."""
    _check_n(n)
    _check_u32(base=base, hw1_cap=hw1_cap)
    if not template.double:
        raise ValueError("the candidate test needs a double-SHA template")
    words = ops.header_words(template)
    if words is not None:
        return search_candidates_header(words, base, n, hw1_cap, device=device)
    if torch.device(device).type == "cpu":
        return search_candidates_plain(template, base, n, hw1_cap)
    device = _cuda_device(device)
    handle = torch.empty(2, dtype=_I64, device=device)
    _launch(
        "tm_search_candidates", ctypes.byref(_template_struct(template)),
        base, n, hw1_cap, handle.data_ptr(), _grid(n, device.index),
        device.index, _stream(device),
    )
    search_candidates.launches += 1
    return handle


def _check_header_words(words) -> None:
    if len(words) != 4 or len(words[0]) != 8:
        raise ValueError("words must be (midstate8, t0, t1, t2)")
    mid, *tail = words
    _check_u32(**{f"mid{i}": w for i, w in enumerate(mid)},
               **{f"t{i}": w for i, w in enumerate(tail)})


@functools.lru_cache(maxsize=64)
def _header_struct(words) -> build.TmHeader:
    mid, t0, t1, t2 = words
    hd = build.TmHeader()
    hd.mid[:] = list(mid)
    hd.t[:] = [t0, t1, t2]
    return hd


def search_candidates_header_plain(words, base: int, n: int, hw1_cap: int,
                                   device="cpu") -> torch.Tensor:
    """Plain version of the header arm: the shared-schedule formula
    (:func:`ops.prepare_hdr`, :func:`ops.hash_prepared_e60_e61`)."""
    mid, t0, t1, t2 = words
    found = _first_hdr_candidate(list(mid), [t0, t1, t2], base, n, hw1_cap, device,
                                 sched=True)
    return torch.tensor(found, dtype=_I64, device=device)


def search_candidates_header(words, base: int, n: int, hw1_cap: int = 0xFFFFFFFF, *,
                             device) -> torch.Tensor:
    """:func:`search_candidates` for an 80-byte header given by
    :func:`ops.header_words` ``(midstate8, t0, t1, t2)``, passed to the
    kernel by value; each thread prepares the header's nonce-free prefix
    once (K5's sched body). Same handle, bit for bit."""
    _check_n(n)
    _check_u32(base=base, hw1_cap=hw1_cap)
    _check_header_words(words)
    if torch.device(device).type == "cpu":
        return search_candidates_header_plain(words, base, n, hw1_cap)
    device = _cuda_device(device)
    handle = torch.empty(2, dtype=_I64, device=device)
    _launch(
        "tm_search_candidates_header", ctypes.byref(_header_struct(tuple(words))), base, n,
        hw1_cap, handle.data_ptr(), _grid(n, device.index), device.index, _stream(device),
    )
    search_candidates_header.launches += 1
    return handle


# ---------------------------------------------------------------------------
# K2: full target compare with the exact running minimum
# ---------------------------------------------------------------------------

def _target_scan(digest_of, target_words: Sequence[int], base: int, n: int,
                 device) -> torch.Tensor:
    """K2's handle, plain: ``digest_of(nonces)`` gives the digest lanes."""
    tgt = [int(t) for t in target_words]
    best = None  # (words..., off) of the minimum so far
    for offs in _offsets(n, device):
        hw = ops.hash_words_be(digest_of((base + offs) & ops.M32))
        i = _argmin_lex(hw)
        cand = tuple(int(w[i]) for w in hw) + (int(offs[i]),)
        if best is None or cand < best:
            best = cand
        lt = torch.zeros_like(offs, dtype=torch.bool)
        eq = torch.ones_like(offs, dtype=torch.bool)
        for w, t in zip(hw, tgt):
            lt |= eq & (w < t)
            eq &= w == t
        hits = torch.nonzero(lt | eq)
        if len(hits):
            return torch.tensor([1, int(offs[hits[0, 0]]), *best], dtype=_I64,
                                device=device)
    return torch.tensor([0, NOT_FOUND, *best], dtype=_I64, device=device)


def search_target_plain(template: ops.NonceTemplate, target_words: Sequence[int],
                        base: int, n: int, device="cpu") -> torch.Tensor:
    return _target_scan(lambda nonces: ops.digest_words(template, 0, nonces), target_words,
                        base, n, device)


def _target_struct(words: Sequence[int]) -> build.TmTarget:
    target = build.TmTarget()
    target.w[:] = words
    return target


def _check_target(base: int, n: int, target_words: Sequence[int]) -> list:
    _check_n(n)
    _check_u32(base=base)
    words = [int(t) for t in target_words]
    if len(words) != 8:
        raise ValueError("target_words must be 8 msb-first u32 words")
    _check_u32(**{f"target_word{i}": w for i, w in enumerate(words)})
    return words


def search_target(template: ops.NonceTemplate, target_words: Sequence[int],
                  base: int, n: int, *, device) -> torch.Tensor:
    """Full double SHA of nonces ``base + off`` (mod 2^32), ``off`` in
    ``[0, n)``: the first offset whose 256-bit hash value is ``<=`` the
    target (msb-first ``target_words``), with early exit, and the
    lexicographic minimum of the hash value with its offset (ties to the
    lowest offset). Handle ``[found, first_off, min_words[8], min_off]``.

    A template of :func:`ops.header_template`'s shape
    (:func:`ops.header_words`) runs the header arm,
    :func:`search_target_header`; any other runs the generic kernel,
    counted here."""
    words = _check_target(base, n, target_words)
    header = ops.header_words(template)
    if header is not None:
        return search_target_header(header, words, base, n, device=device)
    if torch.device(device).type == "cpu":
        return search_target_plain(template, words, base, n)
    device = _cuda_device(device)
    grid = _grid(n, device.index)
    handle = torch.empty(11, dtype=_I64, device=device)
    partial = torch.empty(grid * 9, dtype=torch.int32, device=device)
    _launch(
        "tm_search_target", ctypes.byref(_template_struct(template)),
        ctypes.byref(_target_struct(words)), base, n, handle.data_ptr(), partial.data_ptr(),
        grid, device.index, _stream(device),
    )
    search_target.launches += 1
    return handle


def search_target_header_plain(words, target_words: Sequence[int], base: int, n: int,
                               device="cpu") -> torch.Tensor:
    """Plain version of the header arm: the shared-schedule formula
    (:func:`ops.prepare_hdr`, :func:`ops.hash_prepared_digest`)."""
    mid, t0, t1, t2 = words
    prep = ops.prepare_hdr(list(mid), t0, t1, t2)
    return _target_scan(lambda nonces: ops.hash_prepared_digest(prep, nonces), target_words,
                        base, n, device)


def search_target_header(words, target_words: Sequence[int], base: int, n: int, *,
                         device) -> torch.Tensor:
    """:func:`search_target` for an 80-byte header given by
    :func:`ops.header_words` ``(midstate8, t0, t1, t2)``, passed to the
    kernel by value: K3's header arm's first hash, then a second
    compression that stops at round 60 wherever hash word 0 already rules
    the nonce out. Same handle, bit for bit."""
    tw = _check_target(base, n, target_words)
    _check_header_words(words)
    if torch.device(device).type == "cpu":
        return search_target_header_plain(words, tw, base, n)
    device = _cuda_device(device)
    grid = _grid(n, device.index)
    handle = torch.empty(11, dtype=_I64, device=device)
    partial = torch.empty(grid * 9, dtype=torch.int32, device=device)
    _launch(
        "tm_search_target_header", ctypes.byref(_header_struct(tuple(words))),
        ctypes.byref(_target_struct(tw)), base, n, handle.data_ptr(), partial.data_ptr(),
        grid, device.index, _stream(device),
    )
    search_target_header.launches += 1
    return handle


# ---------------------------------------------------------------------------
# K6: toy-dialect (MIN) fold
# ---------------------------------------------------------------------------

def min_toy_plain(template: ops.NonceTemplate, base_hi: int, base_lo: int,
                  n: int, device="cpu") -> torch.Tensor:
    best = None
    for offs in _offsets(n, device):
        lo = (base_lo + offs) & ops.M32
        hi = (base_hi + (lo < base_lo).to(_I64)) & ops.M32  # 64-bit carry
        digest = ops.digest_words(template, hi, lo)
        i = _argmin_lex(digest[:2])
        cand = (int(digest[0][i]), int(digest[1][i]), int(offs[i]))
        if best is None or cand < best:
            best = cand
    return torch.tensor(best, dtype=_I64, device=device)


def min_toy(template: ops.NonceTemplate, base_hi: int, base_lo: int, n: int,
            *, device) -> torch.Tensor:
    """Minimum over ``n`` consecutive 64-bit nonces from ``base_hi << 32 |
    base_lo`` of the fold (digest words 0 and 1) of the template's hash
    (≡ ``chain.toy_hash`` for a toy template), no early exit, ties to the
    lowest nonce. Handle ``[fold_hi, fold_lo, argmin_off]``.

    A template of :func:`ops.toy_template`'s shape (:func:`ops.toy_words`)
    runs the toy arm, :func:`min_toy_toy`; any other runs the generic
    kernel, counted here."""
    _check_n(n)
    _check_u32(base_hi=base_hi, base_lo=base_lo)
    words = ops.toy_words(template)
    if words is not None:
        return min_toy_toy(words, base_hi, base_lo, n, device=device)
    if torch.device(device).type == "cpu":
        return min_toy_plain(template, base_hi, base_lo, n)
    device = _cuda_device(device)
    grid = _grid(n, device.index)
    handle = torch.empty(3, dtype=_I64, device=device)
    partial = torch.empty(grid * 3, dtype=torch.int32, device=device)
    _launch(
        "tm_min_toy", ctypes.byref(_template_struct(template)), base_hi, base_lo,
        n, handle.data_ptr(), partial.data_ptr(), grid, device.index,
        _stream(device),
    )
    min_toy.launches += 1
    return handle


def _toy_segments(base_hi: int, base_lo: int, n: int) -> list:
    """``(hi, lo0, off0, count)`` of each run of offsets under one high
    word: one, or two where the low word wraps."""
    split = min(n, (1 << 32) - base_lo)
    segments = [(base_hi, base_lo, 0, split)]
    if split < n:
        segments.append(((base_hi + 1) & ops.M32, 0, split, n - split))
    return segments


def min_toy_toy_plain(words: ops.ToyWords, base_hi: int, base_lo: int, n: int,
                      device="cpu") -> torch.Tensor:
    """Plain version of the toy arm: the arm's own formula
    (:func:`ops.toy_launch` per high word, :func:`ops.toy_fold_words`)."""
    best = None
    for hi, lo0, off0, count in _toy_segments(base_hi, base_lo, n):
        launch = ops.toy_launch(words, hi)
        for offs in _offsets(count, device):
            fold = ops.toy_fold_words(launch, lo0 + offs)
            i = _argmin_lex(fold)
            cand = (int(fold[0][i]), int(fold[1][i]), off0 + int(offs[i]))
            if best is None or cand < best:
                best = cand
    return torch.tensor(best, dtype=_I64, device=device)


@functools.lru_cache(maxsize=64)
def _toy_struct(words: ops.ToyWords, hi: int):
    """``(TmToy, k)`` of ``words`` under high word ``hi``."""
    launch = ops.toy_launch(words, hi)
    t = build.TmToy()
    t.mid[:] = list(launch.midstate)
    t.m[:] = list(launch.block)
    t.m1[:] = list(launch.block1)
    t.shift = launch.shift
    return t, launch.k


def min_toy_toy(words: ops.ToyWords, base_hi: int, base_lo: int, n: int, *,
                device) -> torch.Tensor:
    """:func:`min_toy` for a toy template given by :func:`ops.toy_words`:
    each launch takes the message with its high nonce word folded in
    (:func:`ops.toy_launch`) and runs the kernel instantiated for the
    word the low one begins at; a range whose low word wraps runs as two
    launches, one per high word, folded by one reduce. Same handle, bit
    for bit."""
    _check_n(n)
    _check_u32(base_hi=base_hi, base_lo=base_lo)
    if not isinstance(words, ops.ToyWords):
        raise ValueError("words must be an ops.ToyWords")
    if torch.device(device).type == "cpu":
        return min_toy_toy_plain(words, base_hi, base_lo, n)
    device = _cuda_device(device)
    segments = _toy_segments(base_hi, base_lo, n)
    structs = [_toy_struct(words, hi) for hi, *_ in segments]
    grids = [_grid(count, device.index) for *_, count in segments]
    handle = torch.empty(3, dtype=_I64, device=device)
    partial = torch.empty(sum(grids) * 3, dtype=torch.int32, device=device)
    (t0, k), (t1, _) = structs[0], structs[-1]
    _launch(
        "tm_min_toy_toy", ctypes.byref(t0), ctypes.byref(t1), k, base_lo, segments[0][3], n,
        handle.data_ptr(), partial.data_ptr(), grids[0], grids[-1], device.index,
        _stream(device),
    )
    min_toy_toy.launches += 1
    return handle


# ---------------------------------------------------------------------------
# K4 and K5: candidate search under dynamic headers (the rolled sweep)
# ---------------------------------------------------------------------------

def _first_hdr_candidate(mid, tail, base: int, n: int, hw1_cap: int, device,
                         sched: bool = False) -> list:
    """``[found, first_off]`` of one header (words as ints), plain."""
    prep = ops.prepare_hdr(mid, *tail) if sched else None
    for offs in _offsets(n, device):
        nonces = (base + offs) & ops.M32
        if sched:
            e60, e61 = ops.hash_prepared_e60_e61(prep, nonces)
        else:
            e60, e61 = ops.header_e60_e61_dyn(mid, tail, nonces)
        hits = _candidate_hits(e60, e61, hw1_cap)
        if len(hits):
            return [1, int(offs[hits[0, 0]])]
    return [0, NOT_FOUND]


def search_candidates_hdr_plain(mid8: torch.Tensor, tail3: torch.Tensor, base: int,
                                n: int, hw1_cap: int) -> torch.Tensor:
    found = _first_hdr_candidate(mid8.tolist(), tail3.tolist(), base, n, hw1_cap,
                                 mid8.device)
    return torch.tensor(found, dtype=_I64, device=mid8.device)


def search_candidates_hdr(mid8: torch.Tensor, tail3: torch.Tensor, base: int, n: int,
                          hw1_cap: int = 0xFFFFFFFF) -> torch.Tensor:
    """:func:`search_candidates` under a header given as values: its
    midstate ``mid8`` (8,) and tail words ``tail3`` (3,), int64 tensors
    (an :func:`extranonce_roll` row, never read by the host). First
    candidate offset in ``[0, n)`` from nonce ``base``. Handle
    ``[found, first_off]``. The kernel prepares the header's nonce-free
    prefix once a thread (K5's sched body) and runs on whole waves of its
    resident blocks (:func:`hdr_grid`, :func:`occupancy`)."""
    _check_n(n)
    _check_u32(base=base, hw1_cap=hw1_cap)
    _check_lanes("mid8", mid8, (8,))
    _check_lanes("tail3", tail3, (3,))
    device = _same_device(mid8, tail3)
    if device.type == "cpu":
        return search_candidates_hdr_plain(mid8, tail3, base, n, hw1_cap)
    device = _cuda_device(device)
    handle = torch.empty(2, dtype=_I64, device=device)
    resident, _ = occupancy(OCCUPANCY_KERNELS["search_candidates_hdr"], device.index)
    _launch(
        "tm_search_candidates_hdr", mid8.data_ptr(), tail3.data_ptr(), base, n, hw1_cap,
        handle.data_ptr(), hdr_grid(n, resident, _sm_count(device.index)), device.index,
        _stream(device),
    )
    search_candidates_hdr.launches += 1
    return handle


def search_candidates_hdr_batch_plain(mids: torch.Tensor, tails: torch.Tensor,
                                      bases: torch.Tensor, valids: torch.Tensor,
                                      width: int, hw1_cap: int,
                                      sched: bool = False) -> torch.Tensor:
    """Plain version of both K5 arms; ``sched`` selects the
    shared-schedule formula (:func:`ops.prepare_hdr`)."""
    rows = []
    for mid, tail, base, valid in zip(mids.tolist(), tails.tolist(), bases.tolist(),
                                      valids.tolist()):
        n = min(max(valid, 0), width)
        rows.append(_first_hdr_candidate(mid, tail, base, n, hw1_cap, mids.device, sched)
                    if n else [0, NOT_FOUND])
    return torch.tensor(rows, dtype=_I64, device=mids.device).reshape(-1, 2)


def _hdr_batch(arm, mids, tails, bases, valids, width: int, hw1_cap: int,
               sched: bool) -> torch.Tensor:
    """Both K5 arms: validation, the plain version for the CPU, and the
    launch, counted on ``arm`` (the public wrapper)."""
    if not 1 <= width <= 1 << 30:
        raise ValueError("width must be in [1, 2^30]")
    _check_u32(hw1_cap=hw1_cap)
    b = mids.shape[0] if mids.dim() == 2 else -1
    _check_lanes("mids", mids, (b, 8))
    _check_lanes("tails", tails, (b, 3))
    _check_lanes("bases", bases, (b,))
    _check_lanes("valids", valids, (b,))
    device = _same_device(mids, tails, bases, valids)
    if device.type == "cpu":
        return search_candidates_hdr_batch_plain(mids, tails, bases, valids, width,
                                                 hw1_cap, sched)
    device = _cuda_device(device)
    handle = torch.empty((b, 2), dtype=_I64, device=device)
    if b:
        _launch(
            "tm_search_candidates_hdr_batch", mids.data_ptr(), tails.data_ptr(),
            bases.data_ptr(), valids.data_ptr(), b, width, hw1_cap, int(sched),
            handle.data_ptr(), _grid(b * width, device.index), device.index,
            _stream(device),
        )
        arm.launches += 1
    return handle


def search_candidates_hdr_batch(mids: torch.Tensor, tails: torch.Tensor,
                                bases: torch.Tensor, valids: torch.Tensor, width: int,
                                hw1_cap: int = 0xFFFFFFFF) -> torch.Tensor:
    """:func:`search_candidates_hdr` over ``B`` roll rows in one launch:
    row ``r`` sweeps offsets ``[0, min(valids[r], width))`` of its own
    header (``mids`` (B, 8), ``tails`` (B, 3)) from nonce ``bases[r]``,
    int64 tensors on one device. Handle ``(B, 2)``, ``[found,
    first_off]`` per row, offsets relative to the row's base. This arm
    runs the whole first compression per nonce (the reference's
    ``sched=False`` body)."""
    return _hdr_batch(search_candidates_hdr_batch, mids, tails, bases, valids, width,
                      hw1_cap, sched=False)


def search_candidates_hdr_batch_sched(mids: torch.Tensor, tails: torch.Tensor,
                                      bases: torch.Tensor, valids: torch.Tensor,
                                      width: int,
                                      hw1_cap: int = 0xFFFFFFFF) -> torch.Tensor:
    """:func:`search_candidates_hdr_batch` with each row's nonce-free
    prefix (rounds 0-2, ``w16``, ``w17``, most of ``w18``/``w19``, and
    round 3 but for its nonce word) computed once per row, outside the
    nonce loop (the reference's ``sched=True`` body). Same handle, bit
    for bit."""
    return _hdr_batch(search_candidates_hdr_batch_sched, mids, tails, bases, valids,
                      width, hw1_cap, sched=True)


# ---------------------------------------------------------------------------
# the extranonce roll
# ---------------------------------------------------------------------------

extranonce_roll_plain = merkle.roll_plain


@functools.lru_cache(maxsize=16)
def _job_buffer(job: merkle.RollJob, device: torch.device) -> torch.Tensor:
    """The job's u32 words (:meth:`~ops.merkle.RollJob.words`) on the
    card as int32 bit patterns, once a job."""
    words = np.array(job.words(), dtype=np.uint32).view(np.int32)
    return torch.from_numpy(words).to(device)


def extranonce_roll(job: merkle.RollJob, en_hi: torch.Tensor, en_lo: torch.Tensor):
    """Roll extranonces ``en_hi << 32 | en_lo`` ((B,) int64 tensors) into
    their headers: ``(midstates (B, 8), tail words (B, 3))`` int64
    tensors on the same device (≡ ``chain.rolled_header`` per row)."""
    b = en_lo.shape[0] if en_lo.dim() == 1 else -1
    _check_lanes("en_hi", en_hi, (b,))
    _check_lanes("en_lo", en_lo, (b,))
    device = _same_device(en_hi, en_lo)
    if device.type == "cpu":
        return extranonce_roll_plain(job, en_hi, en_lo)
    device = _cuda_device(device)
    mids = torch.empty((b, 8), dtype=_I64, device=device)
    tails = torch.empty((b, 3), dtype=_I64, device=device)
    if b:
        _launch(
            "tm_extranonce_roll", _job_buffer(job, device).data_ptr(), len(job.coinbase.tail),
            len(job.branch), en_hi.data_ptr(), en_lo.data_ptr(), mids.data_ptr(),
            tails.data_ptr(), b, device.index, _stream(device),
        )
        extranonce_roll.launches += 1
    return mids, tails


def serial_floor_plain(n_blocks: int, depth: int) -> list:
    """The roll's chain for a job of ``n_blocks`` coinbase tail blocks and
    a ``depth``-deep branch, with every message the roll reads (a tail
    block, a sibling, the header's words) replaced by the last state
    twice over (``s ‖ s``): from SHA-256's initial state, ``n_blocks``
    compressions and the txid's second hash, then per level a pair
    compression, its padding block and its second hash, then the
    header's first block. The header's midstate, 8 u32 words."""
    h0 = list(SHA256_H0)
    state = h0
    for _ in range(n_blocks):
        state = ops._compress(state, state + state)
    state = ops._compress(h0, state + list(merkle._PAD256))
    for _ in range(depth):
        state = ops._compress(h0, state + state)
        state = ops._compress(state, list(merkle._PAD512))
        state = ops._compress(h0, state + list(merkle._PAD256))
    return ops._compress(h0, state + state)


def serial_floor(n_blocks: int, depth: int, device) -> torch.Tensor:
    """:func:`serial_floor_plain` by one thread of the roll's body on the
    card (``tm_sha256_serial_floor``), ``(8,)`` int64 words: the roll's
    yardstick, what one thread takes for a row's chain with no loads.
    Not a kernel of any path; the CPU gets the plain version."""
    if not 1 <= n_blocks < 1 << 31 or not 0 <= depth < 1 << 31:
        raise ValueError("n_blocks must be in [1, 2^31) and depth in [0, 2^31)")
    device = torch.device(device)
    if device.type == "cpu":
        return torch.tensor(serial_floor_plain(n_blocks, depth), dtype=_I64)
    device = _cuda_device(device)
    out = torch.empty(8, dtype=_I64, device=device)
    _launch("tm_sha256_serial_floor", n_blocks, depth, out.data_ptr(), device.index,
            _stream(device))
    serial_floor.launches += 1
    return out


#: every kernel wrapper, in table order (K1, K2 and K3 both arms, K4, K5
#: both arms, K6 both arms, then the roll)
KERNELS = (
    sha256_batch, search_target, search_target_header, search_candidates,
    search_candidates_header, search_candidates_hdr, search_candidates_hdr_batch,
    search_candidates_hdr_batch_sched, min_toy, min_toy_toy, extranonce_roll,
)
for _fn in KERNELS + (serial_floor,):
    _fn.launches = 0
