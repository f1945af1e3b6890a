"""The layout probes' kernel wrappers, their plain versions and launch counts.

Counterpart of the fifteen ``pallas_call`` sites of the TPU rounds'
walk-layout, transpose and launch-overhead probes (``scripts/``), which
reduce to three kernels in ``csrc/probes.cu``: P1 :func:`xor_const`, P2
:func:`transpose` and P3 :func:`walk_step` (``ops.walk_layouts`` says
which site each serves). Each runs its CUDA kernel for tensors on the
card and its plain version (``ops.walk_layouts``) for tensors on the
CPU, chosen only by where its inputs lie; a CUDA request launches the
kernel or raises. Only ``chip_smoke.py`` and the probe modules
(``tpuminter_torch.probes``) launch them; the miner never does.

Words are int32 bit patterns on the card (4 bytes a word, as the TPU's
u32 arrays) and ``int64`` lanes holding ``[0, 2^32)`` on the CPU; each
wrapper refuses the other. Each wrapper's ``launches`` attribute counts
its kernel launches (plain runs are not counted).

The launch geometry is computed here, by plain functions
(:func:`xor_const_geometry`, :func:`transpose_geometry`,
:func:`walk_step_geometry`, whose docstrings say how each thread maps to
words and lanes), and passed to the kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from tpuminter_torch.kernels import build
from tpuminter_torch.kernels.sha256 import _cuda_device, _same_device, _stream
from tpuminter_torch.ops import walk_layouts as ops

__all__ = [
    "xor_const", "transpose", "walk_step", "xor_const_plain", "transpose_plain",
    "walk_step_plain", "INSTANTIATIONS", "KERNELS", "word_dtype", "XorGeometry",
    "TransposeGeometry", "WalkGeometry", "xor_const_geometry", "transpose_geometry",
    "walk_step_geometry", "xor_const_words", "vector_aligned", "walk_step_pairs",
    "quad_words", "XOR_THREADS", "WALK_THREADS", "QUAD_LANES", "FULL_FORM", "TILE",
]

#: the (layout, body) pairs of P3 that the probes use, and the kernel's
#: ids for them (``Layout`` and ``Body`` in ``csrc/probes.cu``)
INSTANTIATIONS = (
    ("grouped", "null"), ("grouped", "one_extract"), ("grouped", "xor_only"),
    ("grouped", "full"), ("word", "full"), ("row", "full"), ("bitcast", "xor_only"),
    ("bitcast", "full"),
)
_LAYOUT_ID = {"row": 0, "word": 1, "grouped": 2, "bitcast": 3}
_BODY_ID = {"null": 0, "one_extract": 1, "xor_only": 2, "full": 3}
_MAX_WORDS = 1 << 31

#: P1's threads a block and the elementwise P3's (``null``,
#: ``one_extract``, ``xor_only``), each thread one 16-byte vector:
#: ``kXorThreads`` and ``kWalkThreads`` in ``csrc/probes.cu``, the
#: fastest exact launch of a sweep on the card (PERF.md §6)
XOR_THREADS, WALK_THREADS = 512, 256
#: P2's tile, ``TILE`` × ``TILE`` words in both arms (``kTile`` in
#: ``csrc/probes.cu``; a 64-row tile read slower, PERF.md §6)
TILE = 32
#: lanes a block of P3's ``full`` body covers
QUAD_LANES = 128
#: the form each layout's ``full`` body takes in ``csrc/probes.cu``: one
#: thread a lane, or four (``salsa.cuh``'s quad form)
FULL_FORM = {"row": "quad", "word": "lane", "grouped": "lane", "bitcast": "lane"}


def word_dtype(device) -> torch.dtype:
    """The dtype of a word on ``device``: int32 bit patterns on the card,
    int64 lanes on the CPU."""
    return torch.int32 if torch.device(device).type == "cuda" else torch.int64


def _launch(name: str, *args) -> None:
    err = getattr(build.library("probes"), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def _check(name: str, t: torch.Tensor, shape=None) -> None:
    dtype = word_dtype(t.device)
    if t.dtype != dtype or not t.is_contiguous() or (
            shape is not None and tuple(t.shape) != tuple(shape)):
        want = f" of shape {tuple(shape)}" if shape is not None else ""
        raise ValueError(f"{name} must be a contiguous {dtype} tensor{want} on "
                         f"{t.device.type}, got {t.dtype} {tuple(t.shape)}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# P1: x ^ c
# ---------------------------------------------------------------------------

xor_const_plain = ops.xor_const


@dataclass(frozen=True)
class XorGeometry:
    """P1's launch over ``n`` words: ``grid`` blocks of
    :data:`XOR_THREADS`, a thread's slot a 16-byte vector (``aligned``)
    or one word."""

    n: int
    aligned: bool
    grid: int

    @property
    def unit(self) -> int:
        """Words a slot moves."""
        return 4 if self.aligned else 1

    @property
    def units(self) -> int:
        """Slots with work: the vectors, or the words."""
        return self.n // self.unit

    @property
    def tail(self) -> int:
        """Words after the last vector (block 0's first threads take
        them)."""
        return self.n - self.units * self.unit


def xor_const_geometry(n: int, aligned: bool) -> XorGeometry:
    """P1's launch over ``n`` words (``1 <= n < 2^31``), 16-byte vectors
    when both pointers are 16-byte ``aligned``.

    Mapping: thread ``t`` of block ``k`` takes slot ``k·XOR_THREADS +
    t`` (a warp's slots are contiguous bytes), words ``[unit·s, unit·s +
    unit)`` of slot ``s`` when ``s < units``. The grid is exactly the
    blocks the slots fill, no grid-stride loop; in the aligned arm the
    ``n % 4`` tail words go to threads ``0 .. n % 4 - 1`` of block 0. No
    launch reads the card's SM count: the grid is the work's."""
    if not 1 <= n < _MAX_WORDS:
        raise ValueError(f"n must be in [1, 2^31), got {n}")
    units = n // 4 if aligned else n
    return XorGeometry(n, aligned, max(1, _cdiv(units, XOR_THREADS)))


def xor_const_words(g: XorGeometry, blocks=None) -> np.ndarray:
    """The words that ``blocks`` (block indices; every block of the grid
    when None) of :func:`xor_const_geometry`'s launch touch, block by
    block and thread by thread as the kernel walks them (the tail words
    after block 0's), one entry a word."""
    blocks = np.arange(g.grid) if blocks is None else np.asarray(blocks, dtype=np.int64)
    slot = (blocks[:, None] * XOR_THREADS + np.arange(XOR_THREADS, dtype=np.int64)[None, :])
    slot = slot[slot < g.units]
    words = (slot[:, None] * g.unit + np.arange(g.unit)).reshape(-1)
    if g.tail and (blocks == 0).any():
        words = np.concatenate([words, g.units * g.unit + np.arange(g.tail)])
    return words


def xor_const(x: torch.Tensor, c: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x ^ c`` over every word of ``x``, into ``out`` (a new tensor
    when None; ``out`` may be ``x``)."""
    _check("x", x)
    if not 0 <= c <= 0xFFFFFFFF or not 1 <= x.numel() < _MAX_WORDS:
        raise ValueError("c must be a u32 and x hold 1 to 2^31 - 1 words")
    if out is not None:
        _check("out", out, x.shape)
    device = _same_device(x, *(() if out is None else (out,)))
    if device.type == "cpu":
        result = xor_const_plain(x, c)
        return result if out is None else out.copy_(result)
    device = _cuda_device(device)
    out = torch.empty_like(x) if out is None else out
    g = xor_const_geometry(x.numel(), x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    _launch("tm_xor_const", x.data_ptr(), out.data_ptr(), g.n, c, g.grid, int(g.aligned),
            device.index, _stream(device))
    xor_const.launches += 1
    return out


# ---------------------------------------------------------------------------
# P2: (R, C) -> (C, R), optionally xored into a carry
# ---------------------------------------------------------------------------

transpose_plain = ops.transpose


@dataclass(frozen=True)
class TransposeGeometry:
    """P2's launch: the ``vector`` arm (256 threads, one a 16-byte chunk
    of the tile) or the scalar one (32 × 8 threads), on a ``grid`` of
    :data:`TILE` × :data:`TILE` tiles."""

    vector: bool
    grid: tuple


def transpose_geometry(rows: int, cols: int, aligned: bool) -> TransposeGeometry:
    """P2's launch for ``(rows, cols)`` words whose pointers are all
    16-byte ``aligned`` or not.

    The vector arm takes rows and cols that are multiples of 4 with
    aligned pointers: thread ``t`` of block ``(bx, by)`` loads words
    ``4q .. 4q + 3`` (``q = t % 8``) of input row ``32·bx + t // 8``,
    column ``32·by + 4q`` on; warp ``w``, lane ``l`` then stores words
    ``4·(l % 8) .. + 3`` of output row ``32·by + 4w + l // 8`` (an
    input column), column ``32·bx`` on, read from the shared tile.
    Either arm's grid is an exact cover of the tiles, its
    edges masked (by whole vectors in the vector arm); no launch reads
    the card's SM count. Any other call takes the scalar arm."""
    if not (1 <= rows < _MAX_WORDS and 1 <= cols <= 65535 * TILE):
        raise ValueError(f"(rows, cols) must be in [1, 2^31) x [1, {65535 * TILE}], "
                         f"got {(rows, cols)}")
    vector = aligned and rows % 4 == 0 and cols % 4 == 0
    return TransposeGeometry(vector, (_cdiv(rows, TILE), _cdiv(cols, TILE)))


def vector_aligned(*tensors: Optional[torch.Tensor]) -> bool:
    """True when every tensor given (None skipped) starts on a 16-byte
    boundary, as P2's vector arm needs."""
    return all(t.data_ptr() % 16 == 0 for t in tensors if t is not None)


def transpose(x: torch.Tensor, xor_into: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(R, C)`` → ``(C, R)``; xored into ``xor_into`` (``(C, R)``)
    when given. On the card the arm follows :func:`transpose_geometry`:
    the vector arm for sides that are multiples of 4 and pointers on a
    16-byte boundary, else the scalar arm."""
    if x.dim() != 2 or not 1 <= x.shape[0] < _MAX_WORDS or not 1 <= x.shape[1] <= 65535 * 32:
        raise ValueError(f"x must be (R, C) with R < 2^31 and C <= {65535 * 32}, "
                         f"got {tuple(x.shape)}")
    _check("x", x)
    rows, cols = x.shape
    if xor_into is not None:
        _check("xor_into", xor_into, (cols, rows))
    device = _same_device(x, *(() if xor_into is None else (xor_into,)))
    if device.type == "cpu":
        return transpose_plain(x, xor_into)
    device = _cuda_device(device)
    out = torch.empty((cols, rows), dtype=x.dtype, device=device)
    g = transpose_geometry(rows, cols, vector_aligned(x, out, xor_into))
    _launch("tm_transpose_u32", x.data_ptr(), None if xor_into is None else xor_into.data_ptr(),
            out.data_ptr(), rows, cols, int(g.vector), g.grid[0], g.grid[1], device.index,
            _stream(device))
    transpose.launches += 1
    return out


# ---------------------------------------------------------------------------
# P3: one walk step on word planes
# ---------------------------------------------------------------------------

walk_step_plain = ops.walk_step


@dataclass(frozen=True)
class WalkGeometry:
    """P3's launch at ``batch`` lanes: ``grid`` blocks of ``threads``, in
    ``form`` ``elementwise`` (the bodies that xor, a 16-byte vector a
    thread), or the ``full`` body's :data:`FULL_FORM` for the layout."""

    batch: int
    form: str
    grid: int

    @property
    def threads(self) -> int:
        return {"elementwise": WALK_THREADS, "lane": QUAD_LANES,
                "quad": 4 * QUAD_LANES}[self.form]


def quad_words(t: int) -> tuple:
    """The 8 words thread ``t`` (0-3) of a lane's quad holds, in register
    order: row ``t`` of B0, ``r[j] = 4t + ((t + j) & 3)`` (``salsa.cuh``'s
    row layout, ``r[0]`` the diagonal word ``5t``), then row ``t`` of B1,
    16 words on."""
    row = tuple(4 * t + ((t + j) & 3) for j in range(4))
    return row + tuple(16 + w for w in row)


def walk_step_geometry(batch: int, layout: str, body: str,
                       blocks: Optional[int] = None) -> WalkGeometry:
    """P3's launch at ``batch`` lanes (a multiple of 128) for ``layout``
    and ``body``, with ``blocks`` the grid (None: one pass).

    Elementwise bodies: item ``i = w·(B/4) + q`` is lanes ``4q .. 4q + 3``
    of plane ``w`` (16 bytes at word ``4i`` of xw and out; vj's words of
    the four lanes are one vector in the grouped and bitcast layouts).
    Thread ``t`` of block ``k`` takes items ``k·WALK_THREADS + t``, then
    ``grid·WALK_THREADS`` further on, while they last.

    ``full``: block ``k`` takes 128-lane groups ``k, k + grid, ...``; in
    the ``lane`` form thread ``l`` holds all 32 words of lane ``g·128 +
    l`` of group ``g``, in the ``quad`` form (the row layout) thread ``4l
    + t`` holds :func:`quad_words` ``(t)`` of that lane."""
    if batch < QUAD_LANES or batch % QUAD_LANES:
        raise ValueError(f"batch must be a multiple of {QUAD_LANES}, got {batch}")
    if blocks is not None and blocks < 1:
        raise ValueError(f"blocks must be positive, got {blocks}")
    if body == "full":
        return WalkGeometry(batch, FULL_FORM[layout], blocks or batch // QUAD_LANES)
    return WalkGeometry(batch, "elementwise", blocks or _cdiv(8 * batch, WALK_THREADS))


def walk_step_pairs(g: WalkGeometry) -> np.ndarray:
    """The ``(word, lane)`` pairs of the output that the launch's threads
    compute, as flat offsets ``w·B + b``, from the kernel's index
    arithmetic over every block and pass of its grid-stride loop, one
    entry a pair."""
    if g.form != "elementwise":
        groups = g.batch // QUAD_LANES
        group = (np.arange(g.grid)[:, None]
                 + np.arange(_cdiv(groups, g.grid))[None, :] * g.grid).reshape(-1)
        group = group[group < groups]
        tid = np.arange(g.threads)
        per_lane = g.threads // QUAD_LANES
        lane = group[:, None] * QUAD_LANES + tid[None, :] // per_lane
        word = (np.array([quad_words(t) for t in range(4)])[tid % 4] if per_lane == 4
                else np.broadcast_to(np.arange(32), (g.threads, 32)))
        return (word[None, :, :] * g.batch + lane[:, :, None]).reshape(-1)
    items, stride = 8 * g.batch, g.grid * WALK_THREADS
    start = np.arange(0, items, stride)
    item = (start[:, None, None] + np.arange(g.grid)[None, :, None] * WALK_THREADS
            + np.arange(WALK_THREADS)[None, None, :]).reshape(-1)
    item = item[item < items]
    return (item[:, None] * 4 + np.arange(4)).reshape(-1)


def walk_step(xw: torch.Tensor, vj: torch.Tensor, layout: str, body: str,
              blocks: Optional[int] = None) -> torch.Tensor:
    """One step of a layout probe (:func:`ops.walk_layouts.walk_step`):
    ``(32, B/128, 128)`` word planes and vj in ``layout``
    (:func:`ops.walk_layouts.operand_shape`) → ``(32, B/128, 128)``.
    ``blocks`` sets the kernel's grid (a grid-stride loop; one pass when
    None, :func:`walk_step_geometry`); the plain version ignores it."""
    if (layout, body) not in INSTANTIATIONS:
        raise ValueError(f"(layout, body) must be one of {INSTANTIATIONS}, got {(layout, body)}")
    batch = xw.shape[1] * ops.LANES if xw.dim() == 3 else -1
    if not 1 <= batch < 1 << 25:
        raise ValueError(f"xw must be (32, B/128, 128) with 0 < B < 2^25, got {tuple(xw.shape)}")
    if layout == "bitcast" and batch % ops.bitcast_block(batch):
        raise ValueError(f"the bitcast layout needs B below {ops.BITCAST_BLOCK} or a multiple "
                         f"of it, got {batch}")
    _check("xw", xw, (32, batch // ops.LANES, ops.LANES))
    _check("vj", vj, ops.operand_shape(layout, batch))
    if blocks is not None and not 1 <= blocks <= batch:
        raise ValueError(f"blocks must be in [1, {batch}]")
    device = _same_device(xw, vj)
    if device.type == "cpu":
        return walk_step_plain(xw, vj, layout, body)
    device = _cuda_device(device)
    if vj.data_ptr() % 16 or xw.data_ptr() % 16:
        raise ValueError("xw and vj must be 16-byte aligned on the card")
    g = walk_step_geometry(batch, layout, body, blocks)
    out = torch.empty_like(xw)
    _launch("tm_walk_step", _LAYOUT_ID[layout], _BODY_ID[body], xw.data_ptr(), vj.data_ptr(),
            out.data_ptr(), batch, ops.bitcast_block(batch), g.grid, device.index,
            _stream(device))
    walk_step.launches += 1
    return out


#: every probe kernel wrapper, P1-P3
KERNELS = (xor_const, transpose, walk_step)
for _fn in KERNELS:
    _fn.launches = 0
