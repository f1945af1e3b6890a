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
"""

from __future__ import annotations

from typing import Optional

import torch

from tpuminter_torch.kernels import build
from tpuminter_torch.kernels.sha256 import _cuda_device, _same_device, _stream
from tpuminter_torch.ops import walk_layouts as ops

__all__ = [
    "xor_const", "transpose", "walk_step", "xor_const_plain", "transpose_plain",
    "walk_step_plain", "INSTANTIATIONS", "KERNELS", "word_dtype",
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


# ---------------------------------------------------------------------------
# P1: x ^ c
# ---------------------------------------------------------------------------

xor_const_plain = ops.xor_const


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
    _launch("tm_xor_const", x.data_ptr(), out.data_ptr(), x.numel(), c, device.index,
            _stream(device))
    xor_const.launches += 1
    return out


# ---------------------------------------------------------------------------
# P2: (R, C) -> (C, R), optionally xored into a carry
# ---------------------------------------------------------------------------

transpose_plain = ops.transpose


def transpose(x: torch.Tensor, xor_into: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(R, C)`` → ``(C, R)``; xored into ``xor_into`` (``(C, R)``)
    when given."""
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
    _launch("tm_transpose_u32", x.data_ptr(), None if xor_into is None else xor_into.data_ptr(),
            out.data_ptr(), rows, cols, device.index, _stream(device))
    transpose.launches += 1
    return out


# ---------------------------------------------------------------------------
# P3: one walk step on word planes
# ---------------------------------------------------------------------------

walk_step_plain = ops.walk_step


def walk_step(xw: torch.Tensor, vj: torch.Tensor, layout: str, body: str,
              blocks: Optional[int] = None) -> torch.Tensor:
    """One step of a layout probe (:func:`ops.walk_layouts.walk_step`):
    ``(32, B/128, 128)`` word planes and vj in ``layout``
    (:func:`ops.walk_layouts.operand_shape`) → ``(32, B/128, 128)``.
    ``blocks`` sets the kernel's grid (a grid-stride loop; one thread a
    lane when None); the plain version ignores it."""
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
    if vj.data_ptr() % 16:
        raise ValueError("vj must be 16-byte aligned on the card")
    out = torch.empty_like(xw)
    _launch("tm_walk_step", _LAYOUT_ID[layout], _BODY_ID[body], xw.data_ptr(), vj.data_ptr(),
            out.data_ptr(), batch, ops.bitcast_block(batch), blocks or 0, device.index,
            _stream(device))
    walk_step.launches += 1
    return out


#: every probe kernel wrapper, P1-P3
KERNELS = (xor_const, transpose, walk_step)
for _fn in KERNELS:
    _fn.launches = 0
