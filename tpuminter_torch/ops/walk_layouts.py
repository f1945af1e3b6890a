"""The walk-layout probes' functions on torch lanes: the plain versions
of the probe kernels P1-P3 (``kernels.probes``).

Counterpart of the ``pallas_call`` bodies of the TPU rounds' layout
probes under ``scripts/``, which asked how the SCRYPT walk step should
lay out its data. They reduce to three functions:

- :func:`xor_const` (P1): ``x ^ c``, the ``_xor_kernel`` /
  ``_copy_pad_kernel`` of ``pallas_launch_overhead_probe.py`` (9, 10)
  and ``transpose_micro_probe.py`` (12, 13);
- :func:`transpose` (P2): ``(R, C) → (C, R)``, optionally xored into a
  carry: ``to_wm`` of ``walk_pallas_probe.py`` (18), ``_tr_pad_kernel``
  and ``_tr_dense_kernel`` of ``transpose_micro_probe.py`` (14, 15),
  ``k_tr_only`` and ``k_tr_dense`` of ``walk_variants_probe.py`` (20,
  21) and ``k_tr_only`` of ``hlo_layout_check.py`` (24);
- :func:`walk_step` (P3): one walk step on word planes, ``out[w] =
  body(xw[w], vj's word w)``, with vj in one of four layouts: the
  ``_xs_kernel`` of ``walk_isolate_probe.py`` (16), ``walk_wm_probe.py``
  (23) and ``walk_wm2_probe.py`` (22), ``_xs_kernel`` of
  ``walk_native_tile_probe.py`` (17), the four bodies of
  ``kernel_body_probe.py`` (8) and the bodies of ``walk_variants_probe.py``
  (20).

Word planes: the carry ``xw`` is ``(32, B/128, 128)``, word ``w`` of
lane ``b`` at ``xw[w, b // 128, b % 128]``, i.e. ``(32, B)`` in memory.
The four layouts of the gathered rows ``vj`` are explicit index maps
(:func:`index_map`) from (word ``w``, lane ``b``) to a flat offset:

- ``row``: ``(B, 32)``, the gather's rows: ``b·32 + w``;
- ``word``: ``(32, B/128, 128)``, word-major: ``w·B + b``;
- ``grouped``: ``(4, B/128, 8, 128)``, the TPU gather's native tiles,
  ``vjg[g, rb, s, l] = vj[rb·128 + l, 8g + s]`` for ``w = 8g + s``,
  ``b = rb·128 + l``;
- ``bitcast``: ``(B, 32)`` row-major bytes read as word planes per block
  of :data:`BITCAST_BLOCK` lanes (``vj_ref[...].reshape(32, SUB, 128)``
  of ``walk_variants_probe.py``): lane ``b = BB·i + t`` reads plane ``w``
  at ``32·BB·i + BB·w + t``, i.e. ``vj[BB·i + (BB/32)·w + t // 32,
  t % 32]``. Its words are not the row's: the probe measured IO and
  xor at dense layouts, wrong values on purpose.

u32 words are ``int64`` lanes holding ``[0, 2^32)``, the port's
convention; on the card the kernels take int32 bit patterns
(:func:`to_bits`, :func:`to_lanes`).
"""

from __future__ import annotations

from typing import Optional

import torch

from tpuminter_torch.ops.scrypt import block_mix
from tpuminter_torch.ops.sha256 import M32

__all__ = [
    "LANES", "BITCAST_BLOCK", "LAYOUTS", "BODIES", "xor_const", "transpose",
    "index_map", "operand_shape", "bitcast_block", "layout_words", "walk_step",
    "to_bits", "to_lanes",
]

#: lanes of a word plane's row (the TPU's lane width; the probes' carry
#: is ``(32, B/LANES, LANES)``)
LANES = 128
#: lanes per block of the ``bitcast`` layout: ``BB = 2048`` of
#: ``walk_variants_probe.py``, or the whole batch when it is smaller
BITCAST_BLOCK = 2048
LAYOUTS = ("row", "word", "grouped", "bitcast")
#: ``null``: ``xw ^ 1``, vj never read (``k_null``); ``one_extract``: every
#: word xored with vj's word 0 (``k_one_extract``, plane ``(g=0, s=0)``);
#: ``xor_only``: ``xw ^ vj`` (``k_all_extracts``, ``k_xor_only``);
#: ``full``: ``BlockMix(xw ^ vj)``, the walk step; ``tr_only``: vj's
#: words alone (``k_tr_only``: the transpose)
BODIES = ("null", "one_extract", "xor_only", "full", "tr_only")


def to_bits(lanes: torch.Tensor) -> torch.Tensor:
    """u32 values in int64 lanes → the same bits as int32."""
    return torch.where(lanes >= 1 << 31, lanes - (1 << 32), lanes).to(torch.int32)


def to_lanes(bits: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns → u32 values in int64 lanes."""
    return bits.to(torch.int64) & M32


def xor_const(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x ^ c`` on u32 lanes of any shape."""
    return x ^ c


def transpose(x: torch.Tensor, xor_into: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(R, C)`` → ``(C, R)``, xored into ``xor_into`` (``(C, R)``) when
    given."""
    out = x.t().contiguous()
    return out if xor_into is None else xor_into ^ out


def bitcast_block(batch: int) -> int:
    """The ``bitcast`` layout's block at a batch of ``batch`` lanes."""
    return min(BITCAST_BLOCK, batch)


def operand_shape(layout: str, batch: int) -> tuple:
    """The shape of the gathered rows in ``layout`` at ``batch`` lanes."""
    rows = batch // LANES
    return {"row": (batch, 32), "word": (32, rows, LANES), "grouped": (4, rows, 8, LANES),
            "bitcast": (batch, 32)}[layout]


def index_map(layout: str, w, b, batch: int):
    """Flat offset into vj of word ``w`` of lane ``b`` (integers or
    broadcastable integer tensors) in ``layout`` at ``batch`` lanes."""
    if layout == "row":
        return b * 32 + w
    if layout == "word":
        return w * batch + b
    if layout == "grouped":
        rows = batch // LANES
        return (((w // 8) * rows + b // LANES) * 8 + w % 8) * LANES + b % LANES
    if layout == "bitcast":
        block = bitcast_block(batch)
        return ((b // block) * 32 + w) * block + b % block
    raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")


def layout_words(vj: torch.Tensor, layout: str, batch: int) -> torch.Tensor:
    """The ``(32, batch)`` word planes that ``layout``'s index map reads
    from ``vj``."""
    w = torch.arange(32, device=vj.device)[:, None]
    b = torch.arange(batch, device=vj.device)[None, :]
    return vj.reshape(-1)[index_map(layout, w, b, batch)]


def walk_step(xw: torch.Tensor, vj: torch.Tensor, layout: str, body: str) -> torch.Tensor:
    """One step of a layout probe: ``(32, B/128, 128)`` word planes and
    vj in ``layout`` → ``(32, B/128, 128)``, ``out[w] = body(xw[w],
    word w of vj)``. ``full`` is the walk step ``BlockMix(X ⊕ V[j])`` of
    ``ops.scrypt.romix_walk`` on word planes."""
    batch = xw.numel() // 32
    words = xw.reshape(32, batch)
    if body == "null":
        out = words ^ 1
    elif body == "one_extract":
        out = words ^ layout_words(vj, layout, batch)[0]
    elif body == "xor_only":
        out = words ^ layout_words(vj, layout, batch)
    elif body == "full":
        out = block_mix((words ^ layout_words(vj, layout, batch)).t()).t()
    elif body == "tr_only":
        out = layout_words(vj, layout, batch)
    else:
        raise ValueError(f"body must be one of {BODIES}, got {body!r}")
    return out.reshape(xw.shape).contiguous()
