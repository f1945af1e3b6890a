"""SHA-256 message templates and the plain batched hash on torch lanes.

Counterpart of ``tpuminter.ops.sha256`` (templates, ``target_to_words``)
and of the integer half of ``tpuminter.ops.symbolic`` (``CAND_E60``,
``DIGEST6_BIAS`` and the truncated second compression).

- **Templates.** A mining message is constant except for a few nonce
  bytes near its end. :func:`_build_template` compresses every block
  before the first nonce byte once on the host (the midstate) and keeps
  the rest as one or two tail blocks with the nonce bytes zeroed, plus
  where each nonce byte lands. The CUDA kernels take a template as a
  runtime argument, so one build of them serves every job; the JAX
  package instead bakes each template into its kernels' instruction
  stream (``ops.symbolic``), one compile per job.
- **Plain lanes.** The batched functions below are the kernels' plain
  versions. Torch's CPU backend has no add, shift or compare for
  ``torch.uint32``, so a u32 lane is an ``int64`` tensor holding a value
  in ``[0, 2^32)``, masked back after every add and shift. Message and
  state words may also be Python ints (template constants); they mix
  freely with tensors.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from tpuminter_torch.chain import SHA256_H0, SHA256_K, sha256_compress

__all__ = [
    "NonceTemplate",
    "toy_template",
    "header_template",
    "template_from_arrays",
    "target_to_words",
    "CAND_E60",
    "DIGEST6_BIAS",
    "digest_words",
    "e60_e61",
    "byteswap32",
    "hash_words_be",
]

M32 = 0xFFFFFFFF

#: ``e60 == CAND_E60`` ⟺ digest word 7 == 0 ⟺ the top 32 bits of the
#: 256-bit hash value are zero: necessary for every target whose top
#: word is 0 (every real Bitcoin difficulty).
CAND_E60: int = (-SHA256_H0[7]) & M32

#: digest word 6 (whose byteswap is hash word 1) = ``DIGEST6_BIAS + e61``
DIGEST6_BIAS: int = SHA256_H0[6]

#: A u32 lane: an int64 tensor in [0, 2^32), or a Python int constant.
Lane = Union[torch.Tensor, int]


@dataclass(frozen=True)
class NonceTemplate:
    """A padded SHA-256 message with a nonce-shaped hole.

    ``midstate``: state after the constant prefix blocks (8 u32).
    ``tail``: the remaining block(s), nonce bytes zeroed (1 or 2 × 16 u32).
    ``positions``: one entry per nonce byte ``(block, word, word_shift,
    nonce_shift)``: ``tail[block][word] |= ((nonce >> nonce_shift) & 0xFF)
    << word_shift``, where ``nonce = hi << 32 | lo``.
    ``double``: apply a second SHA-256 over the 32-byte digest (Bitcoin).
    """

    midstate: Tuple[int, ...]
    tail: Tuple[Tuple[int, ...], ...]
    positions: Tuple[Tuple[int, int, int, int], ...]
    double: bool = False


def _pad(message_len: int) -> bytes:
    """FIPS 180-4 padding for a ``message_len``-byte message."""
    pad = b"\x80" + b"\x00" * ((55 - message_len) % 64)
    return pad + struct.pack(">Q", message_len * 8)


def _build_template(
    message_with_hole: bytes,
    hole_offset: int,
    byte_map: Sequence[Tuple[int, int]],
    *,
    double: bool,
) -> NonceTemplate:
    """Plan a template: ``byte_map[j] = (offset_delta, nonce_shift)`` puts
    ``(nonce >> nonce_shift) & 0xFF`` at ``hole_offset + offset_delta``."""
    padded = message_with_hole + _pad(len(message_with_hole))
    first_hole_block = min(hole_offset + d for d, _ in byte_map) // 64
    state = tuple(SHA256_H0)
    for b in range(first_hole_block):
        state = sha256_compress(state, padded[b * 64 : (b + 1) * 64])
    tail_bytes = padded[first_hole_block * 64 :]
    tail = tuple(
        struct.unpack(">16I", tail_bytes[b * 64 : (b + 1) * 64])
        for b in range(len(tail_bytes) // 64)
    )
    positions = []
    for offset_delta, nonce_shift in byte_map:
        off = hole_offset + offset_delta - first_hole_block * 64
        positions.append((off // 64, (off % 64) // 4, 24 - 8 * (off % 4), nonce_shift))
    return NonceTemplate(
        midstate=state, tail=tail, positions=tuple(positions), double=double
    )


def toy_template(data: bytes) -> NonceTemplate:
    """SHA-256(data ‖ nonce_be8), any data length (≡ ``chain.toy_hash``).
    The 8 nonce bytes may be unaligned and may straddle two blocks."""
    message = data + b"\x00" * 8
    byte_map = [(j, 56 - 8 * j) for j in range(8)]
    return _build_template(message, len(data), byte_map, double=False)


def header_template(header80: bytes) -> NonceTemplate:
    """Double-SHA-256 over an 80-byte header whose last 4 bytes are the
    little-endian nonce. One tail block; the midstate covers bytes [0, 64)."""
    if len(header80) != 80:
        raise ValueError(f"header must be 80 bytes, got {len(header80)}")
    message = header80[:76] + b"\x00" * 4
    byte_map = [(j, 8 * j) for j in range(4)]  # little-endian
    return _build_template(message, 76, byte_map, double=True)


def template_from_arrays(midstate, tail, positions, double: bool) -> NonceTemplate:
    """A template from plain arrays: ``midstate`` (8,), ``tail`` (B, 16),
    ``positions`` rows of 4 ints. Carries a template planned elsewhere
    (the JAX package's ``midstate_array()``, ``tail_array()`` and
    ``positions``) into this package unchanged."""
    mid = tuple(int(x) for x in np.asarray(midstate, dtype=np.uint64).reshape(8))
    tail_arr = np.asarray(tail, dtype=np.uint64)
    if tail_arr.ndim != 2 or tail_arr.shape[1] != 16 or not 1 <= tail_arr.shape[0] <= 2:
        raise ValueError(f"tail must be (1 or 2, 16), got {tail_arr.shape}")
    pos = tuple(tuple(int(v) for v in row) for row in positions)
    if not 1 <= len(pos) <= 8 or any(len(row) != 4 for row in pos):
        raise ValueError("positions must be 1 to 8 rows of 4 ints")
    return NonceTemplate(
        midstate=mid,
        tail=tuple(tuple(int(x) for x in row) for row in tail_arr),
        positions=pos,
        double=bool(double),
    )


def target_to_words(target: int) -> np.ndarray:
    """256-bit target → msb-first u32 words, comparable with
    :func:`hash_words_be` lexicographically."""
    if not 0 <= target < 1 << 256:
        raise ValueError("target out of range")
    return np.frombuffer(target.to_bytes(32, "big"), dtype=">u4").astype(np.uint32)


# ---------------------------------------------------------------------------
# plain SHA-256 over int64 lanes
# ---------------------------------------------------------------------------

def _add(*xs: Lane) -> Lane:
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    return total & M32


def _rotr(x: Lane, n: int) -> Lane:
    return ((x >> n) | (x << (32 - n))) & M32


def _sigma0(x: Lane) -> Lane:
    return _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)


def _sigma1(x: Lane) -> Lane:
    return _rotr(x, 17) ^ _rotr(x, 19) ^ (x >> 10)


def _round(v: List[Lane], k: int, w: Lane) -> List[Lane]:
    a, b, c, d, e, f, g, h = v
    t1 = _add(h, _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25), g ^ (e & (f ^ g)), k, w)
    t2 = _add(_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22), (a & b) ^ (c & (a ^ b)))
    return [_add(t1, t2), a, b, c, _add(d, t1), e, f, g]


def _schedule(block: Sequence[Lane], count: int) -> List[Lane]:
    w = list(block)
    for i in range(16, count):
        w.append(_add(w[i - 16], _sigma0(w[i - 15]), w[i - 7], _sigma1(w[i - 2])))
    return w


def _compress(state: Sequence[Lane], block: Sequence[Lane]) -> List[Lane]:
    """One compression (≡ ``chain.sha256_compress``) over lanes."""
    w = _schedule(block, 64)
    v = list(state)
    for i in range(64):
        v = _round(v, SHA256_K[i], w[i])
    return [_add(s, x) for s, x in zip(state, v)]


def _compress_e60_e61(state: Sequence[Lane], block: Sequence[Lane]):
    """The ``e`` values after rounds 60 and 61: digest word 7 is
    ``state[7] + e60`` and word 6 is ``state[6] + e61``, so a test on the
    hash's top 64 bits stops two rounds short of a full compression."""
    w = _schedule(block, 62)
    v = list(state)
    for i in range(61):
        v = _round(v, SHA256_K[i], w[i])
    e60 = v[4]
    v = _round(v, SHA256_K[61], w[61])
    return e60, v[4]


def _message(template: NonceTemplate, hi: Lane, lo: Lane) -> List[List[Lane]]:
    """The tail blocks with the nonce bytes ORed in at their positions."""
    blocks: List[List[Lane]] = [list(b) for b in template.tail]
    for block, word, word_shift, nonce_shift in template.positions:
        src = hi if nonce_shift >= 32 else lo
        byte = (src >> (nonce_shift % 32)) & 0xFF
        blocks[block][word] = blocks[block][word] | (byte << word_shift)
    return blocks


def _first_hash(template: NonceTemplate, hi: Lane, lo: Lane) -> List[Lane]:
    state: List[Lane] = list(template.midstate)
    for block in _message(template, hi, lo):
        state = _compress(state, block)
    return state


_SECOND_PAD = (0x80000000, 0, 0, 0, 0, 0, 0, 256)


def digest_words(template: NonceTemplate, hi: Lane, lo: Lane) -> List[torch.Tensor]:
    """Digest words (big-endian u32, msb word first) of the template's
    hash for nonces ``hi << 32 | lo``: eight lanes shaped like the nonce
    lanes. Applies the second SHA-256 when ``template.double``."""
    state = _first_hash(template, hi, lo)
    if template.double:
        state = _compress(SHA256_H0, list(state) + list(_SECOND_PAD))
    like = hi if isinstance(hi, torch.Tensor) else lo
    return [torch.as_tensor(s).expand_as(like) if isinstance(s, int) else s for s in state]


def e60_e61(template: NonceTemplate, hi: Lane, lo: Lane):
    """``(e60, e61)`` of the second compression of a double-SHA template."""
    if not template.double:
        raise ValueError("e60/e61 are defined for double-SHA templates")
    state = _first_hash(template, hi, lo)
    return _compress_e60_e61(SHA256_H0, list(state) + list(_SECOND_PAD))


def byteswap32(x: Lane) -> Lane:
    """Per-lane u32 byte swap."""
    return (
        ((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
        | ((x >> 8) & 0xFF00) | ((x >> 24) & 0xFF)
    )


def hash_words_be(digest: Sequence[Lane]) -> List[Lane]:
    """Digest words → the 256-bit hash value as u32 words, most
    significant first: Bitcoin reads the digest as a little-endian
    integer, so word j = byteswap(digest[7 - j])."""
    return [byteswap32(digest[7 - j]) for j in range(8)]
