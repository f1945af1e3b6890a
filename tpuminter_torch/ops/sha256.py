"""SHA-256 message templates and the plain batched hash on torch lanes.

Counterpart of ``tpuminter.ops.sha256`` (templates, ``target_to_words``,
the dynamic-header hashes ``header_digest_dyn`` and
``header_e60_e61_dyn``) and of the integer half of
``tpuminter.ops.symbolic`` (``CAND_E60``, ``DIGEST6_BIAS``, the
truncated second compression, and the shared-schedule split
``prepare_hdr`` / ``hash_prepared_e60_e61``, with its full-digest
counterpart ``hash_prepared_digest``).

- **Templates.** A mining message is constant except for a few nonce
  bytes near its end. :func:`_build_template` compresses every block
  before the first nonce byte once on the host (the midstate) and keeps
  the rest as one or two tail blocks with the nonce bytes zeroed, plus
  where each nonce byte lands. The CUDA kernels take a template as a
  runtime argument, so one build of them serves every job; the JAX
  package instead bakes each template into its kernels' instruction
  stream (``ops.symbolic``), one compile per job.
- **Dynamic headers.** A rolled job's header changes with its
  extranonce, so the rolled kernels take the header's midstate and its
  three tail words before the nonce (Merkle word 7, time, bits) as
  values, not as a template: :func:`header_digest_dyn`,
  :func:`header_e60_e61_dyn`, and :func:`prepare_hdr` with
  :func:`hash_prepared_e60_e61`, which compute once per header what no
  nonce changes (rounds 0-2 and four schedule words).
- **Toy messages.** :func:`toy_words` recognises :func:`toy_template`'s
  exact shape, as :func:`header_words` does :func:`header_template`'s;
  :func:`toy_launch` folds a high nonce word into it for one launch of
  K6's toy arm, and :func:`toy_fold_words` is that arm's formula.
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
from typing import List, Optional, Sequence, Tuple, Union

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
    "HEADER_TAIL_PAD",
    "HEADER_NONCE_POSITIONS",
    "header_words",
    "header_digest_dyn",
    "header_e60_e61_dyn",
    "prepare_hdr",
    "hash_prepared_e60_e61",
    "hash_prepared_digest",
    "ToyWords",
    "ToyLaunch",
    "toy_words",
    "toy_launch",
    "toy_fold_words",
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


# ---------------------------------------------------------------------------
# dynamic headers: midstate and tail words as values
# ---------------------------------------------------------------------------

#: schedule words 4..15 of an 80-byte header's tail block: the FIPS
#: padding of an 80-byte message (0x80, then the 640-bit length)
HEADER_TAIL_PAD: Tuple[int, ...] = (0x80000000, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 640)

#: the nonce's byte positions in an 80-byte header's tail block, as
#: :func:`header_template` plans them: the little-endian nonce in word 3
HEADER_NONCE_POSITIONS: Tuple[Tuple[int, int, int, int], ...] = (
    (0, 3, 24, 0), (0, 3, 16, 8), (0, 3, 8, 16), (0, 3, 0, 24),
)


def header_words(template: NonceTemplate):
    """``(midstate8, t0, t1, t2)`` when ``template`` has exactly the shape
    :func:`header_template` gives it: double SHA, one tail block, the
    nonce little-endian in tail word 3 (zeroed), tail words 4-15 the FIPS
    padding of an 80-byte message. ``None`` for any other template."""
    tail = template.tail[0] if len(template.tail) == 1 else ()
    if (not template.double or len(tail) != 16 or tail[3] != 0
            or tuple(tail[4:]) != HEADER_TAIL_PAD
            or tuple(template.positions) != HEADER_NONCE_POSITIONS):
        return None
    return tuple(template.midstate), tail[0], tail[1], tail[2]


def _header_block(tailw3: Sequence[Lane], nonces: Lane) -> List[Lane]:
    # the little-endian nonce at header offset 76, read as a big-endian
    # schedule word, is byteswap(nonce)
    return [tailw3[0], tailw3[1], tailw3[2], byteswap32(nonces), *HEADER_TAIL_PAD]


def header_digest_dyn(midstate8: Sequence[Lane], tailw3: Sequence[Lane],
                      nonces: Lane) -> List[Lane]:
    """Double-SHA-256 digest words of a header given by its midstate (8
    words) and tail words ``(merkle word 7, time, bits)``, for each nonce
    lane (≡ ``digest_words(header_template(header), 0, nonces)``)."""
    state = _compress(midstate8, _header_block(tailw3, nonces))
    return _compress(SHA256_H0, list(state) + list(_SECOND_PAD))


def header_e60_e61_dyn(midstate8: Sequence[Lane], tailw3: Sequence[Lane],
                       nonces: Lane):
    """``(e60, e61)`` of the second compression for a dynamic header."""
    state = _compress(midstate8, _header_block(tailw3, nonces))
    return _compress_e60_e61(SHA256_H0, list(state) + list(_SECOND_PAD))


def prepare_hdr(midstate8: Sequence[Lane], t0: Lane, t1: Lane, t2: Lane) -> Tuple:
    """What no nonce changes in a header's first-hash tail block: the
    state after rounds 0-2 (the nonce enters at word 3), schedule words
    ``w16`` and ``w17``, and the nonce-free parts ``p18`` (missing
    ``σ0(w3)``) and ``p19`` (missing ``w3``) of ``w18`` and ``w19``.
    Feed it to :func:`hash_prepared_e60_e61`."""
    v = list(midstate8)
    for i, wi in enumerate((t0, t1, t2)):
        v = _round(v, SHA256_K[i], wi)
    pad = HEADER_TAIL_PAD  # schedule word k >= 4 is pad[k - 4]
    w16 = _add(t0, _sigma0(t1), pad[5], _sigma1(pad[10]))
    w17 = _add(t1, _sigma0(t2), pad[6], _sigma1(pad[11]))
    p18 = _add(t2, pad[7], _sigma1(w16))
    p19 = _add(_sigma0(pad[0]), pad[8], _sigma1(w17))
    return tuple(midstate8), tuple(v), w16, w17, p18, p19


def _prepared_first(prep: Tuple, nonces: Lane) -> List[Lane]:
    """The first hash from a :func:`prepare_hdr` stage: rounds 3-63 and
    the feed-forward."""
    midstate8, v, w16, w17, p18, p19 = prep
    w3 = byteswap32(nonces)
    w: List[Lane] = [0, 0, 0, w3, *HEADER_TAIL_PAD,  # w0..w2 are dead past round 2
                     w16, w17, _add(p18, _sigma0(w3)), _add(p19, w3)]
    for i in range(20, 64):
        w.append(_add(w[i - 16], _sigma0(w[i - 15]), w[i - 7], _sigma1(w[i - 2])))
    v = list(v)
    for i in range(3, 64):
        v = _round(v, SHA256_K[i], w[i])
    return [_add(s, x) for s, x in zip(midstate8, v)]


def hash_prepared_e60_e61(prep: Tuple, nonces: Lane):
    """``(e60, e61)`` from a :func:`prepare_hdr` stage: rounds 3-63 of
    the first hash, then the truncated second compression (≡
    :func:`header_e60_e61_dyn` on the same header)."""
    return _compress_e60_e61(SHA256_H0, _prepared_first(prep, nonces) + list(_SECOND_PAD))


def hash_prepared_digest(prep: Tuple, nonces: Lane) -> List[Lane]:
    """The double-SHA digest words from a :func:`prepare_hdr` stage (≡
    :func:`header_digest_dyn` on the same header)."""
    return _compress(SHA256_H0, _prepared_first(prep, nonces) + list(_SECOND_PAD))


# ---------------------------------------------------------------------------
# toy messages: the MIN dialect's data ‖ nonce_be8
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ToyWords:
    """A template of :func:`toy_template`'s exact shape: its ``midstate``,
    its ``tail`` blocks (nonce bytes zero) and ``offset``, the byte of
    the first tail block at which the nonce begins (``len(data) % 64``)."""

    midstate: Tuple[int, ...]
    tail: Tuple[Tuple[int, ...], ...]
    offset: int


@dataclass(frozen=True)
class ToyLaunch:
    """A toy template with its high nonce word fixed, as one launch of
    the toy arm takes it. ``midstate``: the state before the block that
    holds the low word's first byte (a block the high word ends in is
    compressed into it). ``block``: that block, the low word's bytes
    zero. ``block1``: the next block's words 0, 14 and 15, its low-word
    bytes zero (zeros when there is none; its words 1-13 are zero).
    ``k``: the block's word at which the low word begins, ``shift``: its
    bit offset there (0, 8, 16 or 24). The low word is ``block[k] |=
    lo >> shift`` and, past that word, ``lo << (32 - shift)`` ORed into
    the next word (``block1[0]`` when ``k`` is 15); ``k >= 13`` exactly
    when there is a next block."""

    midstate: Tuple[int, ...]
    block: Tuple[int, ...]
    block1: Tuple[int, int, int]
    k: int
    shift: int


def _toy_positions(offset: int) -> Tuple[Tuple[int, int, int, int], ...]:
    """:func:`toy_template`'s nonce positions for a nonce at ``offset``."""
    out = []
    for j in range(8):
        at = offset + j
        out.append((at // 64, (at % 64) // 4, 24 - 8 * (at % 4), 56 - 8 * j))
    return tuple(out)


def toy_words(template: NonceTemplate) -> Optional[ToyWords]:
    """A :class:`ToyWords` when ``template`` has exactly the shape
    :func:`toy_template` gives it: single SHA, the 8 nonce bytes
    big-endian and in order from byte ``offset`` of the first tail block,
    zeroed, then the FIPS padding of a message that ends with them, in
    as many tail blocks as that needs. ``None`` for any other template."""
    if template.double or len(template.positions) != 8 or template.positions[0][0] != 0:
        return None
    _, word, wshift, _ = template.positions[0]
    if wshift not in (0, 8, 16, 24):
        return None
    offset = 4 * word + (24 - wshift) // 8
    if (tuple(template.positions) != _toy_positions(offset)
            or len(template.tail) != (1 if offset <= 47 else 2)
            or any(len(b) != 16 for b in template.tail)):
        return None
    tail = b"".join(struct.pack(">16I", *b) for b in template.tail)
    length = int.from_bytes(tail[-8:], "big") // 8  # message bytes, nonce included
    if (tail[offset:offset + 9] != bytes(8) + b"\x80" or any(tail[offset + 9:-8])
            or length % 64 != (offset + 8) % 64 or length < offset + 8
            or int.from_bytes(tail[-8:], "big") % 8):
        return None
    return ToyWords(tuple(template.midstate), tuple(tuple(b) for b in template.tail), offset)


def toy_launch(words: ToyWords, hi: int) -> ToyLaunch:
    """The :class:`ToyLaunch` of ``words`` for high nonce word ``hi``."""
    blocks = [list(b) for b in words.tail]
    for block, word, wshift, nshift in _toy_positions(words.offset)[:4]:
        blocks[block][word] |= ((hi >> (nshift - 32)) & 0xFF) << wshift
    mid = list(words.midstate)
    at = words.offset + 4  # the low word's first byte
    if at >= 64:  # the first block holds no byte of it
        mid = _compress(mid, blocks.pop(0))
        at -= 64
    block1 = (blocks[1][0], blocks[1][14], blocks[1][15]) if len(blocks) == 2 else (0, 0, 0)
    return ToyLaunch(tuple(mid), tuple(blocks[0]), block1, at // 4, 8 * (at % 4))


def toy_fold_words(launch: ToyLaunch, lo: Lane):
    """Digest words 0 and 1 (the MIN fold's high and low word) of the
    toy hash of nonces ``hi << 32 | lo`` by the toy arm's formula: the
    low word ORed in at ``(k, shift)``, rounds ``0..k-1`` on the launch's
    constants alone, the rest on the lanes, then the next block if any."""
    k, shift = launch.k, launch.shift
    spill = ((lo << (32 - shift)) & M32) if shift else 0
    w: List[Lane] = list(launch.block)
    w[k] = w[k] | (lo >> shift)
    if k < 15:
        w[k + 1] = w[k + 1] | spill
    v: List[Lane] = list(launch.midstate)
    for i in range(k):  # the nonce-free prefix
        v = _round(v, SHA256_K[i], w[i])
    sched = _schedule(w, 64)
    for i in range(k, 64):
        v = _round(v, SHA256_K[i], sched[i])
    state = [_add(s, x) for s, x in zip(launch.midstate, v)]
    if k >= 13:
        b0, b14, b15 = launch.block1
        state = _compress(state, [b0 | spill if k == 15 else b0, *[0] * 13, b14, b15])
    return state[0], state[1]
