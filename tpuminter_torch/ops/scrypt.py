"""Scrypt (RFC 7914) on torch lanes: the plain versions of the SCRYPT kernels.

Counterpart of ``tpuminter.ops.scrypt`` (``salsa20_8``, ``block_mix``,
``romix``, ``scrypt_header_batch``, ``header_to_words``) and of the
batch fold of ``tpuminter.jax_worker._scrypt_step``. Litecoin-style
header mining: ``scrypt(P=header80, S=header80, N=2^n_log2, r=1, p=1,
dkLen=32)``, whose 32 bytes are read as a little-endian 256-bit value
and compared against the target like a double-SHA hash.

The pipeline, in the three pieces the CUDA kernels (``kernels.scrypt``)
compute:

- **front** (S1): :func:`pbkdf2_in` (13 SHA-256 compressions: the key
  SHA256(header80), the two HMAC states, the salt's first block, and
  four HMAC blocks) gives X, 32 little-endian words; :func:`romix_fill`
  writes ``V[i] = BlockMix^i(X)`` for ``i < N``;
- **walk** (kernel 19): :func:`romix_walk`, ``X ← BlockMix(X ⊕
  V[Integerify(X) mod N])``, Integerify being X word 16;
- **back** (S2): :func:`pbkdf2_out` (the key and HMAC states again,
  the key's first block from :func:`key_state`, computed once a job,
  then four compressions) gives the digest words, and
  :func:`batch_fold` the batch's found flag, first winning lane and
  lexicographic-minimum lane.

u32 words are ``int64`` lanes holding ``[0, 2^32)`` (torch's CPU
backend has no uint32 arithmetic). X is ``(B, 32)``; V is ``(N, S,
32)``, row ``j`` of lane ``b`` at ``V[j, b]``, as the reference's flat
``V[j·B + b]`` with a lane stride ``S >= B`` (the miner keeps one V
for its full batch and runs a ragged last batch in its first lanes).
``n_log2`` is a run-time argument everywhere.

Salsa20/8 runs on the four quarter-rounds of a column or row round at
once: the state is held as four ``(..., 4)`` diagonals (the usual SIMD
layout), so the k-th step of all four quarter-rounds is one operation
on a ``(B, 4)`` lane block, and a row round is a column round on the
diagonals rotated by one, two and three lanes. That cuts the count of
torch calls, which sets the plain version's cost, about fourfold.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from tpuminter_torch.chain import SHA256_H0
from tpuminter_torch.ops.sha256 import M32, _compress, byteswap32, hash_words_be

__all__ = [
    "HEADER_WORDS", "HANDLE_WORDS", "NOT_FOUND", "salsa20_8", "block_mix",
    "romix_fill", "romix_walk", "romix", "pbkdf2_in", "pbkdf2_out", "key_state",
    "scrypt_header_batch", "batch_fold", "header_to_words", "row_gather",
]

#: words of the 76-byte constant header prefix (the nonce completes it)
HEADER_WORDS = 19
#: a batch's packed result: ``[found, first_lane, min_words[8],
#: min_lane, first_words[8]]``, hash words msb-first
HANDLE_WORDS = 19
#: ``first_lane`` when no lane of the batch meets the target
NOT_FOUND = 0x7FFFFFFF
#: the row-gather probe's stride between passes (``romix_pallas_probe``)
GATHER_STEP = 977

_I64 = torch.int64
#: SHA-256 padding of an 80-byte message, after its 20 words
_KEY_PAD = (0x80000000,) + (0,) * 10 + (640,)
#: outer-HMAC second block: 0x80 pad + bit length of opad(64) ‖ digest(32)
_OUTER_PAD = (0x80000000, 0, 0, 0, 0, 0, 0, 768)
#: the state as four diagonals: (x0,x5,x10,x15), (x4,x9,x14,x3),
#: (x8,x13,x2,x7), (x12,x1,x6,x11)
_DIAG = (0, 5, 10, 15, 4, 9, 14, 3, 8, 13, 2, 7, 12, 1, 6, 11)
_UNDIAG = tuple(int(i) for i in np.argsort(_DIAG))


def _step(t: torch.Tensor, a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """``t ^ rotl(a + b, n)``: one step of four quarter-rounds. The
    rotation is left unmasked, so words carry bits 32-49 between steps
    (below 2^51: no sum or shift overflows int64); the sum is masked
    before the rotation reads it, and :func:`salsa20_8` masks its
    output. One torch call fewer a step."""
    s = (a + b) & M32
    return t ^ ((s << n) | (s >> (32 - n)))


def salsa20_8(x: torch.Tensor) -> torch.Tensor:
    """Salsa20/8 core: ``(..., 16)`` little-endian words → same shape
    (RFC 7914 §2): four double rounds, then the feed-forward add."""
    d = x[..., list(_DIAG)]
    a0, a1, a2, a3 = d[..., 0:4], d[..., 4:8], d[..., 8:12], d[..., 12:16]
    for _ in range(4):
        # column round: quarter-round k on lane k of each diagonal
        a1 = _step(a1, a0, a3, 7)
        a2 = _step(a2, a1, a0, 9)
        a3 = _step(a3, a2, a1, 13)
        a0 = _step(a0, a3, a2, 18)
        # row round: the same steps on diagonals rotated so that lane k
        # holds row k's words, (x1,x6,x11,x12), (x2,x7,x8,x13), (x3,x4,x9,x14)
        r3, r2, r1 = a3.roll(-1, -1), a2.roll(2, -1), a1.roll(1, -1)
        r3 = _step(r3, a0, r1, 7)
        r2 = _step(r2, r3, a0, 9)
        r1 = _step(r1, r2, r3, 13)
        a0 = _step(a0, r1, r2, 18)
        a1, a2, a3 = r1.roll(-1, -1), r2.roll(2, -1), r3.roll(1, -1)
    mixed = torch.cat([a0, a1, a2, a3], -1)[..., list(_UNDIAG)]
    return (x + mixed) & M32


def block_mix(x: torch.Tensor) -> torch.Tensor:
    """scryptBlockMix for r=1: ``(..., 32)`` LE words → same shape
    (RFC 7914 §4): ``Y0 = salsa(B1 ^ B0)``, ``Y1 = salsa(Y0 ^ B1)``."""
    b0, b1 = x[..., :16], x[..., 16:]
    y0 = salsa20_8(b1 ^ b0)
    return torch.cat([y0, salsa20_8(y0 ^ b1)], -1)


def _check_v(x: torch.Tensor, v: torch.Tensor, n_log2: int) -> None:
    if not 1 <= n_log2 <= 20:
        raise ValueError("n_log2 must be in [1, 20]")
    if v.dim() != 3 or v.shape[0] != 1 << n_log2 or v.shape[2] != 32 \
            or v.shape[1] < x.shape[0]:
        raise ValueError(f"V must be (2^{n_log2}, S >= {x.shape[0]}, 32), got {tuple(v.shape)}")


def romix_fill(x: torch.Tensor, v: torch.Tensor, n_log2: int) -> torch.Tensor:
    """ROMix phase 1 (RFC 7914 §5 steps 2-3): writes ``V[i, :B] =
    BlockMix^i(X)`` for ``i < N`` in place and returns ``BlockMix^N(X)``."""
    _check_v(x, v, n_log2)
    b = x.shape[0]
    for i in range(1 << n_log2):
        v[i, :b] = x
        x = block_mix(x)
    return x


def romix_walk(x: torch.Tensor, v: torch.Tensor, n_log2: int, steps: int) -> torch.Tensor:
    """``steps`` steps of ROMix phase 2 (RFC 7914 §5 steps 4-5):
    ``X ← BlockMix(X ⊕ V[X[16] mod N, lane])``. The full walk is
    ``steps = N``. V may also hold the words as int32 bit patterns (the
    kernels' scratch)."""
    _check_v(x, v, n_log2)
    lane = torch.arange(x.shape[0], device=x.device)
    for _ in range(steps):
        x = block_mix(x ^ (v[x[:, 16] & ((1 << n_log2) - 1), lane].to(_I64) & M32))
    return x


def romix(x: torch.Tensor, n_log2: int) -> torch.Tensor:
    """scryptROMix for r=1 on a ``(B, 32)`` batch (≡ the reference's
    ``romix``), with its own V."""
    v = torch.empty((1 << n_log2, x.shape[0], 32), dtype=_I64, device=x.device)
    return romix_walk(romix_fill(x, v, n_log2), v, n_log2, 1 << n_log2)


# ---------------------------------------------------------------------------
# PBKDF2-HMAC-SHA256 (c = 1) around ROMix
# ---------------------------------------------------------------------------

def _header(header_words: Sequence[int]) -> List[int]:
    words = [int(w) for w in header_words]
    if len(words) != HEADER_WORDS or any(not 0 <= w <= M32 for w in words):
        raise ValueError(f"header_words must be {HEADER_WORDS} u32 words")
    return words


def key_state(header_words: Sequence[int]) -> tuple:
    """SHA-256's state after the header's first 64 bytes (its first 16
    words): the first block of the HMAC key SHA256(header80), the same
    for every nonce of a job, as 8 ints."""
    return tuple(_compress(SHA256_H0, _header(header_words)[:16]))


def _hmac_states(header: List[int], nw: torch.Tensor, key: Sequence[int] = None):
    """The inner and outer HMAC states keyed by SHA256(header80): the
    key's first block is the header's first 16 words (or ``key``, their
    :func:`key_state`), its second the last three, the nonce word ``nw``
    and the padding. The two pad blocks run as one compression over
    ``2B`` lanes (the plain version's cost is its count of torch
    calls)."""
    first = list(key) if key is not None else _compress(SHA256_H0, header[:16])
    key8 = _compress(first, header[16:] + [nw, *_KEY_PAD])
    b = nw.shape[0]
    pad = torch.full((2 * b,), 0x36363636, dtype=_I64, device=nw.device)
    pad[b:] = 0x5C5C5C5C
    states = _compress(SHA256_H0, [torch.cat([k, k]) ^ pad for k in key8] + [pad] * 8)
    return [s[:b] for s in states], [s[b:] for s in states]


def pbkdf2_in(header_words: Sequence[int], nonces: torch.Tensor) -> torch.Tensor:
    """``B = PBKDF2(P=hdr, S=hdr, c=1, dkLen=128)`` for ``hdr =
    header76 ‖ nonce_le``: 19 header words (big-endian) and ``(B,)``
    nonce lanes → X, ``(B, 32)`` little-endian words. The four HMAC
    blocks (``INT_BE(i)``, ``i`` = 1-4) run side by side as ``4B``
    lanes."""
    header = _header(header_words)
    b = nonces.shape[0]
    nw = byteswap32(nonces)  # the LE nonce bytes as a BE schedule word
    istate, ostate = _hmac_states(header, nw)
    mid = _compress(istate, header[:16])
    block = torch.arange(1, 5, dtype=_I64, device=nonces.device).repeat_interleave(b)
    inner = _compress([m.repeat(4) for m in mid],
                      header[16:] + [nw.repeat(4), block, 0x80000000] + [0] * 9 + [1184])
    t = _compress([o.repeat(4) for o in ostate], inner + list(_OUTER_PAD))
    # lane i·B + b holds block i + 1 of lane b: X_b = T_1 ‖ T_2 ‖ T_3 ‖ T_4
    words = torch.stack([byteswap32(w) for w in t], -1)
    return words.view(4, b, 8).permute(1, 0, 2).reshape(b, 32)


def pbkdf2_out(header_words: Sequence[int], nonces: torch.Tensor, x: torch.Tensor,
               key: Sequence[int] = None) -> torch.Tensor:
    """``PBKDF2(P=hdr, S=X, c=1, dkLen=32)``: X after ROMix → the
    ``(B, 8)`` big-endian digest words (the reference's
    ``scrypt_header_batch`` output convention). ``key``, the header's
    :func:`key_state`, skips its compression (S2's split)."""
    istate, ostate = _hmac_states(_header(header_words), byteswap32(nonces), key)
    bp = [byteswap32(x[:, i]) for i in range(32)]
    st = _compress(_compress(istate, bp[:16]), bp[16:])
    inner = _compress(st, [1, 0x80000000] + [0] * 13 + [1568])
    return torch.stack(_compress(ostate, inner + list(_OUTER_PAD)), -1)


def scrypt_header_batch(header_words: Sequence[int], nonces: torch.Tensor,
                        n_log2: int = 10) -> torch.Tensor:
    """Scrypt PoW digests of a nonce batch: 19 header words × ``(B,)``
    nonces → ``(B, 8)`` big-endian digest words, ≡
    ``hashlib.scrypt(hdr, salt=hdr, n=2**n_log2, r=1, p=1, dklen=32)``."""
    x = romix(pbkdf2_in(header_words, nonces), n_log2)
    return pbkdf2_out(header_words, nonces, x)


def batch_fold(digest: torch.Tensor, target_words: Sequence[int]) -> torch.Tensor:
    """A batch's ``(B, 8)`` digest words against msb-first target words
    → its packed result (:data:`HANDLE_WORDS` int64 words): found (any
    hash value ``<=`` the target), the lowest such lane
    (:data:`NOT_FOUND` if none), the lexicographic minimum's hash words
    and lane (ties to the lowest lane), and the first winner's hash
    words (zeros if none). No host sync."""
    hw = hash_words_be([digest[:, k] for k in range(8)])
    lt = torch.zeros_like(hw[0], dtype=torch.bool)
    eq = torch.ones_like(lt)
    for w, t in zip(hw, target_words):
        lt |= eq & (w < int(t))
        eq &= w == int(t)
    ok = lt | eq
    found = ok.any()
    first = ok.to(_I64).argmax()  # the first maximum: the lowest winning lane
    mask = torch.ones_like(lt)
    for w in hw:
        col = torch.where(mask, w, M32 + 1)
        mask &= col == col.min()
    lane_min = mask.to(_I64).argmax()
    words = torch.stack(hw, -1)
    return torch.cat([
        found.to(_I64).view(1), torch.where(found, first, NOT_FOUND).view(1),
        words[lane_min], lane_min.view(1), words[first] * found,
    ])


def header_to_words(header_prefix76: bytes) -> tuple:
    """76-byte header prefix → the 19 big-endian u32 words the batch
    functions take."""
    if len(header_prefix76) != 76:
        raise ValueError(f"header prefix must be 76 bytes, got {len(header_prefix76)}")
    return tuple(int(w) for w in np.frombuffer(header_prefix76, dtype=">u4"))


def row_gather(v: torch.Tensor, idx: torch.Tensor, reps: int) -> torch.Tensor:
    """The row-gather probe's function: ``(rows, 32)`` words and ``(B,)``
    row indices → ``(B,)`` lanes, each the xor of every word of the rows
    ``(idx + r · 977) mod rows`` for ``r < reps``. The words may be
    int64 lanes or int32 bit patterns."""
    rows = v.shape[0]
    acc = torch.zeros_like(idx)
    for r in range(reps):
        g = v[(idx + r * GATHER_STEP) % rows].to(_I64) & M32
        while g.shape[-1] > 1:
            half = g.shape[-1] // 2
            g = g[..., :half] ^ g[..., half:]
        acc ^= g[..., 0]
    return acc
