"""The extranonce roll on torch lanes: extranonce → coinbase txid → branch
fold → header midstate and tail words.

Counterpart of ``tpuminter.ops.merkle``. A rolled job's header changes
with its extranonce; the rolled kernels want each header as its
midstate (the state after bytes [0, 64)) and its tail words (Merkle
word 7, time, bits). :func:`build_roll` plans a job's constants once on
the host (≡ the reference's ``_build_roll`` outside its traced body):
the coinbase as a double-SHA template whose nonce hole is the
extranonce, the branch's words, and the header's words 0-8 with time
and bits. :func:`roll_plain` is the roll itself over int64 lanes (≡ the
body of ``make_extranonce_roll_batch``), the plain version of the CUDA
kernel ``tm_extranonce_roll`` (``kernels.extranonce_roll``).

The reference's scalar ``make_extranonce_roll`` is the batched roll at
one row here, and its factories' jit caches have no counterpart: the
kernel takes the job's constants as a device buffer, so one build
serves every job. :func:`roll_batch_deduped` rolls each distinct
extranonce of a window once and copies it to its rows, without the
reference's padding of the distinct rows to a power of two (a rule for
bucketing jit shapes; rows are identical either way).

Host reference: ``chain.rolled_header`` (the tests hold both equal).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from tpuminter_torch.chain import HEADER_SIZE, SHA256_H0
from tpuminter_torch.ops import sha256 as ops

__all__ = ["RollJob", "build_roll", "extranonce_place", "roll_plain", "roll_batch_deduped",
           "to_device"]

#: FIPS padding block of a 64-byte message (a Merkle pair)
_PAD512 = (0x80000000,) + (0,) * 14 + (512,)
#: second-hash block words 8..15 of a 32-byte digest
_PAD256 = (0x80000000, 0, 0, 0, 0, 0, 0, 256)

#: roll(en_hi, en_lo) -> (midstates (B, 8), tail words (B, 3)), int64 lanes
RollFn = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


@dataclass(frozen=True)
class RollJob:
    """One rolled job's constants. ``coinbase``: the coinbase as a
    double-SHA template whose nonce is the extranonce (little-endian at
    the prefix/suffix seam); ``branch``: each sibling as 8 big-endian
    words; ``head9``: header words 0-8 (version, previous hash);
    ``time_bits``: header words 17 and 18."""

    coinbase: ops.NonceTemplate
    branch: Tuple[Tuple[int, ...], ...]
    head9: Tuple[int, ...]
    time_bits: Tuple[int, int]

    def words(self) -> list:
        """The job as the roll kernel's u32 word buffer (layout in
        ``csrc/sha256.cu``, ``extranonce_roll_kernel``): the coinbase
        midstate, :func:`extranonce_place`, the tail blocks, the branch,
        and header words 0-8, time, bits and a zero."""
        cb = self.coinbase
        out = list(cb.midstate) + list(extranonce_place(cb))
        for block in cb.tail:
            out += block
        for sib in self.branch:
            out += sib
        return out + list(self.head9) + list(self.time_bits) + [0]


def extranonce_place(coinbase: ops.NonceTemplate) -> Tuple[int, int, int, int]:
    """Where the roll kernel puts the extranonce, resolved once a job from
    the template's byte positions: ``(g0, k, mask_hi, mask_lo)``.

    The extranonce's bytes in message order (byte ``j`` is ``en >> 8j``)
    form an 8-byte stream whose first word is ``bswap32(en_lo)`` and
    second ``bswap32(en_hi)``; ``mask_hi:mask_lo`` keeps the first
    ``size`` bytes of it. Its first byte is tail byte ``4·g0 + k/8``, so
    shifted right by ``k`` bits the stream's three words are ORed into
    tail words ``g0``, ``g0 + 1`` and ``g0 + 2`` (``g0 < 16``: the first
    tail block holds the first byte). Refuses positions that are not
    consecutive little-endian bytes from nonce bit 0."""
    pos = sorted(coinbase.positions, key=lambda p: p[3])
    size = len(pos)
    offsets = [64 * block + 4 * word + 3 - wshift // 8 for block, word, wshift, _ in pos]
    start = offsets[0] if pos else -1
    if (not 1 <= size <= 8 or not 0 <= start < 64
            or [p[3] for p in pos] != [8 * j for j in range(size)]
            or any(p[2] % 8 or not 0 <= p[2] <= 24 for p in pos)
            or offsets != list(range(start, start + size))):
        raise ValueError("the extranonce must be 1-8 consecutive little-endian bytes "
                         "starting in the first tail block")
    stream = ((1 << 8 * size) - 1) << (64 - 8 * size)
    return start // 4, 8 * (start % 4), stream >> 32, stream & 0xFFFFFFFF


def build_roll(header80: bytes, coinbase_prefix: bytes, coinbase_suffix: bytes,
               extranonce_size: int, branch: Sequence[bytes]) -> RollJob:
    """Plan a job's roll. ``header80``'s Merkle root is ignored (the roll
    recomputes it); the coinbase is leaf 0 of the tree."""
    if len(header80) != HEADER_SIZE:
        raise ValueError(f"header must be {HEADER_SIZE} bytes, got {len(header80)}")
    if not 1 <= extranonce_size <= 8:
        raise ValueError("extranonce_size must be in [1, 8]")
    if any(len(sib) != 32 for sib in branch):
        raise ValueError("merkle branch entries must be 32 bytes")
    message = coinbase_prefix + b"\x00" * extranonce_size + coinbase_suffix
    coinbase = ops._build_template(
        message, len(coinbase_prefix), [(j, 8 * j) for j in range(extranonce_size)],
        double=True,
    )
    return RollJob(
        coinbase=coinbase,
        branch=tuple(struct.unpack(">8I", sib) for sib in branch),
        head9=struct.unpack(">9I", header80[:36]),
        time_bits=struct.unpack(">2I", header80[68:76]),
    )


def _dsha256_pair(left: Sequence, right: Sequence) -> list:
    """Double SHA-256 of two 32-byte nodes given as 8 words each."""
    state = ops._compress(SHA256_H0, list(left) + list(right))
    state = ops._compress(state, _PAD512)
    return ops._compress(SHA256_H0, list(state) + list(_PAD256))


def roll_plain(job: RollJob, en_hi: torch.Tensor, en_lo: torch.Tensor):
    """``(B,) × 2`` extranonce halves → ``(midstates (B, 8), tail words
    (B, 3))``, int64 lanes on ``en_lo``'s device."""
    node = ops.digest_words(job.coinbase, en_hi, en_lo)  # the coinbase txid
    for sib in job.branch:
        node = _dsha256_pair(node, sib)  # the coinbase is always the left input
    mid = ops._compress(SHA256_H0, list(job.head9) + list(node[:7]))
    tail = [node[7], *job.time_bits]

    def stack(words):
        return torch.stack([w.expand_as(en_lo) if isinstance(w, torch.Tensor)
                            else torch.full_like(en_lo, w) for w in words], 1)

    return stack(mid), stack(tail)


def to_device(values, device) -> torch.Tensor:
    """Host integers → an int64 tensor on ``device``. A copy to a card
    goes through pinned memory without blocking, so launches already
    queued keep the card busy (a blocking copy would wait for them)."""
    host = torch.from_numpy(np.ascontiguousarray(values, dtype=np.int64))
    device = torch.device(device)
    if device.type == "cpu":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def roll_batch_deduped(roll: RollFn, en_hi, en_lo, device):
    """Roll each distinct extranonce of ``en_hi``/``en_lo`` (host
    integers) once and copy its result to every row that carries it:
    row ``i`` is the plain ``roll`` of row ``i``. In a window of one
    extranonce (every aligned window at 32 nonce bits) that is one roll
    for all rows."""
    en = (np.asarray(en_hi, np.uint64) << np.uint64(32)) | np.asarray(en_lo, np.uint64)
    uniq, inverse = np.unique(en, return_inverse=True)
    packed = to_device(np.concatenate([
        (uniq >> np.uint64(32)).astype(np.int64),
        (uniq & np.uint64(0xFFFFFFFF)).astype(np.int64),
        inverse.astype(np.int64),
    ]), device)
    u = len(uniq)
    mids, tails = roll(packed[:u], packed[u:2 * u])
    idx = packed[2 * u:]
    return mids[idx], tails[idx]
