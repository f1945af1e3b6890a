"""Host-side chain primitives the CUDA worker needs.

Counterpart of ``tpuminter.chain``, reduced to what the worker role
uses: the SHA-256 constants and pure-Python compression (the midstate
that templates are built from), double SHA-256, the toy hash of the MIN
dialect, the scrypt PoW hash (the SCRYPT dialect's host ground truth),
difficulty decoding, the 80-byte block header with the genesis block,
and the extranonce roll's host reference (coinbase template, Merkle
branch fold, rolled headers and the global-index arithmetic of rolled
jobs).

All functions are pure and host-side (hashlib / pure Python).
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, replace
from typing import Iterable, Iterator, Optional, Sequence, Tuple

__all__ = [
    "SHA256_K",
    "SHA256_H0",
    "sha256_compress",
    "dsha256",
    "scrypt_hash",
    "toy_hash",
    "bits_to_target",
    "hash_to_int",
    "hash_to_hex",
    "BlockHeader",
    "GENESIS_HEADER",
    "GENESIS_HASH_HEX",
    "merkle_root_from_branch",
    "CoinbaseTemplate",
    "rolled_header",
    "split_global",
    "roll_span",
    "rolled_segments",
    "rolled_tiles",
]

HEADER_SIZE = 80

#: SHA-256 round constants (FIPS 180-4 §4.2.2).
SHA256_K: Tuple[int, ...] = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5,
    0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC,
    0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
    0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3,
    0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5,
    0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)

#: SHA-256 initial hash state (FIPS 180-4 §5.3.3).
SHA256_H0: Tuple[int, ...] = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

_MASK32 = 0xFFFFFFFF


def dsha256(data: bytes) -> bytes:
    """Bitcoin's double SHA-256: SHA-256(SHA-256(data))."""
    return hashlib.sha256(hashlib.sha256(data).digest()).digest()


def scrypt_hash(data: bytes, n: int = 1024) -> bytes:
    """Litecoin-style scrypt PoW hash: ``scrypt(P=data, S=data, N=n,
    r=1, p=1, dkLen=32)`` (RFC 7914, OpenSSL through hashlib). ``data``
    is the 80-byte header; the 32-byte output is read exactly like a
    double-SHA digest (``hash_to_int``, little-endian, against the
    target)."""
    return hashlib.scrypt(data, salt=data, n=n, r=1, p=1, dklen=32)


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _MASK32


def sha256_compress(state: Sequence[int], block: bytes) -> Tuple[int, ...]:
    """One SHA-256 compression over a 64-byte block (pure Python).

    hashlib does not expose the state after a block, and that state (the
    midstate of a message's constant prefix) is what the device kernels
    start from.
    """
    if len(block) != 64:
        raise ValueError(f"sha256_compress needs a 64-byte block, got {len(block)}")
    w = list(struct.unpack(">16I", block))
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & _MASK32)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + s1 + ch + SHA256_K[i] + w[i]) & _MASK32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (s0 + maj) & _MASK32
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _MASK32, c, b, a, (t1 + t2) & _MASK32
    return tuple((s + v) & _MASK32 for s, v in zip(state, (a, b, c, d, e, f, g, h)))


def bits_to_target(bits: int) -> int:
    """Decode Bitcoin's compact difficulty bits to a 256-bit target."""
    exponent = bits >> 24
    mantissa = bits & 0x007FFFFF
    if bits & 0x00800000:
        raise ValueError("negative target in compact bits encoding")
    if exponent <= 3:
        return mantissa >> (8 * (3 - exponent))
    return mantissa << (8 * (exponent - 3))


def hash_to_int(digest32: bytes) -> int:
    """A 32-byte double-SHA digest as Bitcoin's little-endian uint256."""
    return int.from_bytes(digest32, "little")


def hash_to_hex(digest32: bytes) -> str:
    """Display form: the digest byte-reversed, hex encoded."""
    return digest32[::-1].hex()


def toy_hash(data: bytes, nonce: int) -> int:
    """uint64 fold of SHA-256(data ‖ nonce_be8) that the MIN dialect
    minimizes: the first 8 digest bytes, big-endian."""
    digest = hashlib.sha256(data + struct.pack(">Q", nonce)).digest()
    return int.from_bytes(digest[:8], "big")


@dataclass(frozen=True)
class BlockHeader:
    """An 80-byte Bitcoin block header. ``prev_hash`` and ``merkle_root``
    are in internal (serialized) byte order."""

    version: int
    prev_hash: bytes
    merkle_root: bytes
    timestamp: int
    bits: int
    nonce: int

    def __post_init__(self) -> None:
        if len(self.prev_hash) != 32 or len(self.merkle_root) != 32:
            raise ValueError("prev_hash / merkle_root must be 32 bytes")

    def pack(self) -> bytes:
        return (
            struct.pack("<I", self.version)
            + self.prev_hash
            + self.merkle_root
            + struct.pack("<III", self.timestamp, self.bits, self.nonce & _MASK32)
        )

    @staticmethod
    def unpack(raw: bytes) -> "BlockHeader":
        if len(raw) != HEADER_SIZE:
            raise ValueError(f"header must be {HEADER_SIZE} bytes, got {len(raw)}")
        version = struct.unpack_from("<I", raw, 0)[0]
        timestamp, bits, nonce = struct.unpack_from("<III", raw, 68)
        return BlockHeader(version, raw[4:36], raw[36:68], timestamp, bits, nonce)

    def with_nonce(self, nonce: int) -> "BlockHeader":
        return replace(self, nonce=nonce & _MASK32)

    def with_merkle_root(self, root: bytes) -> "BlockHeader":
        return replace(self, merkle_root=root)

    def block_hash(self) -> bytes:
        return dsha256(self.pack())


GENESIS_HEADER = BlockHeader(
    version=1,
    prev_hash=b"\x00" * 32,
    merkle_root=bytes.fromhex(
        "4a5e1e4baab89f3a32518a88c31bc87f618f76673e2cc77ab2127b7afdeda33b"
    )[::-1],
    timestamp=1231006505,
    bits=0x1D00FFFF,
    nonce=2083236893,
)

GENESIS_HASH_HEX = "000000000019d6689c085ae165831e934ff763ae46a2a6c172b3f1b60a8ce26f"


# ---------------------------------------------------------------------------
# Merkle branch and extranonce rolling (host reference of the device roll)
# ---------------------------------------------------------------------------

def merkle_root_from_branch(leaf: bytes, branch: Iterable[bytes], index: int = 0) -> bytes:
    """Fold a leaf up a Merkle branch to the root."""
    node = leaf
    idx = index
    for sibling in branch:
        node = dsha256(sibling + node) if idx & 1 else dsha256(node + sibling)
        idx //= 2
    return node


@dataclass(frozen=True)
class CoinbaseTemplate:
    """A coinbase transaction split around its extranonce bytes:
    ``txid(e) = dsha256(prefix ‖ e as extranonce_size little-endian
    bytes ‖ suffix)``."""

    prefix: bytes
    suffix: bytes
    extranonce_size: int = 4

    def serialize(self, extranonce: int) -> bytes:
        return (
            self.prefix
            + int(extranonce).to_bytes(self.extranonce_size, "little")
            + self.suffix
        )

    def txid(self, extranonce: int) -> bytes:
        return dsha256(self.serialize(extranonce))

    def merkle_root(self, extranonce: int, branch: Sequence[bytes]) -> bytes:
        return merkle_root_from_branch(self.txid(extranonce), branch, index=0)


def rolled_header(
    header80: bytes, coinbase: CoinbaseTemplate, branch: Sequence[bytes], extranonce: int,
) -> BlockHeader:
    """The header mined at ``extranonce``: ``header80`` with its Merkle
    root replaced by the root of the rolled coinbase (the coinbase is
    leaf 0)."""
    root = coinbase.merkle_root(extranonce, branch)
    return BlockHeader.unpack(header80).with_merkle_root(root)


def split_global(index: int, nonce_bits: int = 32) -> Tuple[int, int]:
    """A rolled job's global index → ``(extranonce, nonce)``: global
    index ``g`` is extranonce ``g >> nonce_bits`` with header nonce
    ``g & (2^nonce_bits - 1)``."""
    return index >> nonce_bits, index & ((1 << nonce_bits) - 1)


def roll_span(extranonce0: int, count: int, nonce_bits: int = 32) -> Tuple[int, int]:
    """Inclusive global-index range of ``count`` whole extranonce
    segments from ``extranonce0``: how a ``RollAssign`` expands. The
    coordinator carves with the same formula, so the two must agree bit
    for bit."""
    if count < 1:
        raise ValueError("roll_span needs count >= 1")
    lower = extranonce0 << nonce_bits
    return lower, ((extranonce0 + count) << nonce_bits) - 1


def rolled_segments(
    lower: int, upper: int, nonce_bits: int = 32
) -> Iterator[Tuple[int, int, int, int]]:
    """Split ``[lower, upper]`` (global indices) into per-extranonce
    segments ``(extranonce, global_base, nonce_lo, nonce_hi)``, the
    spans over which the header is constant."""
    idx = lower
    mask = (1 << nonce_bits) - 1
    while idx <= upper:
        en = idx >> nonce_bits
        seg_end = min(upper, ((en + 1) << nonce_bits) - 1)
        yield en, en << nonce_bits, idx & mask, seg_end & mask
        idx = seg_end + 1


def rolled_tiles(
    lower: int, upper: int, nonce_bits: int = 32, width: Optional[int] = None
) -> Iterator[Tuple[int, int, int, int]]:
    """:func:`rolled_segments` cut at ``width`` granularity: tiles
    ``(extranonce, nonce_base, count, global_base)`` of at most ``width``
    nonces that never cross an extranonce boundary, in ascending global
    order. One tile is one row of a batched rolled sweep; ``width=None``
    means whole segments."""
    for en, base_g, n_lo, n_hi in rolled_segments(lower, upper, nonce_bits):
        if width is None or width >= (1 << nonce_bits):
            yield en, n_lo, n_hi - n_lo + 1, base_g | n_lo
            continue
        b = n_lo
        while b <= n_hi:
            take = min(width, n_hi - b + 1)
            yield en, b, take, base_g | b
            b += take
