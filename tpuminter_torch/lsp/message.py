"""LSP wire frames. Counterpart of ``tpuminter.lsp.message``.

Layout (little-endian): ``type:u8 ‖ conn_id:u32 ‖ seq:u32 ‖ size:u16 ‖
crc32:u32 ‖ payload[size]``. A frame that fails to parse or checksum is
dropped, exactly like a lost datagram. Seq-0 ACKs may carry a boot-epoch
payload (``magic:u8 ‖ epoch:u64``) that tells a client whether the
server it talks to restarted.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from enum import IntEnum
from typing import Optional

_HEADER = struct.Struct("<BIIHI")

#: Max payload carried in one frame (one datagram under a 1500 MTU).
MAX_PAYLOAD = 1400


class MsgType(IntEnum):
    CONNECT = 0  # client → server, seq 0, empty payload
    DATA = 1     # either direction, seq ≥ 1
    ACK = 2      # acks DATA seq; seq 0 = connect-ack / heartbeat


_EPOCH = struct.Struct("<BQ")

#: connect-ack: "your connection is accepted; this incarnation's epoch"
EPOCH_CONNECT = 0xE7
#: reset: "I don't know this connection"
EPOCH_RESET = 0xE8


_U64 = 1 << 64


def encode_epoch(kind: int, epoch: int) -> bytes:
    """A seq-0 ACK epoch payload (connect-ack or reset)."""
    if not 0 <= epoch < _U64:
        raise ValueError(f"epoch out of u64 range: {epoch}")
    return _EPOCH.pack(kind, epoch)


def decode_epoch(payload) -> Optional[tuple]:
    """Parse an epoch payload; ``(kind, epoch)`` or None when the payload
    is anything else (empty heartbeat, SACK words)."""
    if len(payload) != _EPOCH.size:
        return None
    kind, epoch = _EPOCH.unpack(payload)
    if kind not in (EPOCH_CONNECT, EPOCH_RESET):
        return None
    return kind, epoch


@dataclass(frozen=True)
class Frame:
    type: MsgType
    conn_id: int
    seq: int
    payload: bytes = b""


#: Header minus the trailing crc32 field: the bytes the CRC covers.
_PRECRC = struct.Struct("<BIIH")


def encode(frame: Frame) -> bytearray:
    """Serialize into one preallocated buffer (header packed in place,
    payload copied once)."""
    n = len(frame.payload)
    if n > MAX_PAYLOAD:
        raise ValueError(f"payload too large: {n} > {MAX_PAYLOAD}")
    buf = bytearray(_HEADER.size + n)
    _PRECRC.pack_into(buf, 0, frame.type, frame.conn_id, frame.seq, n)
    buf[_HEADER.size:] = frame.payload
    view = memoryview(buf)
    crc = zlib.crc32(view[_HEADER.size:], zlib.crc32(view[:_PRECRC.size]))
    struct.pack_into("<I", buf, _PRECRC.size, crc)
    return buf


def decode_all(data: bytes):
    """Parse a datagram carrying one or more back-to-back frames. Yields
    each frame that parses and checksums; stops at the first malformed
    one, since a corrupt size field unframes everything after it.
    Payloads are zero-copy views into ``data``."""
    view = memoryview(data)
    off = 0
    total = len(view)
    while total - off >= _HEADER.size:
        type_, conn_id, seq, size, crc = _HEADER.unpack_from(view, off)
        end = off + _HEADER.size + size
        if end > total:
            return  # truncated
        payload = view[off + _HEADER.size : end]
        if crc != zlib.crc32(
            payload, zlib.crc32(view[off : off + _PRECRC.size])
        ):
            return  # corrupt: cannot trust the framing past this point
        try:
            mtype = MsgType(type_)
        except ValueError:
            return
        yield Frame(mtype, conn_id, seq, payload)
        off = end
