"""The wire messages of the port's three roles, in both of the
reference's codecs.

Counterpart of ``tpuminter.protocol``, reduced to the kinds a worker, a
client and a single-loop coordinator exchange: ``Join``, ``Request``,
``Result``, ``Setup``, ``Assign``, ``Refuse`` (the worker's and the
admission dialect's), ``Cancel``, the roll-budget dialect's
``RollAssign`` and ``Beacon``, the workload answer ``WorkResult``, the
streaming partial ``Emit`` and the federation's ``Steal`` (decoded so
that a coordinator can deny it). The JSON shapes and the binary layouts
are the reference's exactly, so this module and ``tpuminter.protocol``
decode each other's payloads.

**The binary codec** (the reference's codec v1 and its later tags):
``tag:u8 ‖ fields… ‖ crc32:u32``, little-endian, for Assign ``0xB1``,
Result ``0xB2``, Refuse ``0xB3``, Cancel ``0xB4``, Join ``0xB5``, WalBatch
``0xB8``, RollAssign ``0xB9``, Beacon ``0xBA``, WorkResult ``0xBB`` and
Emit ``0xBE`` (the last three variable-length: raw journal bytes or a
fold payload follows their head). JSON payloads start with ``{``, which
is no tag, so :func:`decode_msg` takes both. A corrupted or truncated
binary payload fails its length or CRC check and raises
:class:`ProtocolError`. ``encode_msg(msg, binary=True)`` packs a kind
that has a layout when its fields fit, else falls back to JSON (Request,
Setup and Steal are JSON only, as is a Join that names workloads).

**Negotiation** (the reference's "No flag day"): a worker advertises
``codec="bin"`` in its Join, and the coordinator then sends it binary
Assigns; the worker answers in binary only once it has seen a binary
payload from the coordinator (:func:`payload_is_binary`). A worker that
joins with ``codec="json"`` is sent only JSON, plus ``RollAssign`` when
it advertises ``roll`` and workload jobs' ``Setup``/``Assign`` for the
workloads it advertises. Clients are always answered in JSON.

**Replication** (:mod:`tpuminter_torch.replication`): ``RepHello``,
``SyncFrom``, ``WalStart`` and ``SyncAck`` travel in JSON, ``WalBatch``
in binary (``0xB8 ‖ offset:u64 ‖ raw journal bytes ‖ crc32``; its JSON
form, hex data, is decoded too).

**The shard seam** (:mod:`tpuminter_torch.multiproc`): the five frames
``0xD1``–``0xD5`` cross the host-local UNIX datagram channel between
shard processes, never the UDP port: ``encode_seam_fwd`` (a mis-steered
datagram with its source), ``encode_seam_bind`` (rebind-registry
gossip), ``encode_seam_rebind`` (ask the home shard),
``encode_seam_answer`` (its encoded Result, or a miss) and
``encode_seam_quota`` (a cumulative admission count), decoded by
:func:`decode_seam`. Each is ``head ‖ variable tail ‖ crc32``, the
reference's bytes.

The kinds of the reference's federation leases (``0xBC``/``0xBD``: the
reference stamps lease epochs only toward peers that sent the
aggregator hello) belong to a role the port does not have yet, and its
binary admission Refuse
(``0xB6``) goes only to clients, which it answers in JSON; the decoder
raises :class:`ProtocolError` on them, which a role logs and drops.
"""

from __future__ import annotations

import json
import struct
import zlib
from dataclasses import dataclass
from enum import Enum
from typing import Optional, Tuple, Union

__all__ = [
    "PowMode",
    "Join",
    "Request",
    "Result",
    "Setup",
    "Assign",
    "Refuse",
    "Cancel",
    "RollAssign",
    "Beacon",
    "WorkResult",
    "Emit",
    "Steal",
    "RepHello",
    "SyncFrom",
    "WalStart",
    "WalBatch",
    "SyncAck",
    "Message",
    "ProtocolError",
    "MIN_UNTRACKED",
    "encode_msg",
    "decode_msg",
    "payload_is_binary",
    "request_to_obj",
    "request_from_obj",
    "SEAM_CKEY_MAX",
    "encode_seam_fwd",
    "encode_seam_bind",
    "encode_seam_rebind",
    "encode_seam_answer",
    "encode_seam_quota",
    "decode_seam",
]

#: ``hash_value`` of an exhausted TARGET Result from a worker that does
#: not track the running 256-bit minimum (the fast candidate path). It
#: loses every min-fold against a real hash; a final Result carrying it
#: means "range exhausted, no winner, minimum untracked".
MIN_UNTRACKED = (1 << 256) - 1


class ProtocolError(ValueError):
    """A payload that is not a well-formed message of this codec."""


class PowMode(str, Enum):
    MIN = "min"        # toy PoW: minimize the uint64 fold of toy_hash
    TARGET = "target"  # double-SHA256(header) <= target
    SCRYPT = "scrypt"  # scrypt(header) <= target

    @property
    def targeted(self) -> bool:
        """True for the header-mining dialects (header + target + u32 nonce)."""
        return self in (PowMode.TARGET, PowMode.SCRYPT)


@dataclass(frozen=True)
class Join:
    """Worker → coordinator: I am a miner. ``lanes`` is a relative
    throughput hint, ``span`` the worker's pipeline-stage size in nonces;
    ``codec``/``roll``/``workloads``/``agg`` are capability
    advertisements (this port's worker sends ``codec="bin"`` unless told
    to speak JSON, ``roll`` unless told not to, and the workloads it
    computes)."""

    backend: str = "cpu"
    lanes: int = 1
    span: int = 0
    codec: str = "json"
    roll: bool = False
    workloads: Tuple[str, ...] = ()
    agg: str = ""


@dataclass(frozen=True)
class Request:
    """Mine ``[lower, upper]`` (inclusive). MIN uses ``data``; the
    targeted modes use an 80-byte ``header`` and a 256-bit ``target``.
    A rolled job (``coinbase_prefix`` set) ranges over global indices
    ``extranonce << nonce_bits | nonce``; ``workload`` names a pluggable
    workload, whose params frame rides ``data``."""

    job_id: int
    mode: PowMode
    lower: int
    upper: int
    data: bytes = b""
    header: Optional[bytes] = None
    target: Optional[int] = None
    chunk_id: int = 0
    coinbase_prefix: Optional[bytes] = None
    coinbase_suffix: bytes = b""
    extranonce_size: int = 4
    branch: Tuple[bytes, ...] = ()
    nonce_bits: int = 32
    client_key: str = ""
    workload: str = ""
    stream: bool = False

    @property
    def rolled(self) -> bool:
        """True when this is an extranonce-rolling job."""
        return self.coinbase_prefix is not None

    def __post_init__(self) -> None:
        if self.rolled:
            if not self.mode.targeted:
                raise ProtocolError("extranonce rolling requires a targeted mode")
            if not 1 <= self.extranonce_size <= 8:
                raise ProtocolError("extranonce_size must be in [1, 8]")
            if not 1 <= self.nonce_bits <= 32:
                raise ProtocolError("nonce_bits must be in [1, 32]")
            for sib in self.branch:
                if len(sib) != 32:
                    raise ProtocolError("merkle branch entries must be 32 bytes")
            span_bits = min(64, self.nonce_bits + 8 * self.extranonce_size)
            limit = (1 << span_bits) - 1
        else:
            limit = 0xFFFFFFFF if self.mode.targeted else 0xFFFFFFFFFFFFFFFF
        if self.lower < 0 or self.upper < self.lower or self.upper > limit:
            raise ProtocolError(f"bad nonce range [{self.lower}, {self.upper}]")
        if self.mode.targeted:
            if self.header is None or len(self.header) != 80:
                raise ProtocolError("targeted modes need an 80-byte header")
            if self.target is None or self.target <= 0:
                raise ProtocolError("targeted modes need a positive target")


@dataclass(frozen=True)
class Result:
    """Worker → coordinator: the minimum hash over the searched range and
    its argmin nonce; ``found`` in TARGET mode iff ``hash_value <=
    target`` (always in MIN mode). ``searched`` counts nonces examined;
    ``chunk_id`` echoes the Assign."""

    job_id: int
    mode: PowMode
    nonce: int
    hash_value: int
    found: bool = True
    searched: int = 0
    chunk_id: int = 0


@dataclass(frozen=True)
class Setup:
    """Coordinator → worker: cache this job's template Request."""

    request: Request


@dataclass(frozen=True)
class Assign:
    """Coordinator → worker: mine ``[lower, upper]`` of a set-up job."""

    job_id: int
    chunk_id: int
    lower: int
    upper: int


@dataclass(frozen=True)
class Refuse:
    """Worker → coordinator: I cannot mine this dispatch; requeue it."""

    job_id: int
    chunk_id: int
    retry_after_ms: int = 0


@dataclass(frozen=True)
class Cancel:
    """Coordinator → worker: stop mining ``job_id``, its answer is in."""

    job_id: int


@dataclass(frozen=True)
class RollAssign:
    """Coordinator → worker: mine extranonces ``[extranonce0,
    extranonce0 + count)`` of a set-up rolled job, each over its full
    ``2^nonce_bits`` nonce sweep (``chain.roll_span`` expands it). Sent
    only to workers whose ``Join`` advertised ``roll``. ``lease_epoch``
    is non-zero only toward federation aggregators."""

    job_id: int
    chunk_id: int
    extranonce0: int
    count: int
    lease_epoch: int = 0


@dataclass(frozen=True)
class Beacon:
    """Worker → coordinator: progress inside a ``RollAssign`` chunk.
    Every global index of the chunk up to ``high_water`` was swept with
    no winner; ``nonce``/``hash_value`` are the running minimum over
    that prefix (``MIN_UNTRACKED`` where the fast path does not track
    it). ``lease_epoch`` echoes the RollAssign's."""

    job_id: int
    chunk_id: int
    high_water: int
    nonce: int
    hash_value: int
    lease_epoch: int = 0


@dataclass(frozen=True)
class WorkResult:
    """Worker → coordinator: a workload chunk's answer. ``payload`` is
    the fold discipline's own tagged, CRC-trailed chunk-partial frame
    (``workloads.folds``), opaque here; ``wid`` is the workload's
    numeric id and ``searched`` counts the indices evaluated."""

    job_id: int
    chunk_id: int
    wid: int
    searched: int
    payload: bytes = b""


@dataclass(frozen=True)
class Steal:
    """Aggregator → coordinator: re-lease me the un-beaconed suffix of a
    slow sibling's assignment (``job_id`` 0 = any job). JSON only. The
    port's coordinator has no aggregators yet and denies every Steal."""

    job_id: int = 0


@dataclass(frozen=True)
class Emit:
    """Coordinator → client: a partial answer of a streaming workload
    job, before its final Result. ``payload`` is the fold's encoding of
    the running accumulator over journal-settled coverage, ``covered``
    and ``total`` the settled and the whole index counts, ``seq`` a
    per-job counter; ``job_id`` is the client's own id."""

    job_id: int
    seq: int
    covered: int
    total: int
    payload: bytes = b""


@dataclass(frozen=True)
class RepHello:
    """Primary → standby, first on a WAL-shipping connection: "I am the
    coordinator of boot epoch ``epoch``; tell me where to resume". The
    epoch is the fencing credential: higher epoch wins."""

    epoch: int


@dataclass(frozen=True)
class SyncFrom:
    """Standby → primary: the durable resume cursor of its local WAL
    copy. ``offset`` bytes are applied, the last record starts at
    ``last_start`` and carries stored CRC ``crc``."""

    offset: int
    last_start: int = -1
    crc: int = 0


@dataclass(frozen=True)
class WalStart:
    """Primary → standby: the next :class:`WalBatch` begins at byte
    ``offset``; 0 with local state present is a full resync."""

    offset: int


@dataclass(frozen=True)
class WalBatch:
    """Primary → standby: ``data`` is a raw slice of the primary's
    journal file starting at byte ``offset``, records framed as the
    flusher wrote them."""

    offset: int
    data: bytes


@dataclass(frozen=True)
class SyncAck:
    """Standby → primary: every byte below ``offset`` is in the
    standby's local WAL and applied to its shadow state."""

    offset: int


Message = Union[Join, Request, Result, Setup, Assign, Refuse, Cancel, RollAssign, Beacon,
                WorkResult, Emit, Steal, RepHello, SyncFrom, WalStart, WalBatch, SyncAck]

_JSON_OPEN = 0x7B  # ord("{")

# ---------------------------------------------------------------------------
# the binary codec (the reference's layouts, tag for tag)
# ---------------------------------------------------------------------------

_TAG_ASSIGN = 0xB1
_TAG_RESULT = 0xB2
_TAG_REFUSE = 0xB3
_TAG_CANCEL = 0xB4
_TAG_JOIN = 0xB5
_TAG_WALBATCH = 0xB8
_TAG_ASSIGN_ROLL = 0xB9
_TAG_BEACON = 0xBA
_TAG_WRESULT = 0xBB
_TAG_EMIT = 0xBE

_BIN_ASSIGN = struct.Struct("<BQQQQ")        # tag, job, chunk, lo, hi
_BIN_RESULT = struct.Struct("<BBQQ32sBQQ")   # tag, mode, job, nonce, hash (u256 LE),
#                                              found, searched, chunk
_BIN_REFUSE = struct.Struct("<BQQ")          # tag, job, chunk
_BIN_CANCEL = struct.Struct("<BQ")           # tag, job
_BIN_JOIN = struct.Struct("<BBIQ16s")        # tag, flags, lanes, span, backend (NUL-padded)
_BIN_ASSIGN_ROLL = struct.Struct("<BQQQI")   # tag, job, chunk, extranonce0, count
_BIN_BEACON = struct.Struct("<BQQQQ32s")     # tag, job, chunk, high_water, nonce, hash
_BIN_WRESULT_HEAD = struct.Struct("<BQQBQ")  # tag, job, chunk, wid, searched (payload follows)
_BIN_EMIT_HEAD = struct.Struct("<BQQQQ")     # tag, job, seq, covered, total (payload follows)
_BIN_WALBATCH_HEAD = struct.Struct("<BQ")    # tag, offset (journal bytes follow)
_CRC = struct.Struct("<I")

#: the fixed-size layouts, by tag (WalBatch, WorkResult and Emit are
#: variable-length)
_BIN_BY_TAG = {
    _TAG_ASSIGN: _BIN_ASSIGN,
    _TAG_RESULT: _BIN_RESULT,
    _TAG_REFUSE: _BIN_REFUSE,
    _TAG_CANCEL: _BIN_CANCEL,
    _TAG_JOIN: _BIN_JOIN,
    _TAG_ASSIGN_ROLL: _BIN_ASSIGN_ROLL,
    _TAG_BEACON: _BIN_BEACON,
}

_JOIN_FLAG_BIN = 0x01   # Join.codec == "bin"
_JOIN_FLAG_ROLL = 0x02  # Join.roll

_MODE_TO_WIRE = {PowMode.MIN: 0, PowMode.TARGET: 1, PowMode.SCRYPT: 2}
_MODE_FROM_WIRE = {v: k for k, v in _MODE_TO_WIRE.items()}

_U32 = 1 << 32
_U64 = 1 << 64
_U256 = 1 << 256


def payload_is_binary(raw) -> bool:
    """True when a payload uses the binary codec (its first byte is a
    tag, not JSON's ``{``): the worker's negotiation hook, since one
    binary payload from the coordinator proves it decodes them."""
    return len(raw) > 0 and raw[0] != _JSON_OPEN


def _seal(body: bytes) -> bytes:
    return body + _CRC.pack(zlib.crc32(body))


def _u64(*values: int) -> bool:
    return all(0 <= v < _U64 for v in values)


def _encode_binary(msg: Message) -> Optional[bytes]:
    """One message in its binary layout, or None when it has none or a
    field does not fit it (the caller then writes JSON)."""
    if isinstance(msg, Assign):
        if not _u64(msg.job_id, msg.chunk_id, msg.lower, msg.upper):
            return None
        return _seal(_BIN_ASSIGN.pack(_TAG_ASSIGN, msg.job_id, msg.chunk_id, msg.lower,
                                      msg.upper))
    if isinstance(msg, RollAssign):
        # a lease epoch has its own tag, which a worker never sends or receives
        if msg.lease_epoch or not (_u64(msg.job_id, msg.chunk_id, msg.extranonce0)
                                   and 0 < msg.count < _U32):
            return None
        return _seal(_BIN_ASSIGN_ROLL.pack(_TAG_ASSIGN_ROLL, msg.job_id, msg.chunk_id,
                                           msg.extranonce0, msg.count))
    if isinstance(msg, Beacon):
        if msg.lease_epoch or not (_u64(msg.job_id, msg.chunk_id, msg.high_water, msg.nonce)
                                   and 0 <= msg.hash_value < _U256):
            return None
        return _seal(_BIN_BEACON.pack(_TAG_BEACON, msg.job_id, msg.chunk_id, msg.high_water,
                                      msg.nonce, msg.hash_value.to_bytes(32, "little")))
    if isinstance(msg, Result):
        if not (_u64(msg.job_id, msg.nonce, msg.searched, msg.chunk_id)
                and 0 <= msg.hash_value < _U256):
            return None
        return _seal(_BIN_RESULT.pack(_TAG_RESULT, _MODE_TO_WIRE[msg.mode], msg.job_id,
                                      msg.nonce, msg.hash_value.to_bytes(32, "little"),
                                      1 if msg.found else 0, msg.searched, msg.chunk_id))
    if isinstance(msg, Refuse):
        # an admission Refuse (retry_after_ms) goes coordinator -> client only
        if msg.retry_after_ms or not _u64(msg.job_id, msg.chunk_id):
            return None
        return _seal(_BIN_REFUSE.pack(_TAG_REFUSE, msg.job_id, msg.chunk_id))
    if isinstance(msg, Cancel):
        if not _u64(msg.job_id):
            return None
        return _seal(_BIN_CANCEL.pack(_TAG_CANCEL, msg.job_id))
    if isinstance(msg, Join):
        backend = msg.backend.encode("utf-8", "strict")
        if (len(backend) > 16 or b"\x00" in backend or not 0 <= msg.lanes < _U32
                or not _u64(msg.span) or msg.codec not in ("json", "bin")
                or msg.workloads or msg.agg):  # the layout predates both: JSON
            return None
        flags = (_JOIN_FLAG_BIN if msg.codec == "bin" else 0) | (
            _JOIN_FLAG_ROLL if msg.roll else 0)
        return _seal(_BIN_JOIN.pack(_TAG_JOIN, flags, msg.lanes, msg.span, backend))
    if isinstance(msg, WorkResult):
        if not (_u64(msg.job_id, msg.chunk_id, msg.searched) and 0 <= msg.wid < 256):
            return None
        return _seal(_BIN_WRESULT_HEAD.pack(_TAG_WRESULT, msg.job_id, msg.chunk_id, msg.wid,
                                            msg.searched) + bytes(msg.payload))
    if isinstance(msg, Emit):
        if not _u64(msg.job_id, msg.seq, msg.covered, msg.total):
            return None
        return _seal(_BIN_EMIT_HEAD.pack(_TAG_EMIT, msg.job_id, msg.seq, msg.covered,
                                         msg.total) + bytes(msg.payload))
    if isinstance(msg, WalBatch):
        if not _u64(msg.offset):
            return None
        return _seal(_BIN_WALBATCH_HEAD.pack(_TAG_WALBATCH, msg.offset) + bytes(msg.data))
    return None


def _checked(raw, body: int) -> memoryview:
    """``raw`` as a view once its CRC over the first ``body`` bytes holds."""
    view = memoryview(raw)
    if zlib.crc32(view[:body]) != _CRC.unpack_from(raw, body)[0]:
        raise ProtocolError("binary payload failed its checksum")
    return view


def _decode_binary(raw) -> Message:
    n, tag = len(raw), raw[0]
    if tag == _TAG_WALBATCH:
        head = _BIN_WALBATCH_HEAD.size
        if n < head + _CRC.size:
            raise ProtocolError(f"walbatch payload truncated: {n} bytes")
        view = _checked(raw, n - _CRC.size)
        return WalBatch(_BIN_WALBATCH_HEAD.unpack_from(raw)[1], bytes(view[head:n - _CRC.size]))
    if tag == _TAG_WRESULT:
        head = _BIN_WRESULT_HEAD.size
        if n < head + _CRC.size:
            raise ProtocolError(f"wresult payload truncated: {n} bytes")
        view = _checked(raw, n - _CRC.size)
        _, job_id, chunk_id, wid, searched = _BIN_WRESULT_HEAD.unpack_from(raw)
        return WorkResult(job_id, chunk_id, wid, searched, bytes(view[head:n - _CRC.size]))
    if tag == _TAG_EMIT:
        head = _BIN_EMIT_HEAD.size
        if n < head + _CRC.size:
            raise ProtocolError(f"emit payload truncated: {n} bytes")
        view = _checked(raw, n - _CRC.size)
        _, job_id, seq, covered, total = _BIN_EMIT_HEAD.unpack_from(raw)
        return Emit(job_id, seq, covered, total, bytes(view[head:n - _CRC.size]))
    layout = _BIN_BY_TAG.get(tag)
    if layout is None:
        raise ProtocolError(f"binary tag {tag:#04x} is not one a worker receives")
    if n != layout.size + _CRC.size:
        raise ProtocolError(f"binary payload for tag {tag:#04x} is {n} bytes, "
                            f"expected {layout.size + _CRC.size}")
    _checked(raw, layout.size)
    try:
        if tag == _TAG_RESULT:
            _, mode, job_id, nonce, digest, found, searched, chunk_id = _BIN_RESULT.unpack_from(raw)
            if mode not in _MODE_FROM_WIRE or found not in (0, 1):
                raise ProtocolError("malformed binary result fields")
            return Result(job_id, _MODE_FROM_WIRE[mode], nonce, int.from_bytes(digest, "little"),
                          bool(found), searched=searched, chunk_id=chunk_id)
        if tag == _TAG_ASSIGN:
            _, job_id, chunk_id, lower, upper = _BIN_ASSIGN.unpack_from(raw)
            return Assign(job_id, chunk_id, lower, upper)
        if tag == _TAG_ASSIGN_ROLL:
            _, job_id, chunk_id, extranonce0, count = _BIN_ASSIGN_ROLL.unpack_from(raw)
            if count < 1:
                raise ProtocolError("roll assign must cover >= 1 extranonce")
            return RollAssign(job_id, chunk_id, extranonce0, count)
        if tag == _TAG_BEACON:
            _, job_id, chunk_id, high_water, nonce, digest = _BIN_BEACON.unpack_from(raw)
            return Beacon(job_id, chunk_id, high_water, nonce, int.from_bytes(digest, "little"))
        if tag == _TAG_REFUSE:
            _, job_id, chunk_id = _BIN_REFUSE.unpack_from(raw)
            return Refuse(job_id, chunk_id)
        if tag == _TAG_CANCEL:
            return Cancel(_BIN_CANCEL.unpack_from(raw)[1])
        _, flags, lanes, span, backend = _BIN_JOIN.unpack_from(raw)
        return Join(backend=backend.rstrip(b"\x00").decode("utf-8"), lanes=lanes, span=span,
                    codec="bin" if flags & _JOIN_FLAG_BIN else "json",
                    roll=bool(flags & _JOIN_FLAG_ROLL))
    except (struct.error, UnicodeDecodeError) as exc:
        raise ProtocolError(f"malformed binary message: {exc}") from exc



def _request_obj(msg: Request) -> dict:
    obj = {
        "kind": "request",
        "job_id": msg.job_id,
        "mode": msg.mode.value,
        "lower": msg.lower,
        "upper": msg.upper,
        "chunk_id": msg.chunk_id,
    }
    if msg.data:
        obj["data"] = msg.data.hex()
    if msg.header is not None:
        obj["header"] = msg.header.hex()
    if msg.target is not None:
        obj["target"] = f"{msg.target:x}"
    if msg.rolled:
        obj["cb_prefix"] = msg.coinbase_prefix.hex()
        obj["cb_suffix"] = msg.coinbase_suffix.hex()
        obj["en_size"] = msg.extranonce_size
        obj["branch"] = [sib.hex() for sib in msg.branch]
        obj["nonce_bits"] = msg.nonce_bits
    if msg.client_key:
        obj["ckey"] = msg.client_key
    if msg.workload:
        obj["wl"] = msg.workload
    if msg.stream:
        obj["strm"] = 1
    return obj


def _request_from_obj(obj: dict) -> Request:
    return Request(
        job_id=int(obj["job_id"]),
        mode=PowMode(obj["mode"]),
        lower=int(obj["lower"]),
        upper=int(obj["upper"]),
        data=bytes.fromhex(obj["data"]) if "data" in obj else b"",
        header=bytes.fromhex(obj["header"]) if "header" in obj else None,
        target=int(obj["target"], 16) if "target" in obj else None,
        chunk_id=int(obj.get("chunk_id", 0)),
        coinbase_prefix=(
            bytes.fromhex(obj["cb_prefix"]) if "cb_prefix" in obj else None
        ),
        coinbase_suffix=bytes.fromhex(obj.get("cb_suffix", "")),
        extranonce_size=int(obj.get("en_size", 4)),
        branch=tuple(bytes.fromhex(s) for s in obj.get("branch", [])),
        nonce_bits=int(obj.get("nonce_bits", 32)),
        client_key=str(obj.get("ckey", "")),
        workload=str(obj.get("wl", "")),
        stream=bool(obj.get("strm", 0)),
    )


#: the Request ↔ JSON-object codec under its public names: the journal
#: persists job templates through the codec the wire uses
request_to_obj = _request_obj
request_from_obj = _request_from_obj


def encode_msg(msg: Message, *, binary: bool = False) -> bytes:
    """Serialize a message to an LSP payload: its binary layout when
    ``binary`` and it has one that its fields fit, else JSON."""
    if binary:
        raw = _encode_binary(msg)
        if raw is not None:
            return raw
    if isinstance(msg, Join):
        obj = {"kind": "join", "backend": msg.backend, "lanes": msg.lanes,
               "span": msg.span}
        if msg.codec != "json":
            obj["codec"] = msg.codec
        if msg.roll:
            obj["roll"] = 1
        if msg.workloads:
            obj["wl"] = list(msg.workloads)
        if msg.agg:
            obj["agg"] = msg.agg
    elif isinstance(msg, Request):
        obj = _request_obj(msg)
    elif isinstance(msg, Setup):
        obj = {"kind": "setup", "request": _request_obj(msg.request)}
    elif isinstance(msg, Assign):
        obj = {
            "kind": "assign",
            "job_id": msg.job_id,
            "chunk_id": msg.chunk_id,
            "lower": msg.lower,
            "upper": msg.upper,
        }
    elif isinstance(msg, Refuse):
        obj = {"kind": "refuse", "job_id": msg.job_id, "chunk_id": msg.chunk_id}
        if msg.retry_after_ms:
            obj["retry_after_ms"] = msg.retry_after_ms
    elif isinstance(msg, Result):
        obj = {
            "kind": "result",
            "job_id": msg.job_id,
            "mode": msg.mode.value,
            "nonce": msg.nonce,
            "hash": f"{msg.hash_value:x}",
            "found": msg.found,
            "searched": msg.searched,
            "chunk_id": msg.chunk_id,
        }
    elif isinstance(msg, WorkResult):
        obj = {
            "kind": "wresult",
            "job_id": msg.job_id,
            "chunk_id": msg.chunk_id,
            "wid": msg.wid,
            "searched": msg.searched,
            "wp": bytes(msg.payload).hex(),
        }
    elif isinstance(msg, Cancel):
        obj = {"kind": "cancel", "job_id": msg.job_id}
    elif isinstance(msg, Steal):
        obj = {"kind": "steal"}
        if msg.job_id:
            obj["job_id"] = msg.job_id
    elif isinstance(msg, Emit):
        obj = {
            "kind": "emit",
            "job_id": msg.job_id,
            "seq": msg.seq,
            "cov": msg.covered,
            "tot": msg.total,
            "wp": bytes(msg.payload).hex(),
        }
    elif isinstance(msg, RollAssign):
        obj = {
            "kind": "rassign",
            "job_id": msg.job_id,
            "chunk_id": msg.chunk_id,
            "e0": msg.extranonce0,
            "count": msg.count,
        }
        if msg.lease_epoch:
            obj["le"] = msg.lease_epoch
    elif isinstance(msg, Beacon):
        obj = {
            "kind": "beacon",
            "job_id": msg.job_id,
            "chunk_id": msg.chunk_id,
            "hw": msg.high_water,
            "nonce": msg.nonce,
            "hash": f"{msg.hash_value:x}",
        }
        if msg.lease_epoch:
            obj["le"] = msg.lease_epoch
    elif isinstance(msg, RepHello):
        obj = {"kind": "rhello", "epoch": msg.epoch}
    elif isinstance(msg, SyncFrom):
        obj = {"kind": "syncfrom", "off": msg.offset, "start": msg.last_start, "crc": msg.crc}
    elif isinstance(msg, WalStart):
        obj = {"kind": "walstart", "off": msg.offset}
    elif isinstance(msg, WalBatch):
        # the shipper always speaks binary; the JSON form is decoded too
        obj = {"kind": "walbatch", "off": msg.offset, "data": bytes(msg.data).hex()}
    elif isinstance(msg, SyncAck):
        obj = {"kind": "syncack", "off": msg.offset}
    else:
        raise ProtocolError(f"not a message of this codec: {msg!r}")
    return json.dumps(obj, separators=(",", ":")).encode()


def decode_msg(raw) -> Message:
    """Parse an LSP payload (``bytes`` or ``memoryview``) of either
    codec. A malformed payload, or a tag or kind of a role the port does
    not have, raises :class:`ProtocolError`."""
    if len(raw) == 0:
        raise ProtocolError("empty payload")
    if raw[0] != _JSON_OPEN:
        return _decode_binary(raw)
    try:
        obj = json.loads(
            raw if isinstance(raw, (bytes, bytearray, str)) else bytes(raw)
        )
    except (ValueError, UnicodeDecodeError) as exc:
        raise ProtocolError(f"payload is not JSON: {exc}") from exc
    kind = obj.get("kind") if isinstance(obj, dict) else None
    try:
        if kind == "join":
            return Join(
                backend=str(obj.get("backend", "cpu")),
                lanes=int(obj.get("lanes", 1)),
                span=int(obj.get("span", 0)),
                codec=str(obj.get("codec", "json")),
                roll=bool(obj.get("roll", 0)),
                workloads=tuple(str(w) for w in obj.get("wl", [])),
                agg=str(obj.get("agg", "")),
            )
        if kind == "request":
            return _request_from_obj(obj)
        if kind == "setup":
            req = obj["request"]
            if not isinstance(req, dict):
                raise ProtocolError("setup message needs a request object")
            return Setup(request=_request_from_obj(req))
        if kind == "assign":
            return Assign(
                job_id=int(obj["job_id"]),
                chunk_id=int(obj["chunk_id"]),
                lower=int(obj["lower"]),
                upper=int(obj["upper"]),
            )
        if kind == "refuse":
            return Refuse(
                job_id=int(obj["job_id"]), chunk_id=int(obj["chunk_id"]),
                retry_after_ms=int(obj.get("retry_after_ms", 0)),
            )
        if kind == "result":
            return Result(
                job_id=int(obj["job_id"]),
                mode=PowMode(obj["mode"]),
                nonce=int(obj["nonce"]),
                hash_value=int(obj["hash"], 16),
                found=bool(obj["found"]),
                searched=int(obj.get("searched", 0)),
                chunk_id=int(obj.get("chunk_id", 0)),
            )
        if kind == "wresult":
            return WorkResult(
                job_id=int(obj["job_id"]),
                chunk_id=int(obj["chunk_id"]),
                wid=int(obj["wid"]),
                searched=int(obj.get("searched", 0)),
                payload=bytes.fromhex(obj.get("wp", "")),
            )
        if kind == "cancel":
            return Cancel(job_id=int(obj["job_id"]))
        if kind == "steal":
            return Steal(job_id=int(obj.get("job_id", 0)))
        if kind == "emit":
            return Emit(
                job_id=int(obj["job_id"]),
                seq=int(obj["seq"]),
                covered=int(obj["cov"]),
                total=int(obj["tot"]),
                payload=bytes.fromhex(obj.get("wp", "")),
            )
        if kind == "rassign":
            count = int(obj["count"])
            if count < 1:
                raise ProtocolError("roll assign must cover >= 1 extranonce")
            return RollAssign(
                job_id=int(obj["job_id"]),
                chunk_id=int(obj["chunk_id"]),
                extranonce0=int(obj["e0"]),
                count=count,
                lease_epoch=int(obj.get("le", 0)),
            )
        if kind == "beacon":
            return Beacon(
                job_id=int(obj["job_id"]),
                chunk_id=int(obj["chunk_id"]),
                high_water=int(obj["hw"]),
                nonce=int(obj["nonce"]),
                hash_value=int(obj["hash"], 16),
                lease_epoch=int(obj.get("le", 0)),
            )
        if kind == "rhello":
            return RepHello(epoch=int(obj["epoch"]))
        if kind == "syncfrom":
            return SyncFrom(offset=int(obj["off"]), last_start=int(obj.get("start", -1)),
                            crc=int(obj.get("crc", 0)))
        if kind == "walstart":
            return WalStart(offset=int(obj["off"]))
        if kind == "walbatch":
            return WalBatch(offset=int(obj["off"]), data=bytes.fromhex(obj["data"]))
        if kind == "syncack":
            return SyncAck(offset=int(obj["off"]))
    except (KeyError, ValueError, TypeError) as exc:
        raise ProtocolError(f"malformed {kind} message: {exc}") from exc
    raise ProtocolError(f"unknown message kind: {kind!r}")


# -- the shard seam's frames --------------------------------------------------
# They travel the host-local channel between shard processes, in the
# process-wide '{'-disjoint tag namespace, so a seam frame is never
# mistaken for an app message or a journal record. Every kind is
# variable-length (a ckey, a raw datagram or an encoded Result follows
# its head), so the trailing CRC32 carries the corruption contract.

_TAG_SEAM_FWD = 0xD1     # a mis-steered datagram, for its owner shard
_TAG_SEAM_BIND = 0xD2    # rebind-registry gossip: shard k owns (ckey, cjid)
_TAG_SEAM_REBIND = 0xD3  # foreign shard -> home shard: re-bind, do not re-mine
_TAG_SEAM_ANSWER = 0xD4  # home -> foreign: the winner's Result, or a miss
_TAG_SEAM_QUOTA = 0xD5   # a cumulative per-ckey admission count

_BIN_SEAM_FWD_HEAD = struct.Struct("<B4sH")     # tag, ip4, port (datagram follows)
_BIN_SEAM_BIND_HEAD = struct.Struct("<BBQ")     # tag, origin, cjid (ckey follows)
_BIN_SEAM_REBIND_HEAD = struct.Struct("<BBIQ")  # tag, origin, conn_id, cjid (ckey follows)
_BIN_SEAM_ANSWER_HEAD = struct.Struct("<BBIQ")  # tag, flags, conn_id, cjid (Result follows)
_BIN_SEAM_QUOTA_HEAD = struct.Struct("<BBQ")    # tag, origin, admitted (ckey follows)

_SEAM_ANSWER_MISS = 0x01

#: Longest ckey (utf-8 bytes) a seam frame carries: a frame is one
#: datagram and the registry a hint, so a longer key stays shard-local.
SEAM_CKEY_MAX = 512


def encode_seam_fwd(addr, payload: bytes) -> bytes:
    """One mis-steered datagram with its source address, for the owning
    shard to take as if the kernel had delivered it there."""
    import socket as _socket

    host, port = addr[0], addr[1]
    if not 0 <= port < (1 << 16):
        raise ProtocolError(f"seam fwd port out of range: {port}")
    try:
        ip4 = _socket.inet_aton(host)
    except OSError as exc:
        raise ProtocolError(f"seam fwd needs an IPv4 source: {host!r}") from exc
    return _seal(_BIN_SEAM_FWD_HEAD.pack(_TAG_SEAM_FWD, ip4, port) + bytes(payload))


def _seam_ckey_bytes(ckey: str) -> bytes:
    raw = ckey.encode("utf-8", "strict")
    if not raw or len(raw) > SEAM_CKEY_MAX:
        raise ProtocolError(f"seam ckey must be 1..{SEAM_CKEY_MAX} utf-8 bytes")
    return raw


def encode_seam_bind(origin: int, ckey: str, cjid: int) -> bytes:
    if not (0 <= origin < 256 and 0 <= cjid < _U64):
        raise ProtocolError("seam bind fields out of range")
    return _seal(_BIN_SEAM_BIND_HEAD.pack(_TAG_SEAM_BIND, origin, cjid)
                 + _seam_ckey_bytes(ckey))


def encode_seam_rebind(origin: int, conn_id: int, ckey: str, cjid: int) -> bytes:
    if not (0 <= origin < 256 and 0 <= conn_id < (1 << 32) and 0 <= cjid < _U64):
        raise ProtocolError("seam rebind fields out of range")
    return _seal(_BIN_SEAM_REBIND_HEAD.pack(_TAG_SEAM_REBIND, origin, conn_id, cjid)
                 + _seam_ckey_bytes(ckey))


def encode_seam_answer(conn_id: int, cjid: int, payload: bytes, *, miss: bool = False) -> bytes:
    if not (0 <= conn_id < (1 << 32) and 0 <= cjid < _U64):
        raise ProtocolError("seam answer fields out of range")
    if miss and payload:
        raise ProtocolError("a seam miss carries no payload")
    flags = _SEAM_ANSWER_MISS if miss else 0
    return _seal(_BIN_SEAM_ANSWER_HEAD.pack(_TAG_SEAM_ANSWER, flags, conn_id, cjid)
                 + bytes(payload))


def encode_seam_quota(origin: int, ckey: str, admitted: int) -> bytes:
    if not (0 <= origin < 256 and 0 <= admitted < _U64):
        raise ProtocolError("seam quota fields out of range")
    return _seal(_BIN_SEAM_QUOTA_HEAD.pack(_TAG_SEAM_QUOTA, origin, admitted)
                 + _seam_ckey_bytes(ckey))


_SEAM_HEADS = {
    _TAG_SEAM_FWD: _BIN_SEAM_FWD_HEAD,
    _TAG_SEAM_BIND: _BIN_SEAM_BIND_HEAD,
    _TAG_SEAM_REBIND: _BIN_SEAM_REBIND_HEAD,
    _TAG_SEAM_ANSWER: _BIN_SEAM_ANSWER_HEAD,
    _TAG_SEAM_QUOTA: _BIN_SEAM_QUOTA_HEAD,
}


def decode_seam(raw) -> tuple:
    """One seam frame as a ``(kind, ...)`` tuple:

    - ``("fwd", (host, port), payload)``
    - ``("bind", origin, ckey, cjid)``
    - ``("rebind", origin, conn_id, ckey, cjid)``
    - ``("answer", miss, conn_id, cjid, payload)``
    - ``("quota", origin, ckey, admitted)``

    Truncation, a failed CRC, an unknown tag or a malformed ckey raise
    :class:`ProtocolError`; the receiving shard drops the frame."""
    import socket as _socket

    n = len(raw)
    if n < 1:
        raise ProtocolError("empty seam frame")
    head = _SEAM_HEADS.get(raw[0])
    if head is None:
        raise ProtocolError(f"unknown seam frame tag {raw[0]:#04x}")
    if n < head.size + _CRC.size:
        raise ProtocolError(f"seam frame truncated: {n} bytes")
    view = memoryview(raw)
    if zlib.crc32(view[:n - _CRC.size]) != _CRC.unpack_from(raw, n - _CRC.size)[0]:
        raise ProtocolError("seam frame failed its checksum")
    tail = bytes(view[head.size:n - _CRC.size])
    tag = raw[0]
    try:
        if tag == _TAG_SEAM_FWD:
            _, ip4, port = head.unpack_from(raw)
            return ("fwd", (_socket.inet_ntoa(ip4), port), tail)
        if tag == _TAG_SEAM_BIND:
            _, origin, cjid = head.unpack_from(raw)
            return ("bind", origin, tail.decode("utf-8"), cjid)
        if tag == _TAG_SEAM_REBIND:
            _, origin, conn_id, cjid = head.unpack_from(raw)
            return ("rebind", origin, conn_id, tail.decode("utf-8"), cjid)
        if tag == _TAG_SEAM_ANSWER:
            _, flags, conn_id, cjid = head.unpack_from(raw)
            return ("answer", bool(flags & _SEAM_ANSWER_MISS), conn_id, cjid, tail)
        _, origin, admitted = head.unpack_from(raw)
        return ("quota", origin, tail.decode("utf-8"), admitted)
    except (struct.error, UnicodeDecodeError) as exc:
        raise ProtocolError(f"malformed seam frame: {exc}") from exc
