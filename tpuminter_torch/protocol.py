"""The wire messages a JSON worker speaks.

Counterpart of ``tpuminter.protocol``, reduced to the JSON codec of the
kinds a JSON worker sends and receives: ``Join``, ``Request``,
``Result``, ``Setup``, ``Assign``, ``Refuse``, ``Cancel``, the
roll-budget dialect's ``RollAssign`` and ``Beacon``, and the workload
answer ``WorkResult``. The JSON shapes are the reference's exactly, so
this module and ``tpuminter.protocol`` decode each other's payloads;
that wire is the port's only contact with the JAX package.

A worker that joins with ``codec="json"`` is sent only JSON
``Setup``/``Assign``/``Cancel``, plus ``RollAssign`` when it advertises
``roll`` and workload jobs' ``Setup``/``Assign`` for the workloads it
advertises (the reference protocol's "No flag day" negotiation), so the
binary codec and the coordinator-internal kinds are not copied. Any other payload raises :class:`ProtocolError`, which
the worker logs and drops.
"""

from __future__ import annotations

import json
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
    "Message",
    "ProtocolError",
    "MIN_UNTRACKED",
    "encode_msg",
    "decode_msg",
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
    advertisements (this port's worker sends JSON, ``roll`` unless told
    not to, and the workloads it computes)."""

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


Message = Union[Join, Request, Result, Setup, Assign, Refuse, Cancel, RollAssign, Beacon,
                WorkResult]

_JSON_OPEN = 0x7B  # ord("{")


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


def encode_msg(msg: Message) -> bytes:
    """Serialize a message to a JSON LSP payload."""
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
    else:
        raise ProtocolError(f"not a message of this codec: {msg!r}")
    return json.dumps(obj, separators=(",", ":")).encode()


def decode_msg(raw) -> Message:
    """Parse a JSON LSP payload (``bytes`` or ``memoryview``). A binary
    payload or an unknown kind raises :class:`ProtocolError`."""
    if len(raw) == 0:
        raise ProtocolError("empty payload")
    if raw[0] != _JSON_OPEN:
        raise ProtocolError("binary payload: this worker speaks the JSON codec only")
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
    except (KeyError, ValueError, TypeError) as exc:
        raise ProtocolError(f"malformed {kind} message: {exc}") from exc
    raise ProtocolError(f"unknown message kind: {kind!r}")
