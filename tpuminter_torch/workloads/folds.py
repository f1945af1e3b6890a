"""Fold disciplines: how a workload chunk's partial answer combines with
others, and how it is framed on the wire.

Counterpart of ``tpuminter.workloads.folds``: the four disciplines'
``initial``/``combine``/``is_final``, their host ``of_batch`` (a batch
of objective values from a global index, as the dict workload scores
them), their chunk-partial codec, and what the coordinator and the
client ask of them (``found``, ``idempotent``, ``describe``). Each
partial travels inside a ``WorkResult`` as a tagged, CRC-trailed frame
(tags 0xC1–0xC4) that the reference coordinator decodes, so the layouts
are the reference's byte for byte.

- **fmin**: the single smallest ``[value, index]``, ties to the lowest
  index;
- **top-k**: the ``k`` smallest ``[value, index]`` pairs in ``(value,
  index)`` order, at most :data:`TOPK_SLOTS`;
- **first-match**: ``[index, value, probes]`` of the earliest index whose
  value is ``<= threshold``, or ``[None, None, probes]`` for a dry scan;
- **sum**: ``[total, count]``, exact.

Accumulators are plain lists and ints, as in the reference.
"""

from __future__ import annotations

import struct
import zlib
from typing import Any, List

__all__ = ["Fold", "FMin", "TopK", "FirstMatch", "FSum", "seal_payload", "TOPK_SLOTS"]

_U64 = 1 << 64
_U128 = 1 << 128

_TAG_WMIN = 0xC1
_TAG_WTOPK = 0xC2
_TAG_WMATCH = 0xC3
_TAG_WSUM = 0xC4

#: top-k payloads carry a fixed slot table; unused slots are zero
TOPK_SLOTS = 8

_BIN_WMIN = struct.Struct("<BBQQ")  # tag, has, value, index
_BIN_WTOPK = struct.Struct("<BB" + "QQ" * TOPK_SLOTS)  # tag, count, (value, index) slots
_BIN_WMATCH = struct.Struct("<BBQQQ")  # tag, has, index, value, probes
_BIN_WSUM = struct.Struct("<B16sQ")  # tag, total (u128 LE), count
_CRC = struct.Struct("<I")


def seal_payload(body: bytes) -> bytes:
    """``body ‖ crc32(body)``: the chunk-partial frame trailer."""
    return body + _CRC.pack(zlib.crc32(body))


def _open_payload(data: bytes, layout: struct.Struct, tag: int) -> tuple:
    """Check length, CRC and tag, then unpack; ValueError on a mismatch."""
    if len(data) != layout.size + _CRC.size:
        raise ValueError(
            f"fold payload: want {layout.size + _CRC.size} bytes, got {len(data)}"
        )
    body, (crc,) = data[:-_CRC.size], _CRC.unpack(data[-_CRC.size:])
    if zlib.crc32(body) != crc:
        raise ValueError("fold payload: CRC mismatch")
    fields = layout.unpack(body)
    if fields[0] != tag:
        raise ValueError(f"fold payload: tag 0x{fields[0]:02X}, want 0x{tag:02X}")
    return fields


class Fold:
    """One reduction discipline; ``combine`` is associative with
    deterministic ties, so partials of any granularity combine to the
    same answer."""

    name = "fold"
    #: False when absorbing overlapping coverage twice would corrupt the
    #: answer (sum); the coordinator's coverage gate is what keeps such
    #: a fold exactly-once
    idempotent = True

    def initial(self) -> Any:
        return None

    def combine(self, a: Any, b: Any) -> Any:
        raise NotImplementedError

    def of_batch(self, index0: int, values: List[int]) -> Any:
        """The accumulator of one contiguous batch of objective values,
        the first at global index ``index0``."""
        raise NotImplementedError

    def is_final(self, acc: Any) -> bool:
        """True when this accumulator already decides the job."""
        return False

    def found(self, acc: Any) -> bool:
        """The finish record's ``found`` flag once the range exhausts."""
        return acc is not None

    def encode(self, acc: Any) -> bytes:
        raise NotImplementedError

    def decode(self, data: bytes) -> Any:
        raise NotImplementedError

    def describe(self, acc: Any) -> str:
        """The client CLI's rendering of an answer."""
        return repr(acc)


class FMin(Fold):
    name = "fmin"

    def combine(self, a, b):
        if a is None:
            return None if b is None else list(b)
        if b is None:
            return list(a)
        return list(min((tuple(a), tuple(b))))

    def of_batch(self, index0, values):
        if not values:
            return None
        value = min(values)
        return [value, index0 + values.index(value)]  # ties: the lowest index

    def encode(self, acc):
        if acc is None:
            return seal_payload(_BIN_WMIN.pack(_TAG_WMIN, 0, 0, 0))
        value, index = acc
        if not (0 <= value < _U64 and 0 <= index < _U64):
            raise ValueError("fmin acc out of u64 range")
        return seal_payload(_BIN_WMIN.pack(_TAG_WMIN, 1, value, index))

    def decode(self, data):
        _tag, has, value, index = _open_payload(data, _BIN_WMIN, _TAG_WMIN)
        return [value, index] if has else None

    def describe(self, acc):
        if acc is None:
            return "fmin: empty range"
        return f"fmin: value={acc[0]} index={acc[1]}"


class TopK(Fold):
    name = "topk"

    def __init__(self, k: int):
        if not 1 <= k <= TOPK_SLOTS:
            raise ValueError(f"topk: k must be in [1, {TOPK_SLOTS}]")
        self.k = k

    def initial(self):
        return []

    def combine(self, a, b):
        merged = {int(i): int(v) for v, i in (a or [])}
        # one index can only carry one value; keep the smaller defensively
        for v, i in (b or []):
            v, i = int(v), int(i)
            merged[i] = min(merged.get(i, v), v)
        return sorted([v, i] for i, v in merged.items())[: self.k]

    def of_batch(self, index0, values):
        return sorted([value, index0 + off] for off, value in enumerate(values))[: self.k]

    def encode(self, acc):
        acc = acc or []
        if len(acc) > TOPK_SLOTS:
            raise ValueError("topk acc exceeds the slot table")
        flat = []
        for value, index in acc:
            if not (0 <= value < _U64 and 0 <= index < _U64):
                raise ValueError("topk acc out of u64 range")
            flat.extend((value, index))
        flat.extend([0] * (2 * TOPK_SLOTS - len(flat)))
        return seal_payload(_BIN_WTOPK.pack(_TAG_WTOPK, len(acc), *flat))

    def decode(self, data):
        fields = _open_payload(data, _BIN_WTOPK, _TAG_WTOPK)
        count = fields[1]
        if count > TOPK_SLOTS:
            raise ValueError("topk payload: count exceeds the slot table")
        return [[fields[2 + 2 * s], fields[3 + 2 * s]] for s in range(count)]

    def found(self, acc):
        return bool(acc)

    def describe(self, acc):
        if not acc:
            return "topk: empty range"
        rows = "\n".join(f"  #{rank + 1} value={v} index={i}" for rank, (v, i) in enumerate(acc))
        return f"topk ({len(acc)}):\n{rows}"


class FirstMatch(Fold):
    name = "fmatch"

    def __init__(self, threshold: int):
        if not 0 <= threshold < _U64:
            raise ValueError("fmatch: threshold out of u64 range")
        self.threshold = threshold

    def combine(self, a, b):
        if a is None:
            return None if b is None else list(b)
        if b is None:
            return list(a)
        if a[0] is None:
            keep = b
        elif b[0] is None:
            keep = a
        else:
            keep = a if a[0] <= b[0] else b
        return [keep[0], keep[1], a[2] + b[2]]

    def of_batch(self, index0, values):
        for off, value in enumerate(values):
            if value <= self.threshold:
                return [index0 + off, value, off + 1]
        return [None, None, len(values)] if values else None

    def is_final(self, acc):
        return acc is not None and acc[0] is not None

    def found(self, acc):
        return acc is not None and acc[0] is not None

    def encode(self, acc):
        if acc is None:
            acc = [None, None, 0]
        index, value, probes = acc
        if not 0 <= probes < _U64:
            raise ValueError("fmatch probes out of u64 range")
        if index is None:
            return seal_payload(_BIN_WMATCH.pack(_TAG_WMATCH, 0, 0, 0, probes))
        if not (0 <= index < _U64 and 0 <= value < _U64):
            raise ValueError("fmatch acc out of u64 range")
        return seal_payload(_BIN_WMATCH.pack(_TAG_WMATCH, 1, index, value, probes))

    def decode(self, data):
        _tag, has, index, value, probes = _open_payload(data, _BIN_WMATCH, _TAG_WMATCH)
        if has:
            return [index, value, probes]
        return [None, None, probes] if probes else None

    def describe(self, acc):
        if acc is None or acc[0] is None:
            return "fmatch: no match"
        return f"fmatch: index={acc[0]} value={acc[1]} probes={acc[2]}"


class FSum(Fold):
    name = "fsum"
    idempotent = False

    def initial(self):
        return [0, 0]

    def combine(self, a, b):
        a, b = a or [0, 0], b or [0, 0]
        return [a[0] + b[0], a[1] + b[1]]

    def of_batch(self, index0, values):
        return [sum(values), len(values)]

    def encode(self, acc):
        total, count = acc or [0, 0]
        if not (0 <= count < _U64 and 0 <= total < _U128):
            raise ValueError("fsum acc out of range (u128 total, u64 count)")
        return seal_payload(_BIN_WSUM.pack(_TAG_WSUM, total.to_bytes(16, "little"), count))

    def decode(self, data):
        _tag, total, count = _open_payload(data, _BIN_WSUM, _TAG_WSUM)
        return [int.from_bytes(total, "little"), count]

    def found(self, acc):
        return True

    def describe(self, acc):
        acc = acc or [0, 0]
        return f"fsum: total={acc[0]} count={acc[1]}"
