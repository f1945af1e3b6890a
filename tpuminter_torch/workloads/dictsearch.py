"""The dict workload: a search over a shipped list of candidates.

Counterpart of ``tpuminter.workloads.dictsearch``: the params codec (the
0xC5 frame the client writes into ``Request.data``, and the
coordinator's per-chunk window frames with their ``base``), the scalar
:func:`score`, the fold each variant asks for, with the range check
against the shipped catalog, :meth:`DictSearch.compute` (the worker's
half) and the coordinator's half: :meth:`~DictSearch.window` and
:meth:`~DictSearch.chunk_cap`, which re-pack a catalog larger than
:data:`WINDOW_BYTES` into per-chunk Setups, and :meth:`~DictSearch.verify`.

Global index ``i`` scores ``entries[i - base]``: :func:`score` is the
low 64 bits, little-endian, of ``SHA-256(seed_le8 ‖ candidate)``. The
candidates are ragged byte strings, so scoring stays on the host's
``hashlib``, as in the reference: this workload has no kernel, and its
chunks run the same on either device. A chunk is scored in batches of
256 entries, folded with the fold's ``of_batch``; a first match ends
the chunk at its batch, so ``searched`` is the reference's, bit for bit.
"""

from __future__ import annotations

import hashlib
import struct
import zlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Optional, Tuple

from tpuminter_torch.workloads import Workload, register
from tpuminter_torch.workloads import folds

__all__ = ["DictSearch", "DictParams", "score", "pack_params", "parse_params",
           "VARIANTS", "DICT_WID", "MAX_CANDIDATES", "MAX_ENTRY", "WINDOW_BYTES"]

#: the workload's numeric id on WorkResults (the reference's)
DICT_WID = 2

_U64 = 1 << 64

#: params frame: tag ‖ variant:u8 ‖ seed:u64 ‖ threshold:u64 ‖ k:u8 ‖
#: base:u64 ‖ count:u32 ‖ count × (len:u16 ‖ bytes) ‖ crc32
_TAG_DICTPARAMS = 0xC5
_BIN_DICTPARAMS_HEAD = struct.Struct("<BBQQBQI")
_LEN = struct.Struct("<H")
_CRC = struct.Struct("<I")

VARIANTS = ("fmin", "topk", "fmatch", "fsum")

#: the bounds a params frame may carry
MAX_CANDIDATES = 1 << 20
MAX_ENTRY = 512

#: per-window byte budget of a chunked dispatch: a windowed Setup stays a
#: few LSP fragments
WINDOW_BYTES = 32 * 1024

#: entries scored between two yields (the reference's batch): a first
#: match ends the chunk at its batch
_BATCH = 256


def score(seed: int, candidate: bytes) -> int:
    """The low 64 bits, little-endian, of ``SHA-256(seed_le8 ‖ candidate)``."""
    digest = hashlib.sha256(seed.to_bytes(8, "little") + bytes(candidate)).digest()
    return int.from_bytes(digest[:8], "little")


def pack_params(variant: str, seed: int, candidates, threshold: int = 0, k: int = 1,
                base: int = 0) -> bytes:
    """Encode job params for ``Request.data``: a whole job's frame has
    ``base = 0``; a window frame carries ``base = lo`` and only the
    entries of its chunk."""
    if variant not in VARIANTS:
        raise ValueError(f"dictsearch: unknown variant {variant!r}")
    if not (0 <= seed < _U64 and 0 <= threshold < _U64 and 0 <= base < _U64):
        raise ValueError("dictsearch: seed/threshold/base out of u64 range")
    if not 1 <= k <= folds.TOPK_SLOTS:
        raise ValueError(f"dictsearch: k must be in [1, {folds.TOPK_SLOTS}]")
    entries = [bytes(c) for c in candidates]
    if not 1 <= len(entries) <= MAX_CANDIDATES:
        raise ValueError(f"dictsearch: candidate count must be in [1, {MAX_CANDIDATES}]")
    parts = [_BIN_DICTPARAMS_HEAD.pack(_TAG_DICTPARAMS, VARIANTS.index(variant), seed,
                                       threshold, k, base, len(entries))]
    for entry in entries:
        if len(entry) > MAX_ENTRY:
            raise ValueError(f"dictsearch: entry exceeds {MAX_ENTRY} bytes")
        parts += [_LEN.pack(len(entry)), entry]
    body = b"".join(parts)
    return body + _CRC.pack(zlib.crc32(body))


@dataclass(frozen=True)
class DictParams:
    variant: str
    seed: int
    threshold: int
    k: int
    #: global index of ``entries[0]``: 0 in a whole job's frame, the
    #: chunk's lower bound in a window frame
    base: int
    entries: Tuple[bytes, ...]

    def entry(self, index: int) -> bytes:
        """The candidate at global ``index``; ValueError outside the frame."""
        slot = index - self.base
        if not 0 <= slot < len(self.entries):
            raise ValueError(f"dictsearch: index {index} outside window "
                             f"[{self.base}, {self.base + len(self.entries) - 1}]")
        return self.entries[slot]


#: parsed-catalog LRU: the coordinator resolves a job's fold and verifies
#: once a settle, and re-parsing a multi-MB catalog each time would
#: dominate; keyed by the frame's bytes, so a window and its job coexist
_PARSE_CACHE: "OrderedDict[bytes, DictParams]" = OrderedDict()
_PARSE_CACHE_CAP = 8


def parse_params(data: bytes) -> DictParams:
    """Decode and check a params frame; ValueError on anything malformed."""
    key = bytes(data)
    hit = _PARSE_CACHE.get(key)
    if hit is not None:
        _PARSE_CACHE.move_to_end(key)
        return hit
    head = _BIN_DICTPARAMS_HEAD.size
    if len(key) < head + _CRC.size:
        raise ValueError(f"dictsearch params: truncated ({len(key)} bytes)")
    body, (crc,) = key[:-_CRC.size], _CRC.unpack(key[-_CRC.size:])
    if zlib.crc32(body) != crc:
        raise ValueError("dictsearch params: CRC mismatch")
    tag, variant, seed, threshold, k, base, count = _BIN_DICTPARAMS_HEAD.unpack_from(body)
    if tag != _TAG_DICTPARAMS:
        raise ValueError(f"dictsearch params: tag 0x{tag:02X}")
    if variant >= len(VARIANTS):
        raise ValueError(f"dictsearch params: unknown variant {variant}")
    if not 1 <= k <= folds.TOPK_SLOTS:
        raise ValueError("dictsearch params: k out of range")
    if not 1 <= count <= MAX_CANDIDATES:
        raise ValueError(f"dictsearch params: bad candidate count {count}")
    entries: List[bytes] = []
    off = head
    for _ in range(count):
        if off + _LEN.size > len(body):
            raise ValueError("dictsearch params: entry table truncated")
        (n,) = _LEN.unpack_from(body, off)
        off += _LEN.size
        if n > MAX_ENTRY or off + n > len(body):
            raise ValueError("dictsearch params: entry overruns the frame")
        entries.append(body[off:off + n])
        off += n
    if off != len(body):
        raise ValueError("dictsearch params: trailing bytes after entries")
    parsed = DictParams(VARIANTS[variant], seed, threshold, k, base, tuple(entries))
    _PARSE_CACHE[key] = parsed
    if len(_PARSE_CACHE) > _PARSE_CACHE_CAP:
        _PARSE_CACHE.popitem(last=False)
    return parsed


class DictSearch(Workload):
    name = "dict"
    wid = DICT_WID

    def fold_for(self, request) -> folds.Fold:
        p = parse_params(request.data)
        # a Request may only carve indices its frame ships
        if request.lower < p.base or request.upper >= p.base + len(p.entries):
            raise ValueError("dictsearch: request range outside the shipped catalog")
        if p.variant == "fmin":
            return folds.FMin()
        if p.variant == "topk":
            return folds.TopK(p.k)
        if p.variant == "fmatch":
            return folds.FirstMatch(p.threshold)
        return folds.FSum()

    def window(self, request, lo: int, hi: int) -> Optional[bytes]:
        p = parse_params(request.data)
        if len(request.data) <= WINDOW_BYTES:
            return None  # the cached full-job Setup is already small
        if not p.base <= lo <= hi < p.base + len(p.entries):
            raise ValueError("dictsearch: window outside the catalog")
        return pack_params(p.variant, p.seed, p.entries[lo - p.base:hi - p.base + 1],
                           threshold=p.threshold, k=p.k, base=lo)

    def chunk_cap(self, request) -> int:
        p = parse_params(request.data)
        if len(request.data) <= WINDOW_BYTES:
            return 0
        avg = max(1, len(request.data) // max(1, len(p.entries)))
        return max(16, WINDOW_BYTES // (avg + _LEN.size))

    def compute(self, request, fold: folds.Fold, device="cuda", engine: str = "kernel"):
        """Score ``[lower, upper]`` on the host in batches of 256 entries,
        fold each with ``of_batch`` and yield after each; a first match
        ends the chunk at its batch. ``device`` and ``engine`` do not
        apply: no kernel scores a ragged byte string."""
        p = parse_params(request.data)
        lo, hi = request.lower, request.upper
        acc, searched = fold.initial(), 0
        for index in range(lo, hi + 1, _BATCH):
            last = min(hi, index + _BATCH - 1)
            values = [score(p.seed, p.entry(j)) for j in range(index, last + 1)]
            acc = fold.combine(acc, fold.of_batch(index, values))
            searched += last - index + 1
            if fold.is_final(acc):
                break
            yield None
        return searched, acc

    def verify(self, request, fold: folds.Fold, acc) -> bool:
        p = parse_params(request.data)
        lo, hi = request.lower, request.upper
        if lo > hi:
            return False

        def value_at(index: int) -> Optional[int]:
            try:
                return score(p.seed, p.entry(index))
            except ValueError:
                return None

        def dry(first: int, last: int) -> bool:
            return all(value_at(j) is not None and value_at(j) > p.threshold
                       for j in range(first, last + 1))

        if isinstance(fold, folds.FMin):
            if acc is None:
                return False
            value, index = acc
            return lo <= index <= hi and value_at(index) == value
        if isinstance(fold, folds.TopK):
            want = min(p.k, hi - lo + 1)
            if len(acc) != want or sorted(map(tuple, acc)) != list(map(tuple, acc)):
                return False
            if len({index for _v, index in acc}) != len(acc):
                return False
            return all(lo <= index <= hi and value_at(index) == value for value, index in acc)
        if isinstance(fold, folds.FirstMatch):
            if acc is None:
                return False  # a dispatched chunk always scans something
            index, value, probes = acc
            if index is None:
                # a dry claim covers the whole chunk and survives a rescan
                return probes == hi - lo + 1 and dry(lo, hi)
            if not (lo <= index <= hi and value <= p.threshold and value_at(index) == value
                    and probes == index - lo + 1):
                return False
            return dry(lo, index - 1)  # "first" is part of the claim
        if isinstance(fold, folds.FSum):
            total, count = acc
            if count != hi - lo + 1:
                return False
            scores = [value_at(j) for j in range(lo, hi + 1)]
            return None not in scores and total == sum(scores)
        return False


register(DictSearch())
