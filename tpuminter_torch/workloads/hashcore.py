"""The hashcore workload: a seeded splitmix64 search over global indices.

Counterpart of ``tpuminter.workloads.hashcore``: the params codec (the
0xC0 frame the client writes into ``Request.data``), the scalar
:func:`objective`, the fold each variant asks for, :meth:`HashCore.compute`
on device lanes (``ops.splitmix``, whose values come from K7,
``kernels.splitmix``) and :meth:`HashCore.verify`, the coordinator's
check of a chunk's claim on the host (numpy's wrapping u64 lanes for a
whole chunk, as the reference's ``_values_vectorized``).

Four variants, one per fold discipline: ``fmin`` (the smallest value),
``topk`` (the k smallest), ``fmatch`` (the first index with a value
``<= threshold``, which ends the chunk early) and ``fsum`` (the exact
total). A chunk computed here returns the ``(searched, acc)`` the
reference's host lanes return for it, bit for bit, so either
coordinator verifies and folds it unchanged.

``compute`` imports ``torch`` (through ``ops.splitmix`` and ``search``)
when it runs, not when this module loads, so the coordinator's half
needs no CUDA stack. What stays in the reference: the numpy host-lane
arm of ``compute`` and its ``set_dev_lanes`` knob (here every chunk runs
on device lanes, on the card or, for ``device="cpu"``, on the plain
versions) and the width autotune. Unlike the reference, no setup error
falls back to other lanes: a chunk whose kernel cannot be built or
launched raises.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

from typing import List

from tpuminter_torch.workloads import Workload, register
from tpuminter_torch.workloads import folds

__all__ = ["HashCore", "HashParams", "objective", "values", "pack_params", "parse_params",
           "VARIANTS", "HASHCORE_WID"]

#: the workload's numeric id on WorkResults (the reference's)
HASHCORE_WID = 1

_U64 = 1 << 64
_M64 = _U64 - 1

#: params frame: tag ‖ variant:u8 ‖ seed:u64 ‖ threshold:u64 ‖ k:u8 ‖ crc32
_TAG_HCPARAMS = 0xC0
_BIN_HCPARAMS = struct.Struct("<BBQQB")
_CRC = struct.Struct("<I")

VARIANTS = ("fmin", "topk", "fmatch", "fsum")

#: splitmix64's constants (``ops.splitmix`` holds the same for the lanes)
GOLDEN = 0x9E3779B97F4A7C15
MIX1 = 0xBF58476D1CE4E5B9
MIX2 = 0x94D049BB133111EB

#: the reference host loop's batch: a first-match chunk that stops early
#: reports ``searched`` in whole batches through the matching index
_BATCH = 2048


def objective(seed: int, index: int) -> int:
    """splitmix64 of ``seed + (index + 1) · golden``, one u64 per index."""
    z = (seed + (index + 1) * GOLDEN) & _M64
    z = ((z ^ (z >> 30)) * MIX1) & _M64
    z = ((z ^ (z >> 27)) * MIX2) & _M64
    return z ^ (z >> 31)


def values(seed: int, lo: int, hi: int) -> List[int]:
    """:func:`objective` over ``[lo, hi]`` on numpy's u64 lanes, whose
    wrapping arithmetic is mod 2^64: the host verifier's batch path."""
    import numpy as np

    idx = np.arange(lo, hi + 1, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = np.uint64(seed) + (idx + np.uint64(1)) * np.uint64(GOLDEN)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(MIX1)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(MIX2)
        z = z ^ (z >> np.uint64(31))
    return z.tolist()


def pack_params(variant: str, seed: int, threshold: int = 0, k: int = 1) -> bytes:
    """Encode job params for ``Request.data``."""
    if variant not in VARIANTS:
        raise ValueError(f"hashcore: unknown variant {variant!r}")
    if not (0 <= seed < _U64 and 0 <= threshold < _U64):
        raise ValueError("hashcore: seed/threshold out of u64 range")
    if not 1 <= k <= folds.TOPK_SLOTS:
        raise ValueError(f"hashcore: k must be in [1, {folds.TOPK_SLOTS}]")
    body = _BIN_HCPARAMS.pack(_TAG_HCPARAMS, VARIANTS.index(variant), seed, threshold, k)
    return body + _CRC.pack(zlib.crc32(body))


@dataclass(frozen=True)
class HashParams:
    variant: str
    seed: int
    threshold: int
    k: int


def parse_params(data: bytes) -> HashParams:
    """Decode and check a params frame; ValueError on anything malformed."""
    if len(data) != _BIN_HCPARAMS.size + _CRC.size:
        raise ValueError(
            f"hashcore params: want {_BIN_HCPARAMS.size + _CRC.size} bytes, got {len(data)}"
        )
    body, (crc,) = data[:-_CRC.size], _CRC.unpack(data[-_CRC.size:])
    if zlib.crc32(body) != crc:
        raise ValueError("hashcore params: CRC mismatch")
    tag, variant, seed, threshold, k = _BIN_HCPARAMS.unpack(body)
    if tag != _TAG_HCPARAMS:
        raise ValueError(f"hashcore params: tag 0x{tag:02X}")
    if variant >= len(VARIANTS):
        raise ValueError(f"hashcore params: unknown variant {variant}")
    if not 1 <= k <= folds.TOPK_SLOTS:
        raise ValueError("hashcore params: k out of range")
    return HashParams(VARIANTS[variant], seed, threshold, k)


class HashCore(Workload):
    name = "hashcore"
    wid = HASHCORE_WID

    def fold_for(self, request) -> folds.Fold:
        p = parse_params(request.data)
        if p.variant == "fmin":
            return folds.FMin()
        if p.variant == "topk":
            return folds.TopK(p.k)
        if p.variant == "fmatch":
            return folds.FirstMatch(p.threshold)
        return folds.FSum()

    def compute(self, request, fold: folds.Fold, device="cuda", engine: str = "kernel"):
        """Sweep ``[lower, upper]`` in windows of ``rows × width``
        indices, two in flight (``search.pipeline_spans``): resolve one
        handle per window, combine the decoded partials, and yield after
        each (the worker's Cancel window). A first match ends the chunk;
        its ``searched`` is then counted from the match index in the
        reference host loop's batches, so it does not depend on the
        window."""
        from tpuminter_torch.ops import splitmix
        from tpuminter_torch.search import pipeline_spans

        p = parse_params(request.data)
        lo, hi = request.lower, request.upper
        sweep = splitmix.lane_sweep(p.variant, k=p.k, device=device, engine=engine)
        spans = ((g, min(g + sweep.window - 1, hi)) for g in range(lo, hi + 1, sweep.window))
        acc, searched = fold.initial(), 0
        for (g, e), handle in pipeline_spans(
            spans, lambda s: sweep.dispatch(p.seed, s[0], s[1], p.threshold)
        ):
            acc = fold.combine(acc, sweep.resolve(handle, g, e))
            if fold.is_final(acc):
                return min(((acc[0] - lo) // _BATCH + 1) * _BATCH, hi - lo + 1), acc
            searched += e - g + 1
            yield None
        return searched, acc

    def verify(self, request, fold: folds.Fold, acc) -> bool:
        p = parse_params(request.data)
        lo, hi = request.lower, request.upper
        if lo > hi:
            return False
        if isinstance(fold, folds.FMin):
            if acc is None:
                return False
            value, index = acc
            return lo <= index <= hi and objective(p.seed, index) == value
        if isinstance(fold, folds.TopK):
            want = min(p.k, hi - lo + 1)
            if len(acc) != want or sorted(map(tuple, acc)) != list(map(tuple, acc)):
                return False
            if len({index for _v, index in acc}) != len(acc):
                return False
            return all(lo <= index <= hi and objective(p.seed, index) == value
                       for value, index in acc)
        if isinstance(fold, folds.FirstMatch):
            if acc is None:
                return False  # a dispatched chunk always scans something
            index, value, probes = acc
            if index is None:
                # absence is decidable: a dry claim covers the whole chunk,
                # and the rescan means a false "no match" cannot hide one
                return probes == hi - lo + 1 and all(
                    objective(p.seed, j) > p.threshold for j in range(lo, hi + 1))
            if not (lo <= index <= hi and value <= p.threshold
                    and objective(p.seed, index) == value and probes == index - lo + 1):
                return False
            # "first" is part of the claim: the prefix must be dry
            return all(objective(p.seed, j) > p.threshold for j in range(lo, index))
        if isinstance(fold, folds.FSum):
            total, count = acc
            return count == hi - lo + 1 and total == sum(values(p.seed, lo, hi))
        return False


register(HashCore())
