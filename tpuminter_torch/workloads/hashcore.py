"""The hashcore workload: a seeded splitmix64 search over global indices.

Counterpart of ``tpuminter.workloads.hashcore``, reduced to the worker's
half: the params codec (the 0xC0 frame the reference client writes into
``Request.data``), the scalar :func:`objective`, the fold each variant
asks for, and :meth:`HashCore.compute` on device lanes
(``ops.splitmix``), whose values come from K7 (``kernels.splitmix``).

Four variants, one per fold discipline: ``fmin`` (the smallest value),
``topk`` (the k smallest), ``fmatch`` (the first index with a value
``<= threshold``, which ends the chunk early) and ``fsum`` (the exact
total). A chunk computed here returns the ``(searched, acc)`` the
reference's host lanes return for it, bit for bit, so the reference
coordinator verifies and folds it unchanged.

What stays in the reference: the numpy host-lane arm and its
``set_dev_lanes`` knob (here every chunk runs on device lanes, on the
card or, for ``device="cpu"``, on the plain versions), the width
autotune, and ``verify``, which runs in the coordinator. Unlike the
reference, no setup error falls back to other lanes: a chunk whose
kernel cannot be built or launched raises.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

from tpuminter_torch.ops import splitmix
from tpuminter_torch.search import pipeline_spans
from tpuminter_torch.workloads import Workload, register
from tpuminter_torch.workloads import folds

__all__ = ["HashCore", "HashParams", "objective", "pack_params", "parse_params",
           "VARIANTS", "HASHCORE_WID"]

#: the workload's numeric id on WorkResults (the reference's)
HASHCORE_WID = 1

_U64 = 1 << 64
_M64 = _U64 - 1

#: params frame: tag ‖ variant:u8 ‖ seed:u64 ‖ threshold:u64 ‖ k:u8 ‖ crc32
_TAG_HCPARAMS = 0xC0
_BIN_HCPARAMS = struct.Struct("<BBQQB")
_CRC = struct.Struct("<I")

VARIANTS = splitmix.VARIANTS

#: the reference host loop's batch: a first-match chunk that stops early
#: reports ``searched`` in whole batches through the matching index
_BATCH = 2048


def objective(seed: int, index: int) -> int:
    """splitmix64 of ``seed + (index + 1) · golden``, one u64 per index."""
    z = (seed + (index + 1) * splitmix.GOLDEN) & _M64
    z = ((z ^ (z >> 30)) * splitmix.MIX1) & _M64
    z = ((z ^ (z >> 27)) * splitmix.MIX2) & _M64
    return z ^ (z >> 31)


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


register(HashCore())
