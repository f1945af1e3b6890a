"""Device-lane splitmix64: the hashcore workload's engine on torch lanes.

Counterpart of ``tpuminter.ops.splitmix``. Three layers:

- **the plain objective** (:func:`splitmix64_pair`): splitmix64 on u32
  word pairs held in int64 lanes, the plain version of K7
  (``kernels.splitmix``). torch has no unsigned 64-bit arithmetic (its
  int64 shifts sign-extend and a 64 × 64 product overflows), so every
  u64 is a ``(hi, lo)`` pair of words in ``[0, 2^32)`` and each 32-bit
  multiply splits one factor into 16-bit halves: every partial product
  is below 2^48;
- **the window fold** (:meth:`LaneSweep.dispatch`): a window's index
  words (the base plus a lane offset, the high word taking the low
  word's carry), its values from K7, and the fold of one of the four
  disciplines as torch ops on the lanes' device, packed into one int64
  tensor that is copied to the host behind the window's work
  (``search.Handle``), with no host sync;
- **the decode** (:meth:`LaneSweep.resolve`): one wait, for that
  window's copy alone, and the decode into the discipline's
  chunk-partial accumulator, the value ``workloads.folds`` combines.

A window covers only its real indices (shapes are run-time values in
torch), so the reference's sentinel-masked tail lanes and its width
clamp have no counterpart. Values are compared through one ordered
int64 key per lane, ``value - 2^63`` (``(hi - 2^31) * 2^32 + lo``),
which sorts as the u64 value does; lanes are in index order, so ties
go to the lowest index wherever the reference breaks them that way
(``argmin`` and ``amin`` return the first minimum, the sort is stable).
The sum is exact: each word's lane sum fits in int64 for any window up
to :data:`MAX_WINDOW`, and the two combine as Python ints.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from tpuminter_torch.search import Handle

__all__ = [
    "splitmix64_pair", "index_words", "LaneSweep", "lane_sweep", "ROWS",
    "DEFAULT_WIDTH",
    "MAX_WINDOW", "VARIANTS", "ENGINES",
]

M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1
_BIAS = 1 << 63
_I64 = torch.int64

#: splitmix64 constants
GOLDEN = 0x9E3779B97F4A7C15
MIX1 = 0xBF58476D1CE4E5B9
MIX2 = 0x94D049BB133111EB

VARIANTS = ("fmin", "topk", "fmatch", "fsum")
#: "kernel": values from K7; "plain": from :func:`splitmix64_pair`
ENGINES = ("kernel", "plain")

#: rows per window (the reference's scan length; here a window is flat)
ROWS = 8
#: lanes per row: a window is ROWS × DEFAULT_WIDTH = 2^24 indices. On an
#: H100 smaller windows are bound by the host's per-window launches
#: (PERF.md §5); a chunk shorter than a window sweeps only its own lanes
DEFAULT_WIDTH = 1 << 21
#: the largest window: its word sums stay below 2^62
MAX_WINDOW = 1 << 30


# ---------------------------------------------------------------------------
# the plain objective on u32 word pairs
# ---------------------------------------------------------------------------

def _mul_lo32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``(a · b) mod 2^32`` for u32 lanes ``a`` and a u32 constant ``b``."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & M32


def _mulhilo32(a: torch.Tensor, b: int):
    """The full product ``a · b`` as (hi, lo) words: ``a · b_lo16 +
    a · b_hi16 · 2^16``, regrouped so no partial sum reaches 2^49."""
    p0 = a * (b & 0xFFFF)
    p1 = a * (b >> 16)
    s = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (s >> 32), s & M32


def _mul64(h: torch.Tensor, l: torch.Tensor, c: int):
    """``(h‖l) · c mod 2^64``: the low words' full product plus the two
    cross terms' low words (the high × high term drops)."""
    hi, lo = _mulhilo32(l, c & M32)
    return (hi + _mul_lo32(l, c >> 32) + _mul_lo32(h, c & M32)) & M32, lo


def _add64(h: torch.Tensor, l: torch.Tensor, c: int):
    """``(h‖l) + c mod 2^64``."""
    lo = l + (c & M32)
    return (h + (c >> 32) + (lo >> 32)) & M32, lo & M32


def _xorshr64(h: torch.Tensor, l: torch.Tensor, s: int):
    """``x ^ (x >> s)`` for ``0 < s < 32``: the low word takes the
    straddling bits of the high word."""
    return h ^ (h >> s), l ^ (((l >> s) | (h << (32 - s))) & M32)


def splitmix64_pair(seed: int, idx_hi: torch.Tensor, idx_lo: torch.Tensor):
    """The hashcore objective ``splitmix64(seed + (index + 1) · golden)``
    on u32 words in int64 lanes: ``(value_hi, value_lo)``, bit for bit
    the reference's ``objective(seed, index)`` (``index + 1`` wraps at
    2^64). Input words are taken modulo 2^32."""
    zh, zl = _add64(idx_hi & M32, idx_lo & M32, 1)
    zh, zl = _mul64(zh, zl, GOLDEN)
    zh, zl = _add64(zh, zl, seed & _M64)
    zh, zl = _xorshr64(zh, zl, 30)
    zh, zl = _mul64(zh, zl, MIX1)
    zh, zl = _xorshr64(zh, zl, 27)
    zh, zl = _mul64(zh, zl, MIX2)
    return _xorshr64(zh, zl, 31)


def index_words(lo: int, offsets: torch.Tensor):
    """Index words ``(hi, lo)`` of ``lo + offsets``: the low word adds
    the offset, the high word takes its carry. ``lo + offsets`` must not
    pass 2^64 - 1 (a chunk's indices never do)."""
    t = offsets + (lo & M32)
    return (t >> 32) + (lo >> 32), t & M32


# ---------------------------------------------------------------------------
# the dispatch seam: a window in, a chunk-partial accumulator out
# ---------------------------------------------------------------------------

class LaneSweep:
    """One discipline's window sweep on ``device``. :meth:`dispatch`
    queues a window's work and returns its handle without waiting for
    the device; :meth:`resolve` is the one wait and decodes the handle's
    packed int64 values into the accumulator the reference's
    ``LaneSweep.resolve`` returns for the same span:

    - fmin: handle ``[key, off]``
    - topk: ``[key_0..key_{c-1}, off_0..off_{c-1}]``, ``c = min(k, n)``
    - fmatch: ``[first_off, key]`` (``first_off == n`` when dry)
    - fsum: ``[sum of value_hi, sum of value_lo]``
    """

    def __init__(self, variant: str, width: int, rows: int, k: int, device,
                 engine: str = "kernel"):
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}")
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}")
        if width < 1 or rows < 1 or rows * width > MAX_WINDOW:
            raise ValueError(f"width and rows must be >= 1 with rows × width <= {MAX_WINDOW}")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "hashcore lanes on cuda need a CUDA device and torch sees none; "
                "device='cpu' runs the plain versions"
            )
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, got {device}")
        if engine == "kernel":
            # imported here: kernels.splitmix imports this module's plain version
            from tpuminter_torch.kernels.splitmix import splitmix_batch as objective
        else:
            objective = splitmix64_pair
        self._objective = objective
        self.variant, self.width, self.rows, self.engine = variant, width, rows, engine
        self.k = k if variant == "topk" else 1
        self.window = rows * width
        self.device = device
        #: lane offsets, grown to the longest span dispatched so far
        self._offsets = torch.arange(0, dtype=_I64, device=device)

    def dispatch(self, seed: int, lo: int, hi: int, threshold: int = 0) -> "Handle":
        """Queue the sweep of global indices ``[lo, hi]`` (at most one
        window) and return its :class:`Handle`."""
        n = hi - lo + 1
        if not 1 <= n <= self.window:
            raise ValueError("span must fit one dispatch window")
        if n > self._offsets.numel():
            self._offsets = torch.arange(n, dtype=_I64, device=self.device)
        off = self._offsets[:n]
        vh, vl = self._objective(seed, *index_words(lo, off))
        if self.variant == "fsum":
            return Handle(torch.stack([vh.sum(), vl.sum()]))
        key = (vh - (1 << 31)) * (1 << 32) + vl  # value - 2^63, ordered as the value
        if self.variant == "fmin":
            i = key.argmin().view(1)
            return Handle(torch.cat([key.index_select(0, i), i]))
        if self.variant == "topk":
            keys, idx = torch.sort(key, stable=True)
            c = min(self.k, n)
            return Handle(torch.cat([keys[:c], idx[:c]]))
        first = torch.where(key <= threshold - _BIAS, off, n).amin().view(1)
        return Handle(torch.cat([first, key.index_select(0, first.clamp(max=n - 1))]))

    def resolve(self, handle: "Handle", lo: int, hi: int):
        """Read ``handle`` (the one wait, for this window alone) and
        decode the span's chunk-partial accumulator."""
        out = handle.read()
        n = hi - lo + 1
        if self.variant == "fmin":
            return [out[0] + _BIAS, lo + out[1]]
        if self.variant == "topk":
            c = len(out) // 2
            return [[out[s] + _BIAS, lo + out[c + s]] for s in range(c)]
        if self.variant == "fmatch":
            first, key = out
            if first == n:
                return [None, None, n]
            return [lo + first, key + _BIAS, first + 1]
        return [(out[0] << 32) + out[1], n]


@functools.lru_cache(maxsize=64)
def _cached_sweep(variant: str, k: int, width: int, rows: int, device: torch.device,
                  engine: str) -> LaneSweep:
    return LaneSweep(variant, width, rows, k, device, engine)


def lane_sweep(variant: str, *, k: int = 1, width: Optional[int] = None, rows: int = ROWS,
               device="cuda", engine: str = "kernel") -> LaneSweep:
    """The process-cached :class:`LaneSweep` for a job's constants."""
    return _cached_sweep(variant, k if variant == "topk" else 1,
                         DEFAULT_WIDTH if width is None else int(width), rows,
                         torch.device(device), engine)
