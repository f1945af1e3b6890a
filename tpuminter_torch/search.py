"""Pipelined candidate search: the host half of the TARGET sweep.

Counterpart of ``tpuminter.search``. The candidate kernel
(:func:`tpuminter_torch.kernels.search_candidates`) reports only the
first nonce of a swept range whose hash has its top 32 bits zero; this
module keeps ``depth`` sweeps in flight, verifies each candidate on the
host against the real target, re-issues the range above a false
positive, and accepts a verified win only once every nonce below it is
searched, so the winner is the lowest winning nonce in the range (the
sequential CPU miner's contract).

A sweep's handle is the small device tensor its kernel wrote
(``[found, first_off]``): the kernel already packs it, which is what
``pack_handle`` did for the JAX package, and :func:`resolve_handle`
(``.cpu()``) is the only point that waits for the device.

One departure: a sweep covers exactly the nonces still to search. The
JAX package always swept a full slab, because its kernel specialised on
``n`` at compile time; these kernels take ``n`` at run time, so a short
trailing range or post-candidate remainder costs only its own length.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import torch

__all__ = ["CandidateSearch", "Handle", "SearchOutcome", "pipeline_spans", "resolve_handle"]

#: sweep(base, n) -> handle (asynchronous launch)
SweepFn = Callable[[int, int], torch.Tensor]
#: resolve(handle) -> (found, first_off); waits for the device
ResolveFn = Callable[[torch.Tensor], Tuple[int, int]]
#: verify(nonce) -> (wins, hash_value), the full host-side evaluation
VerifyFn = Callable[[int], Tuple[bool, int]]


def resolve_handle(handle: torch.Tensor) -> Tuple[int, int]:
    """Read a sweep handle ``[found, first_off]`` (one device sync)."""
    found, off = handle[:2].cpu().tolist()
    return found, off


class Handle:
    """A dispatch's packed int64 result on its way to the host (a
    hashcore window's, a SCRYPT batch's). On the card it is copied into
    pinned memory behind the dispatch's work and an event marks the
    copy's end, so :meth:`read` waits for this dispatch alone: reading
    the device tensor itself would wait for everything queued on the
    stream, the next dispatch in flight included, and leave the card
    idle while the host issues the one after it."""

    def __init__(self, packed: torch.Tensor):
        if packed.device.type == "cpu":
            self._host, self._done = packed, None
            return
        self._host = torch.empty(packed.shape, dtype=torch.int64, pin_memory=True)
        self._host.copy_(packed, non_blocking=True)
        self._done = torch.cuda.Event()
        self._done.record(torch.cuda.current_stream(packed.device))

    def read(self) -> list:
        if self._done is not None:
            self._done.synchronize()
        return self._host.tolist()


def pipeline_spans(
    spans: Iterable, dispatch: Callable[..., object], depth: int = 2
) -> Iterator[Tuple[object, object]]:
    """Keep up to ``depth`` launches in flight over a host loop of device
    calls (MIN, exact-min): yields ``(span, handle)`` in dispatch order.
    ``dispatch(span)`` must not block; the caller reads each handle,
    which is the only sync. A caller that stops consuming simply drops
    the in-flight handles: the caching allocator reuses their memory
    only after the work queued on the stream before it, so an abandoned
    handle is safe."""
    if depth < 1:
        raise ValueError("depth must be >= 1")
    inflight: deque = deque()
    for span in spans:
        inflight.append((span, dispatch(span)))
        if len(inflight) >= depth:
            yield inflight.popleft()
    while inflight:
        yield inflight.popleft()


@dataclass
class SearchOutcome:
    """Terminal state of a :class:`CandidateSearch` run."""

    found: bool
    nonce: Optional[int] = None
    hash_value: Optional[int] = None
    searched: int = 0
    #: every candidate surfaced (nonce, hash); at exhaustion their min is
    #: the exact range minimum iff any candidate existed
    candidates: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def best(self) -> Optional[Tuple[int, int]]:
        """(hash, nonce) minimum over surfaced candidates, or None."""
        if not self.candidates:
            return None
        return min((h, n) for n, h in self.candidates)


class CandidateSearch:
    """Exact lowest-winner search over ``[lower, upper]`` (inclusive): at
    most ``slab`` indices per sweep, ``depth`` sweeps in flight. Drive it
    with :meth:`events`, a generator yielding ``None`` after every
    resolved sweep (the worker's heartbeat and Cancel point); when it
    stops, :attr:`outcome` is set.

    Indices are u32 header nonces by default; ``domain`` widens them,
    for a rolled job's global indices (extranonce × nonce, where a sweep
    is one batched window of roll rows). Nothing else changes: the
    bookkeeping is keyed by whatever integers ``sweep`` and ``verify``
    speak.

    When a verified win ends the search, up to ``depth - 1`` in-flight
    handles above it are abandoned, never resolved (safe, see
    :func:`pipeline_spans`).
    """

    def __init__(
        self,
        sweep: SweepFn,
        resolve: ResolveFn,
        verify: VerifyFn,
        lower: int,
        upper: int,
        *,
        slab: int = 1 << 27,
        depth: int = 2,
        domain: int = 1 << 32,
    ):
        if not 0 <= lower <= upper < domain:
            raise ValueError(f"bad range [{lower}, {upper}] for domain {domain}")
        if not 1 <= slab < 1 << 32:
            raise ValueError("slab must be in [1, 2^32)")
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._sweep, self._resolve, self._verify = sweep, resolve, verify
        self.lower, self.upper = lower, upper
        self.slab, self.depth = slab, depth
        # disjoint unsearched ranges; ascending except re-queued
        # remainders, which go to the FRONT (always lower than the rest)
        self._pending: deque = deque([(lower, upper)])
        self._inflight: deque = deque()  # (start, end, handle) FIFO
        self._wins: List[Tuple[int, int]] = []  # (nonce, hash)
        self.outcome: Optional[SearchOutcome] = None
        self._searched = 0
        self._candidates: List[Tuple[int, int]] = []

    @property
    def searched(self) -> int:
        """Indices swept so far (an early exit counts its covered prefix)."""
        return self._searched

    def settled_high_water(self) -> Optional[int]:
        """Highest ``g`` such that every index of ``[lower, g]`` is swept
        with no winner accepted below it, or None while nothing is: what
        a progress beacon may report."""
        lo = self._unsearched_min()
        if lo is None:
            return self.upper
        if lo <= self.lower:
            return None
        return lo - 1

    def best_candidate(self) -> Optional[Tuple[int, int]]:
        """(hash, index) minimum over the candidates surfaced so far."""
        if not self._candidates:
            return None
        return min((h, n) for n, h in self._candidates)

    def _issue_one(self) -> None:
        start, end = self._pending.popleft()
        take = min(self.slab, end - start + 1)
        if start + take - 1 < end:
            self._pending.appendleft((start + take, end))
        self._inflight.append((start, start + take - 1, self._sweep(start, take)))

    def _unsearched_min(self) -> Optional[int]:
        starts = [s for s, _ in self._pending]
        starts += [s for s, _, _ in self._inflight]
        return min(starts) if starts else None

    def _try_finish(self) -> bool:
        if not self._wins:
            if self._pending or self._inflight:
                return False
            self.outcome = SearchOutcome(
                found=False, searched=self._searched, candidates=self._candidates,
            )
            return True
        w_nonce, w_hash = min(self._wins)
        lo = self._unsearched_min()
        if lo is not None and lo < w_nonce:
            return False
        self.outcome = SearchOutcome(
            found=True, nonce=w_nonce, hash_value=w_hash,
            searched=self._searched, candidates=self._candidates,
        )
        return True

    def events(self) -> Iterator[None]:
        """Run to completion; yields after each resolved sweep."""
        while True:
            while len(self._inflight) < self.depth and self._pending:
                self._issue_one()
            if not self._inflight:
                if not self._try_finish():
                    raise RuntimeError("candidate search ran out of work unfinished")
                return
            start, end, handle = self._inflight.popleft()
            found, off = self._resolve(handle)
            n = end - start + 1
            if not found:
                self._searched += n
            else:
                cand = start + off
                self._searched += off + 1
                if cand < end:
                    # early exit skipped the rest: search it before
                    # anything later (front of queue keeps nonce order)
                    self._pending.appendleft((cand + 1, end))
                wins, hash_value = self._verify(cand)
                self._candidates.append((cand, hash_value))
                if wins:
                    self._wins.append((cand, hash_value))
                    # ranges entirely above a verified win cannot beat it
                    self._pending = deque((s, e) for s, e in self._pending if s < cand)
            if self._try_finish():
                yield
                return
            yield
