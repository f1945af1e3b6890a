"""LSP tunables. Counterpart of ``tpuminter.lsp.params`` (``Params``, the
``FAST`` settings the roles use, and the redial backoff), plus the two
address-list helpers every redialing role shares, whose reference
counterparts live in ``tpuminter.replication``."""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple


@dataclass(frozen=True)
class Params:
    #: Declare the connection lost after this many silent epochs.
    epoch_limit: int = 5
    #: Epoch tick interval, in milliseconds.
    epoch_millis: int = 2000
    #: Sliding window: a DATA frame may be sent while
    #: ``seq < oldest_unacked_seq + window_size``.
    window_size: int = 1
    #: Cap on retransmit backoff, in epochs. 0 = retransmit every epoch.
    max_backoff_interval: int = 0
    #: Cap on in-flight unacked DATA frames; defaults to ``window_size``.
    max_unacked_messages: Optional[int] = None

    def __post_init__(self) -> None:
        if self.epoch_limit < 1 or self.epoch_millis < 1 or self.window_size < 1:
            raise ValueError("epoch_limit, epoch_millis, window_size must be >= 1")
        if self.max_backoff_interval < 0:
            raise ValueError("max_backoff_interval must be >= 0")
        if self.max_unacked_messages is None:
            object.__setattr__(self, "max_unacked_messages", self.window_size)
        elif self.max_unacked_messages < 1:
            raise ValueError("max_unacked_messages must be >= 1")

    @property
    def epoch_seconds(self) -> float:
        return self.epoch_millis / 1000.0


def jittered_backoff(base: float, cap: float,
                     rng: Optional[random.Random] = None) -> Iterator[float]:
    """Redial delays: ``base · 2^k`` capped at ``cap``, each scaled by a
    uniform [0.5, 1.5) jitter, so a fleet that lost one coordinator does
    not redial in lockstep. One generator an episode of failed dials;
    start a fresh one after a session that served."""
    rng = rng or random.Random()
    delay = base
    while True:
        yield delay * (0.5 + rng.random())
        delay = min(delay * 2, cap)


#: Settings of the mining roles (the coordinator's default too).
FAST = Params(
    epoch_limit=5,
    epoch_millis=250,
    window_size=64,
    max_backoff_interval=2,
    max_unacked_messages=64,
)


def dial_patience(targets) -> Optional[int]:
    """Connect epochs a dial waits: 2 when there is another address to
    rotate to (a dead primary must cost a fraction of the loss horizon;
    each epoch resends the CONNECT, so 2 still survives one lost
    datagram), else None (the session's own ``epoch_limit``)."""
    return 2 if len(targets) > 1 else None


def parse_addr_list(spec: str) -> List[Tuple[str, int]]:
    """``HOST:PORT[,HOST:PORT...]`` → ``[(host, port), ...]``; a bare
    ``:PORT`` is localhost. Raises ValueError on an empty list or a port
    that is not a number."""
    addrs = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        addrs.append((host or "127.0.0.1", int(port)))
    if not addrs:
        raise ValueError(f"no coordinator addresses in {spec!r}")
    return addrs
