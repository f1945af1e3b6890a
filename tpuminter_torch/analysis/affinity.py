"""Runtime loop-affinity race detector: the thread-seam checker's
dynamic twin. Counterpart of ``tpuminter.analysis.affinity``.

``TPUMINTER_LOOP_AFFINITY=1`` (or :func:`enable`) turns on the
instrumentation; the port's production call sites then :func:`stamp` an
object at construction and :func:`rebind` it at the sanctioned
ownership-transfer seams (the multi-loop coordinator hands the writer
journal to shard 0's loop after the control loop recovered it).
Stamping swaps the instance's class for a cached one-off subclass whose
``__setattr__`` compares the writing thread against the stamped owner
on every mutation.

The violation rule follows the control plane's memory model:

- writes from the owner thread: fine;
- writes from another thread that runs no event loop: fine. That is
  the executor seam (``Journal._write_sync`` bumps ``self.size`` from
  the flush executor by design; the loop awaits the future, so the
  write is ordered);
- writes from another thread that runs an event loop: a cross-loop
  mutation, the race the multi-loop seams exist to prevent. Recorded,
  and raised in ``strict`` mode.

With the detector off, :func:`stamp` returns at once: an object pays one
module-global read when it is built and nothing a mutation.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

try:  # running-loop probe that returns None instead of raising
    from asyncio import _get_running_loop
except ImportError:  # pragma: no cover
    import asyncio

    def _get_running_loop():
        try:
            return asyncio.get_running_loop()
        except RuntimeError:
            return None

__all__ = [
    "LoopAffinityError",
    "enable",
    "disable",
    "enabled",
    "owner_ident",
    "rebind",
    "reset",
    "stamp",
    "violations",
]

_OWNER = "_affinity_owner_ident"
_GEN = "_affinity_owner_gen"

_enabled = False
_strict = False
#: bumped on every enable(): a stamp from an earlier enabled window is
#: stale. Instrumented classes outlive disable() (the subclass swap is
#: never undone), so without it an object stamped in one test could
#: record violations in another test's window
_generation = 0
_lock = threading.Lock()
_violations: List[dict] = []
_instrumented: Dict[type, type] = {}

#: Thread identity unique for the process's lifetime, unlike
#: ``threading.get_ident()``: a pthread handle is recycled once a joined
#: thread's stack is reused, so a new loop thread could alias a dead
#: owner and a real cross-loop write would compare equal.
_thread_tokens = threading.local()
_next_token = 0


def _thread_token() -> int:
    global _next_token
    token = getattr(_thread_tokens, "token", None)
    if token is None:
        with _lock:
            _next_token += 1
            token = _next_token
        _thread_tokens.token = token
    return token


class LoopAffinityError(AssertionError):
    """A cross-loop mutation, raised only in strict mode."""


def enabled() -> bool:
    return _enabled


def enable(strict: bool = False) -> None:
    global _enabled, _strict, _generation
    _enabled = True
    _strict = strict
    _generation += 1


def disable() -> None:
    global _enabled, _strict
    _enabled = False
    _strict = False


def reset() -> None:
    with _lock:
        _violations.clear()


def violations() -> List[dict]:
    with _lock:
        return list(_violations)


def _record(obj: object, name: str, owner: int, writer: int) -> None:
    entry = {
        "cls": type(obj).__name__,
        "attr": name,
        "owner_ident": owner,
        "writer_ident": writer,
        "writer_thread": threading.current_thread().name,
    }
    with _lock:
        _violations.append(entry)
    if _strict:
        raise LoopAffinityError(
            f"cross-loop mutation: {entry['cls']}.{name} owned by thread "
            f"{owner}, written from loop thread {writer} "
            f"({entry['writer_thread']})"
        )


def _instrument(cls: type) -> type:
    sub = _instrumented.get(cls)
    if sub is not None:
        return sub

    def __setattr__(self, name, value):  # noqa: N807
        owner = self.__dict__.get(_OWNER)
        if (
            _enabled
            and owner is not None
            and self.__dict__.get(_GEN) == _generation
            and not name.startswith("_affinity_")
        ):
            writer = _thread_token()
            if writer != owner and _get_running_loop() is not None:
                _record(self, name, owner, writer)
        cls.__setattr__(self, name, value)

    sub = type(cls.__name__, (cls,), {
        "__setattr__": __setattr__,
        "_affinity_instrumented": True,
        "__module__": cls.__module__,
    })
    _instrumented[cls] = sub
    return sub


def stamp(obj: object) -> object:
    """Mark ``obj`` as owned by the calling thread's loop. No-op (and
    free) while the detector is disabled."""
    if not _enabled:
        return obj
    cls = type(obj)
    if not getattr(cls, "_affinity_instrumented", False):
        try:
            obj.__class__ = _instrument(cls)
        except TypeError:  # __slots__/extension layouts: skip quietly
            return obj
    object.__setattr__(obj, _OWNER, _thread_token())
    object.__setattr__(obj, _GEN, _generation)
    return obj


def rebind(obj: object) -> object:
    """Transfer ownership to the calling thread — the sanctioned seam
    for handing an object to another loop (stamp again, by intent)."""
    return stamp(obj)


def owner_ident(obj: object) -> Optional[int]:
    return getattr(obj, _OWNER, None)


if os.environ.get("TPUMINTER_LOOP_AFFINITY") == "1":  # pragma: no cover
    enable(strict=os.environ.get("TPUMINTER_LOOP_AFFINITY_STRICT") == "1")
