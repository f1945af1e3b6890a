"""Pluggable workloads: the registry and the worker-side compute seam.

Counterpart of ``tpuminter.workloads``, reduced to the worker's half: a
:class:`Workload` resolves a chunk-Request's fold discipline from its
params and computes the chunk as a cooperative generator; the registry
names what the worker's ``Join`` advertises; :func:`compute` runs one
chunk and yields its ``WorkResult``. The coordinator's half (coverage
state, verification, windows) stays in the reference.

Registered here: ``dict`` (``workloads.dictsearch``) and ``hashcore``
(``workloads.hashcore``), so the worker's Join names ``dict,hashcore``
as the reference worker's does.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

from tpuminter_torch.protocol import WorkResult
from tpuminter_torch.workloads.folds import Fold

__all__ = ["Workload", "register", "get", "maybe", "names", "compute"]


class Workload:
    """One registered task type: ``name`` rides Join advertisements and
    Requests, ``wid`` is its numeric id on WorkResults (the reference's
    ids, so the reference coordinator accepts them)."""

    name: str = ""
    wid: int = 0

    def fold_for(self, request) -> Fold:
        """The fold discipline this Request's params ask for; ValueError
        on malformed params."""
        raise NotImplementedError

    def compute(self, request, fold: Fold, device="cuda", engine: str = "kernel"):
        """Cooperative generator: yields ``None`` between steps, returns
        ``(searched, acc)``."""
        raise NotImplementedError


_REGISTRY: Dict[str, Workload] = {}


def register(workload: Workload) -> Workload:
    """Register a workload; a second one under a taken name or id raises."""
    if not workload.name:
        raise ValueError("workload needs a non-empty name")
    if not 1 <= workload.wid < 256:
        raise ValueError("workload wid must be a u8 in [1, 255]")
    for have in _REGISTRY.values():
        if have is not workload and workload.wid == have.wid:
            raise ValueError(f"workload wid {workload.wid} already taken by {have.name!r}")
    have = _REGISTRY.get(workload.name)
    if have is not None and have is not workload:
        raise ValueError(f"workload name {workload.name!r} already taken")
    _REGISTRY[workload.name] = workload
    return workload


def get(name: str) -> Workload:
    return _REGISTRY[name]


def maybe(name: str) -> Optional[Workload]:
    return _REGISTRY.get(name)


def names() -> Tuple[str, ...]:
    """Sorted registered names: what the worker's Join advertises."""
    return tuple(sorted(_REGISTRY))


def compute(request, device="cuda", engine: str = "kernel") -> Iterator:
    """Run the registered compute generator for one chunk-Request on
    ``device`` and yield its final ``WorkResult``: the worker loop's
    drop-in for ``miner.mine(request)``. ``engine="plain"`` computes the
    objective with its plain PyTorch version (a reference to hold the
    kernel path against; the worker never asks for it)."""
    workload = get(request.workload)
    fold = workload.fold_for(request)
    searched, acc = yield from workload.compute(request, fold, device, engine)
    yield WorkResult(
        job_id=request.job_id,
        chunk_id=request.chunk_id,
        wid=workload.wid,
        searched=searched,
        payload=fold.encode(acc),
    )


# built-in workloads register on import (the registry above must exist first)
from tpuminter_torch.workloads import dictsearch  # noqa: E402,F401
from tpuminter_torch.workloads import hashcore  # noqa: E402,F401
