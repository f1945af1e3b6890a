"""Pluggable workloads: the registry, the worker's compute seam and the
coordinator's coverage-gated fold state.

Counterpart of ``tpuminter.workloads``. A :class:`Workload` resolves a
Request's fold discipline from its params, computes a chunk as a
cooperative generator (the worker's half, on the card), verifies a
chunk's claimed partial and cuts a large job's params into per-chunk
windows (the coordinator's half, on the host). The registry names what a
worker's ``Join`` advertises; :func:`compute` runs one chunk and yields
its ``WorkResult``.

**Coverage-gated fold state.** A job's fold state is ``{"covered":
[[lo, hi], ...], "acc": <fold acc>}``. :func:`absorb` refuses a chunk
whose range overlaps what is already covered, which makes even the
non-idempotent fold (sum) exactly-once under journal replay and
duplicate delivery: absorbing the same settle twice is a no-op.

Registered here: ``dict`` (``workloads.dictsearch``) and ``hashcore``
(``workloads.hashcore``), so the worker's Join names ``dict,hashcore``
as the reference worker's does. Loading the registry loads no
``torch``: the hashcore kernel path imports it inside ``compute``, so
the coordinator's half runs on a host without a CUDA stack.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

from tpuminter_torch.protocol import WorkResult
from tpuminter_torch.workloads.folds import FirstMatch, FMin, Fold, FSum, TopK  # noqa: F401

__all__ = [
    "Workload", "register", "get", "maybe", "names", "new_state", "absorb",
    "absorb_payload", "merge_states", "fold_of", "compute", "verify_claim", "window_for",
    "chunk_cap", "covered_span", "Fold", "FMin", "TopK", "FirstMatch", "FSum",
]


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

    def verify(self, request, fold: Fold, acc: Any) -> bool:
        """The coordinator's check of a decoded chunk partial against
        this chunk-Request's exact ``[lower, upper]``."""
        raise NotImplementedError

    def window(self, request, lo: int, hi: int) -> Optional[bytes]:
        """A params frame carrying only what indices ``[lo, hi]`` need,
        or None when the job's cached Setup serves every chunk (the
        default)."""
        return None

    def chunk_cap(self, request) -> int:
        """Upper bound on indices a dispatch (0 = none, the default)."""
        return 0


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


# -- coverage-gated fold state (the coordinator's exactly-once gate) ----------

def new_state(fold: Fold) -> dict:
    return {"covered": [], "acc": fold.initial()}


def _overlaps(covered: List[list], lo: int, hi: int) -> bool:
    return any(not (hi < a or b < lo) for a, b in covered)


def _cover(covered: List[list], lo: int, hi: int) -> List[list]:
    """Insert inclusive ``[lo, hi]`` and coalesce touching spans."""
    spans = sorted([list(s) for s in covered] + [[lo, hi]])
    out: List[list] = []
    for a, b in spans:
        if out and a <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _span(covered: List[list]) -> int:
    return sum(b - a + 1 for a, b in covered)


def absorb(fold: Fold, state: dict, lo: int, hi: int, acc: Any) -> bool:
    """Fold one chunk partial into ``state`` unless its range is already
    covered; False (state untouched) on a duplicate."""
    if lo > hi or _overlaps(state["covered"], lo, hi):
        return False
    state["covered"] = _cover(state["covered"], lo, hi)
    state["acc"] = fold.combine(state["acc"], acc)
    return True


def merge_states(fold: Fold, a: Optional[dict], b: Optional[dict]) -> Optional[dict]:
    """Merge two fold states of one job: disjoint coverage (or an
    idempotent fold) combines; an overlap on sum keeps the state with
    the larger coverage (re-mine rather than double-count)."""
    if a is None or not a["covered"]:
        return b if a is None else (b or a)
    if b is None or not b["covered"]:
        return a
    disjoint = all(not _overlaps(a["covered"], lo, hi) for lo, hi in b["covered"])
    if fold.idempotent or disjoint:
        covered = a["covered"]
        for lo, hi in b["covered"]:
            covered = _cover(covered, lo, hi)
        return {"covered": covered, "acc": fold.combine(a["acc"], b["acc"])}
    return a if _span(a["covered"]) >= _span(b["covered"]) else b


def _workload_of(request) -> Optional[Workload]:
    return _REGISTRY.get(getattr(request, "workload", "") or "")


def fold_of(request) -> Optional[Fold]:
    """The discipline a Request's workload and params name, or None when
    the workload is unknown or the params are malformed."""
    workload = _workload_of(request)
    if workload is None:
        return None
    try:
        return workload.fold_for(request)
    except ValueError:
        return None


def verify_claim(request, msg) -> bool:
    """The coordinator's verifier: does this WorkResult's payload hold
    up against the chunk-Request it answers?"""
    workload = _workload_of(request)
    if workload is None or getattr(msg, "wid", None) != workload.wid:
        return False
    try:
        fold = workload.fold_for(request)
        acc = fold.decode(msg.payload)
    except ValueError:
        return False
    return workload.verify(request, fold, acc)


def window_for(request, lo: int, hi: int) -> Optional[bytes]:
    """The params window covering ``[lo, hi]`` of this job, or None when
    the cached full-job Setup serves every chunk (also for an unknown
    workload or malformed params)."""
    workload = _workload_of(request)
    if workload is None:
        return None
    try:
        return workload.window(request, lo, hi)
    except ValueError:
        return None


def chunk_cap(request) -> int:
    """Indices a dispatch may carry for this job (0 = unbounded)."""
    workload = _workload_of(request)
    if workload is None:
        return 0
    try:
        return max(0, int(workload.chunk_cap(request)))
    except ValueError:
        return 0


def covered_span(state: Optional[dict]) -> int:
    """Settled-index count of a fold state (0 for None)."""
    return _span(state["covered"]) if state else 0


def absorb_payload(request, state: Optional[dict], lo: int, hi: int,
                   payload: bytes) -> Tuple[Optional[dict], bool]:
    """The journal's seam: absorb one settle record's fold payload into
    a (possibly fresh) fold state, coverage-gated. Returns ``(state,
    absorbed)``; a duplicate or undecodable payload leaves the state
    untouched."""
    workload = _workload_of(request)
    if workload is None:
        return state, False
    try:
        fold = workload.fold_for(request)
        acc = fold.decode(payload)
    except ValueError:
        return state, False
    if state is None:
        state = new_state(fold)
    return state, absorb(fold, state, lo, hi, acc)


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
