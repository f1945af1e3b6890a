"""The pod's sweeps: each rank runs the port's kernels on its own card,
and small collectives fold the ranks' answers into one that every rank
holds.

Counterpart of ``tpuminter.parallel.mesh``. There a sweep is one
``shard_map`` program over a device mesh; here it is a plain function
that every rank of a :class:`~tpuminter_torch.parallel.distributed.Pod`
calls with the same arguments, in the same order, and that returns the
same answer on every rank. The reference's collectives map so:

- ``lax.pmax`` of a found flag and ``lax.pmin`` of the lowest candidate
  offset, issued together each stripe, become one ``all_reduce(MIN)`` of
  an int64 offset in which :data:`NO_HIT` (above any offset) stands for
  "no candidate": the flag is ``min < NO_HIT``, one round a stripe;
- ``lax.all_gather`` of the min folds, and the ``lax.psum`` that sends
  the winner's digest from its one contributor, become one
  ``all_gather`` of each rank's packed row, folded on the host the same
  way on every rank: the winner's row carries its own digest.

Offsets count from the sweep's start, never absolute nonces, so a span
that wraps past 2^32 folds in order.

- :func:`candidate_sweep` ← ``build_candidate_sweep``: slab striping, 3h
  (``search_candidates_header``) or, for a header given as values, K4
  (``search_candidates_hdr``), with the stripe-synchronous early exit.
- :func:`rolled_sweep` ← ``build_rolled_sweep``: the rank's block of a
  device-major window (``rolled.plan_tiles(interleave=world)``) through
  R and one launch of K5's ``sched`` arm.
- :func:`exact_sweep` ← ``build_exact_sweep_pallas``: ``2h`` on a slab a
  rank, then the 11-word fold.
- :func:`min_sweep` ← ``build_min_sweep_pallas``: ``6t`` on a slab a
  rank, then the ``(fold, argmin)`` fold.
- :func:`scrypt_sweep` ← ``build_scrypt_sweep``: S1 → 19 → S2 on a
  batch a rank, then the winner and minimum folds.

``build_target_sweep`` and ``build_min_fold`` were the reference's jnp
engines for its CPU mesh. A port rank on the CPU runs these same sweeps
on the kernels' plain versions, so they have no counterpart; the tests
hold these sweeps against them.

The fold sweeps return a :class:`Gathered` handle: on NCCL the gather
stays on the card and nothing waits until :meth:`Gathered.read`, so the
miner keeps ``depth`` spans in flight; on gloo the rows cross to the
host at the gather.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from tpuminter_torch import kernels, rolled
from tpuminter_torch.ops import merkle
from tpuminter_torch.parallel.distributed import Pod

__all__ = ["NO_HIT", "Gathered", "candidate_sweep", "rolled_sweep", "exact_sweep",
           "min_sweep", "scrypt_sweep"]

#: an offset no sweep reaches (sweeps cover at most 2^32 indices): "no hit"
NO_HIT = 1 << 62
_M32 = 0xFFFFFFFF
_I64 = torch.int64

#: slab_fn(base, take) -> the kernel's [found, first_off] handle
SlabFn = Callable[[int, int], torch.Tensor]


class Gathered:
    """Every rank's row of one fold sweep; :meth:`read` waits for them and
    folds them on the host with ``fold``."""

    def __init__(self, rows: torch.Tensor, fold: Callable[[List[list]], list]):
        self._rows, self._fold = rows, fold

    def read(self) -> list:
        return self._fold(self._rows.cpu().tolist())


def _hit(found: torch.Tensor, off: torch.Tensor, lead: int) -> torch.Tensor:
    """``lead + off`` where ``found`` is set, else :data:`NO_HIT` (int64
    device tensors of one element)."""
    return torch.where(found != 0, off + lead, torch.full_like(off, NO_HIT))


def candidate_sweep(pod: Pod, slab_fn: SlabFn, start: int, n: int, *, slab: int,
                    n_slabs: int) -> Tuple[bool, int, int]:
    """The lowest candidate offset in ``[start, start + n)`` (nonces mod
    2^32), striped over the pod: in stripe ``b`` rank ``d`` sweeps the
    slab of ``slab`` nonces at offset ``(b·world + d)·slab`` (clipped to
    ``n``) with ``slab_fn``. Returns ``(found, first_off, stripes_done)``
    on every rank; ``n`` is at most ``world × n_slabs × slab``.

    The early exit is stripe-synchronous, one ``all_reduce(MIN)`` and one
    host read a stripe, and it is exact: when stripe ``b`` finds, every
    slab of the stripes before it was swept clean, and each rank swept
    its stripe-``b`` slab up to its own first candidate (the kernels
    report the lowest), so the minimum over the ranks is the lowest
    candidate of the covered prefix and every offset below it is
    candidate-free: ``search.CandidateSearch``'s lowest-winner contract."""
    span = pod.world * slab
    if not 1 <= n <= span * n_slabs:
        raise ValueError(f"n={n} is not in [1, {span * n_slabs}]")
    stripes = -(-n // span)
    for b in range(stripes):
        off0 = (b * pod.world + pod.rank) * slab
        take = min(slab, n - off0)
        if take > 0:
            h = slab_fn((start + off0) & _M32, take)
            local = _hit((h[:1] != 0) & (h[1:2] < take), h[1:2], off0)
        else:
            local = torch.tensor([NO_HIT], dtype=_I64, device=pod.device)
        first = int(pod.all_reduce_min(local)[0])
        if first != NO_HIT:
            return True, first, b + 1
    return False, NO_HIT, stripes


def rolled_sweep(pod: Pod, plan: rolled.TilePlan, job: merkle.RollJob, width: int,
                 hw1_cap: int) -> Tuple[bool, int]:
    """The lowest candidate's global offset in one rolled window, over the
    pod: ``plan`` holds every rank's rows device-major
    (``rolled.plan_tiles(interleave=world)``), and rank ``d`` rolls its
    block of ``rows / world`` rows (R, each distinct extranonce once) and
    sweeps it in one launch of K5's ``sched`` arm, then one
    ``all_reduce(MIN)`` folds the ranks' lowest global offsets. Returns
    ``(found, first_goff)`` on every rank.

    The reference sweeps the same rows stripe by stripe, one row a rank
    with a ``pmin`` each, and stops at the first stripe that finds. This
    form is the same answer in one launch and one round: global offsets
    rise with global row order, so the window's lowest candidate lies in
    that first stripe, and the minimum over the ranks' lowest is its
    ``pmin``. It sweeps the whole window even past a winner, at most one
    window a found job. K5 sweeps a row's valid nonces only, so no
    candidate past a row's ``valids`` can surface."""
    rows = len(plan.valids)
    per = rows // pod.world
    block = slice(pod.rank * per, (pod.rank + 1) * per)
    mids, tails = merkle.roll_batch_deduped(
        lambda hi, lo: kernels.extranonce_roll(job, hi, lo), plan.en_hi[block],
        plan.en_lo[block], pod.device)
    cols = merkle.to_device(
        np.concatenate([plan.bases[block], plan.valids[block], plan.goffs[block]]), pod.device)
    handle = kernels.search_candidates_hdr_batch_sched(
        mids, tails, cols[:per], cols[per:2 * per], width, hw1_cap)
    local = _hit(handle[:, 0], handle[:, 1], 0) + cols[2 * per:]
    local = local.clamp(max=NO_HIT).min().reshape(1)
    first = int(pod.all_reduce_min(local)[0])
    return first < NO_HIT, first


def _fold_exact(rows: Sequence[Sequence[int]]) -> list:
    """The ranks' ``2h`` rows ``[found, win_off, min_words×8, min_off]`` →
    the pod's: found if any rank found, the lowest winning offset, and
    the lexicographic minimum of (hash words, offset)."""
    found = int(any(r[0] for r in rows))
    best = min((tuple(r[2:10]), r[10]) for r in rows)
    return [found, min(r[1] for r in rows), *best[0], best[1]]


def exact_sweep(pod: Pod, template, target_words: Sequence[int], start: int, *,
                slab: int) -> Gathered:
    """``2h`` (``kernels.search_target``) on rank ``d``'s slab of ``slab``
    nonces at offset ``d·slab`` of ``start``, then one ``all_gather``:
    the handle reads ``[found, win_off, min_words×8, min_off]``, offsets
    from ``start``. The winner is the lowest over the ranks' first hits,
    each its slab's lowest, so the span's lowest winner; the minimum is
    the span's exact one (``_fold_exact``). Full spans only, as in the
    reference: the miner runs a ragged tail on one card."""
    lead = pod.rank * slab
    h = kernels.search_target(template, target_words, (start + lead) & _M32, slab,
                              device=pod.device)
    row = torch.cat([h[:1], _hit(h[:1], h[1:2], lead), h[2:10], h[10:11] + lead])
    return Gathered(pod.all_gather(row), _fold_exact)


def _fold_min(rows: Sequence[Sequence[int]]) -> list:
    """The ranks' ``6t`` rows ``[fold_hi, fold_lo, off]`` → the pod's
    minimum fold, ties to the lowest offset."""
    return list(min(tuple(r) for r in rows))


def min_sweep(pod: Pod, template, start: int, *, slab: int) -> Gathered:
    """``6t`` (``kernels.min_toy``) on rank ``d``'s ``slab`` 64-bit nonces
    at ``start + d·slab``, then one ``all_gather``: the handle reads
    ``[fold_hi, fold_lo, off]``, ``off`` from ``start``
    (``_fold_min``). Full spans only."""
    lead = pod.rank * slab
    base = start + lead
    h = kernels.min_toy(template, (base >> 32) & _M32, base & _M32, slab, device=pod.device)
    row = torch.cat([h[:2], h[2:3] + lead])
    return Gathered(pod.all_gather(row), _fold_min)


def _fold_scrypt(rows: Sequence[Sequence[int]]) -> list:
    """The ranks' rows ``[found, win_off, min_words×8, min_off,
    win_words×8]`` → ``[found, win_off, win_words×8, min_words×8,
    min_off]``: the lowest winner with its own hash words (the
    reference's masked ``psum``), and the lexicographic minimum."""
    found = int(any(r[0] for r in rows))
    win = min((r[1], tuple(r[11:19])) for r in rows)
    best = min((tuple(r[2:10]), r[10]) for r in rows)
    return [found, win[0], *win[1], *best[0], best[1]]


def scrypt_sweep(pod: Pod, header_words: Sequence[int], start: int, target_words: Sequence[int],
                 v: torch.Tensor, *, batch: int, n_log2: int) -> Gathered:
    """S1 → 19 → S2 (``kernels.scrypt_front``, ``romix_walk``,
    ``scrypt_back``) on rank ``d``'s ``batch`` nonces from ``start +
    d·batch``, on the rank's V, then one ``all_gather``: the handle
    reads ``_fold_scrypt``'s row, offsets from ``start``. Full spans
    only."""
    lead = pod.rank * batch
    nonces = torch.arange(start + lead, start + lead + batch, dtype=_I64, device=pod.device)
    x = kernels.scrypt_front(header_words, nonces, n_log2, v)
    x = kernels.romix_walk(x, v, n_log2, 1 << n_log2)
    h = kernels.scrypt_back(header_words, nonces, x, target_words)[1]
    row = torch.cat([h[:1], _hit(h[:1], h[1:2], lead), h[2:10], h[10:11] + lead, h[11:19]])
    return Gathered(pod.all_gather(row), _fold_scrypt)
