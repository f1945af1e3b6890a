"""Rolled (extranonce) TARGET mining: one search over a job's global
indices ``extranonce << nonce_bits | nonce``.

Counterpart of ``tpuminter.rolled``. The fast path (targets below
2^224, every real difficulty) sweeps windows of ``roll_batch × width``
global indices:

- :func:`plan_tiles` cuts a window into rows (``chain.rolled_tiles``),
  each inside one extranonce and at most ``width`` nonces wide;
- the roll kernel (``kernels.extranonce_roll``) turns each row's
  extranonce into its header's midstate and tail words on the card, the
  distinct extranonces once each with ``sched_share``;
- one launch of K5 (``kernels.search_candidates_hdr_batch``, or its
  ``_sched`` arm with ``sched_share``) sweeps every row under its own
  header, and a few torch ops fold the rows' first candidates into the
  window's ``[found, first_global_off]`` handle;
- one ``search.CandidateSearch`` over global indices keeps ``depth``
  windows in flight across extranonce boundaries and verifies each
  candidate on the host (:func:`rolled_verifier`).

``roll_batch=1`` keeps the per-segment loop, on K4
(``kernels.search_candidates_hdr``) with one roll per segment.
:func:`mine_rolled_tracking` serves toy-easy targets (2^224 and up)
with the exact minimum: each segment's header is built on the host and
swept by the fixed-header tracking kernel K2.

Departures from the reference. Its ``lean_plan`` is gone: it sliced
padding rows off a plan to bucket jit shapes, while a ``valid == 0``
row costs the CUDA kernel nothing. Its ``engine`` choice (Pallas or
jnp) is the device of the tensors here, and its ``cand_bits`` test
seam is not copied: the candidate test is always the production one
(top 32 hash bits zero and hash word 1 under the target's). Its
batched tracking sweep (a jnp program, no Pallas kernel) is the
per-segment loop its ``TpuMiner`` runs at ``roll_batch=1``; its
``width`` autotuning is not ported. :func:`plan_tiles`' ``interleave``
lays rows out device-major for the pod's sharded window
(``parallel.mesh.rolled_sweep``).
"""

from __future__ import annotations

import functools
import struct
from typing import Callable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpuminter_torch import chain, kernels
from tpuminter_torch.ops import merkle
from tpuminter_torch.ops import sha256 as ops
from tpuminter_torch.protocol import MIN_UNTRACKED, PowMode, Request, Result
from tpuminter_torch.search import CandidateSearch, resolve_handle

__all__ = [
    "span_bits",
    "tile_width",
    "TilePlan",
    "plan_tiles",
    "rolled_verifier",
    "report_search_progress",
    "fold_rows",
    "mine_rolled_fast",
    "mine_rolled_tracking",
    "ProgressFn",
]

#: progress(high_water, best_index, best_hash): called between sweeps
#: with the highest global index below which everything is swept with no
#: winner, and the running minimum (``MIN_UNTRACKED`` before any
#: candidate); the worker turns it into ``Beacon`` messages
ProgressFn = Callable[[int, int, int], None]

#: a window's first_global_off when no row hit (windows are < 2^32 wide)
_NO_HIT = 0xFFFFFFFF


def span_bits(req: Request) -> int:
    """Bit width of a rolled job's global index space."""
    return min(64, req.nonce_bits + 8 * req.extranonce_size)


def tile_width(nonce_bits: int, cap: int) -> int:
    """Row width: the segment size capped at the largest power of two
    ``<= cap``, so it divides the segment size."""
    if cap < 1:
        raise ValueError("width cap must be >= 1")
    return min(1 << nonce_bits, 1 << (cap.bit_length() - 1))


class TilePlan(NamedTuple):
    """One window's rows as host int64 arrays: each row's extranonce
    halves, nonce base, valid count and global offset from the window's
    start. Padding rows have ``valids == 0``."""

    en_hi: np.ndarray
    en_lo: np.ndarray
    bases: np.ndarray
    valids: np.ndarray
    goffs: np.ndarray


def plan_tiles(start: int, n: int, nonce_bits: int, width: int, rows: int,
               hard_end: Optional[int] = None, interleave: int = 1) -> TilePlan:
    """Cut the window ``[start, start + n)``, clamped at ``hard_end``
    (the index domain's end), into at most ``rows`` tiles, padded to
    exactly ``rows``.

    ``interleave=k`` lays the rows out device-major for a window sharded
    over ``k`` ranks: rank ``d``'s contiguous block of ``rows / k`` rows
    holds the global-order rows ``s·k + d``, so a rank's block is one
    row of each stripe ``s`` (``parallel.mesh.rolled_sweep``)."""
    end = start + n - 1
    if hard_end is not None:
        end = min(end, hard_end)
    if interleave < 1 or rows % interleave:
        raise ValueError("rows must be a positive multiple of interleave")
    tiles = list(chain.rolled_tiles(start, end, nonce_bits, width))
    if len(tiles) > rows:
        raise ValueError(
            f"window [{start}, {end}] needs {len(tiles)} rows > {rows}; "
            "width must divide the segment size (tile_width does)"
        )
    plan = np.zeros((5, rows), np.int64)
    for i, (en, base, take, gbase) in enumerate(tiles):
        plan[:, i] = (en >> 32, en & 0xFFFFFFFF, base, take, gbase - start)
    # device-major: new[d·(rows/k) + s] = old[s·k + d]
    perm = np.arange(rows).reshape(rows // interleave, interleave).T.reshape(-1)
    return TilePlan(*plan[:, perm])


def rolled_verifier(req: Request):
    """The host's exact check of a global index: re-roll its header
    (cached per extranonce) and compare the full 256-bit hash with the
    target. ``verify(g) -> (wins, hash)``."""
    cb = chain.CoinbaseTemplate(req.coinbase_prefix, req.coinbase_suffix,
                                req.extranonce_size)

    @functools.lru_cache(maxsize=64)
    def prefix76(en: int) -> bytes:
        return chain.rolled_header(req.header, cb, req.branch, en).pack()[:76]

    def verify(g: int) -> Tuple[bool, int]:
        en, nonce = chain.split_global(g, req.nonce_bits)
        h = chain.hash_to_int(chain.dsha256(prefix76(en) + struct.pack("<I", nonce)))
        return h <= req.target, h

    return verify


def report_search_progress(search: CandidateSearch, fallback_nonce: int,
                           progress: Optional[ProgressFn]) -> None:
    """Report a running global-index search's settled high-water and
    running minimum; nothing while nothing is settled or once the search
    has its outcome (the final Result covers it)."""
    if progress is None or search.outcome is not None:
        return
    hw = search.settled_high_water()
    if hw is None:
        return
    cand = search.best_candidate()
    if cand is None:
        progress(hw, fallback_nonce, MIN_UNTRACKED)
    else:
        progress(hw, cand[1], cand[0])


def _fast_result(req: Request, found, nonce, hash_value, searched, candidates) -> Result:
    if found:
        return Result(req.job_id, req.mode, nonce, hash_value, found=True,
                      searched=searched, chunk_id=req.chunk_id)
    best = min(((h, g) for g, h in candidates), default=None)
    hash_value, nonce = best if best else (MIN_UNTRACKED, req.lower)
    return Result(req.job_id, req.mode, nonce, hash_value, found=False,
                  searched=searched, chunk_id=req.chunk_id)


def fold_rows(handle: torch.Tensor, goffs: torch.Tensor) -> torch.Tensor:
    """A K5 handle ``(B, 2)`` → the window's ``[found, first_global_off]``:
    the lowest ``goffs[r] + first_off[r]`` over rows that hit. A few
    torch ops on the handle's device; nothing waits for it."""
    ok = handle[:, 0] != 0
    g = torch.where(ok, goffs + handle[:, 1], torch.full_like(goffs, _NO_HIT))
    return torch.stack([ok.any().to(torch.int64), g.min()])


def mine_rolled_fast(
    req: Request,
    *,
    slab: int = 1 << 27,
    depth: int = 2,
    roll_batch: int = 8,
    sched_share: bool = True,
    device="cuda",
    progress: Optional[ProgressFn] = None,
) -> Iterator[Optional[Result]]:
    """The rolled candidate search (module docstring): yields ``None``
    after each resolved window, then the Result. ``sched_share`` selects
    K5's shared-schedule arm and rolls each distinct extranonce of a
    window once; ``False`` is the A/B baseline. ``roll_batch=1`` runs
    the per-segment loop on K4."""
    if not req.rolled or req.header is None or req.target is None:
        raise ValueError("mine_rolled_fast needs a rolled targeted request")
    verify = rolled_verifier(req)
    hw1_cap = int(ops.target_to_words(req.target)[1])
    job = merkle.build_roll(req.header, req.coinbase_prefix, req.coinbase_suffix,
                            req.extranonce_size, req.branch)
    if roll_batch <= 1:
        yield from _mine_rolled_fast_segmented(
            req, job, verify, hw1_cap, slab=slab, depth=depth, device=device,
            progress=progress,
        )
        return

    width = tile_width(req.nonce_bits, slab)
    rows = roll_batch + 2
    window = roll_batch * width
    if window >= 1 << 32:
        raise ValueError("roll_batch × width must stay below 2^32")
    hard_end = (1 << span_bits(req)) - 1
    roll = functools.partial(kernels.extranonce_roll, job)
    sweep_rows = (kernels.search_candidates_hdr_batch_sched if sched_share
                  else kernels.search_candidates_hdr_batch)

    def sweep(start: int, n: int) -> torch.Tensor:
        plan = plan_tiles(start, n, req.nonce_bits, width, rows, hard_end)
        if sched_share:
            mids, tails = merkle.roll_batch_deduped(roll, plan.en_hi, plan.en_lo, device)
        else:
            en = merkle.to_device(np.concatenate([plan.en_hi, plan.en_lo]), device)
            mids, tails = roll(en[:rows], en[rows:])
        cols = merkle.to_device(np.concatenate([plan.bases, plan.valids, plan.goffs]),
                                device)
        handle = sweep_rows(mids, tails, cols[:rows], cols[rows:2 * rows], width, hw1_cap)
        return fold_rows(handle, cols[2 * rows:])

    search = CandidateSearch(
        sweep, resolve_handle, verify, req.lower, req.upper,
        slab=window, depth=depth, domain=1 << span_bits(req),
    )
    for _ in search.events():
        report_search_progress(search, req.lower, progress)
        yield None  # heartbeat / Cancel window per resolved window
    out = search.outcome
    yield _fast_result(req, out.found, out.nonce, out.hash_value, out.searched,
                       out.candidates)


def _mine_rolled_fast_segmented(req, job, verify, hw1_cap, *, slab, depth, device,
                                progress=None) -> Iterator[Optional[Result]]:
    """``roll_batch=1``: one roll and one drained ``CandidateSearch`` on
    K4 per extranonce segment (the reference's pre-batching loop)."""
    width = tile_width(req.nonce_bits, slab)
    searched = 0
    candidates = []  # (global index, hash)
    best_hg = None  # (hash, global index) running min over candidates
    for en, base_g, n_lo, n_hi in chain.rolled_segments(req.lower, req.upper,
                                                        req.nonce_bits):
        en_t = merkle.to_device([en >> 32, en & 0xFFFFFFFF], device)
        mids, tails = kernels.extranonce_roll(job, en_t[:1], en_t[1:])

        def sweep(base: int, n: int, _mid=mids[0], _tail=tails[0]) -> torch.Tensor:
            return kernels.search_candidates_hdr(_mid, _tail, base, n, hw1_cap)

        def seg_verify(nonce: int, _base_g=base_g) -> Tuple[bool, int]:
            return verify(_base_g | nonce)

        search = CandidateSearch(sweep, resolve_handle, seg_verify, n_lo, n_hi,
                                 slab=width, depth=depth)
        for _ in search.events():
            if progress is not None and search.outcome is None:
                local = search.settled_high_water()
                if local is not None:
                    hw = base_g | local
                elif base_g > req.lower:
                    hw = base_g - 1  # earlier segments are settled
                else:
                    hw = None
                if hw is not None:
                    seg_best = search.best_candidate()
                    pool = [b for b in (best_hg, seg_best and (
                        seg_best[0], base_g | seg_best[1])) if b]
                    bh, bg = min(pool) if pool else (MIN_UNTRACKED, req.lower)
                    progress(hw, bg, bh)
            yield None
        out = search.outcome
        searched += out.searched
        candidates += [(base_g | n, h) for n, h in out.candidates]
        best_hg = min(((h, g) for g, h in candidates), default=None)
        if out.found:
            yield _fast_result(req, True, base_g | out.nonce, out.hash_value, searched,
                               candidates)
            return
    yield _fast_result(req, False, None, None, searched, candidates)


def mine_rolled_tracking(
    req: Request,
    mine_segment: Callable[[Request], Iterator[Optional[Result]]],
    progress: Optional[ProgressFn] = None,
) -> Iterator[Optional[Result]]:
    """Exact rolled search (the CPU miner's first winner and exhausted
    minimum), for targets where the candidate test does not apply: each
    extranonce segment's header is built on the host and handed, as a
    fixed-header TARGET request over its nonces, to ``mine_segment``
    (the miner's tracking path on K2). Yields ``None`` between sweeps,
    then the Result over global indices."""
    if not req.rolled or req.target is None:
        raise ValueError("mine_rolled_tracking needs a rolled targeted request")
    cb = chain.CoinbaseTemplate(req.coinbase_prefix, req.coinbase_suffix,
                                req.extranonce_size)
    best: Optional[Tuple[int, int]] = None  # (hash, global index)
    searched = 0
    for en, base_g, n_lo, n_hi in chain.rolled_segments(req.lower, req.upper,
                                                        req.nonce_bits):
        hdr = chain.rolled_header(req.header, cb, req.branch, en)
        sub = Request(job_id=req.job_id, mode=PowMode.TARGET, lower=n_lo, upper=n_hi,
                      header=hdr.pack(), target=req.target, chunk_id=req.chunk_id)
        seg_result: Optional[Result] = None
        for item in mine_segment(sub):
            if item is None:
                yield None
            else:
                seg_result = item
        g = base_g | seg_result.nonce
        if seg_result.found:
            yield Result(req.job_id, req.mode, g, seg_result.hash_value, found=True,
                         searched=searched + seg_result.searched, chunk_id=req.chunk_id)
            return
        searched += seg_result.searched
        cand = (seg_result.hash_value, g)
        if best is None or cand < best:
            best = cand
        if progress is not None and (base_g | n_hi) < req.upper:
            progress(base_g | n_hi, best[1], best[0])
    yield Result(req.job_id, req.mode, best[1], best[0], found=best[0] <= req.target,
                 searched=searched, chunk_id=req.chunk_id)
