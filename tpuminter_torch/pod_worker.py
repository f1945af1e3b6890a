"""PodMiner: one worker that mines on every card of a pod, one process a
card.

Counterpart of ``tpuminter.pod_worker`` (``PodMiner``,
``follower_loop``), backend ``"pod"``. The role layer cannot tell a
PodMiner from a ``CudaMiner``: the same generator contract, the same
Join, Request and Result; only the ``lanes`` hint, scaled by the ranks,
tells the coordinator to carve pod-sized chunks. Every rank runs the
same generator on the same request, its sweeps (``parallel.mesh``) on
its own card, and their collectives give every rank the same answers,
so every rank takes the same steps and ends with the same Result.

Dialect routing, the reference's:

- **TARGET** at real difficulty: ``search.CandidateSearch`` over pod
  spans of ``world × n_slabs × slab_per_device`` nonces, each swept by
  ``mesh.candidate_sweep`` (3h on every rank, striped, with the early
  exit). Rolled jobs sweep windows of ``roll_batch`` rows through
  ``mesh.rolled_sweep`` (R and K5 on every rank's rows);
  ``roll_batch=1`` runs one ``CandidateSearch`` an extranonce segment
  over ``mesh.candidate_sweep`` on K4. The host verifies candidates.
- **exact_min** (not rolled): ``mesh.exact_sweep`` (``2h``) over full
  spans of ``world × slab_per_device``, ``depth`` in flight; the ragged
  tail on the rank's own card (``CudaMiner``'s tracking path).
- **MIN**: ``mesh.min_sweep`` (``6t``) the same way, the tail through
  ``CudaMiner``'s MIN path.
- **SCRYPT**: ``mesh.scrypt_sweep`` (S1, 19, S2) on a batch a rank,
  segment by segment for a rolled job, the tail through ``CudaMiner``'s
  SCRYPT path on the same V.
- **Toy-easy targets** (2^224 and up) go to the rank's ``CudaMiner``:
  the candidate test does not apply there and a winner lands every few
  thousand nonces.

Exhausted TARGET chunks report the range minimum only when a candidate
surfaced (``protocol.MIN_UNTRACKED`` otherwise), as ``CudaMiner`` does.

A candidate sweep reads the found flag on the host after each stripe,
so it has returned by the time its handle is looked at: the candidate
searches run one sweep at a time (a second sweep in flight would only be
swept before the first is read). ``depth`` keeps fold-sweep spans in
flight, which on NCCL overlap. The reference clamped ``depth`` to 1 on
gloo, where two XLA programs in flight cross-matched their collectives;
here every collective is issued eagerly, in program order, from the one
thread that steps the generator, on groups of their own, so no clamp is
needed.

**The replay.** Only the leader (rank 0) speaks to the coordinator. With
``spmd_leader`` it broadcasts each request and a flag before every step
of the generator over the pod's control channel; :func:`follower_loop`
replays them on the other ranks. Workload chunks never reach the miner:
the worker computes them on the leader's card alone.
"""

from __future__ import annotations

import struct
from dataclasses import replace as dc_replace
from typing import Iterator, Optional, Tuple

import torch

from tpuminter_torch import chain, kernels, rolled
from tpuminter_torch.cuda_worker import (
    DEFAULT_SCRYPT_BATCH,
    SCRYPT_N_LOG2,
    CudaMiner,
    _fast_path_ok,
    _words_value,
    make_header_search,
)
from tpuminter_torch.ops import merkle
from tpuminter_torch.ops import scrypt as scrypt_ops
from tpuminter_torch.ops import sha256 as ops
from tpuminter_torch.parallel import mesh
from tpuminter_torch.parallel.distributed import Pod, rank_device
from tpuminter_torch.protocol import (
    MIN_UNTRACKED,
    PowMode,
    Request,
    Result,
    decode_msg,
    encode_msg,
)
from tpuminter_torch.search import CandidateSearch, pipeline_spans, resolve_handle
from tpuminter_torch.worker import Miner

__all__ = ["PodMiner", "follower_loop", "DEFAULT_SLAB_PER_DEVICE", "DEFAULT_N_SLABS"]

#: nonces a rank sweeps a stripe and stripes a pod span, the reference's
#: defaults: a stripe is 17.8 ms of 3h (PERF.md, one rank on an NVIDIA
#: H100 80GB HBM3 at its 700 W limit)
DEFAULT_SLAB_PER_DEVICE = 1 << 27
DEFAULT_N_SLABS = 4


def follower_loop(miner: "PodMiner") -> None:
    """A follower rank's main: replay the leader's chunks without touching
    the control plane. Each broadcast request is mined with the generator
    the leader runs; a 0 step flag means the leader abandoned the chunk
    (a Cancel). Returns on the empty request, the leader's
    :meth:`PodMiner.close`."""
    pod = miner.pod
    while True:
        raw = pod.broadcast_bytes()
        if not raw:
            return
        inner = miner._mine_impl(decode_msg(raw))
        while True:
            if pod.broadcast_flag() == 0:
                inner.close()
                break
            try:
                next(inner)
            except StopIteration:
                break


class PodMiner(Miner):
    """Pod-wide miner behind the standard worker interface. ``pod`` is this
    process's rank (``parallel.distributed.init_from_env``); without one,
    the miner is a pod of one process on ``device``."""

    backend = "pod"
    #: scrypt's N as a log2, as ``CudaMiner.scrypt_n_log2``
    scrypt_n_log2 = SCRYPT_N_LOG2

    def __init__(
        self,
        slab_per_device: int = DEFAULT_SLAB_PER_DEVICE,
        n_slabs: int = DEFAULT_N_SLABS,
        depth: int = 2,
        exact_min: bool = False,
        spmd_leader: bool = False,
        scrypt_batch: Optional[int] = None,
        roll_batch: int = 8,
        device="cuda",
        pod: Optional[Pod] = None,
    ):
        if pod is None:
            pod = Pod(0, 1, rank_device(0, device))
        self.pod = pod
        self.device = pod.device
        if not 1 <= slab_per_device <= 1 << 30:
            raise ValueError("slab_per_device must be in [1, 2^30]")
        if n_slabs < 1 or depth < 1 or roll_batch < 1:
            raise ValueError("n_slabs, depth and roll_batch must be >= 1")
        self.slab_per_device = slab_per_device
        self.n_slabs = n_slabs
        self.pod_span = pod.world * n_slabs * slab_per_device
        if self.pod_span > 1 << 32:
            raise ValueError("pod span exceeds the 32-bit nonce space; shrink "
                             "slab_per_device or n_slabs")
        self.depth = depth
        self.exact_min = exact_min
        self.spmd_leader = spmd_leader
        self.roll_batch = roll_batch
        if scrypt_batch is None:
            scrypt_batch = DEFAULT_SCRYPT_BATCH[self.device.type]
        self.scrypt_batch = scrypt_batch
        # scheduler hint: the ranks' throughput, at least a lane a rank
        self.lanes = max(pod.world, pod.world * (slab_per_device * 4) // 16_384)
        self.span = self.pod_span
        #: the rank's own card, for what runs on one card: the self-check,
        #: toy-easy targets and the ragged tails (its SCRYPT V is the pod's)
        self._card = CudaMiner(slab=slab_per_device, depth=depth, device=self.device,
                               roll_batch=roll_batch, scrypt_batch=scrypt_batch)
        self._open_inner = None  # the leader's chunk generator in progress

    def unsupported(self, request: Request) -> Optional[str]:
        return self._card.unsupported(request)

    # -- Miner interface ---------------------------------------------------

    def mine(self, request: Request) -> Iterator[Optional[Result]]:
        if self.spmd_leader:
            yield from self._spmd_mine(request)
        else:
            yield from self._mine_impl(request)

    def _mine_impl(self, request: Request) -> Iterator[Optional[Result]]:
        if request.workload:
            raise NotImplementedError("workload chunks are computed by workloads.compute")
        self._card._self_check()
        if request.mode == PowMode.MIN:
            yield from self._mine_min(request)
        elif request.mode == PowMode.SCRYPT:
            yield from self._mine_scrypt(request)
        elif self.exact_min and not request.rolled:
            yield from self._mine_target_exact(request)
        elif not _fast_path_ok(request.target):
            yield from self._card.mine(request)
        elif request.rolled:
            yield from self._mine_rolled(request)
        else:
            yield from self._mine_target(request)

    # -- the SPMD replay (leader side) ---------------------------------------

    def _spmd_sync_abandoned(self) -> None:
        """If the previous chunk's generator was abandoned (a Cancel), the
        followers still wait for its next step flag: release them before
        anything else is broadcast."""
        if self._open_inner is not None:
            inner, self._open_inner = self._open_inner, None
            self.pod.broadcast_flag(0)
            inner.close()

    def _spmd_mine(self, request: Request) -> Iterator[Optional[Result]]:
        """Broadcast the request, then a flag before every step of the
        generator, so the followers replay the same steps; the generator
        is deterministic given the request, so every rank stops on the
        same step, and flags exist for abandonment alone."""
        self._spmd_sync_abandoned()
        inner = self._mine_impl(request)
        self._open_inner = inner
        self.pod.broadcast_bytes(encode_msg(request))
        try:
            while True:
                self.pod.broadcast_flag(1)
                try:
                    item = next(inner)
                except StopIteration:
                    self._open_inner = None
                    return
                yield item
        except GeneratorExit:
            # no broadcast here: an abandoned generator is closed by the
            # garbage collector, possibly on the event loop's thread, where
            # a blocking collective would stall the LSP heartbeats. The
            # release flag goes out on the steps' thread, at the next
            # mine() or at close().
            inner.close()
            raise

    def close(self) -> None:
        """Leader shutdown: release a follower in mid-chunk, then send the
        empty request, which ends :func:`follower_loop`."""
        if self.spmd_leader:
            self._spmd_sync_abandoned()
            self.pod.broadcast_bytes(b"")

    # -- TARGET: the pod candidate search ------------------------------------

    def _pod_search(self, lower: int, upper: int, slab_fn, verify) -> CandidateSearch:
        """One (range, slab kernel, verifier) as a ``CandidateSearch`` over
        pod spans; each span is a striped ``mesh.candidate_sweep``, whose
        lowest-candidate answer is what the search needs."""

        def sweep(base: int, n: int) -> torch.Tensor:
            found, off, _ = mesh.candidate_sweep(self.pod, slab_fn, base, n,
                                                 slab=self.slab_per_device,
                                                 n_slabs=self.n_slabs)
            return torch.tensor([int(found), off])

        return CandidateSearch(sweep, resolve_handle, verify, lower, upper,
                               slab=self.pod_span, depth=1)

    def _mine_target(self, req: Request) -> Iterator[Optional[Result]]:
        slab_fn, _, verify = make_header_search(req.header, req.target, self.device)
        search = self._pod_search(req.lower, req.upper, slab_fn, verify)
        for _ in search.events():
            yield None
        yield self._fast_result(req, search)

    @staticmethod
    def _fast_result(req: Request, search: CandidateSearch) -> Result:
        out = search.outcome
        return rolled._fast_result(req, out.found, out.nonce, out.hash_value, out.searched,
                                   out.candidates)

    # -- TARGET + extranonce rolling ------------------------------------------

    def _mine_rolled(self, req: Request) -> Iterator[Optional[Result]]:
        """One ``CandidateSearch`` over global indices whose sweeps are
        rolled windows of ``rows - 2`` rows of ``width`` nonces, ``rows``
        the least multiple of the ranks at or above ``roll_batch + 2``
        (two spare rows for a window cut by extranonce boundaries), laid
        out device-major and swept by ``mesh.rolled_sweep``."""
        if self.roll_batch <= 1:
            yield from self._mine_rolled_segmented(req)
            return
        world = self.pod.world
        width = rolled.tile_width(req.nonce_bits, self.slab_per_device)
        rows = -(-(self.roll_batch + 2) // world) * world
        window = (rows - 2) * width
        if window >= 1 << 32:
            raise ValueError("the rolled window (rows × width) must stay below 2^32; "
                             "shrink roll_batch or slab_per_device")
        job = merkle.build_roll(req.header, req.coinbase_prefix, req.coinbase_suffix,
                                req.extranonce_size, req.branch)
        hw1_cap = int(ops.target_to_words(req.target)[1])
        hard_end = (1 << rolled.span_bits(req)) - 1

        def sweep(start: int, n: int) -> torch.Tensor:
            plan = rolled.plan_tiles(start, n, req.nonce_bits, width, rows, hard_end,
                                     interleave=world)
            found, first = mesh.rolled_sweep(self.pod, plan, job, width, hw1_cap)
            return torch.tensor([int(found), first])

        search = CandidateSearch(sweep, resolve_handle, rolled.rolled_verifier(req),
                                 req.lower, req.upper, slab=window, depth=1,
                                 domain=1 << rolled.span_bits(req))
        for _ in search.events():
            rolled.report_search_progress(search, req.lower, self.progress_cb)
            yield None
        yield self._fast_result(req, search)

    def _mine_rolled_segmented(self, req: Request) -> Iterator[Optional[Result]]:
        """``roll_batch=1``: per extranonce segment, one roll (R) on every
        rank and one drained pod ``CandidateSearch`` on K4."""
        job = merkle.build_roll(req.header, req.coinbase_prefix, req.coinbase_suffix,
                                req.extranonce_size, req.branch)
        hw1_cap = int(ops.target_to_words(req.target)[1])
        verify_g = rolled.rolled_verifier(req)
        searched = 0
        candidates = []  # (global index, hash)
        for en, base_g, n_lo, n_hi in chain.rolled_segments(req.lower, req.upper,
                                                            req.nonce_bits):
            en_t = merkle.to_device([en >> 32, en & 0xFFFFFFFF], self.device)
            mids, tails = kernels.extranonce_roll(job, en_t[:1], en_t[1:])

            def slab_fn(base: int, n: int, _mid=mids[0], _tail=tails[0]) -> torch.Tensor:
                return kernels.search_candidates_hdr(_mid, _tail, base, n, hw1_cap)

            def verify(nonce: int, _base_g=base_g) -> Tuple[bool, int]:
                return verify_g(_base_g | nonce)

            search = self._pod_search(n_lo, n_hi, slab_fn, verify)
            for _ in search.events():
                yield None
            out = search.outcome
            candidates += [(base_g | n, h) for n, h in out.candidates]
            if out.found:
                yield rolled._fast_result(req, True, base_g | out.nonce, out.hash_value,
                                          searched + out.searched, candidates)
                return
            searched += out.searched
            if self.progress_cb is not None and (base_g | n_hi) < req.upper:
                # segment granularity: everything to this segment's end is
                # settled with no winner
                bh, bg = min(((h, g) for g, h in candidates),
                             default=(MIN_UNTRACKED, req.lower))
                self.progress_cb(base_g | n_hi, bg, bh)
        yield rolled._fast_result(req, False, None, None, searched, candidates)

    # -- TARGET with the exact minimum (exact_min) ------------------------------

    def _mine_target_exact(self, req: Request) -> Iterator[Optional[Result]]:
        """Full digests on every rank (no candidate shortcut), the pod's
        lowest winner a span and the exact minimum of an exhausted range:
        the CPU miner's Results. Spans resolve in order, so a winner in
        span *i* is reported before span *i + 1* is looked at."""
        template = ops.header_template(req.header)
        tw = [int(t) for t in ops.target_to_words(req.target)]
        span = self.pod.world * self.slab_per_device
        n_full = (req.upper - req.lower + 1) // span
        starts = (req.lower + i * span for i in range(n_full))
        best: Optional[Tuple[int, int]] = None  # (hash, nonce)
        searched = 0
        for start, handle in pipeline_spans(
                starts, lambda s: mesh.exact_sweep(self.pod, template, tw, s,
                                                   slab=self.slab_per_device),
                depth=self.depth):
            row = handle.read()  # [found, win_off, min_words×8, min_off]
            if row[0]:
                nonce = start + row[1]
                h = chain.hash_to_int(chain.dsha256(req.header[:76] + struct.pack("<I", nonce)))
                yield Result(req.job_id, req.mode, nonce, h, found=True,
                             searched=searched + row[1] + 1, chunk_id=req.chunk_id)
                return
            cand = (_words_value(row[2:10]), start + row[10])
            if best is None or cand < best:
                best = cand
            searched += span
            yield None
        tail_lo = req.lower + n_full * span
        if tail_lo <= req.upper:  # the ragged tail, on the rank's own card
            tail = yield from self._on_card(
                self._card._mine_target_tracking(dc_replace(req, lower=tail_lo)))
            if tail.found:
                yield Result(req.job_id, req.mode, tail.nonce, tail.hash_value, found=True,
                             searched=searched + tail.searched, chunk_id=req.chunk_id)
                return
            searched += tail.searched
            cand = (tail.hash_value, tail.nonce)
            best = cand if best is None else min(best, cand)
        yield Result(req.job_id, req.mode, best[1], best[0], found=False,
                     searched=searched, chunk_id=req.chunk_id)

    @staticmethod
    def _on_card(steps: Iterator[Optional[Result]]):
        """Pass a ``CudaMiner`` path's steps on; return its Result."""
        result = None
        for item in steps:
            if item is None:
                yield None
            else:
                result = item
        return result

    # -- MIN (toy) dialect --------------------------------------------------------

    def _mine_min(self, req: Request) -> Iterator[Optional[Result]]:
        """``mesh.min_sweep`` over full spans, ``depth`` in flight; the
        ragged tail through ``CudaMiner``'s MIN path on the rank's card."""
        template = ops.toy_template(req.data)
        span = self.pod.world * self.slab_per_device
        n_full = (req.upper - req.lower + 1) // span
        starts = (req.lower + i * span for i in range(n_full))
        best: Optional[Tuple[int, int]] = None  # (hash, nonce)
        for start, handle in pipeline_spans(
                starts, lambda s: mesh.min_sweep(self.pod, template, s,
                                                 slab=self.slab_per_device),
                depth=self.depth):
            fold_hi, fold_lo, off = handle.read()
            cand = ((fold_hi << 32) | fold_lo, start + off)
            if best is None or cand < best:
                best = cand
            yield None
        tail_lo = req.lower + n_full * span
        if tail_lo <= req.upper:
            tail = yield from self._on_card(self._card._mine_min(dc_replace(req, lower=tail_lo)))
            cand = (tail.hash_value, tail.nonce)
            best = cand if best is None else min(best, cand)
        yield Result(req.job_id, req.mode, best[1], best[0], found=True,
                     searched=req.upper - req.lower + 1, chunk_id=req.chunk_id)

    # -- SCRYPT ------------------------------------------------------------------

    def _mine_scrypt(self, req: Request) -> Iterator[Optional[Result]]:
        """Each segment (the whole range, or an extranonce's for a rolled
        job) in full spans of a batch a rank through
        ``mesh.scrypt_sweep``, ``depth`` in flight; its ragged tail
        through ``CudaMiner``'s SCRYPT path on the same V."""
        card = self._card
        card.scrypt_n_log2 = self.scrypt_n_log2
        v = card._scrypt_scratch()
        tw = [int(w) for w in ops.target_to_words(req.target)]
        batch = self.scrypt_batch
        span = self.pod.world * batch
        best: Optional[Tuple[int, int]] = None  # (hash, global index)
        searched = 0
        for hdr76, base_g, lo, hi in card._scrypt_segments(req):
            words = scrypt_ops.header_to_words(hdr76)
            n_full = (hi - lo + 1) // span
            starts = (lo + i * span for i in range(n_full))
            for start, handle in pipeline_spans(
                    starts, lambda s, _w=words: mesh.scrypt_sweep(
                        self.pod, _w, s, tw, v, batch=batch, n_log2=self.scrypt_n_log2),
                    depth=self.depth):
                row = handle.read()  # [found, win_off, win_words×8, min_words×8, min_off]
                if row[0]:
                    yield Result(req.job_id, req.mode, base_g | (start + row[1]),
                                 _words_value(row[2:10]), found=True,
                                 searched=searched + row[1] + 1, chunk_id=req.chunk_id)
                    return
                cand = (_words_value(row[10:18]), base_g | (start + row[18]))
                if best is None or cand < best:
                    best = cand
                searched += span
                yield None
            tail_lo = lo + n_full * span
            if tail_lo <= hi:
                sub = Request(req.job_id, req.mode, tail_lo, hi, header=hdr76 + bytes(4),
                              target=req.target, chunk_id=req.chunk_id)
                tail = yield from self._on_card(card._mine_scrypt(sub))
                searched += tail.searched
                if tail.found:
                    yield Result(req.job_id, req.mode, base_g | tail.nonce, tail.hash_value,
                                 found=True, searched=searched, chunk_id=req.chunk_id)
                    return
                cand = (tail.hash_value, base_g | tail.nonce)
                if best is None or cand < best:
                    best = cand
        yield Result(req.job_id, req.mode, best[1], best[0], found=best[0] <= req.target,
                     searched=searched, chunk_id=req.chunk_id)
