"""CudaMiner: the worker backend that mines on the hand-written kernels.

Counterpart of ``tpuminter.tpu_worker`` (``TpuMiner``,
``make_header_search``), backend ``"cuda"``. Same dispatch rule:

- **TARGET at real difficulty** (target < 2^224) runs the candidate
  pipeline (``tpuminter_torch.search``): the card sweeps slabs for
  nonces whose top 32 hash bits are zero, ``depth`` launches in flight,
  and the host verifies the rare candidates exactly.
- **TARGET at toy-easy targets, or with ``exact_min``** runs the
  tracking kernel, which compares the full hash and folds the exact
  minimum (K2's header arm: a header's template always has its shape).
- **MIN** runs the toy-dialect fold kernel, ``depth`` launches in flight
  (K6's toy arm: ``data ‖ nonce_be8`` always has its shape).
- **Rolled TARGET** (extranonce jobs, ``tpuminter_torch.rolled``) at
  real difficulty runs ``rolled.mine_rolled_fast``: the roll kernel
  feeds the batched dynamic-header candidate kernel, ``roll_batch`` rows
  per launch (``roll_batch=1``: one segment at a time on K4); at
  toy-easy targets it runs ``rolled.mine_rolled_tracking``, each
  segment's header built on the host and swept by the tracking kernel.
  ``exact_min`` does not apply to rolled jobs, as in the reference.

The fast path does not track the 256-bit minimum, so an exhausted
TARGET chunk reports the exact range minimum only when the range held a
candidate (their min is then the range min: any hash with a nonzero top
word loses to every candidate); otherwise it reports
``protocol.MIN_UNTRACKED`` with ``found=False``. Construct with
``exact_min=True`` to match the CPU miner's exhausted-min output.

- **SCRYPT** (plain or rolled; counterpart of ``JaxMiner._mine_scrypt``)
  runs batches of ``scrypt_batch`` nonces through three kernels, S1
  (PBKDF2-in and the ROMix fill), 19 (the walk) and S2 (PBKDF2-out and
  the batch fold), ``depth`` batches in flight, on one V scratch the
  miner keeps; a rolled job's headers are rolled on the host, one per
  extranonce segment. Its Results equal the reference's: the first
  winner with ``searched`` up to it, or the exact range minimum of an
  exhausted chunk. The mode is routed before ``rolled``: a rolled SCRYPT
  chunk is scrypt, not double SHA.

Workload chunks are computed by ``tpuminter_torch.workloads`` on the
miner's ``device``, not mined here. ``device="cpu"`` runs the same miner
on the kernels' plain versions; a CUDA device that torch cannot see
raises.
"""

from __future__ import annotations

import struct
from typing import Iterator, Optional, Tuple

import torch

from tpuminter_torch import chain, kernels, rolled, workloads
from tpuminter_torch.ops import scrypt as scrypt_ops
from tpuminter_torch.ops import sha256 as ops
from tpuminter_torch.protocol import MIN_UNTRACKED, PowMode, Request, Result
from tpuminter_torch.search import CandidateSearch, Handle, pipeline_spans, resolve_handle
from tpuminter_torch.worker import Miner

__all__ = ["CudaMiner", "make_header_search", "DEFAULT_SLAB", "DEFAULT_DEPTH",
           "DEFAULT_SCRYPT_BATCH", "SCRYPT_N_LOG2"]

#: nonces per kernel launch; a Cancel lands within about two slabs
DEFAULT_SLAB = 1 << 27

#: kernel launches kept in flight
DEFAULT_DEPTH = 2

#: nonces per SCRYPT batch, by device type. On the card V takes a batch ×
#: 128 KiB at N = 1024 (8 GiB at 2^16). chip_smoke.py's coordinator-size
#: chunk (65,536 nonces, one batch at 2^16) at batches 2^14 to 2^16 read
#: 2^16 fastest on an H100 in each of three runs, by more than 2^15's
#: spread across them: the walk's occupancy lets a wider batch keep more
#: rows in flight, which outweighs the overlap two batches a chunk gave.
#: The CPU's plain versions hold V in int64 lanes, twice the bytes, and
#: gain nothing from a wide batch.
DEFAULT_SCRYPT_BATCH = {"cuda": 1 << 16, "cpu": 256}

#: log2 of scrypt's N: Litecoin's N = 1024, the reference's ``n_log2``
SCRYPT_N_LOG2 = 10

#: nonces of the genesis header hashed by the first-use self-check
_SELF_CHECK_NONCES = 8


def make_header_search(header80: bytes, target: int, device):
    """The sweep/resolve/verify triple of a header-mining job:
    ``sweep(base, n)`` launches the candidate kernel with the target's
    hash word 1 as its cap (candidates are then true wins up to a ~2^-64
    tail), ``resolve`` reads a handle, ``verify(nonce)`` re-hashes on
    the host and applies the exact 256-bit compare."""
    template = ops.header_template(header80)
    header76 = header80[:76]
    hw1_cap = int(ops.target_to_words(target)[1])

    def sweep(base: int, n: int) -> torch.Tensor:
        return kernels.search_candidates(template, base, n, hw1_cap, device=device)

    def verify(nonce: int) -> Tuple[bool, int]:
        h = chain.hash_to_int(chain.dsha256(header76 + struct.pack("<I", nonce)))
        return h <= target, h

    return sweep, resolve_handle, verify


def _fast_path_ok(target: Optional[int]) -> bool:
    """The candidate test (top 32 hash bits zero) is necessary only when
    the target's top word is zero: every real Bitcoin difficulty. Toy
    targets above 2^224 take the tracking kernel."""
    return target is not None and target < 1 << 224


class CudaMiner(Miner):
    """Kernel-backed miner behind the standard worker interface."""

    backend = "cuda"
    #: scrypt's N as a log2 (the wire carries no N: every SCRYPT job is
    #: Litecoin's 1024; tests set a smaller one on an instance)
    scrypt_n_log2 = SCRYPT_N_LOG2

    def __init__(
        self,
        slab: int = DEFAULT_SLAB,
        depth: int = DEFAULT_DEPTH,
        exact_min: bool = False,
        device="cuda",
        roll_batch: int = 8,
        sched_share: bool = True,
        scrypt_batch: Optional[int] = None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CudaMiner needs a CUDA device and torch sees none; "
                    "device='cpu' runs the kernels' plain versions"
                )
        elif self.device.type != "cpu":
            raise ValueError(f"device must be cuda or cpu, got {self.device}")
        if not 1 <= slab <= 1 << 30:
            raise ValueError("slab must be in [1, 2^30]")
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if roll_batch < 1:
            raise ValueError("roll_batch must be >= 1")
        if scrypt_batch is None:
            scrypt_batch = DEFAULT_SCRYPT_BATCH[self.device.type]
        if not 1 <= scrypt_batch <= 1 << 20:
            raise ValueError("scrypt_batch must be in [1, 2^20]")
        self.slab = slab
        self.depth = depth
        self.exact_min = exact_min
        #: extranonce rows per rolled launch; 1 = one segment at a time (K4)
        self.roll_batch = roll_batch
        #: K5's shared-schedule arm and one roll per distinct extranonce
        self.sched_share = sched_share
        #: nonces per SCRYPT batch (the reference's ``JaxMiner(scrypt_batch=)``)
        self.scrypt_batch = scrypt_batch
        #: the SCRYPT path's ROMix scratch, allocated at its first batch and
        #: kept for every batch and chunk after it
        self._scrypt_v: Optional[torch.Tensor] = None
        # scheduler hints: ask for chunks a few slabs deep
        self.lanes = max(1, (slab * 4) // 16_384)
        self.span = slab
        self._checked = False

    def unsupported(self, request: Request) -> Optional[str]:
        if request.workload:
            if workloads.maybe(request.workload) is None:
                return f"workload {request.workload!r} is not served by this worker"
        return None

    def mine(self, request: Request) -> Iterator[Optional[Result]]:
        reason = self.unsupported(request)
        if reason is not None:
            raise NotImplementedError(reason)
        if request.workload:
            raise NotImplementedError("workload chunks are computed by workloads.compute")
        self._self_check()
        if request.mode == PowMode.MIN:
            yield from self._mine_min(request)
        elif request.mode == PowMode.SCRYPT:  # before rolled: a rolled SCRYPT job is scrypt
            yield from self._mine_scrypt(request)
        elif request.rolled:
            if _fast_path_ok(request.target):
                yield from rolled.mine_rolled_fast(
                    request, slab=self.slab, depth=self.depth,
                    roll_batch=self.roll_batch, sched_share=self.sched_share,
                    device=self.device, progress=self.progress_cb,
                )
            else:
                yield from rolled.mine_rolled_tracking(
                    request, self._mine_target_tracking, progress=self.progress_cb,
                )
        elif self.exact_min or not _fast_path_ok(request.target):
            yield from self._mine_target_tracking(request)
        else:
            yield from self._mine_target_fast(request)

    def _self_check(self) -> None:
        """Known-answer test at first use: the kernels are built on this
        machine at first use, so before mining, the digest kernel hashes
        a few genesis-header nonces and must agree with hashlib."""
        if self._checked:
            return
        header = chain.GENESIS_HEADER
        nonces = range(header.nonce, header.nonce + _SELF_CHECK_NONCES)
        lo = torch.tensor(list(nonces), dtype=torch.int64, device=self.device)
        got = kernels.sha256_batch(
            ops.header_template(header.pack()), torch.zeros_like(lo), lo
        ).cpu().tolist()
        for nonce, words in zip(nonces, got):
            want = struct.unpack(">8I", header.with_nonce(nonce).block_hash())
            if tuple(words) != want:
                raise RuntimeError(
                    f"kernel self-check failed on {self.device} at nonce {nonce}"
                )
        self._checked = True

    def _slabs(self, lower: int, upper: int):
        start = lower
        while start <= upper:
            take = min(self.slab, upper - start + 1)
            yield start, take
            start += take

    # -- TARGET: candidate pipeline (production path) ---------------------

    def _mine_target_fast(self, req: Request) -> Iterator[Optional[Result]]:
        sweep, resolve, verify = make_header_search(req.header, req.target, self.device)
        search = CandidateSearch(
            sweep, resolve, verify, req.lower, req.upper,
            slab=self.slab, depth=self.depth,
        )
        for _ in search.events():
            yield None  # heartbeat / Cancel window per resolved slab
        out = search.outcome
        if out.found:
            yield Result(
                req.job_id, req.mode, out.nonce, out.hash_value,
                found=True, searched=out.searched, chunk_id=req.chunk_id,
            )
            return
        best = out.best  # exact range min iff any candidate surfaced
        hash_value, nonce = best if best else (MIN_UNTRACKED, req.lower)
        yield Result(
            req.job_id, req.mode, nonce, hash_value, found=False,
            searched=out.searched, chunk_id=req.chunk_id,
        )

    # -- TARGET: exact-min tracking kernel ---------------------------------

    def _mine_target_tracking(self, req: Request) -> Iterator[Optional[Result]]:
        template = ops.header_template(req.header)
        target_words = [int(t) for t in ops.target_to_words(req.target)]
        best: Optional[Tuple[int, int]] = None  # (hash, nonce)
        searched = 0
        for start, take in self._slabs(req.lower, req.upper):
            row = kernels.search_target(
                template, target_words, start, take, device=self.device
            ).cpu().tolist()
            found, first, min_words, min_off = row[0], row[1], row[2:10], row[10]
            if found:
                nonce = start + first
                # the handle's min is the slab minimum, not the first hit:
                # re-hash the winner on the host (one nonce)
                h = chain.hash_to_int(
                    chain.dsha256(req.header[:76] + struct.pack("<I", nonce))
                )
                yield Result(
                    req.job_id, req.mode, nonce, h, found=True,
                    searched=searched + first + 1, chunk_id=req.chunk_id,
                )
                return
            cand = (_words_value(min_words), start + min_off)
            if best is None or cand < best:
                best = cand
            searched += take
            yield None
        yield Result(
            req.job_id, req.mode, best[1], best[0], found=best[0] <= req.target,
            searched=searched, chunk_id=req.chunk_id,
        )

    # -- MIN (toy) dialect --------------------------------------------------

    def _mine_min(self, req: Request) -> Iterator[Optional[Result]]:
        template = ops.toy_template(req.data)

        def dispatch(span):
            start, take = span
            return kernels.min_toy(
                template, start >> 32, start & 0xFFFFFFFF, take, device=self.device
            )

        best: Optional[Tuple[int, int]] = None
        for (start, _), handle in pipeline_spans(
            self._slabs(req.lower, req.upper), dispatch, depth=self.depth
        ):
            fold_hi, fold_lo, off = handle.cpu().tolist()
            cand = ((fold_hi << 32) | fold_lo, start + off)
            if best is None or cand < best:
                best = cand
            yield None
        yield Result(
            req.job_id, req.mode, best[1], best[0], found=True,
            searched=req.upper - req.lower + 1, chunk_id=req.chunk_id,
        )

    # -- SCRYPT (memory-hard) dialect ---------------------------------------

    def _scrypt_segments(self, req: Request):
        """``(header76, global_base, lo, hi)`` per constant-header span of
        the request: the whole range for a plain job, one span per
        extranonce for a rolled one, its header rolled on the host (at
        scrypt's rates one roll per segment is noise)."""
        if not req.rolled:
            yield req.header[:76], 0, req.lower, req.upper
            return
        cb = chain.CoinbaseTemplate(req.coinbase_prefix, req.coinbase_suffix,
                                    req.extranonce_size)
        for en, base_g, n_lo, n_hi in chain.rolled_segments(req.lower, req.upper,
                                                            req.nonce_bits):
            hdr76 = chain.rolled_header(req.header, cb, req.branch, en).pack()[:76]
            yield hdr76, base_g, n_lo, n_hi

    def _scrypt_scratch(self) -> torch.Tensor:
        """V for a full batch at this miner's N."""
        shape = (1 << self.scrypt_n_log2, self.scrypt_batch)
        if self._scrypt_v is None or tuple(self._scrypt_v.shape[:2]) != shape:
            self._scrypt_v = None  # free the old V before allocating the new
            self._scrypt_v = kernels.romix_scratch(self.scrypt_n_log2, self.scrypt_batch,
                                                   self.device)
        return self._scrypt_v

    def _mine_scrypt(self, req: Request) -> Iterator[Optional[Result]]:
        """Batches of ``scrypt_batch`` nonces, each S1 → 19 → S2 with its
        header words as run-time values, ``depth`` batches in flight
        across segment boundaries (the one V is safe to reuse: the
        stream runs a batch's fill only after the batch before it has
        walked). Batches resolve in order, so the first winner is the
        range's; a ragged batch runs only its real lanes."""
        target_words = [int(w) for w in ops.target_to_words(req.target)]
        v = self._scrypt_scratch()
        n_log2 = self.scrypt_n_log2

        def spans():
            for hdr76, base_g, lo, hi in self._scrypt_segments(req):
                words = scrypt_ops.header_to_words(hdr76)
                for start in range(lo, hi + 1, self.scrypt_batch):
                    yield words, base_g, start, min(self.scrypt_batch, hi - start + 1)

        def dispatch(span):
            words, _, start, valid = span
            nonces = torch.arange(start, start + valid, dtype=torch.int64, device=self.device)
            x = kernels.scrypt_front(words, nonces, n_log2, v)
            x = kernels.romix_walk(x, v, n_log2, 1 << n_log2)
            return Handle(kernels.scrypt_back(words, nonces, x, target_words)[1])

        best: Optional[Tuple[int, int]] = None  # (hash, global index)
        searched = 0
        for (_, base_g, start, valid), handle in pipeline_spans(
            spans(), dispatch, depth=self.depth
        ):
            row = handle.read()
            if row[0]:
                first = row[1]
                yield Result(
                    req.job_id, req.mode, base_g | (start + first), _words_value(row[11:19]),
                    found=True, searched=searched + first + 1, chunk_id=req.chunk_id,
                )
                return
            cand = (_words_value(row[2:10]), base_g | (start + row[10]))
            if best is None or cand < best:
                best = cand
            searched += valid
            yield None
        yield Result(
            req.job_id, req.mode, best[1], best[0], found=best[0] <= req.target,
            searched=searched, chunk_id=req.chunk_id,
        )


def _words_value(words) -> int:
    """msb-first u32 hash words → the 256-bit hash value."""
    value = 0
    for w in words:
        value = (value << 32) | w
    return value
