"""Coordinator role: connection demultiplexer, work scheduler, result folder.

Counterpart of ``tpuminter.coordinator.Coordinator`` on a single event
loop. Clients and miners are told apart by their first message (``Join``
is a miner, ``Request`` a client). Each job's range is carved into
chunks at dispatch time, ``chunk_size × lanes`` nonces a miner (scaled
to whole pipeline spans for a worker that advertises one, divided by the
hash-cost ratio for SCRYPT, never more than half the job, and clamped to
a workload's window cap); jobs are served round-robin, and every miner
keeps up to ``pipeline_depth`` chunks outstanding, filled breadth-first.
A rolled job goes to a roll-dialect worker as extranonce-unit
``RollAssign`` chunks when ``roll_budget`` is set, and that worker's
progress ``Beacon`` books as a partial settle. ``_budget`` and
``_roll_carve`` are the reference's, so for the same ``Join`` and
``Request`` this coordinator sends the reference's ``Setup``, ``Assign``
and ``RollAssign`` sequence.

Every claim is checked on the host before it is folded: hashlib for
double SHA-256 and scrypt, the workload's own verifier (numpy for
hashcore, hashlib for dict) for a ``WorkResult``; scrypt and workload
claims verify on the executor, so the loop keeps its heartbeats. A
forged claim is requeued and its miner evicted after
:data:`MAX_REJECTIONS`; a refused chunk is requeued and its template
re-sent; a lost miner's chunks requeue; the first TARGET winner (or a
first-match workload's) finishes the job and ``Cancel``s the rest.

The reference's single-loop policies, each opt-in as there:

- **audits** (``audit_rate``, ``audit_seed``): an accepted chunk that
  does not finish its job is re-mined, at that probability, over a
  random sub-range of :data:`AUDIT_SAMPLE` nonces
  (:data:`AUDIT_SAMPLE_SCRYPT` for SCRYPT) on another worker; a
  sub-range minimum below the claim, or a winner the claim denied,
  evicts the suspect and requeues its chunk. An audit answered with the
  fast path's ``MIN_UNTRACKED`` sentinel is retried
  :data:`MAX_AUDIT_RETRIES` times, then counted inconclusive (an
  all-fast-path fleet's TARGET audits end so by design).
- **hedging** (``hedge_after``): with nothing queued, a chunk in flight
  longer than that is duplicated onto an idle miner of its size class;
  the first verified Result wins and the loser is ``Cancel``led.
- **admission** (``quota_rate``/``quota_burst``/``quota_tiers``,
  ``max_jobs``, ``park_capacity``/``workload_weights``,
  ``winners_ttl``, ``unbound_ttl``): per-client token buckets answer an
  over-quota submission with ``Refuse{retry_after_ms}``, or park it for
  a weighted drain; the tables are bounded in size and age.
- **streaming** (``emit_interval``): a ``stream`` workload job pushes
  ``Emit`` partials off journal-settled coverage.
- **the stats endpoint** (:meth:`Coordinator.start_stats_server`): the
  reference's JSON snapshot over one-shot HTTP.

Every admission, TTL and winner-age decision reads the ``clock`` seam
(``mono``/``wall``); dispatch stamps and hedge ages stay on the raw
clock, as in the reference.

With a journal (:mod:`tpuminter_torch.journal`) every transition is
appended, a winner is answered only once its ``finish`` record is
fsynced, and a restarted coordinator resumes each job over its
un-settled ranges, unbound until its durable client re-submits under
the same ``client_key``; an answered job's re-submission is answered
from the exactly-once winner table, and each tenant's token bucket is
restored from its ``quota`` records. The journal is the reference's,
record for record.

**Replication** (``replicate_to``, ``replica_ack``; :mod:`tpuminter_torch.
replication`): with a journal, one shipping lane a standby streams the
WAL, started by :meth:`Coordinator.serve`; with ``replica_ack`` a winner
is answered only once a standby has also acked its ``finish`` record.
A lane fenced by a promoted standby fences this coordinator
(:meth:`Coordinator._fence_self`): it drops every connection and rejects
every later event. A ``RepHello`` that reaches a coordinator is a stale
primary's and is rejected (``replication_fenced``). A promoted standby
builds its coordinator through :meth:`Coordinator.adopt_recovered`.

**Shards** (:mod:`tpuminter_torch.multiloop`, :mod:`tpuminter_torch.
multiproc`): one coordinator a shard, on its own loop or in its own
process. ``job_id_start``/``job_id_stride`` give shard *k* of *N* the
job ids ≡ *k*+1 (mod *N*), so recovery re-partitions the journal by id;
``replica_gate`` routes a shard's replica-ack gates to the writer loop's
lanes; ``seam`` (the multi-process shard seam) is told of each durable
bind and admission and consulted on a durable re-submission this shard
does not know, and :meth:`Coordinator.seam_rebind` and
:meth:`Coordinator.seam_quota_debit` are its home-shard halves. The CLI
runs them with ``--loops``, ``--procs``, ``--journal-mode`` and
``--io-batch``.

What waits for later slices, in this order: federation and chaos. Until
then this coordinator has no flag for them, and it denies every
``Steal`` (counted in ``steals_denied``), as the reference does with
``--steal-after`` unset.
"""

from __future__ import annotations

import asyncio
import functools
import json
import logging
import random
import struct
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from dataclasses import replace as dc_replace
from typing import Deque, Dict, List, Optional, Set, Tuple

from tpuminter_torch import chain, workloads
from tpuminter_torch.analysis import affinity
from tpuminter_torch.journal import (
    WINNERS_CAP,
    Journal,
    RecoveredState,
    encode_settle,
    merge_ranges,
)
from tpuminter_torch.lsp import LspServer, Params
from tpuminter_torch.lsp.params import FAST, parse_addr_list
from tpuminter_torch.protocol import (
    MIN_UNTRACKED,
    Assign,
    Beacon,
    Cancel,
    Emit,
    Join,
    PowMode,
    ProtocolError,
    Refuse,
    RepHello,
    Request,
    Result,
    RollAssign,
    Setup,
    Steal,
    WorkResult,
    decode_msg,
    encode_msg,
    request_to_obj,
)
from tpuminter_torch.replication import ReplicationPrimary, gate_any

__all__ = ["Coordinator", "main"]

log = logging.getLogger("tpuminter_torch.coordinator")

#: Nonces a dispatch per advertised worker lane.
DEFAULT_CHUNK_SIZE = 16_384

#: Least pipeline spans a dispatch to a worker that advertises a span
#: (``Join.span > 0``): a one-span chunk never overlaps its dispatch
#: with compute.
SPANS_PER_DISPATCH = 4

#: Chunks kept outstanding a miner, so a Result never round-trips
#: before the next chunk starts; 1 dispatches one chunk at a time.
DEFAULT_PIPELINE_DEPTH = 2

#: Unverifiable Results a miner may send before it is evicted.
MAX_REJECTIONS = 3

#: Consecutive Refuses a miner may send before it is evicted (an honest
#: worker refuses once a desync; the re-sent Setup fixes the next one).
MAX_REFUSALS = 8

#: Nonces re-mined an audit: an under-searcher is caught with
#: probability ~1 - 1/257 an audited chunk, at negligible duplicated
#: work; SCRYPT audits are smaller (each nonce is ~10^4× the work), so
#: at ``audit_rate`` 1 they re-mine at most 64/512 of real work.
AUDIT_SAMPLE = 256
AUDIT_SAMPLE_SCRYPT = 64

#: Re-dispatches an audit gets when its auditor answers with the
#: MIN_UNTRACKED sentinel (nothing falsifiable) before it is counted
#: inconclusive.
MAX_AUDIT_RETRIES = 2

#: SCRYPT costs ~10^3-10^4 double-SHA hashes a nonce: its chunk budget is
#: divided by this, floored at SCRYPT_MIN_CHUNK.
SCRYPT_CHUNK_DIVISOR = 8192
SCRYPT_MIN_CHUNK = 512

#: Token buckets kept (LRU-shed beyond): a shed identity that returns
#: gets a fresh burst, the cheap side of bounding memory.
QUOTA_BUCKETS_CAP = 4096

#: retry_after_ms of a capacity refusal (a quota refusal computes the
#: exact accrual time instead), and the cap of either (a u32 on the wire).
DEFAULT_RETRY_AFTER_MS = 250
MAX_RETRY_AFTER_MS = 60_000


@dataclass
class _Audit:
    """A queued or in-flight spot-check of an accepted chunk (the
    reference's ``_Audit``): ``req`` is the sub-range re-mine request,
    ``claimed_*`` what the suspect reported for the whole chunk
    ``orig``, ``retries`` the re-dispatches its sentinel answers used."""

    job_id: int
    suspect: int
    claimed_hash: int
    claimed_found: bool
    req: Request
    orig: Tuple[int, int]
    retries: int = 0


@dataclass
class _MinerState:
    conn_id: int
    backend: str
    lanes: int
    #: the worker's pipeline-stage size in nonces (0: not pipelined)
    span: int = 0
    depth: int = DEFAULT_PIPELINE_DEPTH
    #: the peer advertised the binary codec and this coordinator speaks
    #: it: Assign and Cancel go struct-packed, Setup stays JSON
    binary: bool = False
    #: the peer advertised the roll-budget dialect (RollAssign, Beacon)
    roll: bool = False
    #: workload names both the peer and this registry know
    workloads: frozenset = frozenset()
    #: outstanding dispatches, oldest first:
    #: chunk_id → (job_id, lower, upper, dispatched_at)
    chunks: "OrderedDict[int, Tuple[int, int, int, float]]" = field(default_factory=OrderedDict)
    rejections: int = 0
    refusals: int = 0  # consecutive; reset on an accepted Result
    hashes: int = 0
    chunks_done: int = 0
    joined: float = field(default_factory=time.monotonic)
    last_result: Optional[float] = None

    @property
    def busy(self) -> bool:
        return bool(self.chunks)

    @property
    def has_capacity(self) -> bool:
        """True while the dispatch pipeline has room for another chunk."""
        return len(self.chunks) < self.depth

    def supports(self, workload: str) -> bool:
        """Can this miner compute ``workload`` ("" is mining, which all do)?"""
        return not workload or workload in self.workloads

    def snapshot(self) -> dict:
        now = time.monotonic()
        alive = now - self.joined
        return {
            "backend": self.backend,
            "lanes": self.lanes,
            "hashes": self.hashes,
            "chunks_done": self.chunks_done,
            "mhs": self.hashes / alive / 1e6 if alive > 0 else 0.0,
            "busy": self.busy,
            "outstanding": len(self.chunks),
            "idle_s": None if self.last_result is None else round(now - self.last_result, 3),
        }


#: ``_Job.client_conn`` when no live connection owns the job (its durable
#: client is gone and has not re-submitted; the job keeps mining).
UNBOUND = -1


@dataclass
class _Winner:
    """A final Result in the dedup table. ``durable`` flips once the
    journal's finish record is fsynced; a re-submission before then
    parks in ``waiters`` and is answered by the same callback. ``ts`` is
    wall time, kept across restarts by the finish record, and feeds the
    ``winners_ttl`` age bound."""

    result: object
    durable: bool
    waiters: List[int] = field(default_factory=list)
    ts: float = field(default_factory=time.time)


@dataclass
class _Job:
    job_id: int                  # the coordinator's, unique across clients
    client_conn: int
    client_job_id: int           # echoed in the final Result
    request: Request             # the client's full-range request
    ranges: Deque[Tuple[int, int]] = field(default_factory=deque)
    #: chunk_id → (miner conn, lower, upper)
    inflight: Dict[int, Tuple[int, int, int]] = field(default_factory=dict)
    best: Optional[Tuple[int, int]] = None  # (hash_value, nonce) min-fold
    #: miners that hold this job's template (got its Setup)
    setup_sent: set = field(default_factory=set)
    #: audits queued or in flight: an exhausted job waits for them, so a
    #: convicted under-searcher's chunk requeues before the answer goes
    pending_audits: int = 0
    #: Results under executor verification, and their ranges (in neither
    #: ``ranges`` nor ``inflight``, so a snapshot reads them here)
    pending_verifications: int = 0
    verifying: List[Tuple[int, int]] = field(default_factory=list)
    done: bool = False
    started: float = field(default_factory=time.monotonic)
    hashes_done: int = 0
    #: the clock seam's instant the owning durable client was lost (0:
    #: bound); the UNBOUND reaper's clock
    unbound_since: float = 0.0
    #: a workload job's fold discipline (None: min-fold mining) and its
    #: coverage-gated fold state
    discipline: Optional[workloads.Fold] = None
    wstate: Optional[dict] = None
    #: streaming partials: the next Emit's seq, the coverage already
    #: pushed (the monotone floor), the last push's instant, and the
    #: newest durably settled snapshot (covered, total, payload) waiting
    #: out the pacing interval
    emit_seq: int = 0
    emit_covered: int = 0
    emit_last: float = 0.0
    emit_snapshot: Optional[Tuple[int, int, bytes]] = None

    @property
    def workload(self) -> str:
        return self.request.workload

    def fold(self, hash_value: int, nonce: int) -> None:
        if self.best is None or (hash_value, nonce) < self.best:
            self.best = (hash_value, nonce)

    def wfold(self, lo: int, hi: int, acc) -> bool:
        if self.wstate is None:
            self.wstate = workloads.new_state(self.discipline)
        return workloads.absorb(self.discipline, self.wstate, lo, hi, acc)

    @property
    def wacc(self):
        if self.wstate is None:
            self.wstate = workloads.new_state(self.discipline)
        return self.wstate["acc"]

    @property
    def exhausted(self) -> bool:
        return (not self.ranges and not self.inflight and self.pending_audits == 0
                and self.pending_verifications == 0)


@functools.lru_cache(maxsize=4096)
def _rolled_prefix76(header: bytes, cb_prefix: bytes, cb_suffix: bytes, en_size: int,
                     branch: Tuple[bytes, ...], en: int) -> bytes:
    """The first 76 bytes of the header mined at extranonce ``en``; a
    fleet revisits few extranonces of a rolled job, so this caches."""
    cb = chain.CoinbaseTemplate(cb_prefix, cb_suffix, en_size)
    return chain.rolled_header(header, cb, branch, en).pack()[:76]


class Coordinator:
    """The scheduler. Owns an :class:`LspServer`; drive with :meth:`serve`."""

    def __init__(
        self,
        server: LspServer,
        *,
        chunk_size: int = DEFAULT_CHUNK_SIZE,
        hedge_after: Optional[float] = None,
        audit_rate: float = 0.0,
        audit_seed: Optional[int] = None,
        stats_interval: float = 10.0,
        journal: Optional[Journal] = None,
        pipeline_depth: int = DEFAULT_PIPELINE_DEPTH,
        binary_codec: bool = True,
        journal_tick_flush: bool = True,
        quota_rate: float = 0.0,
        quota_burst: int = 8,
        quota_tiers: Optional[Dict[str, float]] = None,
        max_jobs: int = 0,
        retry_after_ms: int = DEFAULT_RETRY_AFTER_MS,
        winners_cap: int = WINNERS_CAP,
        winners_ttl: float = 0.0,
        unbound_ttl: float = 0.0,
        roll_budget: int = 0,
        workload_weights: Optional[Dict[str, float]] = None,
        park_capacity: int = 0,
        emit_interval: float = 0.5,
        replicate_to: Optional[List[Tuple[str, int]]] = None,
        replica_ack: bool = False,
        job_id_start: int = 1,
        job_id_stride: int = 1,
        replica_gate=None,
        seam=None,
        clock=None,
    ):
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if roll_budget < 0 or roll_budget > 0xFFFFFFFF:
            raise ValueError("roll_budget must be in [0, 2^32-1]")
        if park_capacity < 0:
            raise ValueError("park_capacity must be >= 0")
        if emit_interval < 0:
            raise ValueError("emit_interval must be >= 0 seconds")
        if quota_rate < 0 or quota_burst < 1:
            raise ValueError("quota_rate must be >= 0, quota_burst >= 1")
        if max_jobs < 0 or winners_cap < 1:
            raise ValueError("max_jobs must be >= 0, winners_cap >= 1")
        if not 0.0 <= audit_rate <= 1.0:
            raise ValueError("audit_rate must be in [0, 1]")
        if hedge_after is not None and hedge_after <= 0:
            raise ValueError("hedge_after must be positive seconds (or None to disable)")
        if job_id_stride < 1 or not 0 < job_id_start <= job_id_stride:
            raise ValueError("job_id_start must be in [1, job_id_stride]")
        self._server = server
        self._chunk_size = chunk_size
        #: the clock seam: admission, TTL and winner-age decisions read
        #: these; dispatch stamps and hedge ages stay on the raw clock
        self._mono = clock.mono if clock is not None else time.monotonic
        self._wall = clock.wall if clock is not None else time.time
        self._stats_interval = stats_interval
        self._stats_server: Optional[asyncio.AbstractServer] = None
        #: the JSON stats endpoint's port once started
        self.stats_port: Optional[int] = None
        self._pipeline_depth = pipeline_depth
        self._binary_codec = binary_codec
        #: extranonce segments a RollAssign to a roll-dialect worker
        #: (0: rolled chunks go as global-index Assigns)
        self._roll_budget = roll_budget
        #: chunk_id → indices already settled by accepted Beacons, so
        #: the chunk's final ``searched`` is not counted twice
        self._beacon_settled: Dict[int, int] = {}
        self._journal = journal
        if journal is not None:
            journal.snapshot_provider = self._journal_snapshot
            journal.tick_flush = journal_tick_flush
        # -- replication
        #: WAL-shipping lanes, one a standby; serve() starts them
        self._replicas: List[ReplicationPrimary] = []
        if replicate_to:
            if journal is None:
                raise ValueError("replicate_to requires a journal: replication ships the WAL, "
                                 "so there must be one")
            self._replicas = [ReplicationPrimary(journal, host, port, params=server.params)
                              for host, port in replicate_to]
        #: a lane was fenced by a promoted standby: this incarnation is a
        #: zombie of a failed-over epoch and answers nothing more
        self.fenced = False
        for rep in self._replicas:
            rep.on_fenced = self._fence_self
        #: a shard's replica-ack router to the writer loop's lanes
        #: (multi-loop), called as ``(target_offset, cb)``
        self._replica_gate = replica_gate
        #: winners wait for a standby's ack past their finish record too
        self._replica_ack = replica_ack and (bool(self._replicas) or replica_gate is not None)
        # -- the multi-process shard seam
        #: sibling-shard gossip and rebind hooks; None makes each a no-op
        self._seam = seam
        #: (ckey, cjid) → [(origin shard, its conn id)]: other shards'
        #: clients parked on a live job or a not-yet-durable winner here
        self._remote_waiters: Dict[Tuple[str, int], List[Tuple[int, int]]] = {}
        # -- audits and hedging
        self._audit_rate = audit_rate
        self._audit_rng = random.Random(audit_seed)
        self._audit_queue: Deque[_Audit] = deque()
        self._audits: Dict[int, _Audit] = {}  # chunk_id → in-flight audit
        self._hedge_after = hedge_after
        self._hedge_task: Optional[asyncio.Task] = None
        # -- admission
        self._quota_rate = quota_rate
        self._quota_burst = quota_burst
        #: ckey prefix before ':' → rate and burst multiplier
        self._quota_tiers = dict(quota_tiers or {})
        self._max_jobs = max_jobs
        self._retry_after_ms = max(1, min(retry_after_ms, MAX_RETRY_AFTER_MS))
        self._winners_cap = winners_cap
        self._winners_ttl = winners_ttl
        self._unbound_ttl = unbound_ttl
        #: ckey → (tokens, last_refill, consecutive_refusals), LRU order
        self._buckets: "OrderedDict[str, Tuple[float, float, int]]" = OrderedDict()
        #: durable ckeys whose buckets changed since the last quota record
        self._quota_dirty: Set[str] = set()
        #: (unbound_since, job_id), monotone by time: the UNBOUND reaper
        self._unbound_q: Deque[Tuple[float, int]] = deque()
        # -- the park queue and streaming
        #: workload class ("mine" for mining) → drain weight (default 1)
        self._workload_weights = {str(k): float(v) for k, v in (workload_weights or {}).items()}
        if any(w <= 0 for w in self._workload_weights.values()):
            raise ValueError("workload weights must be positive")
        self._park_capacity = park_capacity
        #: workload class → parked (conn_id, Request) FIFO
        self._parked: Dict[str, Deque[Tuple[int, Request]]] = {}
        #: workload class → its stride pass (drains / weight)
        self._park_deficit: Dict[str, float] = {}
        #: workload class → entries drained
        self.parked_drained_by_class: Dict[str, int] = {}
        self._park_task: Optional[asyncio.Task] = None
        self._emit_interval = emit_interval
        self._miners: Dict[int, _MinerState] = {}
        #: miners with pipeline room, FIFO; kept on every transition so a
        #: dispatch pass never scans the whole fleet
        self._idle: "OrderedDict[int, _MinerState]" = OrderedDict()
        self._dispatch_scheduled = False
        #: executor-verification tasks in flight (the loop holds tasks weakly)
        self._settling: set = set()
        self._clients: Dict[int, set] = {}        # client conn → its job ids
        self._jobs: Dict[int, _Job] = {}
        self._rotation: Deque[int] = deque()      # job ids with queued ranges
        #: this shard's job-id lane: ids ≡ job_id_start (mod job_id_stride)
        self._job_id_stride = job_id_stride
        self._next_job_id = job_id_start
        self._next_chunk_id = 1
        #: answered winners by (client_key, client_job_id): a re-submitted
        #: request is answered from here, never re-mined
        self._winners: "OrderedDict[Tuple[str, int], _Winner]" = OrderedDict()
        #: live jobs by (client_key, client_job_id): a redialing client
        #: re-binds to its running job
        self._bound: Dict[Tuple[str, int], int] = {}
        #: the reference's counters, key for key; those of the subsystem
        #: this coordinator does not run (federation) stay 0
        self.stats = {
            "hashes": 0,
            "jobs_done": 0,
            "results_accepted": 0,
            "chunks_requeued": 0,
            "results_rejected": 0,
            "miners_evicted": 0,
            "chunks_hedged": 0,
            "audits_done": 0,
            "audits_failed": 0,
            "audits_inconclusive": 0,
            "verifications_offloaded": 0,
            "dispatches_pipelined": 0,
            "replication_fenced": 0,
            "refused_admission": 0,
            "refused_workload": 0,
            "jobs_shed": 0,
            "unbound_reaped": 0,
            "winners_evicted": 0,
            "jobs_high_water": 0,
            "winners_high_water": 0,
            "sessions_high_water": 0,
            "quota_buckets_high_water": 0,
            "chunks_roll_dispatched": 0,
            "beacons_accepted": 0,
            "leases_delegated": 0,
            "chunks_stolen": 0,
            "steals_denied": 0,
            "beacons_fenced": 0,
            "results_fenced": 0,
            "seam_rebinds_honored": 0,
            "seam_rebind_misses": 0,
            "quota_foreign_debits": 0,
            "jobs_parked": 0,
            "parked_shed": 0,
            "parked_drained": 0,
            "park_queue_high_water": 0,
            "emits_sent": 0,
        }
        # TPUMINTER_LOOP_AFFINITY=1: a coordinator is single-loop (one a
        # shard); a mutation from another loop's thread is a recorded race
        affinity.stamp(self)

    @classmethod
    async def create(
        cls,
        port: int = 0,
        *,
        params: Optional[Params] = None,
        host: str = "127.0.0.1",
        recover_from: Optional[str] = None,
        io_batch: Optional[bool] = None,
        **kwargs,
    ) -> "Coordinator":
        """Listen on ``host:port``. ``recover_from`` names a journal file:
        if it exists its records are replayed (jobs resume from their
        un-settled ranges, answered winners return to the dedup table,
        tenants' token buckets to their balances) and every transition
        is journaled onward; the journal's monotone boot epoch becomes
        the LSP server's, so a redialing peer sees the restart.
        ``io_batch`` picks the transport's I/O mode (None: its default).
        Other keywords go to the constructor."""
        journal = None
        recovered: Optional[RecoveredState] = None
        boot_epoch: Optional[int] = None
        if recover_from is not None:
            journal, recovered = Journal.open(
                recover_from, winners_cap=kwargs.get("winners_cap", WINNERS_CAP))
            boot_epoch = recovered.boot_epoch
        server = await LspServer.create(port, params or FAST, host=host, boot_epoch=boot_epoch,
                                        io_batch=io_batch)
        coord = cls(server, journal=journal, **kwargs)
        if recovered is not None:
            coord._adopt(recovered)
        return coord

    def adopt_recovered(self, recovered: RecoveredState) -> None:
        """The replication standby's takeover seam: the shadow it built
        record by record is a replayed journal."""
        self._adopt(recovered)

    def _adopt(self, recovered: RecoveredState) -> None:
        """Rebuild scheduler state from a replayed journal (the
        reference's ``_adopt``): each job resumes UNBOUND over its
        un-settled ranges, each answered winner younger than
        ``winners_ttl`` re-enters the dedup table, and each tenant's
        token bucket resumes its recorded balance, capped at its tier's
        burst, its refill clock restarting now (accrual while down is
        forfeited, which only under-grants). The federation leases that
        replay also folds have no role here yet."""
        if recovered.next_job_id > self._next_job_id:
            # the first id of this shard's lane at or past the recovered
            # high water (stride 1: the dense sequence)
            stride = self._job_id_stride
            nxt = recovered.next_job_id
            self._next_job_id = nxt + (self._next_job_id % stride - nxt % stride) % stride
        now_wall = self._wall()
        for (ckey, cjid), rec in recovered.winners.items():
            ts = float(rec.get("ts", now_wall))
            if self._winners_ttl and now_wall - ts > self._winners_ttl:
                self.stats["winners_evicted"] += 1  # aged out while down
                continue
            if "wp" in rec:
                res = WorkResult(job_id=cjid, chunk_id=0, wid=int(rec.get("wid", 0)),
                                 searched=int(rec["s"]), payload=bytes.fromhex(rec["wp"]))
            else:
                res = Result(cjid, PowMode(rec["mode"]), int(rec["n"]), int(rec["h"], 16),
                             bool(rec["found"]), searched=int(rec["s"]))
            # replayed winners came off fsynced records: durable
            self._winners[(ckey, cjid)] = _Winner(res, durable=True, ts=ts)
        self._trim_winners()
        finish_now = []
        for rjob in recovered.jobs.values():
            job = _Job(job_id=rjob.job_id, client_conn=UNBOUND,
                       client_job_id=rjob.client_job_id, request=rjob.request)
            job.ranges.extend(rjob.remaining)
            job.best = rjob.best
            job.hashes_done = rjob.hashes_done
            if rjob.request.workload:
                job.discipline = workloads.fold_of(rjob.request)
                if job.discipline is None:
                    log.warning("dropping recovered job %d: workload %r is not registered in "
                                "this build", rjob.job_id, rjob.request.workload)
                    continue
                job.wstate = rjob.wstate
            self._jobs[job.job_id] = job
            if self._unbound_ttl:
                # unbound until its client re-submits: the reaper owns it
                job.unbound_since = self._mono()
                self._unbound_q.append((job.unbound_since, job.job_id))
            if rjob.client_key:
                self._bound[(rjob.client_key, rjob.client_job_id)] = job.job_id
            if job.ranges:
                self._rotation.append(job.job_id)
            if job.discipline is not None:
                if job.discipline.is_final(job.wacc):
                    finish_now.append((job, True))  # its finish record was lost
                elif job.exhausted:
                    finish_now.append((job, None))
            elif (job.best is not None and job.request.mode.targeted
                  and job.best[0] <= (job.request.target or 0)):
                finish_now.append((job, True))  # a settled winner, finish lost
            elif job.exhausted:
                finish_now.append((job, None))  # fully settled, finish lost
        if recovered.quota:
            now_mono = self._mono()
            for ck, (tok, strikes) in recovered.quota.items():
                burst = max(1.0, self._quota_burst * self._tier(ck))
                self._buckets[ck] = (min(burst, float(tok)), now_mono, int(strikes))
            while len(self._buckets) > QUOTA_BUCKETS_CAP:
                self._buckets.popitem(last=False)
            self._hw("quota_buckets_high_water", len(self._buckets))
        if recovered.jobs:
            log.info("recovered %d live job(s) and %d acknowledged winner(s) from the journal "
                     "(boot epoch %d)", len(recovered.jobs), len(recovered.winners),
                     recovered.boot_epoch)
        for job, found in finish_now:
            if found is None:
                self._maybe_finish_exhausted(job)
            else:
                self._finish_job(job, found=found)
        self._schedule_dispatch()

    # -- journaling ------------------------------------------------------

    def _journal_append(self, kind: str, obj: dict, on_durable=None) -> None:
        if self._journal is not None:
            self._journal.append(kind, obj, on_durable=on_durable)

    def _journal_settle(self, job: _Job, lo: int, hi: int, msg, searched: int,
                        on_durable=None) -> None:
        if self._journal is None:
            return
        if job.discipline is not None:
            # the fold payload rides along, so replay re-absorbs it;
            # ``on_durable`` releases a streaming snapshot
            self._journal.append("settle", {
                "id": job.job_id, "lo": lo, "hi": hi, "s": searched,
                "wp": bytes(msg.payload).hex(),
            }, on_durable=on_durable)
            return
        # the packed record whenever every field fits its u64 (always,
        # for a verified in-range claim); JSON otherwise
        if (searched < (1 << 64) and hi < (1 << 64) and lo >= 0
                and 0 <= msg.nonce < (1 << 64) and job.job_id < (1 << 64)):
            self._journal.append_encoded(encode_settle(
                job.job_id, lo, hi, msg.nonce, searched, msg.hash_value))
        else:
            self._journal.append_encoded(
                b'{"id":%d,"lo":%d,"hi":%d,"h":"%x","n":%d,"s":%d,"k":"settle"}'
                % (job.job_id, lo, hi, msg.hash_value, msg.nonce, searched))

    def _journal_quota(self) -> None:
        """Flush the durable ckeys' changed buckets as one ``quota``
        record (the reference's ``_journal_quota``). Anonymous
        ``@conn:`` buckets die with their session and never reach disk;
        refill instants are local and do not cross the journal."""
        if self._journal is None or not self._quota_dirty:
            self._quota_dirty.clear()
            return
        buckets = []
        for ck in self._quota_dirty:
            b = self._buckets.get(ck)
            if b is not None and not ck.startswith("@conn:"):
                buckets.append([ck, round(b[0], 3), b[2]])
        self._quota_dirty.clear()
        if buckets:
            self._journal_append("quota", {"buckets": buckets})

    def _journal_snapshot(self) -> dict:
        """The compacting checkpoint equal to the live state (the
        reference's ``_journal_snapshot``): a job's remaining coverage
        is its queued, in-flight and under-verification ranges (none of
        them settled); the durable tenants' buckets ride along as a
        ``quota`` list when there are any."""
        jobs = []
        for job in self._jobs.values():
            if job.done:
                continue
            remaining = merge_ranges(
                list(job.ranges)
                + [(lo, hi) for _conn, lo, hi in job.inflight.values()]
                + list(job.verifying))
            rec = {
                "id": job.job_id,
                "req": request_to_obj(job.request),
                "rem": [[lo, hi] for lo, hi in remaining],
                "best": None if job.best is None else [f"{job.best[0]:x}", job.best[1]],
                "hashes": job.hashes_done,
            }
            if job.wstate is not None:
                rec["wst"] = job.wstate
            jobs.append(rec)
        snap = {
            "k": "snapshot",
            "next": self._next_job_id,
            "jobs": jobs,
            "winners": [[ck, cj, self._winner_rec(ck, cj, w)]
                        for (ck, cj), w in self._winners.items()],
        }
        quota = [[ck, round(tok, 3), strikes]
                 for ck, (tok, _last, strikes) in self._buckets.items()
                 if not ck.startswith("@conn:")]
        if quota:
            snap["quota"] = quota  # quota-free checkpoints keep their shape
        return snap

    @staticmethod
    def _winner_rec(ck: str, cj: int, w: _Winner) -> dict:
        """One dedup-table entry as a replayable finish record."""
        if isinstance(w.result, WorkResult):
            return {
                "k": "finish", "id": 0, "ckey": ck, "cjid": cj,
                "mode": PowMode.MIN.value, "n": 0, "h": "0",
                "found": True, "s": w.result.searched,
                "wid": w.result.wid, "wp": bytes(w.result.payload).hex(),
                "ts": w.ts,
            }
        return {
            "k": "finish", "id": 0, "ckey": ck, "cjid": cj,
            "mode": w.result.mode.value, "n": w.result.nonce,
            "h": f"{w.result.hash_value:x}", "found": w.result.found,
            "s": w.result.searched, "ts": w.ts,
        }

    def crash(self) -> None:
        """Die like ``kill -9``: the socket closes undrained, buffered
        journal records are lost, nobody hears goodbye. Recover with a
        fresh ``create(recover_from=...)``."""
        self._server.crash()
        for rep in self._replicas:
            rep.crash()
        if self._journal is not None:
            self._journal.crash()

    @property
    def port(self) -> int:
        return self._server.port

    @property
    def boot_epoch(self) -> int:
        return self._server.boot_epoch

    @property
    def server(self) -> LspServer:
        return self._server

    # -- event loop ------------------------------------------------------

    async def serve(self) -> None:
        """Process events forever, in bursts: one await for the first
        queued event, ``read_nowait`` for the rest the transport already
        delivered, then one dispatch pass and one journal flush. Hedging
        adds a ticker, since a straggler shows only as time passing."""
        if self._hedge_after is not None:
            self._hedge_task = asyncio.ensure_future(self._hedge_ticker())
        rate_ticker = asyncio.ensure_future(self._rate_ticker())
        for rep in self._replicas:
            rep.start()
        journal = self._journal
        tick_journal = journal if journal is not None and journal.tick_flush else None
        try:
            while True:
                event = await self._server.read()
                while event is not None:
                    self._handle_event(event)
                    event = self._server.read_nowait()
                self._run_scheduled_dispatch()
                if tick_journal is not None:
                    tick_journal.flush_tick()
        finally:
            rate_ticker.cancel()
            for task in (self._hedge_task, self._park_task):
                if task is not None:
                    task.cancel()

    def _fence_self(self) -> None:
        """A lane learned that a promoted standby owns a higher epoch:
        stop serving, so a healed netsplit never runs two coordinators
        on one job set. Every peer is reset now, every later event
        rejected, and the fleet rotates to the promoted standby."""
        if self.fenced:
            return
        self.fenced = True
        log.warning("coordinator (epoch %d) FENCED: a promoted standby owns a higher epoch — "
                    "dropping %d connection(s) and refusing all traffic on this incarnation",
                    self.boot_epoch, len(self._server.conn_ids))
        for conn_id in self._server.conn_ids:
            self._server.reject_conn(conn_id)

    def _handle_event(self, event: Tuple[int, Optional[bytes]]) -> None:
        conn_id, payload = event
        if payload is None:
            self._on_lost(conn_id)
            return
        if self.fenced:
            self._server.reject_conn(conn_id)
            return
        try:
            msg = decode_msg(payload)
        except ProtocolError as exc:
            log.warning("conn %d: malformed message dropped: %s", conn_id, exc)
            return
        if isinstance(msg, (Result, WorkResult)):
            self._on_result(conn_id, msg)
        elif isinstance(msg, Beacon):
            self._on_beacon(conn_id, msg)
        elif isinstance(msg, Refuse):
            self._on_refuse(conn_id, msg)
        elif isinstance(msg, Join):
            self._on_join(conn_id, msg)
        elif isinstance(msg, Steal):
            # no federation yet: every Steal is denied, as the
            # reference's coordinator does without --steal-after
            self.stats["steals_denied"] += 1
        elif isinstance(msg, Request):
            self._on_request(conn_id, msg)
        elif isinstance(msg, RepHello):
            # only a standby is a shipping target: this is a primary that
            # lost a failover resuming its stream here. Higher epoch wins
            log.warning("conn %d: REJECTING RepHello epoch %d (own epoch %d): this coordinator "
                        "is not a standby — a fenced-off primary is still claiming its old role",
                        conn_id, msg.epoch, self.boot_epoch)
            self.stats["replication_fenced"] += 1
            self._server.reject_conn(conn_id)
        else:
            log.warning("conn %d: unexpected %s", conn_id, type(msg).__name__)

    def _schedule_dispatch(self) -> None:
        """Mark dispatch dirty: the pass runs once a tick however many
        events asked for it (at serve's burst end, or by call_soon)."""
        if self._dispatch_scheduled:
            return
        self._dispatch_scheduled = True
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            self._run_scheduled_dispatch()  # no loop: run now
            return
        loop.call_soon(self._run_scheduled_dispatch)

    def _run_scheduled_dispatch(self) -> None:
        if not self._dispatch_scheduled:
            return
        self._dispatch_scheduled = False
        self._dispatch()

    async def _rate_ticker(self) -> None:
        """The aggregate rate line, every ``stats_interval`` seconds
        while work flows (silent while idle), after the housekeeping
        that must advance with no request arriving: the UNBOUND reaper,
        the winner table's age bound and the quota record."""
        last = self.stats["hashes"]
        while True:
            await asyncio.sleep(self._stats_interval)
            self._reap_unbound()
            self._trim_winners()
            self._journal_quota()
            cur = self.stats["hashes"]
            if self._rotation and not self._miners:
                # on a shard: jobs mine on their client's shard, and
                # this one drew clients but no miners
                log.warning("%d job(s) queued but NO miners are connected to this %s — they "
                            "will not progress until a worker joins here", len(self._rotation),
                            "shard" if self._job_id_stride > 1 else "coordinator")
            if cur == last and not self._jobs:
                continue
            busy = sum(1 for m in self._miners.values() if m.busy)
            log.info("rate: %.3f MH/s over the last %.0fs (total %d hashes, %d jobs active, "
                     "%d/%d workers busy)", (cur - last) / self._stats_interval / 1e6,
                     self._stats_interval, cur, len(self._jobs), busy, len(self._miners))
            last = cur

    def stats_snapshot(self) -> dict:
        """The machine-readable view (the reference's ``stats_snapshot``):
        cumulative counters, per-worker rates and queue depths, and a
        ``replication`` entry a shipping lane."""
        snap = {
            "stats": dict(self.stats),
            "workers": {str(k): v for k, v in self.worker_stats().items()},
            "jobs_active": len(self._jobs),
            "chunks_queued": sum(len(j.ranges) for j in self._jobs.values()),
            "audits_queued": len(self._audit_queue) + len(self._audits),
            "boot_epoch": self._server.boot_epoch,
            "winners_cached": len(self._winners),
            "quota_buckets": len(self._buckets),
        }
        if self._journal is not None:
            snap["journal"] = dict(self._journal.stats)
        if self._replicas:
            snap["replication"] = [{"synced": rep.synced, "acked": rep.acked,
                                    "fenced": rep.fenced, **rep.stats}
                                   for rep in self._replicas]
        return snap

    async def start_stats_server(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Serve :meth:`stats_snapshot` as JSON over one-shot HTTP/1.0 on
        ``port`` (0: ephemeral, kept in ``self.stats_port``), as the
        reference's ``start_stats_server`` does: ``curl localhost:PORT``."""

        async def handle(reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
            try:
                try:
                    # drain the request through its blank line (closing
                    # with unread bytes can reset the response away)
                    for _ in range(100):
                        line = await asyncio.wait_for(reader.readline(), 0.5)
                        if not line or line in (b"\r\n", b"\n"):
                            break
                except asyncio.TimeoutError:
                    pass
                body = json.dumps(self.stats_snapshot()).encode()
                writer.write(b"HTTP/1.0 200 OK\r\nContent-Type: application/json\r\n"
                             b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body)
                await writer.drain()
            finally:
                writer.close()

        self._stats_server = await asyncio.start_server(handle, host, port)
        self.stats_port = self._stats_server.sockets[0].getsockname()[1]
        log.info("stats endpoint on http://%s:%d", host, self.stats_port)
        return self.stats_port

    async def _hedge_ticker(self) -> None:
        """A dispatch pass every ``hedge_after / 2`` (the reference's
        ``_hedge_ticker``); an error is logged, never fatal to hedging."""
        while True:
            await asyncio.sleep(self._hedge_after / 2)
            try:
                self._dispatch()
            except Exception:
                log.exception("hedge ticker: dispatch failed; continuing")

    async def close(self) -> None:
        if self._hedge_task is not None:
            self._hedge_task.cancel()
        if self._stats_server is not None:
            self._stats_server.close()
        for rep in self._replicas:
            await rep.stop()
        await self._server.close(drain_timeout=2.0)
        if self._journal is not None:
            await self._journal.aclose()

    # -- membership ------------------------------------------------------

    def _mark_idle(self, miner: _MinerState) -> None:
        """A miner still in the fleet with pipeline room is dispatchable."""
        if miner.has_capacity and miner.conn_id in self._miners:
            self._idle[miner.conn_id] = miner

    def _drop_miner(self, conn_id: int) -> None:
        self._miners.pop(conn_id, None)
        self._idle.pop(conn_id, None)

    def _on_join(self, conn_id: int, msg: Join) -> None:
        if conn_id in self._miners:
            return  # a duplicate Join
        miner = _MinerState(
            conn_id, msg.backend, max(1, msg.lanes), span=max(0, msg.span),
            depth=self._pipeline_depth,
            binary=self._binary_codec and msg.codec == "bin",
            roll=msg.roll,
            workloads=frozenset(msg.workloads) & set(workloads.names()),
        )
        self._miners[conn_id] = miner
        self._idle[conn_id] = miner
        log.info("miner %d joined (backend=%s, lanes=%d, span=%d, codec=%s%s%s)",
                 conn_id, msg.backend, msg.lanes, msg.span,
                 "bin" if miner.binary else "json", ", roll" if miner.roll else "",
                 (", workloads=" + ",".join(sorted(miner.workloads))) if miner.workloads else "")
        self._schedule_dispatch()

    def _release_chunk(self, conn_id: int, chunk_id: int,
                       entry: Tuple[int, int, int, float]) -> None:
        """Requeue one dispatch the miner no longer owns (the caller has
        already taken it out of ``miner.chunks``): a job's chunk back to
        its job, an audit back to the audit queue."""
        job_id, lo, hi, _at = entry
        self._beacon_settled.pop(chunk_id, None)
        audit = self._audits.pop(chunk_id, None)
        if audit is not None:
            self._audit_queue.append(audit)  # retry on another worker
            return
        job = self._jobs.get(job_id)
        if job is not None and not job.done:
            job.inflight.pop(chunk_id, None)
            self._requeue_chunk(job, lo, hi)
            log.info("released [%d, %d] of job %d from miner %d", lo, hi, job_id, conn_id)

    def _release_assignment(self, conn_id: int, miner: _MinerState) -> None:
        """Requeue every chunk a departing miner held."""
        if not miner.chunks:
            return
        chunks, miner.chunks = miner.chunks, OrderedDict()
        for chunk_id, entry in chunks.items():
            self._release_chunk(conn_id, chunk_id, entry)
        self._mark_idle(miner)

    def _on_lost(self, conn_id: int) -> None:
        miner = self._miners.get(conn_id)
        if miner is not None:
            self._drop_miner(conn_id)
            if miner.busy:
                self._release_assignment(conn_id, miner)
                log.info("miner %d died", conn_id)
            else:
                log.info("idle miner %d died", conn_id)
            self._schedule_dispatch()
            return
        # an anonymous client's bucket is its session's; a durable
        # identity's persists (a redial must not refill quota)
        self._buckets.pop(f"@conn:{conn_id}", None)
        job_ids = self._clients.pop(conn_id, None)
        if job_ids:
            dropped = []
            for job_id in list(job_ids):
                job = self._jobs.get(job_id)
                if job is not None and job.request.client_key:
                    # a durable client may redial: keep mining, unbound;
                    # its answer waits in the winner table
                    job.client_conn = UNBOUND
                    if self._unbound_ttl:
                        job.unbound_since = self._mono()
                        self._unbound_q.append((job.unbound_since, job.job_id))
                else:
                    self._abandon_job(job_id)
                    dropped.append(job_id)
            log.info("client %d died; dropped jobs %s, kept %d durable",
                     conn_id, sorted(dropped), len(job_ids) - len(dropped))
            self._schedule_dispatch()
        self._reap_unbound()

    # -- admission and bounded state -------------------------------------

    def _hw(self, key: str, value: int) -> None:
        if value > self.stats[key]:
            self.stats[key] = value

    def _tier(self, ckey: str) -> float:
        """The ckey's ``tier:`` prefix's multiplier (1.0 without one or
        for an unknown one), as the reference's ``_tier``."""
        if ":" in ckey:
            return self._quota_tiers.get(ckey.split(":", 1)[0], 1.0)
        return 1.0

    def _admit(self, conn_id: int, msg: Request) -> int:
        """Admission of a new submission (the reference's ``_admit``;
        dedup hits and re-binds mint nothing and are never charged): 0
        admits, else the retry_after_ms to refuse with. At ``max_jobs``
        a parkless coordinator sheds one zero-progress pending job; with
        the park queue armed the newcomer waits its turn instead. A
        quota refusal suggests the exact accrual time of the missing
        token, doubled for each consecutive refusal."""
        if self._max_jobs and len(self._jobs) >= self._max_jobs:
            if self._park_capacity > 0 or not self._shed_one():
                return self._retry_after_ms
        if self._quota_rate <= 0:
            return 0
        ckey = msg.client_key or f"@conn:{conn_id}"
        tier = self._tier(ckey)
        rate = self._quota_rate * tier
        burst = max(1.0, self._quota_burst * tier)
        now = self._mono()
        bucket = self._buckets.pop(ckey, None)
        if bucket is None:
            tokens, strikes = burst, 0
        else:
            tokens, last, strikes = bucket
            # a clock that steps back must not drain the bucket
            tokens = min(burst, tokens + max(0.0, now - last) * rate)
        if tokens >= 1.0:
            tokens -= 1.0
            ms = 0
            strikes = 0
            if msg.client_key:
                self._quota_dirty.add(ckey)
                if self._seam is not None:
                    # sibling shard processes debit their copy of the bucket
                    self._seam.on_admit(ckey)
        else:
            ms = min(MAX_RETRY_AFTER_MS,
                     max(1, int((1.0 - tokens) / rate * 1000.0)) << min(strikes, 8))
            strikes += 1
        self._buckets[ckey] = (tokens, now, strikes)  # re-insert: the LRU touch
        while len(self._buckets) > QUOTA_BUCKETS_CAP:
            self._buckets.popitem(last=False)
        self._hw("quota_buckets_high_water", len(self._buckets))
        return ms

    def _send_refuse(self, conn_id: int, client_job_id: int, retry_ms: int) -> None:
        """``Refuse{retry_after_ms}`` to a client, echoing its job id
        (chunk_id 0 marks the admission dialect), as the reference's
        ``_send_refuse``."""
        try:
            self._server.write(conn_id, encode_msg(Refuse(client_job_id, 0,
                                                          retry_after_ms=retry_ms)))
        except ConnectionError:
            pass

    def _shed_one(self) -> bool:
        """Shed one zero-progress pending job to make room under
        ``max_jobs`` (the reference's ``_shed_one``): an UNBOUND one
        first, else the oldest bound one, whose client is refused with
        the retry hint. A job with any progress (hashes, chunks in
        flight, audits or verifications) is never shed."""
        victim = None
        for job in self._jobs.values():  # creation order
            if (job.done or job.hashes_done or job.inflight or job.pending_audits
                    or job.pending_verifications):
                continue
            if job.client_conn == UNBOUND:
                victim = job
                break
            if victim is None:
                victim = job
        if victim is None:
            return False
        if victim.client_conn != UNBOUND:
            self._send_refuse(victim.client_conn, victim.client_job_id, self._retry_after_ms)
        self.stats["jobs_shed"] += 1
        log.info("shed pending job %d (over --max-jobs=%d)", victim.job_id, self._max_jobs)
        self._abandon_job(victim.job_id)
        return True

    def _trim_winners(self) -> None:
        """Hold the dedup table to ``winners_cap`` and ``winners_ttl``
        (the reference's ``_trim_winners``), evicting ACKNOWLEDGED
        entries only: one not yet durable, or with parked re-submitters,
        could otherwise be answered twice."""
        if len(self._winners) <= self._winners_cap and not self._winners_ttl:
            return
        evictable = [key for key, w in self._winners.items() if w.durable and not w.waiters]
        excess = len(self._winners) - self._winners_cap
        evicted = 0
        for key in evictable[:max(0, excess)]:
            del self._winners[key]
            evicted += 1
        if self._winners_ttl:
            cutoff = self._wall() - self._winners_ttl
            for key in evictable[max(0, excess):]:
                w = self._winners.get(key)
                if w is not None and w.ts <= cutoff:
                    del self._winners[key]
                    evicted += 1
        if evicted:
            self.stats["winners_evicted"] += evicted

    def _reap_unbound(self) -> None:
        """Abandon durable jobs whose client has been gone longer than
        ``unbound_ttl`` (the reference's ``_reap_unbound``). A client
        that returns later mints a fresh job: work re-done, never an
        answer twice."""
        if not self._unbound_ttl:
            return
        now = self._mono()
        while self._unbound_q and now - self._unbound_q[0][0] >= self._unbound_ttl:
            ts, job_id = self._unbound_q.popleft()
            job = self._jobs.get(job_id)
            if (job is None or job.done or job.client_conn != UNBOUND
                    or job.unbound_since != ts):
                continue  # retired, re-bound, or superseded
            self.stats["unbound_reaped"] += 1
            log.info("reaped UNBOUND job %d (client gone %.1fs > ttl %.1fs)", job_id,
                     now - ts, self._unbound_ttl)
            self._abandon_job(job_id)

    # -- job lifecycle ---------------------------------------------------

    def _on_request(self, conn_id: int, msg: Request) -> None:
        if conn_id in self._miners:
            log.warning("miner %d sent a client Request; dropped", conn_id)
            return
        if msg.client_key:
            key = (msg.client_key, msg.job_id)
            winner = self._winners.get(key)
            if winner is not None:
                # a re-submission of an answered job: answer from the
                # table, once its finish record is durable
                if not winner.durable:
                    winner.waiters.append(conn_id)
                    return
                log.info("client %d re-submitted answered job %s/%d; re-delivering the "
                         "journaled winner", conn_id, msg.client_key[:8], msg.job_id)
                self._deliver_finish(conn_id, winner.result)
                return
            bound = self._bound.get(key)
            if bound is not None:
                job = self._jobs.get(bound)
                if job is not None and not job.done:
                    self._rebind_job(job, conn_id)  # still running: re-bind it
                    return
            if self._seam is not None and self._seam.consult(conn_id, msg):
                # a sibling shard process owns this (ckey, cjid): the seam
                # parked the submission and asks the home shard, whose
                # answer (or miss, which re-enters here) comes back over it
                return
        self._reap_unbound()
        retry_ms = self._admit(conn_id, msg)
        if retry_ms:
            if self._park_capacity > 0:
                self._park_submission(conn_id, msg)
                return
            self.stats["refused_admission"] += 1
            log.info("refused admission for client %d job %d (retry in %d ms)", conn_id,
                     msg.job_id, retry_ms)
            self._send_refuse(conn_id, msg.job_id, retry_ms)
            return
        self._mint_job(conn_id, msg)

    def _mint_job(self, conn_id: int, msg: Request) -> None:
        """Resolve the workload and mint the job (the reference's
        ``_mint_job``: the tail of ``_on_request``, shared with the park
        queue's drain)."""
        discipline = None
        if msg.workload:
            discipline = workloads.fold_of(msg)
            if discipline is None:
                # malformed, not busy: Refuse with no retry hint
                self.stats["refused_workload"] += 1
                log.warning("refused job %d from client %d: unknown workload %r or malformed "
                            "params", msg.job_id, conn_id, msg.workload)
                self._send_refuse(conn_id, msg.job_id, 0)
                return
        job_id = self._next_job_id
        self._next_job_id += self._job_id_stride
        job = _Job(job_id=job_id, client_conn=conn_id, client_job_id=msg.job_id, request=msg)
        job.discipline = discipline
        job.ranges.append((msg.lower, msg.upper))
        self._jobs[job_id] = job
        self._clients.setdefault(conn_id, set()).add(job_id)
        self._hw("jobs_high_water", len(self._jobs))
        self._hw("sessions_high_water", len(self._clients))
        if msg.client_key:
            self._bound[(msg.client_key, msg.job_id)] = job_id
            if self._seam is not None:
                # a re-submission landing on a sibling shard re-binds here
                self._seam.on_bind(msg.client_key, msg.job_id)
        self._rotation.append(job_id)
        # the job record is also the client binding: it carries the key
        self._journal_append("job", {"id": job_id, "req": request_to_obj(msg)})
        log.info("client %d submitted job %d: mode=%s range=[%d, %d]%s", conn_id, job_id,
                 msg.mode.value, msg.lower, msg.upper,
                 f" workload={msg.workload}" if msg.workload else "")
        self._schedule_dispatch()

    def _rebind_job(self, job: _Job, conn_id: int) -> None:
        old = job.client_conn
        if old != UNBOUND:
            jobs = self._clients.get(old)
            if jobs is not None:
                jobs.discard(job.job_id)
        job.client_conn = conn_id
        job.unbound_since = 0.0  # bound again: out of the reaper's hands
        self._clients.setdefault(conn_id, set()).add(job.job_id)
        self._hw("sessions_high_water", len(self._clients))
        self._journal_append("bind", {"id": job.job_id})
        log.info("client %d re-bound to running job %d", conn_id, job.job_id)

    # -- the multi-process shard seam ------------------------------------

    def seam_rebind(self, ckey: str, cjid: int, origin: int, remote_conn: int):
        """Home-shard half of the rebind registry: a durable client
        re-submitted ``(ckey, cjid)`` on shard ``origin``. Returns the
        encoded durable winner (answered now over the seam), True once
        the foreign client is parked on the live job or the in-flight
        winner (the durability callback answers it), or None on a miss
        (the origin mints a job of its own)."""
        wkey = (ckey, cjid)
        winner = self._winners.get(wkey)
        if winner is not None:
            self.stats["seam_rebinds_honored"] += 1
            if winner.durable:
                return encode_msg(winner.result)
            self._remote_waiters.setdefault(wkey, []).append((origin, remote_conn))
            return True
        bound = self._bound.get(wkey)
        if bound is not None:
            job = self._jobs.get(bound)
            if job is not None and not job.done:
                self.stats["seam_rebinds_honored"] += 1
                job.unbound_since = 0.0  # waited for again: out of the reaper's hands
                self._remote_waiters.setdefault(wkey, []).append((origin, remote_conn))
                return True
        self.stats["seam_rebind_misses"] += 1
        return None

    def seam_quota_debit(self, ckey: str, delta: float) -> None:
        """Charge ``delta`` admissions a sibling shard granted ``ckey``
        to this shard's copy of its bucket, so a tenant sliced across
        shard processes spends one budget: refill to now, debit, floor
        at ``-burst``."""
        if self._quota_rate <= 0 or delta <= 0:
            return
        tier = self._tier(ckey)
        rate = self._quota_rate * tier
        burst = max(1.0, self._quota_burst * tier)
        now = self._mono()
        bucket = self._buckets.pop(ckey, None)
        if bucket is None:
            tokens, strikes = burst, 0
        else:
            tokens, last, strikes = bucket
            tokens = min(burst, tokens + max(0.0, now - last) * rate)
        tokens = max(-burst, tokens - delta)
        self._buckets[ckey] = (tokens, now, strikes)
        while len(self._buckets) > QUOTA_BUCKETS_CAP:
            self._buckets.popitem(last=False)
        self._hw("quota_buckets_high_water", len(self._buckets))
        self.stats["quota_foreign_debits"] += 1
        self._quota_dirty.add(ckey)

    # -- the park queue --------------------------------------------------

    @staticmethod
    def _park_class(msg: Request) -> str:
        """A submission's drain class: its workload, or ``"mine"``."""
        return msg.workload or "mine"

    def _park_submission(self, conn_id: int, msg: Request) -> None:
        """Park an over-quota submission (the reference's
        ``_park_submission``): a bounded FIFO a class, its oldest entry
        shed with a Refuse at overflow. Nothing is journaled or minted;
        a crash loses the queue and the client's Refuse retry covers it."""
        cls = self._park_class(msg)
        q = self._parked.get(cls)
        if q is None:
            q = self._parked[cls] = deque()
            if self._park_deficit:
                # a class joining the backlog starts at the current
                # virtual time, not at zero (it would lap the others)
                self._park_deficit.setdefault(cls, min(self._park_deficit.values()))
        if len(q) >= self._park_capacity:
            old_conn, old_msg = q.popleft()
            self.stats["parked_shed"] += 1
            self._send_refuse(old_conn, old_msg.job_id, self._retry_after_ms)
        q.append((conn_id, msg))
        self.stats["jobs_parked"] += 1
        self._hw("park_queue_high_water", sum(len(d) for d in self._parked.values()))
        self._ensure_park_ticker()

    def _ensure_park_ticker(self) -> None:
        if self._park_task is not None and not self._park_task.done():
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # no loop: the caller drains with _drain_parked()
        self._park_task = loop.create_task(self._park_ticker())

    async def _park_ticker(self) -> None:
        """Poll the park queue on a short fixed period while it holds
        entries (tokens accrue continuously), as the reference's
        ``_park_ticker``."""
        period = max(0.02, min(0.25, self._retry_after_ms / 2000.0))
        while any(self._parked.values()):
            await asyncio.sleep(period)
            self._drain_parked()

    def _drain_parked(self) -> None:
        """Drain the park queues by stride scheduling (the reference's
        ``_drain_parked``): each admission goes to the backlogged class
        with the lowest pass (drains / weight); a class whose head is
        still refused sits out the rest of this drain. Dead clients'
        entries and ones a re-submission superseded are dropped."""
        alive = set(self._server.conn_ids)
        blocked: set = set()
        while True:
            ready = [(self._park_deficit.get(c, 0.0), c) for c, q in self._parked.items()
                     if q and c not in blocked]
            if not ready:
                break
            _, cls = min(ready)
            q = self._parked[cls]
            conn_id, msg = q[0]
            if conn_id not in alive:
                q.popleft()
                continue
            if msg.client_key:
                key = (msg.client_key, msg.job_id)
                if key in self._winners or key in self._bound:
                    q.popleft()
                    continue
            if self._admit(conn_id, msg):
                blocked.add(cls)
                continue
            q.popleft()
            w = self._workload_weights.get(cls, 1.0)
            self._park_deficit[cls] = self._park_deficit.get(cls, 0.0) + 1.0 / max(w, 1e-9)
            self.stats["parked_drained"] += 1
            self.parked_drained_by_class[cls] = self.parked_drained_by_class.get(cls, 0) + 1
            self._mint_job(conn_id, msg)
        for cls in list(self._parked):
            if not self._parked[cls]:
                del self._parked[cls]
                self._park_deficit.pop(cls, None)

    # -- results ---------------------------------------------------------

    def _on_result(self, conn_id: int, msg) -> None:
        miner = self._miners.get(conn_id)
        if miner is None:
            return  # from something that never Joined
        entry = miner.chunks.pop(msg.chunk_id, None)
        if entry is None:
            # stale: it answers a dispatch already cancelled or requeued
            self._schedule_dispatch()
            return
        job_id, lo, hi, _at = entry
        self._mark_idle(miner)
        audit = self._audits.pop(msg.chunk_id, None)
        if audit is not None:
            self._settle_audit(conn_id, miner, audit, msg)
            self._schedule_dispatch()
            return
        job = self._jobs.get(job_id)
        if job is not None and not job.done:
            job.inflight.pop(msg.chunk_id, None)
            if job.request.mode == PowMode.SCRYPT or job.discipline is not None:
                # scrypt and the workload verifiers cost whole hashes or
                # whole rescans: verify on the executor, keep the job
                # open; a hedge settles now, so the loser's Result
                # already misses (a failed claim requeues the range)
                if self._hedge_after is not None:
                    self._settle_hedges(job, conn_id, lo, hi)
                job.pending_verifications += 1
                job.verifying.append((lo, hi))
                self.stats["verifications_offloaded"] += 1
                task = asyncio.ensure_future(self._settle_offloaded(conn_id, job_id, lo, hi, msg))
                self._settling.add(task)
                task.add_done_callback(self._settling.discard)
                self._schedule_dispatch()
                return
            if self._verify_result(job.request, msg):
                self._accept_result(conn_id, miner, job, msg, lo, hi)
            else:
                self._reject_result(conn_id, job, msg, lo, hi)
        self._schedule_dispatch()

    def _on_beacon(self, conn_id: int, msg: Beacon) -> None:
        """Book a progress Beacon as a partial settle: every global index
        of ``[chunk lower, high_water]`` was swept with no winner, and
        (nonce, hash) is the running minimum. The claim is host-verified
        like a Result, the prefix journaled as a settle, and the chunk
        advances in place to ``[high_water + 1, upper]`` (its fresh
        dispatch stamp tells the hedger it progresses). A Beacon never
        finishes a job."""
        miner = self._miners.get(conn_id)
        if miner is None:
            return
        entry = miner.chunks.get(msg.chunk_id)
        if entry is None or msg.chunk_id in self._audits:
            return  # stale (the chunk settled or was cancelled) or an audit
        job_id, lo, hi, _at = entry
        job = self._jobs.get(job_id)
        if job is None or job.done or not job.request.rolled or job.request.mode == PowMode.SCRYPT:
            return  # only rolled fast-dialect chunks beacon
        if msg.lease_epoch:
            return  # no chunk here is leased under an epoch: a stale lease's echo
        hw = msg.high_water
        if not lo <= hw < hi:
            return  # already settled (dup/reorder), or the Result is due
        claim = Result(job_id, job.request.mode, msg.nonce, msg.hash_value, found=False,
                       chunk_id=msg.chunk_id)
        if not self._verify_result(job.request, claim):
            log.warning("miner %d sent an unverifiable beacon for job %d (nonce=%d); ignored",
                        conn_id, job_id, msg.nonce)
            return
        searched = hw - lo + 1
        job.hashes_done += searched
        self.stats["hashes"] += searched
        self.stats["beacons_accepted"] += 1
        miner.hashes += searched
        job.fold(msg.hash_value, msg.nonce)
        self._journal_settle(job, lo, hw, claim, searched)
        miner.chunks[msg.chunk_id] = (job_id, hw + 1, hi, time.monotonic())
        job.inflight[msg.chunk_id] = (conn_id, hw + 1, hi)
        self._beacon_settled[msg.chunk_id] = self._beacon_settled.get(msg.chunk_id, 0) + searched

    async def _settle_offloaded(self, conn_id: int, job_id: int, lo: int, hi: int,
                                msg) -> None:
        """Settle one executor-verified Result; every actor is looked up
        again, since the fleet may have churned while the hash ran."""
        job = self._jobs.get(job_id)
        if job is None:
            return
        req = job.request
        if job.discipline is not None:
            # a workload verifier judges the claim against its chunk
            req = dc_replace(req, lower=lo, upper=hi)
        try:
            ok = await asyncio.get_running_loop().run_in_executor(
                None, self._verify_result, req, msg)
        except Exception:
            # the verifier itself failed: inconclusive, requeue, no strike
            log.exception("offloaded verification crashed for job %d chunk [%d, %d]",
                          job_id, lo, hi)
            job = self._jobs.get(job_id)
            if job is not None:
                self._unverify(job, lo, hi)
                if not job.done:
                    self._requeue_chunk(job, lo, hi)
                    self._schedule_dispatch()
            return
        job = self._jobs.get(job_id)
        if job is None:
            return
        self._unverify(job, lo, hi)
        if job.done:
            return
        miner = self._miners.get(conn_id)
        if ok:
            if miner is not None:
                self._accept_result(conn_id, miner, job, msg, lo, hi)
            else:
                # the prover died meanwhile; its verified work still counts
                searched = msg.searched if msg.searched > 0 else hi - lo + 1
                job.hashes_done += searched
                self.stats["hashes"] += searched
                if job.discipline is not None:
                    self._settle_work(job, msg, lo, hi, searched)
                else:
                    job.fold(msg.hash_value, msg.nonce)
                    self._journal_settle(job, lo, hi, msg, searched)
                    if msg.found and job.request.mode.targeted:
                        self._finish_job(job, found=True)
                    else:
                        self._maybe_finish_exhausted(job)
        else:
            self._reject_result(conn_id, job, msg, lo, hi)
            self._maybe_finish_exhausted(job)
        self._schedule_dispatch()

    @staticmethod
    def _unverify(job: _Job, lo: int, hi: int) -> None:
        job.pending_verifications -= 1
        try:
            job.verifying.remove((lo, hi))
        except ValueError:
            pass

    def _accept_result(self, conn_id: int, miner: _MinerState, job: _Job, msg,
                       lo: int, hi: int) -> None:
        """Book a verified chunk Result: accounting, hedge settlement,
        fold, the audit draw, completion."""
        # Beacons already booked a settled prefix; a zero ``searched``
        # books the residual range
        settled = self._beacon_settled.pop(msg.chunk_id, 0)
        searched = max(0, msg.searched - settled) if msg.searched > 0 else hi - lo + 1
        job.hashes_done += searched
        self.stats["hashes"] += searched
        self.stats["results_accepted"] += 1
        miner.hashes += searched
        miner.chunks_done += 1
        miner.refusals = 0
        miner.last_result = time.monotonic()
        if self._hedge_after is not None:
            self._settle_hedges(job, conn_id, lo, hi)
        if job.discipline is not None:
            # no audit draw: the workload verifiers recompute
            self._settle_work(job, msg, lo, hi, searched)
            return
        job.fold(msg.hash_value, msg.nonce)
        self._journal_settle(job, lo, hi, msg, searched)
        if msg.found and job.request.mode.targeted:
            self._finish_job(job, found=True)
        else:
            if self._audit_rate > 0 and self._audit_rng.random() < self._audit_rate:
                self._enqueue_audit(job, conn_id, msg, lo, hi)
            self._maybe_finish_exhausted(job)

    def _settle_work(self, job: _Job, msg, lo: int, hi: int, searched: int) -> None:
        """Book one verified workload chunk through the coverage gate (a
        duplicate delivery is a no-op, which keeps sum exactly-once),
        journal it with its payload, and finish when the fold says so.
        A ``stream`` job snapshots its fold here and releases it as an
        Emit once this settle is durable (at once without a journal),
        as the reference's ``_settle_work`` does."""
        try:
            acc = job.discipline.decode(msg.payload)
        except (ValueError, AttributeError):
            self._requeue_chunk(job, lo, hi)  # a torn buffer: never corrupt
            return
        if job.wfold(lo, hi, acc):
            on_durable = None
            if job.request.stream:
                snap = (workloads.covered_span(job.wstate),
                        job.request.upper - job.request.lower + 1,
                        job.discipline.encode(job.wacc))
                if self._journal is not None:
                    on_durable = functools.partial(self._emit_partial, job.job_id, snap)
                else:
                    self._emit_partial(job.job_id, snap)
            self._journal_settle(job, lo, hi, msg, searched, on_durable=on_durable)
        if job.discipline.is_final(job.wacc):
            self._finish_job(job, found=True)
        else:
            self._maybe_finish_exhausted(job)

    def _emit_partial(self, job_id: int, snap: Tuple[int, int, bytes]) -> None:
        """Keep the newest durable snapshot and push it as an Emit when
        the pacing interval allows (the reference's ``_emit_partial``).
        Coverage never goes back (the ``emit_covered`` floor); a
        snapshot at full coverage is dropped, since the final Result
        supersedes it; an UNBOUND job's stream waits for a re-bind."""
        job = self._jobs.get(job_id)
        if job is None or job.done:
            return
        if job.emit_snapshot is None or snap[0] > job.emit_snapshot[0]:
            job.emit_snapshot = snap
        covered, total, payload = job.emit_snapshot
        if covered >= total or covered <= job.emit_covered:
            return
        now = self._mono()
        if self._emit_interval and now - job.emit_last < self._emit_interval:
            return  # paced: the slot holds the newest snapshot
        conn = job.client_conn
        if conn == UNBOUND:
            return
        job.emit_snapshot = None
        job.emit_last = now
        job.emit_covered = covered
        seq = job.emit_seq
        job.emit_seq += 1
        try:
            self._server.write(conn, encode_msg(Emit(job.client_job_id, seq, covered, total,
                                                     payload)))
            self.stats["emits_sent"] += 1
        except ConnectionError:
            pass

    def _reject_result(self, conn_id: int, job: _Job, msg, lo: int, hi: int) -> None:
        """Drop a claim that failed verification, requeue its chunk for
        an honest worker, and evict a repeat offender."""
        log.warning("miner %d returned an unverifiable result for job %d (nonce=%d); chunk "
                    "[%d, %d] requeued", conn_id, job.job_id, getattr(msg, "nonce", -1), lo, hi)
        # beacon-settled prefixes stay settled; only [lo, hi] re-mines
        self._beacon_settled.pop(msg.chunk_id, None)
        self.stats["results_rejected"] += 1
        self._requeue_chunk(job, lo, hi)
        miner = self._miners.get(conn_id)
        if miner is None:
            return  # it died mid-verification
        miner.rejections += 1
        if miner.rejections >= MAX_REJECTIONS:
            log.warning("miner %d evicted after %d unverifiable results", conn_id,
                        miner.rejections)
            self.stats["miners_evicted"] += 1
            self._release_assignment(conn_id, miner)
            self._drop_miner(conn_id)
            self._server.close_conn(conn_id)

    def _maybe_finish_exhausted(self, job: _Job) -> None:
        """Finish a job whose whole range is settled and whose audits
        are all in."""
        if job.done or not job.exhausted:
            return
        if job.discipline is not None:
            found = job.discipline.found(job.wacc)
        else:
            found = job.request.mode == PowMode.MIN or job.best[0] <= (job.request.target or 0)
        self._finish_job(job, found=found)

    def _on_refuse(self, conn_id: int, msg: Refuse) -> None:
        """A worker could not act on a dispatch (its template cache lost
        the job): requeue it and forget the Setup, so the next dispatch
        re-ships the template."""
        miner = self._miners.get(conn_id)
        if miner is None:
            return
        entry = miner.chunks.pop(msg.chunk_id, None)
        if entry is not None:
            job = self._jobs.get(entry[0])
            if job is not None:
                job.setup_sent.discard(conn_id)
            self._release_chunk(conn_id, msg.chunk_id, entry)
            self._mark_idle(miner)
            log.info("miner %d refused chunk %d (template will be re-sent)", conn_id,
                     msg.chunk_id)
        miner.refusals += 1
        if miner.refusals >= MAX_REFUSALS:
            self._release_assignment(conn_id, miner)
            log.warning("miner %d evicted after %d consecutive refusals", conn_id,
                        miner.refusals)
            self.stats["miners_evicted"] += 1
            self._drop_miner(conn_id)
            self._server.close_conn(conn_id)
        self._schedule_dispatch()

    # -- audits ----------------------------------------------------------

    def _enqueue_audit(self, job: _Job, conn_id: int, msg, lo: int, hi: int) -> None:
        """Queue a spot-check of an accepted chunk: a random sub-range to
        be re-mined by another worker (the reference's
        ``_enqueue_audit``, drawing from the same seeded generator)."""
        sample = AUDIT_SAMPLE_SCRYPT if job.request.mode == PowMode.SCRYPT else AUDIT_SAMPLE
        size = min(sample, hi - lo + 1)
        a = lo + self._audit_rng.randrange(hi - lo + 2 - size)
        req = dc_replace(job.request, job_id=job.job_id, lower=a, upper=a + size - 1,
                         chunk_id=0)
        self._audit_queue.append(_Audit(job.job_id, conn_id, msg.hash_value, msg.found, req,
                                        (lo, hi)))
        job.pending_audits += 1

    def _assign_audit(self, miner: _MinerState, job: _Job, audit: _Audit) -> bool:
        """Book and write one audit dispatch, which a worker cannot tell
        from a chunk (the reference's ``_assign_audit``). Audits stay out
        of ``job.inflight``: ``job.pending_audits`` counts them."""
        chunk_id = self._next_chunk_id
        self._next_chunk_id += 1
        miner.chunks[chunk_id] = (job.job_id, audit.req.lower, audit.req.upper,
                                  time.monotonic())
        if not miner.has_capacity:
            self._idle.pop(miner.conn_id, None)
        self._audits[chunk_id] = audit
        try:
            self._write_dispatch(miner, job, chunk_id, audit.req.lower, audit.req.upper)
        except ConnectionError:
            miner.chunks.pop(chunk_id, None)
            self._audits.pop(chunk_id, None)
            return False
        return True

    def _settle_audit(self, auditor_conn: int, auditor: _MinerState, audit: _Audit,
                      msg) -> None:
        """Convict, acquit or retry on an audit's Result (the reference's
        ``_settle_audit``). The auditor's own claim is host-verified, so
        a lying auditor can report only real hashes of its sub-range,
        which convict rightly or acquit harmlessly. A sentinel answer
        proves nothing and is retried elsewhere, up to
        :data:`MAX_AUDIT_RETRIES` times."""
        job = self._jobs.get(audit.job_id)
        if job is not None:
            job.pending_audits -= 1
        if not self._verify_result(audit.req, msg):
            # the auditor forged its re-mine: strike it, retry elsewhere
            self.stats["results_rejected"] += 1
            auditor.rejections += 1
            if auditor.rejections >= MAX_REJECTIONS:
                log.warning("auditor %d evicted after %d unverifiable results", auditor_conn,
                            auditor.rejections)
                self._release_assignment(auditor_conn, auditor)
                self._drop_miner(auditor_conn)
                self._server.close_conn(auditor_conn)
            self._audit_queue.append(audit)
            if job is not None:
                job.pending_audits += 1
            return
        auditor.refusals = 0
        if msg.hash_value == MIN_UNTRACKED:
            audit.retries += 1
            if audit.retries <= MAX_AUDIT_RETRIES:
                self._audit_queue.append(audit)
                if job is not None:
                    job.pending_audits += 1
            else:
                self.stats["audits_inconclusive"] += 1
                log.info("audit of job %d chunk [%d, %d] inconclusive after %d sentinel answers",
                         audit.job_id, *audit.orig, audit.retries)
                if job is not None and not job.done:
                    self._maybe_finish_exhausted(job)
            return
        searched = msg.searched if msg.searched > 0 else audit.req.upper - audit.req.lower + 1
        self.stats["audits_done"] += 1
        self.stats["hashes"] += searched
        auditor.hashes += searched
        auditor.chunks_done += 1
        auditor.last_result = time.monotonic()
        mismatch = (
            # a winner the suspect's found=False denied
            (not audit.claimed_found and audit.req.mode.targeted and msg.found)
            # or a sub-range minimum under the whole-chunk claim (a
            # sentinel claim has no minimum to undercut)
            or (audit.claimed_hash != MIN_UNTRACKED and msg.hash_value < audit.claimed_hash)
        )
        if mismatch:
            self.stats["audits_failed"] += 1
            lo, hi = audit.orig
            log.warning("audit CONVICTED miner %d: chunk [%d, %d] of job %d was under-searched "
                        "(claimed %#x, sub-range [%d, %d] holds %#x); evicting and requeueing",
                        audit.suspect, lo, hi, audit.job_id, audit.claimed_hash,
                        audit.req.lower, audit.req.upper, msg.hash_value)
            suspect = self._miners.get(audit.suspect)
            if suspect is not None:
                self._release_assignment(audit.suspect, suspect)
                self._drop_miner(audit.suspect)
                self._server.close_conn(audit.suspect)
            if job is not None and not job.done:
                self._requeue_chunk(job, lo, hi)
        if job is not None and not job.done:
            if msg.found and audit.req.mode.targeted:
                job.fold(msg.hash_value, msg.nonce)  # the audit mined a winner
                self._finish_job(job, found=True)
            else:
                self._maybe_finish_exhausted(job)

    def _write_dispatch(self, miner: _MinerState, job: _Job, chunk_id: int, lo: int, hi: int,
                        roll: Optional[Tuple[int, int]] = None) -> None:
        """Ship the job's template once a worker (Setup), or a per-chunk
        window Setup for a catalog too large for one, then the chunk
        (Assign, or RollAssign for a roll-budget carve). Raises
        ConnectionError on a dead conn."""
        window = None
        if job.discipline is not None and roll is None:
            window = workloads.window_for(job.request, lo, hi)
        if window is not None:
            # LSP's ordered delivery lands the window before its Assign
            self._server.write(miner.conn_id, encode_msg(Setup(dc_replace(
                job.request, job_id=job.job_id, data=window, lower=lo, upper=hi))))
        elif miner.conn_id not in job.setup_sent:
            self._server.write(miner.conn_id,
                               encode_msg(Setup(dc_replace(job.request, job_id=job.job_id))))
            job.setup_sent.add(miner.conn_id)
        if roll is not None:
            out = RollAssign(job.job_id, chunk_id, roll[0], roll[1])
        else:
            out = Assign(job.job_id, chunk_id, lo, hi)
        self._server.write(miner.conn_id, encode_msg(out, binary=miner.binary))

    def _requeue_chunk(self, job: _Job, lo: int, hi: int) -> None:
        """Return a chunk to the front of its job's queue, unless a hedge
        copy of it (same job, same ``hi``) is still live: a third copy
        could be re-carved into pieces the hedge settle never cancels."""
        if any(entry[0] == job.job_id and entry[2] == hi and cid not in self._audits
               for m in self._miners.values() for cid, entry in m.chunks.items()):
            log.info("not requeueing [%d, %d] of job %d: a hedge copy is live", lo, hi,
                     job.job_id)
            return
        job.ranges.appendleft((lo, hi))
        if job.job_id not in self._rotation:
            self._rotation.append(job.job_id)
        self._journal_append("requeue", {"id": job.job_id, "lo": lo, "hi": hi})
        self.stats["chunks_requeued"] += 1

    @staticmethod
    def _verify_result(req: Request, msg) -> bool:
        """The host check of a chunk claim: the claimed hash must be the
        true hash of the claimed in-range nonce, and a ``found`` TARGET
        claim must beat the target; a workload claim goes to its
        workload's verifier."""
        if req.workload:
            return workloads.verify_claim(req, msg)
        if not isinstance(msg, Result):
            return False  # a WorkResult answering a mining chunk
        if not msg.found and msg.hash_value == MIN_UNTRACKED:
            # "exhausted, no winner, minimum untracked": only a targeted
            # dialect's found flag gives it content
            return req.mode.targeted
        if not req.lower <= msg.nonce <= req.upper:
            return False
        try:
            if req.mode == PowMode.MIN:
                return chain.toy_hash(req.data, msg.nonce) == msg.hash_value
            if req.rolled:
                en, nonce = chain.split_global(msg.nonce, req.nonce_bits)
                prefix = _rolled_prefix76(req.header, req.coinbase_prefix, req.coinbase_suffix,
                                          req.extranonce_size, req.branch, en)
            else:
                nonce = msg.nonce
                prefix = req.header[:76]
            powf = chain.scrypt_hash if req.mode == PowMode.SCRYPT else chain.dsha256
            h = chain.hash_to_int(powf(prefix + struct.pack("<I", nonce)))
        except (struct.error, TypeError, OverflowError, ValueError):
            return False
        if h != msg.hash_value:
            return False
        return not msg.found or h <= (req.target or 0)

    def _finish_job(self, job: _Job, *, found: bool) -> None:
        job.done = True
        wpayload = b""
        if job.discipline is not None:
            hash_value, nonce = 0, 0  # the shared finish record's placeholders
            wpayload = job.discipline.encode(job.wacc)
            result = WorkResult(job_id=job.client_job_id, chunk_id=0,
                                wid=workloads.get(job.workload).wid,
                                searched=job.hashes_done, payload=wpayload)
        else:
            hash_value, nonce = job.best
            result = Result(job.client_job_id, job.request.mode, nonce, hash_value, found,
                            searched=job.hashes_done)
        ckey = job.request.client_key
        wkey = (ckey, job.client_job_id) if ckey else None
        winner: Optional[_Winner] = None
        if ckey:
            self._winners.pop(wkey, None)
            winner = _Winner(result, durable=self._journal is None, ts=self._wall())
            self._winners[wkey] = winner
            self._hw("winners_high_water", len(self._winners))
            self._trim_winners()
        client_conn = job.client_conn
        if self._journal is not None:
            # the client hears the answer only once the finish record is
            # durable; a re-submitter meanwhile parks in winner.waiters
            rec = {
                "id": job.job_id, "ckey": ckey, "cjid": job.client_job_id,
                "mode": job.request.mode.value, "n": nonce,
                "h": f"{hash_value:x}", "found": found, "s": job.hashes_done,
                "ts": winner.ts if winner is not None else self._wall(),
            }
            if job.discipline is not None:
                rec["wid"] = workloads.get(job.workload).wid
                rec["wp"] = wpayload.hex()
            on_durable = functools.partial(self._finish_durable, client_conn, result, winner,
                                           wkey)
            if self._replica_ack:
                # and then a standby's ack past the record: the answer
                # survives the loss of this machine
                on_durable = functools.partial(self._gate_on_replicas, on_durable)
            self._journal.append("finish", rec, on_durable=on_durable)
        else:
            self._deliver_finish(client_conn, result)
            self._drain_remote_waiters(wkey, result)
        elapsed = time.monotonic() - job.started
        rate = job.hashes_done / elapsed if elapsed > 0 else 0.0
        log.info("job %d done in %.3fs: found=%s nonce=%d (%.2f MH/s across workers)",
                 job.job_id, elapsed, found, nonce, rate / 1e6)
        for conn_id, snap in self.worker_stats().items():
            log.info("  worker %d (%s): %d hashes in %d chunks, %.3f MH/s, %s", conn_id,
                     snap["backend"], snap["hashes"], snap["chunks_done"], snap["mhs"],
                     "busy" if snap["busy"] else "idle")
        self.stats["jobs_done"] += 1
        self._retire_job(job)

    def _gate_on_replicas(self, cb) -> None:
        """The finish record is fsynced (``journal.size`` covers it):
        release ``cb`` once a standby has acked past it, through the
        injected ``replica_gate`` on a multi-loop shard."""
        if self._replica_gate is not None:
            self._replica_gate(self._journal.size, cb)
            return
        gate_any(self._replicas, self._journal.size, cb)

    def _finish_durable(self, client_conn: int, result, winner: Optional[_Winner],
                        wkey: Optional[Tuple[str, int]] = None) -> None:
        """The finish record is on disk: answer the owning client, any
        re-submitter that raced the flush and any other shard process's
        client parked on this job."""
        waiters = []
        if winner is not None:
            winner.durable = True
            waiters, winner.waiters = winner.waiters, []
        self._deliver_finish(client_conn, result)
        for conn_id in waiters:
            if conn_id != client_conn:
                self._deliver_finish(conn_id, result)
        self._drain_remote_waiters(wkey, result)

    def _drain_remote_waiters(self, wkey: Optional[Tuple[str, int]], result) -> None:
        """Answer each other shard's client parked on ``wkey``: with the
        durable answer, or (``result`` None, a job retired without one)
        with a miss, so its origin mines the job itself."""
        if wkey is None:
            return
        parked = self._remote_waiters.pop(wkey, None)
        if not parked or self._seam is None:
            return
        payload = b"" if result is None else encode_msg(result)
        for origin, remote_conn in parked:
            self._seam.answer_remote(origin, remote_conn, wkey[1], payload,
                                     miss=result is None)

    def _deliver_finish(self, client_conn: int, result) -> None:
        """Send a finished job's answer; an unbound or dead client is
        answered from the winner table when it re-submits."""
        if client_conn == UNBOUND:
            return
        try:
            self._server.write(client_conn, encode_msg(result))
        except ConnectionError:
            pass

    def worker_stats(self) -> Dict[int, dict]:
        """Per-worker rate and liveness (conn_id → dict)."""
        return {m.conn_id: m.snapshot() for m in self._miners.values()}

    def _abandon_job(self, job_id: int) -> None:
        job = self._jobs.get(job_id)
        if job is None:
            return
        job.done = True
        self._journal_append("abandon", {"id": job_id})
        self._retire_job(job)

    def _retire_job(self, job: _Job) -> None:
        """Cancel a finished job's in-flight chunks (and the audits of it
        that a cancelled miner holds) and forget its queued work. A
        cancelled miner sends no Result, so it is marked idle now; a
        Result that races the Cancel no longer matches a chunk. The freed
        table slot goes to the park queue at once."""
        job.ranges.clear()
        cancelled: set = set()
        for chunk_id, (miner_conn, _lo, _hi) in list(job.inflight.items()):
            job.inflight.pop(chunk_id, None)
            self._beacon_settled.pop(chunk_id, None)
            miner = self._miners.get(miner_conn)
            if miner is not None and miner.chunks.pop(chunk_id, None) is not None:
                self._mark_idle(miner)
            if miner_conn in cancelled:
                continue  # one Cancel covers every chunk of the job
            cancelled.add(miner_conn)
            try:
                self._server.write(miner_conn, encode_msg(
                    Cancel(job.job_id), binary=miner.binary if miner is not None else False))
            except ConnectionError:
                pass
        # the job-scoped Cancel also abandons an audit of this job the
        # miner holds (the worker answers neither); the reference keeps
        # such an audit booked forever, a pipeline slot lost for good
        for miner_conn in cancelled:
            miner = self._miners.get(miner_conn)
            if miner is None:
                continue
            for cid, entry in list(miner.chunks.items()):
                if entry[0] == job.job_id and self._audits.pop(cid, None) is not None:
                    del miner.chunks[cid]
            self._mark_idle(miner)
        self._schedule_dispatch()
        try:
            self._rotation.remove(job.job_id)
        except ValueError:
            pass
        self._jobs.pop(job.job_id, None)
        if job.request.client_key:
            wkey = (job.request.client_key, job.client_job_id)
            self._bound.pop(wkey, None)
            if wkey not in self._winners:
                # retired with no winner: a foreign client parked here
                # gets a miss and its shard mines the job itself
                self._drain_remote_waiters(wkey, None)
        client_jobs = self._clients.get(job.client_conn)
        if client_jobs is not None:
            client_jobs.discard(job.job_id)
            if not client_jobs:
                self._clients.pop(job.client_conn, None)
        if any(self._parked.values()):
            self._drain_parked()

    # -- dispatch --------------------------------------------------------

    def _dispatch(self) -> None:
        """Carve chunks off the round-robin of jobs onto miners with
        pipeline room, queued audits first (their evidence goes stale as
        the fleet churns), hedges last. An audit never goes to its
        suspect, except in a one-worker fleet. A miner whose dispatch
        write fails is set aside for this pass (its loss event is
        already queued)."""
        if not self._idle:
            return
        idle: Deque[_MinerState] = deque(self._idle.values())
        self._idle.clear()
        failed: List[_MinerState] = []
        held: Deque[_Audit] = deque()
        while self._audit_queue and idle:
            audit = self._audit_queue.popleft()
            job = self._jobs.get(audit.job_id)
            if job is None or job.done:
                continue  # the job retired while queued
            auditor = next((m for m in idle if m.conn_id != audit.suspect), None)
            if auditor is None and len(self._miners) == 1:
                auditor = idle[0]  # a one-worker fleet audits itself
            if auditor is None:
                held.append(audit)  # only the suspect is idle now
                continue
            idle.remove(auditor)
            if not self._assign_audit(auditor, job, audit):
                held.append(audit)
                failed.append(auditor)
            elif auditor.has_capacity:
                idle.append(auditor)
        self._audit_queue.extendleft(reversed(held))
        skipped = 0
        while idle and self._rotation and skipped < len(self._rotation):
            job_id = self._rotation[0]
            job = self._jobs.get(job_id)
            if job is None or job.done or not job.ranges:
                self._rotation.popleft()
                continue
            miner = next((m for m in idle if m.supports(job.workload)), None)
            if miner is None:
                # nobody idle computes this workload: serve the jobs behind it
                self._rotation.rotate(-1)
                skipped += 1
                continue
            idle.remove(miner)
            skipped = 0
            lo, hi = job.ranges.popleft()
            roll = self._roll_carve(miner, job, lo, hi)
            if roll is not None:
                chunk_hi = chain.roll_span(roll[0], roll[1], job.request.nonce_bits)[1]
            else:
                take = min(hi - lo + 1, self._budget(miner, job))
                chunk_hi = lo + take - 1
            if chunk_hi < hi:
                job.ranges.appendleft((chunk_hi + 1, hi))
            if not self._assign(miner, job, lo, chunk_hi, roll=roll):
                job.ranges.appendleft((lo, chunk_hi))
                failed.append(miner)
                continue
            if miner.has_capacity:
                idle.append(miner)  # breadth-first: every miner reaches depth 1 first
            self._rotation.rotate(-1)
        if self._hedge_after is not None and idle:
            self._hedge(idle)
        for m in idle:
            self._mark_idle(m)
        for m in failed:
            self._mark_idle(m)

    def _roll_carve(self, miner: _MinerState, job: _Job, lo: int,
                    hi: int) -> Optional[Tuple[int, int]]:
        """``(extranonce0, count)`` when this dispatch can go as one
        RollAssign of whole segments, else None. Needs the dialect on
        both ends, a budget, and a segment-aligned range: a mid-segment
        remainder always falls back to an exact Assign."""
        if self._roll_budget <= 0 or not miner.roll:
            return None
        req = job.request
        if not req.rolled or req.mode == PowMode.SCRYPT:
            return None
        nb = req.nonce_bits
        if lo & ((1 << nb) - 1):
            return None  # mid-segment lo: only exact ranges are sound
        whole = (hi - lo + 1) >> nb
        if whole < 1:
            return None  # sub-segment tail: classic Assign
        # the half-job cap of _budget, in segments (at least one)
        cap = max(1, ((req.upper - req.lower + 2) // 2) >> nb)
        count = min(self._roll_budget, whole, cap, 0xFFFFFFFF)
        return lo >> nb, count

    def _budget(self, miner: _MinerState, job: _Job) -> int:
        """Nonces a dispatch to this miner for this job's dialect."""
        budget = self._chunk_size * miner.lanes
        if job.request.mode == PowMode.SCRYPT:
            budget = max(SCRYPT_MIN_CHUNK, budget // SCRYPT_CHUNK_DIVISOR)
        elif miner.span > 1:
            budget = max(budget, SPANS_PER_DISPATCH * miner.span)
            budget -= budget % miner.span  # whole spans
        # never more than half the job, so a second worker can take part
        req = job.request
        budget = min(budget, max(1, (req.upper - req.lower + 2) // 2))
        if job.request.mode != PowMode.SCRYPT and miner.span > 1:
            if budget > miner.span:
                budget -= budget % miner.span
        if job.discipline is not None:
            wcap = workloads.chunk_cap(job.request)
            if wcap:
                budget = min(budget, wcap)
        return budget

    def _assign(self, miner: _MinerState, job: _Job, lo: int, hi: int,
                roll: Optional[Tuple[int, int]] = None) -> bool:
        """Book and write one dispatch; False if the write failed. A roll
        carve goes on the wire as a RollAssign, but every book keeps
        global indices (``[lo, hi]`` is ``chain.roll_span``'s expansion)."""
        chunk_id = self._next_chunk_id
        self._next_chunk_id += 1
        pipelined = miner.busy
        miner.chunks[chunk_id] = (job.job_id, lo, hi, time.monotonic())
        if not miner.has_capacity:
            self._idle.pop(miner.conn_id, None)
        job.inflight[chunk_id] = (miner.conn_id, lo, hi)
        try:
            self._write_dispatch(miner, job, chunk_id, lo, hi, roll=roll)
        except ConnectionError:
            miner.chunks.pop(chunk_id, None)
            job.inflight.pop(chunk_id, None)
            return False
        if pipelined:
            self.stats["dispatches_pipelined"] += 1
        if roll is not None:
            self.stats["chunks_roll_dispatched"] += 1
        return True

    # -- hedging ---------------------------------------------------------

    def _hedge(self, idle: Deque[_MinerState]) -> None:
        """With nothing queued and idle room, duplicate the oldest
        in-flight chunk past ``hedge_after`` onto an idle miner (the
        reference's ``_hedge``): a different miner with an empty
        pipeline, of the straggler's size class (its budget covers the
        chunk within 4×). Copies are keyed (job_id, hi), since a
        Beacon advances a copy's lo; audits are never hedged."""
        now = time.monotonic()
        seen: Dict[Tuple[int, int], int] = {}
        for m in self._miners.values():
            for cid, (job_id, _lo, hi, _at) in m.chunks.items():
                if cid not in self._audits:
                    seen[(job_id, hi)] = seen.get((job_id, hi), 0) + 1
        candidates = sorted(
            (at, m.conn_id, job_id, lo, hi)
            for m in self._miners.values()
            for cid, (job_id, lo, hi, at) in m.chunks.items()
            if cid not in self._audits and now - at > self._hedge_after
            and seen[(job_id, hi)] == 1
        )
        for at, straggler_conn, job_id, lo, hi in candidates:
            if not idle:
                return
            job = self._jobs.get(job_id)
            if job is None or job.done:
                continue
            size = hi - lo + 1
            backup = next((m for m in idle
                           if not m.busy and m.conn_id != straggler_conn
                           and m.supports(job.workload)
                           and 4 * self._budget(m, job) >= size), None)
            if backup is None:
                continue
            idle.remove(backup)
            if self._assign(backup, job, lo, hi):
                if backup.has_capacity:
                    idle.append(backup)
                self.stats["chunks_hedged"] += 1
                log.info("hedged straggler chunk [%d, %d] of job %d (miner %d, %.1fs in flight) "
                         "onto idle miner %d", lo, hi, job_id, straggler_conn, now - at,
                         backup.conn_id)

    def _settle_hedges(self, job: _Job, winner_conn: int, lo: int, hi: int) -> None:
        """A chunk Result was accepted: release every other miner's copy
        of the range (the reference's ``_settle_hedges``). The Cancel is
        job-scoped, so the loser's other chunks of the job are released
        too (requeued, audits back to their queue); the hedged range is
        not, since the winner covers it."""
        for m in self._miners.values():
            if m.conn_id == winner_conn:
                continue
            hedged = [cid for cid, entry in m.chunks.items()
                      if cid not in self._audits and entry[0] == job.job_id and entry[2] == hi]
            if not hedged:
                continue
            for cid in hedged:
                m.chunks.pop(cid, None)
                job.inflight.pop(cid, None)
                self._beacon_settled.pop(cid, None)
            for cid, entry in list(m.chunks.items()):
                if entry[0] == job.job_id:
                    m.chunks.pop(cid, None)
                    self._release_chunk(m.conn_id, cid, entry)
            self._mark_idle(m)
            # the Cancel evicts the loser's template: re-ship it next time
            job.setup_sent.discard(m.conn_id)
            try:
                self._server.write(m.conn_id, encode_msg(Cancel(job.job_id), binary=m.binary))
            except ConnectionError:
                pass


def _parse_pairs(parser, flag: str, specs, shape: str) -> Dict[str, float]:
    """``NAME=VALUE`` items → {name: float}, parse errors as the reference's."""
    out = {}
    for spec in specs:
        name, _, value = spec.partition("=")
        if not name or not value:
            parser.error(f"{flag} wants {shape}, got {spec!r}")
        try:
            out[name] = float(value)
        except ValueError:
            parser.error(f"{flag} wants {shape}, got {spec!r}")
    return out


def main(argv: Optional[list] = None) -> None:
    """CLI: ``python -m tpuminter_torch.coordinator PORT [flags]``."""
    import argparse

    parser = argparse.ArgumentParser(description="tpuminter_torch coordinator (server role)")
    parser.add_argument("port", type=int)
    parser.add_argument("--chunk-size", type=int, default=DEFAULT_CHUNK_SIZE,
                        help=f"nonces a dispatch per advertised worker lane "
                        f"(default {DEFAULT_CHUNK_SIZE})")
    parser.add_argument(
        "--hedge-after", type=float, default=None, metavar="SECONDS",
        help="speculatively duplicate an in-flight chunk onto idle capacity after this many "
        "seconds with nothing else queued (off by default: hedged work double-counts in "
        "`searched`)")
    parser.add_argument(
        "--audit-rate", type=float, default=0.0, metavar="P",
        help="spot-check this fraction of accepted chunk Results by re-mining a small random "
        "sub-range on a different worker; a provable under-search evicts the worker and "
        "requeues its chunk (off by default: audits duplicate a little work)")
    parser.add_argument(
        "--roll-budget", type=int, default=0, metavar="N",
        help="dispatch rolled jobs to roll-dialect workers as RollAssigns of up to N whole "
        "extranonce segments, with their progress Beacons journaled as partial settles "
        "(0 = off: global-index Assigns)")
    parser.add_argument(
        "--stats-port", type=int, default=None, metavar="PORT",
        help="serve a JSON stats snapshot over HTTP on this port (0 = ephemeral, logged at "
        "startup); SIGUSR1 dumps the same snapshot to the log either way")
    parser.add_argument("--stats-interval", type=float, default=10.0, metavar="SECONDS",
                        help="period of the aggregate rate log line (default 10)")
    parser.add_argument(
        "--pipeline-depth", type=int, default=DEFAULT_PIPELINE_DEPTH, metavar="N",
        help="chunks kept outstanding per miner so a Result never round-trips before the "
        f"next chunk starts (default {DEFAULT_PIPELINE_DEPTH}; 1 = one chunk at a time)")
    parser.add_argument(
        "--codec", choices=("binary", "json"), default="binary",
        help="codec spoken to workers that advertise the binary fast path (default "
        "binary; json forces JSON everywhere; decode always takes both)")
    parser.add_argument(
        "--loops", type=int, default=1, metavar="N",
        help="shard the coordinator across N event loops, one SO_REUSEPORT socket each "
        "(tpuminter_torch.multiloop): peers are partitioned by a stable connection hash and, "
        "where the kernel allows, steered by a reuseport BPF program (default 1). N > 1 on a "
        "host that cannot shard is an ERROR, never a silent fallback")
    parser.add_argument(
        "--procs", type=int, default=1, metavar="N",
        help="shard the coordinator across N OS PROCESSES, one SO_REUSEPORT socket + private "
        "WAL segment + verifier executor each (tpuminter_torch.multiproc), past the GIL that "
        "--loops cannot reach. Shards keep exactly-once across the boundary over a local "
        "datagram seam: a cross-shard rebind registry (a re-submitted in-flight job is "
        "answered by its home shard, never re-mined) and gossiped per-tenant quota buckets "
        "(one fleet-wide budget). Default 1; exclusive with --loops; N > 1 where "
        "SO_REUSEPORT is missing is an ERROR, never a silent fallback")
    parser.add_argument(
        "--io-batch", choices=("on", "off"), default="on",
        help="batched socket I/O: drain a bounded recvfrom burst per epoll wakeup and group "
        "each tick's sends (default on; off = the stdlib asyncio transport, the A/B "
        "baseline)")
    parser.add_argument(
        "--journal-mode", choices=("writer", "segments"), default="writer",
        help="with --loops N > 1 and --journal: 'writer' keeps ONE WAL on the writer loop fed "
        "by per-shard queues (default; required for --replicate-to), 'segments' gives each "
        "loop a private WAL merged at recovery")
    parser.add_argument(
        "--journal", metavar="PATH", default=None,
        help="write-ahead job journal: every job, settle and winner is appended, and a "
        "coordinator restarted on the same file resumes the jobs and never loses an "
        "answered winner (the reference coordinator's journal format)")
    parser.add_argument(
        "--journal-flush", choices=("tick", "task"), default="tick",
        help="journal flushing: once per serve-loop burst (default) or by a separate "
        "batch-window flusher task")
    parser.add_argument(
        "--replicate-to", metavar="LIST", default=None,
        help="ship the write-ahead journal to hot standby(s) at host:port[,host:port...] "
        "(each runs `python -m tpuminter_torch.replication`); requires --journal. The "
        "standby replays the stream live, so a fenced failover is replay-free")
    parser.add_argument(
        "--quota-rate", type=float, default=0.0, metavar="R",
        help="admission control: job submissions per second each client identity may "
        "sustain (token bucket per ckey; 0 = off, the default). Over-quota submissions are "
        "answered with Refuse{retry_after_ms} instead of a job")
    parser.add_argument(
        "--quota-burst", type=int, default=8, metavar="N",
        help="token-bucket capacity: submissions a client may burst before the per-second "
        "rate applies (default 8)")
    parser.add_argument(
        "--quota-tier", action="append", default=None, metavar="NAME=MULT",
        help="priority tier: clients whose ckey starts with 'NAME:' get MULT x the quota "
        "rate and burst (repeatable, e.g. --quota-tier gold=4 --quota-tier bulk=0.25)")
    parser.add_argument(
        "--max-jobs", type=int, default=0, metavar="N",
        help="hard cap on live jobs (0 = unbounded). At the cap, a new submission LRU-sheds "
        "a zero-progress pending job back to Refuse{retry_after_ms}, or is itself refused "
        "when every job has progress")
    parser.add_argument(
        "--retry-after-ms", type=int, default=DEFAULT_RETRY_AFTER_MS, metavar="MS",
        help=f"base retry-after suggestion on capacity refusals (default "
        f"{DEFAULT_RETRY_AFTER_MS}; quota refusals compute the exact token-accrual time "
        "instead)")
    parser.add_argument(
        "--winners-ttl", type=float, default=0.0, metavar="SECONDS",
        help="age bound on the exactly-once winner/dedup table (0 = size bound only). An "
        "un-acknowledged winner is never evicted regardless")
    parser.add_argument(
        "--unbound-ttl", type=float, default=0.0, metavar="SECONDS",
        help="reap a durable client's job this long after its client vanished without "
        "re-binding (0 = keep forever); a client that returns later simply re-mines")
    parser.add_argument(
        "--park-queue", type=int, default=0, metavar="N",
        help="park up to N over-quota submissions PER workload class and drain them by "
        "weighted deficit round-robin as capacity frees, instead of refusing outright (0 = "
        "off, the refuse-only dialect). Overflow LRU-sheds the oldest parked entry with an "
        "explicit Refuse")
    parser.add_argument(
        "--workload-weight", metavar="LIST", default=None,
        help="DRR drain weights for the park queue as NAME=W[,NAME=W...], e.g. "
        "'mine=1,hashcore=1,dict=2' ('mine' is the classic mining class; unlisted classes "
        "weigh 1). Only meaningful with --park-queue")
    parser.add_argument(
        "--emit-interval", type=float, default=0.5, metavar="SECONDS",
        help="pacing of streaming Emit partials per job (clients that submit with "
        "stream=True; default 0.5, 0 = push on every durable settle)")
    parser.add_argument(
        "--replica-ack", action="store_true",
        help="with --replicate-to: hold each winner acknowledgement until a standby confirms "
        "the finish record, so an answered winner survives MACHINE loss, not just process "
        "loss (degrades loudly to local-only durability when no standby is reachable)")
    args = parser.parse_args(argv)
    if args.replicate_to is not None and args.journal is None:
        parser.error("--replicate-to requires --journal")
    if args.pipeline_depth < 1:
        parser.error("--pipeline-depth must be >= 1")
    if args.loops < 1 or args.procs < 1:
        parser.error("--loops and --procs must be >= 1")
    if args.procs > 1:
        if args.loops > 1:
            parser.error("--procs and --loops are mutually exclusive")
        if args.replicate_to:
            parser.error("--replicate-to is not available with --procs yet (per-shard "
                         "segments have no single shipping stream)")
        if args.hedge_after is not None or args.audit_rate:
            parser.error("--hedge-after/--audit-rate are not plumbed through --procs yet")
    if args.loops > 1 and args.replicate_to and args.journal_mode != "writer":
        parser.error("--replicate-to ships ONE coherent WAL stream: segmented journals cannot "
                     "ship — use --journal-mode writer")
    if args.stats_port is not None and (args.loops > 1 or args.procs > 1):
        # the endpoint serves one coordinator's snapshot; a sharded one
        # dumps its per-shard stats on SIGUSR1 instead
        parser.error("--stats-port is not available with --loops or --procs; SIGUSR1 dumps "
                     "the per-shard stats to the log instead")
    if not 0 <= args.roll_budget <= 0xFFFFFFFF:
        parser.error("--roll-budget must be in [0, 2^32-1]")
    quota_tiers = _parse_pairs(parser, "--quota-tier", args.quota_tier or (), "NAME=MULT")
    weights = _parse_pairs(parser, "--workload-weight",
                           filter(None, (args.workload_weight or "").split(",")),
                           "NAME=W[,NAME=W...]")
    try:
        replicate_to = parse_addr_list(args.replicate_to) if args.replicate_to else None
    except ValueError as exc:
        parser.error(f"--replicate-to: {exc}")
    logging.basicConfig(level=logging.INFO)

    async def _run() -> None:
        import signal

        admission = dict(
            quota_rate=args.quota_rate, quota_burst=args.quota_burst, quota_tiers=quota_tiers,
            max_jobs=args.max_jobs, retry_after_ms=args.retry_after_ms,
            winners_ttl=args.winners_ttl, unbound_ttl=args.unbound_ttl,
            workload_weights=weights, park_capacity=args.park_queue,
            emit_interval=args.emit_interval)
        loop = asyncio.get_running_loop()
        if args.procs > 1:
            from tpuminter_torch.multiproc import MultiProcCoordinator

            coord = await MultiProcCoordinator.create(
                args.port, procs=args.procs, chunk_size=args.chunk_size,
                stats_interval=args.stats_interval, recover_from=args.journal,
                pipeline_depth=args.pipeline_depth, binary_codec=args.codec == "binary",
                io_batch=args.io_batch == "on", roll_budget=args.roll_budget, **admission)
            log.info("coordinator listening on port %d (%d shard processes)", coord.port,
                     args.procs)

            async def _dump_proc_stats() -> None:
                log.info("stats: %s", json.dumps(await coord.stats_all()))

            loop.add_signal_handler(signal.SIGUSR1,
                                    lambda: asyncio.ensure_future(_dump_proc_stats()))
            # SIGTERM/SIGINT run the graceful group stop: a parent dying
            # uncleanly would orphan the shard processes
            stop = asyncio.Event()
            for signum in (signal.SIGINT, signal.SIGTERM):
                loop.add_signal_handler(signum, stop.set)
            try:
                # the parent only supervises; a dead shard takes the group
                # down loudly, since its peers are steered to it by conn id
                while all(coord.alive()) and not stop.is_set():
                    try:
                        await asyncio.wait_for(stop.wait(), 1.0)
                    except asyncio.TimeoutError:
                        pass
                if not stop.is_set():
                    log.error("shard process died (alive=%s); stopping the group",
                              coord.alive())
            finally:
                await coord.close()
            return
        if args.loops > 1:
            from tpuminter_torch.multiloop import MultiLoopCoordinator

            coord = await MultiLoopCoordinator.create(
                args.port, loops=args.loops, chunk_size=args.chunk_size,
                hedge_after=args.hedge_after, audit_rate=args.audit_rate,
                stats_interval=args.stats_interval, recover_from=args.journal,
                journal_mode=args.journal_mode, pipeline_depth=args.pipeline_depth,
                binary_codec=args.codec == "binary",
                journal_tick_flush=args.journal_flush == "tick", replicate_to=replicate_to,
                replica_ack=args.replica_ack, io_batch=args.io_batch == "on",
                roll_budget=args.roll_budget, **admission)
            log.info("coordinator listening on port %d (%d loops)", coord.port, args.loops)
            loop.add_signal_handler(signal.SIGUSR1, lambda: log.info("stats: %s", json.dumps(
                {"stats": coord.stats, "shards": coord.shard_metrics()})))
            await coord.serve()
            return
        coord = await Coordinator.create(
            args.port, chunk_size=args.chunk_size, hedge_after=args.hedge_after,
            audit_rate=args.audit_rate, stats_interval=args.stats_interval,
            recover_from=args.journal, pipeline_depth=args.pipeline_depth,
            binary_codec=args.codec == "binary",
            journal_tick_flush=args.journal_flush == "tick", roll_budget=args.roll_budget,
            replicate_to=replicate_to, replica_ack=args.replica_ack,
            io_batch=args.io_batch == "on", **admission)
        log.info("coordinator listening on port %d", coord.port)
        if args.stats_port is not None:
            await coord.start_stats_server(args.stats_port)
        loop.add_signal_handler(
            signal.SIGUSR1, lambda: log.info("stats: %s", json.dumps(coord.stats_snapshot())))
        await coord.serve()

    asyncio.run(_run())


if __name__ == "__main__":
    main()
