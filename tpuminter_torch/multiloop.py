"""Multi-loop sharded coordinator: N coordinator shards on N event
loops, one ``SO_REUSEPORT`` socket each on one UDP port, peers split by
a stable hash of their address. Counterpart of ``tpuminter.multiloop``.

Each shard is a whole :class:`~tpuminter_torch.coordinator.Coordinator`
with its own :class:`~tpuminter_torch.lsp.LspServer` and its own event
loop on its own thread, its socket bound to the shared port.

**Partitioning.** A peer belongs to shard :func:`shard_of` —
``crc32(host:port) % loops`` — from its first datagram on, whatever the
arrival order, the epoch or the redial. Steering works at two levels:

- **in the kernel** (:func:`attach_conn_steering`): shard *k* allocates
  LSP conn ids ≡ *k* (mod N) (``LspServer.conn_id_stride``), and a
  classic-BPF ``SO_ATTACH_REUSEPORT_CBPF`` program, whose data window
  for UDP is the datagram's payload (the LSP frame), reads the frame's
  little-endian ``conn_id`` (wire bytes 1–4) and returns ``conn_id %
  N``. Every datagram of an established connection goes straight to
  its owning loop. A ``CONNECT`` carries conn id 0 and lands on shard
  0, which forwards it once to the :func:`shard_of` owner, whose conn
  id then makes the kernel agree with the hash for the connection's
  life;
- **in user space** (:class:`_Handoff`): each shard's ingress filter
  checks ``shard_of(addr)``, and a datagram the kernel delivered to
  the wrong loop (a CONNECT, a race before steering, or every datagram
  where the attach failed) goes to its owner's queue, drained with one
  ``call_soon_threadsafe`` a burst. Replies leave through the owner's
  socket, on the same port, so a peer cannot tell the shards apart.

**Shard affinity.** A job lives on the shard of its client's
connection and dispatches only to that shard's miners: a shard with
clients and no miner logs and waits. Job ids are striped (shard *k*
allocates ids ≡ *k*+1 mod N, ``Coordinator.job_id_stride``), so the
journal re-partitions at recovery by :func:`shard_for_job`.

**The journal seam**, the one place shards couple, has two modes:

- ``journal_mode="writer"`` (the default, and the only one that can
  replicate, since a standby follows one WAL stream): one real
  :class:`~tpuminter_torch.journal.Journal` lives on shard 0's loop,
  and the other shards append through a :class:`_JournalProxy` that
  batches a serve tick's records into one ``call_soon_threadsafe``;
  durability callbacks bounce back to the shard's loop the same way.
  The flusher's own compaction is off (a shard's snapshot describes one
  shard); instead the writer loop polls the WAL's growth and compacts
  it in a brief stop-the-world barrier (:meth:`MultiLoopCoordinator.
  _compact_stw`). Replica-ack gates route to the writer loop's lanes.
- ``journal_mode="segments"``: each shard owns a WAL of its own at
  ``path.s<k>``, with no cross-loop traffic and per-segment compaction.
  It cannot ship to a standby.

Recovery merges whatever is on disk (a base file, segments, from any
earlier loop count or mode), writes it anew in the new layout, fsyncs,
and only then deletes what it superseded: a crash mid-start recovers
the old layout or the new one. Recovered jobs land on
``shard_for_job(job_id)``; the acknowledged-winner table is copied into
every shard, so a durable client re-submitting an answered request is
answered once whichever shard its new connection hashes to.

The known waste of this in-process seam, as in the reference: an
in-flight job's ``_bound`` entry lives only on its home shard, so a
client redialing from a new port after a crash hashes elsewhere with
probability (N−1)/N and starts a fresh job there, while the recovered
copy re-mines at home. Exactly-once holds (the fresh job answers; the
home copy's winner stays in the dedup table). The multi-process seam
(:mod:`tpuminter_torch.multiproc`) closes it with a rebind registry.
"""

from __future__ import annotations

import asyncio
import ctypes
import logging
import os
import random
import socket as _socket
import struct
import sys
import threading
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from tpuminter_torch.analysis import affinity
from tpuminter_torch.journal import (
    BATCH_WINDOW_S,
    Journal,
    RecoveredState,
    merge_states,
    replay,
    scan_file,
    segment_paths,
)
from tpuminter_torch.lsp import LspServer, Params
from tpuminter_torch.lsp.params import FAST
from tpuminter_torch.lsp.transport import Addr

__all__ = [
    "MultiLoopCoordinator",
    "shard_of",
    "shard_for_job",
    "attach_conn_steering",
]

log = logging.getLogger("tpuminter_torch.multiloop")

#: ``setsockopt`` level constant (Linux); attach failure anywhere just
#: means the userspace shim carries the steering load.
SO_ATTACH_REUSEPORT_CBPF = 51


# ---------------------------------------------------------------------------
# the partition function (pure)
# ---------------------------------------------------------------------------

def shard_of(addr: Addr, loops: int) -> int:
    """Stable peer→shard assignment: a pure hash of the peer's address.

    Independent of arrival order, epochs, and everything else — the same
    address always maps to the same shard, on every shard (no shard ever
    needs another's opinion to route a datagram). CRC32 is uniform
    enough over (host, port) that balance follows from the hash
    (property-pinned with binomial bounds in tests)."""
    if loops <= 1:
        return 0
    host, port = addr[0], addr[1]
    return zlib.crc32(b"%s:%d" % (host.encode(), port)) % loops


def shard_for_job(job_id: int, loops: int) -> int:
    """Home shard of a (recovered) job: shard *k* allocates job ids
    ≡ *k*+1 (mod loops) (``Coordinator.job_id_start/stride``), so ids
    re-partition without any table."""
    if loops <= 1:
        return 0
    return (job_id - 1) % loops


# ---------------------------------------------------------------------------
# kernel steering: the SO_ATTACH_REUSEPORT_CBPF program
# ---------------------------------------------------------------------------

def _cbpf_conn_steering(loops: int) -> bytes:
    """Classic-BPF: return ``conn_id % loops`` where conn_id is the LSP
    frame header's little-endian u32 at wire bytes 1–4 (the cBPF data
    window for UDP reuseport selection is the datagram payload). ABS
    byte loads + shifts assemble the LE value (cBPF word loads are
    big-endian); an undersized datagram aborts the filter → returns 0 →
    shard 0 drops the garbage like anyone else."""
    BPF_LDB, BPF_LSH, BPF_TAX, BPF_OR_X = 0x30, 0x64, 0x07, 0x4C
    BPF_MOD_K, BPF_RET_A = 0x94, 0x16
    insns = [(BPF_LDB, 0, 0, 4)]          # A = byte 4 (MSB of LE u32)
    for off in (3, 2, 1):
        insns += [
            (BPF_LSH, 0, 0, 8),
            (BPF_TAX, 0, 0, 0),
            (BPF_LDB, 0, 0, off),
            (BPF_OR_X, 0, 0, 0),
        ]
    insns += [(BPF_MOD_K, 0, 0, loops), (BPF_RET_A, 0, 0, 0)]
    return b"".join(struct.pack("HBBI", *i) for i in insns)


def attach_conn_steering(sock: Optional[_socket.socket], loops: int) -> bool:
    """Attach the conn-id steering program to the reuseport group (via
    any member socket). True on success; False means the kernel keeps
    its own 4-tuple hash and the userspace shim forwards mismatches —
    correct either way."""
    if sock is None or loops < 2 or not sys.platform.startswith("linux"):
        return False
    code = _cbpf_conn_steering(loops)
    buf = ctypes.create_string_buffer(code, len(code))
    prog = struct.pack("HP", len(code) // 8, ctypes.addressof(buf))
    try:
        sock.setsockopt(_socket.SOL_SOCKET, SO_ATTACH_REUSEPORT_CBPF, prog)
    except OSError:
        return False
    return True


# ---------------------------------------------------------------------------
# cross-loop datagram handoff (the userspace rehash shim's delivery half)
# ---------------------------------------------------------------------------

class _Handoff:
    """Datagrams for one target shard, pushed from any thread, drained
    on the owner's loop with one wakeup per burst. Safe under the GIL:
    ``deque.append``/``popleft`` are atomic, and the scheduled-flag race
    only ever costs a redundant wakeup or defers an item to the next
    push — never loses one (the drain clears the flag BEFORE popping,
    so an append that saw the stale flag is popped by the same drain)."""

    __slots__ = ("_q", "_loop", "_deliver", "_scheduled", "pushed")

    def __init__(self) -> None:
        self._q: deque = deque()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._deliver: Optional[Callable[[bytes, Addr], None]] = None
        self._scheduled = False
        self.pushed = 0

    def bind(self, loop, deliver) -> None:
        """Owner shard came up: start draining (anything queued while it
        was still booting — e.g. redialing peers racing a crash-drill
        restart — flushes now)."""
        self._loop = loop
        self._deliver = deliver
        if self._q:
            self._schedule()

    def push(self, data: bytes, addr: Addr) -> None:
        self.pushed += 1
        self._q.append((data, addr))
        if self._loop is not None and not self._scheduled:
            self._schedule()

    def _schedule(self) -> None:
        self._scheduled = True
        try:
            self._loop.call_soon_threadsafe(self._drain)
        except RuntimeError:
            self._scheduled = False  # owner loop is gone (shutdown)

    def _drain(self) -> None:
        self._scheduled = False
        deliver = self._deliver
        while True:
            try:
                data, addr = self._q.popleft()
            except IndexError:
                return
            deliver(data, addr)


# ---------------------------------------------------------------------------
# the journal seam, writer mode: per-shard forwarding proxy
# ---------------------------------------------------------------------------

class _JournalProxy:
    """Coordinator-facing facade over the single writer-loop
    :class:`~tpuminter_torch.journal.Journal`. Appends buffer locally (on the
    shard's loop, no locks) and travel to the writer loop as ONE
    ``call_soon_threadsafe`` per serve tick — the same coalescing move
    as the flusher itself, so sharding adds one thread hop per shard
    per tick, not per record. ``on_durable`` callbacks are bounced back
    to the originating shard's loop before they touch its server.

    ``snapshot_provider`` is absorbed (never installed on the real
    journal): a shard-local snapshot describes one shard, and compacting
    the shared WAL with it would delete the other shards' records —
    the flush-loop's own compaction is disabled by construction.
    Writer-mode compaction instead runs as a brief stop-the-world
    barrier (:meth:`MultiLoopCoordinator._compact_stw`): every shard freezes, forwards its pending tail, and
    contributes its absorbed provider's snapshot; the writer merges
    them and swaps the file synchronously."""

    def __init__(
        self, journal: Journal, writer_loop: asyncio.AbstractEventLoop
    ) -> None:
        self._journal = journal
        self._writer_loop = writer_loop
        self._shard_loop = asyncio.get_running_loop()
        self._pending: List[Tuple[object, Optional[Callable]]] = []
        self._timer_armed = False
        #: absorbed Coordinator-installed attributes (see class doc)
        self.snapshot_provider = None
        self.tick_flush = True

    # -- journal API used by Coordinator ---------------------------------

    @property
    def size(self) -> int:
        return self._journal.size

    @property
    def generation(self) -> int:
        return self._journal.generation

    @property
    def boot_epoch(self) -> int:
        return self._journal.boot_epoch

    @property
    def stats(self) -> dict:
        return self._journal.stats

    def append(self, kind, obj=None, *, on_durable=None) -> None:
        rec = dict(obj or {})
        rec["k"] = kind
        if on_durable is not None:
            on_durable = self._bounce(on_durable)
        self._pending.append((rec, on_durable))
        self._arm()

    def append_encoded(self, payload: bytes) -> None:
        self._pending.append((payload, None))
        self._arm()

    def flush_tick(self) -> None:
        """Serve-tick hook: ship this tick's records to the writer loop
        (one thread hop for the whole batch)."""
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        if self._writer_loop is self._shard_loop:
            self._apply(batch)
            return
        try:
            self._writer_loop.call_soon_threadsafe(self._apply, batch)
        except RuntimeError:
            # writer loop already gone (shutdown race): durability is
            # lost for this tail, but gated replies must never wedge
            for _rec, cb in batch:
                if cb is not None:
                    cb()

    def crash(self) -> None:
        """The real journal is crashed once by the supervisor (writer
        loop); a shard-local crash only drops its un-forwarded tail —
        exactly the record-tail loss semantics of a real kill -9."""
        self._pending.clear()

    async def aclose(self) -> None:
        self.flush_tick()

    # -- internals -------------------------------------------------------

    def _bounce(self, cb: Callable[[], None]) -> Callable[[], None]:
        shard_loop = self._shard_loop

        def fire() -> None:  # runs on the writer loop (journal flusher)
            try:
                shard_loop.call_soon_threadsafe(cb)
            except RuntimeError:
                pass  # shard loop gone; nothing left to reply to

        return fire

    def _arm(self) -> None:
        """Backstop timer for appends outside serve ticks (offloaded
        verification settles), mirroring Journal's own tick fallback."""
        if not self._timer_armed:
            self._timer_armed = True
            self._shard_loop.call_later(BATCH_WINDOW_S, self._timer_fire)

    def _timer_fire(self) -> None:
        self._timer_armed = False
        self.flush_tick()

    def _apply(self, batch) -> None:  # runs on the writer loop
        j = self._journal
        for rec, cb in batch:
            if isinstance(rec, (bytes, bytearray)):
                j.append_encoded(rec)
            else:
                j.append(rec.pop("k"), rec, on_durable=cb)
        if j.tick_flush:
            j.flush_tick()


def _merge_snapshot_objs(snaps: List[dict]) -> dict:
    """Union per-shard snapshot records into the one the shared WAL
    compacts to. Jobs are shard-affine (disjoint id lanes) so the job
    lists concatenate; winners replicate to every shard at recovery, so
    the union is keyed and last-writer-wins (any shard's copy of an
    acknowledged winner is authoritative — they are immutable)."""
    out: dict = {"k": "snapshot", "next": 1, "jobs": [], "winners": []}
    winners: Dict[Tuple[str, int], list] = {}
    leases: List[dict] = []
    for snap in snaps:
        out["next"] = max(out["next"], int(snap.get("next", 1)))
        out["jobs"].extend(snap.get("jobs", []))
        for ck, cj, w in snap.get("winners", []):
            winners[(ck, cj)] = [ck, cj, w]
        leases.extend(snap.get("leases", []))
    out["winners"] = list(winners.values())
    if leases:
        out["leases"] = leases
    return out


class _AggJournalView:
    """Read-only aggregate over per-segment journals (segments mode) so
    harness code that reads ``coord._journal.stats``/``.size`` works on
    either journal layout."""

    def __init__(self, journals: List[Journal]) -> None:
        self._journals = journals

    @property
    def size(self) -> int:
        return sum(j.size for j in self._journals)

    @property
    def stats(self) -> dict:
        out: Dict[str, int] = {}
        for j in self._journals:
            for k, v in j.stats.items():
                out[k] = out.get(k, 0) + v
        return out


# ---------------------------------------------------------------------------
# the sharded coordinator
# ---------------------------------------------------------------------------

class _Shard:
    """One event loop's worth of coordinator (thread-confined state)."""

    def __init__(self, index: int) -> None:
        self.index = index
        self.thread: Optional[threading.Thread] = None
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self.server: Optional[LspServer] = None
        self.coordinator = None
        self.lanes: list = []            # shard 0: replication primaries
        self.stop: Optional[asyncio.Event] = None
        self.stop_mode = "close"
        self.error: Optional[BaseException] = None
        self.recovered: Optional[RecoveredState] = None
        self.journal = None              # proxy (writer) or Journal (segments)
        self.forwarded = 0               # datagrams this shard handed off
        self.max_stall = 0.0


class MultiLoopCoordinator:
    """N coordinator shards behind one UDP port. Use :meth:`create`.

    The surface mirrors :class:`~tpuminter_torch.coordinator.Coordinator`
    where the harnesses need it (``port``, ``serve``, ``crash``,
    ``close``, ``stats``, ``_next_chunk_id``, ``_jobs``,
    ``_winners``, ``_miners``, ``_journal``), with aggregate semantics —
    plus per-shard introspection (:meth:`shard_metrics`)."""

    def __init__(self) -> None:
        self.loops = 0
        self.steer_kernel = False
        self._shards: List[_Shard] = []
        self._handoffs: List[_Handoff] = []
        self._host = "127.0.0.1"
        self._port = 0
        self._mode = "writer"
        self._journal_real: Optional[Journal] = None
        self._seg_journals: List[Journal] = []
        self._failure: Optional[asyncio.Event] = None
        self._owner_loop: Optional[asyncio.AbstractEventLoop] = None
        self._closed = False

    # -- construction ----------------------------------------------------

    @classmethod
    async def create(
        cls,
        port: int = 0,
        *,
        loops: int = 2,
        params: Optional[Params] = None,
        host: str = "127.0.0.1",
        chunk_size: Optional[int] = None,
        hedge_after: Optional[float] = None,
        audit_rate: float = 0.0,
        stats_interval: float = 10.0,
        recover_from: Optional[str] = None,
        journal_mode: str = "writer",
        pipeline_depth: Optional[int] = None,
        binary_codec: bool = True,
        journal_tick_flush: bool = True,
        replicate_to: Optional[List[Tuple[str, int]]] = None,
        replica_ack: bool = False,
        io_batch: Optional[bool] = None,
        quota_rate: float = 0.0,
        quota_burst: int = 8,
        quota_tiers: Optional[dict] = None,
        max_jobs: int = 0,
        retry_after_ms: Optional[int] = None,
        winners_cap: Optional[int] = None,
        winners_ttl: float = 0.0,
        unbound_ttl: float = 0.0,
        roll_budget: int = 0,
        workload_weights: Optional[dict] = None,
        park_capacity: int = 0,
        emit_interval: float = 0.5,
        compact_bytes: Optional[int] = None,
    ) -> "MultiLoopCoordinator":
        if loops < 1:
            raise ValueError("loops must be >= 1")
        # loops == 1 is a legitimate explicit config — ONE shard on its
        # own thread, no steering — and the baseline that tells the
        # partitioning seam's cost from that of running the coordinator
        # off the caller's loop
        if journal_mode not in ("writer", "segments"):
            raise ValueError(f"unknown journal_mode {journal_mode!r}")
        if replicate_to and recover_from is None:
            raise ValueError("replicate_to requires a journal (recover_from)")
        if replicate_to and journal_mode != "writer":
            raise ValueError(
                "replication ships ONE coherent WAL stream: segmented "
                "journals cannot ship — use journal_mode='writer'"
            )
        if not hasattr(_socket, "SO_REUSEPORT"):
            # a host that cannot shard must say so, never silently run
            # on one loop
            raise RuntimeError(
                "multi-loop coordinator needs SO_REUSEPORT, which this "
                "platform does not expose"
            )
        self = cls()
        self.loops = loops
        self._host = host
        self._mode = journal_mode
        self._owner_loop = asyncio.get_running_loop()
        self._failure = asyncio.Event()

        # -- merged recovery + journal layout rewrite (startup, sync) ---
        merged: Optional[RecoveredState] = None
        epoch: Optional[int] = None
        if recover_from is not None:
            files = []
            if os.path.exists(recover_from):
                files.append(recover_from)
            segs = segment_paths(recover_from)
            states = [replay(scan_file(p)) for p in files + segs]
            merged = merge_states(states) if states else RecoveredState()
            epoch = merged.boot_epoch + 1
            jkw = (
                {} if compact_bytes is None
                else {"compact_bytes": compact_bytes}
            )
            if journal_mode == "writer":
                snap = merged.snapshot_obj() if merged.records else None
                self._journal_real = Journal.fresh(
                    recover_from, epoch, snap, **jkw
                )
                self._journal_real.tick_flush = journal_tick_flush
                for p in segs:
                    _unlink(p)
            else:
                for k in range(loops):
                    jobs_k = {
                        jid: j for jid, j in merged.jobs.items()
                        if shard_for_job(jid, loops) == k
                    }
                    snap_k = None
                    if merged.records:
                        part = RecoveredState(
                            next_job_id=merged.next_job_id,
                            jobs=jobs_k, winners=merged.winners,
                        )
                        snap_k = part.snapshot_obj()
                    self._seg_journals.append(Journal.fresh(
                        f"{recover_from}.s{k}", epoch, snap_k, **jkw
                    ))
                    self._seg_journals[-1].tick_flush = journal_tick_flush
                _unlink(recover_from)
                for p in segs:
                    if p not in {f"{recover_from}.s{k}" for k in range(loops)}:
                        _unlink(p)
        else:
            # no journal: one shared random boot epoch — every shard of
            # this incarnation must advertise the same identity
            epoch = random.getrandbits(63) | 1

        # -- shards ------------------------------------------------------
        self._handoffs = [_Handoff() for _ in range(loops)]
        params = params or FAST
        coord_kwargs = dict(
            hedge_after=hedge_after, audit_rate=audit_rate,
            stats_interval=stats_interval,
            binary_codec=binary_codec, journal_tick_flush=journal_tick_flush,
            # admission and bounded state: quota accounting is
            # SHARD-AFFINE by design — a peer is steered to one shard by
            # its stable address hash, so its token bucket lives (only)
            # where its submissions land; per-shard caps mean the
            # aggregate bound is cap × loops. A redialed client may land
            # on a different shard with a fresh bucket — the quota leak
            # is one burst per redial, the price of zero cross-shard
            # coordination on the admission hot path (same trade the
            # dedup table made the other way: winners replicate to every
            # shard at recovery because correctness needs them).
            quota_rate=quota_rate, quota_burst=quota_burst,
            quota_tiers=quota_tiers, max_jobs=max_jobs,
            winners_ttl=winners_ttl, unbound_ttl=unbound_ttl,
            # roll-budget carving is shard-local like every other
            # dispatch decision: a rolled job lives on one shard
            roll_budget=roll_budget,
            # the park queue is shard-local
            # like the quota buckets it extends — a peer's submissions
            # park where its address hash steers them
            workload_weights=workload_weights, park_capacity=park_capacity,
            emit_interval=emit_interval,
        )
        if retry_after_ms is not None:
            coord_kwargs["retry_after_ms"] = retry_after_ms
        if winners_cap is not None:
            coord_kwargs["winners_cap"] = winners_cap
        if chunk_size is not None:
            coord_kwargs["chunk_size"] = chunk_size
        if pipeline_depth is not None:
            coord_kwargs["pipeline_depth"] = pipeline_depth
        bound_port = port
        for k in range(loops):
            shard = _Shard(k)
            if merged is not None:
                jobs_k = {
                    jid: j for jid, j in merged.jobs.items()
                    if shard_for_job(jid, loops) == k
                }
                shard.recovered = RecoveredState(
                    boot_epoch=epoch, next_job_id=merged.next_job_id,
                    jobs=jobs_k, winners=merged.winners.copy(),
                )
            ready = threading.Event()
            shard.thread = threading.Thread(
                target=self._shard_thread,
                args=(shard, ready, bound_port, epoch, params,
                      coord_kwargs, replicate_to, replica_ack, io_batch),
                name=f"tpuminter-loop-{k}",
                daemon=True,
            )
            self._shards.append(shard)
            shard.thread.start()
            ok = await asyncio.get_running_loop().run_in_executor(
                None, ready.wait, 30.0
            )
            if not ok and shard.error is None:
                shard.error = RuntimeError(
                    f"shard {k} did not come up within 30 s"
                )
            if shard.error is not None:
                await self._teardown_after_failure()
                raise shard.error
            if k == 0:
                bound_port = self._port = shard.server.endpoint.local_addr[1]
                # kernel steering: make reuseport delivery agree with
                # the conn-id stride before the sibling sockets join
                self.steer_kernel = attach_conn_steering(
                    shard.server.endpoint.sock, loops
                )
        log.info(
            "multi-loop coordinator up: %d loops on port %d "
            "(journal=%s, kernel steering %s)",
            loops, self._port, journal_mode if recover_from else "off",
            "ON" if self.steer_kernel else "off (userspace shim)",
        )
        return self

    def _shard_thread(
        self, shard: _Shard, ready: threading.Event, port: int,
        epoch: int, params: Params, coord_kwargs: dict,
        replicate_to, replica_ack: bool, io_batch,
    ) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(self._shard_main(
                shard, ready, port, epoch, params, coord_kwargs,
                replicate_to, replica_ack, io_batch,
            ))
        except BaseException as exc:  # pragma: no cover - belt+braces
            shard.error = shard.error or exc
        finally:
            ready.set()
            try:
                # reap stragglers (journal flusher, ack timers) so the
                # loop closes clean — a crash-mode exit leaves them
                pending = asyncio.all_tasks(loop)
                for task in pending:
                    task.cancel()
                if pending:
                    loop.run_until_complete(asyncio.gather(
                        *pending, return_exceptions=True
                    ))
            except Exception:
                pass
            try:
                loop.close()
            except Exception:
                pass

    async def _shard_main(
        self, shard: _Shard, ready: threading.Event, port: int,
        epoch: int, params: Params, coord_kwargs: dict,
        replicate_to, replica_ack: bool, io_batch,
    ) -> None:
        k, loops = shard.index, self.loops
        handoffs = self._handoffs

        def ingress(data: bytes, addr: Addr) -> bool:
            owner = shard_of(addr, loops)
            if owner == k:
                return True
            shard.forwarded += 1
            handoffs[owner].push(data, addr)
            return False

        try:
            server = await LspServer.create(
                port, params, host=self._host, boot_epoch=epoch,
                reuse_port=True, io_batch=io_batch,
                conn_id_start=(k or loops), conn_id_stride=loops,
                ingress_filter=ingress,
            )
        except BaseException as exc:
            shard.error = exc
            return
        shard.loop = asyncio.get_running_loop()
        shard.server = server
        shard.stop = asyncio.Event()
        try:
            await self._shard_body(
                shard, ready, params, coord_kwargs, replicate_to,
                replica_ack,
            )
        except BaseException as exc:
            # a failed shard must not leak its REUSEPORT socket (the
            # group's indices shift on close — but a dead shard's
            # group is being torn down wholesale anyway)
            if shard.error is None and not isinstance(
                exc, asyncio.CancelledError
            ):
                shard.error = exc
            server.crash()
            raise

    async def _shard_body(
        self, shard: _Shard, ready: threading.Event, params: Params,
        coord_kwargs: dict, replicate_to, replica_ack: bool,
    ) -> None:
        from tpuminter_torch.coordinator import Coordinator

        k = shard.index
        server = shard.server
        handoffs = self._handoffs
        journal = None
        replica_gate = None
        if self._journal_real is not None:
            # the writer loop is shard 0's own loop (set before shard 0
            # reports ready, so later shards always see it)
            writer_loop = shard.loop if k == 0 else self._shards[0].loop
            journal = _JournalProxy(self._journal_real, writer_loop)
            shard.journal = journal
            if k == 0:
                # ownership handover: the control loop opened/replayed
                # the journal in create(); from here on shard 0's loop
                # is its home (the affinity detector's sanctioned seam)
                affinity.rebind(self._journal_real)
        elif self._seg_journals:
            journal = self._seg_journals[k]
            shard.journal = journal
            affinity.rebind(journal)  # created in create(), homed here
        if k == 0 and replicate_to:
            from tpuminter_torch.replication import ReplicationPrimary

            shard.lanes = [
                ReplicationPrimary(
                    self._journal_real, h, p, params=params
                )
                for h, p in replicate_to
            ]
            for lane in shard.lanes:
                lane.start()
        if replica_ack and replicate_to:
            replica_gate = self._make_replica_gate(shard)
        coordinator = Coordinator(
            server, journal=journal, replica_ack=replica_ack,
            replica_gate=replica_gate,
            job_id_start=k + 1, job_id_stride=self.loops,
            **coord_kwargs,
        )
        shard.coordinator = coordinator
        if shard.recovered is not None:
            coordinator.adopt_recovered(shard.recovered)
        handoffs[k].bind(shard.loop, server.deliver_datagram)
        ready.set()
        serve = asyncio.ensure_future(coordinator.serve())
        sampler = asyncio.ensure_future(self._stall_sampler(shard))
        stop_wait = asyncio.ensure_future(shard.stop.wait())
        tasks = [sampler, stop_wait, serve]
        if k == 0 and self._journal_real is not None:
            # writer-mode live compaction: the flush-loop path is
            # disabled by construction (see _JournalProxy), so the writer
            # shard polls the growth threshold and runs the
            # stop-the-world barrier instead
            tasks.append(asyncio.ensure_future(self._compaction_ticker()))
        try:
            done, _pending = await asyncio.wait(
                {serve, stop_wait}, return_when=asyncio.FIRST_COMPLETED
            )
            if serve in done and not shard.stop.is_set():
                shard.error = serve.exception() or RuntimeError(
                    f"shard {k} serve loop exited unexpectedly"
                )
                self._signal_failure()
        finally:
            for task in tasks:
                task.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            if shard.stop_mode == "close":
                for lane in shard.lanes:
                    await lane.stop()
                await coordinator.close()
                if k == 0 and self._journal_real is not None:
                    await self._journal_real.aclose()
            # crash mode: the supervisor already ran the kill -9 seams

    async def _compaction_ticker(self) -> None:
        """Writer-loop poll for WAL growth past the compaction
        threshold (writer mode only; segment journals compact
        themselves through the normal flush-loop path). The quarter-
        second grain bounds how far past the threshold the file can
        run between checks without taxing the loop it shares."""
        j = self._journal_real
        while True:
            await asyncio.sleep(0.25)
            if j._closed or j._crashed or j._failed:
                return
            if j._bytes_since_compact <= j._compact_bytes:
                continue
            try:
                await self._compact_stw()
            except Exception:
                log.exception("stop-the-world WAL compaction failed")

    async def _compact_stw(self) -> None:
        """Stop-the-world live compaction of the shared writer-mode WAL
        (without it the shared WAL would compact only at a restart).

        Barrier protocol, from the writer loop: each non-writer shard
        is frozen by a callback on its own loop that (1) forwards its
        pending journal tail (one ``call_soon_threadsafe`` onto the
        writer loop — scheduled BEFORE the shard reports frozen, and
        the writer's own executor resume is scheduled after, so FIFO
        ordering guarantees the tail is applied before the snapshot is
        cut), (2) takes its coordinator's snapshot via the proxy's
        absorbed provider, then (3) blocks its loop on the release
        event — the world is stopped. The writer then snapshots its own
        shard inline (no awaits between that and the swap), merges the
        per-shard snapshots, and runs :meth:`Journal.compact_now` —
        buffered records flush to the old file first, then the file is
        atomically replaced by ``boot ‖ merged snapshot``. Records the
        swap discards are all covered by some shard's snapshot (state
        mutates before its record is journaled), which is the same
        replay-idempotency argument the single-loop compactor makes.
        The release is in a ``finally``: a failed swap must never leave
        the fleet frozen."""
        j = self._journal_real
        loop = asyncio.get_running_loop()
        others = [
            s for s in self._shards
            if s.index != 0 and s.loop is not None and s.journal is not None
        ]
        release = threading.Event()
        frozen = [threading.Event() for _ in others]
        snaps: List[Optional[dict]] = [None] * len(others)

        def freeze(i: int, shard: _Shard) -> None:  # runs on shard's loop
            try:
                shard.journal.flush_tick()
                provider = shard.journal.snapshot_provider
                if provider is not None:
                    snaps[i] = provider()
            finally:
                frozen[i].set()
                release.wait(10.0)  # brief stop-the-world, bounded

        for i, shard in enumerate(others):
            try:
                shard.loop.call_soon_threadsafe(freeze, i, shard)
            except RuntimeError:
                frozen[i].set()  # shard loop gone (shutdown race)
        try:
            for evt in frozen:
                # executor wait keeps THIS loop turning so the frozen
                # shards' forwarded batches (and shard 0's own serve
                # traffic) keep applying while the barrier assembles
                await loop.run_in_executor(None, evt.wait, 10.0)
            await asyncio.sleep(0)
            parts = [s for s in snaps if s is not None]
            own = self._shards[0].journal
            if own is not None and own.snapshot_provider is not None:
                parts.append(own.snapshot_provider())
            if parts:
                j.compact_now(_merge_snapshot_objs(parts))
        finally:
            release.set()

    def _make_replica_gate(self, shard: _Shard):
        """Route a shard's replica-ack gate to the writer loop's lanes;
        the release callback bounces back to the shard's loop."""

        def gate(target: int, cb) -> None:
            from tpuminter_torch.replication import gate_any

            shard_loop = shard.loop

            def release() -> None:  # writer loop
                try:
                    shard_loop.call_soon_threadsafe(cb)
                except RuntimeError:
                    pass

            writer = self._shards[0]
            if shard.index == 0:
                gate_any(writer.lanes, target, cb)
                return
            try:
                writer.loop.call_soon_threadsafe(
                    gate_any, writer.lanes, target, release
                )
            except RuntimeError:
                cb()  # writer loop gone: availability over durability

        return gate

    async def _stall_sampler(self, shard: _Shard) -> None:
        # 5 ms grain: fine enough for the 250 ms epoch bound, cheap
        # enough not to tax the loops it measures (N samplers on one
        # core are part of the measured stack)
        loop = asyncio.get_running_loop()
        while True:
            t0 = loop.time()
            await asyncio.sleep(0.005)
            late = loop.time() - t0 - 0.005
            if late > shard.max_stall:
                shard.max_stall = late

    def _signal_failure(self) -> None:
        if self._owner_loop is not None and self._failure is not None:
            try:
                self._owner_loop.call_soon_threadsafe(self._failure.set)
            except RuntimeError:
                pass

    async def _teardown_after_failure(self) -> None:
        for shard in self._shards:
            if shard.loop is not None and shard.stop is not None:
                shard.stop_mode = "crash"
                try:
                    shard.loop.call_soon_threadsafe(self._kill_shard, shard)
                except RuntimeError:
                    pass
        await self._join_threads()

    def _kill_shard(self, shard: _Shard) -> None:
        """kill -9 one shard, on its own loop."""
        try:
            if shard.coordinator is not None:
                shard.coordinator.crash()
            elif shard.server is not None:
                shard.server.crash()
        finally:
            for lane in shard.lanes:
                lane.crash()
            if shard.index == 0 and self._journal_real is not None:
                self._journal_real.crash()
            if shard.stop is not None:
                shard.stop.set()

    async def _join_threads(self, shards: Optional[List[_Shard]] = None) -> None:
        loop = asyncio.get_running_loop()
        for shard in shards or self._shards:
            if shard.thread is not None and shard.thread.is_alive():
                await loop.run_in_executor(None, shard.thread.join, 10.0)

    # -- harness-facing surface ------------------------------------------

    @property
    def port(self) -> int:
        return self._port

    @property
    def boot_epoch(self) -> int:
        return self._shards[0].server.boot_epoch

    @property
    def servers(self) -> List[LspServer]:
        return [sh.server for sh in self._shards]

    @property
    def server(self) -> LspServer:
        """Shard 0's listener (single-loop-compat accessor; prefer
        :attr:`servers` — fault injection must hit every socket)."""
        return self._shards[0].server

    @property
    def shards(self) -> List[_Shard]:
        return self._shards

    @property
    def stats(self) -> dict:
        out: Dict[str, int] = {}
        for sh in self._shards:
            if sh.coordinator is None:
                continue
            for key, v in sh.coordinator.stats.items():
                out[key] = out.get(key, 0) + v
        return out

    @property
    def _next_chunk_id(self) -> int:
        return 1 + sum(
            sh.coordinator._next_chunk_id - 1
            for sh in self._shards if sh.coordinator is not None
        )

    @property
    def _jobs(self) -> dict:
        out: dict = {}
        for sh in self._shards:
            if sh.coordinator is not None:
                out.update(sh.coordinator._jobs)
        return out

    @property
    def _winners(self) -> dict:
        out: dict = {}
        for sh in self._shards:
            if sh.coordinator is not None:
                out.update(sh.coordinator._winners)
        return out

    @property
    def _miners(self) -> dict:
        out: dict = {}
        for sh in self._shards:
            if sh.coordinator is not None:
                for cid, m in sh.coordinator._miners.items():
                    out[(sh.index, cid)] = m
        return out

    @property
    def _journal(self):
        if self._journal_real is not None:
            return self._journal_real
        if self._seg_journals:
            return _AggJournalView(self._seg_journals)
        return None

    def shard_metrics(self) -> List[dict]:
        """Per-loop balance view: each shard's results, miners,
        connections and datagrams."""
        out = []
        for sh in self._shards:
            ep = sh.server.endpoint if sh.server is not None else None
            coord = sh.coordinator
            out.append({
                "shard": sh.index,
                "results_accepted": (
                    coord.stats["results_accepted"] if coord else 0
                ),
                "miners": len(coord._miners) if coord else 0,
                "conns": len(sh.server.conn_ids) if sh.server else 0,
                "datagrams_received": ep.received if ep else 0,
                "datagrams_sent": ep.sent if ep else 0,
                "read_wakeups": ep.read_wakeups if ep else 0,
                "forwarded_out": sh.forwarded,
                "handoff_in": self._handoffs[sh.index].pushed,
                "max_stall_ms": round(sh.max_stall * 1e3, 3),
            })
        return out

    async def serve(self) -> None:
        """The shards serve on their own loops from the moment
        :meth:`create` returns; this surfaces a shard failure to the
        supervising harness (mirrors ``Coordinator.serve``'s role as
        the thing you ``ensure_future`` and watch)."""
        await self._failure.wait()
        errs = "; ".join(
            f"shard {sh.index}: {sh.error!r}"
            for sh in self._shards if sh.error is not None
        )
        raise RuntimeError(f"multi-loop shard failure: {errs}")

    async def crash(self) -> None:
        """kill -9 the whole group: every socket closes with no drain,
        un-flushed journal tails are lost, threads join, the port is
        free when this returns (the crash-drill restart seam)."""
        for shard in reversed(self._shards):
            shard.stop_mode = "crash"
            if shard.loop is None:
                continue
            try:
                shard.loop.call_soon_threadsafe(self._kill_shard, shard)
            except RuntimeError:
                pass
        await self._join_threads()

    async def close(self) -> None:
        """Graceful teardown: non-writer shards first (their journal
        proxies still need the writer loop), shard 0 — and with it the
        real journal and the shipping lanes — last."""
        if self._closed:
            return
        self._closed = True
        for shard in list(reversed(self._shards)):
            if shard.loop is not None and shard.stop is not None:
                try:
                    shard.loop.call_soon_threadsafe(shard.stop.set)
                except RuntimeError:
                    pass  # loop already gone; join below regardless
            await self._join_threads([shard])


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass
