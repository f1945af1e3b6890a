"""Replicated coordinator: WAL shipping to a hot standby, replay-free
takeover and fenced failover.

Counterpart of ``tpuminter.replication``; the wire and the journal are
the reference's, so a port primary ships to a reference standby and the
reverse. Control plane only: no torch.

**WAL shipping**: the primary's coordinator runs one
:class:`ReplicationPrimary` lane a standby. A lane dials its standby over
LSP, offers its boot epoch (``RepHello``), takes the standby's resume
cursor (``SyncFrom``), checks it against its own file with
:func:`~tpuminter_torch.journal.cursor_valid` and answers ``WalStart``
at the cursor, or at 0 when the files diverged. Then it ships the file
as ``WalBatch``es of raw journal bytes (no re-encoding), first the
backlog, then the tail, woken by the journal's ``on_batch`` hook and
coalescing the flusher's batches for :data:`SHIP_COALESCE_S`. A
compaction (a new ``generation``) restarts the stream at 0.

**The standby** (:class:`ReplicationStandby`) writes each batch to its
local WAL copy and applies its records to a live shadow
:class:`~tpuminter_torch.journal.RecoveredState`, then acks (``SyncAck``).
A batch is scanned with the journal codec first: a torn or corrupted
one keeps its clean record prefix and resets the link, so corruption
looks like the loss of a suffix. The local copy is the durable cursor:
a restarted standby scans it and resumes where it stopped.

**Replica-acked winners**: with ``replica_ack`` the coordinator answers
a winner only once its ``finish`` record is fsynced locally and one
standby has acked past it (:func:`gate_any`); with no synced standby the
answer goes out at once, loudly.

**Fenced failover**: :meth:`ReplicationStandby.promote` adopts the local
copy (``Journal.adopt``, no rescan) at an epoch :data:`FENCE_JUMP` above
both the shadow's and the primary's, re-brands the listener and hands
the shadow to the port's :class:`~tpuminter_torch.coordinator.Coordinator`.
Higher epoch wins: a standby rejects a ``RepHello`` below the primary it
follows, a promoted one or a coordinator rejects every ``RepHello``,
and the rejected lane, reset twice, marks itself fenced and stops its
coordinator (``on_fenced``). Miners and clients given both addresses
rotate until the promoted standby takes them.

**Chains** (``chain_to``): a standby re-ships what it persisted to the
next hop through a :class:`ReplicationPrimary` over a
:class:`_ChainSource`, so the primary pays for one stream.

CLI (the standby, promoted once the primary has been lost for
``--promote-after`` seconds)::

    python -m tpuminter_torch.replication PRIMARY_HOST:PORT --wal standby.wal \\
        --port 9100 --promote-after 3

Both roles are stamped for the loop-affinity detector
(:mod:`tpuminter_torch.analysis.affinity`). A multi-loop primary
(:mod:`tpuminter_torch.multiloop`, writer journal mode) runs its lanes
on the writer loop and routes every shard's replica-ack gate there.
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Callable, List, Optional, Tuple

from tpuminter_torch.analysis import affinity
from tpuminter_torch.journal import (
    Journal,
    RecoveredState,
    cursor_valid,
    read_span,
    scan_with_cursor,
)
from tpuminter_torch.lsp import LspClient, LspConnectError, LspConnectionLost, LspServer, Params
from tpuminter_torch.lsp.params import FAST, dial_patience, jittered_backoff, parse_addr_list
from tpuminter_torch.protocol import (
    ProtocolError,
    RepHello,
    SyncAck,
    SyncFrom,
    WalBatch,
    WalStart,
    decode_msg,
    encode_msg,
)

__all__ = [
    "FENCE_JUMP",
    "SHIP_BATCH_BYTES",
    "ReplicationPrimary",
    "ReplicationStandby",
    "dial_patience",
    "gate_any",
    "parse_addr_list",
    "main",
]

log = logging.getLogger("tpuminter_torch.replication")

#: Epochs a promoted standby jumps above the primary it replaces; each
#: restart of the old primary (``Journal.open``) adds only 1, so its
#: whole restart lineage stays fenced below.
FENCE_JUMP = 1 << 16

#: Largest journal slice a WalBatch carries, well under the LSP
#: reassembly cap; a backlog ships as a sequence of these.
SHIP_BATCH_BYTES = 192 * 1024

#: How long a lane waits after the journal signals new bytes before it
#: reads the tail, so several flushes travel as one WalBatch.
SHIP_COALESCE_S = 0.01


# -- primary side: ship the WAL to one standby ---------------------------------

class ReplicationPrimary:
    """One shipping lane of a primary (one a standby address): dials
    with jittered backoff, offers the boot epoch, honours the standby's
    cursor, ships the backlog, then follows the journal. It stops for
    good once a promoted standby fences it off."""

    def __init__(self, journal: Journal, host: str, port: int, *,
                 params: Optional[Params] = None):
        self._journal = journal
        self._host = host
        self._port = port
        self._params = params or FAST
        self._task: Optional[asyncio.Task] = None
        self._stopped = False
        self._resets = 0
        #: a promoted standby refused our epoch: this primary is a zombie
        self.fenced = False
        #: called once, on the loop, when :attr:`fenced` flips; the
        #: owning coordinator stops serving
        self.on_fenced: Optional[Callable[[], None]] = None
        #: fault plan installed on each session's endpoint (a netsplit
        #: between primary and standby while the data plane stays up)
        self.fault_plan = None
        self.last_loss_reason: Optional[str] = None
        #: the standby's SyncAck high water, in generation :attr:`_gen`'s
        #: offset space
        self.acked = 0
        self._gen = journal.generation
        #: bytes shipped in the current stream: an ack past it is stale
        self._shipped = 0
        #: a session is live and its backlog shipped
        self.synced = False
        self._wake = asyncio.Event()
        #: replica-ack waiters: (generation, target offset, callback)
        self._gates: List[Tuple[int, int, Callable[[], None]]] = []
        self.stats = {"batches_shipped": 0, "bytes_shipped": 0, "resyncs": 0, "sessions": 0}
        prev = journal.on_batch

        def hook(start: int, blob: bytes, _prev=prev) -> None:
            if _prev is not None:
                _prev(start, blob)
            self._wake.set()

        journal.on_batch = hook
        # TPUMINTER_LOOP_AFFINITY=1: a shipping lane lives on the
        # journal's writer loop; a poke from another loop is a race
        affinity.stamp(self)

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)
        self._fire_gates("replication stopped")

    def crash(self) -> None:
        """Stop shipping with no goodbye (``kill -9``)."""
        self._stopped = True
        if self._task is not None:
            self._task.cancel()

    # -- the replica-acked tier ------------------------------------------

    def gate(self, target: int, cb: Callable[[], None]) -> bool:
        """Park ``cb`` until the standby has acked past byte ``target``
        (an offset of the journal's current generation). False when no
        synced session exists, or the ack is already past: the caller
        fires it now."""
        if not self.synced:
            return False
        gen = self._journal.generation
        if gen == self._gen and self.acked >= target:
            return False  # acked past it already, in the same offset space
        self._gates.append((gen, target, cb))
        return True

    def _on_ack(self, offset: int) -> None:
        if offset > self._shipped:
            return  # a stale ack of the stream before a resync
        if offset > self.acked:
            self.acked = offset
        if not self._gates:
            return
        due = [cb for g, t, cb in self._gates if g == self._gen and t <= self.acked]
        self._gates = [(g, t, cb) for g, t, cb in self._gates
                       if g != self._gen or t > self.acked]
        for cb in due:
            try:
                cb()
            except Exception:
                log.exception("replica-ack gate callback failed")

    def _switch_generation(self) -> None:
        """The stream moves to the journal's new generation: the high
        waters reset, and a gate of an older one re-bases to the end of
        the compacted file (its snapshot covers the gated record)."""
        gen = self._journal.generation
        self._gen = gen
        self._shipped = 0
        self.acked = 0
        self._gates = [(gen, t if g == gen else self._journal.size, cb)
                       for g, t, cb in self._gates]

    def _fire_gates(self, why: str) -> None:
        """The session died or shipping stopped: no gated reply waits on
        a dead standby."""
        if not self._gates:
            return
        log.warning("releasing %d replica-ack gated replies without standby durability (%s)",
                    len(self._gates), why)
        gates, self._gates = self._gates, []
        for _g, _t, cb in gates:
            try:
                cb()
            except Exception:
                log.exception("replica-ack gate callback failed")

    # -- the shipping session --------------------------------------------

    async def _run(self) -> None:
        delays = jittered_backoff(0.1, 2.0)
        while not self._stopped and not self.fenced:
            try:
                client = await LspClient.connect(self._host, self._port, self._params)
            except LspConnectError:
                await asyncio.sleep(next(delays))
                continue
            if self.fault_plan is not None:
                client.endpoint.set_fault_plan(self.fault_plan)
            try:
                self.stats["sessions"] += 1
                await self._session(client)
                delays = jittered_backoff(0.1, 2.0)
            except LspConnectionLost as exc:
                self.last_loss_reason = str(exc)
                if "reset ack" in str(exc) or "restarted" in str(exc):
                    # the standby forgot us: it restarted (the redial
                    # resumes at its cursor) or it was promoted and
                    # fenced our epoch. A second reset in a row is the
                    # fence (a standby crash-looping inside the hello
                    # window would look the same and self-fence this
                    # lane: that loses replica durability, loudly, never
                    # safety, which rests on the standby's side)
                    self._resets += 1
                    if self._resets >= 2:
                        self.fenced = True
                        log.error("standby %s:%d fenced this primary off (epoch %d rejected "
                                  "twice): this coordinator is a ZOMBIE of a failed-over epoch "
                                  "— WAL shipping stops for good", self._host, self._port,
                                  self._journal.boot_epoch)
                        if self.on_fenced is not None:
                            try:
                                self.on_fenced()
                            except Exception:
                                log.exception("on_fenced hook failed")
                else:
                    self._resets = 0
            except Exception:
                # a malformed reply or a read error must not end the lane
                log.exception("shipping session to %s:%d failed; redialing",
                              self._host, self._port)
            finally:
                self.synced = False
                self._fire_gates("standby session lost")
                await client.close(drain_timeout=0.2)
            if not self._stopped and not self.fenced:
                await asyncio.sleep(next(delays))

    async def _session(self, client: LspClient) -> None:
        journal = self._journal
        loop = asyncio.get_running_loop()
        client.write(encode_msg(RepHello(journal.boot_epoch)))
        msg = decode_msg(await client.read())
        if not isinstance(msg, SyncFrom):
            raise LspConnectionLost(client.conn_id, "expected SyncFrom")
        offset = msg.offset
        if offset > journal.size or not await loop.run_in_executor(
                None, cursor_valid, journal.path, offset, msg.last_start, msg.crc):
            offset = 0
            self.stats["resyncs"] += 1
        gen = journal.generation
        client.write(encode_msg(WalStart(offset)))
        shipped = offset
        self._gen = gen
        self._shipped = shipped
        # this standby incarnation holds the validated cursor durably
        self.acked = offset
        self._resets = 0

        async def read_acks() -> None:
            while True:
                raw = await client.read()
                try:
                    ack = decode_msg(raw)
                except ProtocolError:
                    continue
                if isinstance(ack, SyncAck):
                    self._on_ack(ack.offset)

        acks = asyncio.ensure_future(read_acks())
        backlogged = True  # the cursor's tail ships without lingering
        try:
            while not self._stopped:
                if gen != journal.generation:
                    # a compaction rewrote the file: restart at 0 (the
                    # new file is a boot and a snapshot)
                    gen = journal.generation
                    shipped = 0
                    self._switch_generation()
                    self.stats["resyncs"] += 1
                    backlogged = True
                    client.write(encode_msg(WalStart(0)))
                if shipped >= journal.size:
                    self.synced = True
                    backlogged = False
                    if acks.done():
                        acks.result()  # the session's loss
                    self._wake.clear()
                    try:
                        # woken by the journal's flushes; the timeout only
                        # covers a hook lost to a journal failure
                        await asyncio.wait_for(self._wake.wait(), 0.5)
                    except asyncio.TimeoutError:
                        pass
                    continue
                if not backlogged:
                    await asyncio.sleep(SHIP_COALESCE_S)
                want = min(SHIP_BATCH_BYTES, journal.size - shipped)
                backlogged = journal.size - shipped > want
                if want > 4096:
                    blob = await loop.run_in_executor(None, read_span, journal.path, shipped,
                                                      want)
                else:
                    blob = read_span(journal.path, shipped, want)
                if gen != journal.generation:
                    continue  # compacted under the read: resync
                client.write(encode_msg(WalBatch(shipped, blob), binary=True))
                shipped += len(blob)
                self._shipped = shipped
                self.stats["batches_shipped"] += 1
                self.stats["bytes_shipped"] += len(blob)
                await asyncio.sleep(0)
        finally:
            acks.cancel()
            await asyncio.gather(acks, return_exceptions=True)


# -- standby side: persist, replay live, promote ---------------------------------

class _ChainSource:
    """What a chain lane tails in place of a :class:`Journal`: the five
    members a lane reads, served from a standby's local WAL copy.
    ``generation`` bumps on a full resync of the standby (its file
    restarted at 0), ``boot_epoch`` is the epoch the standby follows, so
    fencing composes down the chain."""

    def __init__(self, standby: "ReplicationStandby"):
        self._standby = standby
        #: the lane's wake hook
        self.on_batch: Optional[Callable[[int, bytes], None]] = None
        self.generation = 0

    @property
    def path(self) -> str:
        return self._standby.path

    @property
    def size(self) -> int:
        return self._standby.size

    @property
    def boot_epoch(self) -> int:
        return self._standby.primary_epoch


class ReplicationStandby:
    """The hot standby: an LSP listener that takes one primary's stream,
    persists it to a local WAL copy and replays each record into a live
    shadow. Every other peer that dials it before promotion is rejected
    through the reset path, so a fleet given both addresses rotates on."""

    def __init__(self) -> None:
        self._server: Optional[LspServer] = None
        self._params = FAST
        self._apply_shadow = True
        self.path = ""
        self._fh = None
        self.shadow = RecoveredState()
        #: the local copy's clean length, and the cursor of its last record
        self.size = 0
        self._last_start = -1
        self._last_crc = 0
        self._primary_conn: Optional[int] = None
        self.primary_epoch = 0
        self.promoted = False
        self._run_task: Optional[asyncio.Task] = None
        #: set when the shipping connection is lost; promotion keys off it
        self.primary_lost = asyncio.Event()
        self._chain_source = _ChainSource(self)
        self._chain_lanes: List[ReplicationPrimary] = []
        self.stats = {"batches": 0, "records_applied": 0, "bytes": 0, "resyncs": 0,
                      "rejects": 0, "acks_sent": 0}
        # TPUMINTER_LOOP_AFFINITY=1: the standby is single-loop
        affinity.stamp(self)

    @classmethod
    async def create(cls, wal_path: str, *, port: int = 0, host: str = "127.0.0.1",
                     params: Optional[Params] = None, apply_shadow: bool = True,
                     chain_to: Optional[List[Tuple[str, int]]] = None) -> "ReplicationStandby":
        """Open (or resume) the local copy at ``wal_path`` (torn tail cut,
        records applied to the shadow, cursor derived) and listen on
        ``port``, the address miners and clients list after the
        primary's. ``apply_shadow=False`` persists and acks without the
        shadow (such a sink cannot promote). ``chain_to`` lists next-hop
        standbys, each fed by a lane over this copy."""
        self = cls()
        self.path = wal_path
        self._apply_shadow = apply_shadow
        self._params = params or FAST
        if os.path.exists(wal_path):
            with open(wal_path, "rb") as fh:
                data = fh.read()
            records, clean, last_start = scan_with_cursor(data)
            if clean < len(data):
                with open(wal_path, "r+b") as fh:
                    fh.truncate(clean)
            if self._apply_shadow:
                for rec in records:
                    self.shadow.apply(rec)
            self.stats["records_applied"] += len(records)
            self.size = clean
            self._last_start = last_start
            if last_start >= 0:
                self._last_crc = int.from_bytes(data[last_start + 4:last_start + 8], "little")
        self._fh = open(wal_path, "ab")
        self._server = await LspServer.create(port, self._params, host=host)
        for chost, cport in chain_to or []:
            lane = ReplicationPrimary(self._chain_source, chost, cport, params=self._params)
            lane.start()
            self._chain_lanes.append(lane)
        return self

    @property
    def port(self) -> int:
        assert self._server is not None
        return self._server.port

    # -- the receive loop --------------------------------------------------

    async def run(self) -> None:
        """Serve the shipping link until promoted or cancelled."""
        self._run_task = asyncio.current_task()
        while not self.promoted:
            conn_id, payload = await self._server.read()
            if payload is None:
                if conn_id == self._primary_conn:
                    self._primary_conn = None
                    self.primary_lost.set()
                    log.warning("standby: primary connection lost (epoch %d)",
                                self.primary_epoch)
                continue
            try:
                msg = decode_msg(payload)
            except ProtocolError as exc:
                log.warning("standby: malformed message dropped: %s", exc)
                continue
            if isinstance(msg, RepHello):
                self._on_hello(conn_id, msg)
            elif conn_id != self._primary_conn:
                # a miner or client dialed early, or a peer that never
                # said hello: reject, so its rotation moves on
                self.stats["rejects"] += 1
                self._server.reject_conn(conn_id)
            elif isinstance(msg, WalStart):
                self._on_start(msg)
            elif isinstance(msg, WalBatch):
                self._on_batch(conn_id, msg)
            else:
                log.warning("standby: unexpected %s from primary", type(msg).__name__)

    def _on_hello(self, conn_id: int, msg: RepHello) -> None:
        if self.promoted or msg.epoch < self.primary_epoch:
            # higher epoch wins
            self.stats["rejects"] += 1
            log.warning("standby: REJECTING hello from fenced/stale epoch %d (following %d%s)",
                        msg.epoch, self.primary_epoch, ", promoted" if self.promoted else "")
            self._server.reject_conn(conn_id)
            return
        if self._primary_conn is not None and self._primary_conn != conn_id:
            # a restarted primary supersedes its stale session
            self._server.reject_conn(self._primary_conn)
        self._primary_conn = conn_id
        self.primary_epoch = msg.epoch
        self.primary_lost.clear()
        log.info("standby: following primary epoch %d (cursor offset %d)", msg.epoch, self.size)
        self._server.write(conn_id, encode_msg(SyncFrom(self.size, self._last_start,
                                                        self._last_crc)))

    def _on_start(self, msg: WalStart) -> None:
        if msg.offset == self.size:
            return  # resuming at our cursor
        if msg.offset == 0:
            log.info("standby: full resync (had %d bytes); shadow reset", self.size)
            self.stats["resyncs"] += 1
            self._fh.close()
            self._fh = open(self.path, "wb")
            self.size = 0
            self._last_start = -1
            self._last_crc = 0
            self.shadow = RecoveredState()
            # chain lanes restart their streams at 0 too
            self._chain_source.generation += 1
            if self._chain_source.on_batch is not None:
                self._chain_source.on_batch(0, b"")
            return
        log.warning("standby: WalStart at %d but local size is %d; resetting the link",
                    msg.offset, self.size)
        if self._primary_conn is not None:
            self._server.reject_conn(self._primary_conn)
            self._primary_conn = None

    def _on_batch(self, conn_id: int, msg: WalBatch) -> None:
        if msg.offset != self.size:
            log.warning("standby: non-contiguous batch at %d (local size %d); resetting the "
                        "link", msg.offset, self.size)
            self._server.reject_conn(conn_id)
            self._primary_conn = None
            return
        records, clean, last_start = scan_with_cursor(msg.data)
        if clean:
            blob = msg.data if clean == len(msg.data) else bytes(msg.data[:clean])
            self._fh.write(blob)
            self._fh.flush()
            if self._apply_shadow:
                for rec in records:
                    self.shadow.apply(rec)
            if last_start >= 0:
                self._last_start = self.size + last_start
                self._last_crc = int.from_bytes(blob[last_start + 4:last_start + 8], "little")
            self.size += clean
            self.stats["batches"] += 1
            self.stats["records_applied"] += len(records)
            self.stats["bytes"] += clean
            # the next hop hears of bytes only once they are persisted here
            if self._chain_source.on_batch is not None:
                self._chain_source.on_batch(msg.offset, blob)
        if clean < len(msg.data):
            # a torn or corrupted batch loses only its suffix: the resumed
            # stream re-ships from the clean cursor
            log.warning("standby: batch at %d corrupt past byte %d; kept the clean prefix, "
                        "resetting the link", msg.offset, clean)
            self._server.reject_conn(conn_id)
            self._primary_conn = None
            return
        self._server.write(conn_id, encode_msg(SyncAck(self.size)))
        self.stats["acks_sent"] += 1

    # -- takeover ------------------------------------------------------------

    async def promote(self, **coordinator_kwargs):
        """Fenced, replay-free takeover: stop following, adopt the local
        copy at an epoch :data:`FENCE_JUMP` above both the shadow's and
        the primary's, and return the port's coordinator on this
        standby's port, built on the shadow. Keywords go to the
        coordinator."""
        from tpuminter_torch.coordinator import Coordinator

        if self.promoted:
            raise RuntimeError("already promoted")
        if not self._apply_shadow:
            raise RuntimeError("a sink standby (apply_shadow=False) holds no shadow state and "
                               "cannot promote")
        self.promoted = True
        if self._run_task is not None and self._run_task is not asyncio.current_task():
            self._run_task.cancel()
            await asyncio.gather(self._run_task, return_exceptions=True)
        for lane in self._chain_lanes:
            await lane.stop()
        self._chain_lanes = []
        if self._primary_conn is not None:
            self._server.reject_conn(self._primary_conn)
            self._primary_conn = None
        epoch = max(self.shadow.boot_epoch, self.primary_epoch) + FENCE_JUMP
        # what the follow loop wrote lazily is fsynced before adoption
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._fh.close()
        self._fh = None
        journal = Journal.adopt(self.path, epoch)
        self._server.set_boot_epoch(epoch)
        coord = Coordinator(self._server, journal=journal, **coordinator_kwargs)
        coord.adopt_recovered(self.shadow)
        log.info("standby PROMOTED: epoch %d (fenced %d + %d), %d jobs and %d winners live, "
                 "port %d", epoch, self.primary_epoch, FENCE_JUMP, len(self.shadow.jobs),
                 len(self.shadow.winners), self.port)
        return coord

    async def close(self) -> None:
        """Tear down an unpromoted standby (a promoted one's server and
        journal belong to its coordinator)."""
        if self._run_task is not None and not self._run_task.done():
            self._run_task.cancel()
            await asyncio.gather(self._run_task, return_exceptions=True)
        for lane in self._chain_lanes:
            await lane.stop()
        self._chain_lanes = []
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if not self.promoted and self._server is not None:
            await self._server.close(drain_timeout=0.2)


def gate_any(primaries: List[ReplicationPrimary], target: int,
             cb: Callable[[], None]) -> None:
    """Fire ``cb`` once any standby has acked past ``target`` (the
    first ack wins); with no synced standby, at once."""
    fired = [False]

    def once() -> None:
        if not fired[0]:
            fired[0] = True
            cb()

    gated = False
    for p in primaries:
        if p.gate(target, once):
            gated = True
    if not gated:
        once()


# -- CLI: the standby and takeover role ------------------------------------------

def main(argv: Optional[list] = None) -> None:
    """``python -m tpuminter_torch.replication PRIMARY --wal W [--port P]
    [--promote-after S] [--chain-to LIST]``: follow the primary's WAL
    (the primary dials this listener); once it has been lost past the
    threshold, become the coordinator on ``--port`` at a fenced epoch."""
    import argparse

    parser = argparse.ArgumentParser(
        description="tpuminter_torch hot-standby coordinator (WAL shipping target)")
    parser.add_argument("primary", help="primary coordinator address, host:port")
    parser.add_argument("--wal", required=True, metavar="PATH",
                        help="local WAL copy (also the promoted coordinator's journal)")
    parser.add_argument(
        "--port", type=int, default=0,
        help="listen port — the address miners/clients list after the primary's (0 = "
        "ephemeral, logged at startup)")
    parser.add_argument(
        "--promote-after", type=float, default=None, metavar="SECONDS",
        help="auto-promote once the primary has been lost for this long (default: follow "
        "forever; promotion is an operator decision)")
    parser.add_argument(
        "--chain-to", metavar="HOST:PORT[,...]", default=None,
        help="chain replication: re-ship every persisted batch to the next standby hop(s), "
        "so the primary pays one stream however deep the chain; a promoted standby stops "
        "chaining")
    args = parser.parse_args(argv)
    chain_to = parse_addr_list(args.chain_to) if args.chain_to else None
    logging.basicConfig(level=logging.INFO)

    async def _run() -> None:
        standby = await ReplicationStandby.create(args.wal, port=args.port, chain_to=chain_to)
        log.info("standby listening on port %d, following %s", standby.port, args.primary)
        runner = asyncio.ensure_future(standby.run())
        try:
            if args.promote_after is None:
                await runner
                return
            while True:
                if standby._primary_conn is not None:
                    await standby.primary_lost.wait()
                # a primary that never (re)connects in the window is as
                # dead as one that vanished mid-stream
                try:
                    await asyncio.wait_for(_wait_primary_back(standby), args.promote_after)
                    continue
                except asyncio.TimeoutError:
                    break
            coord = await standby.promote()
            log.info("serving as coordinator on port %d", coord.port)
            await coord.serve()
        finally:
            runner.cancel()
            await asyncio.gather(runner, return_exceptions=True)

    asyncio.run(_run())


async def _wait_primary_back(standby: ReplicationStandby) -> None:
    while standby._primary_conn is None:
        await asyncio.sleep(0.05)
    standby.primary_lost.clear()


if __name__ == "__main__":
    main()
