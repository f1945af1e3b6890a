"""Multi-process sharded coordinator: one OS process a shard behind one
UDP port, with a cross-shard rebind registry and shared admission
budgets over a host-local datagram seam. Counterpart of
``tpuminter.multiproc``.

:mod:`tpuminter_torch.multiloop` carves the coordinator into N event
loops that still share one GIL. ``procs=N`` spawns N child processes
instead, each a whole single-loop
:class:`~tpuminter_torch.coordinator.Coordinator` with its own
``SO_REUSEPORT`` socket on the shared port, its own WAL segment
(``path.s<k>``, the layout segments-mode recovery merges) and its own
GIL, so the shards' verification executors and journal flushers run on
cores of their own. A spawned shard imports only the port's torch-free
control-plane modules.

**Steering** is the multi-loop machinery's: shard *k* allocates LSP
conn ids ≡ *k* (mod N); child 0 attaches the
``SO_ATTACH_REUSEPORT_CBPF`` program (:func:`multiloop.
attach_conn_steering`) after its bind and before its siblings bind
(reuseport group indices follow bind order, so the parent spawns the
children one at a time), and the kernel then delivers each established
connection's datagrams to its owning process. A mis-steered datagram (a
CONNECT, which carries conn id 0; a race before steering; every
datagram where the attach failed) goes to its owner as a ``SEAM_FWD``
frame, and the owner replays it through :meth:`LspServer.
deliver_datagram` and answers from its own socket on the same port.

**The seam channel** is one ``AF_UNIX``/``SOCK_DGRAM`` socket a shard,
and one for the supervisor, in a private temporary directory. Two
dialects share it, told apart by the first byte: ``{``-initial JSON
control messages (ready/go/stats/stop between parent and child) and the
binary seam frames of :mod:`tpuminter_torch.protocol` (tags
0xD1–0xD5). Sends never block and a lost frame is tolerated: every seam
protocol is a hint with a safe miss path, so a full queue costs
throughput, never correctness. Unlike the reference, a shard holds the
frames it sends before the parent's ``go`` to a sibling not bound yet
and sends them at ``go`` (peers redialing a restarted group reach shard
0 while its siblings still start), so a healthy start drops none.

**The rebind registry**: each durable bind is gossiped (``SEAM_BIND``)
into every sibling's LRU registry. A re-submission after a crash that
lands on a foreign shard finds its home there, parks, and asks the home
shard (``SEAM_REBIND``), which answers with the durable winner, parks
the foreign client on the live job (answered by the durability callback
that answers local waiters), or reports a miss; only a miss or a seam
timeout mints a local job. Lost hints can cost duplicate work, never a
duplicate answer: answers go only to parked entries, each popped once,
and a late answer after a timeout finds nothing parked and is dropped.

**Shared quota buckets**: each admission gossips a cumulative per-ckey
count (``SEAM_QUOTA``); receivers charge the positive delta to their
copy of the bucket (:meth:`Coordinator.seam_quota_debit`), so a tenant
sliced across processes spends one budget. Cumulative counts make the
gossip idempotent under loss, reordering and duplication.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import multiprocessing
import os
import random
import shutil
import signal
import socket as _socket
import tempfile
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from tpuminter_torch.journal import (
    WINNERS_CAP,
    Journal,
    RecoveredState,
    merge_states,
    replay,
    scan_file,
    segment_paths,
)
from tpuminter_torch.lsp import Params
from tpuminter_torch.lsp.params import FAST
from tpuminter_torch.multiloop import attach_conn_steering, shard_for_job, shard_of
from tpuminter_torch.protocol import (
    ProtocolError,
    decode_seam,
    encode_seam_answer,
    encode_seam_bind,
    encode_seam_fwd,
    encode_seam_quota,
    encode_seam_rebind,
)

__all__ = ["MultiProcCoordinator"]

log = logging.getLogger("tpuminter_torch.multiproc")

#: bound on each shard's rebind registry and quota-gossip tables; a
#: miss after LRU eviction re-mines (never double-answers), so the cap
#: trades duplicate work for bounded memory exactly like the winners cap
SEAM_REGISTRY_CAP = 65536

#: seconds a foreign-shard submission stays parked awaiting the home
#: shard's SEAM_ANSWER before falling back to a fresh local job
SEAM_REBIND_TIMEOUT_S = 2.0

#: frames a shard holds for siblings not bound yet, until the parent's
#: ``go`` says every sibling is up (beyond it they drop, as later ones do)
SEAM_HOLD_CAP = 1024


# ---------------------------------------------------------------------------
# the per-shard seam object (lives in the CHILD process)
# ---------------------------------------------------------------------------

class _ShardSeam:
    """One shard's half of the seam channel: owns the shard's UNIX
    datagram socket, the rebind registry, and the quota gossip state.
    Injected into the child's :class:`Coordinator` as ``seam=`` — all
    hooks run on the child's (only) event loop, so no locking."""

    def __init__(
        self, index: int, procs: int, seam_dir: str,
        sock: _socket.socket,
    ) -> None:
        self.index = index
        self.procs = procs
        self._dir = seam_dir
        self._sock = sock
        self._coordinator = None
        self._server = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        #: (ckey, cjid) → home shard index, gossiped via SEAM_BIND.
        #: LRU-capped hints: a miss re-mines, never double-answers.
        self._remote_binds: "OrderedDict[Tuple[str, int], int]" = OrderedDict()
        #: (conn_id, cjid) → (key, Request, timeout handle): local
        #: submissions parked awaiting the home shard's answer
        self._parked: Dict[Tuple[int, int], tuple] = {}
        #: keys whose rebind came back a miss (or timed out): the next
        #: consult lets the submission mint locally — consumed one-shot
        self._fallback: set = set()
        #: ckey → cumulative local admissions (gossiped); LRU-capped —
        #: an evicted counter restarting at 0 sends deltas the sibling's
        #: monotonic check ignores (under-shares, never double-debits)
        self._admitted: "OrderedDict[str, int]" = OrderedDict()
        self._quota_dirty: set = set()
        self._quota_flush_scheduled = False
        #: (shard, frame) sent before ``go`` to a sibling whose socket did
        #: not exist yet (its process is still starting); None once released
        self._held: Optional[List[Tuple[int, bytes]]] = []
        #: (origin shard, ckey) → highest cumulative count applied
        self._seen: "OrderedDict[Tuple[int, str], int]" = OrderedDict()
        self.stats = {
            "fwd_out": 0,
            "fwd_in": 0,
            "binds_gossiped": 0,
            "binds_learned": 0,
            "rebinds_sent": 0,
            "rebind_answers": 0,
            "rebind_misses": 0,
            "rebind_timeouts": 0,
            "quota_msgs_out": 0,
            "quota_msgs_in": 0,
            "seam_drops": 0,
            "seam_bad_frames": 0,
        }

    # -- wiring -----------------------------------------------------------

    def attach(self, coordinator, server) -> None:
        self._coordinator = coordinator
        self._server = server
        self._loop = asyncio.get_running_loop()
        self._loop.add_reader(self._sock.fileno(), self._on_readable)

    def detach(self) -> None:
        if self._loop is not None:
            try:
                self._loop.remove_reader(self._sock.fileno())
            except Exception:
                pass

    def _path(self, shard: int) -> str:
        return os.path.join(self._dir, f"shard{shard}.sock")

    def _send(self, shard: int, frame: bytes) -> None:
        """Non-blocking best-effort send to a sibling (or the parent's
        ``ctrl.sock`` via :meth:`send_ctrl`). A full queue or a gone
        sibling drops the frame; every seam protocol tolerates loss by
        design. Before ``go``, a sibling not bound yet (the parent
        spawns the shards one at a time, while peers redialing a
        restarted group already reach shard 0) gets the frame held
        instead (:meth:`release_held`): the reference drops it, and the
        peer's next retransmission gets through."""
        try:
            self._sock.sendto(frame, self._path(shard))
        except (FileNotFoundError, ConnectionRefusedError):
            if self._held is not None and len(self._held) < SEAM_HOLD_CAP:
                self._held.append((shard, frame))
            else:
                self.stats["seam_drops"] += 1
        except (BlockingIOError, OSError):
            self.stats["seam_drops"] += 1

    def release_held(self) -> None:
        """The parent's ``go``: every sibling is bound, so what was held
        for them goes out now, and nothing is held from here on."""
        held, self._held = self._held or [], None
        for shard, frame in held:
            self._send(shard, frame)

    def send_ctrl(self, obj: dict) -> None:
        try:
            self._sock.sendto(
                json.dumps(obj).encode(),
                os.path.join(self._dir, "ctrl.sock"),
            )
        except (BlockingIOError, ConnectionRefusedError, FileNotFoundError,
                OSError):
            self.stats["seam_drops"] += 1

    def _siblings(self):
        return (s for s in range(self.procs) if s != self.index)

    # -- ingress (mis-steered datagram forwarding) ------------------------

    def forward_datagram(self, owner: int, data: bytes, addr) -> None:
        try:
            frame = encode_seam_fwd(addr, data)
        except ProtocolError:
            self.stats["seam_drops"] += 1  # non-IPv4 peer: just drop
            return
        self.stats["fwd_out"] += 1
        self._send(owner, frame)

    # -- Coordinator-facing hooks ----------------------------------------

    def consult(self, conn_id: int, msg) -> bool:
        """Dedup/bind-miss hook (:meth:`Coordinator._on_request`): does
        a sibling own ``(client_key, job_id)``? True = parked (the seam
        owns the submission now); False = proceed locally."""
        key = (msg.client_key, msg.job_id)
        if key in self._fallback:
            # this submission already round-tripped the seam and missed
            # (or timed out): mint locally, one-shot
            self._fallback.discard(key)
            return False
        home = self._remote_binds.get(key)
        if home is None or home == self.index:
            return False
        park_key = (conn_id, msg.job_id)
        if park_key in self._parked:
            # duplicate re-submit while already parked (client pipeline
            # retry): the pending answer covers it
            return True
        timer = self._loop.call_later(
            SEAM_REBIND_TIMEOUT_S, self._rebind_timeout, park_key
        )
        self._parked[park_key] = (key, msg, timer)
        self.stats["rebinds_sent"] += 1
        self._send(
            home,
            encode_seam_rebind(self.index, conn_id, msg.client_key,
                               msg.job_id),
        )
        return True

    def on_bind(self, ckey: str, cjid: int) -> None:
        """A durable job bound locally: gossip ownership so a post-crash
        re-submit landing on a sibling re-binds here."""
        key = (ckey, cjid)
        # we own it now — a stale foreign entry must not bounce our own
        # future re-submits away
        self._remote_binds.pop(key, None)
        self.stats["binds_gossiped"] += 1
        frame = encode_seam_bind(self.index, ckey, cjid)
        for s in self._siblings():
            self._send(s, frame)

    def on_admit(self, ckey: str) -> None:
        """A durable ckey was admitted locally: bump the cumulative
        counter and schedule one coalesced gossip flush per loop tick
        (a burst of admissions costs one datagram per sibling)."""
        self._admitted[ckey] = self._admitted.pop(ckey, 0) + 1
        while len(self._admitted) > SEAM_REGISTRY_CAP:
            self._admitted.popitem(last=False)
        self._quota_dirty.add(ckey)
        if not self._quota_flush_scheduled:
            self._quota_flush_scheduled = True
            self._loop.call_soon(self._flush_quota)

    def announce_existing(self) -> None:
        """Post-recovery gossip (fired on the parent's ``go``): every
        recovered bind and winner this shard adopted is announced, so a
        redialing client that hashes to a different shard after the
        restart re-binds instead of re-mining — the drill the multiloop
        docstring deliberately left open."""
        coord = self._coordinator
        for ckey, cjid in list(coord._bound.keys()):
            self.on_bind(ckey, cjid)
        for ckey, cjid in list(coord._winners.keys()):
            self.on_bind(ckey, cjid)

    def answer_remote(
        self, origin: int, remote_conn: int, cjid: int, payload: bytes,
        *, miss: bool = False,
    ) -> None:
        """Home-shard reply path (directly from :meth:`seam_rebind`
        or via the coordinator's durability callback draining
        ``_remote_waiters``)."""
        self._send(
            origin,
            encode_seam_answer(remote_conn, cjid, b"" if miss else payload,
                               miss=miss),
        )

    # -- seam-channel receive --------------------------------------------

    def _on_readable(self) -> None:
        while True:
            try:
                data = self._sock.recv(65536)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            if not data:
                continue
            if data[0] == 0x7B:  # '{' — parent control JSON
                try:
                    self._on_ctrl(json.loads(data.decode()))
                except (ValueError, UnicodeDecodeError):
                    self.stats["seam_bad_frames"] += 1
                continue
            try:
                frame = decode_seam(data)
            except ProtocolError:
                self.stats["seam_bad_frames"] += 1
                continue
            try:
                self._on_frame(frame)
            except Exception:
                # the seam is a hint channel: a handler bug must not
                # kill the serve loop's reader
                log.exception("seam frame handler failed: %r", frame[0])

    def _on_frame(self, frame: tuple) -> None:
        kind = frame[0]
        if kind == "fwd":
            _, addr, payload = frame
            self.stats["fwd_in"] += 1
            self._server.deliver_datagram(payload, addr)
        elif kind == "bind":
            _, origin, ckey, cjid = frame
            key = (ckey, cjid)
            self._remote_binds.pop(key, None)
            self._remote_binds[key] = origin
            while len(self._remote_binds) > SEAM_REGISTRY_CAP:
                self._remote_binds.popitem(last=False)
            self.stats["binds_learned"] += 1
        elif kind == "rebind":
            _, origin, conn_id, ckey, cjid = frame
            out = self._coordinator.seam_rebind(ckey, cjid, origin, conn_id)
            if out is True:
                return  # parked; the durability callback answers later
            if out is None:
                self.answer_remote(origin, conn_id, cjid, b"", miss=True)
            else:
                self.answer_remote(origin, conn_id, cjid, out)
        elif kind == "answer":
            _, miss, conn_id, cjid, payload = frame
            entry = self._parked.pop((conn_id, cjid), None)
            if entry is None:
                # late answer after a timeout fallback: the local job is
                # already minting — delivering would DOUBLE-answer, so
                # drop (the fallback job's answer is the one the client
                # gets; duplicate work, exactly-once answers)
                return
            key, msg, timer = entry
            timer.cancel()
            if miss:
                self.stats["rebind_misses"] += 1
                self._fallback.add(key)
                self._coordinator._on_request(conn_id, msg)
                return
            self.stats["rebind_answers"] += 1
            try:
                self._server.write(conn_id, payload)
            except ConnectionError:
                pass  # client died while parked; the winner stays home
        elif kind == "quota":
            _, origin, ckey, admitted = frame
            self.stats["quota_msgs_in"] += 1
            seen_key = (origin, ckey)
            last = self._seen.pop(seen_key, 0)
            self._seen[seen_key] = max(last, admitted)
            while len(self._seen) > SEAM_REGISTRY_CAP:
                self._seen.popitem(last=False)
            if admitted > last:
                self._coordinator.seam_quota_debit(ckey, admitted - last)

    def _rebind_timeout(self, park_key: Tuple[int, int]) -> None:
        entry = self._parked.pop(park_key, None)
        if entry is None:
            return
        key, msg, _timer = entry
        self.stats["rebind_timeouts"] += 1
        # same contract as a miss: mint fresh local work. If the home
        # shard's answer arrives late it finds nothing parked and is
        # dropped — duplicate work, never a duplicate answer.
        self._fallback.add(key)
        self._coordinator._on_request(park_key[0], msg)

    def _flush_quota(self) -> None:
        self._quota_flush_scheduled = False
        dirty, self._quota_dirty = self._quota_dirty, set()
        for ckey in dirty:
            count = self._admitted.get(ckey)
            if count is None:
                continue
            frame = encode_seam_quota(self.index, ckey, count)
            for s in self._siblings():
                self.stats["quota_msgs_out"] += 1
                self._send(s, frame)

    def _on_ctrl(self, obj: dict) -> None:
        """Parent control ops, dispatched by the child runner via the
        handler it installed (set in :func:`_child_async`)."""
        handler = getattr(self, "ctrl_handler", None)
        if handler is not None:
            handler(obj)


# ---------------------------------------------------------------------------
# the child process
# ---------------------------------------------------------------------------

def _child_main(cfg: dict) -> None:
    """Spawn target: one shard process. ``cfg`` is a plain picklable
    dict of scalars (plus the Params fields as a dict) — the exact
    discipline the proc-seam checker enforces; nothing live crosses the
    fork/spawn boundary."""
    logging.basicConfig(
        level=getattr(logging, cfg.get("log_level", "WARNING")),
        format=f"%(asctime)s shard{cfg['shard']} %(name)s: %(message)s",
    )
    try:
        asyncio.run(_child_async(cfg))
    except KeyboardInterrupt:
        pass


async def _child_async(cfg: dict) -> None:
    from tpuminter_torch.coordinator import Coordinator
    from tpuminter_torch.lsp import LspServer

    k = cfg["shard"]
    procs = cfg["procs"]
    seam_dir = cfg["seam_dir"]
    params = Params(**cfg["params"])
    loop = asyncio.get_running_loop()

    sock = _socket.socket(_socket.AF_UNIX, _socket.SOCK_DGRAM)
    sock.bind(os.path.join(seam_dir, f"shard{k}.sock"))
    sock.setblocking(False)
    seam = _ShardSeam(k, procs, seam_dir, sock)

    journal = None
    recovered: Optional[RecoveredState] = None
    boot_epoch = cfg["epoch"]
    if cfg["journal"] is not None:
        # the parent already rewrote the layout (merged recovery →
        # per-shard segments, fsynced, superseded files unlinked);
        # opening bumps the epoch once more, identically in every child
        journal, recovered = Journal.open(
            cfg["journal"], winners_cap=cfg["coord_kwargs"].get(
                "winners_cap", WINNERS_CAP
            ),
        )
        boot_epoch = recovered.boot_epoch

    def ingress(data: bytes, addr) -> bool:
        owner = shard_of(addr, procs)
        if owner == k:
            return True
        seam.forward_datagram(owner, data, addr)
        return False

    server = await LspServer.create(
        cfg["port"], params, host=cfg["host"], boot_epoch=boot_epoch,
        reuse_port=True, io_batch=cfg["io_batch"],
        conn_id_start=(k or procs), conn_id_stride=procs,
        ingress_filter=ingress,
    )
    steer = False
    if k == 0:
        # reuseport group indices follow bind order: shard 0 binds
        # first, attaches the conn-id steering program, and only then
        # does the parent let the siblings bind (sequential spawn)
        steer = attach_conn_steering(server.endpoint.sock, procs)

    coordinator = Coordinator(
        server, journal=journal, job_id_start=k + 1, job_id_stride=procs,
        seam=seam, **cfg["coord_kwargs"],
    )
    if recovered is not None:
        coordinator.adopt_recovered(recovered)
    seam.attach(coordinator, server)

    stop = asyncio.Event()
    go = asyncio.Event()

    def on_ctrl(obj: dict) -> None:
        op = obj.get("op")
        if op == "go":
            go.set()
        elif op == "stop":
            stop.set()
        elif op == "stats":
            snap = coordinator.stats_snapshot()
            seam.send_ctrl({
                "op": "stats_reply", "id": obj.get("id"), "shard": k,
                "stats": snap["stats"],
                "seam": dict(seam.stats),
                "jobs_active": snap["jobs_active"],
                "winners_cached": snap["winners_cached"],
                "quota_buckets": snap["quota_buckets"],
                "conns": len(server.conn_ids),
                # beyond the reference's reply: a supervisor staffing
                # every shard reads its miners here
                "miners": len(coordinator._miners),
            })

    seam.ctrl_handler = on_ctrl
    seam.send_ctrl({
        "op": "ready", "shard": k,
        "port": server.endpoint.local_addr[1],
        "epoch": boot_epoch, "steer": steer,
    })
    await go.wait()
    seam.release_held()
    # every sibling is bound and reading: recovered binds/winners can
    # now gossip without racing a half-up fleet
    seam.announce_existing()

    serve = asyncio.ensure_future(coordinator.serve())
    stop_wait = asyncio.ensure_future(stop.wait())
    try:
        done, _ = await asyncio.wait(
            {serve, stop_wait}, return_when=asyncio.FIRST_COMPLETED
        )
        if serve in done and not stop.is_set():
            exc = serve.exception()
            log.error("shard %d serve loop died: %r", k, exc)
            seam.send_ctrl({"op": "died", "shard": k, "error": repr(exc)})
            return
    finally:
        serve.cancel()
        stop_wait.cancel()
        await asyncio.gather(serve, stop_wait, return_exceptions=True)
        seam.detach()
        try:
            await coordinator.close()
        except Exception:
            log.exception("shard %d close failed", k)
        seam.send_ctrl({"op": "stopped", "shard": k})
        sock.close()


# ---------------------------------------------------------------------------
# the supervisor (parent process)
# ---------------------------------------------------------------------------

class MultiProcCoordinator:
    """N coordinator shard PROCESSES behind one UDP port. Use
    :meth:`create`. The parent holds no sockets on the serve port and
    no coordinator state — it supervises: sequential bootstrap (bind
    order = cBPF steering order), stats RPC over the seam channel's
    control dialect, graceful stop, and kill -9 (:meth:`crash`) for the
    restart drills. Recovery is parent-side and layout-rewriting,
    exactly like segments-mode multiloop: merge whatever is on disk,
    re-snapshot into per-shard segments, fsync, unlink the superseded
    files, then hand each child its own segment path."""

    def __init__(self) -> None:
        self.procs = 0
        self.steer_kernel = False
        self._port = 0
        self._epoch = 0
        self._host = "127.0.0.1"
        self._children: List[multiprocessing.process.BaseProcess] = []
        self._seam_dir = ""
        self._ctrl: Optional[_socket.socket] = None
        self._closed = False
        self._stats_id = 0

    @classmethod
    async def create(
        cls,
        port: int = 0,
        *,
        procs: int = 2,
        params: Optional[Params] = None,
        host: str = "127.0.0.1",
        recover_from: Optional[str] = None,
        chunk_size: Optional[int] = None,
        stats_interval: float = 10.0,
        pipeline_depth: Optional[int] = None,
        binary_codec: bool = True,
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
        log_level: str = "WARNING",
    ) -> "MultiProcCoordinator":
        if procs < 1:
            raise ValueError("procs must be >= 1")
        if not hasattr(_socket, "SO_REUSEPORT"):
            raise RuntimeError(
                "multi-process coordinator needs SO_REUSEPORT, which "
                "this platform does not expose"
            )
        self = cls()
        self.procs = procs
        self._host = host
        loop = asyncio.get_running_loop()

        # -- merged recovery + per-shard journal layout rewrite ----------
        journal_paths: List[Optional[str]] = [None] * procs
        if recover_from is not None:
            files = [recover_from] if os.path.exists(recover_from) else []
            segs = segment_paths(recover_from)
            states = [replay(scan_file(p)) for p in files + segs]
            merged = merge_states(states) if states else RecoveredState()
            epoch = merged.boot_epoch + 1
            for k in range(procs):
                jobs_k = {
                    jid: j for jid, j in merged.jobs.items()
                    if shard_for_job(jid, procs) == k
                }
                snap_k = None
                if merged.records:
                    part = RecoveredState(
                        next_job_id=merged.next_job_id, jobs=jobs_k,
                        # winners AND quota replicate into every shard:
                        # exactly-once needs the dedup table wherever a
                        # redial hashes; shared budgets need every
                        # bucket replica to resume at the recorded level
                        winners=merged.winners.copy(),
                        quota=dict(merged.quota),
                    )
                    snap_k = part.snapshot_obj()
                seg = Journal.fresh(f"{recover_from}.s{k}", epoch, snap_k)
                await seg.aclose()  # the child re-opens it; parent owns none
                journal_paths[k] = f"{recover_from}.s{k}"
            _unlink(recover_from)
            for p in segs:
                if p not in set(journal_paths):
                    _unlink(p)
            self._epoch = epoch
        else:
            # no journal: one shared random boot epoch — every shard of
            # this incarnation must advertise the same identity
            self._epoch = random.getrandbits(63) | 1

        # -- seam dir + parent control socket ----------------------------
        self._seam_dir = tempfile.mkdtemp(prefix="tpuminter-seam-")
        self._ctrl = _socket.socket(_socket.AF_UNIX, _socket.SOCK_DGRAM)
        self._ctrl.bind(os.path.join(self._seam_dir, "ctrl.sock"))
        self._ctrl.setblocking(False)

        params = params or FAST
        coord_kwargs: dict = dict(
            stats_interval=stats_interval, binary_codec=binary_codec,
            quota_rate=quota_rate, quota_burst=quota_burst,
            quota_tiers=quota_tiers, max_jobs=max_jobs,
            winners_ttl=winners_ttl, unbound_ttl=unbound_ttl,
            roll_budget=roll_budget,
            # the park queue is shard-process-local, like the quota
            # buckets it extends
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

        # spawn, not fork: the parent runs an event loop (and possibly
        # threads); fork would clone locks mid-flight. Everything in
        # cfg is a plain scalar/dict — the proc-seam checker's rule.
        ctx = multiprocessing.get_context("spawn")
        bound_port = port
        try:
            for k in range(procs):
                cfg = {
                    "shard": k, "procs": procs, "port": bound_port,
                    "host": host, "epoch": self._epoch,
                    "journal": journal_paths[k],
                    "seam_dir": self._seam_dir,
                    "params": dataclasses.asdict(params),
                    "coord_kwargs": coord_kwargs,
                    "io_batch": io_batch,
                    "log_level": log_level,
                }
                child = ctx.Process(
                    target=_child_main, args=(cfg,),
                    name=f"tpuminter-shard-{k}", daemon=True,
                )
                child.start()
                self._children.append(child)
                ready = await self._wait_ctrl(loop, "ready", shard=k,
                                              timeout=60.0)
                if ready is None:
                    raise RuntimeError(
                        f"shard process {k} did not come up"
                    )
                if k == 0:
                    bound_port = self._port = int(ready["port"])
                    self.steer_kernel = bool(ready.get("steer"))
                self._epoch = max(self._epoch, int(ready.get("epoch", 0)))
            for k in range(procs):
                self._send_ctrl(k, {"op": "go"})
        except BaseException:
            await self.crash()
            raise
        log.info(
            "multi-process coordinator up: %d shard processes on port %d "
            "(journal=%s, kernel steering %s)",
            procs, self._port, "segments" if recover_from else "off",
            "ON" if self.steer_kernel else "off (userspace shim)",
        )
        return self

    # -- control-channel plumbing ----------------------------------------

    def _send_ctrl(self, shard: int, obj: dict) -> None:
        try:
            self._ctrl.sendto(
                json.dumps(obj).encode(),
                os.path.join(self._seam_dir, f"shard{shard}.sock"),
            )
        except OSError:
            pass

    async def _wait_ctrl(
        self, loop, op: str, *, shard: Optional[int] = None,
        reply_id: Optional[int] = None, timeout: float = 10.0,
        collect: Optional[list] = None,
    ) -> Optional[dict]:
        """Receive control messages until one matches (op, shard /
        reply id) or the deadline passes. Non-matching messages are
        appended to ``collect`` (stats replies racing a stop) or
        dropped — the control dialect is idempotent enough that lost
        strays never wedge anything."""
        deadline = loop.time() + timeout
        while True:
            remaining = deadline - loop.time()
            if remaining <= 0:
                return None
            try:
                data = await asyncio.wait_for(
                    loop.sock_recv(self._ctrl, 65536), remaining
                )
            except (asyncio.TimeoutError, OSError):
                return None
            try:
                obj = json.loads(data.decode())
            except (ValueError, UnicodeDecodeError):
                continue
            if obj.get("op") == "died":
                log.error("shard process died: %s", obj)
                continue
            if obj.get("op") != op:
                continue
            if shard is not None and obj.get("shard") != shard:
                continue
            if reply_id is not None and obj.get("id") != reply_id:
                continue
            if collect is not None:
                collect.append(obj)
                if len(collect) >= self.procs:
                    return obj
                continue
            return obj

    # -- harness-facing surface ------------------------------------------

    @property
    def port(self) -> int:
        return self._port

    @property
    def boot_epoch(self) -> int:
        return self._epoch

    def alive(self) -> List[bool]:
        return [c.is_alive() for c in self._children]

    async def stats_all(self, timeout: float = 10.0) -> List[dict]:
        """One stats RPC per shard over the control dialect; returns
        the per-shard reply dicts (shards that miss the deadline are
        simply absent — the caller sums what arrived)."""
        loop = asyncio.get_running_loop()
        self._stats_id += 1
        rid = self._stats_id
        for k in range(self.procs):
            self._send_ctrl(k, {"op": "stats", "id": rid})
        replies: List[dict] = []
        await self._wait_ctrl(
            loop, "stats_reply", reply_id=rid, timeout=timeout,
            collect=replies,
        )
        return sorted(replies, key=lambda r: r.get("shard", 0))

    async def crash(self) -> None:
        """kill -9 every shard process: no drain, no goodbye, un-synced
        journal tails lost — the restart drill's crash seam, now a REAL
        SIGKILL across a process boundary."""
        for child in self._children:
            if child.is_alive():
                try:
                    os.kill(child.pid, signal.SIGKILL)
                except (OSError, TypeError):
                    pass
        await self._join_all()
        self._cleanup()

    async def close(self) -> None:
        """Graceful teardown: stop every child (each closes its server,
        drains and closes its journal segment), then reap."""
        if self._closed:
            return
        self._closed = True
        loop = asyncio.get_running_loop()
        for k in range(self.procs):
            self._send_ctrl(k, {"op": "stop"})
        deadline = loop.time() + 15.0
        for child in self._children:
            remaining = max(0.1, deadline - loop.time())
            await loop.run_in_executor(None, child.join, remaining)
            if child.is_alive():
                try:
                    os.kill(child.pid, signal.SIGKILL)
                except (OSError, TypeError):
                    pass
                await loop.run_in_executor(None, child.join, 5.0)
        self._cleanup()

    async def _join_all(self) -> None:
        loop = asyncio.get_running_loop()
        for child in self._children:
            await loop.run_in_executor(None, child.join, 10.0)

    def _cleanup(self) -> None:
        if self._ctrl is not None:
            try:
                self._ctrl.close()
            except OSError:
                pass
            self._ctrl = None
        if self._seam_dir:
            shutil.rmtree(self._seam_dir, ignore_errors=True)
            self._seam_dir = ""


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass
