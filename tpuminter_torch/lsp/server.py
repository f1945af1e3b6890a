"""LSP server. Counterpart of ``tpuminter.lsp.server.LspServer``.

One UDP socket demultiplexes every client by source address; each gets
a conn_id and its own :class:`~tpuminter_torch.lsp.connection.ConnState`.
:meth:`LspServer.read` yields ``(conn_id, payload)`` events in arrival
order, with ``(conn_id, None)`` for a connection declared lost: the
event a coordinator's failure recovery hangs off.

Every connect-ack carries this incarnation's boot epoch, and a frame
from an address the server does not know draws a reset ack, so a peer of
an earlier incarnation learns of the restart in one round trip. Sends of
one event-loop tick are bundled per connection and written in one
grouped pass.

For replication, :meth:`LspServer.reject_conn` drops a connection at
once and forgets its address, so the peer's next datagram draws a reset
ack, and :meth:`LspServer.set_boot_epoch` re-brands a promoted standby's
listener.

For the sharded coordinators (:mod:`tpuminter_torch.multiloop`,
:mod:`tpuminter_torch.multiproc`): ``conn_id_start``/``conn_id_stride``
give shard *k* of *N* the conn ids ≡ *k* (mod *N*), which the kernel's
reuseport steering program reads off each frame; ``ingress_filter``
sees every datagram first and swallows the ones it hands to another
shard, which replays them through :meth:`LspServer.deliver_datagram`;
``reuse_port`` and ``io_batch`` go to the transport. The reference's
slow-peer read deadlines are not copied.
"""

from __future__ import annotations

import asyncio
import random
from typing import Callable, Dict, Optional, Tuple

from tpuminter_torch.lsp.connection import ACK_DELAY_S, ConnState
from tpuminter_torch.lsp.message import (
    EPOCH_CONNECT,
    EPOCH_RESET,
    Frame,
    MsgType,
    decode_all,
    encode,
    encode_epoch,
)
from tpuminter_torch.lsp.params import Params
from tpuminter_torch.lsp.transport import Addr, UdpEndpoint

#: Reset-ack replies to unknown-address traffic per epoch tick: bounds
#: the amplification a spoofed-source datagram storm could extract.
_MAX_RESETS_PER_EPOCH = 256


class LspServer:
    """Reliable multi-client listener. Use :meth:`create` to construct."""

    def __init__(self) -> None:
        self._endpoint: Optional[UdpEndpoint] = None
        self._params = Params()
        self._by_addr: Dict[Addr, ConnState] = {}
        self._by_id: Dict[int, ConnState] = {}
        self._addr_of: Dict[int, Addr] = {}
        self._next_conn_id = 1
        #: conn-id allocation stride (shard k of N allocates ids ≡ k mod N)
        self._conn_id_stride = 1
        #: while set, conn flushes append (addr, wires) here and
        #: _flush_dirty hands the whole tick to send_grouped
        self._tick_pairs = None
        self._events: "asyncio.Queue[Tuple[int, Optional[bytes]]]" = asyncio.Queue()
        self._epoch_task: Optional[asyncio.Task] = None
        self._dirty: set = set()  # conns with frames or acks to flush this tick
        self._reapers: set = set()  # close_conn drain waiters (the loop holds tasks weakly)
        self._flush_scheduled = False
        self._boot_epoch = 0
        self._reset_pinged: set = set()  # addrs reset-acked this epoch

    @classmethod
    async def create(
        cls,
        port: int = 0,
        params: Optional[Params] = None,
        *,
        host: str = "127.0.0.1",
        seed: Optional[int] = None,
        boot_epoch: Optional[int] = None,
        reuse_port: bool = False,
        io_batch: Optional[bool] = None,
        conn_id_start: int = 1,
        conn_id_stride: int = 1,
        ingress_filter: Optional[Callable[[bytes, Addr], bool]] = None,
    ) -> "LspServer":
        """Listen on ``host:port`` (port 0 binds an ephemeral one).
        ``boot_epoch`` is a journaled owner's durable, monotone epoch;
        without one the server draws a random nonzero epoch, distinct
        across restarts but for a 2^-63 chance. ``seed`` seeds the
        endpoint's fault-injection PRNG. ``ingress_filter(data, addr)``
        returns False for a datagram it handed to another shard."""
        self = cls()
        self._params = params or Params()
        self._next_conn_id = conn_id_start
        self._conn_id_stride = max(1, conn_id_stride)
        self._boot_epoch = boot_epoch if boot_epoch is not None else (random.getrandbits(63) | 1)
        if ingress_filter is None:
            on_datagram = self._on_datagram
        else:
            def on_datagram(data, addr, _f=ingress_filter):
                if _f(data, addr):
                    self._on_datagram(data, addr)
        self._endpoint = await UdpEndpoint.create(on_datagram, local_addr=(host, port),
                                                  seed=seed, reuse_port=reuse_port,
                                                  io_batch=io_batch)
        self._epoch_task = asyncio.ensure_future(self._epoch_loop())
        return self

    def deliver_datagram(self, data: bytes, addr: Addr) -> None:
        """Take one datagram as if the socket had received it: the
        delivery seam of a datagram that another shard's socket got."""
        self._on_datagram(data, addr)

    # -- wiring ----------------------------------------------------------

    def _on_datagram(self, data: bytes, addr: Addr) -> None:
        conn = self._by_addr.get(addr)
        stale_conn_id: Optional[int] = None
        for frame in decode_all(data):
            if frame.type == MsgType.CONNECT:
                if conn is None:
                    conn = self._new_conn(addr)
                # (re-)ack the handshake: a duplicate CONNECT means our
                # ack was lost. The ack names this incarnation's epoch.
                self._send_to(addr, Frame(MsgType.ACK, conn.conn_id, 0,
                                          encode_epoch(EPOCH_CONNECT, self._boot_epoch)))
                conn.on_frame(frame)
            elif conn is not None and frame.conn_id == conn.conn_id:
                conn.on_frame(frame)
            elif conn is None:
                # a peer of an earlier incarnation, or one we forgot
                stale_conn_id = frame.conn_id
            # frames for a known addr with a mismatched conn_id: dropped
        if conn is None and stale_conn_id is not None:
            # one reset per addr per epoch, under a global cap: the peer
            # retransmits anyway, and an ack storm must not follow
            if addr not in self._reset_pinged and len(self._reset_pinged) < _MAX_RESETS_PER_EPOCH:
                self._reset_pinged.add(addr)
                self._send_to(addr, Frame(MsgType.ACK, stale_conn_id, 0,
                                          encode_epoch(EPOCH_RESET, self._boot_epoch)))
            return
        if conn is not None and conn.acks_pending:
            if conn.ack_urgent:
                # a window-blocked sender mid-fragmented-message cannot
                # wait the piggyback delay
                conn.flush_tx()
            elif not conn.ack_timer_armed:
                # delayed standalone ack: an answer within ACK_DELAY_S
                # carries it for free
                conn.ack_timer_armed = True
                asyncio.get_running_loop().call_later(ACK_DELAY_S, self._ack_timer_fire, conn)

    def _ack_timer_fire(self, conn: ConnState) -> None:
        conn.ack_timer_armed = False
        conn.flush_tx()

    def _new_conn(self, addr: Addr) -> ConnState:
        conn_id = self._next_conn_id
        self._next_conn_id += self._conn_id_stride
        conn = ConnState(
            conn_id,
            self._params,
            send_wires=lambda wires, a=addr: self._send_wires_to(a, wires),
            request_flush=self._schedule_flush,
            deliver=lambda payload, cid=conn_id: self._events.put_nowait((cid, payload)),
            on_lost=lambda reason, cid=conn_id: self._handle_lost(cid),
        )
        self._by_addr[addr] = conn
        self._by_id[conn_id] = conn
        self._addr_of[conn_id] = addr
        return conn

    def _schedule_flush(self, conn: ConnState) -> None:
        """One bundled flush per event-loop tick per dirty conn."""
        self._dirty.add(conn)
        if not self._flush_scheduled:
            self._flush_scheduled = True
            asyncio.get_running_loop().call_soon(self._flush_dirty)

    def _flush_dirty(self) -> None:
        self._flush_scheduled = False
        dirty, self._dirty = self._dirty, set()
        pairs = self._tick_pairs = []
        try:
            for conn in dirty:
                conn.flush_tx()
        finally:
            self._tick_pairs = None
        if pairs:
            assert self._endpoint is not None
            self._endpoint.send_grouped(pairs)

    def _send_to(self, addr: Addr, frame: Frame) -> None:
        assert self._endpoint is not None
        self._endpoint.send(encode(frame), addr)

    def _send_wires_to(self, addr: Addr, wires) -> None:
        if self._tick_pairs is not None:
            self._tick_pairs.append((addr, wires))
            return
        assert self._endpoint is not None
        self._endpoint.send_batch(wires, addr)

    def _handle_lost(self, conn_id: int) -> None:
        self._events.put_nowait((conn_id, None))
        self._forget(conn_id)

    def _forget(self, conn_id: int) -> None:
        addr = self._addr_of.pop(conn_id, None)
        if addr is not None:
            self._by_addr.pop(addr, None)
        conn = self._by_id.pop(conn_id, None)
        if conn is not None:
            self._dirty.discard(conn)

    async def _epoch_loop(self) -> None:
        while True:
            await asyncio.sleep(self._params.epoch_seconds)
            self._reset_pinged.clear()
            for conn in list(self._by_id.values()):
                conn.on_epoch()

    # -- public API ------------------------------------------------------

    @property
    def port(self) -> int:
        assert self._endpoint is not None
        return self._endpoint.local_addr[1]

    @property
    def boot_epoch(self) -> int:
        """This incarnation's identity (see ``message.EPOCH_CONNECT``)."""
        return self._boot_epoch

    @property
    def params(self) -> Params:
        """The LSP settings this listener runs: a coordinator's shipping
        lanes dial its standbys with the same ones."""
        return self._params

    @property
    def conn_ids(self) -> Tuple[int, ...]:
        return tuple(self._by_id)

    async def read(self) -> Tuple[int, Optional[bytes]]:
        """Next event from any client: ``(conn_id, payload)``, where a
        ``None`` payload means the connection was declared lost.
        Single-fragment payloads are zero-copy ``memoryview``s."""
        return await self._events.get()

    def read_nowait(self) -> Optional[Tuple[int, Optional[bytes]]]:
        """The already-queued next event, or None: lets an owner drain a
        burst without one task wakeup per message."""
        try:
            return self._events.get_nowait()
        except asyncio.QueueEmpty:
            return None

    def write(self, conn_id: int, payload: bytes) -> None:
        conn = self._by_id.get(conn_id)
        if conn is None:
            raise ConnectionError(f"conn {conn_id} does not exist (or was lost)")
        conn.write(payload)

    def reject_conn(self, conn_id: int) -> None:
        """Drop one connection now: no drain, no loss event here, and its
        address forgotten, so the peer's next datagram draws a reset ack
        and its client declares the connection lost in one round trip
        (a fenced primary, or a miner dialing an unpromoted standby)."""
        conn = self._by_id.get(conn_id)
        if conn is None:
            return
        addr = self._addr_of.get(conn_id)
        conn.suppress_loss_event = True
        conn.declare_lost("rejected by owner")
        self._forget(conn_id)
        # the reset goes out even if one was spent this epoch elsewhere
        self._reset_pinged.discard(addr)

    def set_boot_epoch(self, epoch: int) -> None:
        """Re-brand the listener with a promoted standby's fenced epoch;
        connect-acks and reset acks name it from now on."""
        self._boot_epoch = epoch
        self._reset_pinged.clear()

    def close_conn(self, conn_id: int) -> None:
        """Close one connection: refuse further writes, keep it ticking
        until in-flight data drains (or the peer is declared dead), then
        forget it. No loss event is emitted for a connection we closed."""
        conn = self._by_id.get(conn_id)
        if conn is None:
            return
        conn.suppress_loss_event = True
        conn.close()

        async def _reap() -> None:
            await conn.closed_event.wait()
            self._forget(conn_id)

        if conn.closed_event.is_set():
            self._forget(conn_id)
        else:
            task = asyncio.ensure_future(_reap())
            self._reapers.add(task)
            task.add_done_callback(self._reapers.discard)

    def crash(self) -> None:
        """Die like ``kill -9``: the socket closes with no drain and the
        epoch loop stops; nothing is flushed and no peer hears goodbye."""
        if self._epoch_task is not None:
            self._epoch_task.cancel()
        if self._endpoint is not None:
            self._endpoint.close()

    async def close(self, drain_timeout: Optional[float] = None) -> None:
        """Close every connection, draining in-flight data first (bounded
        by ``drain_timeout``; a dead peer unblocks via loss detection)."""
        conns = list(self._by_id.values())
        for conn_id in list(self._by_id):
            self.close_conn(conn_id)
        if conns:
            try:
                await asyncio.wait_for(
                    asyncio.gather(*(c.closed_event.wait() for c in conns)), drain_timeout)
            except asyncio.TimeoutError:
                pass
        if self._epoch_task is not None:
            self._epoch_task.cancel()
        if self._endpoint is not None:
            self._endpoint.close()

    @property
    def endpoint(self) -> UdpEndpoint:
        """The transport seam, exposed for fault injection."""
        assert self._endpoint is not None
        return self._endpoint
