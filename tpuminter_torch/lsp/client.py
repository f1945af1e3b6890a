"""LSP client. Counterpart of ``tpuminter.lsp.client.LspClient``.

Connect handshake with per-epoch retransmission, then one
:class:`~tpuminter_torch.lsp.connection.ConnState` drives the reliable
stream.
"""

from __future__ import annotations

import asyncio
from typing import Optional, Tuple, Union

from tpuminter_torch.lsp.connection import ACK_DELAY_S, ConnState
from tpuminter_torch.lsp.message import (
    EPOCH_CONNECT,
    EPOCH_RESET,
    Frame,
    MsgType,
    decode_all,
    decode_epoch,
    encode,
)
from tpuminter_torch.lsp.params import Params
from tpuminter_torch.lsp.transport import UdpEndpoint


class LspError(Exception):
    """Base class for LSP errors."""


class LspConnectionLost(LspError):
    """The peer was declared dead (epoch_limit silent epochs) or closed."""

    def __init__(self, conn_id: int, reason: str = "connection lost"):
        super().__init__(f"conn {conn_id}: {reason}")
        self.conn_id = conn_id


class LspConnectError(LspError):
    """The initial connect handshake never completed."""


_LOST = object()  # sentinel in the receive queue


class LspClient:
    """Reliable connection to an LSP server. Use :meth:`connect` to
    construct. ``read`` blocks for the next in-order payload and raises
    :class:`LspConnectionLost` once the server is declared dead (buffered
    payloads are delivered first)."""

    def __init__(self) -> None:
        self._endpoint: Optional[UdpEndpoint] = None
        self._server_addr: Tuple[str, int] = ("", 0)
        self._params = Params()
        self._conn: Optional[ConnState] = None
        self._recv: "asyncio.Queue[Union[bytes, object]]" = asyncio.Queue()
        self._connect_waiter: Optional[asyncio.Future] = None
        self._epoch_task: Optional[asyncio.Task] = None
        self._lost_reason: Optional[str] = None
        self._ack_flush_scheduled = False
        #: the server incarnation this session belongs to (boot epoch
        #: from the connect-ack; 0 until learned)
        self._server_epoch = 0

    @classmethod
    async def connect(
        cls, host: str, port: int, params: Optional[Params] = None, *,
        connect_epochs: Optional[int] = None, seed: Optional[int] = None,
    ) -> "LspClient":
        """Dial the server; raises :class:`LspConnectError` after
        ``epoch_limit`` epochs without a connect-ack, or after
        ``connect_epochs`` when given: a role rotating through an
        address list wants a dead address to fail fast, while the
        session keeps ``params.epoch_limit`` for its liveness. ``seed``
        seeds the endpoint's fault-injection PRNG."""
        dials = connect_epochs or (params or Params()).epoch_limit
        self = cls()
        self._params = params or Params()
        self._server_addr = (host, port)
        self._endpoint = await UdpEndpoint.create(self._on_datagram, seed=seed)
        self._connect_waiter = asyncio.get_running_loop().create_future()
        connect_frame = encode(Frame(MsgType.CONNECT, 0, 0))
        try:
            for _ in range(dials):
                self._endpoint.send(connect_frame, self._server_addr)
                # asyncio.wait, not wait_for: it never swallows a
                # cancellation that races the ack
                await asyncio.wait(
                    [self._connect_waiter], timeout=self._params.epoch_seconds
                )
                if self._connect_waiter.done():
                    conn_id, self._server_epoch = self._connect_waiter.result()
                    break
            else:
                raise LspConnectError(
                    f"no connect-ack from {host}:{port} after {dials} epochs"
                )
        except BaseException:
            self._endpoint.close()  # a failed or cancelled dial releases the socket
            raise
        self._conn = ConnState(
            conn_id,
            self._params,
            send_wires=self._send_wires,
            request_flush=self._schedule_flush,
            deliver=self._recv.put_nowait,
            on_lost=self._handle_lost,
        )
        self._epoch_task = asyncio.ensure_future(self._epoch_loop())
        return self

    # -- wiring ----------------------------------------------------------

    def _send_wires(self, wires) -> None:
        assert self._endpoint is not None
        self._endpoint.send_batch(wires, self._server_addr)

    def _on_datagram(self, data: bytes, addr: Tuple[str, int]) -> None:
        for frame in decode_all(data):
            epoch_info = (
                decode_epoch(frame.payload)
                if frame.type == MsgType.ACK and frame.seq == 0
                and frame.payload else None
            )
            if self._conn is None:
                # handshake: the connect-ack is ACK seq 0 with our id and,
                # from a modern server, the boot-epoch payload
                if (
                    frame.type == MsgType.ACK
                    and frame.seq == 0
                    and (epoch_info is None or epoch_info[0] == EPOCH_CONNECT)
                    and self._connect_waiter is not None
                    and not self._connect_waiter.done()
                ):
                    self._connect_waiter.set_result(
                        (frame.conn_id, epoch_info[1] if epoch_info else 0)
                    )
                continue
            if epoch_info is not None:
                # a RESET, or a connect-ack of another incarnation, means
                # the server restarted: never resume stale sequence state.
                # An epoch of 0 means we never learned ours (the stamped
                # ack was lost and a heartbeat completed the handshake).
                kind, epoch = epoch_info
                if kind == EPOCH_RESET:
                    self._conn.declare_lost(
                        "server restarted or forgot this connection (reset ack)"
                    )
                elif self._server_epoch == 0:
                    self._server_epoch = epoch
                elif epoch != self._server_epoch:
                    self._conn.declare_lost(
                        f"server restarted (boot epoch {self._server_epoch} -> {epoch})"
                    )
                continue
            if frame.conn_id == self._conn.conn_id:
                self._conn.on_frame(frame)
        conn = self._conn
        if conn is not None and conn.acks_pending:
            if conn.ack_urgent:
                conn.flush_tx()
            elif not conn.ack_timer_armed:
                # delayed standalone ack: a response within the delay
                # carries it for free
                conn.ack_timer_armed = True
                asyncio.get_running_loop().call_later(
                    ACK_DELAY_S, self._ack_timer_fire
                )

    def _ack_timer_fire(self) -> None:
        if self._conn is not None:
            self._conn.ack_timer_armed = False
            self._conn.flush_tx()

    def _schedule_flush(self, conn) -> None:
        if not self._ack_flush_scheduled:
            self._ack_flush_scheduled = True
            asyncio.get_running_loop().call_soon(self._flush_tx_cb)

    def _flush_tx_cb(self) -> None:
        self._ack_flush_scheduled = False
        if self._conn is not None:
            self._conn.flush_tx()

    def _handle_lost(self, reason: str) -> None:
        self._lost_reason = reason
        self._recv.put_nowait(_LOST)

    async def _epoch_loop(self) -> None:
        while self._conn is not None and not self._conn.closed_event.is_set():
            await asyncio.sleep(self._params.epoch_seconds)
            self._conn.on_epoch()

    # -- public API ------------------------------------------------------

    @property
    def conn_id(self) -> int:
        assert self._conn is not None
        return self._conn.conn_id

    @property
    def is_lost(self) -> bool:
        return self._conn is not None and self._conn.lost

    @property
    def endpoint(self) -> UdpEndpoint:
        """The transport seam, exposed for fault injection."""
        assert self._endpoint is not None
        return self._endpoint

    def write(self, payload: bytes) -> None:
        """Queue a payload for reliable in-order delivery."""
        if self._conn is None or self._conn.lost:
            raise LspConnectionLost(
                self.conn_id if self._conn else -1,
                self._lost_reason or "not connected",
            )
        self._conn.write(payload)

    async def read(self) -> bytes:
        """Next in-order payload from the server (single-fragment messages
        arrive as a zero-copy ``memoryview``)."""
        item = await self._recv.get()
        if item is _LOST:
            self._recv.put_nowait(_LOST)  # subsequent reads keep failing
            raise LspConnectionLost(
                self.conn_id, self._lost_reason or "connection lost"
            )
        return item  # type: ignore[return-value]

    async def close(self, drain_timeout: Optional[float] = None) -> None:
        """Graceful close: wait until pending writes are acked (loss
        detection unblocks the drain; ``drain_timeout`` bounds it)."""
        if self._conn is not None:
            self._conn.suppress_loss_event = True
            self._conn.close()
            try:
                await asyncio.wait_for(self._conn.closed_event.wait(), drain_timeout)
            except asyncio.TimeoutError:
                pass
            if self._lost_reason is None:
                self._lost_reason = "closed locally"
            self._recv.put_nowait(_LOST)  # unblock readers racing the close
        if self._epoch_task is not None:
            self._epoch_task.cancel()
        if self._endpoint is not None:
            self._endpoint.close()
