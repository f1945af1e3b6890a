"""Per-connection sliding-window state machine, shared by the port's
LSP client and server.

Counterpart of ``tpuminter.lsp.connection.ConnState`` (the machine both
ends of a reference LSP connection run), without the slow-peer
deadlines (the reference's ``read_deadline_epochs``, off in its ``FAST``
settings too): sliding-window send with per-frame retransmit
backoff, in-order buffered delivery, coalesced cumulative + SACK acks,
bundled sends, heartbeats on idle epochs, and loss after
``epoch_limit`` silent epochs.

App payloads of any size are fragmented: each DATA frame carries a
1-byte more-fragments flag and up to ``MAX_PAYLOAD - 1`` bytes, and
in-order delivery makes reassembly a concatenation. Runs entirely on
the event-loop thread; no locks.
"""

from __future__ import annotations

import asyncio
import struct
from collections import OrderedDict, deque
from typing import Callable, Deque, Dict, List, Set

from tpuminter_torch.lsp.message import MAX_PAYLOAD, Frame, MsgType, encode
from tpuminter_torch.lsp.params import Params

#: Fragment flag byte: final (or only) fragment vs more to follow.
_FINAL, _MORE = b"\x00", b"\x01"
#: App bytes per fragment (one byte of each frame is the flag).
FRAGMENT_SIZE = MAX_PAYLOAD - 1
#: Reassembly bound: a peer streaming more-fragments past this is
#: declared lost, so fragmentation cannot grow our memory without bound.
MAX_MESSAGE = 4 << 20
#: Out-of-order seqs carried per coalesced ACK payload (SACK words).
_MAX_SACK = MAX_PAYLOAD // 4
#: Bytes per bundled datagram (several frames back to back), under a
#: 1500-MTU UDP payload.
BUNDLE_BYTES = 1432
#: How long a received burst may wait for app data to piggyback on
#: before its coalesced ack goes out alone.
ACK_DELAY_S = 0.005


class _Pending:
    __slots__ = ("frame", "epochs_waited", "backoff")

    def __init__(self, frame: Frame):
        self.frame = frame
        self.epochs_waited = 0
        self.backoff = 0  # epochs to wait before next retransmit


class ConnState:
    """One reliable connection. ``send_wires`` emits a list of datagrams
    toward the peer, ``request_flush`` schedules :meth:`flush_tx` once
    this event-loop tick, ``deliver`` receives each in-order payload and
    ``on_lost`` fires once if the peer is declared dead."""

    def __init__(
        self,
        conn_id: int,
        params: Params,
        send_wires: Callable[[List[bytes]], None],
        request_flush: Callable[["ConnState"], None],
        deliver: Callable[[bytes], None],
        on_lost: Callable[[str], None],
    ):
        self.conn_id = conn_id
        self.params = params
        self._send_wires_raw = send_wires
        self._request_flush = request_flush
        self._deliver = deliver
        self._on_lost = on_lost

        # send side
        self._next_seq = 1
        self._unacked: "OrderedDict[int, _Pending]" = OrderedDict()
        self._pending: Deque[bytes] = deque()
        self._tx: List[Frame] = []  # this tick's outgoing frames
        self._flush_requested = False
        self._in_flush = False

        # receive side
        self._expected = 1
        self._ooo: Dict[int, bytes] = {}
        self._rx_parts: List[bytes] = []  # fragments of the message in progress
        self._rx_bytes = 0

        # coalesced acks
        self._ack_data_pending = 0  # DATA frames awaiting an ack
        self._ack_extra: Set[int] = set()  # out-of-order seqs to SACK
        self.ack_timer_armed = False  # owner's standalone-ack timer flag

        # liveness
        self._silent_epochs = 0
        self._received_this_epoch = False
        self._sends_this_epoch = 0

        self.lost = False
        self.closing = False
        #: When true, a loss during close emits no loss event (set by the
        #: owner when it initiated the close).
        self.suppress_loss_event = False
        self.closed_event = asyncio.Event()

    # -- helpers ---------------------------------------------------------

    def _send(self, frame: Frame) -> None:
        self._tx.append(frame)
        if not self._flush_requested and not self._in_flush:
            self._flush_requested = True
            self._request_flush(self)

    def _window_open(self) -> bool:
        oldest = next(iter(self._unacked)) if self._unacked else self._next_seq
        return (
            len(self._unacked) < self.params.max_unacked_messages
            and self._next_seq < oldest + self.params.window_size
        )

    def _pump_pending(self) -> None:
        while self._pending and self._window_open():
            self._send_data(self._pending.popleft())

    def _send_data(self, payload: bytes) -> None:
        frame = Frame(MsgType.DATA, self.conn_id, self._next_seq, payload)
        self._next_seq += 1
        self._unacked[frame.seq] = _Pending(frame)
        self._send(frame)

    def _on_fragment(self, data: bytes) -> None:
        """Reassemble one in-order fragment; deliver on the final one. An
        empty frame can only come from a mis-speaking peer: drop it."""
        if not data:
            return
        self._rx_parts.append(data[1:])
        self._rx_bytes += len(data) - 1
        if self._rx_bytes > MAX_MESSAGE:
            self._rx_parts.clear()
            self._rx_bytes = 0
            self.declare_lost(
                f"peer exceeded the {MAX_MESSAGE}-byte reassembly bound"
            )
            return
        if data[:1] == _FINAL:
            parts, self._rx_parts = self._rx_parts, []
            self._rx_bytes = 0
            # a single-fragment message is delivered as the zero-copy view
            self._deliver(parts[0] if len(parts) == 1 else b"".join(parts))

    def _finish_close_if_drained(self) -> None:
        if self.closing and not self._unacked and not self._pending:
            self.closed_event.set()

    # -- public API ------------------------------------------------------

    @property
    def in_flight(self) -> int:
        """DATA frames sent and not yet acknowledged."""
        return len(self._unacked)

    @property
    def acks_pending(self) -> bool:
        """True when received DATA awaits a coalesced ack."""
        return self._ack_data_pending > 0

    @property
    def ack_urgent(self) -> bool:
        """True when the pending ack must not wait the piggyback delay:
        mid-message reassembly or a buffered out-of-order gap means the
        sender is window-blocked on our ack."""
        return bool(self._rx_parts) or bool(self._ooo)

    def write(self, payload: bytes) -> None:
        """Queue an app message of any size for reliable in-order delivery."""
        if self.lost or self.closing:
            raise ConnectionError(f"conn {self.conn_id} is closed or lost")
        if isinstance(payload, memoryview):
            payload = bytes(payload)
        for start in range(0, max(len(payload), 1), FRAGMENT_SIZE):
            part = payload[start : start + FRAGMENT_SIZE]
            flag = _MORE if start + FRAGMENT_SIZE < len(payload) else _FINAL
            if self._window_open():
                self._send_data(flag + part)
            else:
                self._pending.append(flag + part)

    def on_frame(self, frame: Frame) -> None:
        """Handle a decoded frame from the peer."""
        if self.lost:
            return
        self._received_this_epoch = True
        self._silent_epochs = 0
        if frame.type == MsgType.DATA:
            # duplicates still re-arm an ack: our last one may have been lost
            self._ack_data_pending += 1
            if frame.seq >= self._expected and frame.seq not in self._ooo:
                self._ooo[frame.seq] = frame.payload
                while self._expected in self._ooo and not self.lost:
                    self._on_fragment(self._ooo.pop(self._expected))
                    self._expected += 1
            if frame.seq >= self._expected:
                # buffered out of order: rides the ack payload individually
                self._ack_extra.add(frame.seq)
        elif frame.type == MsgType.ACK:
            popped = False
            payload = frame.payload
            if payload:
                # SACK words: u32 seqs acked beyond the cumulative point
                usable = len(payload) - len(payload) % 4
                for (s,) in struct.iter_unpack("<I", payload[:usable]):
                    if self._unacked.pop(s, None) is not None:
                        popped = True
            if frame.seq > 0:
                # cumulative: every DATA frame with seq <= ack seq arrived
                while self._unacked:
                    seq = next(iter(self._unacked))
                    if seq > frame.seq:
                        break
                    del self._unacked[seq]
                    popped = True
            if popped:
                self._pump_pending()
                self._finish_close_if_drained()

    def flush_acks(self) -> None:
        """Queue ONE coalesced ACK for every DATA frame received since the
        last flush: cumulative seq plus SACK payload."""
        if self.lost or not self._ack_data_pending:
            return
        extras = sorted(s for s in self._ack_extra if s >= self._expected)
        del extras[_MAX_SACK:]
        payload = struct.pack(f"<{len(extras)}I", *extras) if extras else b""
        self._ack_data_pending = 0
        self._ack_extra.clear()
        self._send(Frame(MsgType.ACK, self.conn_id, self._expected - 1, payload))

    def flush_tx(self) -> None:
        """Flush this tick's outgoing frames as MTU-bounded bundled
        datagrams, piggybacking the pending coalesced ack."""
        self._in_flush = True
        try:
            if self._ack_data_pending and not self.lost:
                self.flush_acks()
            self._flush_requested = False
            if not self._tx:
                return
            frames, self._tx = self._tx, []
            wires: List[bytes] = []
            bundle = bytearray()
            for f in frames:
                wire = encode(f)
                if bundle and len(bundle) + len(wire) > BUNDLE_BYTES:
                    wires.append(bundle)
                    bundle = bytearray()
                bundle += wire
            if bundle:
                wires.append(bundle)
            # emissions count DATAGRAMS: the heartbeat pad below needs
            # independently lossy datagrams, not frames in one bundle
            self._sends_this_epoch += len(wires)
            self._send_wires_raw(wires)
        finally:
            self._in_flush = False

    def on_epoch(self) -> None:
        """One epoch tick: liveness, retransmits, heartbeat."""
        if self.lost or self.closed_event.is_set():
            return
        if self._received_this_epoch:
            self._silent_epochs = 0
        else:
            self._silent_epochs += 1
            if self._silent_epochs >= self.params.epoch_limit:
                self.declare_lost(f"no traffic for {self._silent_epochs} epochs")
                return
        self._received_this_epoch = False
        self.flush_acks()
        # retransmit with exponential backoff, capped at max_backoff_interval
        for pending in self._unacked.values():
            pending.epochs_waited += 1
            if pending.epochs_waited > pending.backoff:
                self._send(pending.frame)
                pending.epochs_waited = 0
                pending.backoff = min(
                    max(1, pending.backoff * 2), self.params.max_backoff_interval
                ) if self.params.max_backoff_interval > 0 else 0
        self.flush_tx()
        # heartbeat: at least 2 datagrams per epoch, each flushed alone,
        # so one lost datagram never makes a healthy epoch look silent
        while self._sends_this_epoch < 2:
            self._send(Frame(MsgType.ACK, self.conn_id, 0))
            self.flush_tx()
        self._sends_this_epoch = 0

    def close(self) -> None:
        """Graceful close: stop accepting writes, drain in-flight data."""
        self.closing = True
        self._finish_close_if_drained()

    def declare_lost(self, reason: str) -> None:
        if self.lost:
            return
        self.lost = True
        self._unacked.clear()
        self._pending.clear()
        self._tx.clear()
        self._ooo.clear()
        self._rx_parts.clear()
        self._rx_bytes = 0
        self._ack_data_pending = 0
        self._ack_extra.clear()
        self.closed_event.set()
        if not self.suppress_loss_event:
            self._on_lost(reason)
