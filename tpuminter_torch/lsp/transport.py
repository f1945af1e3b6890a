"""The UDP socket under the port's LSP client and server.

Counterpart of ``tpuminter.lsp.transport.UdpEndpoint`` in its default
batched mode: the endpoint owns a non-blocking socket, ``add_reader``
fires once per readability edge and a bounded burst of ``recvfrom``
calls drains what the kernel queued. Sends go straight to ``sendto``;
the rare EAGAIN parks the datagram until ``add_writer`` says the socket
drained, so nothing the caller sent is silently lost locally.

**Fault injection** (the reference's ``lspnet`` seam): drop, duplicate
and reorder rates for each direction, all drawn from one seeded PRNG so
a test's fault pattern is reproducible. ``send_batch`` and
``send_grouped`` are the server's gathered writes; with a fault rate set
they fall back to one :meth:`send` a datagram, so the faults hit each
datagram as a looped send would.

**Fault plans** (the reference's per-link seam): :meth:`UdpEndpoint.
set_fault_plan` installs a plan object that this module reads through
``decide(direction, addr)`` and ``arm()`` only. A datagram the plan
rules on (``("drop", reason)`` or ``("deliver", delays)``) is governed by
it instead of the rates; ``None`` falls through to them. The plan class
itself is the chaos module's.

**The stdlib mode** (``io_batch=False``, the coordinator's ``--io-batch
off``): the endpoint is an ``asyncio.DatagramProtocol`` on the stdlib
datagram transport, one wakeup a datagram, the A/B baseline of the
batched mode. The faults act above the I/O mode, so both modes draw the
same faults from the same seed.

**Shared ports** (``reuse_port=True``): the socket binds with
``SO_REUSEPORT``, so the sharded coordinators (:mod:`tpuminter_torch.
multiloop`, :mod:`tpuminter_torch.multiproc`) bind one socket a shard to
one port; :attr:`UdpEndpoint.sock` is where they attach the kernel's
steering program.
"""

from __future__ import annotations

import asyncio
import random
import socket as _socket
from collections import deque
from typing import Callable, Deque, List, Optional, Tuple

Addr = Tuple[str, int]

#: Datagrams drained per readability wakeup.
RECV_BURST = 64

#: I/O mode of a new endpoint when the caller names none (False: the
#: stdlib datagram transport).
IO_BATCH_DEFAULT = True


class UdpEndpoint(asyncio.DatagramProtocol):
    """A non-blocking UDP socket driven by the running event loop, with
    injectable loss, duplication and reordering (rates in [0, 1])."""

    def __init__(self, on_datagram: Callable[[bytes, Addr], None],
                 seed: Optional[int] = None):
        self._on_datagram = on_datagram
        self._loop = asyncio.get_running_loop()
        #: batched mode's raw socket (None in the stdlib mode)
        self._sock: Optional[_socket.socket] = None
        #: stdlib mode's transport (None in the batched mode)
        self._transport: Optional[asyncio.DatagramTransport] = None
        self._send_backlog: Deque[Tuple[bytes, Addr]] = deque()
        self._writer_armed = False
        self._closed = self._loop.create_future()
        self._rng = random.Random(seed)
        #: per-link fault plan, consulted before the rates
        self.fault_plan = None
        self.write_drop_rate = 0.0
        self.read_drop_rate = 0.0
        self.write_dup_rate = 0.0
        self.read_dup_rate = 0.0
        self.write_reorder_rate = 0.0
        self.read_reorder_rate = 0.0
        #: seconds a reordered datagram is held back
        self.reorder_delay = 0.05
        self.dropped_out = 0
        self.dropped_in = 0
        self.duplicated_out = 0
        self.duplicated_in = 0
        self.reordered_out = 0
        self.reordered_in = 0
        self.partitioned_out = 0
        self.partitioned_in = 0
        #: datagrams that left and arrived (after the faults), and
        #: readability wakeups of the batched mode
        self.sent = 0
        self.received = 0
        self.read_wakeups = 0

    @classmethod
    async def create(cls, on_datagram: Callable[[bytes, Addr], None],
                     local_addr: Optional[Addr] = None,
                     seed: Optional[int] = None, *, reuse_port: bool = False,
                     io_batch: Optional[bool] = None) -> "UdpEndpoint":
        """An endpoint bound to ``local_addr`` (an ephemeral port on
        every interface when None); ``seed`` seeds the fault PRNG,
        ``reuse_port`` binds with ``SO_REUSEPORT`` and ``io_batch``
        picks the I/O mode (None: :data:`IO_BATCH_DEFAULT`)."""
        loop = asyncio.get_running_loop()
        if io_batch is None:
            io_batch = IO_BATCH_DEFAULT
        if not io_batch:
            _, protocol = await loop.create_datagram_endpoint(
                lambda: cls(on_datagram, seed=seed), local_addr=local_addr or ("0.0.0.0", 0),
                reuse_port=reuse_port or None)
            return protocol
        self = cls(on_datagram, seed=seed)
        sock = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
        try:
            if reuse_port:
                sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEPORT, 1)
            sock.setblocking(False)
            sock.bind(local_addr or ("0.0.0.0", 0))
        except BaseException:
            sock.close()
            raise
        self._sock = sock
        self._loop.add_reader(sock.fileno(), self._on_readable)
        return self

    # -- asyncio.DatagramProtocol (the stdlib mode) ----------------------

    def connection_made(self, transport) -> None:
        self._transport = transport

    def connection_lost(self, exc: Optional[Exception]) -> None:
        if not self._closed.done():
            self._closed.set_result(None)

    def datagram_received(self, data: bytes, addr) -> None:
        self._received(data, addr[:2])

    @property
    def local_addr(self) -> Addr:
        if self._sock is not None:
            return self._sock.getsockname()[:2]
        assert self._transport is not None
        return self._transport.get_extra_info("sockname")[:2]

    @property
    def sock(self) -> Optional[_socket.socket]:
        """The batched mode's socket (None in the stdlib mode): where a
        sharded coordinator attaches its reuseport steering program."""
        return self._sock

    def _is_closing(self) -> bool:
        if self._sock is not None:
            return False
        return self._transport is None or self._transport.is_closing()

    def _on_readable(self) -> None:
        self.read_wakeups += 1
        for _ in range(RECV_BURST):
            sock = self._sock
            if sock is None:
                return  # a handler closed us mid-burst
            try:
                data, addr = sock.recvfrom(65536)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return  # socket died under us; close() handles lifecycle
            self._received(data, addr[:2])

    def _received(self, data: bytes, addr: Addr) -> None:
        if self.fault_plan is not None:
            verdict = self.fault_plan.decide("in", addr)
            if verdict is not None:
                self._apply_plan_verdict(verdict, data, addr, inbound=True)
                return
        if self.read_drop_rate > 0 and self._rng.random() < self.read_drop_rate:
            self.dropped_in += 1
            return
        copies = 1
        if self.read_dup_rate > 0 and self._rng.random() < self.read_dup_rate:
            self.duplicated_in += 1
            copies = 2
        for _ in range(copies):
            if self.read_reorder_rate > 0 and self._rng.random() < self.read_reorder_rate:
                self.reordered_in += 1
                self._loop.call_later(self.reorder_delay, self._deliver, data, addr)
            else:
                self._deliver(data, addr)

    def _apply_plan_verdict(self, verdict, data: bytes, addr: Addr, *, inbound: bool) -> None:
        """Carry out a plan's decision for one datagram: the plan drew
        drop, dup and delays; this books the counters and sends or
        delivers each surviving copy after its delay."""
        kind, detail = verdict
        if kind == "drop":
            if detail == "partition":
                if inbound:
                    self.partitioned_in += 1
                else:
                    self.partitioned_out += 1
            elif inbound:
                self.dropped_in += 1
            else:
                self.dropped_out += 1
            return
        if len(detail) > 1:
            if inbound:
                self.duplicated_in += len(detail) - 1
            else:
                self.duplicated_out += len(detail) - 1
        emit = self._deliver if inbound else self._send_raw
        for held in detail:
            if held > 0:
                if inbound:
                    self.reordered_in += 1
                else:
                    self.reordered_out += 1
                self._loop.call_later(held, emit, data, addr)
            else:
                emit(data, addr)

    def _deliver(self, data: bytes, addr: Addr) -> None:
        if self._is_closing():
            return  # a held-back datagram outlived the socket
        self.received += 1
        self._on_datagram(data, addr)

    def _faulty(self) -> bool:
        return (self.write_drop_rate > 0 or self.write_dup_rate > 0
                or self.write_reorder_rate > 0 or self.fault_plan is not None)

    def send(self, data: bytes, addr: Addr) -> None:
        """Send one datagram, subject to the injected write faults."""
        if self._is_closing():
            return
        if self.fault_plan is not None:
            verdict = self.fault_plan.decide("out", addr)
            if verdict is not None:
                self._apply_plan_verdict(verdict, data, addr, inbound=False)
                return
        if self.write_drop_rate > 0 and self._rng.random() < self.write_drop_rate:
            self.dropped_out += 1
            return
        copies = 1
        if self.write_dup_rate > 0 and self._rng.random() < self.write_dup_rate:
            self.duplicated_out += 1
            copies = 2
        for _ in range(copies):
            if self.write_reorder_rate > 0 and self._rng.random() < self.write_reorder_rate:
                self.reordered_out += 1
                self._loop.call_later(self.reorder_delay, self._send_raw, data, addr)
            else:
                self._send_raw(data, addr)

    def send_batch(self, datagrams, addr: Addr) -> None:
        """Several datagrams to one peer."""
        if self._faulty():
            for data in datagrams:
                self.send(data, addr)
            return
        for data in datagrams:
            self._send_raw(data, addr)

    def send_grouped(self, pairs: List[Tuple[Addr, List[bytes]]]) -> None:
        """One event-loop tick's datagrams to every peer, in one call."""
        for addr, datagrams in pairs:
            self.send_batch(datagrams, addr)

    def _send_raw(self, data: bytes, addr: Addr) -> None:
        """UDP may lose the datagram; this endpoint does not."""
        if self._is_closing():
            return  # a held-back datagram outlived the socket
        self.sent += 1
        if self._sock is None:
            self._transport.sendto(data, addr)
            return
        if self._send_backlog:
            self._send_backlog.append((data, addr))
            return
        try:
            self._sock.sendto(data, addr)
        except (BlockingIOError, InterruptedError):
            self._send_backlog.append((data, addr))
            self._arm_writer()
        except OSError:
            self._unsent()  # unreachable/iface error: lost, as UDP allows

    def _unsent(self) -> None:
        """A datagram booked as sent never left."""
        self.sent -= 1
        self.dropped_out += 1

    def _arm_writer(self) -> None:
        if not self._writer_armed and self._sock is not None:
            self._writer_armed = True
            self._loop.add_writer(self._sock.fileno(), self._on_writable)

    def _on_writable(self) -> None:
        sock = self._sock
        if sock is None:
            return
        while self._send_backlog:
            data, addr = self._send_backlog[0]
            try:
                sock.sendto(data, addr)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._unsent()  # lost, as above
            self._send_backlog.popleft()
        self._writer_armed = False
        self._loop.remove_writer(sock.fileno())

    def set_write_drop_rate(self, rate: float) -> None:
        self.write_drop_rate = rate

    def set_read_drop_rate(self, rate: float) -> None:
        self.read_drop_rate = rate

    def set_fault_rates(self, *, drop: Optional[float] = None, dup: Optional[float] = None,
                        reorder: Optional[float] = None) -> None:
        """Set any fault class symmetrically in both directions."""
        if drop is not None:
            self.write_drop_rate = self.read_drop_rate = drop
        if dup is not None:
            self.write_dup_rate = self.read_dup_rate = dup
        if reorder is not None:
            self.write_reorder_rate = self.read_reorder_rate = reorder

    def set_fault_plan(self, plan) -> None:
        """Install (or clear, with None) a per-link fault plan and arm
        its clock, so its timed partitions count from now."""
        self.fault_plan = plan
        if plan is not None:
            plan.arm()

    def close(self) -> None:
        if self._sock is None:
            if self._transport is not None and not self._transport.is_closing():
                self._transport.close()
            return
        sock, self._sock = self._sock, None
        self._loop.remove_reader(sock.fileno())
        if self._writer_armed:
            self._loop.remove_writer(sock.fileno())
        sock.close()
        for _ in self._send_backlog:
            self._unsent()
        self._send_backlog.clear()
        if not self._closed.done():
            self._closed.set_result(None)

    async def wait_closed(self) -> None:
        await self._closed
