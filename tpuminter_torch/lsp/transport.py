"""The UDP socket under an LSP client.

Counterpart of ``tpuminter.lsp.transport.UdpEndpoint`` in its default
batched mode: the endpoint owns a non-blocking socket, ``add_reader``
fires once per readability edge and a bounded burst of ``recvfrom``
calls drains what the kernel queued. Sends go straight to ``sendto``;
the rare EAGAIN parks the datagram until ``add_writer`` says the socket
drained, so nothing the caller sent is silently lost locally. The
reference's fault-injection knobs and stdlib-transport mode serve its
own tests and the server side, and are not copied.
"""

from __future__ import annotations

import asyncio
import socket as _socket
from collections import deque
from typing import Callable, Deque, Optional, Tuple

Addr = Tuple[str, int]

#: Datagrams drained per readability wakeup.
RECV_BURST = 64


class UdpEndpoint:
    """A non-blocking UDP socket driven by the running event loop."""

    def __init__(self, on_datagram: Callable[[bytes, Addr], None]):
        self._on_datagram = on_datagram
        self._loop = asyncio.get_running_loop()
        self._sock: Optional[_socket.socket] = None
        self._send_backlog: Deque[Tuple[bytes, Addr]] = deque()
        self._writer_armed = False

    @classmethod
    async def create(cls, on_datagram: Callable[[bytes, Addr], None]) -> "UdpEndpoint":
        """An endpoint on an ephemeral local port."""
        self = cls(on_datagram)
        sock = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
        try:
            sock.setblocking(False)
            sock.bind(("0.0.0.0", 0))
        except BaseException:
            sock.close()
            raise
        self._sock = sock
        self._loop.add_reader(sock.fileno(), self._on_readable)
        return self

    def _on_readable(self) -> None:
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
            self._on_datagram(data, addr[:2])

    def send(self, data: bytes, addr: Addr) -> None:
        """Send one datagram; UDP may lose it, this endpoint does not."""
        if self._sock is None:
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
            pass  # unreachable/iface error: the datagram is lost, as UDP allows

    def send_batch(self, datagrams, addr: Addr) -> None:
        """Several datagrams to one peer."""
        for data in datagrams:
            self.send(data, addr)

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
                pass  # lost, as above
            self._send_backlog.popleft()
        self._writer_armed = False
        self._loop.remove_writer(sock.fileno())

    def close(self) -> None:
        sock, self._sock = self._sock, None
        if sock is None:
            return
        self._loop.remove_reader(sock.fileno())
        if self._writer_armed:
            self._loop.remove_writer(sock.fileno())
        sock.close()
        self._send_backlog.clear()
