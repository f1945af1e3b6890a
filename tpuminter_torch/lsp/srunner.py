"""srunner: a standalone LSP echo server. Counterpart of
``tpuminter.lsp.srunner``.

Runs :class:`~tpuminter_torch.lsp.LspServer` with no application on top:
every payload read is logged and echoed to its sender, and a lost
connection is logged. Pair it with ``python -m tpuminter_torch.lsp.crunner``
to watch windows, heartbeats, retransmission and loss detection by hand.

Usage: ``python -m tpuminter_torch.lsp.srunner [port] [--drop PCT]``
(``--drop`` injects receive-side loss at the transport seam).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
from typing import Optional

from tpuminter_torch.lsp import LspServer
from tpuminter_torch.lsp.params import FAST

log = logging.getLogger("tpuminter_torch.lsp.srunner")


async def serve(port: int, drop_pct: float = 0.0, on_ready=None) -> None:
    server = await LspServer.create(port, FAST)
    if drop_pct:
        server.endpoint.set_read_drop_rate(drop_pct / 100.0)
    if on_ready is not None:
        on_ready(server.port)  # port 0 binds an ephemeral port; report it
    log.info("echo server on port %d (drop=%.0f%%)", server.port, drop_pct)
    try:
        while True:
            conn_id, payload = await server.read()
            if payload is None:
                log.info("conn %d lost", conn_id)
                continue
            log.info("conn %d -> %r", conn_id, bytes(payload))
            try:
                server.write(conn_id, payload)
            except ConnectionError:
                log.info("conn %d died before echo", conn_id)
    finally:
        await server.close()


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description="LSP echo server (smoke runner)")
    parser.add_argument("port", nargs="?", type=int, default=9090)
    parser.add_argument("--drop", type=float, default=0.0,
                        help="simulated receive packet loss, percent")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    try:
        asyncio.run(serve(args.port, args.drop))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
