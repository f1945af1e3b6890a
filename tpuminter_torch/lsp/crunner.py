"""crunner: a standalone LSP client. Counterpart of
``tpuminter.lsp.crunner``.

Connects an :class:`~tpuminter_torch.lsp.LspClient` to an srunner (or any
LSP server), sends each message argument and prints every reply, then
reports loss-free completion. With no message arguments it sends a
numbered ping a second until interrupted.

Usage: ``python -m tpuminter_torch.lsp.crunner <host:port> [msg ...] [--drop PCT]``
"""

from __future__ import annotations

import argparse
import asyncio
import itertools
import logging
from typing import Optional

from tpuminter_torch.lsp import LspClient, LspConnectionLost
from tpuminter_torch.lsp.params import FAST

log = logging.getLogger("tpuminter_torch.lsp.crunner")


async def run(host: str, port: int, messages, drop_pct: float = 0.0) -> None:
    client = await LspClient.connect(host, port, FAST)
    if drop_pct:
        client.endpoint.set_read_drop_rate(drop_pct / 100.0)
    log.info("connected, conn_id=%d", client.conn_id)
    try:
        if messages:
            for msg in messages:
                client.write(msg.encode())
            for _ in messages:
                # read() may hand back a zero-copy memoryview
                print(bytes(await client.read()).decode(errors="replace"))
            print(f"done: {len(messages)} replies, in order, loss-free")
        else:
            for i in itertools.count():
                client.write(f"ping {i}".encode())
                print(bytes(await client.read()).decode(errors="replace"))
                await asyncio.sleep(1.0)
    except LspConnectionLost:
        print("Disconnected")
    finally:
        await client.close(drain_timeout=2.0)


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description="LSP client (smoke runner)")
    parser.add_argument("hostport")
    parser.add_argument("messages", nargs="*")
    parser.add_argument("--drop", type=float, default=0.0,
                        help="simulated receive packet loss, percent")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    host, _, port = args.hostport.rpartition(":")
    try:
        asyncio.run(run(host or "127.0.0.1", int(port), args.messages, args.drop))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
