"""Worker role: the Miner interface, the LSP role loop and the CLI.

Counterpart of ``tpuminter.worker`` (``Miner``, ``run_miner``, ``main``)
for a worker that speaks the classic dialect only: it joins with the
JSON codec, without the roll-budget dialect and with no workloads, so
an unchanged ``tpuminter`` coordinator sends it JSON ``Setup``, ``Assign``
and ``Cancel`` messages and nothing else. A chunk its miner cannot
serve (a rolled or SCRYPT job, a workload) is answered with a
``Refuse``, which makes the coordinator requeue it.

Run it as ``python -m tpuminter_torch.worker HOST:PORT``.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import replace as dc_replace
from typing import Iterator, Optional

from tpuminter_torch.lsp import FAST, LspClient, LspConnectionLost, Params
from tpuminter_torch.protocol import (
    Assign,
    Cancel,
    Join,
    Message,
    ProtocolError,
    Refuse,
    Request,
    Result,
    Setup,
    decode_msg,
    encode_msg,
)

__all__ = ["Miner", "run_miner", "main"]

log = logging.getLogger("tpuminter_torch.worker")

#: Setup templates kept per connection (oldest evicted first; a Cancel
#: evicts eagerly, and a missing template is healed by the Refuse seam)
_TEMPLATE_CAP = 256


class Miner:
    """The interface every backend satisfies.

    Subclasses set ``backend``/``lanes``/``span`` (advertised in
    ``Join``) and implement :meth:`mine` as a generator: yield ``None``
    whenever it is safe to pause, then the chunk's ``Result`` exactly
    once. The caller may abandon the generator (on Cancel), so resources
    must not depend on exhaustion.
    """

    backend = "abstract"
    lanes = 1
    #: internal pipeline-stage size in nonces (Join.span; 0 = none)
    span = 0

    def unsupported(self, request: Request) -> Optional[str]:
        """Why this miner cannot serve ``request``, or None if it can."""
        return None

    def mine(self, request: Request) -> Iterator[Optional[Result]]:
        raise NotImplementedError


def _safe_decode(raw) -> Optional[Message]:
    try:
        return decode_msg(raw)
    except ProtocolError as exc:
        log.warning("worker: dropping message: %s", exc)
        return None


async def run_miner(
    host: str, port: int, miner: Miner, *, params: Optional[Params] = None,
) -> None:
    """Worker role main loop; returns when the coordinator is lost.

    Generator steps run in an executor thread, so a step that waits on
    the device or builds the kernels never stalls the event loop and the
    LSP heartbeats keep flowing. While a chunk is mined one read stays in
    flight, so a ``Cancel`` for the active job abandons it at the next
    step; any other message read meanwhile is queued and handled after.
    """
    client = await LspClient.connect(host, port, params or FAST)
    client.write(encode_msg(Join(backend=miner.backend, lanes=miner.lanes, span=miner.span)))
    pending: "asyncio.Queue[Message]" = asyncio.Queue()
    read_task: Optional[asyncio.Task] = None
    templates: dict = {}  # job_id -> template Request from a Setup
    loop = asyncio.get_running_loop()
    try:
        while True:
            if not pending.empty():
                msg = pending.get_nowait()
            else:
                if read_task is None:
                    read_task = asyncio.ensure_future(client.read())
                raw = await read_task
                read_task = None
                msg = _safe_decode(raw)
                if msg is None:
                    continue
            if isinstance(msg, Cancel):
                templates.pop(msg.job_id, None)
                continue  # not the job being mined: stale
            if isinstance(msg, Setup):
                templates[msg.request.job_id] = msg.request
                while len(templates) > _TEMPLATE_CAP:
                    templates.pop(next(iter(templates)))
                continue
            if isinstance(msg, Assign):
                tmpl = templates.get(msg.job_id)
                if tmpl is None:
                    # the coordinator requeues the chunk and re-ships the Setup
                    log.warning("worker: no template for job %d; refusing chunk %d",
                                msg.job_id, msg.chunk_id)
                    client.write(encode_msg(Refuse(msg.job_id, msg.chunk_id)))
                    continue
                msg = dc_replace(tmpl, lower=msg.lower, upper=msg.upper,
                                 chunk_id=msg.chunk_id)
            if not isinstance(msg, Request):
                log.warning("worker: unexpected %s, dropping", type(msg).__name__)
                continue
            reason = miner.unsupported(msg)
            if reason is not None:
                log.warning("worker: refusing chunk %d of job %d: %s",
                            msg.chunk_id, msg.job_id, reason)
                client.write(encode_msg(Refuse(msg.job_id, msg.chunk_id)))
                continue

            gen = miner.mine(msg)
            result: Optional[Result] = None
            cancelled = False
            done = object()
            while True:
                item = await loop.run_in_executor(None, next, gen, done)
                if item is done:
                    break  # generator ended without a Result
                if item is not None:
                    result = item
                    break
                if read_task is None:
                    read_task = asyncio.ensure_future(client.read())
                if read_task.done():
                    raw = read_task.result()  # raises here if the conn is lost
                    read_task = None
                    inner = _safe_decode(raw)
                    if isinstance(inner, Cancel) and inner.job_id == msg.job_id:
                        # consumed here, so evict the template here too:
                        # queued Assigns of the dead job then take the
                        # Refuse seam instead of mining retired work
                        cancelled = True
                        templates.pop(inner.job_id, None)
                        break
                    if inner is not None:
                        pending.put_nowait(inner)
            if cancelled or result is None:
                log.info("worker: job %d cancelled mid-chunk", msg.job_id)
                continue
            client.write(encode_msg(result))
    except LspConnectionLost:
        log.info("worker: coordinator lost, exiting")
    finally:
        if read_task is not None:
            read_task.cancel()
        await client.close(drain_timeout=2.0)


def _parse_hostport(value: str):
    host, sep, port = value.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"expected HOST:PORT, got {value!r}")
    return host, int(port)


def main(argv: Optional[list] = None) -> None:
    """CLI: ``python -m tpuminter_torch.worker HOST:PORT [--device cuda]``."""
    import argparse

    parser = argparse.ArgumentParser(description="tpuminter_torch worker (CUDA miner role)")
    parser.add_argument("hostport", help="coordinator address, HOST:PORT")
    parser.add_argument(
        "--exact-min", action="store_true",
        help="track the exact exhausted-range minimum of TARGET chunks "
        "(the CPU miner's output) at reduced throughput",
    )
    parser.add_argument("--slab", type=int, default=None,
                        help="nonces per kernel launch (default 2^27)")
    parser.add_argument("--depth", type=int, default=None,
                        help="kernel launches kept in flight (default 2)")
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to mine on (default cuda; cpu runs the kernels' "
        "plain versions)",
    )
    args = parser.parse_args(argv)
    try:
        host, port = _parse_hostport(args.hostport)
    except ValueError as exc:
        parser.error(str(exc))
    logging.basicConfig(level=logging.INFO)
    from tpuminter_torch.cuda_worker import CudaMiner

    kwargs = {"exact_min": args.exact_min, "device": args.device}
    if args.slab is not None:
        kwargs["slab"] = args.slab
    if args.depth is not None:
        kwargs["depth"] = args.depth
    asyncio.run(run_miner(host, port, CudaMiner(**kwargs)))


if __name__ == "__main__":
    main()
