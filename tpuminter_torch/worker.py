"""Worker role: the Miner interface, the LSP role loop and the CLI.

Counterpart of ``tpuminter.worker`` (``Miner``, ``run_miner``, ``main``)
for a worker that joins with the JSON codec, so an unchanged
``tpuminter`` coordinator sends it JSON ``Setup``, ``Assign`` and
``Cancel`` messages, and, since it advertises the roll-budget dialect
unless told not to, ``RollAssign`` chunks of whole extranonces, on which
it reports progress with ``Beacon`` messages. It advertises the
registered workloads (``tpuminter_torch.workloads``: dict and hashcore), whose
chunks it computes on the miner's device and answers with
``WorkResult``s. It mines every dialect: TARGET, rolled TARGET, MIN and
SCRYPT (plain or rolled). A chunk of a workload it did not register is
answered with a ``Refuse``, which makes the coordinator requeue it.

Run it as ``python -m tpuminter_torch.worker HOST:PORT``.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import replace as dc_replace
from typing import Callable, Iterator, Optional, Union

from tpuminter_torch import chain, workloads
from tpuminter_torch.lsp import FAST, LspClient, LspConnectionLost, Params
from tpuminter_torch.protocol import (
    Assign,
    Beacon,
    Cancel,
    Join,
    Message,
    ProtocolError,
    Refuse,
    Request,
    Result,
    RollAssign,
    Setup,
    WorkResult,
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
    #: torch device the worker computes workload chunks on
    device = "cuda"
    #: ``(high_water, best_nonce, best_hash)`` callback the role loop
    #: installs for each roll-budget chunk; rolled mine paths call it
    #: between sweeps, on the mining thread. None disables it.
    progress_cb: Optional[Callable[[int, int, int], None]] = None

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
    roll: bool = True, beacon_interval: float = 2.0,
) -> None:
    """Worker role main loop; returns when the coordinator is lost.

    Generator steps run in an executor thread, so a step that waits on
    the device or builds the kernels never stalls the event loop and the
    LSP heartbeats keep flowing. While a chunk is mined one read stays in
    flight, so a ``Cancel`` for the active job abandons it at the next
    step; any other message read meanwhile is queued and handled after.

    ``roll`` advertises the roll-budget dialect: the coordinator may then
    send ``RollAssign`` chunks, and for exactly those the loop sends a
    ``Beacon`` (settled high-water and running minimum, from the miner's
    ``progress_cb``) at most every ``beacon_interval`` seconds (``<= 0``
    sends none).
    """
    client = await LspClient.connect(host, port, params or FAST)
    client.write(encode_msg(Join(backend=miner.backend, lanes=miner.lanes, span=miner.span,
                                 roll=roll, workloads=workloads.names())))
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
            roll_chunk = False
            if isinstance(msg, (Assign, RollAssign)):
                tmpl = templates.get(msg.job_id)
                if tmpl is None:
                    # the coordinator requeues the chunk and re-ships the Setup
                    log.warning("worker: no template for job %d; refusing chunk %d",
                                msg.job_id, msg.chunk_id)
                    client.write(encode_msg(Refuse(msg.job_id, msg.chunk_id)))
                    continue
                if isinstance(msg, RollAssign):
                    # whole extranonces, each over its full nonce space
                    roll_chunk = True
                    lower, upper = chain.roll_span(msg.extranonce0, msg.count,
                                                   tmpl.nonce_bits)
                else:
                    lower, upper = msg.lower, msg.upper
                msg = dc_replace(tmpl, lower=lower, upper=upper, chunk_id=msg.chunk_id)
            if not isinstance(msg, Request):
                log.warning("worker: unexpected %s, dropping", type(msg).__name__)
                continue
            if msg.workload and workloads.maybe(msg.workload) is None:
                # never advertised: Refuse so the chunk requeues onto a
                # worker that computes it
                log.warning("worker: unregistered workload %r for job %d; refusing chunk %d",
                            msg.workload, msg.job_id, msg.chunk_id)
                client.write(encode_msg(Refuse(msg.job_id, msg.chunk_id)))
                continue
            reason = miner.unsupported(msg)
            if reason is not None:
                log.warning("worker: refusing chunk %d of job %d: %s",
                            msg.chunk_id, msg.job_id, reason)
                client.write(encode_msg(Refuse(msg.job_id, msg.chunk_id)))
                continue

            # a latest-value cell the mining thread writes (one tuple
            # store); installed or cleared per chunk, so no callback
            # outlives its chunk
            latest: dict = {}
            if roll_chunk and beacon_interval > 0:
                miner.progress_cb = lambda hw, n, h: latest.__setitem__("p", (hw, n, h))
            else:
                miner.progress_cb = None
            last_beacon = time.monotonic()
            beacon_hw = -1
            if msg.workload:
                # the workload's compute generator, in the same executor
                # loop with the same Cancel window
                gen = workloads.compute(msg, device=miner.device)
            else:
                gen = miner.mine(msg)
            result: Optional[Union[Result, WorkResult]] = None
            cancelled = False
            done = object()
            while True:
                item = await loop.run_in_executor(None, next, gen, done)
                if item is done:
                    break  # generator ended without a Result
                if item is not None:
                    result = item
                    break
                prog = latest.get("p")
                if prog is not None and time.monotonic() - last_beacon >= beacon_interval:
                    hw, bn, bh = prog
                    hw = min(hw, msg.upper)
                    # hw == upper: the chunk is done and its Result settles it
                    if msg.lower <= hw < msg.upper and hw > beacon_hw:
                        client.write(encode_msg(Beacon(msg.job_id, msg.chunk_id, hw, bn, bh)))
                        last_beacon = time.monotonic()
                        beacon_hw = hw
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
    parser.add_argument(
        "--roll-batch", type=int, default=None,
        help="extranonce rows per rolled kernel launch (default 8); 1 mines "
        "one extranonce segment at a time",
    )
    parser.add_argument(
        "--beacon-interval", type=float, default=2.0, metavar="SECS",
        help="minimum seconds between progress beacons on a roll-budget chunk "
        "(default 2.0; <= 0 sends none)",
    )
    parser.add_argument(
        "--no-roll", action="store_true",
        help="do not advertise the roll-budget dialect: only classic Assigns arrive",
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
    if args.roll_batch is not None:
        kwargs["roll_batch"] = args.roll_batch
    asyncio.run(run_miner(host, port, CudaMiner(**kwargs), roll=not args.no_roll,
                          beacon_interval=args.beacon_interval))


if __name__ == "__main__":
    main()
