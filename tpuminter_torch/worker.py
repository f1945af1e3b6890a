"""Worker role: the Miner interface, the LSP role loop and the CLI.

Counterpart of ``tpuminter.worker`` (``Miner``, ``ProfiledMiner``,
``run_miner``, ``run_miner_reconnect``, ``main``). The worker joins an
unchanged ``tpuminter`` coordinator advertising the binary codec (unless
told to speak JSON), the roll-budget dialect (unless told not to) and
the registered workloads (``tpuminter_torch.workloads``: dict and
hashcore), so the coordinator sends it ``Setup``, ``Assign``,
``Cancel`` and ``RollAssign`` messages, binary ones once it has seen the
Join; the worker answers in binary once it has seen a binary payload.
On ``RollAssign`` chunks it reports progress with ``Beacon`` messages,
and it computes workload chunks on the miner's device and answers them
with ``WorkResult``s. It mines every dialect: TARGET, rolled TARGET, MIN
and SCRYPT (plain or rolled). A chunk of a workload it did not register
is answered with a ``Refuse``, which makes the coordinator requeue it.
With ``--reconnect`` it survives a coordinator restart or a failover to
a standby (``--coordinator HOST:PORT,HOST:PORT``); with ``--profile
DIR`` it writes one ``torch.profiler`` trace of a warm window. With
``--backend pod`` it is one process of a pod, a card a process
(``tpuminter_torch.pod_worker``): rank 0 joins the coordinator, the
other ranks replay its chunks.

Run it as ``python -m tpuminter_torch.worker HOST:PORT``.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace as dc_replace
from typing import Callable, Iterator, List, Optional, Tuple, Union

from tpuminter_torch import chain, workloads
from tpuminter_torch.lsp import FAST, LspClient, LspConnectError, LspConnectionLost, Params
from tpuminter_torch.lsp.params import dial_patience, jittered_backoff, parse_addr_list
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
    payload_is_binary,
)

__all__ = ["Miner", "ProfiledMiner", "run_miner", "run_miner_reconnect", "parse_addr_list",
           "dial_patience", "main"]

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


class ProfiledMiner(Miner):
    """A Miner that records one ``torch.profiler`` trace of a warm window
    into ``log_dir``: the work between generator steps 1 and 3 of the
    first chunk that yields a step before its Result, so the kernels'
    first build (before a device miner's first yield) stays out of it.
    CPU activity always, CUDA activity when the miner's device is
    ``cuda``; shapes not recorded; one Chrome-trace JSON (Perfetto or
    ``chrome://tracing`` open it), whose path :attr:`trace_path` holds.

    The trace closes at step 3, before a Result that ends the chunk
    inside the window, or on an exception (which is re-raised). The role
    loop may abandon the generator (a Cancel), so a trace left open is
    closed at the start of the next :meth:`mine` call, or by
    :meth:`close` at shutdown, which also closes the inner miner.

    ``torch.profiler`` records CPU ops on the thread that starts it and
    must be stopped on that thread: :func:`run_miner` runs every
    generator step of a session, and the miner's :meth:`close`, on one
    thread of its own. An abandoned generator is never closed here, so
    the garbage collector's thread never stops a trace.
    """

    _START_STEP, _STOP_STEP = 1, 3

    def __init__(self, inner: Miner, log_dir: str):
        self._inner = inner
        self._log_dir = log_dir
        self._profiler = None
        self._traced = False
        #: the trace file, once written
        self.trace_path: Optional[str] = None
        self.backend = inner.backend
        self.lanes = inner.lanes
        self.span = inner.span
        self.device = inner.device

    def unsupported(self, request: Request) -> Optional[str]:
        return self._inner.unsupported(request)

    def _start_trace(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        log.info("profiling a steady-state window to %s", self._log_dir)
        self._profiler = profile(activities=activities, record_shapes=False)
        self._profiler.start()
        self._traced = True

    def _stop_trace(self) -> None:
        profiler, self._profiler = self._profiler, None
        profiler.stop()
        os.makedirs(self._log_dir, exist_ok=True)
        path = os.path.join(self._log_dir, f"worker.{os.getpid()}.{time.time_ns()}.pt.trace.json")
        profiler.export_chrome_trace(path)
        self.trace_path = path
        log.info("wrote the trace %s", path)

    def mine(self, request: Request) -> Iterator[Optional[Result]]:
        if self._profiler is not None:
            log.info("closing the trace a cancelled chunk left open")
            self._stop_trace()
        # the role loop installs progress_cb on this wrapper each chunk;
        # the inner miner is the one that calls it
        self._inner.progress_cb = self.progress_cb
        if self._traced:
            yield from self._inner.mine(request)
            return
        step = 0
        try:
            for item in self._inner.mine(request):
                step += 1
                if step == self._START_STEP and item is None:
                    self._start_trace()
                elif self._profiler is not None and (step == self._STOP_STEP or item is not None):
                    self._stop_trace()
                yield item
        except Exception:
            if self._profiler is not None:
                self._stop_trace()
            raise

    def close(self) -> None:
        """Write a trace still open at shutdown, then close the inner
        miner (when it has a ``close``)."""
        if self._profiler is not None:
            log.info("writing the trace left open at shutdown")
            self._stop_trace()
        closer = getattr(self._inner, "close", None)
        if callable(closer):
            closer()


def _safe_decode(raw) -> Optional[Message]:
    try:
        return decode_msg(raw)
    except ProtocolError as exc:
        log.warning("worker: dropping message: %s", exc)
        return None


async def run_miner(
    host: str, port: int, miner: Miner, *, params: Optional[Params] = None,
    binary: bool = True, connect_epochs: Optional[int] = None, roll: bool = True,
    beacon_interval: float = 2.0,
) -> None:
    """Worker role main loop; returns when the coordinator is lost.

    Generator steps run on one executor thread of the session's own, so
    a step that waits on the device or builds the kernels never stalls
    the event loop and the LSP heartbeats keep flowing, and every step
    of the session (and the miner's ``close`` at its end) runs on the
    same thread, as ``torch.profiler`` needs (:class:`ProfiledMiner`).
    While a chunk is mined one read stays in flight, so a ``Cancel`` for
    the active job abandons it at the next step; any other message read
    meanwhile is queued and handled after.

    ``binary`` advertises the binary codec in the Join: Results,
    Refuses and Beacons switch to binary only after the coordinator has
    sent a binary payload, proof that it decodes them; ``False`` pins
    the worker to JSON. ``connect_epochs`` bounds the dial
    (:meth:`LspClient.connect`). ``roll`` advertises the roll-budget
    dialect: the coordinator may then send ``RollAssign`` chunks, and
    for exactly those the loop sends a ``Beacon`` (settled high-water
    and running minimum, from the miner's ``progress_cb``) at most every
    ``beacon_interval`` seconds (``<= 0`` sends none).
    """
    client = await LspClient.connect(host, port, params or FAST, connect_epochs=connect_epochs)
    client.write(encode_msg(Join(backend=miner.backend, lanes=miner.lanes, span=miner.span,
                                 codec="bin" if binary else "json", roll=roll,
                                 workloads=workloads.names())))
    speak_binary = False
    sent = {"results": 0, "binary": 0}

    def note_codec(raw) -> None:
        # one binary payload from the coordinator flips our side, for
        # the rest of the session
        nonlocal speak_binary
        if binary and not speak_binary and payload_is_binary(raw):
            speak_binary = True
            log.info("worker: the coordinator speaks the binary codec; answering in binary")

    def send(msg: Message) -> None:
        raw = encode_msg(msg, binary=speak_binary)
        if isinstance(msg, (Result, WorkResult)):
            sent["results"] += 1
            sent["binary"] += payload_is_binary(raw)
        client.write(raw)

    pending: "asyncio.Queue[Message]" = asyncio.Queue()
    read_task: Optional[asyncio.Task] = None
    templates: dict = {}  # job_id -> template Request from a Setup
    loop = asyncio.get_running_loop()
    steps = ThreadPoolExecutor(1, thread_name_prefix="tpuminter-steps")
    try:
        while True:
            if not pending.empty():
                msg = pending.get_nowait()
            else:
                if read_task is None:
                    read_task = asyncio.ensure_future(client.read())
                raw = await read_task
                read_task = None
                note_codec(raw)
                msg = _safe_decode(raw)
                if msg is None:
                    continue
            if isinstance(msg, Cancel):
                templates.pop(msg.job_id, None)
                log.info("worker: job %d cancelled between chunks", msg.job_id)
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
                    send(Refuse(msg.job_id, msg.chunk_id))
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
                send(Refuse(msg.job_id, msg.chunk_id))
                continue
            reason = miner.unsupported(msg)
            if reason is not None:
                log.warning("worker: refusing chunk %d of job %d: %s",
                            msg.chunk_id, msg.job_id, reason)
                send(Refuse(msg.job_id, msg.chunk_id))
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
                # the workload's compute generator, on the same thread
                # with the same Cancel window
                gen = workloads.compute(msg, device=miner.device)
            else:
                gen = miner.mine(msg)
            result: Optional[Union[Result, WorkResult]] = None
            cancelled = False
            done = object()
            while True:
                item = await loop.run_in_executor(steps, next, gen, done)
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
                        send(Beacon(msg.job_id, msg.chunk_id, hw, bn, bh))
                        last_beacon = time.monotonic()
                        beacon_hw = hw
                if read_task is None:
                    read_task = asyncio.ensure_future(client.read())
                if read_task.done():
                    raw = read_task.result()  # raises here if the conn is lost
                    read_task = None
                    note_codec(raw)
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
            send(result)
    except LspConnectionLost:
        log.info("worker: coordinator lost")
    finally:
        if read_task is not None:
            read_task.cancel()
        log.info("worker: session with %s:%d ended; %d Results sent, %d of them binary",
                 host, port, sent["results"], sent["binary"])
        closer = getattr(miner, "close", None)
        try:
            if callable(closer):
                # on the steps' thread, after any step still running
                # there (a ProfiledMiner writes a trace left open)
                await loop.run_in_executor(steps, closer)
        finally:
            steps.shutdown(wait=False)
            await client.close(drain_timeout=2.0)


async def run_miner_reconnect(
    host: str, port: int, miner: Miner, *, params: Optional[Params] = None,
    base_backoff: float = 0.2, max_backoff: float = 5.0, max_dials: Optional[int] = None,
    rng: Optional[random.Random] = None, binary: bool = True,
    addrs: Optional[List[Tuple[str, int]]] = None, roll: bool = True,
    beacon_interval: float = 2.0,
) -> None:
    """:func:`run_miner` that survives coordinator restarts: when the
    coordinator is lost, or a dial fails, it redials with jittered
    exponential backoff (``base_backoff · 2^k`` capped at
    ``max_backoff``, each wait scaled by [0.5, 1.5)) and re-Joins. A
    restarted coordinator re-ships its jobs' templates through Setups,
    so the worker keeps no state across sessions.

    ``addrs`` (the CLI's ``--coordinator HOST:PORT,HOST:PORT``) lists
    every coordinator address, primary first: each failed dial or lost
    session rotates to the next, so a fleet reaches a promoted standby
    by itself; when given it supersedes ``host``/``port``. A session
    that was established resets the backoff. ``max_dials`` bounds the
    loop for tests; the CLI runs it unbounded.
    """
    targets = list(addrs) if addrs else [(host, port)]
    connect_epochs = dial_patience(targets)
    delays = jittered_backoff(base_backoff, max_backoff, rng)
    dials = 0
    while True:
        h, p = targets[dials % len(targets)]
        dials += 1
        try:
            await run_miner(h, p, miner, params=params, binary=binary,
                            connect_epochs=connect_epochs, roll=roll,
                            beacon_interval=beacon_interval)
            delays = jittered_backoff(base_backoff, max_backoff, rng)  # it served
        except LspConnectError:
            pass  # the dial failed: keep backing off
        if max_dials is not None and dials >= max_dials:
            return
        wait = next(delays)
        log.info("worker: coordinator gone; redialing %s:%d in %.2f s (attempt %d)",
                 *targets[dials % len(targets)], wait, dials + 1)
        await asyncio.sleep(wait)


def _parse_args(argv: Optional[list] = None):
    """The CLI's arguments and its coordinator address list; refuses
    (``SystemExit``) what the reference's worker refuses."""
    import argparse

    parser = argparse.ArgumentParser(description="tpuminter_torch worker (CUDA miner role)")
    parser.add_argument("hostport", nargs="?", default=None,
                        help="coordinator address, HOST:PORT (or use --coordinator)")
    parser.add_argument(
        "--coordinator", metavar="LIST", default=None,
        help="coordinator address list, HOST:PORT[,HOST:PORT...], primary first, hot "
        "standbys after; with --reconnect each failure rotates to the next address, so "
        "the worker lands on a promoted standby by itself",
    )
    parser.add_argument(
        "--exact-min", action="store_true",
        help="track the exact exhausted-range minimum of TARGET chunks "
        "(the CPU miner's output) at reduced throughput",
    )
    parser.add_argument(
        "--backend", choices=("cuda", "pod"), default="cuda",
        help="cuda (default): one card; pod: one process of a pod, a card a process, its "
        "rank and rendezvous from TPUMINTER_COORD_ADDR, TPUMINTER_NUM_PROCS and "
        "TPUMINTER_PROC_ID (rank 0 joins the coordinator, the others replay its chunks)",
    )
    parser.add_argument("--slab", type=int, default=None,
                        help="nonces per kernel launch (default 2^27; under --backend pod, "
                        "a rank's slab a stripe)")
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
        "--profile", metavar="DIR", default=None,
        help="record a torch.profiler trace (CPU, and CUDA on the card) of a warm window "
        "of the first mined chunk into DIR, as Chrome-trace JSON (open it in Perfetto "
        "or chrome://tracing)",
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
    parser.add_argument(
        "--codec", choices=("binary", "json"), default="binary",
        help="wire codec advertised to the coordinator (binary, the default, is "
        "negotiated: a coordinator that never sends binary still gets JSON; json pins "
        "this worker to JSON)",
    )
    parser.add_argument(
        "--reconnect", action="store_true",
        help="survive coordinator restarts: when the coordinator is lost, redial with "
        "jittered exponential backoff and re-Join instead of exiting",
    )
    args = parser.parse_args(argv)
    try:
        if args.coordinator is not None:
            addrs = parse_addr_list(args.coordinator)
        elif args.hostport is not None:
            addrs = parse_addr_list(args.hostport)
        else:
            parser.error("need a coordinator address (positional or --coordinator)")
    except ValueError as exc:
        parser.error(f"expected HOST:PORT[,HOST:PORT...]: {exc}")
    if len(addrs) > 1 and not args.reconnect:
        parser.error("an address list only makes sense with --reconnect (the rotation "
                     "happens on redial)")
    if args.backend == "pod" and args.reconnect:
        # the leader's session close ends its followers' replay
        parser.error("--backend pod does not redial: restart the pod's processes instead")
    return args, addrs


def main(argv: Optional[list] = None) -> None:
    """CLI: ``python -m tpuminter_torch.worker HOST:PORT [--device cuda]``,
    or ``--coordinator HOST:PORT,HOST:PORT --reconnect``."""
    args, addrs = _parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    kwargs = {"exact_min": args.exact_min, "device": args.device}
    if args.depth is not None:
        kwargs["depth"] = args.depth
    if args.roll_batch is not None:
        kwargs["roll_batch"] = args.roll_batch
    if args.backend == "pod":
        _main_pod(args, addrs, kwargs)
        return
    from tpuminter_torch.cuda_worker import CudaMiner

    if args.slab is not None:
        kwargs["slab"] = args.slab
    _serve(args, addrs, CudaMiner(**kwargs))


def _main_pod(args, addrs, kwargs) -> None:
    """``--backend pod``: join the pod the environment describes (a pod of
    one process without it); rank 0 serves the coordinator, every other
    rank replays its chunks until it closes."""
    from tpuminter_torch.parallel import distributed
    from tpuminter_torch.pod_worker import PodMiner, follower_loop

    if args.slab is not None:
        kwargs["slab_per_device"] = args.slab
    pod = distributed.init_from_env(args.device)
    try:
        if pod is not None and not pod.is_leader:
            follower_loop(PodMiner(pod=pod, **kwargs))
            return
        _serve(args, addrs, PodMiner(pod=pod, spmd_leader=pod is not None, **kwargs))
    finally:
        if pod is not None:
            pod.close()


def _serve(args, addrs, miner: Miner) -> None:
    """Run the worker role with ``miner`` until the coordinator is lost (or,
    with ``--reconnect``, for good)."""
    host, port = addrs[0]
    if args.profile:
        miner = ProfiledMiner(miner, args.profile)
    options = dict(binary=args.codec == "binary", roll=not args.no_roll,
                   beacon_interval=args.beacon_interval)
    if args.reconnect:
        asyncio.run(run_miner_reconnect(host, port, miner, addrs=addrs, **options))
    else:
        asyncio.run(run_miner(host, port, miner, **options))


if __name__ == "__main__":
    main()
