"""Client role: submit one job, await its answer.

Counterpart of ``tpuminter.client``: connect, send one Request, wait
for its Result and print ``Result <hash> <nonce>``, or ``Disconnected``
when the coordinator is declared lost. Every dialect has its flags:
toy MIN (``<host:port> <message> <maxNonce>``), TARGET and SCRYPT
(``--header``/``--bits``, rolled with ``--coinbase-prefix`` and its
companions) and the registered workloads (``--workload`` with the
hashcore flags or dict's ``--candidates``). ``--reconnect`` survives a
coordinator restart by redialing and re-submitting under a durable
``--client-key``; ``--stream`` prints the streaming ``Partial`` lines a
coordinator pushes before the answer. It talks to the port's
coordinator and to the reference's alike, and imports neither ``torch``
nor ``jax``.
"""

from __future__ import annotations

import asyncio
import logging
import random
import secrets
from dataclasses import replace as dc_replace
from typing import Optional

from tpuminter_torch import chain
from tpuminter_torch.lsp import (
    LspClient,
    LspConnectError,
    LspConnectionLost,
    Params,
)
from tpuminter_torch.lsp.params import FAST, dial_patience, jittered_backoff, parse_addr_list
from tpuminter_torch.protocol import (
    Emit,
    PowMode,
    Refuse,
    Request,
    Result,
    WorkResult,
    decode_msg,
    encode_msg,
)

__all__ = ["JobRefused", "submit", "main"]

log = logging.getLogger("tpuminter_torch.client")


class JobRefused(Exception):
    """The coordinator refused the submission with no retry hint — a
    malformed request (unknown workload, params its codec rejects), not
    backpressure. Retrying verbatim would loop forever."""


async def submit(
    host: str,
    port: int,
    request: Request,
    *,
    params: Optional[Params] = None,
    client_key: Optional[str] = None,
    reconnect: bool = False,
    base_backoff: float = 0.2,
    max_backoff: float = 5.0,
    rng: Optional[random.Random] = None,
    addrs: Optional[list] = None,
    on_emit=None,
) -> Result:
    """Connect, submit ``request``, and await its final Result.

    ``on_emit`` receives each streaming :class:`Emit`
    partial pushed for this job when the request was submitted with
    ``stream=True`` — an advisory running answer + coverage off
    journal-settled state only. The callback should gate on
    ``emit.covered`` monotonicity (this function does not): sequence
    numbers restart across a coordinator failover, coverage never
    regresses.

    Raises :class:`LspConnectionLost` if the coordinator dies first (the
    caller prints ``Disconnected``, matching the reference UX) — unless
    ``reconnect`` is set, in which case the client survives coordinator
    restarts: it redials with jittered exponential backoff and
    RE-SUBMITS the request under its durable ``client_key`` and
    ORIGINAL ``job_id``. A journaled coordinator deduplicates the
    re-submission — re-binding it to the still-running recovered job,
    or answering straight from the journaled winners table — so the
    client gets exactly one answer no matter how many times either
    side dies in between. ``reconnect`` without an explicit
    ``client_key`` mints a random one for this call.

    ``addrs`` lists every coordinator address, primary first,
    standbys after: each failure rotates the redial to the next one, so
    a re-submission reaches a promoted standby — whose replicated
    winners table / recovered jobs deduplicate it — with no client-side
    state beyond the address list. Supersedes ``host``/``port``.
    """
    if client_key is None and reconnect:
        client_key = secrets.token_hex(8)
    if client_key:
        request = dc_replace(request, client_key=client_key)
    targets = list(addrs) if addrs else [(host, port)]
    connect_epochs = dial_patience(targets)
    attempt = 0
    delays = jittered_backoff(base_backoff, max_backoff, rng)
    while True:
        h, p = targets[attempt % len(targets)]
        attempt += 1
        try:
            client = await LspClient.connect(
                h, p, params or FAST, connect_epochs=connect_epochs
            )
        except LspConnectError:
            if not reconnect:
                raise
            await asyncio.sleep(next(delays))
            continue
        try:
            client.write(encode_msg(request))
            while True:
                msg = decode_msg(await client.read())
                if (
                    isinstance(msg, (Result, WorkResult))
                    and msg.job_id == request.job_id
                ):
                    return msg
                if isinstance(msg, Emit) and msg.job_id == request.job_id:
                    if on_emit is not None:
                        on_emit(msg)
                    continue
                if (
                    isinstance(msg, Refuse)
                    and msg.retry_after_ms > 0
                    and msg.job_id == request.job_id
                ):
                    # admission backpressure: the coordinator
                    # said "not now, come back in ~retry_after_ms". Honor
                    # it on the SAME connection with jitter (0.5–1.5× so
                    # a refused thundering herd decorrelates) and
                    # re-submit; the durable client_key + original job_id
                    # make the re-submission exactly-once safe.
                    base = msg.retry_after_ms / 1000.0
                    wait = base * ((rng.random() if rng
                                    else random.random()) + 0.5)
                    log.info(
                        "client: admission refused for job %d; retrying "
                        "in %.3fs (suggested %d ms)",
                        request.job_id, wait, msg.retry_after_ms,
                    )
                    await asyncio.sleep(wait)
                    client.write(encode_msg(request))
                    continue
                if (
                    isinstance(msg, Refuse)
                    and msg.retry_after_ms <= 0
                    and msg.job_id == request.job_id
                ):
                    # no retry hint: the request itself is bad (unknown
                    # workload / malformed params) — fail fast
                    raise JobRefused(
                        f"coordinator refused job {request.job_id}"
                    )
                log.warning(
                    "client: ignoring unexpected %s", type(msg).__name__
                )
        except LspConnectionLost:
            if not reconnect:
                raise
            # the dial worked: fresh backoff episode
            delays = jittered_backoff(base_backoff, max_backoff, rng)
            wait = next(delays)
            log.info(
                "client: coordinator lost mid-job; re-submitting job %d "
                "to %s:%d in %.2fs", request.job_id,
                *targets[attempt % len(targets)], wait,
            )
            await asyncio.sleep(wait)
        finally:
            await client.close(drain_timeout=2.0)


def main(argv: Optional[list] = None) -> None:
    """CLI: ``python -m tpuminter_torch.client <host:port> <message> <maxNonce>``."""
    import argparse

    parser = argparse.ArgumentParser(description="tpuminter_torch client")
    parser.add_argument(
        "hostport", nargs="?", default=None,
        help="coordinator address, host:port — or a comma-separated "
        "list host:port,host:port (primary first, hot standbys after; "
        "needs --reconnect, which rotates the redial across the list "
        "so a re-submission lands on a promoted standby)",
    )
    parser.add_argument(
        "--coordinator", metavar="LIST", default=None,
        help="alias for the positional address list (matches the "
        "worker CLI)",
    )
    parser.add_argument("message", nargs="?", help="toy-mode payload string")
    parser.add_argument("max_nonce", nargs="?", help="toy-mode nonce bound")
    parser.add_argument("--header", help="TARGET mode: 160-hex-char block header")
    parser.add_argument("--bits", type=lambda s: int(s, 0), default=0x1D00FFFF,
                        help="TARGET mode: compact difficulty bits (default diff-1)")
    parser.add_argument("--max-nonce", dest="max_nonce_opt", type=int,
                        default=0xFFFFFFFF, help="TARGET mode: nonce sweep bound")
    parser.add_argument("--scrypt", action="store_true",
                        help="with --header: scrypt PoW (Litecoin N=1024,r=1,p=1) "
                        "instead of double-SHA256")
    parser.add_argument("--coinbase-prefix", metavar="HEX", default=None,
                        help="extranonce rolling (eval configs 3-4): coinbase tx "
                        "bytes before the extranonce; the search space becomes "
                        "(extranonce x nonce) and workers re-roll the merkle "
                        "root on device as each 2^32 nonce space exhausts")
    parser.add_argument("--coinbase-suffix", metavar="HEX", default="",
                        help="coinbase tx bytes after the extranonce")
    parser.add_argument("--branch", metavar="HEX", action="append", default=[],
                        help="32-byte merkle branch sibling, repeatable, "
                        "leaf-to-root order")
    parser.add_argument("--extranonce-size", type=int, default=4,
                        help="extranonce width in bytes (1-8, default 4)")
    parser.add_argument("--max-extranonce", type=int, default=None,
                        help="with --coinbase-prefix: highest extranonce to "
                        "search (default 255)")
    parser.add_argument("--timeout", type=float, default=None,
                        metavar="SECONDS",
                        help="give up if no Result arrives within this many "
                        "seconds (the reference blocks forever); prints "
                        "'Timeout' and exits 1, like the 'Disconnected' "
                        "path for a dead coordinator")
    parser.add_argument("--reconnect", action="store_true",
                        help="survive coordinator restarts: redial with "
                        "jittered backoff and re-submit this request under "
                        "its durable client key — a journaled coordinator "
                        "deduplicates, so exactly one answer arrives")
    parser.add_argument("--client-key", metavar="KEY", default=None,
                        help="durable client identity for --reconnect "
                        "deduplication (default: random per invocation; "
                        "pass a stable key to dedup across client-process "
                        "restarts too)")
    parser.add_argument("--workload", metavar="NAME", default=None,
                        help="submit a registered-workload job "
                        "over [0, --max-nonce] instead of a mining job; "
                        "e.g. 'hashcore' with the --variant/--seed/"
                        "--threshold/--k params below")
    parser.add_argument("--variant", default="fmin",
                        choices=("fmin", "topk", "fmatch", "fsum"),
                        help="hashcore fold variant (default fmin)")
    parser.add_argument("--seed", type=lambda s: int(s, 0), default=1,
                        help="hashcore objective seed (default 1)")
    parser.add_argument("--threshold", type=lambda s: int(s, 0), default=0,
                        help="hashcore fmatch threshold")
    parser.add_argument("--k", type=int, default=4,
                        help="hashcore topk k, 1-8 (default 4)")
    parser.add_argument("--params", metavar="HEX", default=None,
                        help="with --workload: raw params frame bytes "
                        "(overrides the hashcore convenience flags — the "
                        "escape hatch for other registered workloads)")
    parser.add_argument("--candidates", metavar="FILE", default=None,
                        help="with --workload dict: newline-separated "
                        "candidate file packed through the dict params "
                        "codec; the search domain becomes "
                        "indices into the shipped list")
    parser.add_argument("--stream", action="store_true",
                        help="ask for streaming partial results: the "
                        "coordinator pushes journal-settled "
                        "Emit partials (running answer + coverage) "
                        "before the final Result; each prints as "
                        "'Partial ...'")
    args = parser.parse_args(argv)
    if args.timeout is not None and args.timeout <= 0:
        parser.error("--timeout must be positive seconds")
    if args.stream and args.workload is None:
        parser.error(
            "--stream needs --workload: only registered-workload folds "
            "emit partial results"
        )
    if args.coordinator is not None:
        # --coordinator frees the positional address slot, so the
        # remaining positionals left-shift into the toy-mode pair
        if args.max_nonce is not None:
            parser.error(
                "too many positionals with --coordinator: expected "
                "[<message> <maxNonce>]"
            )
        toy_message, toy_max_nonce = args.hostport, args.message
        addrs = parse_addr_list(args.coordinator)
    elif args.hostport is not None:
        toy_message, toy_max_nonce = args.message, args.max_nonce
        addrs = parse_addr_list(args.hostport)
    else:
        parser.error(
            "need a coordinator address (positional or --coordinator)"
        )
    if toy_max_nonce is not None:
        try:
            toy_max_nonce = int(toy_max_nonce)
        except ValueError:
            parser.error(f"maxNonce must be an integer, got {toy_max_nonce!r}")
    if len(addrs) > 1 and not args.reconnect:
        parser.error(
            "an address list only makes sense with --reconnect (the "
            "rotation happens on redial)"
        )
    host, port = addrs[0]
    logging.basicConfig(level=logging.WARNING)

    def _hex(value: str, what: str) -> bytes:
        try:
            return bytes.fromhex(value)
        except ValueError:
            parser.error(f"{what} is not valid hex: {value!r}")

    if args.workload is not None:
        if args.header is not None:
            parser.error("--workload conflicts with --header")
        upper = args.max_nonce_opt
        if args.params is not None:
            data = _hex(args.params, "--params")
        elif args.workload == "hashcore":
            from tpuminter_torch.workloads import hashcore as _hc

            try:
                data = _hc.pack_params(
                    args.variant, args.seed, args.threshold, args.k
                )
            except ValueError as exc:
                parser.error(str(exc))
        elif args.workload == "dict":
            if args.candidates is None:
                parser.error(
                    "--workload dict needs --candidates FILE (or raw "
                    "--params HEX)"
                )
            from tpuminter_torch.workloads import dictsearch as _ds

            with open(args.candidates, "rb") as fh:
                cands = [ln for ln in fh.read().splitlines() if ln]
            try:
                data = _ds.pack_params(
                    args.variant, args.seed, cands,
                    threshold=args.threshold, k=args.k,
                )
            except ValueError as exc:
                parser.error(str(exc))
            # an opaque domain: the job sweeps indices INTO the list
            upper = len(cands) - 1
        else:
            parser.error(
                f"--workload {args.workload}: pass --params HEX (only "
                "hashcore and dict params have convenience flags)"
            )
        request = Request(
            job_id=1,
            mode=PowMode.MIN,
            lower=0,
            upper=upper,
            data=data,
            workload=args.workload,
            stream=args.stream,
        )
    elif args.header is not None:
        header = _hex(args.header, "--header")
        rolled = {}
        upper = args.max_nonce_opt
        if args.coinbase_prefix is not None:
            if args.max_nonce_opt != 0xFFFFFFFF:
                parser.error(
                    "--max-nonce conflicts with --coinbase-prefix: a rolled "
                    "job sweeps full 2^32 nonce spaces per extranonce; bound "
                    "it with --max-extranonce instead"
                )
            if not 1 <= args.extranonce_size <= 8:
                parser.error("--extranonce-size must be in [1, 8]")
            max_en = 255 if args.max_extranonce is None else args.max_extranonce
            en_limit = (1 << min(32, 8 * args.extranonce_size)) - 1
            if not 0 <= max_en <= en_limit:
                parser.error(
                    f"--max-extranonce must be in [0, {en_limit}] for "
                    f"--extranonce-size {args.extranonce_size}"
                )
            for sib in args.branch:
                if len(sib) != 64:
                    parser.error(
                        f"--branch entries must be 64 hex chars (32 bytes), "
                        f"got {len(sib)}"
                    )
            upper = (max_en << 32) | 0xFFFFFFFF
            rolled = dict(
                coinbase_prefix=_hex(args.coinbase_prefix, "--coinbase-prefix"),
                coinbase_suffix=_hex(args.coinbase_suffix, "--coinbase-suffix"),
                extranonce_size=args.extranonce_size,
                branch=tuple(_hex(s, "--branch") for s in args.branch),
            )
        request = Request(
            job_id=1,
            mode=PowMode.SCRYPT if args.scrypt else PowMode.TARGET,
            lower=0,
            upper=upper,
            header=header,
            target=chain.bits_to_target(args.bits),
            **rolled,
        )
    elif toy_message is not None and toy_max_nonce is not None:
        request = Request(
            job_id=1,
            mode=PowMode.MIN,
            lower=0,
            upper=toy_max_nonce,
            data=toy_message.encode(),
        )
    else:
        parser.error("need either <message> <maxNonce> or --header")

    on_emit = None
    if args.stream:
        from tpuminter_torch import workloads as _wl

        stream_fold = _wl.fold_of(request)
        seen = {"cov": -1}

        def on_emit(emit):
            # coverage-gated rendering: a duplicate or replayed Emit
            # (redial, coordinator failover) never prints a regression
            if emit.covered <= seen["cov"]:
                return
            seen["cov"] = emit.covered
            frac = emit.covered / emit.total if emit.total else 0.0
            desc = bytes(emit.payload).hex()
            if stream_fold is not None:
                try:
                    desc = stream_fold.describe(
                        stream_fold.decode(bytes(emit.payload))
                    )
                except ValueError:
                    desc = f"undecodable payload={desc}"
            print(
                f"Partial [{emit.covered}/{emit.total} {frac:.0%}] {desc}",
                flush=True,
            )

    async def _run() -> int:
        try:
            # wait_for(None) imposes no deadline — the reference's
            # block-forever default is preserved unless --timeout is given
            result = await asyncio.wait_for(
                submit(
                    host, port, request,
                    client_key=args.client_key,
                    reconnect=args.reconnect,
                    addrs=addrs,
                    on_emit=on_emit,
                ),
                args.timeout,
            )
        except asyncio.TimeoutError:
            # the wait_for cancellation propagates into submit(), whose
            # finally-close drains the connection before we return
            print("Timeout")
            return 1
        except LspConnectionLost:
            print("Disconnected")
            return 0
        except JobRefused:
            print("Refused (unknown workload or malformed params)")
            return 1
        if isinstance(result, WorkResult):
            # fold-aware rendering: top-k and map-reduce answers print
            # their full payload via the discipline's describe()
            from tpuminter_torch import workloads

            fold = workloads.fold_of(request)
            payload = bytes(result.payload)
            if fold is None:
                print(f"Result [{request.workload}] payload={payload.hex()}")
            else:
                try:
                    acc = fold.decode(payload)
                except ValueError:
                    print(
                        f"Result [{request.workload}] undecodable "
                        f"payload={payload.hex()}"
                    )
                    return 1
                print(f"Result [{request.workload}] {fold.describe(acc)}")
            print(f"  searched={result.searched}")
            return 0
        if request.mode == PowMode.MIN:
            print(f"Result {result.hash_value} {result.nonce}")
        elif result.found:
            digest = result.hash_value.to_bytes(32, "little")
            if request.rolled:
                en, n = chain.split_global(result.nonce, request.nonce_bits)
                print(
                    f"Result {chain.hash_to_hex(digest)} "
                    f"extranonce={en} nonce={n}"
                )
            else:
                print(f"Result {chain.hash_to_hex(digest)} {result.nonce}")
        else:
            print("Exhausted (no nonce met the target)")
        return 0

    rc = asyncio.run(_run())
    if rc:
        raise SystemExit(rc)


if __name__ == "__main__":
    main()
