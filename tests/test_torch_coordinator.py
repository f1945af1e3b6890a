"""The port's coordinator held to the reference's.

- *Wire trace*: one scripted LSP peer joins each coordinator with the
  same ``Join`` and answers every dispatch the same way, for one client
  ``Request``; the raw ``Setup``/``Assign``/``RollAssign``/``Cancel``
  payloads each coordinator sends must be equal, byte for byte, and so
  must the final Results. With audits on (``audit_rate=1.0`` under one
  ``audit_seed``, one chunk at a time) the lone peer audits itself, so
  the audit dispatches drawn from the seeded generator are in the trace.
- *Same Results*: each dialect and workload through the port's three
  roles (worker on ``device="cpu"``) and through the reference's.
- *Interop*: the port's coordinator with the reference's worker and
  client, the reference's coordinator with the port's worker and
  client, in both codecs.
- *Faults* (``tests/test_e2e.py``'s): miner death, client death, a
  forged winner, a refused Assign, early-exit Cancel, span-hint caps.
- *Cross-recovery*: each coordinator is killed mid-job and the other
  recovers from its journal; no answered winner is lost.

Toy sizes at 50 ms epochs on ephemeral ports; every await is bounded.
"""

import asyncio
import dataclasses
import logging
import random
import struct
import time

import pytest

from tpuminter import chain as ref_chain
from tpuminter import protocol as ref
from tpuminter import workloads as ref_workloads
from tpuminter.client import submit as ref_submit
from tpuminter.coordinator import Coordinator as RefCoordinator
from tpuminter.lsp import LspClient as RefLspClient
from tpuminter.lsp import Params as RefParams
from tpuminter.worker import CpuMiner
from tpuminter.worker import run_miner as ref_run_miner
from tpuminter.workloads import dictsearch as ref_ds
from tpuminter.workloads import hashcore as ref_hc
from tpuminter_torch import chain, protocol as port
from tpuminter_torch.client import JobRefused, submit
from tpuminter_torch.coordinator import MAX_REJECTIONS, SPANS_PER_DISPATCH, Coordinator
from tpuminter_torch.cuda_worker import CudaMiner
from tpuminter_torch.lsp import Params
from tpuminter_torch.worker import run_miner, run_miner_reconnect

_LSP = dict(epoch_limit=5, epoch_millis=50, window_size=32, max_backoff_interval=2,
            max_unacked_messages=32)
REF_FAST, FAST = RefParams(**_LSP), Params(**_LSP)
GENESIS = ref_chain.GENESIS_HEADER


def run(coro, timeout=60.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _stop(coord, *tasks):
    """Tear a scenario down: its tasks cancelled, its coordinator killed
    (a graceful close would wait out the loss horizon of every peer
    that closed without acking its last message)."""
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    coord.crash()


def brute_min(data, lo, hi):
    return min((ref_chain.toy_hash(data, n), n) for n in range(lo, hi + 1))


def _as_ref(msg):
    """A port message as the reference's dataclass (for comparison)."""
    if isinstance(msg, port.Request):
        return ref.decode_msg(port.encode_msg(msg))
    cls = getattr(ref, type(msg).__name__)
    return cls(**{f.name: (ref.PowMode(getattr(msg, f.name).value) if f.name == "mode"
                           else getattr(msg, f.name)) for f in dataclasses.fields(msg)})


def _impl(name):
    """(Coordinator class, its LSP params, client submit, client params)."""
    if name == "ref":
        return RefCoordinator, REF_FAST, ref_submit, REF_FAST
    return Coordinator, FAST, submit, FAST


def _rolled(nonce_bits=6, max_en=5, target=1):
    cb = bytes(range(40))
    return ref.Request(1, ref.PowMode.TARGET, 0, ((max_en + 1) << nonce_bits) - 1,
                       header=GENESIS.pack(), target=target, coinbase_prefix=cb[:12],
                       coinbase_suffix=cb[12:], extranonce_size=1, branch=(cb[:32],),
                       nonce_bits=nonce_bits)


def _rolled_hash(req, index):
    en, nonce = ref_chain.split_global(index, req.nonce_bits)
    tmpl = ref_chain.CoinbaseTemplate(req.coinbase_prefix, req.coinbase_suffix,
                                      req.extranonce_size)
    hdr = ref_chain.rolled_header(req.header, tmpl, req.branch, en).with_nonce(nonce)
    return ref_chain.hash_to_int(hdr.block_hash())


def _candidates(n, width=20):
    return [f"cand-{i:0{width - 5}d}".encode() for i in range(n)]


# -- the wire trace ------------------------------------------------------------

def _answer(tmpl, msg):
    """The scripted peer's reply to one dispatch: brute force for MIN, the
    reference's host compute for a workload, a Beacon and the untracked
    sentinel for a roll chunk, the sentinel for the other targeted ones."""
    if isinstance(msg, ref.RollAssign):
        lo, hi = ref_chain.roll_span(msg.extranonce0, msg.count, tmpl.nonce_bits)
        hw = lo + (1 << tmpl.nonce_bits) // 2 - 1
        return [ref.Beacon(msg.job_id, msg.chunk_id, hw, lo, _rolled_hash(tmpl, lo)),
                ref.Result(msg.job_id, tmpl.mode, 0, ref.MIN_UNTRACKED, found=False,
                           searched=hi - lo + 1, chunk_id=msg.chunk_id)]
    req = dataclasses.replace(tmpl, lower=msg.lower, upper=msg.upper, chunk_id=msg.chunk_id)
    if req.workload:
        return [[r for r in ref_workloads.compute(req) if r is not None][-1]]
    if req.mode == ref.PowMode.MIN:
        h, n = brute_min(req.data, req.lower, req.upper)
        return [ref.Result(msg.job_id, req.mode, n, h, searched=req.upper - req.lower + 1,
                           chunk_id=msg.chunk_id)]
    return [ref.Result(msg.job_id, req.mode, 0, ref.MIN_UNTRACKED, found=False,
                       searched=req.upper - req.lower + 1, chunk_id=msg.chunk_id)]


async def _trace(impl, join, request, coord_kwargs, stats=None):
    """The raw payloads the peer read and the final Result; ``stats``, a
    dict, receives the coordinator's counters at the end."""
    Coord, params, sub, sub_params = _impl(impl)
    coord = await Coord.create(params=params, **coord_kwargs)
    serve = asyncio.ensure_future(coord.serve())
    peer = await RefLspClient.connect("127.0.0.1", coord.port, REF_FAST)
    try:
        peer.write(ref.encode_msg(join))
        await asyncio.sleep(0.05)
        req = request if impl == "ref" else port.decode_msg(ref.encode_msg(request))
        job = asyncio.ensure_future(sub("127.0.0.1", coord.port, req, params=sub_params))
        trace, templates = [], {}
        while True:
            read = asyncio.ensure_future(peer.read())
            await asyncio.wait([read, job], timeout=10, return_when=asyncio.FIRST_COMPLETED)
            if not read.done():
                read.cancel()
                await asyncio.gather(read, return_exceptions=True)
                break
            raw = bytes(read.result())
            trace.append(raw)
            msg = ref.decode_msg(raw)
            if isinstance(msg, ref.Setup):
                templates[msg.request.job_id] = msg.request
            elif isinstance(msg, (ref.Assign, ref.RollAssign)):
                for out in _answer(templates[msg.job_id], msg):
                    peer.write(ref.encode_msg(out, binary=join.codec == "bin"))
            if job.done():
                await asyncio.sleep(0.05)  # let a trailing Cancel land
                while True:
                    try:
                        trace.append(bytes(await asyncio.wait_for(peer.read(), 0.05)))
                    except asyncio.TimeoutError:
                        break
                break
        result = await asyncio.wait_for(job, 5)
        if stats is not None:
            stats.update(coord.stats)
    finally:
        await peer.close(drain_timeout=0.5)  # drains while the coordinator acks
        await _stop(coord, serve)
    return trace, _as_ref(result) if impl == "port" else result


_cat = _candidates(2000)
TRACES = {
    "min-lanes1": (ref.Join(backend="cpu", lanes=1),
                   ref.Request(1, ref.PowMode.MIN, 0, 4095, data=b"trace"), {"chunk_size": 512}),
    "min-span-bin": (ref.Join(backend="cuda", lanes=3, span=700, codec="bin"),
                     ref.Request(2, ref.PowMode.MIN, 0, 9999, data=b"span"),
                     {"chunk_size": 256}),
    "target-bin": (ref.Join(backend="cuda", lanes=2, codec="bin"),
                   ref.Request(3, ref.PowMode.TARGET, 0, 3000, header=GENESIS.pack(),
                               target=1), {"chunk_size": 512}),
    "rolled-roll-budget": (ref.Join(backend="cuda", lanes=1, codec="bin", roll=True),
                           _rolled(), {"chunk_size": 40, "roll_budget": 2}),
    "rolled-no-roll": (ref.Join(backend="cuda", lanes=1, roll=False), _rolled(),
                       {"chunk_size": 100, "roll_budget": 2}),
    "scrypt": (ref.Join(backend="cuda", lanes=1 << 20, codec="bin"),
               ref.Request(4, ref.PowMode.SCRYPT, 0, 2047, header=GENESIS.pack(), target=1),
               {}),
    "hashcore": (ref.Join(backend="cuda", lanes=1, workloads=("dict", "hashcore")),
                 ref.Request(5, ref.PowMode.MIN, 0, 2047, data=ref_hc.pack_params("topk", 9, k=3),
                             workload="hashcore"), {"chunk_size": 512}),
    "dict-windows": (ref.Join(backend="cuda", lanes=64, codec="bin", workloads=("dict",)),
                     ref.Request(6, ref.PowMode.MIN, 0, len(_cat) - 1,
                                 data=ref_ds.pack_params("fmin", 3, _cat), workload="dict"),
                     {"chunk_size": 512}),
    # MIN audits conclude (each sub-range re-mined exactly); the TARGET
    # peer answers with the sentinel, so each audit ends inconclusive
    # after MAX_AUDIT_RETRIES re-dispatches
    "min-audit": (ref.Join(backend="cpu", lanes=1),
                  ref.Request(7, ref.PowMode.MIN, 0, 4095, data=b"audit trace"),
                  {"chunk_size": 512, "audit_rate": 1.0, "audit_seed": 5, "pipeline_depth": 1}),
    "target-audit": (ref.Join(backend="cuda", lanes=2, codec="bin"),
                     ref.Request(8, ref.PowMode.TARGET, 0, 3000, header=GENESIS.pack(),
                                 target=1),
                     {"chunk_size": 512, "audit_rate": 1.0, "audit_seed": 5,
                      "pipeline_depth": 1}),
}


@pytest.mark.parametrize("case", list(TRACES))
def test_wire_trace_equals_the_references(case):
    join, request, kwargs = TRACES[case]
    want, want_result = run(_trace("ref", join, request, kwargs))
    got, got_result = run(_trace("port", join, request, kwargs))
    kinds = {type(ref.decode_msg(raw)).__name__ for raw in want}
    assert "Setup" in kinds and kinds & {"Assign", "RollAssign"}
    if case == "rolled-roll-budget":
        assert "RollAssign" in kinds
    assert got == want
    assert got_result == want_result


# -- the same Results through three roles ----------------------------------------

def _rolled_winner():
    """A rolled job over 3 extranonces × 2^8 nonces whose target admits
    exactly one index (the range's minimum hash)."""
    probe = _rolled(nonce_bits=8, max_en=2)
    return _rolled(nonce_bits=8, max_en=2,
                   target=min(_rolled_hash(probe, g) for g in range(probe.upper + 1)))


_words = _candidates(300, 12)
RESULT_CASES = {
    "min": (ref.Request(1, ref.PowMode.MIN, 0, 20_000, data=b"three roles"), {}),
    "target": (ref.Request(2, ref.PowMode.TARGET, GENESIS.nonce - 3000, GENESIS.nonce + 1000,
                           header=GENESIS.pack(), target=ref_chain.bits_to_target(GENESIS.bits)),
               {}),
    "rolled": (_rolled_winner(), {}),
    "rolled-roll-budget": (_rolled_winner(), {"roll_budget": 1}),
    # one nonce, so one chunk: the CPU plain versions take seconds a batch
    "scrypt": (ref.Request(3, ref.PowMode.SCRYPT, 7, 7, header=GENESIS.pack(),
                           target=(1 << 256) - 1), {}),
    "hashcore": (ref.Request(4, ref.PowMode.MIN, 0, 4095,
                             data=ref_hc.pack_params("fmin", 42), workload="hashcore"), {}),
    "dict": (ref.Request(5, ref.PowMode.MIN, 0, len(_words) - 1,
                         data=ref_ds.pack_params("topk", 42, _words, k=3), workload="dict"), {}),
}


async def _three_roles(impl, request, coord_kwargs, worker_impl=None, codec="binary"):
    """One job through a coordinator, one worker and one client of
    ``impl`` (the worker of ``worker_impl`` when given)."""
    Coord, params, sub, sub_params = _impl(impl)
    coord = await Coord.create(params=params, chunk_size=1024,
                               binary_codec=codec == "binary", **coord_kwargs)
    serve = asyncio.ensure_future(coord.serve())
    if (worker_impl or impl) == "ref":
        worker = asyncio.ensure_future(ref_run_miner("127.0.0.1", coord.port, CpuMiner(),
                                                     params=REF_FAST))
    else:
        worker = asyncio.ensure_future(run_miner(
            "127.0.0.1", coord.port, CudaMiner(device="cpu", slab=65536, scrypt_batch=2),
            params=FAST))
    try:
        await asyncio.sleep(0.05)
        req = request if sub is ref_submit else port.decode_msg(ref.encode_msg(request))
        result = await asyncio.wait_for(sub("127.0.0.1", coord.port, req, params=sub_params), 30)
        miners = [(m.backend, m.binary, m.roll) for m in coord._miners.values()]
    finally:
        await _stop(coord, worker, serve)
    return (result if sub is ref_submit else _as_ref(result)), miners


@pytest.mark.parametrize("case", list(RESULT_CASES))
def test_three_roles_answer_as_the_references(case):
    request, kwargs = RESULT_CASES[case]
    want, _ = run(_three_roles("ref", request, kwargs))
    got, miners = run(_three_roles("port", request, kwargs))
    assert miners and miners[0][0] == "cuda"
    assert got == want
    if request.workload:
        fold = ref_workloads.fold_of(request)
        acc = fold.decode(got.payload)
        assert ref_workloads.get(request.workload).verify(request, fold, acc)
    elif request.mode == ref.PowMode.MIN:
        assert (got.hash_value, got.nonce) == brute_min(request.data, request.lower,
                                                        request.upper)
    else:
        assert got.found and got.hash_value <= request.target


@pytest.mark.parametrize("coordinator", ["port", "ref"])
@pytest.mark.parametrize("codec", ["binary", "json"])
def test_interop_across_implementations(coordinator, codec):
    """The port's coordinator with the reference's worker and client, and
    the reference's coordinator with the port's worker and client; a
    rolled job on a roll budget exercises RollAssign and Beacon too."""
    other = "ref" if coordinator == "port" else "port"
    request = _rolled_winner()
    want = run(_three_roles("ref", request, {"roll_budget": 1}))[0]

    async def scenario():
        Coord, params, _, _ = _impl(coordinator)
        _, _, sub, sub_params = _impl(other)
        coord = await Coord.create(params=params, chunk_size=1024, roll_budget=1,
                                   binary_codec=codec == "binary")
        serve = asyncio.ensure_future(coord.serve())
        if other == "ref":
            worker = asyncio.ensure_future(ref_run_miner("127.0.0.1", coord.port, CpuMiner(),
                                                         params=REF_FAST))
        else:
            worker = asyncio.ensure_future(run_miner("127.0.0.1", coord.port,
                                                     CudaMiner(device="cpu", slab=65536),
                                                     params=FAST))
        try:
            await asyncio.sleep(0.05)
            req = port.decode_msg(ref.encode_msg(request)) if other == "port" else request
            result = await asyncio.wait_for(sub("127.0.0.1", coord.port, req, params=sub_params),
                                            30)
            miners = [(m.binary, m.roll) for m in coord._miners.values()]
            assert coord.stats["chunks_roll_dispatched"] > 0
        finally:
            await _stop(coord, worker, serve)
        return result, miners

    result, miners = run(scenario())
    assert (_as_ref(result) if other == "port" else result) == want
    assert miners == [(codec == "binary", True)]


# -- fault scenarios -------------------------------------------------------------

class _Slow(CudaMiner):
    """The CPU plain versions throttled, so a job is mid-flight when a
    role dies."""

    def mine(self, request):
        for item in super().mine(request):
            time.sleep(0.004)
            yield item


async def _cluster(n_miners, chunk_size=1024, miner=lambda: CudaMiner(device="cpu", slab=65536),
                   **kw):
    coord = await Coordinator.create(params=FAST, chunk_size=chunk_size, **kw)
    tasks = [asyncio.ensure_future(coord.serve())]
    for _ in range(n_miners):
        tasks.append(asyncio.ensure_future(run_miner("127.0.0.1", coord.port, miner(),
                                                     params=FAST)))
    await asyncio.sleep(0.1)
    return coord, tasks


async def _close(coord, tasks):
    await _stop(coord, *tasks)


def test_miner_death_requeues_and_the_job_completes():
    async def scenario():
        coord, tasks = await _cluster(2, miner=lambda: _Slow(device="cpu", slab=256))
        try:
            req = port.Request(1, port.PowMode.MIN, 0, 12_000, data=b"survive")
            job = asyncio.ensure_future(submit("127.0.0.1", coord.port, req, params=FAST))
            while coord.stats["results_accepted"] < 2:
                await asyncio.sleep(0.01)
            tasks[1].cancel()  # one miner dies without a goodbye
            result = await asyncio.wait_for(job, 30)
            assert (result.hash_value, result.nonce) == brute_min(b"survive", 0, 12_000)
            assert coord.stats["chunks_requeued"] >= 1
        finally:
            await _close(coord, tasks)

    run(scenario())


def test_client_death_drops_its_job_and_the_coordinator_serves_on():
    async def scenario():
        coord, tasks = await _cluster(1, chunk_size=512,
                                      miner=lambda: _Slow(device="cpu", slab=256))
        try:
            doomed = await RefLspClient.connect("127.0.0.1", coord.port, REF_FAST)
            doomed.write(ref.encode_msg(ref.Request(1, ref.PowMode.MIN, 0, 500_000,
                                                    data=b"abandoned")))
            await asyncio.sleep(0.15)
            assert len(coord._jobs) == 1
            await doomed.close()
            req = port.Request(2, port.PowMode.MIN, 0, 2000, data=b"ok")
            result = await asyncio.wait_for(submit("127.0.0.1", coord.port, req, params=FAST),
                                            30)
            assert (result.hash_value, result.nonce) == brute_min(b"ok", 0, 2000)
            assert not coord._jobs and coord.stats["jobs_done"] == 1
        finally:
            await _close(coord, tasks)

    run(scenario())


def test_forged_winner_is_rejected_and_the_liar_evicted():
    async def scenario():
        coord, tasks = await _cluster(0)
        try:
            evil = await RefLspClient.connect("127.0.0.1", coord.port, REF_FAST)
            evil.write(ref.encode_msg(ref.Join(backend="evil", lanes=1)))

            async def forge_forever():
                modes = {}
                while True:
                    msg = ref.decode_msg(await evil.read())
                    if isinstance(msg, ref.Setup):
                        modes[msg.request.job_id] = msg.request.mode
                    elif isinstance(msg, ref.Assign):
                        evil.write(ref.encode_msg(ref.Result(
                            msg.job_id, modes[msg.job_id], nonce=msg.lower, hash_value=0,
                            found=True, searched=1, chunk_id=msg.chunk_id)))

            tasks.append(asyncio.ensure_future(forge_forever()))
            evil.write(ref.encode_msg(ref.Steal(job_id=1)))  # no federation: denied
            await asyncio.sleep(0.05)
            assert coord.stats["steals_denied"] == 1
            req = port.Request(1, port.PowMode.TARGET, GENESIS.nonce - 500, GENESIS.nonce + 500,
                               header=GENESIS.pack(),
                               target=chain.bits_to_target(GENESIS.bits))
            job = asyncio.ensure_future(submit("127.0.0.1", coord.port, req, params=FAST))
            await asyncio.sleep(0.5)
            assert not job.done()
            assert coord.stats["results_rejected"] == MAX_REJECTIONS
            assert coord.stats["miners_evicted"] == 1
            tasks.append(asyncio.ensure_future(run_miner(
                "127.0.0.1", coord.port, CudaMiner(device="cpu", slab=65536), params=FAST)))
            result = await asyncio.wait_for(job, 30)
            assert result.found and result.nonce == GENESIS.nonce
            assert chain.hash_to_hex(result.hash_value.to_bytes(32, "little")) == \
                chain.GENESIS_HASH_HEX
        finally:
            await _close(coord, tasks)

    run(scenario())


def test_refused_assign_requeues_and_resends_the_setup():
    async def scenario():
        coord, tasks = await _cluster(0, chunk_size=4096)
        try:
            w = await RefLspClient.connect("127.0.0.1", coord.port, REF_FAST)
            w.write(ref.encode_msg(ref.Join(backend="flaky", lanes=1)))
            setups = []

            async def act():
                refused, templates = False, {}
                while True:
                    msg = ref.decode_msg(await w.read())
                    if isinstance(msg, ref.Setup):
                        setups.append(msg)
                        templates[msg.request.job_id] = msg.request
                    elif isinstance(msg, ref.Assign):
                        t = templates.get(msg.job_id)
                        if not refused or t is None:
                            refused = True
                            templates.pop(msg.job_id, None)  # "evicted"
                            w.write(ref.encode_msg(ref.Refuse(msg.job_id, msg.chunk_id)))
                            continue
                        h, n = brute_min(t.data, msg.lower, msg.upper)
                        w.write(ref.encode_msg(ref.Result(
                            msg.job_id, t.mode, n, h, searched=msg.upper - msg.lower + 1,
                            chunk_id=msg.chunk_id)))

            tasks.append(asyncio.ensure_future(act()))
            req = port.Request(9, port.PowMode.MIN, 0, 9999, data=b"refuse me")
            result = await asyncio.wait_for(submit("127.0.0.1", coord.port, req, params=FAST),
                                            30)
            assert (result.hash_value, result.nonce) == brute_min(b"refuse me", 0, 9999)
            assert len(setups) >= 2 and coord.stats["chunks_requeued"] >= 1
            # a workload no registry knows is refused outright, with no retry hint
            bad = port.Request(10, port.PowMode.MIN, 0, 9, data=b"x", workload="nosuch")
            with pytest.raises(JobRefused):
                await asyncio.wait_for(submit("127.0.0.1", coord.port, bad, params=FAST), 10)
            assert coord.stats["refused_workload"] == 1
        finally:
            await _close(coord, tasks)

    run(scenario())


def test_early_exit_cancels_the_remaining_work(caplog):
    caplog.set_level(logging.INFO, logger="tpuminter_torch.worker")

    async def scenario():
        coord, tasks = await _cluster(2, miner=lambda: CudaMiner(device="cpu", slab=4096))
        try:
            easy = (1 << 252) - 1
            req = port.Request(1, port.PowMode.TARGET, 0, 50_000_000, header=GENESIS.pack(),
                               target=easy)
            result = await asyncio.wait_for(submit("127.0.0.1", coord.port, req, params=FAST),
                                            20)
            digest = chain.dsha256(GENESIS.pack()[:76] + struct.pack("<I", result.nonce))
            assert result.found and chain.hash_to_int(digest) == result.hash_value <= easy
            assert coord.stats["hashes"] < 1_000_000 and not coord._jobs
            await asyncio.sleep(0.1)
            assert all(not m.busy for m in coord._miners.values())
        finally:
            await _close(coord, tasks)

    run(scenario())


@pytest.mark.parametrize("span", [5_000, 1 << 31], ids=["multiple-spans", "half-job-cap"])
def test_span_hint_caps(span):
    sizes = []

    class SpanMiner(CudaMiner):
        def mine(self, request):
            sizes.append(request.upper - request.lower + 1)
            yield from super().mine(request)

    def make():
        miner = SpanMiner(device="cpu", slab=4096)
        miner.lanes, miner.span = 1, span  # the reference test's CPU-class hints
        return miner

    async def scenario():
        coord, tasks = await _cluster(1, chunk_size=600, miner=make)
        try:
            req = port.Request(3, port.PowMode.MIN, 0, 99_999, data=b"span hint")
            result = await asyncio.wait_for(submit("127.0.0.1", coord.port, req, params=FAST),
                                            30)
            assert (result.hash_value, result.nonce) == brute_min(b"span hint", 0, 99_999)
        finally:
            await _close(coord, tasks)

    run(scenario())
    assert sum(sizes) == 100_000
    if span == 5_000:
        assert min(sizes) >= SPANS_PER_DISPATCH * span
    else:
        assert len(sizes) >= 2 and max(sizes) <= 50_000


# -- cross-recovery ----------------------------------------------------------------

@pytest.mark.parametrize("first, second", [("ref", "port"), ("port", "ref")])
def test_each_coordinator_recovers_from_the_others_journal(tmp_path, first, second):
    wal = str(tmp_path / "coord.wal")
    data, upper = b"cross-recover", 12_000

    async def scenario():
        A, a_params, _, _ = _impl(first)
        B, b_params, _, _ = _impl(second)
        coord = await A.create(params=a_params, chunk_size=512, recover_from=wal)
        port_no = coord.port
        serve = asyncio.ensure_future(coord.serve())
        worker = asyncio.ensure_future(run_miner_reconnect(
            "127.0.0.1", port_no, _Slow(device="cpu", slab=256), params=FAST,
            base_backoff=0.05, max_backoff=0.4, rng=random.Random(1)))
        answered = await asyncio.wait_for(submit(
            "127.0.0.1", port_no, port.Request(1, port.PowMode.MIN, 0, 999, data=b"first"),
            params=FAST, client_key="k1"), 30)
        job = asyncio.ensure_future(submit(
            "127.0.0.1", port_no, port.Request(2, port.PowMode.MIN, 0, upper, data=data),
            params=FAST, client_key="k2", reconnect=True, base_backoff=0.05,
            rng=random.Random(2)))
        coord2 = None
        try:
            t0 = time.monotonic()
            while coord.stats["results_accepted"] < 6:
                assert time.monotonic() - t0 < 20, "no progress before the crash"
                await asyncio.sleep(0.01)
            assert coord.stats["jobs_done"] == 1
            serve.cancel()
            await asyncio.gather(serve, return_exceptions=True)
            endpoint = coord.server.endpoint
            coord.crash()
            await endpoint.wait_closed()
            for _ in range(100):
                try:
                    coord2 = await B.create(port_no, params=b_params, chunk_size=512,
                                            recover_from=wal)
                    break
                except OSError:
                    await asyncio.sleep(0.02)
            assert len(coord2._jobs) == 1 and len(coord2._winners) == 1
            serve = asyncio.ensure_future(coord2.serve())
            result = await asyncio.wait_for(job, 40)
            assert (result.hash_value, result.nonce) == brute_min(data, 0, upper)
            # the answered winner survived: a re-submission is answered
            # from the recovered table, not re-mined
            again = await asyncio.wait_for(submit(
                "127.0.0.1", port_no, port.Request(1, port.PowMode.MIN, 0, 999, data=b"first"),
                params=FAST, client_key="k1"), 10)
            assert again == answered == port.Result(
                1, port.PowMode.MIN, brute_min(b"first", 0, 999)[1],
                brute_min(b"first", 0, 999)[0], True, searched=1000)
            assert coord2.stats["jobs_done"] == 1 and coord2.stats["results_accepted"] > 0
        finally:
            for t in (worker, job, serve):
                t.cancel()
            await asyncio.gather(worker, job, serve, return_exceptions=True)
            await (coord2 or coord).close()

    run(scenario(), 90)
