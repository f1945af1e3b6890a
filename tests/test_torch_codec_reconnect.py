"""The port worker's binary codec, negotiation, reconnect and address
rotation, against the reference.

The port's ``protocol`` packs every kind a worker sends or receives
byte for byte as ``tpuminter.protocol.encode_msg(..., binary=True)``
does, both ways, on hypothesis-drawn fields; flipping any single byte
of such a frame makes both decoders raise (or both decode it alike); a
tag a worker never receives raises in the port. Over real LSP on
localhost, against an unchanged coordinator: a worker that joins with
JSON is answered in JSON and answers in JSON, one that joins with the
binary codec answers in binary only once the coordinator has spoken it;
a port worker with ``run_miner_reconnect`` redials a journaled
coordinator that is crashed and restarted mid-job, and the job is
answered exactly once, equal to brute force; with two addresses it
rotates onto a promoted standby (``tests/test_replication.py``'s
scenario). The CLI takes the reference's flags and refuses what it
refuses.
"""

import asyncio
import dataclasses
import logging
import random
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tpuminter import chain as ref_chain
from tpuminter import protocol as ref
from tpuminter.client import submit
from tpuminter.coordinator import Coordinator
from tpuminter.lsp import Params as RefParams
from tpuminter.replication import ReplicationStandby
from tpuminter_torch import protocol as port
from tpuminter_torch.cuda_worker import CudaMiner
from tpuminter_torch.lsp import Params
from tpuminter_torch.lsp.params import jittered_backoff
from tpuminter_torch.worker import (
    _parse_args, dial_patience, parse_addr_list, run_miner, run_miner_reconnect)

_LSP = dict(epoch_limit=5, epoch_millis=50, window_size=32, max_backoff_interval=2,
            max_unacked_messages=32)
REF_FAST, FAST = RefParams(**_LSP), Params(**_LSP)

u64 = st.integers(0, (1 << 64) - 1)
u256 = st.integers(0, (1 << 256) - 1)
modes = st.sampled_from(list(ref.PowMode))
backends = st.text(st.characters(min_codepoint=33, max_codepoint=126), min_size=1,
                   max_size=16)

#: every kind a worker sends or receives, as a strategy of reference messages
KINDS = {
    "Assign": st.builds(ref.Assign, u64, u64, u64, u64),
    "Result": st.builds(ref.Result, u64, modes, u64, u256, st.booleans(), u64, u64),
    "Refuse": st.builds(ref.Refuse, u64, u64),
    "Cancel": st.builds(ref.Cancel, u64),
    "Join": st.builds(ref.Join, backend=backends, lanes=st.integers(0, (1 << 32) - 1),
                      span=u64, codec=st.sampled_from(["json", "bin"]), roll=st.booleans()),
    "RollAssign": st.builds(ref.RollAssign, u64, u64, u64, st.integers(1, (1 << 32) - 1)),
    "Beacon": st.builds(ref.Beacon, u64, u64, u64, u64, u256),
    "WorkResult": st.builds(ref.WorkResult, u64, u64, st.integers(0, 255), u64,
                            st.binary(max_size=64)),
}
#: one frame of each kind, for the byte-flip sweep
SAMPLES = [
    ref.Assign(9, 4, 5, 1 << 40),
    ref.Result(1, ref.PowMode.TARGET, 2083236893, ref.MIN_UNTRACKED, False, 7, 3),
    ref.Refuse(9, 4),
    ref.Cancel(9),
    ref.Join(backend="cuda", lanes=32768, span=1 << 27, codec="bin", roll=True),
    ref.RollAssign(3, 8, 4, 2),
    ref.Beacon(3, 8, (4 << 32) | 77, (4 << 32) | 5, 1 << 200),
    ref.WorkResult(5, 6, 1, 1 << 29, bytes(range(23))),
]


def _port_of(msg):
    return getattr(port, type(msg).__name__)(**{
        f.name: (port.PowMode(getattr(msg, f.name).value) if f.name == "mode"
                 else getattr(msg, f.name)) for f in dataclasses.fields(msg)})


def _same(mine, theirs) -> bool:
    return (type(mine).__name__ == type(theirs).__name__
            and dataclasses.asdict(mine) == dataclasses.asdict(theirs))


@pytest.mark.parametrize("kind", list(KINDS))
@settings(max_examples=30)
@given(data=st.data())
def test_binary_frames_are_the_references_both_ways(kind, data):
    msg = data.draw(KINDS[kind])
    raw = ref.encode_msg(msg, binary=True)
    assert raw[0] != 0x7B  # every drawn field fits the binary layout
    assert port.encode_msg(_port_of(msg), binary=True) == raw
    assert _same(port.decode_msg(raw), msg)
    assert ref.decode_msg(port.encode_msg(port.decode_msg(raw), binary=True)) == msg
    assert port.payload_is_binary(raw) and not port.payload_is_binary(ref.encode_msg(msg))


def test_binary_falls_back_to_json_as_the_reference_does():
    """Fields past a layout, a Join that names workloads and the kinds
    without a layout are JSON in both, byte for byte."""
    req = ref.Request(1, ref.PowMode.MIN, 0, 9, data=b"x")
    for msg in (ref.Assign(1, 2, 3, 1 << 64), ref.Result(1, ref.PowMode.MIN, -1, 0),
                ref.Join(backend="cuda", codec="bin", workloads=("dict", "hashcore")),
                ref.Join(backend="x" * 17, codec="bin"), ref.Setup(req), req):
        raw = ref.encode_msg(msg, binary=True)
        assert raw[0] == 0x7B and port.encode_msg(port.decode_msg(raw), binary=True) == raw


@pytest.mark.parametrize("msg", SAMPLES, ids=lambda m: type(m).__name__)
def test_every_single_byte_flip_decodes_as_the_reference_does(msg):
    raw = ref.encode_msg(msg, binary=True)
    for i in range(len(raw)):
        for flip in (0x01, 0x80, 0xFF, raw[i] ^ 0x7B):
            bad = bytearray(raw)
            bad[i] ^= flip
            try:
                want = ref.decode_msg(bytes(bad))
            except ref.ProtocolError:
                with pytest.raises(port.ProtocolError):
                    port.decode_msg(bytes(bad))
                continue
            assert _same(port.decode_msg(bytes(bad)), want), (i, flip)
    for n in range(len(raw)):  # every truncation
        with pytest.raises(ref.ProtocolError):
            ref.decode_msg(raw[:n])
        with pytest.raises(port.ProtocolError):
            port.decode_msg(raw[:n])


def test_tags_a_worker_never_receives_raise():
    """The reference's lease-epoch variants (sent only to aggregators)
    and its binary admission Refuse (clients get JSON) decode there and
    raise here. Its partial emits, which the port's client receives, and
    its WAL batches, which the port's standby receives, decode here as
    there in both codecs, as does the admission Refuse's JSON."""
    for msg in (ref.RollAssign(1, 2, 3, 4, lease_epoch=5), ref.Beacon(1, 2, 3, 4, 5, 6),
                ref.Refuse(1, 0, retry_after_ms=50)):
        raw = ref.encode_msg(msg, binary=True)
        assert raw[0] != 0x7B and ref.decode_msg(raw) is not None
        with pytest.raises(port.ProtocolError, match="not one a worker receives"):
            port.decode_msg(raw)
    for msg, codecs in ((ref.Refuse(1, 0, retry_after_ms=50), (False,)),
                        (ref.Emit(1, 1, 1, 2, b"y"), (True, False)),
                        (ref.WalBatch(0, b"x"), (True, False))):
        for binary in codecs:
            raw = ref.encode_msg(msg, binary=binary)
            assert _same(port.decode_msg(raw), msg)
            assert port.encode_msg(port.decode_msg(raw), binary=binary) == raw
    with pytest.raises(port.ProtocolError):
        port.decode_msg(b"\xc0" + bytes(20))


# -- negotiation over real LSP ----------------------------------------------

def _run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _session(binary: bool, coordinator_binary: bool):
    """One MIN job of two chunks through an unchanged coordinator; the
    worker's session ends with the coordinator. Returns the Result and
    whether the coordinator marked the worker binary."""
    coord = await Coordinator.create(params=REF_FAST, chunk_size=4096,
                                     binary_codec=coordinator_binary)
    serve = asyncio.ensure_future(coord.serve())
    worker = asyncio.ensure_future(run_miner("127.0.0.1", coord.port, CudaMiner(device="cpu"),
                                             params=FAST, binary=binary))
    try:
        await asyncio.sleep(0.05)
        result = await submit("127.0.0.1", coord.port,
                              ref.Request(1, ref.PowMode.MIN, 0, 8191, data=b"negotiate"),
                              params=REF_FAST)
        marked = [m.binary for m in coord._miners.values()]
    finally:
        serve.cancel()
        await asyncio.gather(serve, return_exceptions=True)
        await coord.close()
        await asyncio.wait_for(worker, 10)
    return result, marked


def _sent(caplog):
    """(Results, binary Results) from the worker's session-end line, and
    whether it logged the switch."""
    ends = [r for r in caplog.records if "Results sent" in r.getMessage()]
    assert len(ends) == 1
    _, _, results, binary = ends[0].args
    switched = any("speaks the binary codec" in r.getMessage() for r in caplog.records)
    return results, binary, switched


@pytest.mark.parametrize("binary, coordinator_binary, want", [
    (False, True, "json"), (True, False, "json"), (True, True, "binary")],
    ids=["json-join", "old-coordinator", "binary"])
def test_codec_negotiation(caplog, binary, coordinator_binary, want):
    caplog.set_level(logging.INFO, logger="tpuminter_torch.worker")
    result, marked = _run(_session(binary, coordinator_binary))
    assert (result.hash_value, result.nonce) == min(
        (ref_chain.toy_hash(b"negotiate", n), n) for n in range(8192))
    assert marked == [binary and coordinator_binary]
    results, sent_binary, switched = _sent(caplog)
    assert results == 2
    assert (sent_binary, switched) == ((2, True) if want == "binary" else (0, False))


# -- reconnect -----------------------------------------------------------------

class _Slow(CudaMiner):
    """The CPU plain versions throttled so a job is mid-flight when the
    coordinator dies (steps run on the worker's step thread)."""

    def mine(self, request):
        for item in super().mine(request):
            time.sleep(0.004)
            yield item


def _brute(data, upper):
    return min((ref_chain.toy_hash(data, n), n) for n in range(upper + 1))


async def _restart(port_no, wal):
    for _ in range(100):
        try:
            return await Coordinator.create(port_no, params=REF_FAST, chunk_size=512,
                                            recover_from=wal)
        except OSError:
            await asyncio.sleep(0.02)
    raise AssertionError("could not rebind the coordinator's port")


def test_crash_and_restart_answers_the_job_exactly_once(tmp_path):
    wal, upper, data = str(tmp_path / "coord.wal"), 8191, b"port-crash"

    async def scenario():
        coord = await Coordinator.create(params=REF_FAST, chunk_size=512, recover_from=wal)
        port_no = coord.port
        serve = asyncio.ensure_future(coord.serve())
        worker = asyncio.ensure_future(run_miner_reconnect(
            "127.0.0.1", port_no, _Slow(device="cpu", slab=256), params=FAST,
            base_backoff=0.05, max_backoff=0.4, rng=random.Random(1)))
        await asyncio.sleep(0.1)
        sub = asyncio.ensure_future(submit(
            "127.0.0.1", port_no, ref.Request(3, ref.PowMode.MIN, 0, upper, data=data),
            params=REF_FAST, client_key="port-crash", reconnect=True, base_backoff=0.05,
            rng=random.Random(2)))
        coord2 = None
        try:
            t0 = time.monotonic()
            while coord.stats["results_accepted"] < 3:
                assert time.monotonic() - t0 < 20, "no progress before the crash"
                await asyncio.sleep(0.01)
            assert coord.stats["jobs_done"] == 0, "the crash must land mid-job"
            serve.cancel()
            await asyncio.gather(serve, return_exceptions=True)
            endpoint = coord.server.endpoint
            coord.crash()
            await endpoint.wait_closed()
            coord2 = await _restart(port_no, wal)
            assert len(coord2._jobs) == 1  # replayed from the journal
            serve = asyncio.ensure_future(coord2.serve())
            result = await asyncio.wait_for(sub, 40)
            assert (result.hash_value, result.nonce) == _brute(data, upper) and result.found
            assert coord2.stats["jobs_done"] == 1 and not coord2._jobs
            assert coord2.stats["results_accepted"] > 0  # the port worker redialed
            assert any(m.backend == "cuda" for m in coord2._miners.values())
        finally:
            for t in (worker, sub, serve):
                t.cancel()
            await asyncio.gather(worker, sub, serve, return_exceptions=True)
            await (coord2 or coord).close()

    _run(scenario(), 90)


def test_two_address_rotation_lands_on_the_promoted_standby(tmp_path):
    pwal, swal, upper, data = str(tmp_path / "p.wal"), str(tmp_path / "s.wal"), 8191, b"rotate"

    async def scenario():
        standby = await ReplicationStandby.create(swal, params=REF_FAST)
        runner = asyncio.ensure_future(standby.run())
        coord = await Coordinator.create(params=REF_FAST, chunk_size=512, recover_from=pwal,
                                         replicate_to=[("127.0.0.1", standby.port)],
                                         replica_ack=True)
        addrs = [("127.0.0.1", coord.port), ("127.0.0.1", standby.port)]
        serve = asyncio.ensure_future(coord.serve())
        worker = asyncio.ensure_future(run_miner_reconnect(
            "", 0, _Slow(device="cpu", slab=256), params=FAST, addrs=addrs,
            base_backoff=0.05, max_backoff=0.4, rng=random.Random(3)))
        await asyncio.sleep(0.2)
        sub = asyncio.ensure_future(submit(
            "", 0, ref.Request(4, ref.PowMode.MIN, 0, upper, data=data), params=REF_FAST,
            client_key="port-rotate", reconnect=True, base_backoff=0.05,
            rng=random.Random(4), addrs=addrs))
        serve2 = coord2 = None
        try:
            t0 = time.monotonic()
            while coord.stats["results_accepted"] < 3:
                assert time.monotonic() - t0 < 20, "no progress before the failover"
                await asyncio.sleep(0.01)
            assert coord.stats["jobs_done"] == 0, "the failover must land mid-job"
            serve.cancel()
            await asyncio.gather(serve, return_exceptions=True)
            coord.crash()
            await asyncio.wait_for(standby.primary_lost.wait(),
                                   20 * REF_FAST.epoch_limit * REF_FAST.epoch_seconds)
            coord2 = await standby.promote(chunk_size=512)
            assert len(coord2._jobs) == 1
            serve2 = asyncio.ensure_future(coord2.serve())
            result = await asyncio.wait_for(sub, 60)
            assert (result.hash_value, result.nonce) == _brute(data, upper) and result.found
            assert not coord2._jobs and coord2.stats["results_accepted"] > 0
            assert any(m.backend == "cuda" for m in coord2._miners.values())
        finally:
            for t in (worker, sub, runner) + ((serve2,) if serve2 else ()):
                t.cancel()
            await asyncio.gather(worker, sub, runner, *((serve2,) if serve2 else ()),
                                 return_exceptions=True)
            if coord2 is not None:
                await coord2.close()

    _run(scenario(), 120)


def test_max_dials_bounds_a_dead_address_list():
    """Every dial of a dead list fails fast (two connect epochs an
    address) and the loop returns after ``max_dials``."""
    async def scenario():
        t0 = time.monotonic()
        await run_miner_reconnect("", 0, CudaMiner(device="cpu"), params=FAST,
                                  addrs=[("127.0.0.1", 9), ("127.0.0.1", 7)], max_dials=3,
                                  base_backoff=0.01, max_backoff=0.02, rng=random.Random(5))
        return time.monotonic() - t0

    # 3 dials of 2 epochs of 50 ms and two short waits
    assert _run(scenario(), 20) < 3 * 2 * FAST.epoch_seconds + 1.0


# -- the CLI and the helpers ---------------------------------------------------

def test_cli_takes_the_references_flags_and_refusals(tmp_path, capsys):
    args, addrs = _parse_args(["--coordinator", "h:1,h:2", "--reconnect", "--profile",
                               str(tmp_path), "--codec", "json"])
    assert addrs == [("h", 1), ("h", 2)] and args.reconnect and args.profile == str(tmp_path)
    assert args.codec == "json"
    args, addrs = _parse_args(["127.0.0.1:7911"])
    assert addrs == [("127.0.0.1", 7911)] and args.codec == "binary" and not args.reconnect
    for argv in (["--coordinator", "h:1,h:2"], [], ["h:x"], ["--codec", "xml", "h:1"]):
        with pytest.raises(SystemExit):
            _parse_args(argv)
    assert "only makes sense with --reconnect" in capsys.readouterr().err


def test_helpers_equal_the_references():
    from tpuminter.lsp.params import jittered_backoff as ref_backoff
    from tpuminter.replication import dial_patience as ref_patience
    from tpuminter.replication import parse_addr_list as ref_parse

    for spec in ("h:1", ":7", "a:1, b:2,", "::1:5"):
        assert parse_addr_list(spec) == ref_parse(spec)
    for bad in ("", ",", "h:x"):
        with pytest.raises(ValueError):
            parse_addr_list(bad)
        with pytest.raises(ValueError):
            ref_parse(bad)
    for targets in ([("h", 1)], [("h", 1), ("h", 2)]):
        assert dial_patience(targets) == ref_patience(targets)
    mine, theirs = jittered_backoff(0.2, 5.0, random.Random(9)), ref_backoff(
        0.2, 5.0, random.Random(9))
    assert [next(mine) for _ in range(8)] == [next(theirs) for _ in range(8)]
