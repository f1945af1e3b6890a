"""The port's multi-process coordinator held to the reference's.

- *Seam frames*: each of the five kinds is byte-equal to the
  reference's on drawn fields, each side decodes the other's, and both
  refuse the same damaged frames and out-of-range fields.
- *Configurations*: what the reference refuses (``procs=0``; ``--procs``
  with ``--loops``, ``--replicate-to``, ``--hedge-after``,
  ``--audit-rate``, ``--stats-port``) is refused.
- *Drills* on real shard processes behind one UDP port, port workers on
  the CPU plain versions: a job answered on each shard; a durable job
  live at a kill -9 of every shard process, re-submitted on the other
  shard after the restart, answered once through the rebind registry;
  one tenant alternating shards held to one budget; ``procs=1`` as the
  degenerate case; no shard process left after ``close()``.

LSP sessions at 50 ms epochs on ephemeral ports; every wait is bounded
and every child is killed in a ``finally``.
"""

import asyncio
import os
import signal
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tpuminter import protocol as ref
from tests.test_torch_multiloop import (  # the drills' miners, dials and waits
    FAST,
    _collect,
    _dial,
    _drain,
    _one_torch_thread,  # noqa: F401  (autouse: one torch thread for the module)
    _Serial,
    brute_min,
    run,
)
from tpuminter_torch import coordinator as port_coordinator
from tpuminter_torch import protocol as port
from tpuminter_torch.lsp import LspClient
from tpuminter_torch.multiproc import MultiProcCoordinator, _ShardSeam
from tpuminter_torch.protocol import PowMode, Refuse, Request, Result, encode_msg
from tpuminter_torch.worker import run_miner


# -- the seam frames ---------------------------------------------------------------

_CKEY = st.text(min_size=1, max_size=40).filter(lambda s: 0 < len(s.encode()) <= 512)
_U64 = st.integers(0, 2**64 - 1)
_U32 = st.integers(0, 2**32 - 1)
_IP4 = st.tuples(*[st.integers(0, 255)] * 4).map(lambda q: "%d.%d.%d.%d" % q)


def _both(name, *args, **kw):
    mine = getattr(port, name)(*args, **kw)
    assert mine == getattr(ref, name)(*args, **kw)
    assert port.decode_seam(mine) == ref.decode_seam(mine)
    return mine


@settings(max_examples=60, deadline=None)
@given(ip=_IP4, p=st.integers(0, 65535), data=st.binary(max_size=200), origin=st.integers(0, 255),
       ckey=_CKEY, cjid=_U64, conn=_U32, admitted=_U64, miss=st.booleans())
def test_each_seam_frame_is_the_references_both_ways(ip, p, data, origin, ckey, cjid, conn,
                                                      admitted, miss):
    assert port.decode_seam(_both("encode_seam_fwd", (ip, p), data)) == ("fwd", (ip, p), data)
    assert port.decode_seam(_both("encode_seam_bind", origin, ckey, cjid)) == (
        "bind", origin, ckey, cjid)
    assert port.decode_seam(_both("encode_seam_rebind", origin, conn, ckey, cjid)) == (
        "rebind", origin, conn, ckey, cjid)
    payload = b"" if miss else data
    assert port.decode_seam(_both("encode_seam_answer", conn, cjid, payload, miss=miss)) == (
        "answer", miss, conn, cjid, payload)
    assert port.decode_seam(_both("encode_seam_quota", origin, ckey, admitted)) == (
        "quota", origin, ckey, admitted)


def _damaged():
    good = port.encode_seam_bind(1, "k", 2)
    flipped = bytearray(port.encode_seam_rebind(0, 11, "tenant", 5))
    flipped[len(flipped) // 2] ^= 0x40
    return [bytes(flipped), good[:0], good[:1], good[:-1], b"\xee" + good[1:],
            port.encode_seam_fwd(("1.2.3.4", 5), b"")[:7]]


@pytest.mark.parametrize("frame", _damaged())
def test_both_decoders_refuse_a_damaged_frame(frame):
    with pytest.raises(port.ProtocolError):
        port.decode_seam(frame)
    with pytest.raises(ref.ProtocolError):
        ref.decode_seam(frame)


@pytest.mark.parametrize("name, args, kw", [
    ("encode_seam_bind", (1, "", 2), {}),
    ("encode_seam_bind", (1, "k" * 513, 2), {}),
    ("encode_seam_bind", (256, "k", 2), {}),
    ("encode_seam_bind", (1, "k", 2**64), {}),
    ("encode_seam_answer", (1, 2, b"data"), {"miss": True}),
    ("encode_seam_answer", (2**32, 2, b""), {}),
    ("encode_seam_fwd", (("::1", 9), b""), {}),
    ("encode_seam_fwd", (("127.0.0.1", 1 << 16), b""), {}),
    ("encode_seam_rebind", (256, 1, "k", 1), {}),
    ("encode_seam_quota", (0, "k", -1), {}),
])
def test_both_encoders_refuse_the_same_fields(name, args, kw):
    with pytest.raises(port.ProtocolError):
        getattr(port, name)(*args, **kw)
    with pytest.raises(ref.ProtocolError):
        getattr(ref, name)(*args, **kw)


# -- configurations ----------------------------------------------------------------

@pytest.mark.parametrize("argv, words", [
    (["--procs", "0"], "must be >= 1"),
    (["--procs", "2", "--loops", "2"], "mutually exclusive"),
    (["--procs", "2", "--journal", "x.wal", "--replicate-to", "127.0.0.1:9"],
     "--replicate-to is not available with --procs"),
    (["--procs", "2", "--hedge-after", "1"], "not plumbed through --procs"),
    (["--procs", "2", "--audit-rate", "0.5"], "not plumbed through --procs"),
    (["--procs", "2", "--stats-port", "0"], "--stats-port is not available"),
])
def test_the_cli_refuses_what_the_reference_refuses(argv, words, capsys):
    with pytest.raises(SystemExit) as exc:
        port_coordinator.main(["0", *argv])
    assert exc.value.code == 2
    assert words in capsys.readouterr().err


def test_procs_below_one_is_refused():
    async def scenario():
        with pytest.raises(ValueError):
            await MultiProcCoordinator.create(procs=0)

    run(scenario())


def test_a_frame_for_a_sibling_still_starting_is_held_until_go():
    """Before the parent's ``go`` a frame for a sibling whose socket does
    not exist yet (its process still starting) is held, not dropped, and
    goes out at ``go``; after it such a frame drops, as the reference's
    always does."""
    import shutil
    import socket
    import tempfile

    seam_dir = tempfile.mkdtemp(prefix="seam-")
    own = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
    sibling = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
    try:
        own.bind(os.path.join(seam_dir, "shard0.sock"))
        own.setblocking(False)
        seam = _ShardSeam(0, 2, seam_dir, own)
        seam.forward_datagram(1, b"\x00connect", ("127.0.0.1", 4000))
        assert seam.stats["fwd_out"] == 1 and seam.stats["seam_drops"] == 0
        sibling.bind(os.path.join(seam_dir, "shard1.sock"))
        sibling.settimeout(5)
        seam.release_held()
        assert port.decode_seam(sibling.recv(65536)) == (
            "fwd", ("127.0.0.1", 4000), b"\x00connect")
        sibling.close()
        os.unlink(os.path.join(seam_dir, "shard1.sock"))
        seam.forward_datagram(1, b"late", ("127.0.0.1", 4000))
        assert seam.stats["seam_drops"] == 1
    finally:
        own.close()
        sibling.close()
        shutil.rmtree(seam_dir, ignore_errors=True)


# -- drills ------------------------------------------------------------------------

async def _results(client, *, first_timeout=20.0, dup_window=0.3):
    return await _collect(client, kinds=(Result, Refuse), first_timeout=first_timeout,
                          dup_window=dup_window)


async def _staff(coord, limit=12):
    """Start miners until every shard process holds one (before any
    client, a shard's connections are its miners)."""
    tasks = []
    while len(tasks) < limit:
        tasks.append(asyncio.ensure_future(run_miner(
            "127.0.0.1", coord.port, _Serial(device="cpu", slab=65536), params=FAST)))
        deadline = time.monotonic() + 3.0
        while True:
            conns = [r["conns"] for r in await coord.stats_all(timeout=2.0)]
            if sum(conns) >= len(tasks):
                break
            assert time.monotonic() < deadline, f"a miner did not join: {conns}"
            await asyncio.sleep(0.02)
        if len(conns) == coord.procs and all(conns):
            return tasks
    await _drain(*tasks)
    raise AssertionError(f"a shard process has no miner after {limit}")


def _reap(coord):
    """Belt and braces: SIGKILL any shard process still alive."""
    for child in coord._children:
        if child.is_alive():
            os.kill(child.pid, signal.SIGKILL)
            child.join(5)


def test_two_shard_processes_answer_rebind_and_share_one_budget(tmp_path):
    """(1) A job on each shard process, answered once by brute force's
    answer, the seam's counters mirrored across the shards. (2) A
    durable job live at a kill -9 of every shard process, re-submitted
    after the restart from the OTHER shard: the sibling consults its
    rebind registry and the home shard answers once
    (``seam_rebinds_honored`` >= 1). (3) One tenant alternating shards
    spends one budget (``quota_foreign_debits`` > 0). No shard process
    is left after ``close()``."""
    wal = str(tmp_path / "mp.wal")
    coords = []

    async def scenario():
        # (1) a job on each shard
        coord = await MultiProcCoordinator.create(procs=2, params=FAST, chunk_size=1024,
                                                  recover_from=wal)
        coords.append(coord)
        assert coord.steer_kernel
        miners = await _staff(coord)
        try:
            for shard in (0, 1):
                client = await _dial(coord.port, (shard, 2))
                req = Request(shard + 1, PowMode.MIN, 0, 6000, data=b"mp-%d" % shard,
                              client_key=f"mp-job-{shard}")
                client.write(encode_msg(req))
                (res,) = await _results(client)
                await client.close(drain_timeout=0.05)
                assert (res.hash_value, res.nonce) == brute_min(req.data, 0, 6000)
            snaps = await coord.stats_all()
            assert [s["stats"]["jobs_done"] for s in snaps] == [1, 1]
            s0, s1 = (s["seam"] for s in snaps)
            assert s0["fwd_out"] == s1["fwd_in"] and s1["fwd_out"] == s0["fwd_in"]
            assert s0["binds_gossiped"] == s1["binds_learned"] == 1
            assert s1["binds_gossiped"] == s0["binds_learned"] == 1
            assert s0["seam_drops"] == s1["seam_drops"] == 0
        finally:
            await _drain(*miners)
            await coord.close()
        assert coord.alive() == [False, False]

        # (2) the rebind drill: live at the kill, no miner anywhere
        coord = await MultiProcCoordinator.create(procs=2, params=FAST, chunk_size=1024,
                                                  recover_from=wal)
        coords.append(coord)
        req = Request(11, PowMode.MIN, 0, 9000, data=b"mp-rebind", client_key="mp-drill")
        client = await _dial(coord.port, (0, 2))
        client.write(encode_msg(req))
        await asyncio.sleep(0.4)  # the job and its bind reach the segment
        await client.close(drain_timeout=0.05)
        await coord.crash()
        assert coord.alive() == [False, False]
        coord = await MultiProcCoordinator.create(procs=2, params=FAST, chunk_size=1024,
                                                  recover_from=wal)
        coords.append(coord)
        miners = await _staff(coord)
        try:
            await asyncio.sleep(0.1)  # the recovered binds' gossip lands
            client = await _dial(coord.port, (1, 2))
            client.write(encode_msg(req))
            answers = await _results(client)
            await client.close(drain_timeout=0.05)
            assert [(a.hash_value, a.nonce) for a in answers] == [brute_min(b"mp-rebind", 0,
                                                                              9000)]
            snaps = await coord.stats_all()
            assert sum(s["stats"]["seam_rebinds_honored"] for s in snaps) >= 1
            assert sum(s["seam"]["rebinds_sent"] for s in snaps) >= 1
            assert sum(s["stats"]["jobs_done"] for s in snaps) == 1  # nothing re-minted
        finally:
            await _drain(*miners)
            await coord.close()

        # (3) one budget across processes
        coord = await MultiProcCoordinator.create(procs=2, params=FAST, chunk_size=1024,
                                                  quota_rate=0.001, quota_burst=3)
        coords.append(coord)
        miners = await _staff(coord)
        try:
            ca, cb = await _dial(coord.port, (0, 2)), await _dial(coord.port, (1, 2))
            admitted = refused = 0
            for i in range(6):
                qc = ca if i % 2 == 0 else cb
                qc.write(encode_msg(Request(i + 1, PowMode.MIN, 0, 1023, data=b"q-%d" % i,
                                            client_key="mp-tenant")))
                (msg,) = await _results(qc, dup_window=0.05)
                admitted += isinstance(msg, Result)
                refused += isinstance(msg, Refuse)
                await asyncio.sleep(0.05)  # the admission gossip lands first
            await ca.close(drain_timeout=0.05)
            await cb.close(drain_timeout=0.05)
            assert admitted + refused == 6
            assert 1 <= admitted <= 3 + 1  # one budget, give or take one gossip in flight
            snaps = await coord.stats_all()
            assert sum(s["stats"]["quota_foreign_debits"] for s in snaps) > 0
        finally:
            await _drain(*miners)
            await coord.close()
        assert coord.alive() == [False, False]

    try:
        run(scenario(), 90)
    finally:
        for c in coords:
            _reap(c)
    for c in coords:
        assert not any(child.is_alive() for child in c._children)
        assert not os.path.exists(c._seam_dir or "/nonexistent-seam-dir")


def test_one_process_is_the_degenerate_case():
    """``procs=1``: one shard process, no steering program, the job
    answered by brute force's answer, nothing left after ``close()``."""
    coords = []

    async def scenario():
        coord = await MultiProcCoordinator.create(procs=1, params=FAST, chunk_size=1024)
        coords.append(coord)
        assert coord.steer_kernel is False
        miners = await _staff(coord)
        try:
            client = await LspClient.connect("127.0.0.1", coord.port, FAST)
            client.write(encode_msg(Request(1, PowMode.MIN, 0, 5000, data=b"mp-one")))
            (res,) = await _results(client)
            await client.close(drain_timeout=0.05)
            assert (res.hash_value, res.nonce) == brute_min(b"mp-one", 0, 5000)
            (snap,) = await coord.stats_all()
            assert snap["shard"] == 0 and snap["stats"]["jobs_done"] == 1
            assert snap["seam"]["fwd_out"] == snap["seam"]["fwd_in"] == 0
        finally:
            await _drain(*miners)
            await coord.close()

    try:
        run(scenario(), 60)
    finally:
        for c in coords:
            _reap(c)
    assert coords[0].alive() == [False]
