"""The port's multi-loop coordinator held to the reference's.

- *Partitioning*: ``shard_of``/``shard_for_job`` equal the reference's
  on drawn addresses and ids; the cBPF steering program is the
  reference's, byte for byte, and attaches on this kernel; conn ids
  stripe by shard.
- *Segments*: ``segment_paths`` and ``merge_states`` equal the
  reference's on seeded record streams (a compacted segment included);
  ``Journal.open`` absorbs segments; group commit shares fsyncs.
- *Transport*: both I/O modes deliver, and draw the same faults from one
  seed as each other and as the reference's endpoint.
- *Drills* (port workers on the CPU plain versions, every shard
  staffed): a 2-loop coordinator answers every job once with brute
  force's answer; a crash in writer mode and one in segments mode,
  restarted at another loop count, answer every durable client once,
  under the strict loop-affinity detector; a 2-loop primary fails over
  to the port's standby.
- *Interop*: each journal recovers the other's segments to an equal
  state and file; a reference client is answered over the wire.

LSP sessions at 50 ms epochs on ephemeral ports; every wait is bounded.
"""

import asyncio
import os
import random
import shutil
import socket
import sys
import threading
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tpuminter import chain as ref_chain
from tpuminter import journal as ref_journal
from tpuminter import multiloop as ref_multiloop
from tpuminter import protocol as ref
from tpuminter.client import submit as ref_submit
from tpuminter.lsp import Params as RefParams
from tpuminter.lsp.transport import UdpEndpoint as RefUdpEndpoint
from tpuminter_torch import coordinator as port_coordinator
from tpuminter_torch.analysis import affinity
from tpuminter_torch.cuda_worker import CudaMiner
from tpuminter_torch.journal import (
    Journal,
    encode_settle,
    merge_states,
    replay,
    scan_file,
    segment_paths,
)
from tpuminter_torch.lsp import LspClient, LspServer, Params
from tpuminter_torch.lsp.transport import UdpEndpoint
from tpuminter_torch.multiloop import (
    MultiLoopCoordinator,
    _cbpf_conn_steering,
    attach_conn_steering,
    shard_for_job,
    shard_of,
)
from tpuminter_torch.protocol import (
    PowMode,
    Request,
    Result,
    decode_msg,
    encode_msg,
    request_to_obj,
)
from tpuminter_torch.replication import ReplicationStandby
from tpuminter_torch.worker import run_miner, run_miner_reconnect

_LSP = dict(epoch_limit=5, epoch_millis=50, window_size=32, max_backoff_interval=2,
            max_unacked_messages=32)
FAST, REF_FAST = Params(**_LSP), RefParams(**_LSP)
LOSS_S = 20 * FAST.epoch_limit * FAST.epoch_seconds


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are many small torch calls: with several
    miners at once, torch's intra-op threads only contend (restored
    after the module)."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run(coro, timeout=40.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _until(cond, limit, what):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < limit, what
        await asyncio.sleep(0.01)


async def _drain(*tasks):
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)


def brute_min(data, lo, hi):
    return min((ref_chain.toy_hash(data, n), n) for n in range(lo, hi + 1))


#: One miner thread at a time runs the plain versions: each slab is
#: thousands of small torch calls, each of which gives up and retakes
#: the GIL, so several mining threads at once mostly wait on each other.
_COMPUTE = threading.Lock()
_END = object()


class _Serial(CudaMiner):
    """The CPU plain versions, one mining thread at a time, with an
    optional sleep after each slab (``delay``) so a job is still
    mid-flight when the coordinator dies."""

    delay = 0.0

    def mine(self, request):
        steps = super().mine(request)
        while True:
            with _COMPUTE:
                item = next(steps, _END)
            if item is _END:
                return
            if self.delay:
                time.sleep(self.delay)
            yield item


def _slow():
    miner = _Serial(device="cpu", slab=1024)
    miner.delay = 0.03
    return miner


def _miner():
    return _Serial(device="cpu", slab=65536)


async def _staff(coord, make, limit=16):
    """Start miners until every shard holds one: a job mines only on its
    client's shard, so a drill judges no job on an empty one."""
    tasks = []
    while len(tasks) < limit:
        tasks.append(asyncio.ensure_future(make()))
        try:
            await _until(lambda: sum(m["miners"] for m in coord.shard_metrics()) >= len(tasks),
                         2.0, "a miner did not join")
        except AssertionError:
            await _drain(*tasks)
            raise
        if all(m["miners"] for m in coord.shard_metrics()):
            return tasks
    await _drain(*tasks)
    raise AssertionError(f"a shard has no miner after {limit}: {coord.shard_metrics()}")


async def _dial(port, shard=None):
    """A client connection; with ``shard=(k, n)``, redialed until its
    source port hashes to shard k of n."""
    for _ in range(256):
        client = await LspClient.connect("127.0.0.1", port, FAST)
        if shard is None or shard_of(("127.0.0.1", client._endpoint.local_addr[1]),
                                     shard[1]) == shard[0]:
            return client
        await client.close(drain_timeout=0.05)
    raise AssertionError(f"no connection landed on shard {shard}")


async def _collect(client, *, kinds=(Result,), first_timeout=20.0, dup_window=0.3):
    """Every message of ``kinds`` on ``client`` until ``dup_window`` of
    silence after the first: a duplicate answer that was going to come,
    comes."""
    out, timeout = [], first_timeout
    try:
        while True:
            msg = decode_msg(await asyncio.wait_for(client.read(), timeout))
            if isinstance(msg, kinds):
                out.append(msg)
                timeout = dup_window
    except asyncio.TimeoutError:
        pass
    return out


async def _ask(port, req, *, shard=None, first_timeout=20.0, dup_window=0.3):
    """Submit ``req`` on a fresh connection; its Results (:func:`_collect`)."""
    client = await _dial(port, shard)
    try:
        client.write(encode_msg(req))
        return await _collect(client, first_timeout=first_timeout, dup_window=dup_window)
    finally:
        await client.close(drain_timeout=0.1)


def _min_req(jid, upper, ckey=""):
    return Request(jid, PowMode.MIN, 0, upper, data=b"ml-%d" % jid, client_key=ckey)


# -- partitioning ------------------------------------------------------------------

_ADDR = st.tuples(
    st.tuples(st.integers(0, 255), st.integers(0, 255), st.integers(0, 255),
              st.integers(0, 255)).map(lambda q: "%d.%d.%d.%d" % q),
    st.integers(0, 65535))


@settings(max_examples=200, deadline=None)
@given(addr=_ADDR, loops=st.integers(1, 16), job_id=st.integers(1, 2**63))
def test_shard_of_and_shard_for_job_equal_the_references(addr, loops, job_id):
    assert shard_of(addr, loops) == ref_multiloop.shard_of(addr, loops)
    assert shard_for_job(job_id, loops) == ref_multiloop.shard_for_job(job_id, loops)


@pytest.mark.parametrize("loops", range(2, 9))
def test_cbpf_program_is_the_references(loops):
    assert _cbpf_conn_steering(loops) == ref_multiloop._cbpf_conn_steering(loops)


def test_attach_conn_steering_on_this_kernel():
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        sock.bind(("127.0.0.1", 0))
        attached = attach_conn_steering(sock, 2)
    finally:
        sock.close()
    assert attached == sys.platform.startswith("linux")
    assert not attach_conn_steering(None, 2)


def test_conn_id_stride_partitions_the_id_space():
    async def scenario():
        server = await LspServer.create(0, FAST, conn_id_start=3, conn_id_stride=4)
        try:
            ids = [server._new_conn(("127.0.0.1", 40000 + i)).conn_id for i in range(5)]
            assert ids == [3, 7, 11, 15, 19]
        finally:
            server.crash()

    run(scenario())


# -- segments ----------------------------------------------------------------------

def _records(rng, jid):
    """One job's records: job, settles (packed and JSON), perhaps a
    finish or an abandon, perhaps a quota record."""
    req = request_to_obj(_min_req(jid, 4095, ckey=f"ck-{jid}"))
    recs = [{"k": "job", "id": jid, "req": req}]
    for _ in range(rng.randrange(1, 4)):
        lo = rng.randrange(0, 4000)
        recs.append({"k": "settle", "id": jid, "lo": lo, "hi": min(4095, lo + rng.randrange(64)),
                     "n": lo, "s": 64, "h": "%x" % rng.randrange(1, 2**64)})
    roll = rng.random()
    if roll < 0.3:
        recs.append({"k": "finish", "id": jid, "ckey": f"ck-{jid}", "cjid": jid, "mode": "min",
                     "n": 9, "h": "%x" % (900 + jid), "found": True, "s": 64, "ts": 1.5})
    elif roll < 0.4:
        recs.append({"k": "abandon", "id": jid})
    if rng.random() < 0.3:
        recs.append({"k": "quota", "buckets": [["tenant", round(rng.random() * 8, 3),
                                                 rng.randrange(3)]]})
    return recs


def _split(seed, loops=2, jobs=12):
    rng = random.Random(seed)
    per_shard = {k: [] for k in range(loops)}
    for jid in range(1, jobs + 1):
        per_shard[shard_for_job(jid, loops)].extend(_records(rng, jid))
    # one segment compacted itself mid-stream: its snapshot resets only it
    half = len(per_shard[0]) // 2
    compacted = [replay(per_shard[0][:half]).snapshot_obj()] + per_shard[0][half:]
    return [per_shard[k] for k in range(loops)], [compacted] + [per_shard[k]
                                                                  for k in range(1, loops)]


@pytest.mark.parametrize("seed", range(6))
def test_merge_states_equals_the_references(seed):
    for streams in _split(seed, loops=2 + seed % 2):
        mine = merge_states([replay(s) for s in streams])
        theirs = ref_journal.merge_states([ref_journal.replay(s) for s in streams])
        assert mine.snapshot_obj() == theirs.snapshot_obj()
        assert (mine.boot_epoch, mine.records, mine.finished) == (
            theirs.boot_epoch, theirs.records, theirs.finished)


def test_segment_paths_and_scan_file_equal_the_references(tmp_path):
    base = str(tmp_path / "w.wal")
    for name in ("w.wal.s0", "w.wal.s1", "w.wal.s12", "w.wal.sx", "w.wal.compact", "w.wal"):
        (tmp_path / name).write_bytes(b"")
    assert segment_paths(base) == ref_journal.segment_paths(base)
    assert len(segment_paths(base)) == 3
    j = Journal.fresh(f"{base}.s0", 5, {"k": "snapshot", "next": 3, "jobs": [], "winners": []})
    j.append("abandon", {"id": 1})
    j._flush_buffered_sync()
    j._fh.close()
    assert scan_file(f"{base}.s0") == ref_journal.scan_file(f"{base}.s0")
    assert scan_file(str(tmp_path / "missing")) == []


def _write_segments(journal_cls, encode, base, seed, loops=2):
    """Segments ``base.s<k>`` written through ``journal_cls`` (the port's
    or the reference's ``Journal.fresh`` and appends)."""
    streams, _ = _split(seed, loops)
    for k, stream in enumerate(streams):
        j = journal_cls.fresh(f"{base}.s{k}", 3)
        for rec in stream:
            rec = dict(rec)
            if rec["k"] == "settle":
                j.append_encoded(encode(rec["id"], rec["lo"], rec["hi"], rec["n"], rec["s"],
                                        int(rec["h"], 16)))
            else:
                j.append(rec.pop("k"), rec)
        j._flush_buffered_sync()
        j._fh.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_journal_open_absorbs_the_others_segments(tmp_path, writer):
    """Segments written by one implementation: the port's and the
    reference's single-loop ``Journal.open`` each recover them to the
    same state and write the same base file, and delete the segments."""
    src = tmp_path / "src"
    src.mkdir()
    journal_cls, encode = ((Journal, encode_settle) if writer == "port"
                           else (ref_journal.Journal, ref_journal.encode_settle))
    _write_segments(journal_cls, encode, str(src / "w.wal"), seed=7)
    states, files = {}, {}
    for who, cls in (("port", Journal), ("reference", ref_journal.Journal)):
        dst = tmp_path / who
        shutil.copytree(src, dst)
        journal, state = cls.open(str(dst / "w.wal"))
        journal._fh.close()
        assert segment_paths(str(dst / "w.wal")) == []
        states[who], files[who] = state, (dst / "w.wal").read_bytes()
        again_j, again = cls.open(str(dst / "w.wal"))  # the absorbed snapshot replays alike
        again_j._fh.close()
        assert again.snapshot_obj() == state.snapshot_obj()
    assert states["port"].boot_epoch == states["reference"].boot_epoch == 4
    assert states["port"].snapshot_obj() == states["reference"].snapshot_obj()
    assert files["port"] == files["reference"]


def test_group_commit_shares_one_fsync_across_a_winner_burst(tmp_path):
    async def scenario():
        journal, _ = Journal.open(str(tmp_path / "g.wal"))
        journal.group_commit = True
        fired = []
        base_syncs = journal.stats["syncs"]
        for i in range(6):
            journal.append("finish", {"id": i, "ckey": f"c{i}", "cjid": i, "mode": "min",
                                      "n": 1, "h": "ff", "found": True, "s": 1},
                           on_durable=lambda i=i: fired.append(i))
            await asyncio.sleep(0.0005)
        await journal.flush()
        assert sorted(fired) == list(range(6))
        assert 1 <= journal.stats["syncs"] - base_syncs <= 3
        await journal.aclose()

    run(scenario())


# -- the transport's two modes -------------------------------------------------------

async def _fault_pattern(cls, io_batch):
    """Which of 60 datagrams a seeded 30% write-drop and 20% write-dup
    let through, and the counters."""
    got = []
    server = await cls.create(lambda d, a: got.append(bytes(d)), local_addr=("127.0.0.1", 0),
                              io_batch=io_batch, seed=7)
    sender = await cls.create(lambda d, a: None, io_batch=io_batch, seed=11)
    try:
        sender.write_drop_rate, sender.write_dup_rate = 0.3, 0.2
        addr = server.local_addr
        for i in range(40):
            sender.send(b"m%d" % i, addr)
        sender.send_batch([b"b%d" % i for i in range(10)], addr)
        sender.send_grouped([(addr, [b"g%d" % i for i in range(10)])])
        await asyncio.sleep(0.15)
        server.set_read_drop_rate(1.0)
        sender.write_drop_rate = sender.write_dup_rate = 0.0
        sender.send(b"dropped", addr)
        await asyncio.sleep(0.1)
        return (sorted(got), sender.dropped_out, sender.duplicated_out, sender.sent,
                server.received, server.dropped_in)
    finally:
        server.close()
        sender.close()


def test_both_io_modes_deliver_and_draw_the_same_faults():
    async def scenario():
        batched = await _fault_pattern(UdpEndpoint, True)
        stdlib = await _fault_pattern(UdpEndpoint, False)
        reference = await _fault_pattern(RefUdpEndpoint, True)
        return batched, stdlib, reference

    batched, stdlib, reference = run(scenario())
    assert batched == stdlib == reference
    got, dropped, duplicated, sent, received, dropped_in = batched
    assert dropped > 0 and duplicated > 0 and dropped_in == 1
    # the last datagram left and was dropped on arrival
    assert sent - 1 == received == len(got) == 60 - dropped + duplicated
    assert b"dropped" not in got


# -- construction -------------------------------------------------------------------

def test_multiloop_refuses_the_references_bad_configurations(tmp_path):
    async def scenario():
        with pytest.raises(ValueError):
            await MultiLoopCoordinator.create(loops=0)
        with pytest.raises(ValueError):
            await MultiLoopCoordinator.create(
                loops=2, recover_from=str(tmp_path / "x.wal"), journal_mode="segments",
                replicate_to=[("127.0.0.1", 1)])
        with pytest.raises(ValueError):
            await MultiLoopCoordinator.create(loops=2, replicate_to=[("127.0.0.1", 1)])
        with pytest.raises(ValueError):
            await MultiLoopCoordinator.create(loops=2, journal_mode="mirror")

    run(scenario())
    assert not os.path.exists(tmp_path / "x.wal")


@pytest.mark.parametrize("argv, words", [
    (["--loops", "0"], "must be >= 1"),
    (["--loops", "2", "--procs", "2"], "mutually exclusive"),
    (["--loops", "2", "--journal", "x.wal", "--journal-mode", "segments",
      "--replicate-to", "127.0.0.1:9"], "segmented journals cannot ship"),
    (["--loops", "2", "--stats-port", "0"], "--stats-port is not available"),
    (["--loops", "2", "--io-batch", "maybe"], "invalid choice"),
])
def test_the_cli_refuses_what_the_reference_refuses(argv, words, capsys):
    with pytest.raises(SystemExit) as exc:
        port_coordinator.main(["0", *argv])
    assert exc.value.code == 2
    assert words in capsys.readouterr().err


# -- drills -------------------------------------------------------------------------

def test_two_loops_answer_every_job_once_with_brute_forces_answer():
    """Six clients' MIN jobs and a genesis TARGET job over a 2-loop
    coordinator with a miner on each shard: one answer each, equal to
    brute force and to hashlib's double SHA-256; both shards carried
    connections."""
    genesis = ref_chain.GENESIS_HEADER

    async def scenario():
        coord = await MultiLoopCoordinator.create(loops=2, params=FAST, chunk_size=1024)
        miners = await _staff(coord, lambda: run_miner("127.0.0.1", coord.port, _miner(),
                                                        params=FAST))
        try:
            reqs = [_min_req(i, 6000) for i in range(1, 7)]
            reqs.append(Request(7, PowMode.TARGET, genesis.nonce - 3000, genesis.nonce + 3000,
                                header=genesis.pack(),
                                target=ref_chain.bits_to_target(genesis.bits)))
            answers = await asyncio.gather(*(_ask(coord.port, r) for r in reqs))
            assert [len(a) for a in answers] == [1] * 7
            for req, (res,) in zip(reqs[:6], answers):
                assert (res.hash_value, res.nonce) == brute_min(req.data, 0, 6000)
            res = answers[6][0]
            block = genesis.with_nonce(res.nonce)
            assert res.found and res.nonce == genesis.nonce
            assert res.hash_value == int.from_bytes(ref_chain.dsha256(block.pack()), "little")
            assert coord.stats["jobs_done"] == 7
            shards = coord.shard_metrics()
            assert all(s["conns"] > 0 and s["datagrams_received"] > 0 for s in shards)
        finally:
            await _drain(*miners)
            await coord.crash()

    run(scenario(), 60)


def _crash_drill(tmp_path, mode, restart_loops):
    """kill -9 a 2-loop coordinator in ``mode`` with one durable job
    answered and three live, restart it at ``restart_loops`` on the same
    journal: every durable client's re-submission is answered once,
    equal to brute force, the live ones by their recovered jobs (each
    client redials onto its job's home shard, ``shard_for_job``; from
    another shard it would mint a job of its own, the in-process seam's
    known waste). The strict affinity detector watches it all."""
    wal = str(tmp_path / "c.wal")
    upper = 65535  # sixteen 4096-nonce chunks: no live job can finish before the kill
    answered = _min_req(1, 2000, ckey="drill-a")
    live = [_min_req(10 + i, upper, ckey=f"drill-{i}") for i in range(3)]

    async def scenario():
        coord = await MultiLoopCoordinator.create(loops=2, params=FAST, chunk_size=256,
                                                  recover_from=wal, journal_mode=mode)
        miners = await _staff(coord, lambda: run_miner("127.0.0.1", coord.port,
                                                        _slow(),
                                                        params=FAST))
        clients = []
        try:
            assert len(await _ask(coord.port, answered)) == 1
            for req in live:
                clients.append(await LspClient.connect("127.0.0.1", coord.port, FAST))
                clients[-1].write(encode_msg(req))
            await _until(lambda: coord.stats["hashes"] > 2001 + 4096, 15, "no progress")
            assert coord.stats["jobs_done"] == 1, "the kill must land mid-job"
        finally:
            await _drain(*miners)
            await coord.crash()
            for c in clients:
                await c.close(drain_timeout=0.05)
        coord = await MultiLoopCoordinator.create(loops=restart_loops, params=FAST,
                                                  chunk_size=1024, recover_from=wal,
                                                  journal_mode=mode)
        try:
            home = {job.client_job_id: shard_for_job(jid, restart_loops)
                    for jid, job in coord._jobs.items()}
            assert sorted(home) == [r.job_id for r in live]
            assert sum(j.hashes_done for j in coord._jobs.values()) > 0
            miners = await _staff(coord, lambda: run_miner("127.0.0.1", coord.port, _miner(),
                                                            params=FAST), limit=24)
            answers = await asyncio.gather(_ask(coord.port, answered), *(
                _ask(coord.port, r, shard=(home[r.job_id], restart_loops)) for r in live))
            assert [len(a) for a in answers] == [1] * 4
            assert (answers[0][0].hash_value, answers[0][0].nonce) == brute_min(
                answered.data, 0, 2000)
            for req, (res,) in zip(live, answers[1:]):
                assert (res.hash_value, res.nonce) == brute_min(req.data, 0, upper)
            assert coord.stats["jobs_done"] == 3 and not coord._jobs  # nothing re-minted
            if mode == "segments":
                assert segment_paths(wal) == [f"{wal}.s{k}" for k in range(restart_loops)]
                assert not os.path.exists(wal)
            else:
                assert segment_paths(wal) == []
        finally:
            await _drain(*miners)
            await coord.crash()

    affinity.enable(strict=True)
    affinity.reset()
    try:
        run(scenario(), 90)
        assert affinity.violations() == []
    finally:
        affinity.disable()
        affinity.reset()


def test_crash_drill_in_writer_mode_restarts_at_three_loops(tmp_path):
    _crash_drill(tmp_path, "writer", 3)


def test_crash_drill_in_segments_mode_restarts_at_one_loop(tmp_path):
    _crash_drill(tmp_path, "segments", 1)


def test_writer_mode_compacts_the_shared_wal_in_a_barrier(tmp_path):
    """Writer mode's live compaction: past ``compact_bytes`` the writer
    loop freezes the other shard, merges both shards' snapshots and
    swaps the file; the swapped file replays to every answered winner,
    and a restart answers a re-submission from it."""
    wal = str(tmp_path / "w.wal")
    reqs = [_min_req(40 + i, 3000, ckey=f"compact-{i}") for i in range(6)]

    async def scenario():
        coord = await MultiLoopCoordinator.create(loops=2, params=FAST, chunk_size=1024,
                                                  recover_from=wal, compact_bytes=1500)
        miners = await _staff(coord, lambda: run_miner("127.0.0.1", coord.port, _miner(),
                                                        params=FAST))
        try:
            answers = await asyncio.gather(*(_ask(coord.port, r, dup_window=0.05)
                                             for r in reqs))
            assert [len(a) for a in answers] == [1] * 6
            await _until(lambda: coord._journal.stats["compactions"] >= 1, 5, "no compaction")
            assert coord._journal.generation >= 1
        finally:
            await _drain(*miners)
            await coord.close()
        state = replay(scan_file(wal))
        assert sorted(cj for _ck, cj in state.winners) == [r.job_id for r in reqs]
        assert not state.jobs and any(
            rec["k"] == "snapshot" for rec in scan_file(wal))
        coord = await MultiLoopCoordinator.create(loops=2, params=FAST, recover_from=wal)
        try:
            (again,) = await _ask(coord.port, reqs[0])
            (first,) = answers[0]
            assert (again.hash_value, again.nonce) == (first.hash_value, first.nonce)
        finally:
            await coord.crash()

    run(scenario(), 60)


def test_two_loop_primary_fails_over_to_the_ports_standby(tmp_path):
    """A 2-loop writer-mode primary ships one WAL to the port's standby
    with replica-acked winners; it dies mid-job, the standby promotes,
    and each of two bound clients is answered once, by brute force."""
    pwal, swal, upper = str(tmp_path / "p.wal"), str(tmp_path / "s.wal"), 65535
    payloads = [b"ml-failover-a", b"ml-failover-b"]
    from tpuminter_torch.client import submit

    async def scenario():
        standby = await ReplicationStandby.create(swal, params=FAST)
        runner = asyncio.ensure_future(standby.run())
        coord = await MultiLoopCoordinator.create(
            loops=2, params=FAST, chunk_size=256, recover_from=pwal,
            replicate_to=[("127.0.0.1", standby.port)], replica_ack=True)
        addrs = [("127.0.0.1", coord.port), ("127.0.0.1", standby.port)]
        rng = random.Random(5)
        miners = await _staff(coord, lambda: run_miner_reconnect(
            "", 0, _slow(), params=FAST, addrs=addrs,
            base_backoff=0.05, max_backoff=0.4, rng=random.Random(rng.random())))
        subs = [asyncio.ensure_future(submit(
            "", 0, Request(70 + i, PowMode.MIN, 0, upper, data=payloads[i]), params=FAST,
            client_key=f"ml-failover-{i}", reconnect=True, base_backoff=0.05,
            rng=random.Random(i), addrs=addrs)) for i in range(2)]
        coord2 = serve2 = None
        try:
            await _until(lambda: coord.stats["hashes"] > 4096, 15, "no progress")
            assert coord.stats["jobs_done"] == 0, "the kill must land mid-job"
            await _until(lambda: standby.stats["records_applied"] >= 4, 10, "shipping lagged")
            await coord.crash()
            await asyncio.wait_for(standby.primary_lost.wait(), LOSS_S)
            coord2 = await standby.promote(chunk_size=1024)
            assert len(coord2._jobs) == 2
            assert sum(j.hashes_done for j in coord2._jobs.values()) > 0
            serve2 = asyncio.ensure_future(coord2.serve())
            results = await asyncio.wait_for(asyncio.gather(*subs), 60)
            for i, res in enumerate(results):
                assert (res.hash_value, res.nonce) == brute_min(payloads[i], 0, upper)
            assert not coord2._jobs and coord2.stats["jobs_done"] == 2
        finally:
            await _drain(*miners, *subs, runner, *((serve2,) if serve2 else ()))
            if coord2 is not None:
                coord2.crash()

    run(scenario(), 90)


def test_a_reference_client_is_answered_by_two_port_loops():
    async def scenario():
        coord = await MultiLoopCoordinator.create(loops=2, params=FAST, chunk_size=1024)
        miners = await _staff(coord, lambda: run_miner("127.0.0.1", coord.port, _miner(),
                                                        params=FAST))
        try:
            results = await asyncio.gather(*(asyncio.wait_for(ref_submit(
                "127.0.0.1", coord.port, ref.Request(i, ref.PowMode.MIN, 0, 5000,
                                                     data=b"ref-%d" % i),
                params=REF_FAST), 20) for i in range(1, 4)))
            for i, res in enumerate(results, 1):
                assert isinstance(res, ref.Result)
                assert (res.hash_value, res.nonce) == brute_min(b"ref-%d" % i, 0, 5000)
        finally:
            await _drain(*miners)
            await coord.crash()

    run(scenario(), 60)
