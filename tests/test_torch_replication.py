"""The port's replication held to the reference's, scenario for scenario
of ``tests/test_replication.py`` (which stays as it is).

- *The shipping stream*: a corrupted or truncated shipped batch, through
  the port's standby, keeps exactly the record prefix that the
  reference's ``scan_with_cursor`` decodes; the shadow applied batch by
  batch equals the reference's ``replay``; ``cursor_valid`` answers as
  the reference's on the same files.
- *Shipping*: a port primary's lane builds, in a port standby, a copy
  byte-equal to its file and a shadow equal to the reference's replay of
  it; a restarted standby resumes at its cursor and applies no record
  twice; the serve-tick flusher's file replays in the reference.
- *The replica-ack tier*: gates park until acked, survive a compaction's
  change of offset space, and are released when a session dies.
- *Failover*: a restarted old primary is fenced through the reset path
  and cannot touch the promoted state; a worker fleet and two bound
  clients lose their primary mid-job and the promoted standby answers
  each exactly once, equal to brute force; the tenants' quota buckets
  survive the promotion.

The reference's ``test_loadgen_failover_scenario_smoke`` waits for the
port of ``scripts/loadgen.py``, which comes with the chaos slice.
Workers run the port's CPU plain versions; LSP sessions at 50 ms epochs
on ephemeral ports.
"""

import asyncio
import os
import random
import time

import pytest

from tpuminter import chain as ref_chain
from tpuminter import journal as ref_journal
from tpuminter_torch import replication
from tpuminter_torch.client import submit
from tpuminter_torch.coordinator import Coordinator
from tpuminter_torch.cuda_worker import CudaMiner
from tpuminter_torch.journal import (
    Journal,
    RecoveredState,
    cursor_valid,
    encode_record,
    encode_settle,
    frame_payload,
    scan,
    scan_with_cursor,
)
from tpuminter_torch.lsp import LspClient, Params
from tpuminter_torch.protocol import (
    PowMode,
    Request,
    SyncAck,
    WalBatch,
    encode_msg,
    request_to_obj,
)
from tpuminter_torch.replication import (
    FENCE_JUMP,
    ReplicationPrimary,
    ReplicationStandby,
    gate_any,
    parse_addr_list,
)
from tpuminter_torch.worker import run_miner_reconnect

FAST = Params(epoch_limit=5, epoch_millis=50, window_size=32, max_backoff_interval=2,
              max_unacked_messages=32)
LOSS_S = 20 * FAST.epoch_limit * FAST.epoch_seconds


def run(coro, timeout=30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _drain(*tasks):
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)


async def _until(cond, limit, what):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < limit, what
        await asyncio.sleep(0.01)


def _req_obj(jid, upper=4095, ckey=""):
    return request_to_obj(Request(job_id=jid, mode=PowMode.MIN, lower=0, upper=upper,
                                  data=b"rep-%d" % jid, client_key=ckey))


def _record_stream(rng, n=30):
    """A plausible journal: jobs, packed settles and some finishes."""
    blobs = []
    for jid in range(1, n + 1):
        blobs.append(encode_record({"k": "job", "id": jid, "req": _req_obj(jid)}))
        lo = rng.randrange(0, 2048)
        blobs.append(frame_payload(encode_settle(jid, lo, lo + 511, lo, 512,
                                                 rng.randrange(2**64))))
        if rng.random() < 0.3:
            blobs.append(encode_record({"k": "finish", "id": jid, "ckey": f"c{jid}",
                                        "cjid": jid, "mode": "min", "n": lo, "h": "ab",
                                        "found": True, "s": 512}))
    return b"".join(blobs)


def _same_state(mine: RecoveredState, ref_state) -> None:
    assert mine.jobs.keys() == ref_state.jobs.keys()
    for jid, job in ref_state.jobs.items():
        assert mine.jobs[jid].remaining == job.remaining
        assert mine.jobs[jid].best == job.best
        assert mine.jobs[jid].hashes_done == job.hashes_done
    assert mine.winners == ref_state.winners
    assert mine.next_job_id == ref_state.next_job_id
    assert mine.boot_epoch == ref_state.boot_epoch
    assert mine.quota == ref_state.quota


class _StubServer:
    """What a standby's batch handler touches of its listener."""

    def __init__(self):
        self.rejected, self.sent = [], []

    def reject_conn(self, conn_id):
        self.rejected.append(conn_id)

    def write(self, conn_id, payload):
        self.sent.append((conn_id, bytes(payload)))


def _bare_standby(path):
    standby = ReplicationStandby()
    standby.path = path
    standby._fh = open(path, "ab")
    standby._server = _StubServer()
    standby._primary_conn = 7
    return standby


# -- the shipping stream ---------------------------------------------------------

@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_a_damaged_batch_applies_the_references_exact_prefix(tmp_path, damage):
    """A byte flipped anywhere in a shipped batch, or the batch cut
    anywhere: the port's standby keeps exactly the records (and bytes)
    the reference's ``scan_with_cursor`` decodes, which are a prefix of
    the undamaged batch's, acks only a whole batch and resets the link
    otherwise."""
    rng = random.Random(0x5EED if damage == "flip" else 0xCAFE)
    for trial in range(40):
        stream = _record_stream(rng, n=rng.randrange(2, 12))
        clean_records, _ = ref_journal.scan(stream)
        wire = bytearray(stream)
        if damage == "flip":
            i = rng.randrange(len(wire))
            wire[i] ^= rng.randrange(1, 256)
        else:
            wire = wire[:rng.randrange(len(wire))]
        wire = bytes(wire)
        want_records, want_clean, want_last = ref_journal.scan_with_cursor(wire)
        assert scan_with_cursor(wire) == (want_records, want_clean, want_last)
        assert want_records == clean_records[:len(want_records)], trial
        path = str(tmp_path / f"{damage}{trial}.wal")
        standby = _bare_standby(path)
        standby._on_batch(7, WalBatch(0, wire))
        standby._fh.close()
        with open(path, "rb") as fh:
            assert fh.read() == wire[:want_clean]
        assert standby.size == want_clean
        assert standby.stats["records_applied"] == len(want_records)
        _same_state(standby.shadow, ref_journal.replay(want_records))
        whole = want_clean == len(wire)
        assert standby._server.rejected == ([] if whole else [7])
        assert [p for _, p in standby._server.sent] == (
            [encode_msg(SyncAck(want_clean))] if whole else [])


def test_batch_by_batch_shadow_equals_the_references_replay(tmp_path):
    """Whatever the batch boundaries (mid-record splits included: the
    standby keeps each batch's clean prefix, and the next batch starts
    at its cursor), the shadow equals the reference's replay of the
    whole stream and the copy equals the stream."""
    rng = random.Random(7)
    for trial in range(12):
        stream = _record_stream(rng, n=rng.randrange(3, 15))
        path = str(tmp_path / f"s{trial}.wal")
        standby = _bare_standby(path)
        while standby.size < len(stream):
            end = min(len(stream), standby.size + rng.randrange(1, 400))
            standby._on_batch(7, WalBatch(standby.size, stream[standby.size:end]))
        standby._fh.close()
        _same_state(standby.shadow, ref_journal.replay(ref_journal.scan(stream)[0]))
        with open(path, "rb") as fh:
            assert fh.read() == stream


def test_cursor_valid_answers_as_the_references(tmp_path):
    """On the same file: every record's true cursor, the empty cursor,
    and cursors off by a byte, a CRC or past the end."""
    rng = random.Random(11)
    path = str(tmp_path / "c.wal")
    stream = _record_stream(rng, n=8)
    with open(path, "wb") as fh:
        fh.write(stream)
    records, clean, _ = scan_with_cursor(stream)
    cursors = [(0, -1, 0)]
    off = 0
    while off < clean:
        end = off + 8 + int.from_bytes(stream[off:off + 4], "little")
        crc = int.from_bytes(stream[off + 4:off + 8], "little")
        cursors += [(end, off, crc), (end, off, crc ^ 1), (end + 1, off, crc),
                    (end, off + 1, crc), (end, end, crc)]
        off = end
    cursors += [(clean + 8, clean, 0), (5, -1, 0), (5, 7, 0)]
    for cur in cursors:
        assert cursor_valid(path, *cur) == ref_journal.cursor_valid(path, *cur), cur
    assert cursor_valid(str(tmp_path / "missing.wal"), 8, 0, 0) is False


# -- shipping ------------------------------------------------------------------

def test_shipping_builds_a_copy_and_shadow_equal_to_the_primarys(tmp_path):
    pwal, swal = str(tmp_path / "p.wal"), str(tmp_path / "s.wal")

    async def scenario():
        journal, _ = Journal.open(pwal)
        standby = await ReplicationStandby.create(swal, params=FAST)
        runner = asyncio.ensure_future(standby.run())
        prim = ReplicationPrimary(journal, "127.0.0.1", standby.port, params=FAST)
        prim.start()
        for jid in range(1, 40):
            journal.append("job", {"id": jid, "req": _req_obj(jid)})
        await journal.flush()
        await _until(lambda: prim.acked >= journal.size, 15, "shipping stalled")
        with open(pwal, "rb") as fh:
            primary = fh.read()
        _same_state(standby.shadow, ref_journal.replay(ref_journal.scan(primary)[0]))
        assert standby.size == len(primary) == journal.size
        with open(swal, "rb") as fh:
            assert fh.read() == primary
        assert prim.synced and prim.stats["resyncs"] == 0
        await prim.stop()
        await _drain(runner)
        await standby.close()
        await journal.aclose()

    run(scenario())


def test_a_restarted_standby_resumes_at_its_cursor(tmp_path):
    """The standby dies and restarts over its copy: the primary ships
    only the ten records it missed, with no resync."""
    pwal, swal = str(tmp_path / "p.wal"), str(tmp_path / "s.wal")

    async def scenario():
        journal, _ = Journal.open(pwal)
        standby = await ReplicationStandby.create(swal, params=FAST)
        runner = asyncio.ensure_future(standby.run())
        prim = ReplicationPrimary(journal, "127.0.0.1", standby.port, params=FAST)
        prim.start()
        for jid in range(1, 21):
            journal.append("job", {"id": jid, "req": _req_obj(jid)})
        await journal.flush()
        await _until(lambda: standby.size >= journal.size, 15, "shipping stalled")
        await prim.stop()
        await _drain(runner)
        await standby.close()
        standby2 = await ReplicationStandby.create(swal, params=FAST)
        from_file = standby2.stats["records_applied"]
        runner2 = asyncio.ensure_future(standby2.run())
        prim2 = ReplicationPrimary(journal, "127.0.0.1", standby2.port, params=FAST)
        prim2.start()
        for jid in range(21, 31):
            journal.append("job", {"id": jid, "req": _req_obj(jid)})
        await journal.flush()
        await _until(lambda: standby2.size >= journal.size, 15, "shipping stalled")
        assert prim2.stats["resyncs"] == 0
        assert standby2.stats["records_applied"] - from_file == 10
        with open(pwal, "rb") as fh:
            _same_state(standby2.shadow, ref_journal.replay(ref_journal.scan(fh.read())[0]))
        await prim2.stop()
        await _drain(runner2)
        await standby2.close()
        await journal.aclose()

    run(scenario())


def test_the_tick_flusher_writes_what_the_reference_replays(tmp_path):
    """Nothing reaches the file before ``flush_tick``; a durable batch
    fires its callback; the fallback timer covers appends with no tick;
    the ship hook sees each batch at its offset; and the reference's
    ``Journal.open`` replays the file as the port does."""
    path = str(tmp_path / "tick.wal")

    async def scenario():
        journal, _ = Journal.open(path)
        journal.tick_flush = True
        shipped = []
        journal.on_batch = lambda start, blob: shipped.append((start, len(blob)))
        start = journal.size
        journal.append("job", {"id": 1, "req": _req_obj(1)})
        assert journal._buffer and journal.size == start
        journal.flush_tick()
        assert not journal._buffer and shipped == [(start, journal.size - start)]
        fired = []
        journal.append("finish", {"id": 1, "ckey": "c", "cjid": 1, "mode": "min", "n": 3,
                                  "h": "ab", "found": True, "s": 4096},
                       on_durable=lambda: fired.append(journal.size))
        journal.flush_tick()
        await journal.flush()
        assert fired == [journal.size]
        journal.append("abandon", {"id": 1})
        await _until(lambda: not journal._buffer, 2.0, "the fallback timer never fired")
        assert [s for s, _ in shipped] == [start] + [s + n for s, n in shipped[:-1]]
        await journal.aclose()

    run(scenario(), 15)
    ref_j, ref_state = ref_journal.Journal.open(path)
    run(ref_j.aclose(), 5)
    assert ref_state.finished == {1} and ("c", 1) in ref_state.winners


def test_a_hook_that_raises_is_detached_and_the_wal_goes_on(tmp_path):
    journal, _ = Journal.open(str(tmp_path / "h.wal"))

    def boom(start, blob):
        raise RuntimeError("hook")

    journal.on_batch = boom
    journal.append("abandon", {"id": 1})  # no loop: written through
    assert journal.on_batch is None
    journal.append("abandon", {"id": 2})
    assert len(scan(open(journal.path, "rb").read())[0]) == 3
    run(journal.aclose(), 5)


def test_adopt_writes_a_durable_fencing_boot_and_rescans_nothing(tmp_path):
    path = str(tmp_path / "a.wal")
    with open(path, "wb") as fh:
        fh.write(_record_stream(random.Random(3), n=4) + b"\x01\x02")  # a torn tail too
    before = os.path.getsize(path)
    journal = Journal.adopt(path, 7 + FENCE_JUMP)
    assert journal.size == before + len(encode_record({"k": "boot", "epoch": 7 + FENCE_JUMP}))
    assert journal.boot_epoch == 7 + FENCE_JUMP and journal.stats["syncs"] == 1
    run(journal.aclose(), 5)
    assert os.path.getsize(path) == journal.size  # the torn tail stays: no rescan


# -- the replica-ack tier ---------------------------------------------------------

def test_replica_ack_gate_parks_until_acked(tmp_path):
    async def scenario():
        journal, _ = Journal.open(str(tmp_path / "p.wal"))
        prim = ReplicationPrimary(journal, "127.0.0.1", 1, params=FAST)
        fired = []
        gate_any([prim], 100, lambda: fired.append("now"))
        assert fired == ["now"]  # no synced session: released at once
        prim.synced, prim._shipped, prim.acked = True, 1000, 50
        gate_any([prim], 100, lambda: fired.append("later"))
        prim._on_ack(99)
        assert fired == ["now"]
        prim._on_ack(100)
        assert fired == ["now", "later"]
        gate_any([prim, prim], 500, lambda: fired.append("released"))  # one fire a gate
        prim._fire_gates("test teardown")
        assert fired == ["now", "later", "released"]
        await journal.aclose()

    run(scenario(), 10)


def test_replica_ack_gate_survives_a_compactions_space_change(tmp_path):
    """A gate placed after a compaction is not released by the old
    space's high water, a stale old-space ack is ignored, and a gate
    placed before re-bases to the end of the compacted file."""

    async def scenario():
        journal, state = Journal.open(str(tmp_path / "p.wal"), compact_bytes=512, fsync=False)
        journal.snapshot_provider = lambda: state.snapshot_obj()
        prim = ReplicationPrimary(journal, "127.0.0.1", 1, params=FAST)
        fired = []
        prim.synced, prim._shipped, prim.acked = True, journal.size, journal.size
        gate_any([prim], journal.size + 1, lambda: fired.append("pre"))
        state.apply({"k": "job", "id": 1, "req": _req_obj(1)})
        journal.append("job", {"id": 1, "req": _req_obj(1)})
        for i in range(40):
            rec = {"k": "settle", "id": 1, "lo": 100 * i, "hi": 100 * i + 49, "h": "ff",
                   "n": 100 * i, "s": 50}
            state.apply(rec)
            journal.append("settle", dict(rec))
            await asyncio.sleep(0)
        await journal.flush()
        assert journal.stats["compactions"] >= 1 and journal.generation >= 1
        with open(journal.path, "rb") as fh:
            assert journal.size == len(fh.read())
        gate_any([prim], journal.size, lambda: fired.append("post"))
        assert fired == []
        prim._switch_generation()
        prim._on_ack(10 ** 6)
        assert prim.acked == 0 and fired == []
        prim._shipped = journal.size
        prim._on_ack(journal.size)
        assert sorted(fired) == ["post", "pre"]
        await journal.aclose()

    run(scenario(), 10)


# -- failover ------------------------------------------------------------------

def test_a_restarted_old_primary_draws_reset_and_cannot_corrupt(tmp_path):
    """After the failover the old primary restarts on its own journal
    (epoch + 1) and tries to ship to the promoted standby: the hello is
    rejected, the lane's connection is lost to a reset, the lane and its
    coordinator are fenced, and the promoted state is untouched."""
    pwal, swal = str(tmp_path / "p.wal"), str(tmp_path / "s.wal")

    async def scenario():
        standby = await ReplicationStandby.create(swal, params=FAST)
        runner = asyncio.ensure_future(standby.run())
        coord = await Coordinator.create(params=FAST, recover_from=pwal,
                                         replicate_to=[("127.0.0.1", standby.port)])
        old_epoch = coord.boot_epoch
        serve = asyncio.ensure_future(coord.serve())
        coord._journal.append("job", {"id": 1, "req": _req_obj(1, ckey="ck")})
        await coord._journal.flush()
        await _until(lambda: standby.stats["records_applied"] >= 2, 15, "no shipping")
        await _drain(serve)
        coord.crash()
        await asyncio.wait_for(standby.primary_lost.wait(), LOSS_S)
        coord2 = await standby.promote()
        assert coord2.boot_epoch == old_epoch + FENCE_JUMP
        serve2 = asyncio.ensure_future(coord2.serve())
        jobs_before = set(coord2._jobs)
        assert jobs_before == {1}
        zombie = await Coordinator.create(params=FAST, recover_from=pwal,
                                          replicate_to=[("127.0.0.1", coord2.port)])
        assert zombie.boot_epoch == old_epoch + 1
        serve3 = asyncio.ensure_future(zombie.serve())
        lane = zombie._replicas[0]
        await _until(lambda: lane.fenced, 20, "the zombie was never fenced")
        reason = lane.last_loss_reason or ""
        assert "reset ack" in reason or "restarted" in reason
        assert zombie.fenced and zombie.stats_snapshot()["replication"][0]["fenced"]
        assert coord2.stats["replication_fenced"] >= 1
        assert set(coord2._jobs) == jobs_before
        await _drain(serve3, serve2, runner)
        zombie.crash()
        coord2.crash()

    run(scenario(), 40)


class _Slow(CudaMiner):
    """The CPU plain versions throttled so jobs are mid-flight at the kill."""

    def mine(self, request):
        for item in super().mine(request):
            time.sleep(0.004)
            yield item


def _brute(data, upper):
    return min((ref_chain.toy_hash(data, n), n) for n in range(upper + 1))


def test_failover_answers_bound_clients_exactly_once(tmp_path):
    """The primary machine dies mid-job (its journal is never read
    again) under a fleet of three port workers and two bound port
    clients given both addresses; the standby promotes and the fleet
    lands on it: each client gets one answer, equal to brute force."""
    pwal, swal, upper = str(tmp_path / "p.wal"), str(tmp_path / "s.wal"), 8191
    payloads = [b"failover-client-a", b"failover-client-b"]

    async def scenario():
        standby = await ReplicationStandby.create(swal, params=FAST)
        runner = asyncio.ensure_future(standby.run())
        coord = await Coordinator.create(params=FAST, chunk_size=512, recover_from=pwal,
                                         replicate_to=[("127.0.0.1", standby.port)],
                                         replica_ack=True)
        addrs = [("127.0.0.1", coord.port), ("127.0.0.1", standby.port)]
        serve = asyncio.ensure_future(coord.serve())
        miners = [asyncio.ensure_future(run_miner_reconnect(
            "", 0, _Slow(device="cpu", slab=256), params=FAST, addrs=addrs,
            base_backoff=0.05, max_backoff=0.4, rng=random.Random(100 + i)))
            for i in range(3)]
        await asyncio.sleep(0.2)
        subs = [asyncio.ensure_future(submit(
            "", 0, Request(70 + i, PowMode.MIN, 0, upper, data=payloads[i]), params=FAST,
            client_key=f"failover-client-{i}", reconnect=True, base_backoff=0.05,
            rng=random.Random(i), addrs=addrs)) for i in range(2)]
        serve2 = coord2 = None
        try:
            await _until(lambda: coord.stats["results_accepted"] >= 4, 20, "no progress")
            assert coord.stats["jobs_done"] == 0, "the kill must land mid-job"
            await _until(lambda: standby.stats["records_applied"] >= 4, 10, "shipping lagged")
            await _drain(serve)
            coord.crash()
            await asyncio.wait_for(standby.primary_lost.wait(), LOSS_S)
            coord2 = await standby.promote(chunk_size=512)
            assert len(coord2._jobs) == 2
            assert sum(j.hashes_done for j in coord2._jobs.values()) > 0
            serve2 = asyncio.ensure_future(coord2.serve())
            results = await asyncio.wait_for(asyncio.gather(*subs), 60)
            for i, res in enumerate(results):
                assert (res.hash_value, res.nonce) == _brute(payloads[i], upper) and res.found
            assert not coord2._jobs
        finally:
            await _drain(*miners, *subs, runner, *((serve2,) if serve2 else ()))
            if coord2 is not None:
                coord2.crash()

    run(scenario(), 90)


def test_parse_addr_list_is_the_params_one():
    from tpuminter_torch.lsp import params

    assert replication.parse_addr_list is params.parse_addr_list
    assert replication.dial_patience is params.dial_patience
    assert parse_addr_list("a:1,b:2") == [("a", 1), ("b", 2)]
    assert parse_addr_list(":9000") == [("127.0.0.1", 9000)]
    with pytest.raises(ValueError):
        parse_addr_list(",")


def test_quota_buckets_survive_the_promotion(tmp_path):
    """The ``quota`` record rides the stream like every append, so the
    promoted standby restores the tenant's balance instead of a fresh
    burst."""
    pwal, swal = str(tmp_path / "p.wal"), str(tmp_path / "s.wal")

    async def scenario():
        standby = await ReplicationStandby.create(swal, params=FAST)
        runner = asyncio.ensure_future(standby.run())
        coord = await Coordinator.create(params=FAST, chunk_size=512, recover_from=pwal,
                                         replicate_to=[("127.0.0.1", standby.port)],
                                         replica_ack=True, quota_rate=0.001, quota_burst=6)
        serve = asyncio.ensure_future(coord.serve())
        coord2 = client = None
        try:
            client = await LspClient.connect("127.0.0.1", coord.port, FAST)
            for jid in range(1, 5):
                client.write(encode_msg(Request(jid, PowMode.MIN, 0, 4095,
                                                data=b"failover-quota-%d" % jid,
                                                client_key="tenant-f")))
            await _until(lambda: len(coord._jobs) == 4, 10, "submissions lost")
            tok, _, strikes = coord._buckets["tenant-f"]
            assert tok == pytest.approx(2.0, abs=0.01)
            coord._journal_quota()

            def shipped():
                with open(swal, "rb") as fh:
                    return ref_journal.replay(ref_journal.scan(fh.read())[0]).quota

            await _until(shipped, 10, "the quota record never shipped")
            await _drain(serve)
            coord.crash()
            await asyncio.wait_for(standby.primary_lost.wait(), LOSS_S)
            coord2 = await standby.promote(quota_rate=0.001, quota_burst=6)
            tok2, _, strikes2 = coord2._buckets["tenant-f"]
            assert tok2 == pytest.approx(tok, abs=0.01) and strikes2 == strikes
        finally:
            if client is not None:
                await client.close(drain_timeout=0.1)
            await _drain(runner, serve)
            if coord2 is not None:
                coord2.crash()

    run(scenario(), 40)


def test_the_coordinator_takes_the_references_replication_flags(tmp_path):
    """``--replicate-to`` and ``--replica-ack`` are in the help with the
    reference's metavar; ``--replicate-to`` without ``--journal`` is
    the reference's parse error, and ``replicate_to`` without a journal
    the reference's ValueError."""
    import contextlib
    import io

    from tpuminter import coordinator as ref_coordinator
    from tpuminter_torch import coordinator as port_coordinator

    for main in (port_coordinator.main, ref_coordinator.main):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as exit_:
            main(["--help"])
        assert exit_.value.code == 0
        text = " ".join(out.getvalue().split())
        assert "--replicate-to LIST" in text and "--replica-ack" in text
        err = io.StringIO()
        with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as exit_:
            main(["0", "--replicate-to", "h:1"])
        assert exit_.value.code == 2 and "--replicate-to requires --journal" in err.getvalue()

    async def scenario():
        from tpuminter_torch.lsp import LspServer

        server = await LspServer.create(0, FAST)
        try:
            with pytest.raises(ValueError, match="replicate_to requires a journal"):
                Coordinator(server, replicate_to=[("127.0.0.1", 1)])
            coord = Coordinator(server, replica_ack=True)  # no lanes: the tier is off
            assert not coord._replica_ack and "replication" not in coord.stats_snapshot()
        finally:
            server.crash()

    run(scenario(), 10)
