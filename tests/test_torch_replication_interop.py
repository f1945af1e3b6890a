"""The port's replication against the reference's own, over the wire.

- *Codec*: the five replication messages encode byte for byte as the
  reference's in both codecs, on hypothesis-drawn fields, and decode
  back equal; a damaged binary ``WalBatch`` raises in both.
- *Interop, both ways*: a port primary ships to the reference's
  standby, and the reference's primary to the port's. Each standby's
  copy is byte-equal to the primary's file; each promotes, and a bound
  client's re-submission is answered from the promoted winner table
  with no miner.
- *A chain*: primary, a port standby with ``chain_to``, and a second
  port standby; the tail's copy is byte-equal to the primary's file.
- *The transport's fault-plan seam*: one seeded reference
  ``chaos.FaultPlan`` cuts the lane's link to the standby and then
  heals; the standby resumes at its cursor and applies no record twice.

LSP sessions at 50 ms epochs on ephemeral ports; the worker runs the
port's CPU plain versions.
"""

import asyncio
import dataclasses
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tpuminter import chaos as ref_chaos
from tpuminter import protocol as ref
from tpuminter import replication as ref_replication
from tpuminter.coordinator import Coordinator as RefCoordinator
from tpuminter.lsp import Params as RefParams
from tpuminter_torch import protocol as port
from tpuminter_torch.client import submit
from tpuminter_torch.coordinator import Coordinator
from tpuminter_torch.cuda_worker import CudaMiner
from tpuminter_torch.journal import Journal, scan
from tpuminter_torch.lsp import Params
from tpuminter_torch.replication import FENCE_JUMP, ReplicationPrimary, ReplicationStandby
from tpuminter_torch.worker import run_miner

_LSP = dict(epoch_limit=5, epoch_millis=50, window_size=32, max_backoff_interval=2,
            max_unacked_messages=32)
REF_FAST, FAST = RefParams(**_LSP), Params(**_LSP)
LOSS_S = 20 * FAST.epoch_limit * FAST.epoch_seconds

u64 = st.integers(0, (1 << 64) - 1)
KINDS = {
    "RepHello": st.builds(ref.RepHello, u64),
    "SyncFrom": st.builds(ref.SyncFrom, u64, st.integers(-1, (1 << 63) - 1),
                          st.integers(0, (1 << 32) - 1)),
    "WalStart": st.builds(ref.WalStart, u64),
    "WalBatch": st.builds(ref.WalBatch, u64, st.binary(max_size=300)),
    "SyncAck": st.builds(ref.SyncAck, u64),
}


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


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _req_obj(jid):
    return port.request_to_obj(port.Request(jid, port.PowMode.MIN, 0, 4095, data=b"i-%d" % jid))


# -- codec ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(KINDS))
@settings(max_examples=30, deadline=None)
@given(data=st.data())
def test_replication_messages_are_the_references_in_both_codecs(kind, data):
    msg = data.draw(KINDS[kind])
    mine = getattr(port, kind)(**dataclasses.asdict(msg))
    for binary in (False, True):
        raw = ref.encode_msg(msg, binary=binary)
        assert port.encode_msg(mine, binary=binary) == raw
        assert port.payload_is_binary(raw) == (binary and kind == "WalBatch")
        assert dataclasses.asdict(port.decode_msg(raw)) == dataclasses.asdict(msg)


def test_a_damaged_binary_walbatch_raises_in_both():
    raw = ref.encode_msg(ref.WalBatch(1 << 40, bytes(range(64))), binary=True)
    for bad in [raw[:n] for n in range(len(raw))] + [
            raw[:i] + bytes([raw[i] ^ 0x20]) + raw[i + 1:] for i in range(1, len(raw))]:
        with pytest.raises(ref.ProtocolError):
            ref.decode_msg(bad)
        with pytest.raises(port.ProtocolError):
            port.decode_msg(bad)


# -- interop, both ways ----------------------------------------------------------

@pytest.mark.parametrize("primary", ["port", "ref"])
def test_each_primary_ships_to_the_others_standby(tmp_path, primary):
    """A MIN job under a client key through the primary (a port worker
    mines it); the other implementation's standby holds a byte-equal
    copy, is promoted once the primary dies, and answers the client's
    re-submission from its winner table with no miner attached."""
    pwal, swal = str(tmp_path / "p.wal"), str(tmp_path / "s.wal")
    Coord, Standby, params = ((Coordinator, ref_replication.ReplicationStandby, FAST)
                              if primary == "port" else
                              (RefCoordinator, ReplicationStandby, REF_FAST))
    promoted_params = REF_FAST if primary == "port" else FAST
    req = port.Request(5, port.PowMode.MIN, 0, 4095, data=b"interop-" + primary.encode())

    async def scenario():
        standby = await Standby.create(swal, params=promoted_params)
        runner = asyncio.ensure_future(standby.run())
        coord = await Coord.create(params=params, chunk_size=1024, recover_from=pwal,
                                   replicate_to=[("127.0.0.1", standby.port)], replica_ack=True)
        serve = asyncio.ensure_future(coord.serve())
        worker = asyncio.ensure_future(run_miner("127.0.0.1", coord.port,
                                                 CudaMiner(device="cpu"), params=FAST))
        serve2 = coord2 = None
        try:
            first = await asyncio.wait_for(submit("127.0.0.1", coord.port, req, params=FAST,
                                                  client_key="interop-key"), 20)
            await _until(lambda: standby.size >= coord._journal.size
                         and coord._journal.size == len(_read(pwal)), 10, "shipping lagged")
            assert _read(swal) == _read(pwal)
            assert coord.stats_snapshot()["replication"][0]["acked"] == coord._journal.size
            await _drain(worker, serve)
            coord.crash()
            await asyncio.wait_for(standby.primary_lost.wait(), LOSS_S)
            coord2 = await standby.promote()
            assert coord2.boot_epoch == coord.boot_epoch + FENCE_JUMP
            serve2 = asyncio.ensure_future(coord2.serve())
            again = await asyncio.wait_for(submit("127.0.0.1", standby.port, req, params=FAST,
                                                  client_key="interop-key"), 10)
            assert (again.nonce, again.hash_value, again.found, again.searched) == (
                first.nonce, first.hash_value, first.found, first.searched)
            assert not coord2._miners and coord2.stats["jobs_done"] == 0 and not coord2._jobs
        finally:
            await _drain(worker, serve, runner, *((serve2,) if serve2 else ()))
            coord.crash()
            if coord2 is not None:
                coord2.crash()

    run(scenario(), 40)


def test_a_two_hop_chain_ships_a_byte_equal_tail(tmp_path):
    pwal = str(tmp_path / "p.wal")
    mid_wal, tail_wal = str(tmp_path / "mid.wal"), str(tmp_path / "tail.wal")

    async def scenario():
        journal, _ = Journal.open(pwal)
        tail = await ReplicationStandby.create(tail_wal, params=FAST)
        mid = await ReplicationStandby.create(mid_wal, params=FAST,
                                              chain_to=[("127.0.0.1", tail.port)])
        runners = [asyncio.ensure_future(s.run()) for s in (tail, mid)]
        prim = ReplicationPrimary(journal, "127.0.0.1", mid.port, params=FAST)
        prim.start()
        for jid in range(1, 31):
            journal.append("job", {"id": jid, "req": _req_obj(jid)})
            if jid % 10 == 0:
                await journal.flush()
                await asyncio.sleep(0.02)
        await journal.flush()
        await _until(lambda: tail.size >= journal.size, 15, "the chain stalled")
        assert _read(tail_wal) == _read(mid_wal) == _read(pwal)
        assert tail.stats["records_applied"] == len(scan(_read(pwal))[0])
        assert prim.stats["sessions"] == 1  # the primary feeds one stream
        await prim.stop()
        await _drain(*runners)
        await mid.close()
        await tail.close()
        await journal.aclose()

    run(scenario())


def test_a_healed_partition_resumes_at_the_cursor(tmp_path):
    """A seeded reference ``FaultPlan`` on the lane's endpoint blacks out
    its link to the standby 0.3 s after the session starts; records
    appended meanwhile wait; the standby loses its primary; once healed,
    the lane redials and the standby resumes at its cursor: no resync,
    no record applied twice, a byte-equal copy."""
    pwal, swal = str(tmp_path / "p.wal"), str(tmp_path / "s.wal")

    async def scenario():
        journal, _ = Journal.open(pwal)
        standby = await ReplicationStandby.create(swal, params=FAST)
        runner = asyncio.ensure_future(standby.run())
        plan = ref_chaos.FaultPlan(seed=16).partition(("127.0.0.1", standby.port), start=0.3)
        prim = ReplicationPrimary(journal, "127.0.0.1", standby.port, params=FAST)
        prim.fault_plan = plan
        prim.start()
        for jid in range(1, 11):
            journal.append("job", {"id": jid, "req": _req_obj(jid)})
        await journal.flush()
        await _until(lambda: standby.size >= journal.size, 5, "no shipping before the cut")
        await _until(lambda: plan.elapsed() > 0.3, 5, "the plan never armed")
        for jid in range(11, 21):
            journal.append("job", {"id": jid, "req": _req_obj(jid)})
        await journal.flush()
        await asyncio.wait_for(standby.primary_lost.wait(), LOSS_S)
        assert standby.size < journal.size and plan.stats["partitioned"] > 0
        plan.heal()
        await _until(lambda: standby.size >= journal.size, 15, "no resume after the heal")
        assert _read(swal) == _read(pwal)
        assert standby.stats["records_applied"] == len(scan(_read(pwal))[0])
        assert standby.stats["resyncs"] == prim.stats["resyncs"] == 0
        assert prim.stats["sessions"] >= 2
        await prim.stop()
        await _drain(runner)
        await standby.close()
        await journal.aclose()

    run(scenario())
