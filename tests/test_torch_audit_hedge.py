"""The port's audits and hedging held to the reference's.

- *Sentinel audits*: a peer answering every TARGET chunk with the fast
  path's ``MIN_UNTRACKED`` sentinel leaves every audit inconclusive
  after ``MAX_AUDIT_RETRIES`` re-dispatches; a MIN peer's audits all
  conclude. Both coordinators end with the same counters (the wire
  trace of ``tests/test_torch_coordinator.py``, which also holds the
  audit dispatches equal byte for byte).
- *A lazy worker* (``tests/test_e2e.py``'s): a scripted peer that mines
  half of each MIN chunk and claims its minimum, beside an honest
  ``CudaMiner(device="cpu")`` worker, is convicted by a full-chunk audit
  and evicted, its chunk requeued, and the Result equals brute force.
- *Hedging* (``tests/test_e2e.py``'s): a peer that takes a chunk and
  never answers is hedged onto the idle honest worker, whose Result
  wins; the staller gets the ``Cancel``. Without ``hedge_after`` no
  work is duplicated: ``searched`` is the range's size.

LSP sessions at 40 ms epochs on ephemeral ports; every await is bounded.
"""

import asyncio
import struct

import pytest

from tests.test_torch_coordinator import TRACES, _trace, brute_min
from tpuminter_torch import chain
from tpuminter_torch import coordinator as port_coordinator
from tpuminter_torch import protocol as port
from tpuminter_torch.client import submit
from tpuminter_torch.coordinator import MAX_AUDIT_RETRIES, Coordinator
from tpuminter_torch.cuda_worker import CudaMiner
from tpuminter_torch.lsp import LspClient, Params
from tpuminter_torch.lsp.client import LspConnectionLost
from tpuminter_torch.worker import run_miner

FAST = Params(epoch_limit=5, epoch_millis=40, window_size=32, max_backoff_interval=2,
              max_unacked_messages=32)


def run(coro, timeout=30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.mark.parametrize("case, concluded", [("target-audit", False), ("min-audit", True)])
def test_audit_counters_equal_the_references(case, concluded):
    join, request, kwargs = TRACES[case]
    want, got = {}, {}
    run(_trace("ref", join, request, kwargs, want))
    run(_trace("port", join, request, kwargs, got))
    assert got == want
    chunks = got["results_accepted"]
    if concluded:
        assert (got["audits_done"], got["audits_inconclusive"]) == (chunks, 0)
    else:
        # every chunk's audit: one dispatch and MAX_AUDIT_RETRIES retries,
        # each answered with the sentinel, then inconclusive
        assert (got["audits_done"], got["audits_inconclusive"]) == (0, chunks)
    assert got["audits_failed"] == 0


async def _scripted_peer(coord, backend, answer):
    """A Join, then ``answer(template, lo, hi)`` → the Result to send (or
    None to stay silent) for every dispatch; returns (the task, every
    message read)."""
    peer = await LspClient.connect("127.0.0.1", coord.port, FAST)
    peer.write(port.encode_msg(port.Join(backend=backend, lanes=1)))
    seen = []

    async def act():
        templates = {}
        try:
            while True:
                msg = port.decode_msg(await peer.read())
                seen.append(msg)
                if isinstance(msg, port.Setup):
                    templates[msg.request.job_id] = msg.request
                elif isinstance(msg, port.Assign):
                    out = answer(templates[msg.job_id], msg.lower, msg.upper)
                    if out is not None:
                        peer.write(port.encode_msg(
                            port.Result(msg.job_id, out[0], out[1], out[2], found=True,
                                        searched=msg.upper - msg.lower + 1,
                                        chunk_id=msg.chunk_id)))
        except LspConnectionLost:
            pass  # evicted

    return asyncio.ensure_future(act()), seen


#: every 1024-nonce chunk of [0, 8191] has its minimum in its upper half
LAZY_DATA = b"lazy 113"


def test_lazy_worker_is_convicted_and_the_result_equals_brute_force(monkeypatch):
    # full-chunk audits make the conviction certain
    monkeypatch.setattr(port_coordinator, "AUDIT_SAMPLE", 1024)
    for lo in range(0, 8192, 1024):
        assert brute_min(LAZY_DATA, lo, lo + 1023)[1] >= lo + 512, lo

    def lazy(tmpl, lo, hi):
        h, n = brute_min(tmpl.data, lo, (lo + hi) // 2)  # half the chunk, claimed whole
        return tmpl.mode, n, h

    async def scenario():
        coord = await Coordinator.create(params=FAST, chunk_size=1024, audit_rate=1.0,
                                         audit_seed=5)
        serve = asyncio.ensure_future(coord.serve())
        lazy_task, _seen = await _scripted_peer(coord, "lazy", lazy)
        await asyncio.sleep(0.05)
        honest = asyncio.ensure_future(run_miner(
            "127.0.0.1", coord.port, CudaMiner(device="cpu", slab=256), params=FAST))
        try:
            await asyncio.sleep(0.05)
            req = port.Request(3, port.PowMode.MIN, 0, 8191, data=LAZY_DATA)
            result = await asyncio.wait_for(submit("127.0.0.1", coord.port, req, params=FAST),
                                            20)
            assert (result.hash_value, result.nonce) == brute_min(LAZY_DATA, 0, 8191)
            assert coord.stats["audits_failed"] >= 1 and coord.stats["audits_done"] >= 1
            assert coord.stats["chunks_requeued"] >= 1
            assert all(s["backend"] != "lazy" for s in coord.worker_stats().values())
        finally:
            for t in (lazy_task, honest, serve):
                t.cancel()
            await asyncio.gather(lazy_task, honest, serve, return_exceptions=True)
            coord.crash()

    run(scenario())


def test_hedged_straggler_loses_to_the_backup_and_is_cancelled():
    async def scenario():
        # a silent peer joins first, so it takes the first of two chunks
        coord = await Coordinator.create(params=FAST, chunk_size=3000, hedge_after=0.3)
        serve = asyncio.ensure_future(coord.serve())
        stall_task, seen = await _scripted_peer(coord, "stall", lambda tmpl, lo, hi: None)
        await asyncio.sleep(0.05)
        honest = asyncio.ensure_future(run_miner(
            "127.0.0.1", coord.port, CudaMiner(device="cpu", slab=1024), params=FAST))
        tasks = [stall_task, honest, serve]
        try:
            await asyncio.sleep(0.05)
            req = port.Request(1, port.PowMode.MIN, 0, 5999, data=b"hedge me")
            result = await asyncio.wait_for(submit("127.0.0.1", coord.port, req, params=FAST),
                                            20)
            assert (result.hash_value, result.nonce) == brute_min(b"hedge me", 0, 5999)
            assert coord.stats["chunks_hedged"] >= 1
            await asyncio.sleep(0.1)
            kinds = [type(m).__name__ for m in seen]
            assert kinds[:2] == ["Setup", "Assign"] and "Cancel" in kinds
            assert [m.job_id for m in seen if isinstance(m, port.Cancel)] == [seen[1].job_id]
        finally:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            coord.crash()

    run(scenario())


def test_searched_equals_the_range_without_hedging():
    async def scenario():
        coord = await Coordinator.create(params=FAST, chunk_size=1024)
        serve = asyncio.ensure_future(coord.serve())
        workers = [asyncio.ensure_future(run_miner(
            "127.0.0.1", coord.port, CudaMiner(device="cpu", slab=1024), params=FAST))
            for _ in range(2)]
        try:
            await asyncio.sleep(0.05)
            req = port.Request(1, port.PowMode.MIN, 0, 20_000, data=b"no hedge")
            result = await asyncio.wait_for(submit("127.0.0.1", coord.port, req, params=FAST),
                                            20)
            assert (result.hash_value, result.nonce) == brute_min(b"no hedge", 0, 20_000)
            assert result.searched == coord.stats["hashes"] == 20_001
            assert coord.stats["chunks_hedged"] == 0
        finally:
            for t in workers + [serve]:
                t.cancel()
            await asyncio.gather(*workers, serve, return_exceptions=True)
            coord.crash()

    run(scenario())


def test_audit_on_a_lost_miner_returns_to_the_queue():
    """An audit in flight on a miner that dies goes back to the audit
    queue (the reference's ``_release_chunk``) and out again, to the
    one miner left (a one-worker fleet audits itself); the job waits
    for it."""
    coord = Coordinator(_NullServer(), audit_rate=1.0, audit_seed=1)
    coord._on_join(1, port.Join(backend="a", lanes=1))
    coord._on_join(2, port.Join(backend="b", lanes=1))
    coord._on_request(9, port.Request(1, port.PowMode.MIN, 0, 99, data=b"q"))
    job = next(iter(coord._jobs.values()))
    (cid, entry), = [(c, e) for c, e in coord._miners[1].chunks.items()]
    h, n = brute_min(b"q", entry[1], entry[2])
    coord._on_result(1, port.Result(job.job_id, port.PowMode.MIN, n, h, True,
                                    searched=entry[2] - entry[1] + 1, chunk_id=cid))
    audits = dict(coord._audits)
    assert len(audits) == 1 and job.pending_audits == 1
    auditor = next(m for m in coord._miners.values()
                   if any(c in audits for c in m.chunks))
    assert auditor.conn_id == 2  # never the suspect
    coord._on_lost(2)
    (audit,) = audits.values()
    assert list(coord._audits.values()) == [audit] and not coord._audit_queue
    assert set(coord._audits) <= set(coord._miners[1].chunks)
    assert job.pending_audits == 1 and not job.exhausted
    assert chain.toy_hash(b"q", n) == h and MAX_AUDIT_RETRIES == 2


def _retire_with_audits(impl):
    """Two miners, four TARGET chunks of 50 nonces; both sentinel-answer
    their first chunk, so each holds a chunk and an audit of the job
    when miner 1's second chunk wins. Returns the coordinator."""
    from tpuminter import chain as ref_chain
    from tpuminter import protocol as ref
    from tpuminter.coordinator import Coordinator as RefCoordinator

    msgs, Coord, ch = ((ref, RefCoordinator, ref_chain) if impl == "ref"
                       else (port, Coordinator, chain))
    coord = Coord(_NullServer(), chunk_size=50, audit_rate=1.0, audit_seed=3)
    for conn in (1, 2):
        coord._on_join(conn, msgs.Join(backend="x", lanes=1))
    header = ch.GENESIS_HEADER.pack()
    coord._on_request(9, msgs.Request(1, msgs.PowMode.TARGET, 0, 199, header=header,
                                      target=(1 << 256) - 1))
    (job,) = coord._jobs.values()
    for conn in (1, 2):
        cid, (_j, lo, hi, _at) = next(iter(coord._miners[conn].chunks.items()))
        coord._on_result(conn, msgs.Result(job.job_id, msgs.PowMode.TARGET, lo,
                                           msgs.MIN_UNTRACKED, False, searched=hi - lo + 1,
                                           chunk_id=cid))
    assert all(len(m.chunks) == 2 for m in coord._miners.values()) and len(coord._audits) == 2
    cid, (_j, lo, _hi, _at) = next((c, e) for c, e in coord._miners[1].chunks.items()
                                   if c not in coord._audits)
    h = ch.hash_to_int(ch.dsha256(header[:76] + struct.pack("<I", lo)))
    coord._on_result(1, msgs.Result(job.job_id, msgs.PowMode.TARGET, lo, h, True, searched=1,
                                    chunk_id=cid))
    assert not coord._jobs
    return coord


def test_a_cancelled_miners_audit_of_the_retired_job_leaves_its_books():
    """The job-scoped Cancel a finished job sends makes a worker abandon
    an audit of that job too, answering nothing. The port takes that
    audit off the miner's books, so the miner keeps its pipeline room
    and stays a hedge backup; the reference keeps it booked for good."""
    ref_coord = _retire_with_audits("ref")
    assert ref_coord._miners[2].busy and len(ref_coord._audits) == 2
    coord = _retire_with_audits("port")
    assert not coord._miners[2].busy and 2 in coord._idle
    assert list(coord._audits) == list(coord._miners[1].chunks)  # not cancelled: answers


class _NullServer:
    def write(self, conn_id, data):
        pass
