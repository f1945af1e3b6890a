"""The port's journal held to the reference's, record for record.

- the record codec (``encode_record``, ``encode_settle``,
  ``frame_payload``) writes the reference's bytes on hypothesis-drawn
  records, and ``scan`` reads torn and corrupted tails as it does;
- ``replay`` rebuilds an equal ``RecoveredState`` on every sequence in
  which each job's record comes before its settles (what a coordinator
  writes), idempotently; the orphan-settle sequence, which replays
  non-idempotently in the reference, replays the same here;
- the journal scenarios of ``tests/test_recovery.py`` (interval helpers,
  torn tails, compaction, reopen, crash, a failed disk);
- ``_trim_winners`` never evicts an unacknowledged winner and leaves the
  reference's table.
"""

import asyncio
import random
import time
from collections import OrderedDict

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tpuminter import journal as ref_journal
from tpuminter import protocol as ref_protocol
from tpuminter.coordinator import Coordinator as RefCoordinator
from tpuminter.coordinator import _Winner as RefWinner
from tpuminter.workloads import hashcore as ref_hc
from tpuminter_torch import journal
from tpuminter_torch.coordinator import Coordinator, _Winner
from tpuminter_torch.protocol import PowMode, Request, Result, request_to_obj

u64 = st.integers(0, (1 << 64) - 1)


def _request(jid, upper, ckey, workload):
    if workload:
        return Request(jid, PowMode.MIN, 0, upper, data=ref_hc.pack_params("fsum", 5),
                       client_key=ckey, workload="hashcore")
    return Request(jid, PowMode.MIN, 0, upper, data=b"x", client_key=ckey)


requests = st.builds(_request, st.integers(1, 9), st.integers(1, 999),
                     st.sampled_from(["", "c"]), st.booleans())
job_recs = st.builds(lambda i, req: {"k": "job", "id": i, "req": request_to_obj(req)},
                     st.integers(1, 4), requests)
settle_recs = st.builds(
    lambda i, lo, size, h, s: {"k": "settle", "id": i, "lo": lo, "hi": lo + size,
                               "h": f"{h:x}", "n": lo, "s": s},
    st.integers(1, 4), st.integers(0, 900), st.integers(0, 200), u64, st.integers(1, 500))
work_settle_recs = st.builds(
    lambda i, lo, size: {"k": "settle", "id": i, "lo": lo, "hi": lo + size, "s": size + 1,
                         "wp": ref_hc.folds.FSum().encode([7 * (size + 1), size + 1]).hex()},
    st.integers(1, 4), st.integers(0, 900), st.integers(0, 200))
finish_recs = st.builds(
    lambda i: {"k": "finish", "id": i, "ckey": "c", "cjid": i, "mode": "min", "n": 1,
               "h": "aa", "found": True, "s": 9, "ts": 1.5},
    st.integers(1, 4))
other_recs = st.one_of(
    st.builds(lambda e: {"k": "boot", "epoch": e}, st.integers(1, 50)),
    st.builds(lambda i: {"k": "abandon", "id": i}, st.integers(1, 4)),
    st.builds(lambda i, lo: {"k": "requeue", "id": i, "lo": lo, "hi": lo + 9},
              st.integers(1, 4), st.integers(0, 99)),
    st.builds(lambda ck, tok: {"k": "quota", "buckets": [[ck, tok, 1]]},
              st.sampled_from(["a", "b"]), st.floats(0, 8)),
)
any_recs = st.lists(st.one_of(job_recs, settle_recs, work_settle_recs, finish_recs,
                              other_recs), min_size=1, max_size=14)


def _ordered(records):
    """Drop each settle that comes before its job's record: the sequences
    a coordinator writes."""
    seen, out = set(), []
    for rec in records:
        if rec["k"] == "job":
            seen.add(rec["id"])
        elif rec["k"] == "settle" and rec["id"] not in seen:
            continue
        out.append(rec)
    return out


def _key(state):
    """A comparable view of either implementation's RecoveredState."""
    return (
        state.boot_epoch, state.next_job_id, state.records, sorted(state.finished),
        {j: (job.job_id, tuple(job.remaining), job.best, job.hashes_done, job.wstate,
             request_to_obj(job.request) if isinstance(job.request, Request)
             else ref_protocol.request_to_obj(job.request))
         for j, job in state.jobs.items()},
        list(state.winners.items()), state.leases, state.quota,
    )


def _idem_key(state):
    k = _key(state)
    return k[:2] + k[4:]  # a second pass counts its records, and re-finishes


# -- the record codec ----------------------------------------------------------

@settings(max_examples=40, deadline=None)
@given(any_recs, st.lists(st.tuples(u64, u64, u64, u64, u64, st.integers(0, (1 << 256) - 1)),
                          max_size=3))
def test_record_codec_writes_the_references_bytes(records, settles):
    for rec in records:
        assert journal.encode_record(rec) == ref_journal.encode_record(rec)
        raw = ref_journal.encode_record(rec)[8:]
        assert journal.frame_payload(raw) == ref_journal.frame_payload(raw)
    for fields in settles:
        packed = journal.encode_settle(*fields)
        assert packed == ref_journal.encode_settle(*fields)
        assert journal.decode_settle(packed) == ref_journal.decode_settle(packed)


@settings(max_examples=40, deadline=None)
@given(any_recs, st.data())
def test_scan_reads_torn_and_corrupted_tails_as_the_reference(records, data):
    blob = bytearray(b"".join(journal.encode_record(r) for r in records))
    blob += journal.frame_payload(journal.encode_settle(1, 2, 3, 4, 5, 6))
    keep = data.draw(st.integers(0, len(blob) - 1))
    assert journal.scan(bytes(blob[:keep])) == ref_journal.scan(bytes(blob[:keep]))
    i = data.draw(st.integers(0, len(blob) - 1))
    blob[i] ^= data.draw(st.integers(1, 255))
    got = journal.scan(bytes(blob))
    assert got == ref_journal.scan(bytes(blob))
    assert len(got[0]) <= len(records)


# -- replay ------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(any_recs)
def test_replay_equals_the_reference_and_is_idempotent(records):
    records = _ordered(records)
    mine = journal.replay(records)
    assert _key(mine) == _key(ref_journal.replay(records))
    assert _idem_key(journal.replay(records + records)) == _idem_key(mine)
    snap = [{"k": "boot", "epoch": mine.boot_epoch}, mine.snapshot_obj()]
    assert journal.encode_record(snap[1]) == ref_journal.encode_record(
        ref_journal.replay(records).snapshot_obj())
    assert _idem_key(journal.replay(snap)) == _idem_key(mine)


def test_orphan_settle_replays_as_the_reference_does():
    """The falsifying sequence of the reference's double-replay property
    (``tests/test_properties.py``): a settle before its job's record.
    No coordinator writes it; both implementations replay it alike,
    non-idempotently."""
    req = request_to_obj(Request(1, PowMode.MIN, 0, 99, data=b"x"))
    records = [{"k": "settle", "id": 1, "lo": 0, "hi": 9, "h": "5", "n": 3, "s": 10},
               {"k": "job", "id": 1, "req": req}]
    for recs in (records, records + records):
        assert _key(journal.replay(recs)) == _key(ref_journal.replay(recs))
    assert journal.replay(records).jobs[1].remaining == [(0, 99)]
    assert journal.replay(records + records).jobs[1].remaining == [(10, 99)]


@pytest.mark.parametrize("fold", ["fmin", "fsum"])
def test_fold_states_merge_as_the_references(fold):
    """Disjoint coverage combines; an overlap on the non-idempotent sum
    keeps the state with the larger coverage."""
    from tpuminter import workloads as ref_wl
    from tpuminter_torch import workloads as wl

    req = Request(1, PowMode.MIN, 0, 99, data=ref_hc.pack_params(fold, 3), workload="hashcore")
    mine, theirs = wl.fold_of(req), ref_wl.fold_of(ref_protocol.decode_msg(
        ref_protocol.encode_msg(ref_protocol.Request(
            1, ref_protocol.PowMode.MIN, 0, 99, data=req.data, workload="hashcore"))))
    accs = {"fmin": ([5, 1], [3, 40]), "fsum": ([10, 10], [7, 5])}[fold]
    for spans in (([0, 9], [40, 44]), ([0, 9], [5, 14])):
        states = []
        for impl, f in ((wl, mine), (ref_wl, theirs)):
            a, b = impl.new_state(f), impl.new_state(f)
            impl.absorb(f, a, *spans[0], accs[0])
            impl.absorb(f, b, *spans[1], accs[1])
            states.append((impl.merge_states(f, a, b), impl.merge_states(f, None, b),
                           impl.covered_span(a)))
        assert states[0] == states[1]


def test_subtract_and_merge_ranges():
    assert journal.subtract_range([(0, 9)], 3, 5) == ([(0, 2), (6, 9)], 3)
    assert journal.subtract_range([(0, 9)], 0, 9) == ([], 10)
    assert journal.subtract_range([(0, 2), (6, 9)], 3, 5) == ([(0, 2), (6, 9)], 0)
    assert journal.merge_ranges([(5, 9), (0, 4), (20, 25)]) == [(0, 9), (20, 25)]
    assert journal.intersect_ranges([(0, 9), (20, 29)], [(5, 24)]) == [(5, 9), (20, 24)]
    rng = random.Random(7)
    for _ in range(100):
        ranges = journal.merge_ranges([(a, a + rng.randrange(30))
                                       for a in rng.sample(range(200), 4)])
        lo = rng.randrange(220)
        hi = lo + rng.randrange(40)
        assert journal.subtract_range(ranges, lo, hi) == ref_journal.subtract_range(
            ranges, lo, hi)


def test_settle_replay_rebuilds_remaining_ranges_and_fold():
    req = request_to_obj(Request(9, PowMode.MIN, 0, 999, data=b"x", client_key="k"))
    records = [{"k": "boot", "epoch": 1}, {"k": "job", "id": 1, "req": req},
               {"k": "settle", "id": 1, "lo": 0, "hi": 99, "h": "50", "n": 42, "s": 100},
               {"k": "settle", "id": 1, "lo": 300, "hi": 999, "h": "20", "n": 400, "s": 700}]
    job = journal.replay(records).jobs[1]
    assert (job.remaining, job.best, job.hashes_done) == ([(100, 299)], (0x20, 400), 800)
    records.append({"k": "finish", "id": 1, "ckey": "k", "cjid": 9, "mode": "min",
                    "n": 400, "h": "20", "found": True, "s": 1000})
    state = journal.replay(records)
    assert not state.jobs and state.winners[("k", 9)]["n"] == 400


# -- the journal at run time ---------------------------------------------------

@pytest.mark.parametrize("tick", [False, True], ids=["task", "tick"])
def test_reopen_replays_appends_and_repairs_a_torn_tail(tmp_path, tick):
    path = str(tmp_path / "j.wal")

    async def session():
        wal, state = journal.Journal.open(path)
        wal.tick_flush = tick
        assert state.boot_epoch == 1
        req = Request(5, PowMode.MIN, 0, 100, data=b"x", client_key="me")
        wal.append("job", {"id": 1, "req": request_to_obj(req)})
        wal.append_encoded(journal.encode_settle(1, 0, 49, 3, 50, 0xAA))
        fired = []
        wal.append("finish", {"id": 2, "ckey": "me", "cjid": 6, "mode": "min", "n": 1,
                              "h": "bb", "found": True, "s": 10},
                   on_durable=lambda: fired.append(1))
        await wal.flush()
        assert fired == [1] and wal.stats["syncs"] >= 2
        await wal.aclose()

    asyncio.run(session())
    _, state = ref_journal.Journal.open(path)  # the reference reads it
    assert state.boot_epoch == 2 and state.jobs[1].remaining == [(50, 100)]
    with open(path, "ab") as fh:
        fh.write(b"\xde\xad\xbe\xef-torn-write")
    _, state = journal.Journal.open(path)
    assert state.boot_epoch == 3 and state.winners[("me", 6)]["found"] is True
    with open(path, "rb") as fh:
        data = fh.read()
    records, clean = journal.scan(data)
    assert clean == len(data) and records[-1] == {"k": "boot", "epoch": 3}


def test_crash_loses_at_most_the_unflushed_tail(tmp_path):
    path = str(tmp_path / "j.wal")

    async def scenario():
        wal, _ = journal.Journal.open(path)
        req = Request(1, PowMode.MIN, 0, 10, data=b"x")
        wal.append("job", {"id": 1, "req": request_to_obj(req)})
        await wal.flush()
        wal.append("abandon", {"id": 1})  # buffered, never flushed
        wal.crash()

    asyncio.run(scenario())
    assert 1 in journal.Journal.open(path)[1].jobs


def test_disk_failure_fails_loudly_but_never_wedges_replies(tmp_path, monkeypatch):
    path = str(tmp_path / "j.wal")

    async def scenario():
        wal, _ = journal.Journal.open(path)

        def boom(blob, need_sync):
            raise OSError(28, "No space left on device")

        monkeypatch.setattr(wal, "_write_sync", boom)
        fired = []
        rec = {"id": 1, "ckey": "", "cjid": 1, "mode": "min", "n": 0, "h": "0",
               "found": True, "s": 1}
        wal.append("finish", rec, on_durable=lambda: fired.append("first"))
        await wal.flush()
        assert fired == ["first"] and wal._failed
        wal.append("finish", dict(rec, id=2), on_durable=lambda: fired.append("second"))
        assert fired == ["first", "second"]
        await wal.aclose()

    asyncio.run(scenario())


def test_compaction_preserves_state(tmp_path):
    path = str(tmp_path / "j.wal")

    async def scenario():
        wal, state = journal.Journal.open(path, compact_bytes=512)
        wal.snapshot_provider = state.snapshot_obj
        req = request_to_obj(Request(2, PowMode.MIN, 0, 9999, data=b"x", client_key="cc"))
        state.apply({"k": "job", "id": 1, "req": req})
        wal.append("job", {"id": 1, "req": req})
        for i in range(40):
            rec = {"k": "settle", "id": 1, "lo": 100 * i, "hi": 100 * i + 49, "h": "ff",
                   "n": 100 * i, "s": 50}
            state.apply(rec)
            wal.append("settle", dict(rec))
            await asyncio.sleep(0)
        await wal.flush()
        assert wal.stats["compactions"] >= 1
        await wal.aclose()
        return state

    state = asyncio.run(scenario())
    for impl in (journal, ref_journal):
        job = impl.Journal.open(path)[1].jobs[1]
        assert (job.remaining, job.hashes_done) == (state.jobs[1].remaining,
                                                   state.jobs[1].hashes_done)


# -- the exactly-once winner table ---------------------------------------------

@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.booleans(), st.booleans()), max_size=20), st.integers(1, 12))
def test_trim_winners_never_evicts_unacked_and_equals_the_reference(entries, cap):
    now = time.time()
    mine = Coordinator(None, winners_cap=cap)
    ref = RefCoordinator(None, winners_cap=cap)
    for i, (durable, waiter) in enumerate(entries):
        res = Result(1, PowMode.MIN, 1, 1)
        mine._winners[("ck", i)] = _Winner(res, durable, [7] if waiter else [], now)
        ref._winners[("ck", i)] = RefWinner(
            ref_protocol.Result(1, ref_protocol.PowMode.MIN, 1, 1), durable,
            [7] if waiter else [], now)
    unacked = {k for k, w in mine._winners.items() if not w.durable or w.waiters}
    mine._trim_winners()
    ref._trim_winners()
    assert unacked <= set(mine._winners)
    assert list(mine._winners) == list(ref._winners)
    assert mine.stats["winners_evicted"] == ref.stats["winners_evicted"]
    assert isinstance(mine._winners, OrderedDict)
