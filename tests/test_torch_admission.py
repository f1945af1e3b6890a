"""The port's admission control held to the reference's.

- *Quota across compaction*: a reference journal's ``quota`` records
  are recovered by the port, which compacts; the reference recovers the
  same balances from the compacted file, and the port's own balances
  survive the same round trip.
- *Scripted admission*: the same ``Request``s, clock steps and table
  events drive both coordinators on stub servers under one fake clock;
  every byte they write (``Refuse{retry_after_ms}`` and the rest), the
  jobs they mint, shed and park, the park queue's drain order and every
  counter must be equal. The park-queue cases mirror
  ``tests/test_fabric.py``'s.
- *Bounds*: tier multipliers, strike escalation, the bucket cap, the
  winner table's age bound and the UNBOUND reaper, each against the
  reference under the fake clock.
"""

import asyncio

import pytest

from tpuminter import protocol as ref
from tpuminter.coordinator import Coordinator as RefCoordinator
from tpuminter.journal import encode_record as ref_encode_record
from tpuminter.journal import replay as ref_replay
from tpuminter.journal import scan_file as ref_scan_file
from tpuminter.lsp import Params as RefParams
from tpuminter.workloads import dictsearch as ref_ds
from tpuminter_torch import coordinator as port_coordinator
from tpuminter_torch import protocol as port
from tpuminter_torch.coordinator import QUOTA_BUCKETS_CAP, Coordinator
from tpuminter_torch.journal import encode_record
from tpuminter_torch.lsp import Params

_LSP = dict(epoch_limit=5, epoch_millis=40, window_size=32, max_backoff_interval=2,
            max_unacked_messages=32)
REF_FAST, FAST = RefParams(**_LSP), Params(**_LSP)


def run(coro, timeout=30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


class FakeClock:
    """The coordinators' clock seam, stepped by the script."""

    def __init__(self):
        self.t_mono, self.t_wall = 1000.0, 1_700_000_000.0

    def mono(self):
        return self.t_mono

    def wall(self):
        return self.t_wall

    def step(self, dt):
        self.t_mono += dt
        self.t_wall += dt


class StubServer:
    """The LSP server's surface the admission paths touch."""

    def __init__(self, conn_ids=()):
        self.conn_ids = set(conn_ids)
        self.writes = []

    def write(self, conn_id, data):
        self.writes.append((conn_id, bytes(data)))


def _mine(job_id, ckey="", upper=31):
    return ref.Request(job_id=job_id, mode=ref.PowMode.MIN, lower=0, upper=upper,
                       data=b"adm-%d" % job_id, client_key=ckey)


_DICT_DATA = ref_ds.pack_params("fmin", 0xFA1A, [b"pa", b"pb", b"pc"])


def _dict(job_id, ckey=""):
    return ref.Request(job_id=job_id, mode=ref.PowMode.MIN, lower=0, upper=2, data=_DICT_DATA,
                       client_key=ckey, workload="dict")


def _job_of(coord, conn, cjid):
    return next(j for j in coord._jobs.values()
                if j.client_conn == conn and j.client_job_id == cjid)


def _play(impl, script, conns=(1, 2, 3, 4), **kw):
    """Drive one coordinator through ``script`` on a stub server; return
    everything observable: the bytes written, the minted jobs in order,
    the park drain order, the live jobs, the buckets and the counters."""
    clock = FakeClock()
    server = StubServer(conns)
    coord = (RefCoordinator if impl == "ref" else Coordinator)(server, clock=clock, **kw)
    minted, drained = [], []
    for op, *args in script:
        if op == "req":
            conn, msg = args
            coord._on_request(conn, msg if impl == "ref" else port.decode_msg(
                ref.encode_msg(msg)))
        elif op == "step":
            clock.step(args[0])
        elif op == "drain":
            before = dict(coord.parked_drained_by_class)
            coord._drain_parked()
            drained.append({c: n - before.get(c, 0)
                            for c, n in coord.parked_drained_by_class.items()
                            if n != before.get(c, 0)})
        elif op == "set":
            setattr(coord, *args)
        elif op == "progress":  # a job gains settled hashes: never shed
            _job_of(coord, *args).hashes_done = 1
        elif op == "finish":
            job = _job_of(coord, *args)
            job.best = (5, 3)
            coord._finish_job(job, found=True)
        elif op == "lost":
            server.conn_ids.discard(args[0])
            coord._on_lost(args[0])
        elif op == "bind":  # a re-submission superseded a parked entry
            coord._bound[tuple(args)] = 777
        elif op == "trim":
            coord._trim_winners()
        elif op == "reap":
            coord._reap_unbound()
        for job in coord._jobs.values():
            key = (job.client_conn, job.client_job_id, job.request.workload)
            if key not in minted:
                minted.append(key)
    return {
        "writes": server.writes,
        "minted": minted,
        "drained": drained,
        "live": sorted((j.client_conn, j.client_job_id) for j in coord._jobs.values()),
        "buckets": [(k, round(t, 9), s) for k, (t, _last, s) in coord._buckets.items()],
        "winners": sorted(coord._winners),
        "stats": dict(coord.stats),
    }


def _both(script, **kw):
    want = _play("ref", script, **kw)
    got = _play("port", script, **kw)
    return want, got


def _refusals(writes):
    return [(conn, ref.decode_msg(raw)) for conn, raw in writes
            if isinstance(ref.decode_msg(raw), ref.Refuse)]


# -- quota across compaction ---------------------------------------------------

def _tenant_reqs(ckey, n, base=1):
    return [port.decode_msg(ref.encode_msg(_mine(base + i, ckey))) for i in range(n)]


async def _port_compacts(wal, **kw):
    """Open ``wal`` in the port's coordinator, compact it through the
    journal's own flush path, and return the recovered buckets."""
    coord = await Coordinator.create(params=FAST, recover_from=wal, **kw)
    buckets = {k: (round(t, 3), s) for k, (t, _l, s) in coord._buckets.items()}
    journal = coord._journal
    journal._compact_bytes = 0
    coord._quota_dirty.update(k for k in coord._buckets)  # a record to flush
    coord._journal_quota()
    await journal.flush()
    while journal._flush_task is not None and not journal._flush_task.done():
        await asyncio.sleep(0.01)
    assert journal.stats["compactions"] >= 1
    coord.crash()
    return buckets


def _kinds(wal):
    return [rec.get("k") for rec in ref_scan_file(wal)]


def test_reference_quota_equals_after_a_port_compaction(tmp_path):
    """A reference journal with tenant balances, recovered by the port
    and compacted there: the port adopts the balances, and the
    reference recovers them unchanged from the compacted file (before
    the repair the port's snapshot dropped them and every tenant came
    back with a fresh burst)."""
    wal = str(tmp_path / "q.wal")
    kw = dict(quota_rate=0.001, quota_burst=6, quota_tiers={"gold": 2.0})

    async def scenario():
        coord = await RefCoordinator.create(params=REF_FAST, recover_from=wal, **kw)
        for ckey, n in (("tenant-a", 4), ("gold:b", 14), ("tenant-c", 1)):
            for msg in [ref.decode_msg(ref.encode_msg(_mine(i + 1, ckey))) for i in range(n)]:
                coord._admit(1, msg)
        coord._admit(2, _mine(1))  # anonymous: never journaled
        want = {k: (round(t, 3), s) for k, (t, _l, s) in coord._buckets.items()
                if not k.startswith("@conn:")}
        coord._journal_quota()
        await coord._journal.flush()
        coord.crash()
        got = await _port_compacts(wal, **kw)
        assert "snapshot" in _kinds(wal) and "quota" not in _kinds(wal)
        again = await RefCoordinator.create(params=REF_FAST, recover_from=wal, **kw)
        back = {k: (round(t, 3), s) for k, (t, _l, s) in again._buckets.items()}
        again.crash()
        return want, got, back

    want, got, back = run(scenario())
    assert want == {"tenant-a": (2.0, 0), "gold:b": (0.0, 2), "tenant-c": (5.0, 0)}
    assert got == want
    assert back == want
    assert ref_replay(ref_scan_file(wal)).quota == {k: [t, s] for k, (t, s) in want.items()}


def test_port_quota_equals_after_its_own_compaction(tmp_path):
    """The port's own balances, journaled by its quota record and
    carried through its compaction, come back equal in the port and in
    the reference."""
    wal = str(tmp_path / "p.wal")
    kw = dict(quota_rate=0.001, quota_burst=5)

    async def scenario():
        coord = await Coordinator.create(params=FAST, recover_from=wal, **kw)
        for msg in _tenant_reqs("tenant-p", 3) + _tenant_reqs("tenant-r", 7):
            coord._admit(1, msg)
        want = {k: (round(t, 3), s) for k, (t, _l, s) in coord._buckets.items()}
        coord._journal_quota()
        await coord._journal.flush()
        coord.crash()
        got = await _port_compacts(wal, **kw)
        ref_back = await RefCoordinator.create(params=REF_FAST, recover_from=wal, **kw)
        back = {k: (round(t, 3), s) for k, (t, _l, s) in ref_back._buckets.items()}
        ref_back.crash()
        port_back = await Coordinator.create(params=FAST, recover_from=wal, **kw)
        back2 = {k: (round(t, 3), s) for k, (t, _l, s) in port_back._buckets.items()}
        port_back.crash()
        return want, got, back, back2

    want, got, back, back2 = run(scenario())
    assert want == {"tenant-p": (2.0, 0), "tenant-r": (0.0, 2)}
    assert got == back == back2 == want


def test_snapshot_without_quota_keeps_the_references_shape():
    """A checkpoint with no durable tenant carries no ``quota`` key, as
    the reference's; with one it carries the same list."""
    for kw in ({}, {"quota_rate": 1.0}):
        snaps = []
        for impl in ("ref", "port"):
            coord = (RefCoordinator if impl == "ref" else Coordinator)(
                StubServer(), clock=FakeClock(), **kw)
            msg = _mine(1, "tenant") if impl == "ref" else _tenant_reqs("tenant", 1)[0]
            coord._on_request(1, msg)
            snap = coord._journal_snapshot()
            snaps.append(ref_encode_record(snap) if impl == "ref" else encode_record(snap))
        assert snaps[0] == snaps[1]
        assert (b'"quota"' in snaps[0]) == bool(kw)


# -- the scripted admission sequences ---------------------------------------------

ADMISSION = {
    # burst 2, 1 token/s: refusals carry the exact accrual time, doubled
    # on each consecutive strike; admission resets the strikes
    "quota-strikes": (
        [("req", 1, _mine(i, "tenant")) for i in range(1, 7)]
        + [("step", 0.4), ("req", 1, _mine(7, "tenant")), ("step", 0.7),
           ("req", 1, _mine(8, "tenant")), ("req", 1, _mine(9, "tenant")),
           ("step", 3.0), ("req", 1, _mine(10, "tenant"))],
        dict(quota_rate=1.0, quota_burst=2)),
    # tiers: gold 4× (burst 8), bulk 0.25× (burst floored at 1), unknown
    # prefix 1×; anonymous clients meter per connection, and a lost
    # session's anonymous bucket goes with it
    "quota-tiers": (
        [("req", 1, _mine(i, "gold:alice")) for i in range(1, 11)]
        + [("req", 2, _mine(i, "bulk:bob")) for i in range(1, 4)]
        + [("req", 3, _mine(i, "odd:carol")) for i in range(1, 5)]
        + [("req", 4, _mine(i)) for i in range(1, 5)]
        + [("step", 0.6), ("req", 2, _mine(9, "bulk:bob")), ("req", 4, _mine(9)),
           ("lost", 4), ("step", 30.0), ("req", 1, _mine(11, "gold:alice"))],
        dict(quota_rate=2.0, quota_burst=2, quota_tiers={"gold": 4.0, "bulk": 0.25})),
    # the job cap without the park queue: the newcomer sheds the oldest
    # zero-progress job (an UNBOUND one first), else is refused
    "max-jobs-shed": (
        [("req", 1, _mine(1, "a")), ("req", 2, _mine(2)), ("req", 3, _mine(3, "c")),
         ("lost", 1), ("req", 4, _mine(4)), ("req", 4, _mine(5)),
         ("progress", 3, 3), ("progress", 4, 4), ("req", 2, _mine(6)),
         ("progress", 2, 6), ("req", 2, _mine(7)), ("finish", 4, 4), ("req", 2, _mine(8))],
        dict(max_jobs=3, retry_after_ms=75)),
    # the park queue's stride drain under weights 3:1, one slot at a time
    # (tests/test_fabric.py's degenerate schedule)
    "park-stride": (
        [("req", 1, _mine(900))]
        + [op for i in range(12) for op in (("req", 1, _mine(i + 1)),
                                            ("req", 2, _dict(i + 101)))]
        + [op for n in range(2, 10) for op in (("set", "_max_jobs", n), ("drain",))],
        dict(max_jobs=1, park_capacity=32, retry_after_ms=50,
             workload_weights={"mine": 3.0, "dict": 1.0})),
    # overflow sheds the oldest parked entry with an explicit Refuse
    "park-overflow": (
        [("req", 1, _mine(900))] + [("req", 2, _dict(j, "flood")) for j in (11, 12, 13)],
        dict(max_jobs=1, park_capacity=2, retry_after_ms=50)),
    # dead clients' and superseded entries drop without minting
    "park-dead-superseded": (
        [("req", 1, _mine(900)), ("req", 99, _mine(5)), ("req", 2, _mine(6, "k")),
         ("bind", "k", 6), ("set", "_max_jobs", 10), ("drain",)],
        dict(max_jobs=1, park_capacity=32, retry_after_ms=50, conns=(1, 2))),
    # a class parking late joins at the current virtual time
    "park-late-class": (
        [("req", 1, _mine(900))] + [("req", 1, _mine(i + 1)) for i in range(4)]
        + [("set", "_max_jobs", 2), ("drain",), ("set", "_max_jobs", 3), ("drain",),
           ("req", 2, _dict(50)), ("req", 2, _dict(51)), ("set", "_max_jobs", 6), ("drain",)],
        dict(max_jobs=1, park_capacity=32, retry_after_ms=50,
             workload_weights={"mine": 1.0, "dict": 1.0})),
    # quota and the park queue together: over-quota submissions park and
    # drain as tokens accrue; a full table never line-jump sheds
    "park-quota": (
        [("req", 1, _mine(i, "t")) for i in range(1, 5)]
        + [("req", 2, _dict(i, "d")) for i in range(1, 4)]
        + [("drain",), ("step", 0.5), ("drain",), ("step", 0.6), ("drain",),
           ("finish", 1, 1), ("step", 2.0), ("drain",)],
        dict(quota_rate=1.0, quota_burst=2, max_jobs=5, park_capacity=8,
             workload_weights={"mine": 1.0, "dict": 2.0})),
    # the winner table's age bound under the fake wall clock
    "winners-ttl": (
        [("req", 1, _mine(i, "w")) for i in range(1, 4)]
        + [("finish", 1, 1), ("step", 5.0), ("finish", 1, 2), ("step", 6.0), ("trim",),
           ("finish", 1, 3), ("step", 6.0), ("trim",)],
        dict(winners_ttl=10.0)),
    # UNBOUND reaping: a durable client's job outlives its session by
    # unbound_ttl; a re-bind takes it out of the reaper's hands
    "unbound-ttl": (
        [("req", 1, _mine(1, "u")), ("req", 1, _mine(2, "u")), ("req", 2, _mine(3)),
         ("lost", 1), ("lost", 2), ("step", 1.0), ("req", 3, _mine(2, "u")),
         ("step", 1.5), ("reap",), ("req", 4, _mine(9))],
        dict(unbound_ttl=2.0, conns=(1, 2, 3, 4))),
}


@pytest.mark.parametrize("case", list(ADMISSION))
def test_admission_sequence_equals_the_references(case):
    script, kw = ADMISSION[case]
    want, got = _both(script, **kw)
    assert got["writes"] == want["writes"]
    assert got == want


def test_quota_refusals_escalate_as_the_reference_computes():
    """The Refuses' retry hints: the exact accrual time of the missing
    token, doubled per consecutive strike, reset by an admission."""
    script, kw = ADMISSION["quota-strikes"]
    got = _play("port", script, **kw)
    hints = [msg.retry_after_ms for _conn, msg in _refusals(got["writes"])]
    # 4 quick refusals at 0 tokens, one after 0.4 s (0.4 token), then 1.1
    # tokens admit #8 and #9 is refused at 0.1 token, strikes reset
    assert hints[:5] == [1000, 2000, 4000, 8000, 600 << 4]
    assert hints[5] in (899, 900)  # 0.9 of a token, as the float sum rounds
    assert [m.chunk_id for _c, m in _refusals(got["writes"])] == [0] * 6
    assert got["stats"]["refused_admission"] == 6


def test_tiers_and_the_session_bucket_as_the_reference_meters():
    script, kw = ADMISSION["quota-tiers"]
    got = _play("port", script, **kw)
    admitted = {}
    for conn, cjid, _wl in got["minted"]:
        admitted.setdefault(conn, []).append(cjid)
    assert admitted[1] == list(range(1, 9)) + [11]  # gold: burst 8, then refilled
    assert admitted[2] == [1]                       # bulk: burst floored at 1
    assert admitted[3] == [1, 2]                    # unknown tier: 1×
    assert admitted[4][:2] == [1, 2]                # anonymous: per connection
    assert not any(k == "@conn:4" for k, _t, _s in got["buckets"])


def test_bucket_cap_sheds_the_least_recent_as_the_reference():
    """Past QUOTA_BUCKETS_CAP identities the least recently metered
    bucket goes: a returning shed identity gets a fresh burst."""
    n = QUOTA_BUCKETS_CAP + 3
    script = ([("req", 1, _mine(1, f"id-{i}")) for i in range(n)]
              + [("req", 1, _mine(2, "id-0"))])
    want, got = _both(script, quota_rate=0.001, quota_burst=1)
    assert got == want
    keys = [k for k, _t, _s in got["buckets"]]
    assert len(keys) == QUOTA_BUCKETS_CAP and keys[-1] == "id-0"
    assert not {"id-1", "id-2", "id-3"} & set(keys) and "id-4" in keys
    assert got["stats"]["quota_buckets_high_water"] == QUOTA_BUCKETS_CAP
    assert got["stats"]["refused_admission"] == 0  # id-0 came back fresh


def test_winners_ttl_and_unbound_ttl_evict_as_the_reference():
    got = _play("port", *ADMISSION["winners-ttl"][:1], **ADMISSION["winners-ttl"][1])
    assert got["winners"] == [("w", 3)] and got["stats"]["winners_evicted"] == 2
    got = _play("port", *ADMISSION["unbound-ttl"][:1], **ADMISSION["unbound-ttl"][1])
    # job 1 of "u" reaped; job 2 re-bound on conn 3; the anonymous job
    # went with its session
    assert got["live"] == [(3, 2), (4, 9)]
    assert got["stats"]["unbound_reaped"] == 1


def test_the_cli_takes_the_references_admission_flags():
    """The thirteen policy flags parse with the reference's defaults, and
    the help lists the sharded coordinators' four; malformed tiers and
    weights are the reference's parse errors, as is ``--replicate-to``
    without ``--journal``; the federation's flag, of a later slice, is an
    argparse error, not a silent no-op."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as exit_:
        port_coordinator.main(["--help"])
    assert exit_.value.code == 0
    text = " ".join(out.getvalue().split())
    for flag in ("--hedge-after SECONDS", "--audit-rate P", "--stats-port PORT",
                 "--quota-rate R", "--quota-burst N", "--quota-tier NAME=MULT",
                 "--max-jobs N", "--retry-after-ms MS", "--winners-ttl SECONDS",
                 "--unbound-ttl SECONDS", "--park-queue N", "--workload-weight LIST",
                 "--emit-interval SECONDS", "--loops N", "--procs N", "--io-batch {on,off}",
                 "--journal-mode {writer,segments}"):
        assert flag in text, flag
    for default in ("(default 8)", "(default 250;", "default 0.5"):
        assert default in text
    for argv in (["0", "--quota-tier", "gold"], ["0", "--workload-weight", "mine=1,dict"],
                 ["0", "--replicate-to", "h:1"], ["0", "--steal-after", "1"]):
        err = io.StringIO()
        with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as exit_:
            port_coordinator.main(argv)
        assert exit_.value.code == 2, argv
