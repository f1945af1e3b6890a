"""Write-ahead job journal: durable coordinator state and crash recovery.

Counterpart of ``tpuminter.journal`` for a single-loop coordinator. The
records are the reference's byte for byte, so either coordinator
recovers from the other's journal.

**On-disk format**: an append-only file of length-prefixed, CRC-checked
records, ``size:u32 ‖ crc32:u32 ‖ payload[size]`` with the CRC over
``size ‖ payload``. A payload is compact JSON, except the highest-rate
record, ``settle``, which is struct-packed (tag 0xB7,
:func:`encode_settle`). A record that fails to frame or checksum ends
the readable prefix: a torn tail and mid-file corruption both look like
the loss of a suffix, never like different records.

**Record kinds**: ``boot`` (one per incarnation, with its monotone boot
epoch), ``job`` (a job accepted; its request carries the client's
durable key), ``settle`` (a verified chunk folded: replay subtracts its
range from the job's remaining work and min-folds its claim, or
re-absorbs a workload's fold payload), ``finish`` (a winner, written
before the client is answered), ``abandon``, ``snapshot`` (a compacting
checkpoint), and the observability kinds ``assign``, ``requeue`` and
``bind``. Replay also folds the reference's ``quota``, ``lease`` and
``lease_end`` records, which the port's coordinator does not write yet.

**Write path**: appends buffer in memory. In ``tick_flush`` mode the
owner's serve loop calls :meth:`Journal.flush_tick` once per event
burst; otherwise a flusher task group-commits each burst. A batch that
gates a client reply (a record appended with ``on_durable``) is
fsynced before its callbacks fire, inline while fsync is fast and on
the executor once one took longer than :data:`INLINE_FSYNC_BUDGET_S`.
With no running loop, appends write through synchronously.

**Replay** (:func:`replay`) is a pure fold over decoded records and is
idempotent on every sequence in which each job's record comes before
its settles, as a coordinator writes them.

**Replication** (:mod:`tpuminter_torch.replication`): :attr:`Journal.size`
is the clean file's length, the shipping offset space, and
:attr:`Journal.generation` counts compactions (each makes every older
offset meaningless). :attr:`Journal.on_batch` sees each batch written
to the file, with its start offset and raw framed bytes; a hook that
raises is detached and the WAL goes on. :func:`scan_with_cursor`,
:func:`read_span` and :func:`cursor_valid` are a standby's resume cursor
and a primary's tail reader, and :meth:`Journal.adopt` opens a promoted
standby's copy without a rescan.

**Segments** (the sharded coordinators, :mod:`tpuminter_torch.multiloop`
and :mod:`tpuminter_torch.multiproc`): shard *k* may keep its own WAL at
``path.s<k>`` (:func:`segment_paths`). Jobs are shard-affine, so
:func:`merge_states` rebuilds the single-journal state from the
segments' replays; :meth:`Journal.fresh` writes a recovered layout anew
(fsynced before it replaces the old file), and :meth:`Journal.open`
absorbs segments an earlier sharded run left, so a restart may cross
journal modes and shard counts. :meth:`Journal.compact_now` is the
writer journal's compaction for a caller that stopped the world itself.

**Group commit across jobs** (:attr:`Journal.group_commit`, off by
default as in the reference): a batch that gates a reply waits
:data:`GROUP_COMMIT_WINDOW_S` so a burst of finishes shares one fsync.
The disk fault plan waits for a later slice.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import struct
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from tpuminter_torch.analysis import affinity
from tpuminter_torch.protocol import Request, request_from_obj, request_to_obj

log = logging.getLogger("tpuminter_torch.journal")

__all__ = [
    "Journal",
    "RecoveredJob",
    "RecoveredState",
    "frame_payload",
    "encode_record",
    "encode_settle",
    "decode_settle",
    "scan",
    "scan_with_cursor",
    "read_span",
    "cursor_valid",
    "replay",
    "merge_ranges",
    "merge_states",
    "scan_file",
    "segment_paths",
    "intersect_ranges",
    "subtract_range",
    "WINNERS_CAP",
]

_REC = struct.Struct("<II")

#: Framing bound: a corrupted size field past it ends the readable
#: prefix instead of attempting a huge allocation.
MAX_RECORD = 8 << 20

#: Acknowledged winners kept for duplicate-request suppression; the
#: oldest are evicted beyond this.
WINNERS_CAP = 4096

#: A durable group commit whose write + fsync finishes under this runs
#: inline on the event loop; the first slower one moves every later
#: fsync to the executor for good.
INLINE_FSYNC_BUDGET_S = 0.002

#: How long a callback-free batch may wait for more records to share
#: its write (task flush mode).
BATCH_WINDOW_S = 0.002

#: How long a reply-gating batch waits for more finishes to share its
#: fsync when :attr:`Journal.group_commit` is on. It adds its length to
#: every winner's answer, which is why the knob is off by default: it
#: pays only where an fsync costs milliseconds.
GROUP_COMMIT_WINDOW_S = 0.005


# -- record codec (pure) -----------------------------------------------------

def frame_payload(payload: bytes) -> bytes:
    """Frame one serialized payload: ``size ‖ crc32(size ‖ payload) ‖ payload``."""
    size = len(payload)
    if size > MAX_RECORD:
        raise ValueError(f"record too large: {size} > {MAX_RECORD}")
    head = struct.pack("<I", size)
    crc = zlib.crc32(payload, zlib.crc32(head))
    return _REC.pack(size, crc) + payload


def encode_record(obj: dict) -> bytes:
    """Serialize and frame one record dict."""
    return frame_payload(json.dumps(obj, separators=(",", ":")).encode())


#: Packed settle record. The tag shares the ``{``-disjoint namespace of
#: the wire's binary tags, so a payload's first byte tells it from JSON;
#: the record framing already checksums it.
_SETTLE_TAG = 0xB7
_SETTLE = struct.Struct("<BQQQQQ32s")  # tag, id, lo, hi, n, s, h (u256 LE)


def encode_settle(job_id: int, lo: int, hi: int, nonce: int, searched: int,
                  hash_value: int) -> bytes:
    """Pack one settle payload (the caller keeps every field in range)."""
    return _SETTLE.pack(_SETTLE_TAG, job_id, lo, hi, nonce, searched,
                        hash_value.to_bytes(32, "little"))


def decode_settle(payload: bytes) -> Optional[dict]:
    """A packed settle payload as the replay-shaped record dict, or None
    when ``payload`` is not one (the scanner then ends the prefix)."""
    if len(payload) != _SETTLE.size or payload[0] != _SETTLE_TAG:
        return None
    _, job_id, lo, hi, nonce, searched, digest = _SETTLE.unpack(payload)
    return {
        "k": "settle", "id": job_id, "lo": lo, "hi": hi,
        "n": nonce, "s": searched,
        "h": f"{int.from_bytes(digest, 'little'):x}",
    }


def scan(data: bytes) -> Tuple[List[dict], int]:
    """Decode the valid record prefix of ``data``: ``(records,
    clean_bytes)``. Everything past ``clean_bytes`` (a torn tail, a
    corrupted record and what its broken size field would unframe) is
    lost; the recovering owner truncates the file there."""
    records, clean, _last = scan_with_cursor(data)
    return records, clean


def scan_with_cursor(data: bytes) -> Tuple[List[dict], int, int]:
    """:func:`scan`, plus the offset at which the last clean record
    starts (-1 when none decoded). ``(clean, last_start, the stored CRC
    at last_start)`` is a standby's resume cursor, which the primary
    checks against its own file with :func:`cursor_valid`."""
    records: List[dict] = []
    off = 0
    last_start = -1
    total = len(data)
    while total - off >= _REC.size:
        size, crc = _REC.unpack_from(data, off)
        end = off + _REC.size + size
        if size > MAX_RECORD or end > total:
            break
        payload = bytes(data[off + _REC.size:end])
        if crc != zlib.crc32(payload, zlib.crc32(data[off:off + 4])):
            break
        if payload[:1] != b"{":
            obj = decode_settle(payload)  # the only non-JSON kind
            if obj is None:
                break
        else:
            try:
                obj = json.loads(payload)
            except ValueError:
                break
            if not isinstance(obj, dict) or "k" not in obj:
                break
        records.append(obj)
        last_start, off = off, end
    return records, off, last_start


def read_span(path: str, offset: int, limit: int) -> bytes:
    """Up to ``limit`` raw journal bytes from ``offset``: a primary's
    tail reader (the file is the backlog; ``on_batch`` only says that
    there is more)."""
    with open(path, "rb") as fh:
        fh.seek(offset)
        return fh.read(limit)


def cursor_valid(path: str, offset: int, last_start: int, crc: int) -> bool:
    """Whether a standby's cursor matches this file, with no replay: the
    record at ``last_start`` must frame to exactly ``offset`` and carry
    stored CRC ``crc``. A compaction or any divergence fails it (the
    stream then restarts at 0); ``offset == 0`` always holds."""
    if offset == 0:
        return True
    if not 0 <= last_start < offset:
        return False
    try:
        with open(path, "rb") as fh:
            if fh.seek(0, os.SEEK_END) < offset:
                return False
            fh.seek(last_start)
            head = fh.read(_REC.size)
    except OSError:
        return False
    if len(head) != _REC.size:
        return False
    size, stored_crc = _REC.unpack(head)
    return last_start + _REC.size + size == offset and stored_crc == crc


# -- interval arithmetic (pure) ----------------------------------------------

def merge_ranges(ranges: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sort and coalesce inclusive integer intervals (adjacent ones merge)."""
    out: List[Tuple[int, int]] = []
    for lo, hi in sorted(r for r in ranges if r[1] >= r[0]):
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def intersect_ranges(a: List[Tuple[int, int]],
                     b: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Intersect two lists of disjoint sorted inclusive intervals."""
    out: List[Tuple[int, int]] = []
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if lo <= hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract_range(ranges: List[Tuple[int, int]], lo: int,
                   hi: int) -> Tuple[List[Tuple[int, int]], int]:
    """Remove ``[lo, hi]`` from disjoint inclusive intervals. Returns
    ``(new_ranges, removed)``; ``removed`` is 0 when the settle was
    already applied, which is what makes replay idempotent."""
    out: List[Tuple[int, int]] = []
    removed = 0
    for a, b in ranges:
        if b < lo or a > hi:
            out.append((a, b))
            continue
        cut_lo, cut_hi = max(a, lo), min(b, hi)
        removed += cut_hi - cut_lo + 1
        if a < cut_lo:
            out.append((a, cut_lo - 1))
        if cut_hi < b:
            out.append((cut_hi + 1, b))
    return out, removed


# -- replay (pure) -----------------------------------------------------------

def _best_to_obj(best: Optional[Tuple[int, int]]):
    return None if best is None else [f"{best[0]:x}", best[1]]


def _best_from_obj(obj) -> Optional[Tuple[int, int]]:
    return None if obj is None else (int(obj[0], 16), int(obj[1]))


@dataclass
class RecoveredJob:
    """One journaled job replayed back to its pre-crash coverage."""

    job_id: int
    request: Request
    #: un-settled inclusive intervals of the job's range: the work a
    #: restarted coordinator must still dispatch
    remaining: List[Tuple[int, int]]
    best: Optional[Tuple[int, int]] = None  # (hash_value, nonce) min-fold
    hashes_done: int = 0
    #: a workload job's coverage-gated fold state, None for mining jobs
    wstate: Optional[dict] = None

    @property
    def client_key(self) -> str:
        return self.request.client_key

    @property
    def client_job_id(self) -> int:
        return self.request.job_id

    def to_obj(self) -> dict:
        obj = {
            "id": self.job_id,
            "req": request_to_obj(self.request),
            "rem": [[lo, hi] for lo, hi in self.remaining],
            "best": _best_to_obj(self.best),
            "hashes": self.hashes_done,
        }
        if self.wstate is not None:
            obj["wst"] = self.wstate
        return obj

    @classmethod
    def from_obj(cls, obj: dict) -> "RecoveredJob":
        return cls(
            job_id=int(obj["id"]),
            request=request_from_obj(obj["req"]),
            remaining=merge_ranges([(int(lo), int(hi)) for lo, hi in obj["rem"]]),
            best=_best_from_obj(obj.get("best")),
            hashes_done=int(obj.get("hashes", 0)),
            wstate=obj.get("wst"),
        )


@dataclass
class RecoveredState:
    """Everything :func:`replay` rebuilds from a journal."""

    boot_epoch: int = 0
    next_job_id: int = 1
    jobs: Dict[int, RecoveredJob] = field(default_factory=dict)
    #: (client_key, client_job_id) → finish-record dict, oldest first
    winners: "OrderedDict[Tuple[str, int], dict]" = field(default_factory=OrderedDict)
    #: job ids seen finishing or abandoned: keeps job records idempotent
    finished: Set[int] = field(default_factory=set)
    #: a federation aggregator's still-open parent leases (raw records)
    leases: Dict[int, dict] = field(default_factory=dict)
    #: admission buckets by durable client key: ckey → [tokens, strikes]
    quota: Dict[str, list] = field(default_factory=dict)
    records: int = 0
    #: size bound applied to ``winners`` while folding, so a coordinator
    #: with a smaller table rebuilds the same bounded view
    winners_cap: int = WINNERS_CAP

    def apply(self, rec: dict) -> None:
        k = rec["k"]
        self.records += 1
        if k == "boot":
            self.boot_epoch = max(self.boot_epoch, int(rec["epoch"]))
        elif k == "snapshot":
            self.next_job_id = int(rec["next"])
            self.jobs = {int(j["id"]): RecoveredJob.from_obj(j) for j in rec["jobs"]}
            self.winners = OrderedDict(
                ((str(ck), int(cj)), dict(w)) for ck, cj, w in rec["winners"])
            # later records can only re-apply what the snapshot holds
            self.finished = set()
            self.leases = {int(lease["pc"]): dict(lease) for lease in rec.get("leases", [])}
            self.quota = {str(ck): [float(tok), int(strikes)]
                          for ck, tok, strikes in rec.get("quota", [])}
        elif k == "job":
            job_id = int(rec["id"])
            self.next_job_id = max(self.next_job_id, job_id + 1)
            if job_id in self.jobs or job_id in self.finished:
                return  # a duplicate (double replay): already accounted
            req = request_from_obj(rec["req"])
            self.jobs[job_id] = RecoveredJob(job_id=job_id, request=req,
                                             remaining=[(req.lower, req.upper)])
        elif k == "settle":
            job = self.jobs.get(int(rec["id"]))
            if job is None:
                return  # finished, abandoned or unknown: moot
            job.remaining, removed = subtract_range(job.remaining, int(rec["lo"]),
                                                    int(rec["hi"]))
            if removed:
                job.hashes_done += int(rec["s"])
            if "wp" in rec:
                # a workload settle re-absorbs through the coverage gate,
                # so a second replay of the range is a no-op
                from tpuminter_torch import workloads

                job.wstate, _ = workloads.absorb_payload(
                    job.request, job.wstate, int(rec["lo"]), int(rec["hi"]),
                    bytes.fromhex(rec["wp"]))
                return
            claim = (int(rec["h"], 16), int(rec["n"]))
            if job.best is None or claim < job.best:
                job.best = claim  # min-fold: idempotent under replay
        elif k == "finish":
            job_id = int(rec["id"])
            self.jobs.pop(job_id, None)
            self.finished.add(job_id)
            ckey = rec.get("ckey") or ""
            if ckey:
                key = (ckey, int(rec["cjid"]))
                self.winners.pop(key, None)
                self.winners[key] = rec
                while len(self.winners) > self.winners_cap:
                    self.winners.popitem(last=False)
        elif k == "abandon":
            job_id = int(rec["id"])
            self.jobs.pop(job_id, None)
            self.finished.add(job_id)
        elif k == "lease":
            self.leases[int(rec["pc"])] = {key: rec[key] for key in rec if key != "k"}
        elif k == "lease_end":
            self.leases.pop(int(rec.get("pc", 0)), None)
        elif k == "quota":
            for ck, tok, strikes in rec.get("buckets", []):
                self.quota[str(ck)] = [float(tok), int(strikes)]
        # assign / requeue / bind: observability only (every un-settled
        # range re-mines after a restart anyway)

    def snapshot_obj(self) -> dict:
        """The compacting checkpoint equal to this state (the boot epoch
        rides its own ``boot`` record)."""
        obj = {
            "k": "snapshot",
            "next": self.next_job_id,
            "jobs": [j.to_obj() for j in self.jobs.values()],
            "winners": [[ck, cj, w] for (ck, cj), w in self.winners.items()],
        }
        if self.leases:
            obj["leases"] = list(self.leases.values())
        if self.quota:
            obj["quota"] = [[ck, tok, strikes] for ck, (tok, strikes) in self.quota.items()]
        return obj


def replay(records: List[dict], *, winners_cap: int = WINNERS_CAP) -> RecoveredState:
    """Fold a record sequence into a :class:`RecoveredState`."""
    state = RecoveredState(winners_cap=winners_cap)
    for rec in records:
        state.apply(rec)
    return state


def segment_paths(path: str) -> List[str]:
    """The per-shard WAL segments beside ``path`` (``path.s<k>``),
    sorted; the merge does not depend on their order."""
    import glob as _glob

    return sorted(_glob.glob(path + ".s[0-9]*"))


def scan_file(path: str) -> List[dict]:
    """The valid record prefix of the journal at ``path`` (a missing
    file has none). A pure read: the sharded recovery that calls it
    rewrites the files whole."""
    if not os.path.exists(path):
        return []
    with open(path, "rb") as fh:
        data = fh.read()
    records, _clean = scan(data)
    return records


def merge_states(states: List[RecoveredState]) -> RecoveredState:
    """The single-journal state of WAL segments each replayed on its own
    (a segment's snapshot resets only its own stream). Jobs are
    shard-affine, so the union is well defined; a job id in two streams
    (a crash between a sharded start's rewrite and its unlinks) merges
    conservatively: remaining coverage intersects, the min-fold keeps
    the smaller best, hashes take the max, and a job any stream saw
    finish or abandon stays finished. Quota buckets merge to the
    emptiest balance and the most strikes, which only under-grants."""
    out = RecoveredState(
        winners_cap=max((st.winners_cap for st in states), default=WINNERS_CAP))
    for st in states:
        out.boot_epoch = max(out.boot_epoch, st.boot_epoch)
        out.next_job_id = max(out.next_job_id, st.next_job_id)
        out.records += st.records
        out.finished |= st.finished
        out.leases.update(st.leases)
        for ck, (tok, strikes) in st.quota.items():
            cur = out.quota.get(ck)
            out.quota[ck] = ([tok, strikes] if cur is None
                             else [min(cur[0], tok), max(cur[1], strikes)])
        for jid, job in st.jobs.items():
            cur = out.jobs.get(jid)
            if cur is None:
                out.jobs[jid] = RecoveredJob(
                    job_id=job.job_id, request=job.request, remaining=list(job.remaining),
                    best=job.best, hashes_done=job.hashes_done, wstate=job.wstate)
                continue
            cur.remaining = intersect_ranges(cur.remaining, job.remaining)
            cur.hashes_done = max(cur.hashes_done, job.hashes_done)
            if job.best is not None and (cur.best is None or job.best < cur.best):
                cur.best = job.best
            if job.wstate is not None or cur.wstate is not None:
                # fold states merge by the workload's own discipline
                from tpuminter_torch import workloads

                fold = workloads.fold_of(cur.request)
                if fold is not None:
                    cur.wstate = workloads.merge_states(fold, cur.wstate, job.wstate)
        for key, w in st.winners.items():
            out.winners.pop(key, None)
            out.winners[key] = dict(w)
    for jid in out.finished:
        out.jobs.pop(jid, None)
    while len(out.winners) > out.winners_cap:
        out.winners.popitem(last=False)
    return out


# -- the journal itself ------------------------------------------------------

class Journal:
    """Append-only WAL with group commit and compaction.

    Use :meth:`open`: it scans the existing file (truncating a torn
    tail in place), replays it, bumps the boot epoch and durably writes
    the new ``boot`` record before returning, so the LSP server never
    advertises an epoch a crash could roll back.
    """

    def __init__(self, path: str, *, fsync: bool = True, compact_bytes: int = 4 << 20):
        self.path = path
        self._fsync = fsync
        self._compact_bytes = compact_bytes
        self._fh = None
        self._buffer: List[Tuple[object, Optional[Callable[[], None]]]] = []
        self._flush_task: Optional[asyncio.Task] = None
        self._closed = False
        self._crashed = False
        #: the disk failed (ENOSPC, a lost volume): journaling stops, and
        #: durability callbacks keep firing so no reply waits forever
        self._failed = False
        self.boot_epoch = 0
        #: returns the snapshot record; compaction is off while unset
        self.snapshot_provider: Optional[Callable[[], dict]] = None
        self._bytes_since_compact = 0
        self._fsync_slow = False  # sticky: see INLINE_FSYNC_BUDGET_S
        #: serve-tick flush mode: the owner calls :meth:`flush_tick` once
        #: per event burst; a short timer covers appends made elsewhere
        self.tick_flush = False
        self._tick_timer_armed = False
        #: the clean file's length: the replication offset space
        self.size = 0
        #: bumped by each compaction, which makes older offsets meaningless
        self.generation = 0
        #: replication hook, called on the event loop with ``(start,
        #: blob)`` once each batch is in the file
        self.on_batch: Optional[Callable[[int, bytes], None]] = None
        #: a reply-gating batch waits GROUP_COMMIT_WINDOW_S for company
        self.group_commit = False
        self.stats = {"records": 0, "flushes": 0, "syncs": 0, "bytes": 0, "compactions": 0}
        # TPUMINTER_LOOP_AFFINITY=1: a mutation from another loop's thread
        # is a recorded race (executor threads are exempt: _write_sync
        # bumps self.size off the loop by design); the multi-loop
        # coordinator rebinds the journal when it hands it over
        affinity.stamp(self)

    @classmethod
    def open(cls, path: str, *, winners_cap: int = WINNERS_CAP,
             **kwargs) -> Tuple["Journal", RecoveredState]:
        """Open (or create) the journal at ``path`` and replay it;
        ``winners_cap`` bounds the rebuilt dedup table to the caller's.
        Segments a sharded run left beside it (``path.s<k>``) are merged
        in, written into this file as one snapshot in the same durable
        write as the boot record, and only then deleted."""
        records: List[dict] = []
        if os.path.exists(path):
            with open(path, "rb") as fh:
                data = fh.read()
            records, clean = scan(data)
            if clean < len(data):
                # torn tail or corrupt record: cut the file back to its
                # clean prefix
                with open(path, "r+b") as fh:
                    fh.truncate(clean)
        state = replay(records, winners_cap=winners_cap)
        seg_paths = segment_paths(path)
        if seg_paths:
            state = merge_states([state] + [replay(scan_file(p), winners_cap=winners_cap)
                                            for p in seg_paths])
        state.boot_epoch += 1
        journal = cls(path, **kwargs)
        journal.boot_epoch = state.boot_epoch
        journal._fh = open(path, "ab")
        journal.size = journal._fh.tell()
        blob = encode_record({"k": "boot", "epoch": state.boot_epoch})
        journal.stats["records"] += 1
        if seg_paths:
            blob += encode_record(state.snapshot_obj())
            journal.stats["records"] += 1
        journal._write_sync(blob, True)
        for p in seg_paths:
            try:
                os.unlink(p)
            except OSError:
                pass
        return journal, state

    @classmethod
    def fresh(cls, path: str, epoch: int, snapshot: Optional[dict] = None,
              **kwargs) -> "Journal":
        """Create ``path`` anew as a durable ``boot`` record and an
        optional ``snapshot``: a sharded start's rewrite of the
        recovered layout. The new prefix is fsynced in a temporary file
        and ``os.replace``d over ``path``, so a crash mid-start leaves
        the old file or the whole new one, never an empty WAL."""
        blob = encode_record({"k": "boot", "epoch": epoch})
        records = 1
        if snapshot is not None:
            blob += encode_record(snapshot)
            records += 1
        journal = cls(path, **kwargs)
        journal.boot_epoch = epoch
        tmp = path + ".rewrite"
        with open(tmp, "wb") as fh:
            fh.write(blob)
            fh.flush()
            if journal._fsync:
                os.fsync(fh.fileno())
        os.replace(tmp, path)
        journal._fh = open(path, "ab")
        journal.size = len(blob)
        journal._bytes_since_compact = len(blob)
        journal.stats["records"] += records
        journal.stats["flushes"] += 1
        journal.stats["bytes"] += len(blob)
        if journal._fsync:
            journal.stats["syncs"] += 1
        return journal

    @classmethod
    def adopt(cls, path: str, epoch: int, **kwargs) -> "Journal":
        """Open ``path`` with no scan or replay: a promoted standby
        already holds the state its copy replays to, and its copy is a
        clean record prefix. The fencing ``boot`` record of ``epoch`` is
        durable before this returns, as in :meth:`open`."""
        journal = cls(path, **kwargs)
        journal.boot_epoch = epoch
        journal._fh = open(path, "ab")
        journal.size = journal._fh.tell()
        journal._write_sync(encode_record({"k": "boot", "epoch": epoch}), True)
        journal.stats["records"] += 1
        return journal

    # -- append path -------------------------------------------------------

    def append(self, kind: str, obj: Optional[dict] = None, *,
               on_durable: Optional[Callable[[], None]] = None) -> None:
        """Queue one record for the next group commit. ``on_durable``
        fires once the record's group is fsynced; only such a group is
        fsynced at all, and routine records ride to disk with the next
        sync or the OS's writeback (losing a tail of them is the suffix
        loss replay already tolerates)."""
        if self._closed or self._crashed or self._failed:
            # the record is lost; a reply waiting on it must not be
            if on_durable is not None and not self._crashed:
                on_durable()
            return
        rec = dict(obj or {})
        rec["k"] = kind
        self._buffer.append((rec, on_durable))
        self.stats["records"] += 1
        self._kick()

    def append_encoded(self, payload: bytes) -> None:
        """Queue one pre-serialized record payload (the settle fast path)."""
        if self._closed or self._crashed or self._failed:
            return
        self._buffer.append((payload, None))
        self.stats["records"] += 1
        self._kick()

    def _kick(self) -> None:
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            self._flush_buffered_sync()  # no loop: write through
            return
        if self.tick_flush:
            if not self._tick_timer_armed:
                self._tick_timer_armed = True
                loop.call_later(BATCH_WINDOW_S, self._tick_fallback)
            return
        if self._flush_task is None or self._flush_task.done():
            self._flush_task = asyncio.ensure_future(self._flush_loop())

    def _tick_fallback(self) -> None:
        self._tick_timer_armed = False
        self.flush_tick()

    def flush_tick(self) -> None:
        """Serve-tick flusher: a callback-free batch is written inline
        here; a batch gating a reply, or a due compaction, takes the
        flusher task for its fsync and executor tiers."""
        if not self._buffer or self._closed or self._crashed or self._failed:
            return
        if self._flush_task is not None and not self._flush_task.done():
            return  # an fsync or compaction flush is mid-flight; it drains
        if any(cb is not None for _, cb in self._buffer) or (
                self.snapshot_provider is not None
                and self._bytes_since_compact > self._compact_bytes):
            self._flush_task = asyncio.ensure_future(self._flush_loop())
            return
        buf, self._buffer = self._buffer, []
        try:
            self._write_sync(self._encode_batch(buf), False)
        except (OSError, ValueError):
            self._failed = True
            log.exception("journal write to %s FAILED — journaling disabled, durability is "
                          "LOST for this incarnation; replies continue undurable", self.path)

    @staticmethod
    def _encode_batch(buf) -> bytes:
        return b"".join(frame_payload(rec) if isinstance(rec, bytes) else encode_record(rec)
                        for rec, _ in buf)

    def _flush_buffered_sync(self) -> None:
        buf, self._buffer = self._buffer, []
        if not buf:
            return
        self._write_sync(self._encode_batch(buf), True)
        for _, cb in buf:
            if cb is not None:
                cb()

    @staticmethod
    def _fire(callbacks) -> None:
        for cb in callbacks:
            if cb is not None:
                try:
                    cb()
                except Exception:  # a callback must not kill the journal
                    log.exception("journal durability callback failed")

    async def _flush_loop(self) -> None:
        """Group-commit everything buffered, one task a burst. A batch
        with no callback is a page-cache write; a batch gating a reply
        is fsynced first, inline while fsync stays fast, else on the
        executor so a slow disk never stalls the heartbeats."""
        loop = asyncio.get_running_loop()
        while self._buffer and not self._crashed and not self._closed:
            if not self.tick_flush and all(cb is None for _, cb in self._buffer):
                await asyncio.sleep(BATCH_WINDOW_S)  # let the burst grow
            elif self.group_commit and any(cb is not None for _, cb in self._buffer):
                # finishes of other jobs arriving meanwhile share the fsync
                await asyncio.sleep(GROUP_COMMIT_WINDOW_S)
            buf, self._buffer = self._buffer, []
            if not buf:
                continue
            need_sync = any(cb is not None for _, cb in buf)
            try:
                blob = self._encode_batch(buf)
                if need_sync and self._fsync and self._fsync_slow:
                    await loop.run_in_executor(None, self._write_sync, blob, True, loop)
                elif need_sync and self._fsync:
                    t0 = time.perf_counter()
                    self._write_sync(blob, True)
                    if time.perf_counter() - t0 > INLINE_FSYNC_BUDGET_S:
                        self._fsync_slow = True
                    await asyncio.sleep(0)
                else:
                    self._write_sync(blob, False)
                    await asyncio.sleep(0)  # one tick, so the next burst batches
            except (OSError, ValueError):
                if self._crashed:
                    return
                # durability of this batch is gone; the replies it gates
                # are released anyway, loudly, and journaling stops
                self._failed = True
                log.exception("journal write to %s FAILED — journaling disabled, durability "
                              "is LOST for this incarnation; replies continue undurable",
                              self.path)
            self._fire(cb for _, cb in buf)
            if self._failed:
                rest, self._buffer = self._buffer, []
                self._fire(cb for _, cb in rest)
                return
            if (self.snapshot_provider is not None
                    and self._bytes_since_compact > self._compact_bytes):
                # the snapshot is taken on the loop, so it covers every
                # append so far; only the file swap runs on the executor
                blob = (encode_record({"k": "boot", "epoch": self.boot_epoch})
                        + encode_record(self.snapshot_provider()))
                try:
                    swapped = await loop.run_in_executor(None, self._compact_sync, blob)
                except (OSError, ValueError):
                    if self._crashed:
                        return
                    self._failed = True
                    log.exception("journal compaction of %s FAILED — journaling disabled "
                                  "for this incarnation", self.path)
                    return
                if swapped:
                    # size and generation move together, on the loop
                    self.size = len(blob)
                    self.generation += 1
                    self._bytes_since_compact = 0
                    self.stats["compactions"] += 1

    def _write_sync(self, blob: bytes, need_sync: bool,
                    loop: Optional[asyncio.AbstractEventLoop] = None) -> None:
        """Append one batch, then hand it to :attr:`on_batch`. On the
        executor ``loop`` names the owner's loop, where the hook runs
        (before the awaiting flusher resumes to fire callbacks)."""
        if self._crashed:
            return
        self._fh.write(blob)
        self._fh.flush()
        if self._fsync and need_sync:
            os.fsync(self._fh.fileno())
            self.stats["syncs"] += 1
        start = self.size
        self.size += len(blob)
        self.stats["flushes"] += 1
        self.stats["bytes"] += len(blob)
        self._bytes_since_compact += len(blob)
        if self.on_batch is not None:
            if loop is None:
                self._ship(start, blob)
            else:
                loop.call_soon_threadsafe(self._ship, start, blob)

    def _ship(self, start: int, blob: bytes) -> None:
        """One batch to the replication hook; a broken hook is detached."""
        if self.on_batch is not None:
            try:
                self.on_batch(start, blob)
            except Exception:
                log.exception("journal on_batch hook failed; detaching it")
                self.on_batch = None

    def compact_now(self, snapshot: Optional[dict] = None) -> bool:
        """Compact at once, for a caller that stopped the world itself
        (the multi-loop writer journal's barrier) and hands in the
        merged ``snapshot`` (else :attr:`snapshot_provider`'s). Buffered
        records reach the file first, their callbacks firing as usual;
        then the file becomes ``boot ‖ snapshot``. False when nothing
        was compacted."""
        if self._closed or self._crashed or self._failed:
            return False
        if snapshot is None:
            if self.snapshot_provider is None:
                return False
            snapshot = self.snapshot_provider()
        try:
            self._flush_buffered_sync()
            blob = (encode_record({"k": "boot", "epoch": self.boot_epoch})
                    + encode_record(snapshot))
            swapped = self._compact_sync(blob)
        except (OSError, ValueError):
            self._failed = True
            log.exception("journal compaction of %s FAILED — journaling disabled for this "
                          "incarnation", self.path)
            return False
        if swapped:
            self.size = len(blob)
            self.generation += 1
            self._bytes_since_compact = 0
            self.stats["compactions"] += 1
        return swapped

    def _compact_sync(self, blob: bytes) -> bool:
        """Replace the file by ``boot ‖ snapshot``, atomically."""
        if self._crashed:
            return False
        tmp = self.path + ".compact"
        with open(tmp, "wb") as fh:
            fh.write(blob)
            fh.flush()
            if self._fsync:
                os.fsync(fh.fileno())
        os.replace(tmp, self.path)
        self._fh.close()
        self._fh = open(self.path, "ab")
        return True

    async def flush(self) -> None:
        """Drain the buffer (tests; :meth:`aclose` uses it too)."""
        while self._buffer or (self._flush_task is not None and not self._flush_task.done()):
            if self.tick_flush:
                self.flush_tick()
            else:
                self._kick()
            if self._flush_task is not None:
                await asyncio.gather(self._flush_task, return_exceptions=True)
            if self._failed or not self._buffer:
                break

    async def aclose(self) -> None:
        """Graceful close: a final group commit, then release the file."""
        if self._closed or self._crashed:
            return
        if not self._failed:
            await self.flush()
        self._closed = True
        try:
            if not self._failed:
                self._flush_buffered_sync()
        finally:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass

    def crash(self) -> None:
        """Die like ``kill -9``: buffered records are lost (they gated no
        reply yet, so exactly-once survives) and the file just closes."""
        self._crashed = True
        self._buffer.clear()
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
