"""The port's streaming partials and stats endpoint held to the reference's.

- *Emit sequence*: one scripted peer answers every chunk of a streaming
  dict top-k the same way for both coordinators, one chunk at a time at
  ``emit_interval=0``; the ``Emit``s the client receives (seq, covered,
  total, payload) and the final Result must be equal, with and without
  a journal.
- *Durable partials*: with a journal, every ``Emit`` the port writes
  shows no more coverage than the journal file already holds.
- *Stats endpoint*: the same MIN job through each coordinator, then one
  HTTP GET of its stats endpoint: the same keys at every level, the
  same counters.
"""

import asyncio
import json

import pytest

from tests.test_torch_coordinator import REF_FAST, _answer, _candidates, _impl
from tpuminter import protocol as ref
from tpuminter.lsp import LspClient as RefLspClient
from tpuminter.workloads import dictsearch as ref_ds
from tpuminter_torch import journal as port_journal
from tpuminter_torch import protocol as port
from tpuminter_torch import workloads as port_workloads


def run(coro, timeout=30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


_cands = _candidates(300)
STREAM = ref.Request(11, ref.PowMode.MIN, 0, len(_cands) - 1,
                     data=ref_ds.pack_params("topk", 42, _cands, k=3), workload="dict",
                     stream=True)


async def _peer(coord, join, pause=0.0):
    """A scripted peer answering each dispatch with ``_answer``, after
    ``pause`` seconds (time for the last settle to reach the disk, so
    a journaled stream is not cut short by its final settle)."""
    peer = await RefLspClient.connect("127.0.0.1", coord.port, REF_FAST)
    peer.write(ref.encode_msg(join))

    async def act():
        templates = {}
        while True:
            msg = ref.decode_msg(await peer.read())
            if isinstance(msg, ref.Setup):
                templates[msg.request.job_id] = msg.request
            elif isinstance(msg, ref.Assign):
                await asyncio.sleep(pause)
                for out in _answer(templates[msg.job_id], msg):
                    peer.write(ref.encode_msg(out))

    return peer, asyncio.ensure_future(act())


async def _stream(impl, wal=None, on_write=None):
    """The Emits and the Result of STREAM through ``impl``'s coordinator
    (journaled at ``wal``) and client; ``on_write(coord, conn, data)``
    sees every write the coordinator makes."""
    Coord, params, sub, sub_params = _impl(impl)
    coord = await Coord.create(params=params, chunk_size=64, pipeline_depth=1,
                               emit_interval=0.0, recover_from=wal)
    if on_write is not None:
        write = coord.server.write
        coord.server.write = lambda conn, data: (on_write(coord, conn, data),
                                                 write(conn, data))[1]
    serve = asyncio.ensure_future(coord.serve())
    peer, act = await _peer(coord, ref.Join(backend="cuda", lanes=1, workloads=("dict",)),
                            pause=0.08)
    emits = []
    try:
        await asyncio.sleep(0.05)
        req = STREAM if impl == "ref" else port.decode_msg(ref.encode_msg(STREAM))
        result = await asyncio.wait_for(sub(
            "127.0.0.1", coord.port, req, params=sub_params,
            on_emit=lambda e: emits.append((e.seq, e.covered, e.total, bytes(e.payload)))), 20)
        sent = coord.stats["emits_sent"]
    finally:
        act.cancel()
        await asyncio.gather(act, return_exceptions=True)
        await peer.close(drain_timeout=0.2)
        serve.cancel()
        await asyncio.gather(serve, return_exceptions=True)
        coord.crash()
    return emits, (result.job_id, result.searched, bytes(result.payload)), sent


@pytest.mark.parametrize("journal", [False, True], ids=["no-journal", "journal"])
def test_emit_sequence_equals_the_references(tmp_path, journal):
    want = run(_stream("ref", str(tmp_path / "ref.wal") if journal else None))
    got = run(_stream("port", str(tmp_path / "port.wal") if journal else None))
    assert got == want
    emits, (_job, searched, payload), sent = got
    assert sent == len(emits) >= 3
    assert [e[0] for e in emits] == list(range(len(emits)))
    covered = [e[1] for e in emits]
    assert covered == sorted(set(covered)) and covered[-1] < searched == len(_cands)
    fold = port_workloads.fold_of(port.decode_msg(ref.encode_msg(STREAM)))
    for _seq, cov, total, part in emits:
        assert total == len(_cands) and len(fold.decode(part)) == min(3, cov)
    assert fold.decode(payload) == sorted(
        [ref_ds.score(42, c), i] for i, c in enumerate(_cands))[:3]


def test_no_emit_precedes_its_settles_fsync(tmp_path):
    wal = str(tmp_path / "durable.wal")
    checked = []

    def on_write(coord, conn, data):
        msg = port.decode_msg(bytes(data))
        if not isinstance(msg, port.Emit):
            return
        with open(wal, "rb") as fh:
            state = port_journal.replay(port_journal.scan(fh.read())[0])
        (job,) = state.jobs.values()
        on_disk = port_workloads.covered_span(job.wstate)
        checked.append((msg.covered, on_disk))
        assert msg.covered <= on_disk

    emits, _result, _sent = run(_stream("port", wal, on_write))
    assert len(checked) == len(emits) >= 3


async def _stats_over_http(impl, tmp_path):
    Coord, params, sub, sub_params = _impl(impl)
    coord = await Coord.create(params=params, chunk_size=512,
                               recover_from=str(tmp_path / f"{impl}.wal"))
    stats_port = await coord.start_stats_server(0)
    serve = asyncio.ensure_future(coord.serve())
    peer, act = await _peer(coord, ref.Join(backend="cpu", lanes=1))
    try:
        await asyncio.sleep(0.05)
        req = ref.Request(1, ref.PowMode.MIN, 0, 4095, data=b"stats")
        await asyncio.wait_for(sub("127.0.0.1", coord.port, req if impl == "ref" else
                                   port.decode_msg(ref.encode_msg(req)), params=sub_params), 20)
        reader, writer = await asyncio.open_connection("127.0.0.1", stats_port)
        writer.write(b"GET / HTTP/1.0\r\n\r\n")
        raw = await asyncio.wait_for(reader.read(), 5)
        writer.close()
    finally:
        act.cancel()
        await asyncio.gather(act, return_exceptions=True)
        await peer.close(drain_timeout=0.2)
        serve.cancel()
        await asyncio.gather(serve, return_exceptions=True)
        await coord.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.0 200 OK") and b"application/json" in head
    return json.loads(body)


def _shape(obj):
    """An object's keys at every level (a worker's under one name)."""
    if isinstance(obj, dict):
        if obj and all(k.isdigit() for k in obj):
            return {"<conn>": _shape(next(iter(obj.values())))}
        return {k: _shape(v) for k, v in obj.items()}
    return type(obj).__name__


def test_stats_snapshot_over_http_has_the_references_keys(tmp_path):
    want = run(_stats_over_http("ref", tmp_path))
    got = run(_stats_over_http("port", tmp_path))
    assert _shape(got) == _shape(want)
    assert set(got["stats"]) == set(want["stats"])
    for key in ("jobs_done", "results_accepted", "hashes", "chunks_requeued"):
        assert got["stats"][key] == want["stats"][key], key
    assert got["stats"]["jobs_done"] == 1 and got["stats"]["hashes"] == 4096
    assert (got["jobs_active"], got["audits_queued"], got["chunks_queued"]) == (0, 0, 0)

