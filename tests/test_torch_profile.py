"""The port worker's ``--profile DIR``: ``ProfiledMiner`` on
``torch.profiler``, held to the reference's window and contract.

On the CPU's plain versions (``CudaMiner(device="cpu")``, CPU activity
only): a trace file is written into DIR and holds the window's ops; the
wrapped miner's Result equals the unwrapped one's; a Cancel inside the
window (the generator abandoned), followed by the next chunk's
``mine()``, closes the trace; ``close()`` at shutdown closes an open
trace and calls the inner ``close()``; an exception inside the window
closes it and re-raises. Through an unchanged coordinator, every
generator step of a ``run_miner`` session and the miner's ``close`` run
on one thread that is not the event loop's, which is what lets
``torch.profiler``, a per-thread recorder, start and stop its trace.
"""

import asyncio
import dataclasses
import json
import threading

import pytest

from tpuminter import protocol as ref
from tpuminter.client import submit
from tpuminter.coordinator import Coordinator
from tpuminter.lsp import Params as RefParams
from tpuminter_torch import protocol as port
from tpuminter_torch.cuda_worker import CudaMiner
from tpuminter_torch.lsp import Params
from tpuminter_torch.worker import Miner, ProfiledMiner, run_miner

_LSP = dict(epoch_limit=5, epoch_millis=50, window_size=32, max_backoff_interval=2,
            max_unacked_messages=32)
#: four slabs of 1024 nonces: steps 1-4, then the Result
MIN_REQ = port.Request(4, port.PowMode.MIN, 0, 4095, data=b"hello bitcoin", chunk_id=3)


def _miner():
    return CudaMiner(device="cpu", slab=1024)


def _drain(gen):
    results = [r for r in gen if r is not None]
    assert len(results) == 1
    return results[0]


def _events(path):
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


class _Closing(Miner):
    """Yields ``steps`` Nones then a Result, or raises at step ``fail``;
    records its close."""

    backend, device = "cpu", "cpu"

    def __init__(self, steps=4, fail=None):
        self.steps, self.fail, self.closed = steps, fail, 0

    def mine(self, request):
        for step in range(1, self.steps + 1):
            if step == self.fail:
                raise RuntimeError("boom")
            yield None
        yield port.Result(request.job_id, request.mode, 0, 0)

    def close(self):
        self.closed += 1


def test_trace_written_and_result_unchanged(tmp_path):
    prof, plain = ProfiledMiner(_miner(), str(tmp_path)), _miner()
    assert (prof.backend, prof.lanes, prof.span, prof.device) == (
        plain.backend, plain.lanes, plain.span, plain.device)
    got = _drain(prof.mine(MIN_REQ))
    assert got == _drain(plain.mine(MIN_REQ))
    files = list(tmp_path.iterdir())
    assert [str(f) for f in files] == [prof.trace_path]
    names = {e.get("name", "") for e in _events(prof.trace_path)}
    assert any(n.startswith("aten::") for n in names)  # the window's plain-version ops
    # one trace a worker: the next chunk is not traced
    assert _drain(prof.mine(dataclasses.replace(MIN_REQ, job_id=5))).job_id == 5
    assert len(list(tmp_path.iterdir())) == 1


def test_chunk_without_a_step_leaves_the_window_to_the_next(tmp_path):
    """A chunk that yields its Result at once opens no trace."""
    inner = _Closing(steps=0)
    prof = ProfiledMiner(inner, str(tmp_path))
    _drain(prof.mine(MIN_REQ))
    assert prof.trace_path is None and not list(tmp_path.iterdir())
    inner.steps = 1  # ends inside the window: the trace closes before the Result
    gen = prof.mine(MIN_REQ)
    assert next(gen) is None and prof.trace_path is None
    assert next(gen) is not None and prof.trace_path is not None


def test_cancel_inside_window_is_closed_by_the_next_mine(tmp_path):
    prof = ProfiledMiner(_miner(), str(tmp_path))
    gen = prof.mine(MIN_REQ)
    assert next(gen) is None and next(gen) is None  # steps 1 and 2: inside the window
    assert prof.trace_path is None
    del gen  # abandoned, as the role loop abandons a cancelled chunk
    nxt = prof.mine(dataclasses.replace(MIN_REQ, job_id=6))
    assert prof.trace_path is None  # a generator's body runs at its first step
    assert next(nxt) is None
    assert prof.trace_path is not None and _events(prof.trace_path)
    assert _drain(nxt).job_id == 6


def test_close_at_shutdown_writes_an_open_trace_and_closes_the_inner(tmp_path):
    inner = _Closing()
    prof = ProfiledMiner(inner, str(tmp_path))
    gen = prof.mine(MIN_REQ)
    next(gen), next(gen)
    prof.close()
    assert prof.trace_path is not None and inner.closed == 1
    prof.close()  # nothing left open: only the inner close again
    assert inner.closed == 2 and len(list(tmp_path.iterdir())) == 1


def test_exception_inside_window_closes_and_reraises(tmp_path):
    prof = ProfiledMiner(_Closing(fail=2), str(tmp_path))
    with pytest.raises(RuntimeError, match="boom"):
        _drain(prof.mine(MIN_REQ))
    assert prof.trace_path is not None and _events(prof.trace_path)


class _Threads(Miner):
    """Records the thread each generator step and ``close`` runs on."""

    def __init__(self, inner):
        self.inner, self.threads, self.closed_on = inner, [], None
        self.backend, self.lanes, self.span, self.device = (
            inner.backend, inner.lanes, inner.span, inner.device)

    def mine(self, request):
        for item in self.inner.mine(request):
            self.threads.append(threading.get_ident())
            yield item

    def close(self):
        self.closed_on = threading.get_ident()


def test_role_loop_runs_a_session_on_one_thread(tmp_path):
    """Two chunks through an unchanged coordinator: every step and the
    close on one thread, not the loop's; the trace started and stopped
    there holds the window's ops."""
    threads = _Threads(_miner())
    prof = ProfiledMiner(threads, str(tmp_path))
    req = ref.Request(7, ref.PowMode.MIN, 0, 8191, data=b"two chunks")

    async def scenario():
        coord = await Coordinator.create(params=RefParams(**_LSP), chunk_size=4096)
        serve = asyncio.ensure_future(coord.serve())
        worker = asyncio.ensure_future(run_miner("127.0.0.1", coord.port, prof,
                                                 params=Params(**_LSP)))
        loop_thread = threading.get_ident()
        try:
            await asyncio.sleep(0.05)
            result = await submit("127.0.0.1", coord.port, req, params=RefParams(**_LSP))
        finally:
            serve.cancel()
            await asyncio.gather(serve, return_exceptions=True)
            await coord.close()
            await asyncio.wait_for(worker, 10)  # the session ends with its coordinator
        return result, loop_thread

    result, loop_thread = asyncio.run(asyncio.wait_for(scenario(), 60))
    assert result.found and result.searched == 8192
    assert len(threads.threads) >= 10 and len(set(threads.threads)) == 1
    assert threads.closed_on == threads.threads[0] != loop_thread
    names = {e.get("name", "") for e in _events(prof.trace_path)}
    assert any(n.startswith("aten::") for n in names)
