"""The port's hashcore workload against the JAX package's.

``tpuminter_torch.workloads.compute`` on CPU lanes (the plain versions)
must give the ``WorkResult`` (payload bytes and ``searched``) that
``tpuminter.workloads.compute`` gives on its host lanes, for every
variant, a first-match early stop and a dry chunk included; the params
and fold codecs and the ``WorkResult``/``Join`` JSON must round-trip
with the reference; over real LSP on localhost the port worker must
advertise hashcore, refuse an unregistered workload, and settle a
hashcore job through an unchanged coordinator with the fold
``CpuMiner`` gives. The tolerance is exact equality.
"""

import asyncio
import dataclasses

import pytest
import torch

from tpuminter import protocol as ref
from tpuminter import workloads as ref_wl
from tpuminter.client import submit
from tpuminter.coordinator import Coordinator
from tpuminter.lsp import LspServer
from tpuminter.lsp import Params as RefParams
from tpuminter.worker import CpuMiner
from tpuminter.worker import run_miner as ref_run_miner
from tpuminter.workloads import folds as ref_folds
from tpuminter.workloads import hashcore as ref_hc
from tpuminter_torch import protocol as port
from tpuminter_torch import workloads
from tpuminter_torch.cuda_worker import CudaMiner
from tpuminter_torch.lsp import Params
from tpuminter_torch.worker import run_miner
from tpuminter_torch.workloads import folds
from tpuminter_torch.workloads import hashcore as hc

M64 = (1 << 64) - 1


@pytest.fixture(autouse=True)
def _host_lanes():
    """The reference's ground truth is its numpy host lanes; its device
    knob is process-global, so snapshot and restore it."""
    prior = ref_hc.set_dev_lanes("off")
    yield
    ref_hc.set_dev_lanes(prior["mode"], width=prior["width"], rows=prior["rows"],
                         engine=prior["engine"])


def _request(variant, seed, lo, hi, thr=0, k=1, job_id=1, chunk_id=0):
    return ref.Request(job_id, ref.PowMode.MIN, lo, hi, chunk_id=chunk_id,
                       data=ref_hc.pack_params(variant, seed, thr, k), workload="hashcore")


def _first_match_threshold(seed, lo, at):
    """A threshold whose first hit from ``lo`` lies in ``[lo, lo + at]``."""
    return min(ref_hc.objective(seed, i) for i in range(lo, lo + at + 1))


_SEED = 0x5EED_0000_C0FF_EE42
_LO = (1 << 32) - 5000  # chunks cross a 2^32 word boundary
CHUNKS = {
    "fmin": _request("fmin", _SEED, _LO, _LO + 20_000, chunk_id=4),
    "topk-1": _request("topk", 7, 0, 0, k=1),
    "topk-8": _request("topk", M64, _LO, _LO + 9_999, k=8),
    "topk-short": _request("topk", 3, M64 - 4, M64, k=8),  # fewer indices than k
    "fmatch-early": _request("fmatch", _SEED, _LO, _LO + 20_000,
                             thr=_first_match_threshold(_SEED, _LO, 6_000)),
    "fmatch-dry": _request("fmatch", _SEED, _LO, _LO + 3_000, thr=0),
    "fmatch-first": _request("fmatch", 1, 10, 4_000, thr=M64),  # every index matches
    "fsum": _request("fsum", M64, (1 << 63) - 17, (1 << 63) + 12_000),
}


def _one(gen):
    results = [r for r in gen if r is not None]
    assert len(results) == 1
    return results[0]


@pytest.mark.parametrize("name", list(CHUNKS))
def test_compute_equals_reference_host_lanes(name):
    req = CHUNKS[name]
    got = _one(workloads.compute(port.decode_msg(ref.encode_msg(req)), device="cpu"))
    want = _one(ref_wl.compute(req, engine="cpu"))
    assert isinstance(got, port.WorkResult)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if name == "fmatch-early":
        assert got.searched < req.upper - req.lower + 1  # it stopped early


def test_compute_on_cuda_without_a_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    req = port.decode_msg(ref.encode_msg(CHUNKS["fmin"]))
    with pytest.raises(RuntimeError):
        next(workloads.compute(req, device="cuda"))


@pytest.mark.parametrize("params", [("fmin", 0, 0, 1), ("topk", M64, 3, 8),
                                    ("fmatch", 12345, M64, 1), ("fsum", 1, 0, 4)])
def test_params_codec_equals_reference(params):
    data = ref_hc.pack_params(*params)
    assert hc.pack_params(*params) == data
    assert dataclasses.asdict(hc.parse_params(data)) == dataclasses.asdict(
        ref_hc.parse_params(data))
    for bad in (data[:-1], data[:-1] + bytes([data[-1] ^ 1]), b"\xc1" + data[1:]):
        with pytest.raises(ValueError):
            hc.parse_params(bad)


ACCS = [
    ("FMin", (), [None, [5, 9], [M64, M64]]),
    ("TopK", (3,), [[], [[1, 2]], [[0, 7], [0, 9], [M64, 1]]]),
    ("FirstMatch", (10,), [None, [None, None, 77], [4, 3, 5]]),
    ("FSum", (), [[0, 0], [(1 << 128) - 1, M64 - 1]]),
]


@pytest.mark.parametrize("fold_name,args,accs", ACCS, ids=[a[0] for a in ACCS])
def test_fold_codecs_and_combine_equal_reference(fold_name, args, accs):
    mine, theirs = getattr(folds, fold_name)(*args), getattr(ref_folds, fold_name)(*args)
    assert mine.initial() == theirs.initial()
    for acc in accs:
        assert mine.encode(acc) == theirs.encode(acc)
        assert mine.decode(theirs.encode(acc)) == theirs.decode(theirs.encode(acc))
        assert mine.is_final(acc) == theirs.is_final(acc)
        for other in accs:
            assert mine.combine(acc, other) == theirs.combine(acc, other)
    with pytest.raises(ValueError):
        mine.decode(theirs.encode(accs[-1])[:-1])


MESSAGES = [
    ref.WorkResult(job_id=3, chunk_id=5, wid=1, searched=1 << 33,
                   payload=ref_folds.TopK(2).encode([[1, 2], [3, 4]])),
    ref.WorkResult(job_id=1, chunk_id=0, wid=1, searched=0),
    ref.Join(backend="cuda", lanes=32768, span=1 << 27, roll=True, workloads=("hashcore",)),
]


@pytest.mark.parametrize("msg", MESSAGES, ids=lambda m: type(m).__name__)
def test_codec_round_trips_with_reference(msg):
    raw = ref.encode_msg(msg)
    mine = port.decode_msg(raw)
    assert type(mine).__name__ == type(msg).__name__
    assert dataclasses.asdict(mine) == dataclasses.asdict(msg)
    assert port.encode_msg(mine) == raw
    assert ref.decode_msg(port.encode_msg(mine)) == msg


# -- over real LSP on localhost ---------------------------------------------

_LSP = dict(epoch_limit=5, epoch_millis=50, window_size=32, max_backoff_interval=2,
            max_unacked_messages=32)


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, 60))


async def _stub_coordinator_exchange():
    """A bare LSP server speaking the reference codec: the port worker's
    Join, a Refuse for an unregistered workload's chunk, and a hashcore
    chunk's WorkResult."""
    server = await LspServer.create(params=RefParams(**_LSP))
    worker = asyncio.ensure_future(run_miner(
        "127.0.0.1", server.port, CudaMiner(device="cpu"), params=Params(**_LSP)))

    async def read():
        conn, raw = await server.read()
        return conn, ref.decode_msg(raw)

    try:
        conn, join = await read()
        unknown_job = ref.Request(2, ref.PowMode.MIN, 0, 99, data=b"\xc5", workload="nosuch")
        hc_job = _request("topk", 42, 0, 199_999, k=3, job_id=3)
        for msg in (ref.Setup(unknown_job), ref.Assign(2, 6, 0, 99), ref.Setup(hc_job),
                    ref.Assign(3, 7, 1000, 150_000)):
            server.write(conn, ref.encode_msg(msg))
        replies = [(await read())[1] for _ in range(2)]
        return join, replies
    finally:
        worker.cancel()
        await asyncio.gather(worker, return_exceptions=True)
        await server.close()


def test_worker_advertises_hashcore_refuses_unregistered_and_answers_chunks():
    join, (refuse, result) = _run(_stub_coordinator_exchange())
    assert join.workloads == ("dict", "hashcore")
    assert refuse == ref.Refuse(job_id=2, chunk_id=6)
    chunk = dataclasses.replace(_request("topk", 42, 1000, 150_000, k=3, job_id=3),
                                chunk_id=7)
    assert result == _one(ref_wl.compute(chunk, engine="cpu"))


async def _through_coordinator(request, start_worker):
    coord = await Coordinator.create(params=RefParams(**_LSP), chunk_size=4096)
    serve = asyncio.ensure_future(coord.serve())
    worker = asyncio.ensure_future(start_worker(coord.port))
    try:
        await asyncio.sleep(0.05)  # let the Join land first
        res = await submit("127.0.0.1", coord.port, request, params=RefParams(**_LSP))
        return res, dict(coord.stats)
    finally:
        worker.cancel()
        serve.cancel()
        await asyncio.gather(worker, serve, return_exceptions=True)
        await coord.close()


@pytest.mark.parametrize("variant,thr,k", [("topk", 0, 3), ("fmatch", 1 << 52, 1)])
def test_lsp_hashcore_job_matches_cpu_miner(variant, thr, k):
    req = _request(variant, 42, 0, 30_000, thr=thr, k=k)
    got, stats = _run(_through_coordinator(req, lambda p: run_miner(
        "127.0.0.1", p, CudaMiner(device="cpu"), params=Params(**_LSP))))
    want, _ = _run(_through_coordinator(req, lambda p: ref_run_miner(
        "127.0.0.1", p, CpuMiner(), params=RefParams(**_LSP))))
    assert isinstance(got, ref.WorkResult)
    fold = ref_wl.fold_of(req)
    assert fold.decode(got.payload) == fold.decode(want.payload)
    assert stats["results_rejected"] == 0
    if variant == "topk":
        pairs = sorted((ref_hc.objective(42, i), i) for i in range(30_001))[:k]
        assert fold.decode(got.payload) == [list(p) for p in pairs]
