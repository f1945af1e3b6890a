"""The port's dict workload (``tpuminter_torch.workloads.dictsearch``)
against the reference's ``tpuminter.workloads.dictsearch``: the params
codec byte for byte, the folds' host ``of_batch``, each variant's chunk
through ``workloads.compute`` equal to the reference's WorkResult (on a
window Setup cut from a catalog above the reference's 32 KiB window, and
on a ragged tail), and one dict job through an unchanged coordinator
that only a port worker, whose Join names ``dict,hashcore``, answers.
"""

import asyncio
import dataclasses
import logging
import random

import pytest

from tpuminter import protocol as ref
from tpuminter import workloads as ref_wl
from tpuminter.client import submit
from tpuminter.coordinator import Coordinator
from tpuminter.lsp import Params as RefParams
from tpuminter.workloads import dictsearch as ref_ds
from tpuminter.workloads import folds as ref_folds
from tpuminter_torch import protocol as port
from tpuminter_torch import workloads
from tpuminter_torch.cuda_worker import CudaMiner
from tpuminter_torch.lsp import Params
from tpuminter_torch.worker import run_miner
from tpuminter_torch.workloads import dictsearch as ds
from tpuminter_torch.workloads import folds

M64 = (1 << 64) - 1
SEED = 0xD1C7_5EED_0042


def _catalog(n, seed=1):
    rng = random.Random(seed)
    return [b"cand-%06d-" % i + rng.randbytes(rng.randrange(0, 24)) for i in range(n)]


#: a catalog past the reference's window budget: its chunks ride window Setups
CATALOG = _catalog(2500)
assert len(ref_ds.pack_params("fmin", SEED, CATALOG)) > ref_ds.WINDOW_BYTES


def _first_hit_threshold(entries, lo, at):
    """A threshold whose first hit from ``lo`` lies in ``[lo, lo + at]``."""
    return min(ref_ds.score(SEED, entries[i]) for i in range(lo, lo + at + 1))


def _job(variant, thr=0, k=1, entries=CATALOG):
    return ref.Request(1, ref.PowMode.MIN, 0, len(entries) - 1, workload="dict",
                       data=ref_ds.pack_params(variant, SEED, entries, threshold=thr, k=k))


def _window_chunk(job, lo, hi, chunk_id=3):
    """The chunk Request a worker receives: the coordinator's window frame
    (or the whole job's, below the window budget) over ``[lo, hi]``."""
    data = ref_ds.DictSearch().window(job, lo, hi) or job.data
    return dataclasses.replace(job, lower=lo, upper=hi, chunk_id=chunk_id, data=data)


_TAIL = len(CATALOG) - 700  # ragged: 700 entries, not a whole number of batches
CHUNKS = {
    "fmin-window": _window_chunk(_job("fmin"), 300, 1299),
    "topk-window": _window_chunk(_job("topk", k=8), 1000, 1999),
    "fmatch-early": _window_chunk(
        _job("fmatch", thr=_first_hit_threshold(CATALOG, 500, 400)), 500, 1499),
    "fmatch-dry": _window_chunk(_job("fmatch", thr=0), 100, 612),
    "fsum-tail": _window_chunk(_job("fsum"), _TAIL, len(CATALOG) - 1),
    "topk-tail": _window_chunk(_job("topk", k=5), _TAIL, len(CATALOG) - 1),
    "fmin-whole": _window_chunk(_job("fmin", entries=CATALOG[:40]), 0, 39),
}


def _one(gen):
    results = [r for r in gen if r is not None]
    assert len(results) == 1
    return results[0]


@pytest.mark.parametrize("name", list(CHUNKS))
def test_compute_equals_reference(name):
    req = CHUNKS[name]
    got = _one(workloads.compute(port.decode_msg(ref.encode_msg(req)), device="cpu"))
    want = _one(ref_wl.compute(req, engine="cpu"))
    assert isinstance(got, port.WorkResult)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if name == "fmatch-early":
        assert got.searched < req.upper - req.lower + 1  # it stopped at its batch
    if name.endswith("window"):
        assert ds.parse_params(req.data).base == req.lower  # a window frame


def test_fold_refuses_a_range_outside_the_shipped_entries():
    req = port.decode_msg(ref.encode_msg(CHUNKS["fmin-window"]))
    for lo, hi in ((req.lower - 1, req.upper), (req.lower, req.upper + 1)):
        with pytest.raises(ValueError):
            workloads.get("dict").fold_for(dataclasses.replace(req, lower=lo, upper=hi))


@pytest.mark.parametrize("args", [
    ("fmin", 0, [b""], 0, 1, 0),
    ("topk", M64, [b"a", b"bc" * 100, bytes(512)], 7, 8, 0),
    ("fmatch", 12345, CATALOG[:50], M64, 1, 1 << 40),
    ("fsum", 1, [bytes([i]) * i for i in range(1, 60)], 0, 3, 2 ** 63),
])
def test_params_codec_byte_equal_both_ways(args):
    variant, seed, entries, thr, k, base = args
    data = ref_ds.pack_params(variant, seed, entries, threshold=thr, k=k, base=base)
    assert ds.pack_params(variant, seed, entries, threshold=thr, k=k, base=base) == data
    assert dataclasses.asdict(ds.parse_params(data)) == dataclasses.asdict(
        ref_ds.parse_params(data))
    assert ref_ds.parse_params(ds.pack_params(variant, seed, entries, thr, k, base)).entries \
        == tuple(entries)
    for bad in (data[:-1], data[:-1] + bytes([data[-1] ^ 1]), b"\xc0" + data[1:],
                data[:20] + data[-4:]):
        with pytest.raises(ValueError):
            ds.parse_params(bad)
    for bad_args in (("nope", seed, entries), (variant, -1, entries), (variant, seed, []),
                     (variant, seed, [bytes(ds.MAX_ENTRY + 1)])):
        with pytest.raises(ValueError):
            ds.pack_params(*bad_args)


@pytest.mark.parametrize("seed", range(6))
def test_of_batch_equals_reference_with_ties(seed):
    rng = random.Random(seed)
    for _ in range(40):
        n = rng.randrange(0, 40)
        values = [rng.randrange(0, 6) for _ in range(n)]  # many ties
        index0 = rng.choice([0, 5, (1 << 40) + 3])
        thr = rng.randrange(0, 6)
        for mine, theirs in ((folds.FMin(), ref_folds.FMin()),
                             (folds.TopK(rng.randrange(1, 9)), None),
                             (folds.FirstMatch(thr), ref_folds.FirstMatch(thr)),
                             (folds.FSum(), ref_folds.FSum())):
            theirs = theirs or ref_folds.TopK(mine.k)
            assert mine.of_batch(index0, values) == theirs.of_batch(index0, values)


def test_score_equals_reference():
    for seed in (0, 1, M64, SEED):
        for cand in (b"", b"x", CATALOG[7], bytes(range(256)) * 2):
            assert ds.score(seed, cand) == ref_ds.score(seed, cand)


# -- over real LSP on localhost ---------------------------------------------

_LSP = dict(epoch_limit=5, epoch_millis=50, window_size=32, max_backoff_interval=2,
            max_unacked_messages=32)


async def _dict_job_through_coordinator(request):
    coord = await Coordinator.create(params=RefParams(**_LSP), chunk_size=512)
    serve = asyncio.ensure_future(coord.serve())
    worker = asyncio.ensure_future(run_miner(
        "127.0.0.1", coord.port, CudaMiner(device="cpu"), params=Params(**_LSP)))
    try:
        await asyncio.sleep(0.05)  # let the Join land first
        res = await submit("127.0.0.1", coord.port, request, params=RefParams(**_LSP))
        return res, dict(coord.stats)
    finally:
        worker.cancel()
        serve.cancel()
        await asyncio.gather(worker, serve, return_exceptions=True)
        await coord.close()


def test_lsp_dict_job_answered_by_a_port_worker(caplog):
    caplog.set_level(logging.INFO)
    entries = CATALOG[:1500]
    req = _job("topk", k=3, entries=entries)
    got, stats = asyncio.run(asyncio.wait_for(_dict_job_through_coordinator(req), 60))
    assert isinstance(got, ref.WorkResult)
    assert got.searched == len(entries)
    want = sorted([ref_ds.score(SEED, c), i] for i, c in enumerate(entries))[:3]
    assert ref_wl.fold_of(req).decode(got.payload) == want
    assert stats["results_rejected"] == 0
    joins = [r.getMessage() for r in caplog.records if "joined (backend=cuda" in r.getMessage()]
    assert joins and joins[0].endswith("workloads=dict,hashcore)")
