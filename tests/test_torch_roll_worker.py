"""The port's roll dialect on the wire, against the JAX package's.

``RollAssign`` and ``Beacon`` must round-trip between the two JSON
codecs, and over real LSP on localhost an unchanged ``tpuminter``
coordinator with a roll budget must send the port's ``run_miner``
``RollAssign`` chunks, accept its ``Beacon``s and settle the job with
the Result ``CpuMiner`` gives. The targets are toy-easy (above 2^224),
so the port mines on its tracking path, which reports exact minima.
"""

import asyncio
import dataclasses

import pytest

from tests.test_extranonce import fixture
from tpuminter import chain as ref_chain
from tpuminter import protocol as ref
from tpuminter.client import submit
from tpuminter.coordinator import Coordinator
from tpuminter.lsp import Params as RefParams
from tpuminter_torch import protocol as port
from tpuminter_torch.cuda_worker import CudaMiner
from tpuminter_torch.lsp import Params
from tpuminter_torch.worker import run_miner

NB = 10  # nonce bits: a segment is 1024 nonces, so the sweep rolls often

MESSAGES = [
    ref.RollAssign(job_id=3, chunk_id=8, extranonce0=5, count=2),
    ref.RollAssign(job_id=3, chunk_id=9, extranonce0=(1 << 40) + 1, count=7, lease_epoch=4),
    ref.Beacon(3, 8, (5 << 32) + 77, (5 << 32) + 12, ref.MIN_UNTRACKED),
    ref.Beacon(3, 9, 1 << 35, 99, 12345, lease_epoch=2),
    ref.Join(backend="cuda", lanes=32768, span=1 << 27, roll=True),
]


@pytest.mark.parametrize("msg", MESSAGES, ids=lambda m: type(m).__name__)
def test_roll_dialect_round_trips_with_reference(msg):
    raw = ref.encode_msg(msg)
    mine = port.decode_msg(raw)
    assert type(mine).__name__ == type(msg).__name__
    assert dataclasses.asdict(mine) == dataclasses.asdict(msg)
    assert port.encode_msg(mine) == raw
    assert ref.decode_msg(port.encode_msg(mine)) == msg


def test_roll_assign_with_no_extranonce_is_malformed():
    with pytest.raises(port.ProtocolError):
        port.decode_msg(b'{"kind":"rassign","job_id":1,"chunk_id":2,"e0":0,"count":0}')


_LSP = dict(epoch_limit=5, epoch_millis=50, window_size=32, max_backoff_interval=2,
            max_unacked_messages=32)


def _brute_min(ens):
    prefix, suffix, branch, hdr80 = fixture()
    cb = ref_chain.CoinbaseTemplate(prefix, suffix, 4)
    pairs = []
    for en in range(ens):
        p76 = ref_chain.rolled_header(hdr80, cb, branch, en).pack()[:76]
        pairs += [(ref_chain.hash_to_int(ref_chain.dsha256(p76 + n.to_bytes(4, "little"))),
                   (en << NB) | n) for n in range(1 << NB)]
    return min(pairs)


def _request(ens, target):
    prefix, suffix, branch, hdr80 = fixture()
    return ref.Request(1, ref.PowMode.TARGET, 0, (ens << NB) - 1, header=hdr80,
                       target=target, coinbase_prefix=prefix, coinbase_suffix=suffix,
                       extranonce_size=4, branch=tuple(branch), nonce_bits=NB)


async def _cluster(req, *, roll):
    coord = await Coordinator.create(params=RefParams(**_LSP), chunk_size=1024,
                                     roll_budget=8)
    serve = asyncio.ensure_future(coord.serve())
    worker = asyncio.ensure_future(run_miner(
        "127.0.0.1", coord.port, CudaMiner(device="cpu"), params=Params(**_LSP),
        roll=roll, beacon_interval=1e-6,
    ))
    try:
        await asyncio.sleep(0.05)  # let the Join land first
        res = await submit("127.0.0.1", coord.port, req, params=RefParams(**_LSP))
        return res, dict(coord.stats)
    finally:
        worker.cancel()
        serve.cancel()
        await asyncio.gather(worker, serve, return_exceptions=True)
        await coord.close()


@pytest.mark.parametrize("roll", [True, False], ids=["roll", "no-roll"])
def test_budgeted_coordinator_settles_port_worker_rolled_job(roll):
    ens = 8
    h_min, g_min = _brute_min(ens)
    assert h_min - 1 >= 1 << 224  # a toy-easy target: the tracking path
    req = _request(ens, h_min - 1)  # just misses: exhaust, report the minimum
    res, stats = asyncio.run(asyncio.wait_for(_cluster(req, roll=roll), 60))
    assert (res.found, res.hash_value, res.nonce) == (False, h_min, g_min)
    assert stats["hashes"] == ens << NB
    assert stats["results_rejected"] == 0
    if roll:
        assert stats["chunks_roll_dispatched"] > 0
        assert stats["beacons_accepted"] > 0
    else:
        assert stats["chunks_roll_dispatched"] == 0
        assert stats["beacons_accepted"] == 0
