"""The port's worker role against the JAX package's.

``CudaMiner(device="cpu")`` (the kernels' plain versions) must return
the Results ``JaxMiner`` and ``CpuMiner`` return; the port's JSON codec
must round-trip with ``tpuminter.protocol``; and over real LSP on
localhost, an unchanged ``tpuminter`` coordinator and client must get
the same answer from the port's ``run_miner`` as from ``CpuMiner``.
"""

import asyncio
import dataclasses

import pytest

from tpuminter import chain as ref_chain
from tpuminter import protocol as ref
from tpuminter.client import submit
from tpuminter.coordinator import Coordinator
from tpuminter.jax_worker import JaxMiner
from tpuminter.lsp import Params as RefParams
from tpuminter.worker import CpuMiner
from tpuminter.worker import run_miner as ref_run_miner
from tpuminter_torch import protocol as port
from tpuminter_torch.cuda_worker import CudaMiner
from tpuminter_torch.lsp import Params
from tpuminter_torch.worker import run_miner

GENESIS = ref_chain.GENESIS_HEADER
N = 2083236893
TARGET = ref_chain.bits_to_target(GENESIS.bits)
REGTEST_BITS = 0x207FFFFF
REGTEST = GENESIS.pack()[:72] + REGTEST_BITS.to_bytes(4, "little") + b"\0" * 4

REQUESTS = {
    "genesis-fast": ref.Request(1, ref.PowMode.TARGET, N - 1000, N + 3095,
                                header=GENESIS.pack(), target=TARGET, chunk_id=3),
    "regtest-tracking": ref.Request(2, ref.PowMode.TARGET, 0, 4095, header=REGTEST,
                                    target=ref_chain.bits_to_target(REGTEST_BITS)),
    "exact-min-exhausted": ref.Request(3, ref.PowMode.TARGET, N - 5000, N - 1001,
                                       header=GENESIS.pack(), target=TARGET),
    "min": ref.Request(4, ref.PowMode.MIN, 0, 4095, data=b"hello bitcoin"),
    "min-carry": ref.Request(5, ref.PowMode.MIN, (1 << 32) - 2048, (1 << 32) + 2047,
                             data=bytes(range(60))),
}


def _port_request(req: ref.Request) -> port.Request:
    return port.decode_msg(ref.encode_msg(req))


def _fields(result):
    """A Result of either package as plain values."""
    return (result.job_id, result.mode.value, result.nonce, result.hash_value,
            result.found, result.searched, result.chunk_id)


def _one(gen):
    results = [r for r in gen if r is not None]
    assert len(results) == 1
    return results[0]


@pytest.mark.parametrize("name", list(REQUESTS))
def test_cuda_miner_on_cpu_matches_jax_and_cpu_miners(name):
    req = REQUESTS[name]
    exact = name == "exact-min-exhausted"
    got = _one(CudaMiner(device="cpu", exact_min=exact).mine(_port_request(req)))
    want_cpu = _one(CpuMiner().mine(req))
    want_jax = _one(JaxMiner(batch=4096).mine(req))
    assert _fields(got) == _fields(want_cpu) == _fields(want_jax)


def test_fast_path_exhausted_reports_min_untracked():
    req = REQUESTS["exact-min-exhausted"]
    got = _one(CudaMiner(device="cpu").mine(_port_request(req)))
    assert (got.nonce, got.hash_value, got.found, got.searched) == (
        req.lower, port.MIN_UNTRACKED, False, req.upper - req.lower + 1)
    assert port.MIN_UNTRACKED == ref.MIN_UNTRACKED


def test_cuda_miner_refuses_what_it_does_not_serve():
    miner = CudaMiner(device="cpu")
    rolled = port.Request(6, port.PowMode.TARGET, 0, 255, header=GENESIS.pack(),
                          target=TARGET, coinbase_prefix=b"\x01", nonce_bits=4)
    scrypt = port.Request(7, port.PowMode.SCRYPT, 0, 255, header=GENESIS.pack(),
                          target=TARGET)
    workload = port.Request(8, port.PowMode.MIN, 0, 255, data=b"x", workload="nosuch")
    assert miner.unsupported(workload)
    with pytest.raises(NotImplementedError):
        next(miner.mine(workload))
    assert miner.unsupported(rolled) is None  # rolled jobs are served
    assert miner.unsupported(scrypt) is None  # and SCRYPT jobs
    assert miner.unsupported(_port_request(REQUESTS["min"])) is None


_SETUP_REQ = ref.Request(9, ref.PowMode.TARGET, 0, (4 << 32) - 1, header=GENESIS.pack(),
                         target=TARGET, coinbase_prefix=b"\xab", coinbase_suffix=b"\xcd",
                         extranonce_size=2, branch=(b"\x11" * 32,), nonce_bits=32,
                         client_key="k", chunk_id=2)
MESSAGES = [
    ref.Join(backend="cuda", lanes=32768, span=1 << 27),
    ref.Setup(_SETUP_REQ),
    ref.Setup(REQUESTS["min"]),
    ref.Assign(job_id=9, chunk_id=4, lower=5, upper=1 << 40),
    ref.Result(1, ref.PowMode.TARGET, N, ref.MIN_UNTRACKED, found=False, searched=7,
               chunk_id=3),
    ref.Result(2, ref.PowMode.MIN, 3, 12345, found=True, searched=4096),
    ref.Refuse(job_id=9, chunk_id=4),
    ref.Cancel(job_id=9),
]


@pytest.mark.parametrize("msg", MESSAGES, ids=lambda m: type(m).__name__)
def test_codec_round_trips_with_reference(msg):
    raw = ref.encode_msg(msg)
    mine = port.decode_msg(raw)
    assert type(mine).__name__ == type(msg).__name__
    assert dataclasses.asdict(mine) == dataclasses.asdict(msg)
    assert port.encode_msg(mine) == raw
    assert ref.decode_msg(port.encode_msg(mine)) == msg


def test_codec_drops_what_a_json_worker_never_receives():
    """A kind no role has raises; the replication hello, which the
    port's standby and coordinator decode (the latter to reject it), a
    Steal, which the port's coordinator decodes to deny it, and a binary
    Assign, which a worker that advertises the binary codec receives,
    decode equal to the reference's."""
    with pytest.raises(port.ProtocolError):
        port.decode_msg(b'{"kind":"nosuch","epoch":1}')
    raw = ref.encode_msg(ref.RepHello(epoch=1))
    assert dataclasses.asdict(port.decode_msg(raw)) == dataclasses.asdict(ref.decode_msg(raw))
    raw = ref.encode_msg(ref.Steal(job_id=1))
    assert dataclasses.asdict(port.decode_msg(raw)) == dataclasses.asdict(ref.decode_msg(raw))
    raw = ref.encode_msg(ref.Assign(1, 2, 3, 4), binary=True)
    assert dataclasses.asdict(port.decode_msg(raw)) == dataclasses.asdict(ref.decode_msg(raw))


# -- over real LSP on localhost ---------------------------------------------

_LSP = dict(epoch_limit=5, epoch_millis=50, window_size=32, max_backoff_interval=2,
            max_unacked_messages=32)


async def _through_coordinator(request, start_worker):
    coord = await Coordinator.create(params=RefParams(**_LSP), chunk_size=4096)
    serve = asyncio.ensure_future(coord.serve())
    worker = asyncio.ensure_future(start_worker(coord.port))
    try:
        await asyncio.sleep(0.05)  # let the Join land first
        return await submit("127.0.0.1", coord.port, request, params=RefParams(**_LSP))
    finally:
        worker.cancel()
        serve.cancel()
        await asyncio.gather(worker, serve, return_exceptions=True)
        await coord.close()


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, 60))


@pytest.mark.parametrize("name", ["genesis-fast", "min"])
def test_lsp_end_to_end_matches_cpu_miner(name):
    req = dataclasses.replace(REQUESTS[name], chunk_id=0)
    got = _run(_through_coordinator(req, lambda p: run_miner(
        "127.0.0.1", p, CudaMiner(device="cpu"), params=Params(**_LSP))))
    want = _run(_through_coordinator(req, lambda p: ref_run_miner(
        "127.0.0.1", p, CpuMiner(), params=RefParams(**_LSP))))
    assert (got.job_id, got.nonce, got.hash_value, got.found) == (
        want.job_id, want.nonce, want.hash_value, want.found)
    assert got.found
