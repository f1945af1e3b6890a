"""The port's client CLI held to the reference's.

For each dialect's flags both CLIs must build the same ``Request`` (and
the same redial settings) and print the same answer for the same
Result; both must refuse the same bad command lines. ``--stream``
against the reference's coordinator must print the reference client's
``Partial`` lines for the stream it receives.
"""

import asyncio
import threading

import pytest

from tpuminter import chain as ref_chain
from tpuminter import client as ref_client
from tpuminter import protocol as ref
from tpuminter import workloads as ref_workloads
from tpuminter.coordinator import Coordinator as RefCoordinator
from tpuminter.lsp import Params as RefParams
from tpuminter.worker import CpuMiner
from tpuminter.worker import run_miner as ref_run_miner
from tpuminter.workloads import hashcore as ref_hc
from tpuminter_torch import client as port_client
from tpuminter_torch import protocol as port

HDR = ref_chain.GENESIS_HEADER.pack().hex()
BRANCH = "ab" * 32

#: a canned accumulator of each fold, for the answer a CLI renders
_ACCS = {"fmin": [3, 4], "topk": [[1, 9], [2, 5]], "fmatch": [7, 1, 8], "fsum": [99, 3]}


def _canned(request, mod):
    """The answer a fake submit returns, in ``mod``'s own types."""
    if request.workload:
        fold = ref_workloads.fold_of(ref.decode_msg(mod.encode_msg(request)))
        return mod.WorkResult(request.job_id, 0, ref_workloads.get(request.workload).wid, 1234,
                              fold.encode(_ACCS[fold.name]))
    nonce = (2 << request.nonce_bits) | 77 if request.rolled else 77
    return mod.Result(request.job_id, request.mode, nonce, 0xBEEF, True, searched=500)


def _run_cli(cli, mod, argv, monkeypatch, capsys):
    seen = {}

    async def fake_submit(host, port_no, request, **kwargs):
        seen.update(request=mod.encode_msg(request), host=(host, port_no),
                    **{k: kwargs.get(k) for k in ("client_key", "reconnect", "addrs")})
        return _canned(request, mod)

    monkeypatch.setattr(cli, "submit", fake_submit)
    cli.main(argv)
    return seen, capsys.readouterr().out


@pytest.fixture
def words(tmp_path):
    path = tmp_path / "words.txt"
    path.write_bytes(b"".join(b"cand-%04d\n" % i for i in range(50)))
    return str(path)


CASES = {
    "toy": ["127.0.0.1:9", "hello bitcoin", "1000"],
    "toy-list": ["--coordinator", "h:1,h:2", "--reconnect", "msg", "77"],
    "toy-key": ["h:1", "msg", "10", "--client-key", "abc", "--timeout", "5"],
    "target": ["h:1", "--header", HDR, "--bits", "0x1d00ffff", "--max-nonce", "5000"],
    "scrypt": ["h:1", "--header", HDR, "--scrypt", "--max-nonce", "100"],
    "rolled": ["h:1", "--header", HDR, "--coinbase-prefix", "00ff", "--coinbase-suffix", "ee",
               "--branch", BRANCH, "--extranonce-size", "1", "--max-extranonce", "3"],
    "hashcore-topk": ["h:1", "--workload", "hashcore", "--variant", "topk", "--k", "3",
                      "--seed", "42", "--max-nonce", "99999"],
    "hashcore-fmatch": ["h:1", "--workload", "hashcore", "--variant", "fmatch",
                        "--threshold", "0x1000"],
    "hashcore-params": ["h:1", "--workload", "hashcore", "--params",
                        ref_hc.pack_params("fmin", 5).hex(), "--max-nonce", "10"],
    "dict": ["h:1", "--workload", "dict", "--variant", "fsum", "--candidates", "WORDS"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_builds_the_references_request_and_prints_its_answer(case, words, monkeypatch,
                                                                 capsys):
    argv = [words if a == "WORDS" else a for a in CASES[case]]
    got, got_out = _run_cli(port_client, port, argv, monkeypatch, capsys)
    want, want_out = _run_cli(ref_client, ref, argv, monkeypatch, capsys)
    assert got == want
    assert got_out == want_out and got_out.startswith("Result")


REFUSED = [
    [], ["h:1"], ["h:1,h:2", "m", "1"], ["h:1", "--workload", "dict"],
    ["h:1", "--stream", "m", "5"], ["h:1", "--header", "zz"], ["h:1", "m", "x"],
    ["h:1", "--header", HDR, "--coinbase-prefix", "00", "--max-nonce", "5"],
    ["h:1", "--header", HDR, "--coinbase-prefix", "00", "--extranonce-size", "9"],
    ["h:1", "--workload", "hashcore", "--k", "9"], ["h:1", "m", "5", "--timeout", "0"],
]


@pytest.mark.parametrize("argv", REFUSED, ids=lambda a: " ".join(a) or "empty")
def test_cli_refuses_what_the_reference_refuses(argv, capsys):
    errors = []
    for cli in (port_client, ref_client):
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ")[1])
    assert errors[0] == errors[1]


def test_stream_prints_the_references_partial_lines(words, monkeypatch, capsys):
    """The port's client against the reference's coordinator: it prints
    a Partial line for each Emit of rising coverage, and the reference's
    client, fed the same Emits and Result, prints the same lines."""
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    params = RefParams(epoch_limit=5, epoch_millis=50, window_size=32, max_backoff_interval=2,
                       max_unacked_messages=32)

    async def start():
        coord = await RefCoordinator.create(params=params, chunk_size=5, emit_interval=0,
                                            pipeline_depth=1)
        tasks = [asyncio.ensure_future(coord.serve()),
                 asyncio.ensure_future(ref_run_miner("127.0.0.1", coord.port, CpuMiner(),
                                                     params=params))]
        await asyncio.sleep(0.05)
        return coord, tasks

    async def stop(coord, tasks):
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        coord.crash()

    coord, tasks = asyncio.run_coroutine_threadsafe(start(), loop).result(10)
    argv = [f"127.0.0.1:{coord.port}", "--workload", "dict", "--variant", "topk", "--k", "3",
            "--seed", "42", "--candidates", words, "--stream", "--timeout", "30"]
    seen = {}
    real_submit = port_client.submit

    async def spy(*args, on_emit=None, **kwargs):
        emits = seen.setdefault("emits", [])

        def hook(emit):
            emits.append(emit)
            on_emit(emit)

        seen["result"] = await real_submit(*args, on_emit=hook, **kwargs)
        return seen["result"]

    try:
        monkeypatch.setattr(port_client, "submit", spy)
        port_client.main(argv)
        got = capsys.readouterr().out
    finally:
        asyncio.run_coroutine_threadsafe(stop(coord, tasks), loop).result(10)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)

    def to_ref(msg):
        return ref.decode_msg(port.encode_msg(msg, binary=True))

    async def replay(*args, on_emit=None, **kwargs):
        for emit in seen["emits"]:
            on_emit(to_ref(emit))
        return to_ref(seen["result"])

    monkeypatch.setattr(ref_client, "submit", replay)
    ref_client.main(argv)
    assert got == capsys.readouterr().out
    lines = got.splitlines()
    assert lines[0].startswith("Partial [") and "Result [dict] topk (3):" in lines
    assert lines[-1] == "  searched=50"
