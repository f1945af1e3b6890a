"""The port's LSP server, runners and transport held to the scenarios of
``tests/test_lsp.py``: ordered echo, client demultiplexing, fragmented
payloads, a drop/dup/reorder storm, the reassembly bound, dead-peer
detection both ways, drain on close and the runners' round trip, plus
one interop case each way against the reference's LSP.

Every case is a few round trips at 40 ms epochs on ephemeral ports.
"""

import asyncio

import pytest

from tpuminter import lsp as ref_lsp
from tpuminter_torch.lsp import LspClient, LspConnectionLost, LspServer, Params

FAST = Params(epoch_limit=5, epoch_millis=40, window_size=4, max_backoff_interval=2)
REF_FAST = ref_lsp.Params(epoch_limit=5, epoch_millis=40, window_size=4,
                          max_backoff_interval=2)


def run(coro, timeout=30.0):
    async def wrapped():
        return await asyncio.wait_for(coro, timeout)

    return asyncio.run(wrapped())


async def _echo_round(server, clients, payloads):
    """Every client writes ``payloads``; the server reads them in order
    per client and echoes them; every client reads them back in order."""
    for c in clients:
        for p in payloads:
            c.write(p)
    got = {}
    for _ in range(len(clients) * len(payloads)):
        conn_id, payload = await server.read()
        assert payload is not None
        got.setdefault(conn_id, []).append(bytes(payload))
        server.write(conn_id, payload)
    assert sorted(got) == sorted(c.conn_id for c in clients)
    assert all(v == payloads for v in got.values())
    for c in clients:
        assert [bytes(await c.read()) for _ in payloads] == payloads


@pytest.mark.parametrize("n_clients", [1, 4], ids=["order", "demux"])
def test_echo_in_order_and_demultiplexed(n_clients):
    async def scenario():
        server = await LspServer.create(params=FAST)
        clients = [await LspClient.connect("127.0.0.1", server.port, FAST)
                   for _ in range(n_clients)]
        assert len({c.conn_id for c in clients}) == n_clients
        await _echo_round(server, clients, [f"msg-{i}".encode() for i in range(20)])
        for c in clients:
            await c.close()
        await server.close()

    run(scenario())


def test_large_payloads_fragment_and_reassemble_under_loss():
    from tpuminter_torch.lsp.message import MAX_PAYLOAD

    payloads = [b"small", bytes(range(256)) * 20, b"x" * MAX_PAYLOAD, b"",
                b"y" * (3 * MAX_PAYLOAD + 17)]

    async def scenario():
        server = await LspServer.create(params=FAST, seed=3)
        client = await LspClient.connect("127.0.0.1", server.port, FAST, seed=4)
        client.endpoint.set_write_drop_rate(0.1)
        client.endpoint.set_read_drop_rate(0.1)
        await _echo_round(server, [client], payloads)
        await client.close()
        await server.close()

    run(scenario(), timeout=60.0)


def test_drop_dup_reorder_storm_delivers_exactly_once_in_order():
    async def scenario():
        server = await LspServer.create(params=FAST, seed=5)
        client = await LspClient.connect("127.0.0.1", server.port, FAST, seed=6)
        for ep in (server.endpoint, client.endpoint):
            ep.set_fault_rates(drop=0.1, dup=0.1, reorder=0.1)
            ep.reorder_delay = 0.02
        payloads = [i.to_bytes(4, "big") for i in range(60)] + [b"frag" * 1000]
        await _echo_round(server, [client], payloads)
        eps = (server.endpoint, client.endpoint)
        assert sum(e.dropped_out + e.dropped_in for e in eps) > 0
        assert sum(e.duplicated_out + e.duplicated_in for e in eps) > 0
        assert sum(e.reordered_out + e.reordered_in for e in eps) > 0
        await client.close()
        await server.close()

    run(scenario(), timeout=60.0)


def test_reassembly_overflow_declares_connection_lost():
    from tpuminter_torch.lsp.connection import FRAGMENT_SIZE, MAX_MESSAGE, ConnState
    from tpuminter_torch.lsp.message import Frame, MsgType

    async def scenario():
        delivered, lost = [], []
        conn = ConnState(1, Params(), lambda wires: None, lambda c: None, delivered.append,
                         lost.append)
        for seq in range(1, MAX_MESSAGE // FRAGMENT_SIZE + 3):
            conn.on_frame(Frame(MsgType.DATA, 1, seq, b"\x01" + b"z" * FRAGMENT_SIZE))
            if conn.lost:
                break
        assert conn.lost and lost and not delivered
        assert conn._rx_parts == [] and conn._rx_bytes == 0

    run(scenario())


@pytest.mark.parametrize("dies", ["client", "server"])
def test_dead_peer_is_detected(dies):
    async def scenario():
        server = await LspServer.create(params=FAST)
        client = await LspClient.connect("127.0.0.1", server.port, FAST)
        client.write(b"hello")
        conn_id, payload = await server.read()
        assert payload == b"hello"
        if dies == "client":
            client.endpoint.close()  # the client process "crashes"
            assert await server.read() == (conn_id, None)
            assert conn_id not in server.conn_ids
        else:
            server.crash()
            with pytest.raises(LspConnectionLost):
                while True:
                    await asyncio.wait_for(client.read(), 5.0)
            assert client.is_lost
        await client.close()
        await server.close()

    run(scenario())


def test_server_close_conn_drains_in_flight_data():
    async def scenario():
        params = Params(epoch_limit=8, epoch_millis=40, window_size=1)
        server = await LspServer.create(params=params, seed=5)
        client = await LspClient.connect("127.0.0.1", server.port, params, seed=6)
        client.write(b"hi")
        conn_id, _ = await server.read()
        server.endpoint.set_write_drop_rate(0.4)  # force retransmission work
        for i in range(5):
            server.write(conn_id, bytes([i]))
        server.close_conn(conn_id)  # keeps retransmitting until drained
        assert [(await client.read())[0] for _ in range(5)] == list(range(5))
        await client.close()
        await server.close()

    run(scenario(), timeout=60.0)


def test_restarted_server_resets_a_stale_peer():
    """A frame from an address the server does not know draws a reset
    ack, so the stale client declares its session lost at once."""
    async def scenario():
        server = await LspServer.create(params=FAST)
        port = server.port
        client = await LspClient.connect("127.0.0.1", port, FAST)
        epoch = server.boot_epoch
        server.crash()
        await server.endpoint.wait_closed()
        server2 = await LspServer.create(port, params=FAST)
        assert server2.boot_epoch != epoch
        client.write(b"anyone?")
        with pytest.raises(LspConnectionLost, match="restarted"):
            await asyncio.wait_for(client.read(), 2 * FAST.epoch_seconds + 1.0)
        await client.close()
        await server2.close()

    run(scenario())


def test_smoke_runners_roundtrip(capsys):
    from tpuminter_torch.lsp import crunner, srunner

    async def scenario():
        ready = asyncio.get_running_loop().create_future()
        server = asyncio.create_task(srunner.serve(0, on_ready=ready.set_result))
        port = await asyncio.wait_for(ready, 5.0)
        try:
            await asyncio.wait_for(crunner.run("127.0.0.1", port, ["alpha", "beta"]), 10.0)
        finally:
            server.cancel()
            await asyncio.gather(server, return_exceptions=True)

    asyncio.run(scenario())
    assert capsys.readouterr().out.splitlines() == [
        "alpha", "beta", "done: 2 replies, in order, loss-free"]


@pytest.mark.parametrize("server_side", ["reference", "port"])
def test_interop_with_the_reference_lsp(server_side):
    """The port's client against the reference's server, and the
    reference's client against the port's server: fragments included."""
    payloads = [b"one", b"z" * 5000, b"three"]

    async def scenario():
        if server_side == "reference":
            server = await ref_lsp.LspServer.create(params=REF_FAST)
            client = await LspClient.connect("127.0.0.1", server.port, FAST)
        else:
            server = await LspServer.create(params=FAST)
            client = await ref_lsp.LspClient.connect("127.0.0.1", server.port, REF_FAST)
        await _echo_round(server, [client], payloads)
        await client.close()
        await server.close()

    run(scenario())
