"""The port's pod worker against the JAX package's, at two and four ranks.

The port's pod runs as real processes, one a rank, over gloo on the CPU
(``device="cpu"``, the kernels' plain versions): ``torch_pod_ranks.py``
joins each rank through the ``TPUMINTER_*`` triple, and every rank
asserts by its output that it loaded no module of JAX or the JAX
package. The reference's ``PodMiner`` runs on ``make_mesh(jax.devices()
[:W])`` with the same ``slab_per_device``, ``n_slabs``, ``roll_batch``
and ``scrypt_batch``, on its CPU engines. One pod of each size starts
once for the module and runs every scenario; the reference runs in this
process meanwhile.

Held equal, field by field (``found``, ``nonce``, ``hash_value``,
``searched``): the scenarios of ``tests/test_pod.py`` (the genesis
window, an exhausted window whose candidate is its minimum, one with no
candidate, MIN, a rolled exhausted window, the easy-target delegate,
SCRYPT with a ragged tail) and, as the port has no ``cand_bits`` seam,
a rolled window of the genesis coinbase around the genesis block, whose
winner is a production candidate, batched and at ``roll_batch=1``; and
exact-min found and exhausted. Where the reference's CPU engine fixes
less than its production engine (``_mine_target_exact_jnp`` counts a
found span's ``searched`` by whole rounds), the port is held to the
production contract, ``searched = nonce - lower + 1``, and to hashlib.
SCRYPT runs at N = 16 on both sides: the port's ``scrypt_n_log2``, and
for the reference a hashlib stand-in for ``scrypt_header_batch`` (as
``tests/test_torch_scrypt_worker.py`` does).

Each ``parallel.mesh`` sweep is also held against the reference's sweep
on the same inputs: ``candidate_sweep`` (static and dynamic header)
against ``build_candidate_sweep``, ``rolled_sweep`` against
``build_rolled_sweep``, and ``exact_sweep``, ``min_sweep`` and
``scrypt_sweep`` against the jnp sweeps the reference runs on its CPU
mesh (``build_target_sweep``, ``build_min_fold``,
``build_scrypt_sweep``): the same shards, rank ``d`` on the ``d``-th.

The two-rank pod also replays an abandoned chunk, is closed in the middle
of a chunk, and serves an unchanged ``tpuminter.coordinator`` in this
process over LSP (a TARGET job and a MIN job, held to ``CpuMiner``).
Exact integer equality throughout.
"""

import asyncio
import hashlib
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpuminter import chain as ref_chain
from tpuminter import jax_worker
from tpuminter import protocol as ref
from tpuminter.client import submit
from tpuminter.coordinator import Coordinator
from tpuminter.lsp import Params as RefParams
from tpuminter.ops import merkle as ref_merkle
from tpuminter.ops import scrypt as ref_scrypt
from tpuminter.ops import sha256 as ref_ops
from tpuminter.parallel import (
    build_candidate_sweep,
    build_min_fold,
    build_rolled_sweep,
    build_scrypt_sweep,
    build_target_sweep,
    make_mesh,
)
from tpuminter.pod_worker import PodMiner as RefPodMiner
from tpuminter.pod_worker import _biased_cap
from tpuminter.rolled import plan_tiles as ref_plan_tiles
from tpuminter.worker import CpuMiner
from tpuminter_torch.rolled import plan_tiles

HERE = os.path.dirname(os.path.abspath(__file__))
GEN = ref_chain.GENESIS_HEADER
N = GEN.nonce
TARGET = ref_chain.bits_to_target(GEN.bits)
GENESIS_COINBASE = bytes.fromhex(
    "01000000" "01" + "00" * 32 + "ffffffff" "4d"
    "04ffff001d0104455468652054696d65732030332f4a616e2f32303039204368616e63656c"
    "6c6f72206f6e206272696e6b206f66207365636f6e64206261696c6f757420666f722062616e6b73"
    "ffffffff" "01" "00f2052a01000000" "43"
    "4104678afdb0fe5548271967f1a67130b7105cd6a828e03909a67962e0ea1f61deb649f6bc3f"
    "4cef38c4f35504e51ec112de5c384df7ba0b8d578a4c702b6bf11d5fac"
    "00000000"
)
#: the genesis block as a rolled index: extranonce 4 (the coinbase's byte 48)
ROLLED_N = (4 << 32) | N
GEN_ROLL = dict(coinbase_prefix=GENESIS_COINBASE[:48], coinbase_suffix=GENESIS_COINBASE[49:],
                extranonce_size=1, nonce_bits=32)
_RNG = np.random.RandomState(5)
RAND_ROLL = dict(coinbase_prefix=_RNG.bytes(41), coinbase_suffix=_RNG.bytes(60),
                 extranonce_size=4, branch=(_RNG.bytes(32), _RNG.bytes(32)), nonce_bits=11)
SCRYPT_N_LOG2 = 4
SCRYPT_UPPER = 100  # two ranks: 3 spans of 32 and 5 more; four: 1 of 64 and 37
WORLDS = (2, 4)
#: seconds the pods may take: a hung rank fails the module, it cannot eat
#: the suite's limit
SPAWN_TIMEOUT = 150
_LSP = dict(epoch_limit=20, epoch_millis=100, window_size=32, max_backoff_interval=2,
            max_unacked_messages=32)


def _scrypt16(prefix76: bytes, nonce: int) -> int:
    data = prefix76 + struct.pack("<I", nonce)
    return ref_chain.hash_to_int(hashlib.scrypt(data, salt=data, n=1 << SCRYPT_N_LOG2, r=1,
                                                p=1, dklen=32))


_SCRYPT_HASHES = [(_scrypt16(GEN.pack()[:76], n), n) for n in range(SCRYPT_UPPER + 1)]


def _req(job_id, mode, lower, upper, **kw):
    return ref.Request(job_id, mode, lower, upper, **kw)


def _target(job_id, lower, upper, target=TARGET, **kw):
    return _req(job_id, ref.PowMode.TARGET, lower, upper, header=GEN.pack(), target=target,
                **kw)


#: name -> (miner kwargs, scrypt at N = 16, {scenario: request})
GROUPS = {
    "target": (dict(slab_per_device=256, n_slabs=2), False, {
        "genesis_found": _target(1, N - 3000, N + 3000),
        "candidate_min": _target(2, N - 1000, N + 1000, GEN.block_hash_int() - 1),
        "no_candidate": _target(3, 0, 4000, 1),
        "easy_delegate": _target(4, 0, 5000, (1 << 250) - 1),
    }),
    "min": (dict(slab_per_device=512, n_slabs=2), False, {
        "min": _req(5, ref.PowMode.MIN, 5, 6001, data=b"pod"),
    }),
    "rolled": (dict(slab_per_device=256, n_slabs=2), False, {
        "rolled_exhausted": _target(6, 100, (3 << 11) - 50, **RAND_ROLL),
    }),
    "rolled_rb1": (dict(slab_per_device=256, n_slabs=2, roll_batch=1), False, {
        "rolled_exhausted": _target(6, 100, (3 << 11) - 50, **RAND_ROLL),
    }),
    "genesis_rolled": (dict(slab_per_device=256, n_slabs=2, roll_batch=6), False, {
        "found": _target(7, ROLLED_N - 3000, ROLLED_N + 3000, **GEN_ROLL),
        "candidate_min": _target(8, ROLLED_N - 1000, ROLLED_N + 1000,
                                 GEN.block_hash_int() - 1, **GEN_ROLL),
    }),
    "genesis_rolled_rb1": (dict(slab_per_device=256, n_slabs=2, roll_batch=1), False, {
        "found": _target(7, ROLLED_N - 3000, ROLLED_N + 3000, **GEN_ROLL),
        "candidate_min": _target(8, ROLLED_N - 1000, ROLLED_N + 1000,
                                 GEN.block_hash_int() - 1, **GEN_ROLL),
    }),
    "exact": (dict(slab_per_device=256, n_slabs=2, exact_min=True), False, {
        "found": _target(9, N - 3000, N + 3000),
        "exhausted": _target(10, N - 5000, N - 1001),
    }),
    "scrypt": (dict(slab_per_device=256, n_slabs=2, scrypt_batch=16), True, {
        "found": _req(11, ref.PowMode.SCRYPT, 0, SCRYPT_UPPER, header=GEN.pack(),
                      target=min(_SCRYPT_HASHES)[0]),
        "exhausted": _req(12, ref.PowMode.SCRYPT, 0, SCRYPT_UPPER, header=GEN.pack(),
                          target=1),
    }),
}
CASES = [(g, s) for g, (_, _, reqs) in GROUPS.items() for s in reqs]

#: the two-rank pod's replay: a chunk of 8 spans abandoned after one step,
#: then a chunk mined to its end
REPLAY = (dict(slab_per_device=512, n_slabs=2), {
    "abandoned": _req(20, ref.PowMode.MIN, 0, (1 << 13) - 1, data=b"abandoned chunk"),
    "after": _req(21, ref.PowMode.MIN, 0, 4095, data=b"after cancel"),
})
LSP_MINER = dict(slab_per_device=256, n_slabs=2)
LSP_JOBS = [_target(31, N - 1000, N + 3095), _req(32, ref.PowMode.MIN, 0, 4095,
                                                  data=b"hello bitcoin")]

#: inputs of the direct sweep checks
SWEEPS = dict(
    header=GEN.pack().hex(),
    candidate=dict(slab=256, n_slabs=4, starts=[N - 1500, (1 << 32) - 1000]),
    rolled=dict(coinbase=GENESIS_COINBASE.hex(), split=48, width=256, rows=8,
                start=ROLLED_N - 700),
    exact=dict(slab=256, target=TARGET, starts=[N - 300, N - 5000]),
    min=dict(data=b"pod".hex(), slab=256, start=(1 << 32) - 300),
    scrypt=dict(n_log2=SCRYPT_N_LOG2, batch=16, start=3,
                found_target=sorted(h for h, _ in _SCRYPT_HASHES[3:67])[5]),
)


def _encode(req: ref.Request) -> str:
    return ref.encode_msg(req).decode()


def _fields(result):
    return [result.found, result.nonce, result.hash_value, result.searched]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _plan(world: int, lsp_port=None) -> dict:
    plan = {"sweeps": SWEEPS, "groups": [
        {"name": name, "miner": kw, "scrypt_n_log2": SCRYPT_N_LOG2 if scrypt else None,
         "requests": {s: _encode(r) for s, r in reqs.items()}}
        for name, (kw, scrypt, reqs) in GROUPS.items()]}
    if world == 2:
        plan["replay"] = {"miner": REPLAY[0],
                          "requests": {s: _encode(r) for s, r in REPLAY[1].items()}}
        plan["lsp"] = {"addr": ["127.0.0.1", lsp_port], "miner": LSP_MINER, "params": _LSP}
    return plan


def _spawn(world: int, plan: dict, tmp, deadline: float) -> list:
    d = tmp / f"w{world}"
    d.mkdir()
    (d / "plan.json").write_text(json.dumps(plan))
    env = dict(os.environ, TPUMINTER_COORD_ADDR=f"127.0.0.1:{_free_port()}",
               TPUMINTER_NUM_PROCS=str(world), TPUMINTER_HEARTBEAT_S="60",
               OMP_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        log = open(d / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_pod_ranks.py"), str(d / "plan.json")],
            env=dict(env, TPUMINTER_PROC_ID=str(rank)), stdout=log, stderr=subprocess.STDOUT),
            log))
    return procs, deadline


def _reap(world: int, spawned, tmp) -> list:
    d = tmp / f"w{world}"
    procs, deadline = spawned
    try:
        for proc, _ in procs:
            proc.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    failed = [r for r, (proc, _) in enumerate(procs) if proc.returncode != 0]
    if failed:
        logs = "\n".join((d / f"rank{r}.log").read_text()[-3000:] for r in failed)
        pytest.fail(f"{world}-rank pod: ranks {failed} failed\n{logs}")
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(world)]


def _hashlib_digests(header76w, nonces):
    hdr76 = np.asarray(header76w).astype(">u4").tobytes()
    rows = []
    for nonce in np.asarray(nonces):
        data = hdr76 + struct.pack("<I", int(nonce))
        rows.append(struct.unpack(">8I", hashlib.scrypt(data, salt=data, n=1 << SCRYPT_N_LOG2,
                                                        r=1, p=1, dklen=32)))
    return np.array(rows, dtype=np.uint32).reshape(-1, 8)


def _hashlib_batch(header76w, nonces, n_log2=10):
    """``scrypt_header_batch`` on hashlib at N = 16, as a host callback."""
    return jax.pure_callback(_hashlib_digests,
                             jax.ShapeDtypeStruct((nonces.shape[0], 8), jnp.uint32),
                             header76w, nonces)


def _drain(gen):
    results = [r for r in gen if r is not None]
    assert len(results) == 1
    return results[0]


def _reference(world: int, out: dict) -> None:
    """The reference's answers on a ``world``-device mesh into ``out``:
    each scenario through its ``PodMiner`` and each sweep on the sweeps'
    inputs (SCRYPT through :func:`_hashlib_batch`, patched in by the
    caller)."""
    mesh = make_mesh(jax.devices()[:world])
    out["groups"] = {}
    for name, (kw, _, reqs) in GROUPS.items():
        miner = RefPodMiner(mesh=mesh, **kw)
        out["groups"][name] = {s: _fields(_drain(miner.mine(r))) for s, r in reqs.items()}
    out["sweeps"] = _reference_sweeps(mesh, world)


def _reference_sweeps(mesh, world: int) -> dict:
    out = {}
    template = ref_ops.header_template(GEN.pack())
    cap = _biased_cap(TARGET)
    c = SWEEPS["candidate"]
    static = build_candidate_sweep(mesh, template, slab_per_device=c["slab"],
                                   n_slabs=c["n_slabs"], kernel="jnp")
    dynamic = build_candidate_sweep(mesh, None, slab_per_device=c["slab"],
                                    n_slabs=c["n_slabs"], kernel="jnp", dynamic_header=True)
    mid = jnp.asarray(np.array(template.midstate, np.uint32))
    tailw = jnp.asarray(np.array([template.tail[0][w] for w in range(3)], np.uint32))
    for start in c["starts"]:
        out[f"candidate_{start}"] = [int(x) for x in static(jnp.uint32(start), cap)]
        out[f"candidate_dyn_{start}"] = [int(x) for x in dynamic(jnp.uint32(start), cap,
                                                                 mid, tailw)]
    r = SWEEPS["rolled"]
    rows = -(-r["rows"] // world) * world
    plan = ref_plan_tiles(r["start"], (rows - 2) * r["width"], 32, r["width"], rows,
                          interleave=world)
    roll = ref_merkle.make_extranonce_roll_batch(GEN.pack(), GENESIS_COINBASE[:48],
                                                 GENESIS_COINBASE[49:], 1, ())
    mids, tails = roll(jnp.asarray(plan.en_hi), jnp.asarray(plan.en_lo))
    sweep = build_rolled_sweep(mesh, width=r["width"], rows=rows, kernel="jnp")
    found, first, _ = sweep(mids, tails, jnp.asarray(plan.bases), jnp.asarray(plan.valids),
                            jnp.asarray(plan.goffs), cap)
    out["rolled"] = [int(found), int(first)]
    e = SWEEPS["exact"]
    sweep = build_target_sweep(mesh, template, batch_per_device=e["slab"], n_batches=1)
    tw = jnp.asarray(ref_ops.target_to_words(e["target"]))
    for start in e["starts"]:
        found, nonce, digest, _ = sweep(jnp.uint32(start), tw,
                                        jnp.uint32(start + world * e["slab"] - 1))
        out[f"exact_{start}"] = [int(found), int(nonce), ref_ops.digest_to_int(
            np.asarray(digest))]
    m = SWEEPS["min"]
    fold = build_min_fold(mesh, ref_ops.toy_template(bytes.fromhex(m["data"])),
                          batch_per_device=m["slab"])
    last = m["start"] + world * m["slab"] - 1
    fh, fl, nh, nl = fold(jnp.uint32(m["start"] >> 32), jnp.uint32(m["start"] & 0xFFFFFFFF),
                          jnp.uint32(last >> 32), jnp.uint32(last & 0xFFFFFFFF))
    out["min"] = [(int(fh) << 32) | int(fl), (int(nh) << 32) | int(nl)]
    s = SWEEPS["scrypt"]
    step = build_scrypt_sweep(mesh, batch_per_device=s["batch"], n_log2=s["n_log2"])
    hw = jnp.asarray(ref_scrypt.header_to_words(GEN.pack()[:76]))
    for name, tgt in (("found", s["found_target"]), ("exhausted", 1)):
        found, win, win_digest, min_digest, min_nonce = step(
            hw, jnp.uint32(s["start"]), jnp.asarray(ref_ops.target_to_words(tgt)))
        out[f"scrypt_{name}"] = [int(found), int(win),
                                 ref_ops.digest_to_int(np.asarray(win_digest)),
                                 ref_ops.digest_to_int(np.asarray(min_digest)), int(min_nonce)]
    return out


def _coordinator_leg(ports, box) -> None:
    """The unchanged coordinator, in a thread of its own: wait for the
    two-rank pod's leader to join, hand it :data:`LSP_JOBS`, close."""

    async def scenario():
        params = RefParams(**_LSP)
        coord = await Coordinator.create(params=params, chunk_size=4096)
        serve = asyncio.ensure_future(coord.serve())
        ports.append(coord.port)
        try:
            while not coord._miners:
                await asyncio.sleep(0.05)
            box["joins"] = [(m.backend, m.lanes) for m in coord._miners.values()]
            box["results"] = [await submit("127.0.0.1", coord.port, req, params=params)
                              for req in LSP_JOBS]
        finally:
            serve.cancel()
            await asyncio.gather(serve, return_exceptions=True)
            await coord.close()

    try:
        asyncio.run(asyncio.wait_for(scenario(), SPAWN_TIMEOUT))
    except BaseException as exc:  # reported by the fixture
        box["error"] = repr(exc)
        ports.append(None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pod")
    ports, box = [], {}
    leg = threading.Thread(target=_coordinator_leg, args=(ports, box), daemon=True)
    leg.start()
    while not ports:
        leg.join(0.01)
    assert ports[0] is not None, box
    deadline = time.monotonic() + SPAWN_TIMEOUT
    procs = {w: _spawn(w, _plan(w, ports[0]), tmp, deadline) for w in WORLDS}
    reference = {w: {} for w in WORLDS}
    try:
        # both meshes at once: much of a reference run is jit tracing and
        # cache loads that release the interpreter to the other
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ref_scrypt, "scrypt_header_batch", _hashlib_batch)
            mp.setattr(jax_worker, "_scrypt_step",
                       jax.jit(jax_worker._scrypt_step.__wrapped__, static_argnums=3))
            threads = [threading.Thread(target=_reference, args=(w, reference[w]))
                       for w in WORLDS]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        reference["lsp"] = [_fields(_drain(CpuMiner().mine(r))) for r in LSP_JOBS]
    finally:
        ranks = {w: _reap(w, procs[w], tmp) for w in WORLDS}
    assert all("sweeps" in reference[w] for w in WORLDS), "a reference run failed"
    leg.join(SPAWN_TIMEOUT)
    return {"ranks": ranks, "reference": reference, "lsp": box}


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_agree_and_load_no_jax(runs, world):
    ranks = runs["ranks"][world]
    assert [r["rank"] for r in ranks] == list(range(world))
    assert {r["backend"] for r in ranks} == {"gloo"}
    assert all(r["loaded"] == [] for r in ranks)
    # every rank computed every sweep's answer, the same
    assert all(r["sweeps"] == ranks[0]["sweeps"] for r in ranks)
    # followers replayed each chunk to the leader's Result
    for name in GROUPS:
        leader = ranks[0]["groups"][name]
        assert list(leader["results"].values()) == leader["replayed"]
        assert all(r["groups"][name]["replayed"] == leader["replayed"] for r in ranks)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("group,scenario", CASES)
def test_pod_result_equals_reference(runs, world, group, scenario):
    got = runs["ranks"][world][0]["groups"][group]["results"][scenario]
    want = runs["reference"][world]["groups"][group][scenario]
    req = GROUPS[group][2][scenario]
    if group == "exact" and scenario == "found":
        # the reference's CPU engine counts whole rounds; production (and
        # the port) counts up to the winner
        assert got[:3] == want[:3] and got[3] == got[1] - req.lower + 1
    else:
        assert got == want
    found, nonce, value, _ = got
    if req.mode == ref.PowMode.TARGET and value != ref.MIN_UNTRACKED:
        hdr = GEN
        if req.rolled:
            en, n = ref_chain.split_global(nonce, req.nonce_bits)
            tmpl = ref_chain.CoinbaseTemplate(req.coinbase_prefix, req.coinbase_suffix,
                                              req.extranonce_size)
            hdr = ref_chain.rolled_header(req.header, tmpl, req.branch, en)
            nonce = n
        assert value == ref_chain.hash_to_int(hdr.with_nonce(nonce).block_hash())
        assert found == (value <= req.target)
    elif req.mode == ref.PowMode.SCRYPT:
        assert value == _scrypt16(GEN.pack()[:76], nonce)
    elif req.mode == ref.PowMode.MIN:
        assert value == ref_chain.toy_hash(req.data, nonce)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("group", ["rolled", "genesis_rolled"])
def test_rolled_batched_equals_one_segment_at_a_time(runs, world, group):
    results = runs["ranks"][world][0]["groups"]
    assert results[group]["results"] == results[group + "_rb1"]["results"]
    if group == "genesis_rolled":
        assert results[group]["results"]["found"][:2] == [True, ROLLED_N]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("sweep", [f"candidate_{s}" for s in SWEEPS["candidate"]["starts"]]
                         + [f"candidate_dyn_{s}" for s in SWEEPS["candidate"]["starts"]]
                         + ["rolled", "min", "scrypt_found", "scrypt_exhausted"]
                         + [f"exact_{s}" for s in SWEEPS["exact"]["starts"]])
def test_sweep_equals_reference_sweep(runs, world, sweep):
    got = runs["ranks"][world][0]["sweeps"][sweep]
    want = runs["reference"][world]["sweeps"][sweep]
    if sweep.startswith("candidate"):
        found, first, stripes = got
        assert [int(found), first if found else want[1], stripes] == want
    elif sweep == "rolled":
        assert [int(got[0]), got[1]] == want and got[0]
    elif sweep == "min":
        fold_hi, fold_lo, off = got
        assert [(fold_hi << 32) | fold_lo, SWEEPS["min"]["start"] + off] == want
    elif sweep.startswith("scrypt"):
        found, win, win_words, min_words, min_off = got[0], got[1], got[2:10], got[10:18], \
            got[18]
        start = SWEEPS["scrypt"]["start"]
        value = lambda ws: int.from_bytes(struct.pack(">8I", *ws), "big")  # noqa: E731
        assert [found, start + min_off] == [want[0], want[4]]
        assert value(min_words) == want[3]
        if found:
            assert [start + win, value(win_words)] == want[1:3]
    else:
        start = int(sweep.split("_")[1])
        found, win, min_words, min_off = got[0], got[1], got[2:10], got[10]
        assert found == want[0]
        if found:
            assert start + win == want[1]
        else:
            value = int.from_bytes(struct.pack(">8I", *min_words), "big")
            assert [start + min_off, value] == want[1:]


@pytest.mark.parametrize("k", [1, 2, 4])
def test_plan_tiles_interleave_equals_reference(k):
    rows = 12
    for start, n, nb, width in [(100, 600, 11, 64), ((3 << 11) - 300, 700, 11, 256),
                                (ROLLED_N - 700, 1536, 32, 256)]:
        got = plan_tiles(start, n, nb, width, rows, interleave=k)
        want = ref_plan_tiles(start, n, nb, width, rows, interleave=k)
        assert [a.tolist() for a in got] == [a.astype(np.int64).tolist() for a in want]


def test_abandoned_chunk_leaves_the_follower_in_step(runs):
    leader, follower = runs["ranks"][2]
    want = min((ref_chain.toy_hash(b"after cancel", i), i) for i in range(4096))
    found, nonce, value, searched = leader["replay"]["results"]["after_abandon"]
    assert (value, nonce, found, searched) == (*want, True, 4096)
    # the follower started three chunks: the abandoned one, the next to its
    # Result, and the one the leader's close() released mid-chunk
    assert follower["replay"]["replayed"] == [None, [True, nonce, value, searched], None]
    assert follower["replay"]["results"] == {"follower_returned": True}


def test_pod_serves_the_coordinator_over_lsp(runs):
    box = runs["lsp"]
    assert "error" not in box, box.get("error")
    leader, follower = runs["ranks"][2]
    # the pod joins once, as backend "pod" with its lanes hint
    assert box["joins"] == [("pod", 2)]
    assert leader["replay"]["results"]["lanes"] == 2
    for got, want in zip(box["results"], runs["reference"]["lsp"]):
        assert (got.found, got.nonce, got.hash_value) == tuple(want[:3])
    assert box["results"][0].found and box["results"][0].nonce == N
    # the follower replayed every chunk the leader mined, to the same Result
    assert follower["lsp_replayed"] == leader["lsp_replayed"]
    assert len(leader["lsp_replayed"]) >= len(LSP_JOBS)


@pytest.mark.parametrize("group", ["target", "min"])
def test_a_pod_of_one_process_equals_the_ranks(runs, group):
    """``PodMiner`` without a rank (the worker's ``--backend pod`` without
    the ``TPUMINTER_*`` triple) is a pod of one process on its device,
    with the same Results as the two-rank pod."""
    import torch

    from tpuminter_torch import protocol as port
    from tpuminter_torch.pod_worker import PodMiner

    kw, _, reqs = GROUPS[group]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        miner = PodMiner(device="cpu", **kw)
        assert (miner.pod.world, miner.pod.group, miner.lanes) == (1, None, 1)
        got = {s: _fields(_drain(miner.mine(port.decode_msg(ref.encode_msg(r)))))
               for s, r in reqs.items()}
    finally:
        torch.set_num_threads(threads)
    assert got == runs["ranks"][2][0]["groups"][group]["results"]


@pytest.mark.parametrize("argv,backend", [([], "cuda"), (["--backend", "pod"], "pod"),
                                          (["--backend", "pod", "--reconnect"], None)])
def test_worker_backend_flag(argv, backend):
    """``--backend`` is ``cuda`` by default; ``pod`` takes no ``--reconnect``
    (the leader's session end releases its followers)."""
    from tpuminter_torch.worker import _parse_args

    if backend is None:
        with pytest.raises(SystemExit):
            _parse_args(["127.0.0.1:6060", *argv])
    else:
        assert _parse_args(["127.0.0.1:6060", *argv])[0].backend == backend
