"""The port's rolled (extranonce) TARGET path against the JAX package's.

The same inputs go through ``tpuminter_torch`` (the kernels' plain
versions, on the CPU) and through ``tpuminter``'s chain helpers, jnp
roll, jnp candidate sweeps (the reference engines of K4 and K5; their
Pallas kernels need a TPU), ``rolled.mine_rolled_fast`` and
``CpuMiner``. Exact integer equality throughout.

Vector with a known winner: the genesis block as a rolled job. Its
204-byte coinbase splits at byte 48 around a one-byte extranonce, and
extranonce 4 (the genesis scriptSig's byte) with an empty branch gives
the genesis Merkle root, so global index ``(4 << 32) | 2083236893`` is
the genesis block itself.
"""

import dataclasses
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_extranonce import ENS, NB, brute, fixture
from tpuminter import chain as ref_chain
from tpuminter import protocol as ref
from tpuminter import rolled as ref_rolled
from tpuminter import search as ref_search
from tpuminter.ops import merkle as ref_merkle
from tpuminter.ops import sha256 as ref_ops
from tpuminter.ops import symbolic as ref_sym
from tpuminter.worker import CpuMiner
from tpuminter_torch import chain, rolled
from tpuminter_torch import protocol as port
from tpuminter_torch import search
from tpuminter_torch.cuda_worker import CudaMiner
from tpuminter_torch.kernels import sha256 as K
from tpuminter_torch.ops import merkle
from tpuminter_torch.ops import sha256 as ops

GENESIS = ref_chain.GENESIS_HEADER
N = 2083236893
TARGET = ref_chain.bits_to_target(GENESIS.bits)
HW1_CAP = int(ref_ops.target_to_words(TARGET)[1])
GENESIS_COINBASE = bytes.fromhex(
    "01000000" "01" + "00" * 32 + "ffffffff" "4d"
    "04ffff001d0104455468652054696d65732030332f4a616e2f32303039204368616e63656c"
    "6c6f72206f6e206272696e6b206f66207365636f6e64206261696c6f757420666f722062616e6b73"
    "ffffffff" "01" "00f2052a01000000" "43"
    "4104678afdb0fe5548271967f1a67130b7105cd6a828e03909a67962e0ea1f61deb649f6bc3f"
    "4cef38c4f35504e51ec112de5c384df7ba0b8d578a4c702b6bf11d5fac"
    "00000000"
)
PREFIX, SUFFIX = GENESIS_COINBASE[:48], GENESIS_COINBASE[49:]
WINNER = (4 << 32) | N

_RNG = np.random.RandomState(7)
#: the mainnet block template's shape: a 250-byte coinbase, 12-deep branch
MAIN_PREFIX, MAIN_SUFFIX = _RNG.bytes(120), _RNG.bytes(126)
MAIN_BRANCH = tuple(_RNG.bytes(32) for _ in range(12))


def _genesis_job(lower, upper, target=TARGET, **kw):
    return ref.Request(7, ref.PowMode.TARGET, lower, upper, header=GENESIS.pack(),
                       target=target, coinbase_prefix=PREFIX, coinbase_suffix=SUFFIX,
                       extranonce_size=1, branch=(), nonce_bits=32, chunk_id=5, **kw)


def _port(req):
    return port.decode_msg(ref.encode_msg(req))


def _one(gen):
    results = [r for r in gen if r is not None]
    assert len(results) == 1
    return results[0]


def _fields(r):
    return (r.job_id, r.mode.value, r.nonce, r.hash_value, r.found, r.searched,
            r.chunk_id)


def _i64(values):
    return torch.tensor(np.asarray(values, dtype=np.int64))


def _u32(values):
    return jnp.asarray(np.asarray(values, dtype=np.uint32))


# -- chain helpers -------------------------------------------------------------

def test_genesis_coinbase_vector():
    assert ref_chain.hash_to_hex(ref_chain.dsha256(GENESIS_COINBASE)) == (
        "4a5e1e4baab89f3a32518a88c31bc87f618f76673e2cc77ab2127b7afdeda33b")
    assert GENESIS_COINBASE[48] == 4 and len(SUFFIX) == 155
    cb = chain.CoinbaseTemplate(PREFIX, SUFFIX, 1)
    assert chain.rolled_header(GENESIS.pack(), cb, (), 4).pack() == GENESIS.pack()
    assert chain.merkle_root_from_branch(cb.txid(4), ()) == GENESIS.merkle_root


@pytest.mark.parametrize("lower,upper,nb,width", [
    (0, (3 << 10) - 1, 10, 256),
    ((1 << 10) + 100, (3 << 10) + 50, 10, 256),
    (5, 5, 10, 64),
    ((7 << 32) - 3000, (9 << 32) + 77, 32, 1 << 27),
    (123, 123 + 5000, 8, None),
], ids=["aligned", "ragged", "single", "nb32-across-segments", "whole-segments"])
def test_rolled_tiles_and_segments_match_reference(lower, upper, nb, width):
    assert list(chain.rolled_tiles(lower, upper, nb, width)) == list(
        ref_chain.rolled_tiles(lower, upper, nb, width))
    assert list(chain.rolled_segments(lower, upper, nb)) == list(
        ref_chain.rolled_segments(lower, upper, nb))


def test_roll_span_and_split_global_match_reference():
    for e0, count, nb in ((0, 1, 32), (5, 3, 10), ((1 << 31) + 1, 7, 32)):
        assert chain.roll_span(e0, count, nb) == ref_chain.roll_span(e0, count, nb)
    for g, nb in ((0, 32), (WINNER, 32), ((1 << 40) - 1, 10), (12345, 4)):
        assert chain.split_global(g, nb) == ref_chain.split_global(g, nb)
    with pytest.raises(ValueError):
        chain.roll_span(0, 0)


# -- the roll ------------------------------------------------------------------

_ENS = [0, 1, 4, 255, 0x1234, (1 << 32) + 9]


def _host_roll(prefix, suffix, size, branch, ens):
    """(midstates, tail words) of each extranonce by hashlib."""
    cb = ref_chain.CoinbaseTemplate(prefix, suffix, size)
    hdrs = [ref_chain.rolled_header(GENESIS.pack(), cb, branch, e) for e in ens]
    return [list(h.midstate()) for h in hdrs], [list(h.tail_words()) for h in hdrs]


def _ens(size):
    return [e & ((1 << (8 * size)) - 1) for e in _ENS]


@pytest.mark.parametrize("size", [1, 4, 8])
def test_roll_plain_matches_jax_roll_and_rolled_header(size):
    ens = _ens(size)
    job = merkle.build_roll(GENESIS.pack(), MAIN_PREFIX, MAIN_SUFFIX, size, ())
    mids, tails = merkle.roll_plain(job, _i64([e >> 32 for e in ens]),
                                    _i64([e & 0xFFFFFFFF for e in ens]))
    roll = ref_merkle.make_extranonce_roll_batch(GENESIS.pack(), MAIN_PREFIX,
                                                 MAIN_SUFFIX, size, ())
    ref_mids, ref_tails = roll(_u32([e >> 32 for e in ens]),
                               _u32([e & 0xFFFFFFFF for e in ens]))
    assert mids.tolist() == np.asarray(ref_mids).tolist()
    assert tails.tolist() == np.asarray(ref_tails).tolist()
    assert (mids.tolist(), tails.tolist()) == _host_roll(MAIN_PREFIX, MAIN_SUFFIX, size,
                                                         (), ens)


@pytest.mark.parametrize("size", [1, 4, 8])
def test_roll_plain_12_deep_matches_rolled_header(size):
    ens = _ens(size)
    job = merkle.build_roll(GENESIS.pack(), MAIN_PREFIX, MAIN_SUFFIX, size, MAIN_BRANCH)
    mids, tails = K.extranonce_roll(job, _i64([e >> 32 for e in ens]),
                                    _i64([e & 0xFFFFFFFF for e in ens]))
    assert (mids.tolist(), tails.tolist()) == _host_roll(MAIN_PREFIX, MAIN_SUFFIX, size,
                                                         MAIN_BRANCH, ens)


def test_roll_deduped_equals_plain_roll():
    job = merkle.build_roll(GENESIS.pack(), PREFIX, SUFFIX, 1, MAIN_BRANCH[:1])
    en_hi, en_lo = [0, 0, 0, 0, 0], [3, 4, 3, 0, 4]
    calls = []

    def roll(hi, lo):
        calls.append(len(lo))
        return K.extranonce_roll(job, hi, lo)

    got = merkle.roll_batch_deduped(roll, en_hi, en_lo, "cpu")
    want = merkle.roll_plain(job, _i64(en_hi), _i64(en_lo))
    assert calls == [3]  # one roll per distinct extranonce
    assert [t.tolist() for t in got] == [t.tolist() for t in want]


# -- plans ---------------------------------------------------------------------

@pytest.mark.parametrize("start,n,nb,width,rows,hard_end", [
    (0, 8 * 256, 10, 256, 10, None),
    ((1 << 10) - 300, 8 * 256, 10, 256, 10, None),
    (1000, 700, 10, 256, 10, None),
    ((3 << 10) - 100, 8 * 256, 10, 256, 10, (1 << 12) - 1),
    ((4 << 32) | (N - 5), 1 << 20, 32, 1 << 17, 10, None),
], ids=["aligned", "ragged-across-segment", "short-padded", "clamped", "nb32"])
def test_plan_tiles_matches_reference(start, n, nb, width, rows, hard_end):
    got = rolled.plan_tiles(start, n, nb, width, rows, hard_end)
    want = ref_rolled.plan_tiles(start, n, nb, width, rows, hard_end)
    for a, b in zip(got, want):
        assert a.tolist() == b.astype(np.int64).tolist()
    assert rolled.tile_width(32, 1 << 27) == ref_rolled.tile_width(32, 1 << 27)
    assert rolled.tile_width(10, 3000) == ref_rolled.tile_width(10, 3000)


# -- dynamic-header hashes and the sched arm's split ---------------------------

def test_dynamic_header_hashes_match_reference():
    hdr = ref_chain.rolled_header(GENESIS.pack(), ref_chain.CoinbaseTemplate(
        MAIN_PREFIX, MAIN_SUFFIX, 4), MAIN_BRANCH, 3)
    mid, tail = list(hdr.midstate()), list(hdr.tail_words())
    nonces = np.array([0, 1, N, 0xFFFFFFFF, 0x12345678], dtype=np.uint32)
    lanes = _i64(nonces)
    digest = ops.header_digest_dyn(mid, tail, lanes)
    for i, n in enumerate(nonces.tolist()):
        want = ref_chain.dsha256(hdr.pack()[:76] + struct.pack("<I", n))
        assert [int(w[i]) for w in digest] == list(struct.unpack(">8I", want))
    e60, e61 = ops.header_e60_e61_dyn(mid, tail, lanes)
    # called eagerly on numpy lanes (the symbolic ops are plain operators,
    # whose u32 sums wrap by design)
    with np.errstate(over="ignore"):
        r60, r61 = ref_ops.header_e60_e61_dyn(np.array(mid, np.uint32),
                                              np.array(tail, np.uint32), nonces)
    assert (e60.tolist(), e61.tolist()) == (np.asarray(r60).tolist(),
                                            np.asarray(r61).tolist())
    prep = ops.prepare_hdr(mid, *tail)
    assert ops.hash_prepared_e60_e61(prep, lanes)[0].tolist() == e60.tolist()
    assert ops.hash_prepared_e60_e61(prep, lanes)[1].tolist() == e61.tolist()
    ref_prep = ref_sym.prepare_hdr(mid, *tail)
    assert ref_prep[2:] == prep[2:] and tuple(ref_prep[1]) == prep[1]
    for n in nonces.tolist()[:3]:
        want = ref_sym.hash_prepared_e60_e61(ref_prep, n)
        assert ops.hash_prepared_e60_e61(prep, n) == tuple(want)


# -- K4 and K5 plain versions against the jnp sweeps ---------------------------

#: the jnp sweeps' width: the fast-path tests' slab, so each jnp program
#: compiles once for the whole file
WIDTH = 1024


def _genesis_row(en=4):
    job = merkle.build_roll(GENESIS.pack(), PREFIX, SUFFIX, 1, ())
    return merkle.roll_plain(job, _i64([0]), _i64([en]))


def _ref_segment(base):
    roll = ref_merkle.make_extranonce_roll(GENESIS.pack(), PREFIX, SUFFIX, 1, ())
    mid, tail = roll(jnp.uint32(0), jnp.uint32(4))
    return np.asarray(ref_rolled._jnp_segment_candidate_sweep(
        mid, tail, jnp.uint32(base), jnp.uint32(HW1_CAP), WIDTH, 32)).tolist()


@pytest.mark.parametrize("base,n", [
    (N - 1000, WIDTH),
    (N - WIDTH + 1, WIDTH),
    (N - WIDTH + 1, WIDTH - 1),
    (123_456_789, WIDTH),
], ids=["hit", "last-offset", "masked-by-n", "free"])
def test_k4_plain_matches_jnp_segment_sweep(base, n):
    mids, tails = _genesis_row()
    got = K.search_candidates_hdr(mids[0], tails[0], base, n, HW1_CAP).tolist()
    found, first = _ref_segment(base)
    want = [1, first] if found and first < n else [0, K.NOT_FOUND]
    assert got == want
    assert got[0] == (N - base < n)


def test_k5_plain_both_arms_match_jnp_batched_sweep():
    # extranonces 3, 4, 5: the winner in row 1, a ragged row, then padding
    # rows (eight rows: the fast-path tests' plan shape)
    job = merkle.build_roll(GENESIS.pack(), PREFIX, SUFFIX, 1, ())
    pad = 5
    en_lo = [3, 4, 5] + [0] * pad
    bases = [N - 1000, N - 100, 17] + [0] * pad
    valids = [WIDTH, WIDTH, 300] + [0] * pad
    goffs = [0, WIDTH, 2 * WIDTH] + [2 * WIDTH + 300] * pad
    width = WIDTH
    mids, tails = merkle.roll_plain(job, _i64([0] * 8), _i64(en_lo))
    roll = ref_merkle.make_extranonce_roll_batch(GENESIS.pack(), PREFIX, SUFFIX, 1, ())
    ref_mids, ref_tails = roll(_u32([0] * 8), _u32(en_lo))
    want = np.asarray(ref_rolled._jnp_batched_candidate_sweep(
        ref_mids, ref_tails, _u32(bases), _u32(valids), _u32(goffs), jnp.uint32(HW1_CAP),
        width, 32, False)).tolist()
    assert want == [1, WIDTH + 100]
    rows = []
    for fn in (K.search_candidates_hdr_batch, K.search_candidates_hdr_batch_sched):
        handle = fn(mids, tails, _i64(bases), _i64(valids), width, HW1_CAP)
        rows.append(handle.tolist())
        assert rolled.fold_rows(handle, _i64(goffs)).tolist() == want
    assert rows[0] == rows[1] == [[0, K.NOT_FOUND], [1, 100]] + [[0, K.NOT_FOUND]] * 6


def test_rolled_wrappers_run_plain_on_cpu_and_check_inputs():
    mids, tails = _genesis_row()
    counts = [fn.launches for fn in K.KERNELS]
    K.search_candidates_hdr(mids[0], tails[0], N - 10, 16)
    K.search_candidates_hdr_batch_sched(mids, tails, _i64([N]), _i64([1]), 8)
    assert [fn.launches for fn in K.KERNELS] == counts  # plain runs are not launches
    with pytest.raises(ValueError):
        K.search_candidates_hdr(mids[0], tails[0], 0, 0)
    with pytest.raises(ValueError):
        K.search_candidates_hdr(mids[0].to(torch.int32), tails[0], 0, 16)
    with pytest.raises(ValueError):
        K.search_candidates_hdr_batch(mids, tails, _i64([N, 0]), _i64([1]), 8)
    with pytest.raises(ValueError):
        K.search_candidates_hdr_batch(mids, tails, _i64([N]), _i64([1]), 1 << 31)


# -- CandidateSearch over global indices --------------------------------------

def test_candidate_search_domain_matches_reference():
    """A scripted sweep over a 40-bit domain: candidates at known global
    indices, a false positive, and a winner; the port and the reference
    must agree at every event."""
    cands = {(3 << 32) + 500: False, (3 << 32) + 5000: True, (3 << 32) + 900: False}
    lower, upper = (3 << 32) + 100, (3 << 32) + 9000

    def sweep(base, n):
        hits = sorted(g for g in cands if base <= g < base + n)
        return (1, hits[0] - base) if hits else (0, K.NOT_FOUND)

    def verify(g):
        return cands[g], g * 7

    def run(cls, resolve):
        s = cls(sweep, resolve, verify, lower, upper, slab=1000, depth=2,
                domain=1 << 40)
        trace = []
        for _ in s.events():
            trace.append((s.searched, s.settled_high_water(), s.best_candidate()))
        return trace, dataclasses.astuple(s.outcome)

    got = run(search.CandidateSearch, lambda h: h)
    want = run(ref_search.CandidateSearch, lambda h: h)
    assert got == want
    assert got[1][:2] == (True, (3 << 32) + 5000)
    with pytest.raises(ValueError):
        search.CandidateSearch(sweep, None, verify, 0, 1 << 32, slab=4)


# -- the whole miner -----------------------------------------------------------

@pytest.mark.parametrize("roll_batch,sched_share", [(8, True), (8, False), (1, True)],
                         ids=["b8-sched", "b8-plain", "b1"])
def test_fast_path_matches_mine_rolled_fast(roll_batch, sched_share):
    req = _genesis_job((4 << 32) | (N - 3000), (4 << 32) | (N + 1000))
    got = _one(CudaMiner(device="cpu", slab=WIDTH, roll_batch=roll_batch,
                         sched_share=sched_share).mine(_port(req)))
    want = _one(ref_rolled.mine_rolled_fast(req, engine="jnp", sched_share=False,
                                            slab=WIDTH, roll_batch=roll_batch))
    assert _fields(got) == _fields(want)
    assert (got.nonce, got.found, got.searched) == (WINNER, True, 3001)
    assert ref_chain.hash_to_hex(got.hash_value.to_bytes(32, "little")) == (
        ref_chain.GENESIS_HASH_HEX)


def test_fast_path_exhausted_reports_min_untracked():
    req = _genesis_job((4 << 32) | (N - 3000), (4 << 32) | (N - 2000), target=1)
    got = _one(CudaMiner(device="cpu", slab=WIDTH).mine(_port(req)))
    want = _one(ref_rolled.mine_rolled_fast(req, engine="jnp", sched_share=False,
                                            slab=WIDTH))
    assert _fields(got) == _fields(want)
    assert (got.hash_value, got.found, got.searched) == (ref.MIN_UNTRACKED, False, 1001)


@pytest.fixture(scope="module")
def truth():
    prefix, suffix, branch, hdr80 = fixture()
    all_h = brute(prefix, suffix, branch, hdr80)
    return (prefix, suffix, branch, hdr80), all_h, min(all_h)


def _fixture_request(parts, target, lower=0, upper=(ENS << NB) - 1):
    prefix, suffix, branch, hdr80 = parts
    return ref.Request(3, ref.PowMode.TARGET, lower, upper, header=hdr80, target=target,
                       coinbase_prefix=prefix, coinbase_suffix=suffix, extranonce_size=4,
                       branch=tuple(branch), nonce_bits=NB, chunk_id=9)


@pytest.mark.parametrize("case", ["winner", "exhausted", "partial"])
def test_tracking_path_matches_cpu_miner(truth, case):
    parts, all_h, (h_min, g_min) = truth
    assert h_min > 1 << 225  # toy-easy: the tracking path's targets
    lower, upper = 0, (ENS << NB) - 1
    target = h_min if case == "winner" else h_min - 1
    if case == "partial":
        lower, upper = (1 << NB) + 100, (3 << NB) + 50
    req = _fixture_request(parts, target, lower, upper)
    got = _one(CudaMiner(device="cpu", roll_batch=8).mine(_port(req)))
    want = _one(CpuMiner(batch=256).mine(req))
    assert _fields(got) == _fields(want)
    if case == "winner":
        assert (got.found, got.nonce, got.hash_value) == (True, g_min, h_min)
    else:
        assert got.hash_value == min(h for h, g in all_h if lower <= g <= upper)
