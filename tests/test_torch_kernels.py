"""The kernels' plain versions (tpuminter_torch.kernels.sha256) against
the JAX package's CPU references: the jnp path of ``tpuminter.ops``
(the SHA Pallas kernels cannot run in interpret mode on the CPU),
``JaxMiner`` and hashlib. Exact integer equality throughout.

The CUDA kernels themselves run only on the card; ``chip_smoke.py``
holds each against these plain versions there.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuminter import chain as ref_chain
from tpuminter.jax_worker import JaxMiner
from tpuminter.ops import sha256 as ref_ops
from tpuminter.ops import symbolic as ref_sym
from tpuminter.protocol import PowMode, Request
from tpuminter_torch.kernels import sha256 as K
from tpuminter_torch.ops import sha256 as ops

GENESIS = ref_chain.GENESIS_HEADER
GENESIS_NONCE = 2083236893
TARGET = ref_chain.bits_to_target(GENESIS.bits)
HW1_CAP = int(ref_ops.target_to_words(TARGET)[1])
REGTEST = GENESIS.pack()[:72] + (0x207FFFFF).to_bytes(4, "little") + b"\0" * 4


def _nonces(base, n):
    return (np.uint64(base) + np.arange(n, dtype=np.uint64)) & np.uint64(0xFFFFFFFF)


#: windows whose candidate masks the jnp path computes once
_REF_WINDOWS = ((GENESIS_NONCE - 4095, 4095 + 3096), (123_456_789, 4096))


@functools.lru_cache(maxsize=None)
def _ref_candidate_mask(base, n):
    hdr = GENESIS
    e60, e61 = ref_ops.header_e60_e61_dyn(
        jnp.asarray(np.array(hdr.midstate(), dtype=np.uint32)),
        jnp.asarray(np.array(hdr.tail_words(), dtype=np.uint32)),
        jnp.asarray(_nonces(base, n).astype(np.uint32)),
    )
    hw1 = ref_ops.byteswap32(jnp.uint32(ref_sym.DIGEST6_BIAS) + e61)
    return np.asarray((e60 == jnp.uint32(ref_sym.CAND_E60)) & (hw1 <= jnp.uint32(HW1_CAP)))


def _ref_candidates(base, n):
    """First candidate offset of the genesis header by the jnp path, or None."""
    for wbase, wn in _REF_WINDOWS:
        if wbase <= base and base + n <= wbase + wn:
            hits = np.flatnonzero(_ref_candidate_mask(wbase, wn)[base - wbase:base - wbase + n])
            return int(hits[0]) if len(hits) else None
    raise AssertionError("window outside the reference windows")


@pytest.mark.parametrize("base,n", [
    (GENESIS_NONCE - 1000, 4096),   # the genesis winner at offset 1000
    (GENESIS_NONCE - 4095, 4096),   # ... at the last offset
    (GENESIS_NONCE - 4095, 4095),   # ... masked out by n
    (GENESIS_NONCE, 1),
    (GENESIS_NONCE - 1, 1),
    (123_456_789, 4096),            # a candidate-free window
], ids=["offset-1000", "last-offset", "masked-by-n", "n1-hit", "n1-miss", "free"])
def test_search_candidates_plain_matches_jnp(base, n):
    got = K.search_candidates_plain(ops.header_template(GENESIS.pack()), base, n, HW1_CAP)
    want = _ref_candidates(base, n)
    assert got.tolist() == ([1, want] if want is not None else [0, K.NOT_FOUND])
    if base == GENESIS_NONCE - 1000:
        assert got.tolist() == [1, 1000]


def test_search_candidates_wrapper_runs_plain_on_cpu():
    tmpl = ops.header_template(GENESIS.pack())
    before = K.search_candidates.launches
    got = K.search_candidates(tmpl, GENESIS_NONCE - 1000, 4096, HW1_CAP, device="cpu")
    assert got.tolist() == [1, 1000]
    assert K.search_candidates.launches == before  # plain runs are not launches
    with pytest.raises(ValueError):
        K.search_candidates(tmpl, 0, 0, HW1_CAP, device="cpu")
    with pytest.raises(ValueError):
        K.search_candidates(ops.toy_template(b"x"), 0, 16, HW1_CAP, device="cpu")


def _ref_search_target(header, base, n, target):
    nonces = jnp.asarray(_nonces(base, n).astype(np.uint32))
    hw = ref_ops.hash_words_be(
        ref_ops.double_sha256_header_batch(ref_ops.header_template(header), nonces)
    )
    ok = np.asarray(ref_ops.lex_le(hw, jnp.asarray(ref_ops.target_to_words(target))))
    midx = int(ref_ops.lex_argmin(hw))
    hits = np.flatnonzero(ok)
    first = int(hits[0]) if len(hits) else None
    return first, [int(w) for w in np.asarray(hw[midx])], midx


@pytest.mark.parametrize("header,base,n,bits", [
    (REGTEST, 0, 4096, 0x207FFFFF),
    (GENESIS.pack(), GENESIS_NONCE - 3000, 4096, 0x1D00FFFF),
    (GENESIS.pack(), GENESIS_NONCE - 5000, 4000, 0x1D00FFFF),
], ids=["regtest", "genesis-at-3000", "exhausted"])
def test_search_target_plain_matches_jnp(header, base, n, bits):
    target = ref_chain.bits_to_target(bits)
    words = [int(w) for w in ref_ops.target_to_words(target)]
    got = K.search_target_plain(ops.header_template(header), words, base, n).tolist()
    first, min_words, min_off = _ref_search_target(header, base, n, target)
    if first is None:
        assert got == [0, K.NOT_FOUND, *min_words, min_off]
    else:
        assert got[:2] == [1, first]


def test_plain_lex_argmin_ties_to_lowest_offset_like_reference():
    rng = np.random.default_rng(7)
    words = rng.integers(0, 3, (4096, 8)).astype(np.uint32)  # many exact ties
    want = int(ref_ops.lex_argmin(jnp.asarray(words)))
    keys = [torch.from_numpy(words[:, k].astype(np.int64)) for k in range(8)]
    assert K._argmin_lex(keys) == want
    assert (words[:want] != words[want]).any(axis=1).all()  # no equal row before it


def _jax_min(data, lower, upper):
    res = [r for r in JaxMiner(batch=4096).mine(
        Request(1, PowMode.MIN, lower, upper, data=data)) if r is not None][0]
    return res.hash_value, res.nonce


@pytest.mark.parametrize("data,base", [
    (b"hello bitcoin", 0),
    (bytes(range(60)), (5 << 32) | 0xFFFFF800),  # nonce straddles a block; lo wraps
], ids=["short", "straddle-and-carry"])
def test_min_toy_plain_matches_jaxminer_and_toy_hash(data, base):
    n = 4096
    fh, fl, off = K.min_toy_plain(ops.toy_template(data), base >> 32, base & 0xFFFFFFFF, n).tolist()
    got = ((fh << 32) | fl, base + off)
    assert got == _jax_min(data, base, base + n - 1)
    assert got == min((ref_chain.toy_hash(data, x), x) for x in range(base, base + n))


def test_sha256_batch_plain_matches_hashlib():
    data = b"tpuminter"
    rng = np.random.default_rng(3)
    hi = torch.from_numpy(rng.integers(0, 1 << 32, 64, dtype=np.int64))
    lo = torch.from_numpy(rng.integers(0, 1 << 32, 64, dtype=np.int64))
    got = K.sha256_batch(ops.toy_template(data), hi, lo)
    for i in range(64):
        nonce = (int(hi[i]) << 32) | int(lo[i])
        want = ref_chain.sha256(data + nonce.to_bytes(8, "big"))
        assert bytes().join(int(w).to_bytes(4, "big") for w in got[i]) == want


def test_bound_op_count_walks_sha256_itself():
    """The on-card script's bound counts instructions on a dataflow graph
    of SHA-256: folded on constants the graph is SHA-256 (hashlib), a
    compression of run-time words costs 64 rounds x 14 + 48 schedule
    words x 10 + 8 final adds, and every rolled search arm counts one
    function."""
    import hashlib
    import struct

    import chip_smoke as cs

    msg = bytes(range(55))
    block = struct.unpack(">16I", msg + b"\x80" + struct.pack(">Q", 8 * len(msg)))
    words = cs._compress(cs._h0(), list(block))
    assert struct.pack(">8I", *words) == hashlib.sha256(msg).digest()
    var = [cs.leaf(cs.NONCE) for _ in range(24)]
    assert cs._count(cs._compress(var[:8], var[8:])) == (64 * 14 + 48 * 10 + 8, 0)
    arms = {cs.op_count(name) for name in ("search_candidates_hdr", "search_candidates_hdr_batch",
                                           "search_candidates_hdr_batch_sched")}
    assert len(arms) == 1
