"""The port miner's SCRYPT dialect against hashlib.scrypt.

``CudaMiner(device="cpu")`` mines SCRYPT chunks on the SCRYPT kernels'
plain versions (``kernels.scrypt`` routes CPU tensors to them). Its
Results must be the reference's (``JaxMiner._mine_scrypt``): the first
winner with ``searched`` up to it, or the exact minimum of an exhausted
chunk with ``searched`` the whole chunk, here held against
``hashlib.scrypt`` over every nonce and against the reference miner's
own loop (``JaxMiner(scrypt_batch=16)._mine_scrypt``, its step's fold
compiled around hashlib digests at N = 16). Most chunks run at N = 16 (the
instance's ``scrypt_n_log2``), batches of 16 nonces with a ragged last
one; one runs at Litecoin's N = 1024. A rolled SCRYPT chunk must give
scrypt's answer on each extranonce's header, not double SHA's. The
tolerance is exact equality.
"""

import dataclasses
import hashlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpuminter import chain as ref_chain
from tpuminter import jax_worker
from tpuminter import protocol as ref_protocol
from tpuminter.ops import scrypt as ref_scrypt
from tpuminter_torch import chain
from tpuminter_torch.cuda_worker import CudaMiner
from tpuminter_torch.protocol import PowMode, Request

N_LOG2 = 4
HEADER = np.random.default_rng(20261018).bytes(80)


def _scrypt(header80: bytes, nonce: int, n_log2: int = N_LOG2) -> int:
    hdr = header80[:76] + struct.pack("<I", nonce)
    return ref_chain.hash_to_int(hashlib.scrypt(hdr, salt=hdr, n=1 << n_log2, r=1, p=1,
                                                dklen=32))


def _expected(hashes, target: int):
    """``(index, hash, found, searched)`` of the reference's SCRYPT
    contract (``tpuminter/jax_worker.py:279-300``) over ``[(index,
    hash), ...]`` in index order."""
    for k, (index, value) in enumerate(hashes):
        if value <= target:
            return index, value, True, k + 1
    value, index = min((v, i) for i, v in hashes)
    return index, value, value <= target, len(hashes)


#: the port miner's answer per (miner, request): the reference-miner test
#: asks again for chunks the hashlib tests mined, and a chunk costs about a
#: second of plain torch calls here
_MINED = {}


def _mine(miner, req):
    key = (id(miner), req)
    if key not in _MINED:
        results = [r for r in miner.mine(req) if r is not None]
        assert len(results) == 1
        r = results[0]
        _MINED[key] = r.nonce, r.hash_value, r.found, r.searched
    return _MINED[key]


@pytest.fixture(scope="module")
def miner():
    m = CudaMiner(device="cpu", scrypt_batch=16)
    m.scrypt_n_log2 = N_LOG2
    return m


def _request(lo, hi, target, **kw):
    return Request(1, PowMode.SCRYPT, lo, hi, header=HEADER, target=target, **kw)


LO, HI = 4_000_000_000, 4_000_000_040  # 41 nonces: batches of 16, 16 and 9
HASHES = [(n, _scrypt(HEADER, n)) for n in range(LO, HI + 1)]
#: a rolled chunk across an extranonce boundary at 4-bit nonces
ROLL_CB = np.random.default_rng(5).bytes(60)
ROLL_BRANCH = (np.random.default_rng(6).bytes(32),)
ROLL_TMPL = ref_chain.CoinbaseTemplate(ROLL_CB[:20], ROLL_CB[20:], 1)
ROLL_LO, ROLL_HI = (3 << 4) - 5, (3 << 4) + 6
ROLL_KW = dict(coinbase_prefix=ROLL_CB[:20], coinbase_suffix=ROLL_CB[20:], extranonce_size=1,
               branch=ROLL_BRANCH, nonce_bits=4)


def _rolled_hashes():
    hashes = []
    for g in range(ROLL_LO, ROLL_HI + 1):
        en, nonce = ref_chain.split_global(g, 4)
        hdr = ref_chain.rolled_header(HEADER, ROLL_TMPL, ROLL_BRANCH, en).pack()
        hashes.append((g, _scrypt(hdr, nonce)))
    return hashes


def _ragged_window():
    """``(hashes, winner)``: a 41-nonce window whose only winner (at its
    own hash as the target) sits at offset 35, in the third, 9-nonce
    batch."""
    hashes = [(n, _scrypt(HEADER, n)) for n in range(1000, 1400)]
    i = next(k for k in range(35, len(hashes) - 5)
             if hashes[k][1] == min(v for _, v in hashes[k - 35:k + 6]))
    return hashes[i - 35:i + 6], hashes[i]


def test_exhausted_chunk_reports_the_exact_minimum(miner):
    assert _mine(miner, _request(LO, HI, 1)) == _expected(HASHES, 1)


def test_found_chunk_reports_the_first_winner(miner):
    target = sorted(v for _, v in HASHES)[4]  # the 5th-smallest hash
    got = _mine(miner, _request(LO, HI, target))
    assert got == _expected(HASHES, target) and got[2]


def test_winner_in_the_ragged_last_batch(miner):
    """A chunk whose only winner sits at offset 35 of 41: in the third,
    9-nonce batch, after two whole batches without one."""
    window, (index, value) = _ragged_window()
    got = _mine(miner, _request(window[0][0], window[-1][0], value))
    assert got == (index, value, True, 36) == _expected(window, value)


def test_rolled_chunk_is_scrypt_not_double_sha(miner):
    """Rolled SCRYPT across an extranonce boundary (4-bit nonces):
    each index is hashed on its extranonce's rolled header, with
    scrypt. The SCRYPT mode is dispatched before ``rolled``, so the
    answer is not the double-SHA one."""
    hashes = _rolled_hashes()
    assert _mine(miner, _request(ROLL_LO, ROLL_HI, 1, **ROLL_KW)) == _expected(hashes, 1)
    target = sorted(v for _, v in hashes)[4]
    got = _mine(miner, _request(ROLL_LO, ROLL_HI, target, **ROLL_KW))
    assert got == _expected(hashes, target) and got[2]
    en, nonce = ref_chain.split_global(got[0], 4)
    hdr = ref_chain.rolled_header(HEADER, ROLL_TMPL, ROLL_BRANCH, en).with_nonce(nonce)
    assert got[1] != ref_chain.hash_to_int(hdr.block_hash())
    double_sha = Request(1, PowMode.TARGET, ROLL_LO, ROLL_HI, header=HEADER, target=target,
                         **ROLL_KW)
    assert _mine(miner, double_sha) != got


def test_chunk_at_litecoin_n():
    """Three nonces at N = 1024, the miner's own N: one ragged batch of
    its CPU default size."""
    lo = 2084524493
    hashes = [(n, _scrypt(HEADER, n, 10)) for n in range(lo, lo + 3)]
    assert _scrypt(HEADER, lo, 10) == ref_chain.hash_to_int(
        chain.scrypt_hash(HEADER[:76] + struct.pack("<I", lo)))
    miner = CudaMiner(device="cpu")
    assert miner.scrypt_n_log2 == 10
    assert _mine(miner, _request(lo, lo + 2, 1)) == _expected(hashes, 1)


def test_scrypt_is_served():
    miner = CudaMiner(device="cpu")
    assert miner.unsupported(_request(0, 10, 1)) is None
    assert miner.unsupported(_request(0, 10, 1, coinbase_prefix=b"\x01", nonce_bits=8)) is None


def _case(case):
    """The chunks of the hashlib tests above, by name."""
    if case == "ragged":
        window, (_, value) = _ragged_window()
        return _request(window[0][0], window[-1][0], value)
    if case.startswith("rolled"):
        target = 1 if case == "rolled_exhausted" else sorted(v for _, v in _rolled_hashes())[4]
        return _request(ROLL_LO, ROLL_HI, target, **ROLL_KW)
    return _request(LO, HI, 1 if case == "exhausted" else sorted(v for _, v in HASHES)[4])


def _hashlib_digests(header76w, nonces):
    hdr76 = np.asarray(header76w).astype(">u4").tobytes()
    rows = []
    for nonce in np.asarray(nonces):
        hdr = hdr76 + struct.pack("<I", int(nonce))
        rows.append(struct.unpack(">8I", hashlib.scrypt(hdr, salt=hdr, n=1 << N_LOG2, r=1, p=1,
                                                        dklen=32)))
    return np.array(rows, dtype=np.uint32)


def _hashlib_batch(header76w, nonces, n_log2=10):
    """``scrypt_header_batch``'s contract on hashlib at N = 16, as a host
    callback: the reference's step asks for its fixed N = 1024, which
    this stands in for as the port miner's ``scrypt_n_log2`` does."""
    return jax.pure_callback(_hashlib_digests,
                             jax.ShapeDtypeStruct((nonces.shape[0], 8), jnp.uint32),
                             header76w, nonces)


#: the reference's step compiled anew, with a cache of its own, so that
#: its trace through the hashlib stand-in reaches no other test
_REF_STEP = jax.jit(jax_worker._scrypt_step.__wrapped__, static_argnums=3)


@pytest.mark.parametrize("case", ["exhausted", "found", "ragged", "rolled_exhausted",
                                  "rolled_found"])
def test_results_equal_the_reference_miners(miner, monkeypatch, case):
    """The same chunk through ``JaxMiner(scrypt_batch=16)._mine_scrypt``:
    its own segments, pipeline and Result composition, and its
    ``_scrypt_step``'s fold, on digests from hashlib."""
    req = _case(case)
    monkeypatch.setattr(ref_scrypt, "scrypt_header_batch", _hashlib_batch)
    monkeypatch.setattr(jax_worker, "_scrypt_step", _REF_STEP)
    ref_req = ref_protocol.Request(**{f.name: getattr(req, f.name)
                                      for f in dataclasses.fields(ref_protocol.Request)})
    want = [r for r in jax_worker.JaxMiner(scrypt_batch=16)._mine_scrypt(ref_req)
            if r is not None]
    assert len(want) == 1
    want = want[0]
    assert _mine(miner, req) == (want.nonce, want.hash_value, want.found, want.searched)
