"""K2's header arm and K6's toy arm on the CPU
(``tpuminter_torch.kernels.sha256.search_target_header`` and
``min_toy_toy``), as ``search_target`` and ``min_toy`` choose them by the
template's shape.

``ops.toy_words`` must recognise exactly the templates ``toy_template``
builds, as ``ops.header_words`` does ``header_template``'s. The arms'
plain versions compute the arms' own formulas: the toy arm's with the
high nonce word folded into the message per launch, a nonce-free prefix
and the low word ORed in at its word (``ops.toy_launch``,
``ops.toy_fold_words``); the header arm's from a prepared header
(``ops.prepare_hdr``, ``ops.hash_prepared_digest``). They must equal the
JAX package's references bit for bit: ``chain.toy_hash`` and ``JaxMiner``
for MIN, the jnp header batch with ``lex_le`` / ``lex_argmin`` for the
target search (the Pallas kernels' unrolled graphs do not compile on the
CPU, so they run here as the JAX package's tests hold them).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuminter import chain as ref_chain
from tpuminter.jax_worker import JaxMiner
from tpuminter.ops import sha256 as ref_ops
from tpuminter.protocol import PowMode, Request
from tpuminter_torch.kernels import sha256 as K
from tpuminter_torch.ops import sha256 as ops

M32 = 0xFFFFFFFF
GENESIS = ref_chain.GENESIS_HEADER
GENESIS_NONCE = 2083236893


def _data(length, seed=0):
    return np.random.default_rng(seed + length).bytes(length)


def _generic_form(template):
    """The same function with its nonce bytes listed in reverse order,
    a form neither arm takes."""
    return dataclasses.replace(template, positions=template.positions[::-1])


# ---------------------------------------------------------------------------
# the toy arm's shape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length", range(131))
def test_toy_words_recognises_toy_templates(length):
    """Every length is recognised, and every launch has the shape the
    kernel is compiled for: the words past the low word zero but for the
    length, a second block exactly when ``k >= 13``, its words 1-13 zero
    and its word 0 zero unless the low word ends there (``k == 15``)."""
    data = _data(length)
    tmpl = ops.toy_template(data)
    words = ops.toy_words(tmpl)
    assert words == ops.ToyWords(tmpl.midstate, tmpl.tail, length % 64)
    for hi in (0, 0x80FF01FE, M32):
        launch = ops.toy_launch(words, hi)
        k, block = launch.k, launch.block
        assert 0 <= k <= 15 and launch.shift in (0, 8, 16, 24)
        assert ((length % 64) + 4) % 64 == 4 * k + launch.shift // 8
        if k <= 12:
            assert not any(block[k + 2:14]) and launch.block1 == (0, 0, 0)
            assert block[15] == (length + 8) * 8  # the length, in the last block
        else:
            assert not any(block[k + 2:]) and launch.block1[2] == (length + 8) * 8
            assert launch.block1[0] == 0 or k == 15


_TOY = ops.toy_template(b"hello bitcoin")
_TOY60 = ops.toy_template(bytes(range(60)))


@pytest.mark.parametrize("template", [
    _generic_form(_TOY),
    _generic_form(_TOY60),
    ops.header_template(GENESIS.pack()),
    dataclasses.replace(_TOY, double=True),
    ops._build_template(b"hello bitcoin" + bytes(8), 13, [(j, 56 - 8 * j) for j in range(8)],
                        double=True),
    dataclasses.replace(_TOY, tail=(_TOY.tail[0][:15] + (_TOY.tail[0][15] + 8,),)),   # length
    dataclasses.replace(_TOY, tail=(_TOY.tail[0][:3] + (1,) + _TOY.tail[0][4:],)),     # nonce byte set
    dataclasses.replace(_TOY, tail=(_TOY.tail[0][:5] + (0,) + _TOY.tail[0][6:],)),     # padding's 0x80
    dataclasses.replace(_TOY, positions=tuple((b, w, ws, 56 - ns) for b, w, ws, ns in _TOY.positions)),
    dataclasses.replace(_TOY60, tail=_TOY60.tail[:1]),                                 # a block short
], ids=["generic-13", "generic-60", "header", "double-sha", "double-sha-built", "pad-length",
        "nonce-byte-set", "pad-0x80", "little-endian-nonce", "one-block-short"])
def test_toy_words_refuses_other_templates(template):
    assert ops.toy_words(template) is None


# ---------------------------------------------------------------------------
# the toy arm's formula against toy_hash and JaxMiner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offset", range(64))
def test_toy_arm_plain_matches_toy_hash(offset):
    """64 nonces at every nonce offset within a block (one, two or three
    blocks of data before it), across a low-word wrap at every fourth
    offset: each nonce's fold, and the arm's minimum."""
    data = _data(offset + 64 * (offset % 3), seed=1)
    words = ops.toy_words(ops.toy_template(data))
    rng = np.random.default_rng(offset)
    hi = int(rng.integers(0, 1 << 32))
    lo = (1 << 32) - 32 if offset % 4 == 0 else int(rng.integers(0, (1 << 32) - 64))
    want = [ref_chain.toy_hash(data, ((hi << 32) + lo + i) % (1 << 64)) for i in range(64)]
    split = min(64, (1 << 32) - lo)
    first = ops.toy_fold_words(ops.toy_launch(words, hi),
                               lo + torch.arange(split, dtype=torch.int64))
    got = [(int(a) << 32) | int(b) for a, b in zip(*first)]
    if split < 64:
        rest = ops.toy_fold_words(ops.toy_launch(words, (hi + 1) & M32),
                                  torch.arange(64 - split, dtype=torch.int64))
        got += [(int(a) << 32) | int(b) for a, b in zip(*rest)]
    assert got == want
    fh, fl, off = K.min_toy_toy_plain(words, hi, lo, 64).tolist()
    assert ((fh << 32) | fl, off) == min((v, i) for i, v in enumerate(want))


def _jax_min(data, lower, upper):
    res = [r for r in JaxMiner(batch=4096).mine(
        Request(1, PowMode.MIN, lower, upper, data=data)) if r is not None][0]
    return res.hash_value, res.nonce


@pytest.mark.parametrize("length,base", [
    (13, (5 << 32) | ((1 << 32) - 2000)),
    (58, (9 << 32) | ((1 << 32) - 1000)),  # the low word straddles two blocks
], ids=["13-bytes", "58-bytes"])
def test_toy_arm_plain_matches_jaxminer_across_a_wrap(length, base):
    data = _data(length, seed=2)
    n = 4096
    fh, fl, off = K.min_toy_toy_plain(ops.toy_words(ops.toy_template(data)), base >> 32,
                                      base & M32, n).tolist()
    assert ((fh << 32) | fl, base + off) == _jax_min(data, base, base + n - 1)


# ---------------------------------------------------------------------------
# the header arm against the reference's batch, lex_le and lex_argmin
# ---------------------------------------------------------------------------

#: the reference window: the genesis header's nonces from BASE, its
#: winner at lane 1500
BASE, LANES = GENESIS_NONCE - 1500, 2048


@functools.lru_cache(maxsize=None)
def _ref_hash_words():
    nonces = (np.uint64(BASE) + np.arange(LANES, dtype=np.uint64)) & np.uint64(M32)
    return ref_ops.hash_words_be(ref_ops.double_sha256_header_batch(
        ref_ops.header_template(GENESIS.pack()), jnp.asarray(nonces.astype(np.uint32))))


def _ref_handle(lo, n, target_words):
    """``pallas_search_target``'s handle on lanes ``[lo, lo + n)`` of the
    reference window: the first hit, else the exact minimum."""
    hw = _ref_hash_words()[lo:lo + n]
    ok = np.asarray(ref_ops.lex_le(hw, jnp.asarray(np.array(target_words, dtype=np.uint32))))
    hits = np.flatnonzero(ok)
    if len(hits):
        return [1, int(hits[0])]
    midx = int(ref_ops.lex_argmin(hw))
    return [0, K.NOT_FOUND, *(int(w) for w in np.asarray(hw[midx])), midx]


def _bits_words(bits):
    return [int(w) for w in ref_ops.target_to_words(ref_chain.bits_to_target(bits))]


def _lane_words(lane, delta=0):
    """A target equal to a reference lane's hash value plus ``delta``."""
    value = int.from_bytes(np.asarray(_ref_hash_words()[lane]).astype(">u4").tobytes(), "big")
    return [int(w) for w in ref_ops.target_to_words(value + delta)]


TARGET_CASES = [
    (0, 1024, lambda: _bits_words(0x207FFFFF)),     # regtest difficulty: a hit at once
    (0, 2048, lambda: _bits_words(0x1D00FFFF)),     # the genesis winner at lane 1500
    (0, 1400, lambda: _bits_words(0x1D00FFFF)),     # exhausted: the exact minimum
    (100, 1000, lambda: [0] * 8),                   # nothing hits
    (0, 1024, lambda: _lane_words(777)),            # lane 777's hash word 0 ties the target's
    (0, 1024, lambda: _lane_words(777, -1)),        # ... and its value is one above it
]


@pytest.mark.parametrize("lo,n,target", TARGET_CASES,
                         ids=["regtest", "genesis-hit", "exhausted", "target-0", "at-a-hash",
                              "below-a-hash"])
def test_header_arm_plain_matches_reference(lo, n, target):
    words = target()
    want = _ref_handle(lo, n, words)
    hw = ops.header_words(ops.header_template(GENESIS.pack()))
    got = K.search_target_header_plain(hw, words, BASE + lo, n).tolist()
    assert got[:len(want)] == want
    if n == 2048 and words == _bits_words(0x1D00FFFF):
        assert want == [1, 1500]


def test_running_minimum_ties_on_hash_word_0(monkeypatch):
    """K2's minimum carried across sweeps (the plain version's chunks, as
    a kernel thread carries its own across nonces) where later nonces
    tie the running minimum's hash word 0: the later words decide, and
    equal values keep the lowest offset, as the reference's
    ``lex_argmin`` does over the whole window."""
    monkeypatch.setitem(K.PLAIN_CHUNK, "cpu", 32)
    rng = np.random.default_rng(9)
    n = 256
    hw = rng.integers(0, 1 << 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    hw[:, 0] = rng.integers(5, 8, n)  # word 0 of every lane ties many others
    hw[100, 0], hw[200, 0], hw[201, 0], hw[202, 0] = 5, 5, 4, 4  # ... the minimum's too
    hw[201, 1:] = hw[202, 1:]  # an exact tie: the lower offset wins
    hw[200, 1] = hw[100, 1]
    # digest word j is hash word 7 - j byteswapped (ops.hash_words_be)
    digests = [torch.from_numpy(hw[:, 7 - j].byteswap().astype(np.int64)) for j in range(8)]

    def digest_of(nonces):
        return [d[nonces] for d in digests]

    for target in ([0] * 8, [4] + [0] * 7, [5] * 8, [M32] * 8):
        got = K._target_scan(digest_of, target, 0, n, "cpu").tolist()
        ok = np.asarray(ref_ops.lex_le(jnp.asarray(hw), jnp.asarray(np.array(target, np.uint32))))
        hits = np.flatnonzero(ok)
        midx = int(ref_ops.lex_argmin(jnp.asarray(hw)))
        if len(hits):
            assert got[:2] == [1, int(hits[0])]
        else:
            assert got == [0, K.NOT_FOUND, *hw[midx].tolist(), midx]
            assert midx == 201


# ---------------------------------------------------------------------------
# dispatch by shape, and the wrappers' checks
# ---------------------------------------------------------------------------

def _spy(monkeypatch, name):
    calls = []
    real = getattr(K, name)

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(K, name, spy)
    return calls


def test_search_target_dispatches_by_shape_on_cpu(monkeypatch):
    """A header template runs the header arm, its generic form the
    generic plain version, with equal handles and no launch counted."""
    calls = _spy(monkeypatch, "search_target_header")
    tmpl = ops.header_template(GENESIS.pack())
    words, base = _bits_words(0x1D00FFFF), GENESIS_NONCE - 600
    before = [fn.launches for fn in K.KERNELS]
    got = K.search_target(tmpl, words, base, 1024, device="cpu").tolist()
    assert len(calls) == 1 and calls[0][0] == ops.header_words(tmpl)
    assert K.search_target(_generic_form(tmpl), words, base, 1024, device="cpu").tolist() == got
    assert len(calls) == 1 and got[:2] == [1, 600]
    assert [fn.launches for fn in K.KERNELS] == before


def test_min_toy_dispatches_by_shape_on_cpu(monkeypatch):
    """A toy template runs the toy arm, its generic form the generic
    plain version, with equal handles across a low-word wrap and no
    launch counted."""
    calls = _spy(monkeypatch, "min_toy_toy")
    data = _data(58, seed=3)
    tmpl = ops.toy_template(data)
    base = (3 << 32) | ((1 << 32) - 700)
    before = [fn.launches for fn in K.KERNELS]
    got = K.min_toy(tmpl, base >> 32, base & M32, 2048, device="cpu").tolist()
    assert len(calls) == 1 and calls[0][0] == ops.toy_words(tmpl)
    assert K.min_toy(_generic_form(tmpl), base >> 32, base & M32, 2048,
                     device="cpu").tolist() == got
    assert len(calls) == 1
    fh, fl, off = got
    assert (fh << 32) | fl == ref_chain.toy_hash(data, base + off)
    assert [fn.launches for fn in K.KERNELS] == before


def test_arms_refuse_bad_arguments():
    words = ops.toy_words(_TOY)
    with pytest.raises(ValueError):
        K.min_toy_toy(words, 0, 0, 0, device="cpu")
    with pytest.raises(ValueError):
        K.min_toy_toy(words, 1 << 32, 0, 16, device="cpu")
    with pytest.raises(ValueError):
        K.min_toy_toy(_TOY, 0, 0, 16, device="cpu")
    hw = ops.header_words(ops.header_template(GENESIS.pack()))
    with pytest.raises(ValueError):
        K.search_target_header(hw, [0] * 7, 0, 16, device="cpu")
    with pytest.raises(ValueError):
        K.search_target_header(hw[:3], [0] * 8, 0, 16, device="cpu")
    with pytest.raises(ValueError):
        K.search_target_header(hw, [0] * 8, 0, 0, device="cpu")
