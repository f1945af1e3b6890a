"""K3's two arms on the CPU: the header arm
(``tpuminter_torch.kernels.sha256.search_candidates_header``) and the
generic kernel, as ``search_candidates`` chooses between them.

``ops.header_words`` must recognise exactly the templates
``header_template`` builds. The header arm's plain version (the
shared-schedule formula, ``ops.prepare_hdr`` + ``hash_prepared_e60_e61``)
must equal the generic plain version and the JAX package's
``pallas_search_candidates``. That kernel's unrolled SHA graph does not
compile on the CPU, so it runs here as the JAX package's tests hold it:
through the formula its body evaluates, ``symbolic.double_sha256_e60_e61``
on jnp lanes. Exact integer equality throughout.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from tpuminter import chain as ref_chain
from tpuminter.ops import sha256 as ref_ops
from tpuminter.ops import symbolic as ref_sym
from tpuminter_torch.kernels import sha256 as K
from tpuminter_torch.ops import sha256 as ops

M32 = 0xFFFFFFFF
GENESIS = ref_chain.GENESIS_HEADER
GENESIS_NONCE = 2083236893
BLOCK1 = ref_chain.BlockHeader(
    1, bytes.fromhex("000000000019d6689c085ae165831e934ff763ae46a2a6c172b3f1b60a8ce26f")[::-1],
    bytes.fromhex("0e3e2357e806b6cdb1f70b54c3a3a17b6714ee1f0e68bebb44a74b1efd512098")[::-1],
    1231469665, 0x1D00FFFF, 2573394689,
)
HW1_CAP = int(ref_ops.target_to_words(ref_chain.bits_to_target(GENESIS.bits))[1])
#: a 100-byte message with a little-endian nonce at bytes 60-63: a
#: double-SHA template with two tail blocks, which the header arm refuses
TWO_BLOCK_MSG = bytes(np.random.default_rng(7).integers(0, 256, 60, dtype=np.uint8)) \
    + bytes(4) + bytes(range(36))
LE_NONCE = [(j, 8 * j) for j in range(4)]

#: each message's reference window (first nonce, lanes): the genesis and
#: block 1 winners at its last offset, the two-block message at a seeded base
WINDOWS = {
    "genesis": (GENESIS_NONCE - 8191, 8192),
    "block1": (BLOCK1.nonce - 8191, 8192),
    "two-block": (int(np.random.default_rng(8).integers(0, 1 << 32)), 4096),
}


def _templates(name):
    """(the port's template, the reference's) for a message name."""
    if name == "two-block":
        return (ops._build_template(TWO_BLOCK_MSG, 60, LE_NONCE, double=True),
                ref_ops._build_template(TWO_BLOCK_MSG, 60, LE_NONCE, double=True))
    header = (GENESIS if name == "genesis" else BLOCK1).pack()
    return ops.header_template(header), ref_ops.header_template(header)


@functools.lru_cache(maxsize=None)
def _ref_lanes(name):
    """e60 and hash word 1 of every nonce of the message's window, by the
    reference kernel's formula on jnp lanes."""
    wbase, wn = WINDOWS[name]
    nonces = (np.uint64(wbase) + np.arange(wn, dtype=np.uint64)) & np.uint64(M32)
    e60, e61 = ref_sym.double_sha256_e60_e61(_templates(name)[1], 0,
                                             jnp.asarray(nonces.astype(np.uint32)))
    hw1 = ref_ops.byteswap32(jnp.uint32(ref_sym.DIGEST6_BIAS) + e61)
    return np.asarray(e60), np.asarray(hw1)


def _ref_handle(name, base, n, cap):
    """``pallas_search_candidates``'s ``[found, first_off]``."""
    e60, hw1 = _ref_lanes(name)
    lo = base - WINDOWS[name][0]
    ok = (e60[lo:lo + n] == ref_sym.CAND_E60) & (hw1[lo:lo + n] <= cap)
    hits = np.flatnonzero(ok)
    return [1, int(hits[0])] if len(hits) else [0, K.NOT_FOUND]


def _seeded_windows(name, count, seed):
    """Windows of the message's reference window at seeded bases and
    lengths, each at the cap that lets every candidate hit."""
    wbase, wn = WINDOWS[name]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        lo = int(rng.integers(0, wn))
        out.append((name, wbase + lo, int(rng.integers(1, wn - lo + 1)), M32))
    return out


_GENESIS_WINNER_HW1 = int.from_bytes(GENESIS.block_hash()[::-1][4:8], "big")

WINDOW_CASES = [
    ("genesis", GENESIS_NONCE - 1000, 4096, HW1_CAP),       # the genesis winner at offset 1000
    ("genesis", GENESIS_NONCE - 1000, 1000, HW1_CAP),       # ... masked out by n
    ("genesis", GENESIS_NONCE, 1, HW1_CAP),
    ("genesis", GENESIS_NONCE - 64, 65, _GENESIS_WINNER_HW1),       # a cap at its word 1
    ("genesis", GENESIS_NONCE - 64, 65, _GENESIS_WINNER_HW1 - 1),   # ... just under it
    ("block1", BLOCK1.nonce - 5000, 5001, HW1_CAP),          # block 1's winner at offset 5000
    ("two-block", WINDOWS["two-block"][0], 4096, M32),
] + _seeded_windows("genesis", 4, 11) + _seeded_windows("block1", 3, 12)


_GT = ops.header_template(GENESIS.pack())
_RNG = np.random.default_rng(13)


def _header_like(**changes):
    """The genesis header template with some of its fields replaced."""
    return dataclasses.replace(_GT, **changes)


@pytest.mark.parametrize("header", [
    GENESIS.pack(), BLOCK1.pack(), *(_RNG.bytes(80) for _ in range(3)),
], ids=["genesis", "block1", "seeded0", "seeded1", "seeded2"])
def test_header_words_recognises_header_templates(header):
    ref = ref_chain.BlockHeader.unpack(header)
    assert ops.header_words(ops.header_template(header)) == (ref.midstate(), *ref.tail_words())


@pytest.mark.parametrize("template", [
    ops.toy_template(b"hello bitcoin"),
    ops.toy_template(bytes(range(60))),
    ops._build_template(TWO_BLOCK_MSG, 60, LE_NONCE, double=True),
    dataclasses.replace(_GT, double=False),
    _header_like(tail=(_GT.tail[0][:15] + (641,),)),                  # padding length
    _header_like(tail=(_GT.tail[0][:4] + (0,) + _GT.tail[0][5:],)),   # padding's 0x80
    _header_like(tail=(_GT.tail[0][:3] + (1,) + _GT.tail[0][4:],)),   # nonce word not zeroed
    _header_like(positions=tuple((b, w, ws, 24 - ns) for b, w, ws, ns in _GT.positions)),
    _header_like(positions=tuple((b, 2, ws, ns) for b, _, ws, ns in _GT.positions)),
], ids=["toy-short", "toy-60", "two-tail-blocks", "single-sha", "pad-length", "pad-0x80",
        "nonce-word-set", "big-endian-nonce", "nonce-in-word-2"])
def test_header_words_refuses_other_templates(template):
    assert ops.header_words(template) is None


@pytest.mark.parametrize("name,base,n,cap", WINDOW_CASES)
def test_header_arm_plain_matches_generic_and_reference(name, base, n, cap):
    tmpl, _ = _templates(name)
    want = _ref_handle(name, base, n, cap)
    assert K.search_candidates_plain(tmpl, base, n, cap).tolist() == want
    words = ops.header_words(tmpl)
    if words is not None:
        assert K.search_candidates_header_plain(words, base, n, cap).tolist() == want
    if base == GENESIS_NONCE - 1000 and n == 4096:
        assert want == [1, 1000]
    if base == BLOCK1.nonce - 5000:
        assert want == [1, 5000]


@pytest.mark.parametrize("name", ["genesis", "two-block"])
def test_search_candidates_dispatches_by_shape_on_cpu(name):
    """The wrapper's plain runs give the reference's handle for both
    shapes, and for a header template's nonce bytes listed in another
    order (the generic arm), and count no launch."""
    tmpl, _ = _templates(name)
    base, n = (GENESIS_NONCE - 1000, 4096) if name == "genesis" else WINDOWS[name]
    before = [fn.launches for fn in K.KERNELS]
    want = _ref_handle(name, base, n, HW1_CAP)
    assert K.search_candidates(tmpl, base, n, HW1_CAP, device="cpu").tolist() == want
    reordered = dataclasses.replace(tmpl, positions=tmpl.positions[::-1])
    assert ops.header_words(reordered) is None
    assert K.search_candidates(reordered, base, n, HW1_CAP, device="cpu").tolist() == want
    words = ops.header_words(tmpl)
    assert (words is not None) == (name == "genesis")
    if words is not None:
        assert K.search_candidates_header(words, base, n, HW1_CAP,
                                          device="cpu").tolist() == want
    assert [fn.launches for fn in K.KERNELS] == before


def test_search_candidates_header_refuses_bad_words():
    words = ops.header_words(_GT)
    with pytest.raises(ValueError):
        K.search_candidates_header(words[:3], 0, 16, device="cpu")
    with pytest.raises(ValueError):
        K.search_candidates_header((words[0][:7], *words[1:]), 0, 16, device="cpu")
    with pytest.raises(ValueError):
        K.search_candidates_header((words[0], 1 << 32, *words[2:]), 0, 16, device="cpu")
    with pytest.raises(ValueError):
        K.search_candidates_header(words, 0, 0, device="cpu")
