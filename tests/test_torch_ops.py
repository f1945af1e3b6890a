"""tpuminter_torch.ops.sha256 against tpuminter.ops.sha256.

Templates are compared field for field; the plain int64-lane digest and
the truncated (e60, e61) are held to the JAX package's jnp path on the
same seeded nonces, with exact integer equality.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuminter import chain as ref_chain
from tpuminter.ops import sha256 as ref_ops
from tpuminter_torch.ops import sha256 as ops

SEED = 1234
TOY_LENGTHS = [0, 1, 47, 55, 56, 63, 64, 119, 130]


def _headers():
    rng = np.random.default_rng(SEED)
    out = [ref_chain.GENESIS_HEADER.pack()]
    out += [rng.integers(0, 256, 80, dtype=np.uint8).tobytes() for _ in range(3)]
    return out


def _toy_data(length):
    return np.random.default_rng(SEED + length).integers(0, 256, length, dtype=np.uint8).tobytes()


def _same_template(mine, ref):
    assert mine.midstate == tuple(int(x) for x in ref.midstate)
    assert mine.tail == tuple(tuple(int(x) for x in b) for b in ref.tail)
    assert mine.positions == tuple(tuple(int(x) for x in p) for p in ref.positions)
    assert mine.double == ref.double


@pytest.mark.parametrize("index", range(4))
def test_header_template_matches_reference(index):
    header = _headers()[index]
    _same_template(ops.header_template(header), ref_ops.header_template(header))


@pytest.mark.parametrize("length", TOY_LENGTHS)
def test_toy_template_matches_reference(length):
    data = _toy_data(length)
    _same_template(ops.toy_template(data), ref_ops.toy_template(data))


@pytest.mark.parametrize("length", [0, 60, 130])
def test_template_from_arrays_round_trips(length):
    ref = ref_ops.toy_template(_toy_data(length))
    carried = ops.template_from_arrays(
        ref.midstate_array(), ref.tail_array(), ref.positions, ref.double
    )
    assert carried == ops.toy_template(_toy_data(length))
    again = ops.template_from_arrays(
        np.array(carried.midstate), np.array(carried.tail), carried.positions, carried.double
    )
    assert again == carried
    assert dataclasses.astuple(again) == dataclasses.astuple(carried)


def _nonces(n=2048):
    rng = np.random.default_rng(SEED)
    hi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return hi, lo


@pytest.mark.parametrize("kind", ["genesis-header", "toy-13", "toy-60", "toy-119"])
def test_plain_digest_matches_jnp_sha256_batch(kind):
    if kind == "genesis-header":
        msg = ref_chain.GENESIS_HEADER.pack()
        mine, ref = ops.header_template(msg), ref_ops.header_template(msg)
    else:
        data = _toy_data(int(kind.split("-")[1]))
        mine, ref = ops.toy_template(data), ref_ops.toy_template(data)
    hi, lo = _nonces()
    want = np.asarray(ref_ops.sha256_batch(ref, jnp.asarray(hi), jnp.asarray(lo)))
    got = ops.digest_words(
        mine, torch.from_numpy(hi.astype(np.int64)), torch.from_numpy(lo.astype(np.int64))
    )
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("index", [0, 1])
def test_plain_e60_e61_matches_jnp_header_e60_e61_dyn(index):
    header = _headers()[index]
    ref = ref_ops.header_template(header)
    hdr = ref_chain.BlockHeader.unpack(header)
    _, lo = _nonces()
    want60, want61 = ref_ops.header_e60_e61_dyn(
        jnp.asarray(np.array(hdr.midstate(), dtype=np.uint32)),
        jnp.asarray(np.array(hdr.tail_words(), dtype=np.uint32)),
        jnp.asarray(lo),
    )
    e60, e61 = ops.e60_e61(ops.template_from_arrays(
        ref.midstate_array(), ref.tail_array(), ref.positions, ref.double
    ), 0, torch.from_numpy(lo.astype(np.int64)))
    np.testing.assert_array_equal(e60.numpy(), np.asarray(want60).astype(np.int64))
    np.testing.assert_array_equal(e61.numpy(), np.asarray(want61).astype(np.int64))


def test_candidate_constants_match_reference():
    from tpuminter.ops import symbolic as ref_sym

    assert ops.CAND_E60 == ref_sym.CAND_E60
    assert ops.DIGEST6_BIAS == ref_sym.DIGEST6_BIAS
    target = ref_chain.bits_to_target(0x1D00FFFF)
    np.testing.assert_array_equal(ops.target_to_words(target), ref_ops.target_to_words(target))
