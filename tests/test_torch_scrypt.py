"""The port's scrypt lanes against the JAX package's and hashlib.

The plain versions in ``tpuminter_torch.ops.scrypt`` (Salsa20/8,
BlockMix, the ROMix walk, PBKDF2 at both ends, the batch fold) and the
SCRYPT kernels' wrappers on CPU tensors (S1 → 19 → S2, the row-gather
probe 11) must equal ``tpuminter.ops.scrypt`` (``salsa20_8`` and
``block_mix`` called eagerly, ``scrypt_header_batch`` under one jit at
N = 16 shared by the module), ``hashlib.scrypt`` and numpy. The
tolerance is exact equality.
"""

import hashlib
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuminter.ops import scrypt as ref
from tpuminter_torch import kernels
from tpuminter_torch.kernels import scrypt as K
from tpuminter_torch.ops import scrypt as S
from tpuminter_torch.ops import sha256 as ops

N_LOG2 = 4
M32 = 0xFFFFFFFF


def _lanes(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _value(digest_row) -> int:
    return int.from_bytes(b"".join(struct.pack(">I", int(w)) for w in digest_row), "little")


def _hashlib(hdr76: bytes, nonce: int, n_log2: int = N_LOG2):
    hdr = hdr76 + struct.pack("<I", nonce)
    return struct.unpack(">8I", hashlib.scrypt(hdr, salt=hdr, n=1 << n_log2, r=1, p=1,
                                               dklen=32))


@pytest.fixture(scope="module")
def batch():
    """A seeded header and 12 nonces (the u32 edges included) with the
    reference's digests: one jit of ``scrypt_header_batch`` at N = 16."""
    rng = np.random.default_rng(20261017)
    hdr76 = rng.bytes(76)
    nonces = np.concatenate([rng.integers(0, 1 << 32, 10, dtype=np.uint32),
                             np.array([0, M32], dtype=np.uint32)])
    digest = np.asarray(ref.scrypt_header_batch(
        jnp.asarray(ref.header_to_words(hdr76)), jnp.asarray(nonces), N_LOG2))
    return hdr76, nonces, digest


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_salsa20_8_equals_reference(seed):
    x = np.random.default_rng(seed).integers(0, 1 << 32, (5, 16), dtype=np.uint32)
    want = np.asarray(ref.salsa20_8(jnp.asarray(x)))
    assert torch.equal(S.salsa20_8(_lanes(x)), _lanes(want))


@pytest.mark.parametrize("seed", [4, 5])
def test_block_mix_equals_reference(seed):
    x = np.random.default_rng(seed).integers(0, 1 << 32, (3, 32), dtype=np.uint32)
    x[0] = M32  # every add carries
    want = np.asarray(ref.block_mix(jnp.asarray(x)))
    assert torch.equal(S.block_mix(_lanes(x)), _lanes(want))


def test_header_batch_equals_reference_and_hashlib(batch):
    hdr76, nonces, digest = batch
    got = S.scrypt_header_batch(S.header_to_words(hdr76), _lanes(nonces), N_LOG2)
    assert torch.equal(got, _lanes(digest))
    assert [tuple(r) for r in got.tolist()] == [_hashlib(hdr76, int(n)) for n in nonces]
    assert S.header_to_words(hdr76) == tuple(int(w) for w in ref.header_to_words(hdr76))


@pytest.mark.parametrize("stride_extra", [0, 5])
def test_front_walk_back_equal_reference(batch, stride_extra):
    """S1 → 19 → S2 through the wrappers on CPU tensors (their plain
    versions), V wider than the batch or not, against the reference's
    digests, with the fold equal to the host's; no launch counted."""
    hdr76, nonces, digest = batch
    words, lanes = S.header_to_words(hdr76), _lanes(nonces)
    before = [fn.launches for fn in kernels.KERNELS]
    v = K.romix_scratch(N_LOG2, len(nonces) + stride_extra, "cpu")
    x = K.scrypt_front(words, lanes, N_LOG2, v)
    x = K.romix_walk(x, v, N_LOG2, 1 << N_LOG2)
    values = [_value(r) for r in digest.tolist()]
    target = sorted(values)[4]
    got, handle = K.scrypt_back(words, lanes, x, ops.target_to_words(target))
    assert torch.equal(got, _lanes(digest))
    wins = [i for i, val in enumerate(values) if val <= target]
    low = min(range(len(values)), key=lambda i: (values[i], i))
    row = handle.tolist()
    assert row[:2] == [1, wins[0]] and row[10] == low
    assert _words_value(row[2:10]) == values[low]
    assert _words_value(row[11:19]) == values[wins[0]]
    assert [fn.launches for fn in kernels.KERNELS] == before


def _words_value(words) -> int:
    value = 0
    for w in words:
        value = (value << 32) | w
    return value


def test_romix_walk_chain_equals_reference_block_mix_loop():
    """Four walk steps against a loop over the reference's BlockMix with
    numpy's gather of ``V[X[16] mod N, lane]``; V given as int64 lanes
    and as int32 bit patterns (the kernels' scratch)."""
    rng = np.random.default_rng(7)
    b, n_log2 = 6, 5
    x = rng.integers(0, 1 << 32, (b, 32), dtype=np.uint32)
    v = rng.integers(0, 1 << 32, (1 << n_log2, b, 32), dtype=np.uint32)
    want = x
    for _ in range(4):
        row = v[want[:, 16] & ((1 << n_log2) - 1), np.arange(b)]
        want = np.asarray(ref.block_mix(jnp.asarray(want ^ row)))
    for vt in (_lanes(v), torch.from_numpy(v.view(np.int32))):
        assert torch.equal(S.romix_walk(_lanes(x), vt, n_log2, 4), _lanes(want))
    assert torch.equal(K.romix_walk(_lanes(x), _lanes(v), n_log2, 4), _lanes(want))


@pytest.mark.parametrize("reps", [0, 1, 6])
def test_row_gather_plain_equals_numpy(reps):
    rng = np.random.default_rng(9 + reps)
    rows = 3001  # not a power of two: the pass stride wraps
    v = rng.integers(0, 1 << 32, (rows, 32), dtype=np.uint32)
    idx = rng.integers(0, rows, 77)
    want = np.zeros(77, dtype=np.uint32)
    for r in range(reps):
        want ^= np.bitwise_xor.reduce(v[(idx + r * 977) % rows], axis=1)
    got = K.row_gather(_lanes(v), _lanes(idx), reps)
    assert torch.equal(got, _lanes(want))
    assert torch.equal(S.row_gather(torch.from_numpy(v.view(np.int32)), _lanes(idx), reps),
                       _lanes(want))


def test_batch_fold_ties_and_targets():
    """The fold's first winner and minimum lane on a batch with a
    repeated minimum (ties go to the lowest lane), at no, one and every
    winning lane."""
    rng = np.random.default_rng(11)
    digest = rng.integers(0, 1 << 32, (9, 8), dtype=np.uint32)
    digest[6] = digest[2] = [0] * 7 + [1 << 24]  # value 2^224: word 0 is bswap(word 7)
    values = [_value(r) for r in digest.tolist()]
    low = values[2]
    for target, first in ((0, None), (low, 2), ((1 << 256) - 1, 0)):
        row = S.batch_fold(_lanes(digest), ops.target_to_words(target)).tolist()
        assert row[10] == 2 and _words_value(row[2:10]) == low
        if first is None:
            assert row[:2] == [0, S.NOT_FOUND] and row[11:] == [0] * 8
        else:
            assert row[:2] == [1, first] and _words_value(row[11:]) == values[first]


def test_wrappers_check_their_inputs():
    words = (0,) * 19
    nonces = torch.zeros(4, dtype=torch.int64)
    v = K.romix_scratch(N_LOG2, 4, "cpu")
    with pytest.raises(ValueError):
        K.scrypt_front(words, nonces, N_LOG2, K.romix_scratch(N_LOG2, 3, "cpu"))
    with pytest.raises(ValueError):
        K.scrypt_front(words, nonces, N_LOG2 + 1, v)
    with pytest.raises(ValueError):
        K.scrypt_front(words, nonces, N_LOG2, v.to(torch.int32))
    with pytest.raises(ValueError):
        K.scrypt_front((0,) * 18, nonces, N_LOG2, v)
    with pytest.raises(ValueError):
        K.romix_walk(torch.zeros((4, 31), dtype=torch.int64), v, N_LOG2, 1)
    with pytest.raises(ValueError):
        K.scrypt_back(words, nonces, torch.zeros((4, 32), dtype=torch.int64), [0] * 7)
    with pytest.raises(ValueError):
        K.row_gather(torch.zeros((5, 16), dtype=torch.int64), nonces, 1)
