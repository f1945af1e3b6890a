"""What the host prepares for K4 and S2, held to the reference and to
the kernels' sources.

S2 (``csrc/scrypt.cu`` ``tm_scrypt_back``) takes the key's first block,
SHA-256's state after the header's first 64 bytes, from the host
(``ops.scrypt.key_state``): held against the reference's ``_compress``
(``tpuminter.ops.scrypt``) and ``hashlib.sha256``, and the plain
version fed through that split against ``hashlib.scrypt`` at N = 16.
K4 (``tm_search_candidates_hdr``)
runs on a grid computed in ``kernels/sha256.py`` (``hdr_grid``):
``HDR_WAVES`` whole waves of its resident blocks, whose warps sweep every offset of
``[0, n)`` once (``hdr_offsets``, a numpy model of the kernel's u32
loop), for every ``n`` up to 2^32 - 1. The constants written on both
sides are held equal. CPU only, no card; exact equality throughout.
"""

import hashlib
import re
import struct
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuminter.ops import scrypt as ref
from tpuminter_torch.chain import SHA256_H0
from tpuminter_torch.kernels import scrypt as KS
from tpuminter_torch.kernels import sha256 as K
from tpuminter_torch.ops import scrypt as S
from tpuminter_torch.ops import sha256 as ops

CSRC = Path(K.__file__).resolve().parent / "csrc"
N_LOG2 = 4
#: header seeds: each header's 76 bytes are ``default_rng(seed).bytes(76)``
SEEDS = (0, 1, 2)


def _header(seed: int) -> bytes:
    return np.random.default_rng(seed).bytes(76)


def _lanes(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_key_state_is_the_references_first_compression(seed):
    hdr76 = _header(seed)
    words = S.header_to_words(hdr76)
    want = ref._compress(jnp.asarray(np.array(SHA256_H0, dtype=np.uint32)),
                         jnp.asarray(ref.header_to_words(hdr76)[:16]))
    assert S.key_state(words) == tuple(int(w) for w in np.asarray(want))


@pytest.mark.parametrize("nonce", [0, 2083236893, 0xFFFFFFFF])
@pytest.mark.parametrize("seed", SEEDS)
def test_key_state_finishes_to_hashlib(seed, nonce):
    """The key state is the midstate of SHA256(header80): its second
    block (the header's last 16 bytes and the padding) ends on hashlib's
    digest."""
    hdr76 = _header(seed)
    words = S.header_to_words(hdr76)
    nw = struct.unpack(">I", struct.pack("<I", nonce))[0]
    block = list(words[16:]) + [nw, 0x80000000] + [0] * 10 + [640]
    got = ops._compress(list(S.key_state(words)), block)
    assert got == list(struct.unpack(">8I", hashlib.sha256(hdr76 + struct.pack("<I", nonce))
                                     .digest()))


def test_key_state_refuses_a_short_header():
    with pytest.raises(ValueError):
        S.key_state((0,) * 18)


def test_split_back_equals_hashlib_scrypt():
    """PBKDF2-in and ROMix on the plain versions, then S2's plain version
    given the key state, against ``hashlib.scrypt`` at N = 16; the split
    and the unsplit PBKDF2-out agree, and so do their folds and the
    wrapper's (which takes the split on CPU tensors too; its digests are
    held against the reference's ``scrypt_header_batch`` by
    ``tests/test_torch_scrypt.py``, whose jit this file does not
    repeat)."""
    rng = np.random.default_rng(20261018)
    hdr76 = rng.bytes(76)
    nonces = np.concatenate([rng.integers(0, 1 << 32, 6, dtype=np.uint32),
                             np.array([0, 0xFFFFFFFF], dtype=np.uint32)])
    words, lanes = S.header_to_words(hdr76), _lanes(nonces)
    x = S.romix(S.pbkdf2_in(words, lanes), N_LOG2)
    values = []
    for nonce in nonces.tolist():
        hdr = hdr76 + struct.pack("<I", nonce)
        values.append(hashlib.scrypt(hdr, salt=hdr, n=1 << N_LOG2, r=1, p=1, dklen=32))
    target = ops.target_to_words(sorted(int.from_bytes(v, "little") for v in values)[2])
    digest, handle = KS.scrypt_back_plain(words, lanes, x, target, S.key_state(words))
    assert [struct.pack(">8I", *row) for row in digest.tolist()] == values
    assert torch.equal(digest, S.pbkdf2_out(words, lanes, x))
    assert torch.equal(handle, KS.scrypt_back_plain(words, lanes, x, target)[1])
    assert torch.equal(handle, KS.scrypt_back(words, lanes, x, target)[1])
    assert handle[0] == 1


def test_wrapper_constants_match_the_sources():
    scrypt = (CSRC / "scrypt.cu").read_text()
    sha = (CSRC / "sha256.cu").read_text()
    assert f"constexpr int kBackPartial = {KS.BACK_PARTIAL};" in scrypt
    assert f"constexpr int kThreads = {KS.THREADS};" in scrypt
    assert f"constexpr int kThreads = {K.THREADS};" in sha
    # tm_sha256_occupancy's table, in order, then K6's toy arm
    table = re.search(r"const void\* fns\[\] = \{(.*?)\};", sha.split("tm_sha256_occupancy")[-1],
                      re.S).group(1)
    names = re.findall(r"\(const void\*\)(\w+)(<(?:true|false)>)?", table)
    kernels = {"search_candidates_hdr_kernel": "search_candidates_hdr",
               "search_candidates_header_kernel": "search_candidates_header",
               "search_target_header_kernel": "search_target_header",
               "search_candidates_hdr_batch_kernel<false>": "search_candidates_hdr_batch",
               "search_candidates_hdr_batch_kernel<true>": "search_candidates_hdr_batch_sched"}
    assert [kernels[a + b] for a, b in names] == list(K.OCCUPANCY_KERNELS)
    assert list(K.OCCUPANCY_KERNELS.values()) == list(range(len(names)))
    assert K.OCCUPANCY_TOY == len(names)
    # S2's occupancy entry and the kernels THREADS_PER_HASH names, in order
    occ = re.search(r"const void\* fns\[\] = \{(.*?)\};", scrypt.split("tm_scrypt_occupancy")[-1],
                    re.S).group(1)
    assert re.findall(r"\(const void\*\)(\w+)_kernel", occ) == \
        ["scrypt_front", "romix_walk", "scrypt_back"] == list(KS.THREADS_PER_HASH)


#: (resident blocks an SM, SMs): an H100 at 2-4 blocks, another card, one SM
GEOMETRIES = [(3, 132), (4, 132), (2, 132), (2, 114), (1, 1)]


def _edges(resident, sms):
    """Counts at the edges of a warp, a block, a full grid and the u32
    range."""
    grid = K.HDR_WAVES * resident * sms * K.THREADS
    return sorted({1, 2, 31, 32, 33, 255, 256, 257, grid - 1, grid, grid + 1, 2 * grid + 31,
                   1 << 27, 1 << 30, (1 << 32) - grid - 1, (1 << 32) - 1})


@pytest.mark.parametrize("resident, sms", GEOMETRIES)
def test_k4_grid_is_whole_waves(resident, sms):
    wave = resident * sms
    for n in _edges(resident, sms):
        grid = K.hdr_grid(n, resident, sms)
        assert 1 <= grid <= K.HDR_WAVES * wave
        # whole waves, or one block for each THREADS offsets of a smaller range
        assert grid == K.HDR_WAVES * wave or grid * K.THREADS >= n
        assert (grid - 1) * K.THREADS < n


def test_k4_grid_refuses_empty_inputs():
    for args in ((0, 3, 132), (5, 0, 132), (5, 3, 0)):
        with pytest.raises(ValueError):
            K.hdr_grid(*args)


def _covers_once(offsets, n):
    got = offsets[offsets >= 0]
    return np.array_equal(np.bincount(got, minlength=n), np.ones(n, dtype=np.int64))


@pytest.mark.parametrize("resident, sms", GEOMETRIES[:2] + GEOMETRIES[-1:])
def test_k4_threads_sweep_every_offset_once(resident, sms):
    """Every thread of the launch, below a few waves' worth of offsets."""
    for n in [e for e in _edges(resident, sms)
              if e <= 3 * K.HDR_WAVES * resident * sms * K.THREADS]:
        assert _covers_once(K.hdr_offsets(n, K.hdr_grid(n, resident, sms)), n), n


@pytest.mark.parametrize("resident, sms", GEOMETRIES[:4])
def test_k4_large_ranges_never_wrap(resident, sms):
    """Past that, sampled warps (the first and the last):
    each sweeps its arithmetic run of offsets below n, no step passes
    2^32 and comes back, and the runs of all threads add up to n."""
    for n in [e for e in _edges(resident, sms)
              if e > 3 * K.HDR_WAVES * resident * sms * K.THREADS]:
        grid = K.hdr_grid(n, resident, sms)
        stride = grid * K.THREADS
        warps = [0, grid * 8 - 1]
        tid = np.concatenate([np.arange(32 * w, 32 * w + 32) for w in warps])
        offs = K.hdr_offsets(n, grid, tid)
        for t, row in zip(tid, offs):
            live = row[row >= 0]
            want = np.arange(t, n, stride)
            assert np.array_equal(live, want), (n, t)
        # per residue r < stride, ceil((n - r) / stride) offsets: n in all
        r = np.arange(stride)
        assert int(np.sum(-(-(n - r) // stride))) == n


def test_k4_model_shows_the_wrap_it_guards():
    """Without the kernel's stop before a step past 2^32, a u32 step of
    the last warps would wrap below n: the model's guard is what keeps
    every offset once at n = 2^32 - 1."""
    n = (1 << 32) - 1
    grid = K.hdr_grid(n, 3, 132)
    stride = grid * K.THREADS
    last_w0 = (n - 1) // stride * stride
    assert last_w0 + stride >= 1 << 32  # the unguarded next step wraps
    assert ((last_w0 + stride) % (1 << 32)) < n
    offs = K.hdr_offsets(n, grid, np.arange(32))
    assert offs.max() < n
    assert (offs >= 0).sum() == sum(-(-(n - lane) // stride) for lane in range(32))
