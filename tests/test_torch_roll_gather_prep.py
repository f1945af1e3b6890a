"""What the host prepares for the roll (R) and the row gather (11), held
to the reference and to the kernels' sources.

R (``csrc/sha256.cu`` ``extranonce_roll_kernel``) reads a job buffer
that ``ops.merkle.RollJob.words`` lays out once a job: the extranonce's
byte positions resolved into the tail word it starts in, a bit shift and
a mask (``extranonce_place``), and it compresses the Merkle pair's
padding block from a literal table of ``K[i] + W[i]`` (``kPad512KW``).
A numpy model of the kernel's arithmetic on that buffer (its selects on
compile-time word indices, the funnel shifts, the table) is held equal
to the reference ``tpuminter.ops.merkle.make_extranonce_roll_batch`` and
to hashlib (``chain.rolled_header``, ``chain.dsha256``) at extranonce
sizes 1-8, branch depths 0 and 12, and offsets that cross words and
blocks, and R's serial floor's plain version runs the roll's chain.
11 (``row_gather_kernel``) runs on a launch computed in
``kernels/scrypt.py`` (``gather_geometry``): a numpy model of its thread
mapping (here, ``gather_reads`` and ``gather_rows``) shows every
``(lane, pass)`` row read once by each of its eight pieces, the row
recurrence equal to the modulo, and the fold equal to
``row_gather_plain``, on launches for 1 to 132 SMs. CPU only, no card; exact equality throughout.
"""

import re
import struct
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuminter import chain as ref_chain
from tpuminter.ops import merkle as ref_merkle
from tpuminter_torch.chain import SHA256_H0, SHA256_K
from tpuminter_torch.kernels import scrypt as KS
from tpuminter_torch.kernels import sha256 as K
from tpuminter_torch.ops import merkle
from tpuminter_torch.ops import sha256 as ops
from tpuminter_torch.ops.scrypt import GATHER_STEP

CSRC = Path(K.__file__).resolve().parent / "csrc"
U32 = np.uint32
GENESIS = ref_chain.GENESIS_HEADER.pack()
#: extranonce values: small, every byte set, and junk above any size
#: (the kernel's mask must drop bytes past the extranonce's size)
ENS = (0, 1, 0x0102030405060708, 0xFFFFFFFFFFFFFFFF, 0xDEADBEEFCAFEF00D)


# ---- a numpy model of extranonce_roll_kernel --------------------------------

def _rotr(x, n):
    return (x >> U32(n)) | (x << U32(32 - n))


def _rounds(state, kw):
    """64 rounds from ``state`` (8 arrays) with ``kw[i]`` = K[i] + W[i]
    (arrays or scalars); the feed-forward added."""
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        t1 = h + kw[i] + s1 + (g ^ (e & (f ^ g)))
        t2 = (_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)) + ((a & b) | (c & (a | b)))
        a, b, c, d, e, f, g, h = t1 + t2, a, b, c, d + t1, e, f, g
    return [s + v for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def _schedule(m):
    w = list(m)
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> U32(3))
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> U32(10))
        w.append(w[i - 16] + s0 + w[i - 7] + s1)
    return w


def _compress(state, m):
    return _rounds(state, [U32(k) + w for k, w in zip(SHA256_K, _schedule(m))])


def _source_pad_kw():
    """``kPad512KW`` as written in ``sha256.cu``."""
    body = re.search(r"kPad512KW\[64\] = \{(.*?)\};", (CSRC / "sha256.cu").read_text(),
                     re.S).group(1)
    return [int(v, 16) for v in re.findall(r"0x([0-9A-F]{8})u", body)]


def _fshr(lo, hi, k):
    """``__funnelshift_r(lo, hi, k)``: the low word of ``hi:lo >> k``."""
    wide = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return (wide >> np.uint64(k)).astype(U32)


def _bswap(x):
    return x.byteswap()


def model_roll(words, n_blocks, depth, en):
    """The kernel's arithmetic on ``RollJob.words()``: ``en`` (B,)
    extranonces → (midstates (B, 8), tail words (B, 3)) as u32 arrays."""
    w = np.asarray(words, dtype=np.uint64).astype(U32)
    en = np.asarray(en, dtype=np.uint64)
    hi, lo = (en >> np.uint64(32)).astype(U32), (en & np.uint64(0xFFFFFFFF)).astype(U32)
    ones = np.ones(len(en), dtype=U32)
    g0, k, mask_hi, mask_lo = (int(x) for x in w[8:12])
    xh, xl = _bswap(lo) & U32(mask_hi), _bswap(hi) & U32(mask_lo)
    c = [xh >> U32(k), _fshr(xl, xh, k), _fshr(np.zeros_like(xl), xl, k)]
    tail = w[12:12 + 16 * n_blocks]
    branch = w[12 + 16 * n_blocks:12 + 16 * n_blocks + 8 * depth]
    head = w[12 + 16 * n_blocks + 8 * depth:]
    s = [ones * x for x in w[:8]]
    for b in range(n_blocks):
        m = [ones * x for x in tail[16 * b:16 * b + 16]]
        if b < 2:
            for i in range(16):  # the kernel's select on a compile-time i
                d = 16 * b - g0 + i
                if 0 <= d <= 2:
                    m[i] = m[i] | c[d]
        s = _compress(s, m)
    h0 = [ones * U32(x) for x in SHA256_H0]
    pad256 = [ones * U32(x) for x in merkle._PAD256]
    s = _compress(h0, s + pad256)
    kw = [U32(x) for x in _source_pad_kw()]
    for lvl in range(depth):
        t = _compress(h0, s + [ones * x for x in branch[8 * lvl:8 * lvl + 8]])
        t = _rounds(t, kw)
        s = _compress(h0, t + pad256)
    mid = _compress(h0, [ones * x for x in head[:9]] + s[:7])
    return np.stack(mid, 1), np.stack([s[7], ones * head[9], ones * head[10]], 1)


def _job(prefix_len, size, depth, seed=0):
    """A job whose extranonce starts at coinbase byte ``prefix_len``."""
    rng = np.random.default_rng([seed, prefix_len, size, depth])
    prefix, suffix = rng.bytes(prefix_len), rng.bytes(90 + int(rng.integers(0, 64)))
    branch = tuple(rng.bytes(32) for _ in range(depth))
    return (prefix, suffix, size, branch), merkle.build_roll(GENESIS, prefix, suffix, size, branch)


def _hashlib_rows(parts, ens):
    prefix, suffix, size, branch = parts
    cb = ref_chain.CoinbaseTemplate(prefix, suffix, size)
    mids, tails = [], []
    for e in ens:
        hdr = ref_chain.rolled_header(GENESIS, cb, branch, e % (1 << 8 * size))
        mids.append(list(hdr.midstate()))
        tails.append(list(hdr.tail_words()))
    return np.array(mids, dtype=np.uint64), np.array(tails, dtype=np.uint64)


def _offset(job):
    g0, k, _, _ = merkle.extranonce_place(job.coinbase)
    return 4 * g0 + k // 8


#: (prefix length, size): the extranonce's first byte at tail offsets
#: 0-3 (word starts and crossings) and 57-63 (crossing into the next
#: block), and a prefix past one block
PLACES = [(p, s) for s in range(1, 9) for p in (0, 1, 3, 58, 61, 63, 64 + 62)]


@pytest.mark.parametrize("prefix_len, size", PLACES)
def test_model_roll_equals_hashlib_at_every_place(prefix_len, size):
    parts, job = _job(prefix_len, size, 0)
    assert _offset(job) == prefix_len % 64
    mids, tails = model_roll(job.words(), len(job.coinbase.tail), 0, ENS)
    want_mids, want_tails = _hashlib_rows(parts, ENS)
    assert np.array_equal(mids, want_mids) and np.array_equal(tails, want_tails)


@pytest.mark.parametrize("prefix_len, size", [(3, 1), (61, 4), (62, 8), (120, 4)])
def test_model_roll_12_deep_equals_hashlib(prefix_len, size):
    parts, job = _job(prefix_len, size, 12)
    mids, tails = model_roll(job.words(), len(job.coinbase.tail), 12, ENS[:3])
    want_mids, want_tails = _hashlib_rows(parts, ENS[:3])
    assert np.array_equal(mids, want_mids) and np.array_equal(tails, want_tails)


@pytest.mark.parametrize("prefix_len, size, depth", [(0, 1, 0), (62, 4, 0), (61, 8, 0),
                                                     (59, 7, 12)])
def test_model_roll_equals_the_reference_batch(prefix_len, size, depth):
    """The reference's batched roll (one jit a job), and the port's plain
    version, on extranonces that also hold junk past the size."""
    parts, job = _job(prefix_len, size, depth, seed=1)
    ens = np.array(ENS, dtype=np.uint64)
    hi, lo = (ens >> np.uint64(32)).astype(U32), (ens & np.uint64(0xFFFFFFFF)).astype(U32)
    roll = ref_merkle.make_extranonce_roll_batch(GENESIS, *parts)
    want_mids, want_tails = (np.asarray(a).astype(np.uint64)
                             for a in roll(jnp.asarray(hi), jnp.asarray(lo)))
    mids, tails = model_roll(job.words(), len(job.coinbase.tail), depth, ens)
    assert np.array_equal(mids, want_mids) and np.array_equal(tails, want_tails)
    plain = K.extranonce_roll_plain(job, torch.from_numpy(hi.astype(np.int64)),
                                    torch.from_numpy(lo.astype(np.int64)))
    assert np.array_equal(plain[0].numpy(), want_mids)
    assert np.array_equal(plain[1].numpy(), want_tails)


def test_the_roll_folds_a_branch_as_dsha256():
    """One level by hand: the model's node is dsha256(txid ‖ sibling),
    the txid dsha256 of the coinbase, with the coinbase on the left."""
    parts, job = _job(41, 4, 1)
    prefix, suffix, size, branch = parts
    en = 0x11223344
    txid = ref_chain.dsha256(prefix + en.to_bytes(size, "little") + suffix)
    root = ref_chain.dsha256(txid + branch[0])
    _, tails = model_roll(job.words(), len(job.coinbase.tail), 1, [en])
    assert int(tails[0, 0]) == struct.unpack(">8I", root)[7]


def test_job_words_lay_out_aligned_sections():
    parts, job = _job(61, 8, 12)
    words, n, d = job.words(), len(job.coinbase.tail), 12
    assert len(words) == 12 + 16 * n + 8 * d + 12
    assert words[:8] == list(job.coinbase.midstate)
    assert words[12 + 16 * n + 8 * d:] == list(job.head9) + list(job.time_bits) + [0]
    # the kernel loads 16 bytes at a time from every section's start
    assert all(start % 4 == 0 for start in (8, 12, 12 + 16 * n, 12 + 16 * n + 8 * d))
    assert all(0 <= w <= 0xFFFFFFFF for w in words)
    src = (CSRC / "sha256.cu").read_text()
    assert "constexpr int kRollJobHead = 12;" in src


@pytest.mark.parametrize("size", range(1, 9))
def test_extranonce_place_masks_the_size(size):
    _, job = _job(5, size, 0)
    g0, k, mask_hi, mask_lo = merkle.extranonce_place(job.coinbase)
    assert (g0, k) == (1, 8)
    assert bin(mask_hi).count("1") + bin(mask_lo).count("1") == 8 * size
    assert ((mask_hi << 32) | mask_lo) == ((1 << 8 * size) - 1) << (64 - 8 * size)


def test_extranonce_place_refuses_other_positions():
    _, job = _job(5, 4, 0)
    cb = job.coinbase
    # big-endian bytes: byte j takes nonce bits 8 (3 - j)
    swapped = tuple(p[:3] + (24 - p[3],) for p in cb.positions)
    gap = cb.positions[:3] + ((cb.positions[3][0], cb.positions[3][1] + 1) + cb.positions[3][2:],)
    for positions in (swapped, gap, ()):
        bad = ops.NonceTemplate(cb.midstate, cb.tail, positions, cb.double)
        with pytest.raises(ValueError):
            merkle.extranonce_place(bad)


def test_pad_table_is_k_plus_the_pad_blocks_schedule():
    w = _schedule([np.array([x], dtype=U32) for x in merkle._PAD512])
    assert _source_pad_kw() == [int((U32(k) + x)[0]) for k, x in zip(SHA256_K, w)]


def _ref_compress(state, words):
    return list(struct.unpack(">8I", struct.pack(">8I", *ref_chain.sha256_compress(
        tuple(state), struct.pack(">16I", *words)))))


@pytest.mark.parametrize("n_blocks, depth", [(1, 0), (2, 1), (4, 12)])
def test_serial_floor_plain_runs_the_rolls_chain(n_blocks, depth):
    """The floor's chain: the roll's compressions for the job's shape
    (txid, per level a pair, its padding block and its second hash, the
    header's block), each message the roll reads replaced by ``s ‖ s``."""
    h0 = list(SHA256_H0)
    state = h0
    for _ in range(n_blocks):
        state = _ref_compress(state, state + state)
    state = _ref_compress(h0, state + list(merkle._PAD256))
    for _ in range(depth):
        state = _ref_compress(h0, state + state)
        state = _ref_compress(state, list(merkle._PAD512))
        state = _ref_compress(h0, state + list(merkle._PAD256))
    state = _ref_compress(h0, state + state)
    assert K.serial_floor_plain(n_blocks, depth) == state
    assert K.serial_floor(n_blocks, depth, "cpu").tolist() == state


# ---- 11's thread mapping --------------------------------------------------------

def gather_reads(g, blocks=None):
    """What each thread of ``blocks`` (every block when None) of
    ``gather_geometry``'s launch reads, as ``row_gather_kernel`` walks
    it: ``(thread, lane, pass, piece)`` arrays, one entry a 16-byte
    load, and each thread's ``(lane, live)``."""
    blocks = np.arange(g.grid) if blocks is None else np.asarray(blocks, dtype=np.int64)
    t = (blocks[:, None] * KS.GATHER_THREADS + np.arange(KS.GATHER_THREADS)[None, :]).reshape(-1)
    piece, slot = t % KS.GATHER_PIECES, t // KS.GATHER_PIECES
    lane, slice_ = slot % g.count, slot // g.count
    live = slice_ < g.slices
    r0 = slice_ * g.per
    r1 = np.minimum(g.reps, r0 + g.per)
    n = np.where(live, np.maximum(r1 - r0, 0), 0)
    thread = np.repeat(np.arange(len(t)), n)
    passes = np.repeat(r0, n) + (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n))
    return (thread, lane[thread], passes, piece[thread]), (lane, live)


def gather_rows(g, idx, rows):
    """The rows the kernel's reads of :func:`gather_reads` land on: the
    first from one modulo, each next by a step of ``977 mod rows`` and
    one conditional subtract, per thread in pass order."""
    (thread, lane, passes, _), _ = gather_reads(g)
    step = GATHER_STEP % rows
    out = np.empty(len(thread), dtype=np.int64)
    first = np.ones(len(thread), dtype=bool)
    first[1:] = thread[1:] != thread[:-1]
    row = 0
    for i in range(len(thread)):
        if first[i]:
            row = (int(idx[lane[i]]) + int(passes[i]) * GATHER_STEP) % rows
        else:
            row += step
            row -= rows if row >= rows else 0
        out[i] = row
    return out


#: (count, reps, SMs): the probe's 8192 lanes on an H100 at its two rep
#: counts, counts that are not a multiple of a warp's rows, one lane, no
#: passes, one SM (no split) and few SMs (2-4 slices of several passes)
GATHER_CASES = [(8192, 32, 132), (8192, 256, 132), (8191, 3, 132), (7, 32, 132),
                (1, 256, 132), (1, 1, 132), (5, 0, 132), (100, 9, 1), (33, 5, 2),
                (2100, 9, 1), (1500, 11, 1), (700, 9, 1), (600, 7, 1)]


@pytest.mark.parametrize("count, reps, sms", GATHER_CASES)
def test_gather_geometry_fills_the_card_without_empty_slices(count, reps, sms):
    g = KS.gather_geometry(count, reps, sms)
    assert g.slices >= 1 and g.slices * g.per >= reps
    assert (g.slices - 1) * g.per < max(reps, 1)  # no empty slice
    assert g.slices <= max(reps, 1)
    # passes a slice: as few as the row slots an SM aims for allow
    want = -(-sms * KS.GATHER_SLOTS_PER_SM // count)
    assert g.per == (-(-reps // min(want, reps)) if reps else 0)
    assert (g.grid - 1) * KS.GATHER_THREADS < g.slices * count * KS.GATHER_PIECES \
        <= g.grid * KS.GATHER_THREADS


def _small(count, reps, sms):
    return count * max(reps, 1) <= 8192 * 4


@pytest.mark.parametrize("sms", [1, 2, 3, 132])
@pytest.mark.parametrize("count, reps, _", [c for c in GATHER_CASES if _small(*c)])
def test_gather_reads_every_lane_pass_piece_once(count, reps, _, sms):
    g = KS.gather_geometry(count, reps, sms)
    (_, lane, passes, piece), _ = gather_reads(g)
    key = (lane * max(reps, 1) + passes) * KS.GATHER_PIECES + piece
    assert np.array_equal(np.bincount(key, minlength=count * reps * KS.GATHER_PIECES),
                          np.ones(count * reps * KS.GATHER_PIECES, dtype=np.int64))


def test_gather_reads_the_probes_launch_block_by_block():
    """At the probe's 8192 lanes and 256 passes, sampled blocks: each
    live thread reads its slice's run of passes."""
    g = KS.gather_geometry(8192, 256, 132)
    assert g.slices > 1 and g.per < 256
    for block in (0, 1, g.grid // 2, g.grid - 1):
        (thread, _, passes, _), (_, live) = gather_reads(g, [block])
        assert np.array_equal(np.unique(thread), np.flatnonzero(live))
        for t in np.flatnonzero(live):
            run = passes[thread == t]
            assert run[0] % g.per == 0
            assert np.array_equal(run, np.arange(run[0], min(run[0] + g.per, 256)))


@pytest.mark.parametrize("rows", [1, 2, 5, 976, 977, 978, 4096])
def test_gather_row_recurrence_is_the_modulo(rows):
    """700 lanes of 11 passes on one SM: 3 slices of 4 passes, so each
    thread steps its row several times."""
    rng = np.random.default_rng(rows)
    g = KS.gather_geometry(700, 11, 1)
    assert (g.slices, g.per) == (3, 4)
    idx = rng.integers(0, rows, 700)
    (_, lane, passes, _), _ = gather_reads(g)
    got = gather_rows(g, idx, rows)
    assert np.array_equal(got, (idx[lane] + passes * 977) % rows)


@pytest.mark.parametrize("sms", [1, 2, 132])
@pytest.mark.parametrize("count, reps, rows", [(7, 32, 5), (700, 9, 4096), (1500, 11, 977),
                                               (2100, 3, 978)])
def test_gather_fold_equals_the_plain_version(count, reps, rows, sms):
    """Each thread xors its pieces' words over its passes; the row's 8
    threads fold by xor (the shuffles), and the slices meet by xor (the
    atomics on the zeroed output): the same as ``row_gather_plain``."""
    rng = np.random.default_rng([count, reps, rows])
    v = rng.integers(0, 1 << 32, (rows, 32), dtype=np.int64)
    idx = rng.integers(0, rows, count)
    g = KS.gather_geometry(count, reps, sms)
    (thread, lane, passes, piece), (lanes, live) = gather_reads(g)
    row = gather_rows(g, idx, rows)
    words = v.reshape(rows, KS.GATHER_PIECES, 4)[row, piece]  # the 16-byte piece
    part = np.zeros(len(lanes), dtype=np.int64)
    np.bitwise_xor.at(part, thread, np.bitwise_xor.reduce(words, axis=1))
    out = np.zeros(count, dtype=np.int64)
    np.bitwise_xor.at(out, lanes[live], part[live])
    want = KS.row_gather_plain(torch.from_numpy(v), torch.from_numpy(idx), reps)
    assert np.array_equal(out, want.numpy())
    assert KS.row_gather(torch.from_numpy(v), torch.from_numpy(idx), reps).tolist() == \
        want.tolist()


def test_gather_geometry_refuses_bad_launches():
    for args in ((0, 1, 132), (1, -1, 132), (1, 1, 0), (1 << 31, 1, 132)):
        with pytest.raises(ValueError):
            KS.gather_geometry(*args)


def test_gather_constants_match_the_source():
    src = (CSRC / "scrypt.cu").read_text()
    assert f"constexpr int kGatherThreads = {KS.GATHER_THREADS};" in src
    assert f"constexpr int kGatherPieces = {KS.GATHER_PIECES};" in src
