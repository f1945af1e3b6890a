"""P2's vector arm (``tm_transpose_u32`` in ``csrc/probes.cu``) held to a
transpose, thread by thread, with numpy.

``transpose_vector_map`` below writes out the kernel's index arithmetic
on the launch ``kernels.probes.transpose_geometry`` computes: the input
vector each thread loads and the shared-tile slot it writes, then the 4 shared words it reads back and
the output vector it stores. These tests run that map on random words
(every block's load into its swizzled tile, a barrier, every block's
stores), for each shape the probes hand P2 and for edges that are not a
multiple of a tile, with and without a carry, and hold that every output
word is written exactly once, from the right input word; that no two
threads of a quarter-warp hit one bank with a 16-byte tile write, and no
two lanes of a warp with a 4-byte read; and that shapes whose sides are
not multiples of 4, and pointers off a 16-byte boundary, take the scalar
arm. CPU only, no card, no JAX; exact equality throughout.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuminter_torch.kernels import probes as K
from tpuminter_torch.ops import walk_layouts as W

#: the probes' shapes (``_common.to_wm`` / ``from_wm``, sites 14, 18, 20,
#: 24; 15 and 21's ``(B/4, 128)``) at B = 16384 and, for the edges, sides
#: that are multiples of 4 but not of a tile
VECTOR_SHAPES = [(16384, 32), (32, 16384), (4096, 128), (1000, 36), (36, 1000), (4, 4),
                 (68, 260)]
SCALAR_SHAPES = [(1000, 37), (37, 1000), (33, 1), (1, 33), (6, 4), (4, 6)]
BANKS = 32
#: the vector arm's threads a block: one a 16-byte chunk of the tile
VECTOR_THREADS = K.TILE * K.TILE // 4


def transpose_vector_map(g, rows, cols, blocks=None) -> dict:
    """P2's vector arm's index arithmetic (``transpose_vec_kernel`` in
    ``csrc/probes.cu``) on the launch ``g`` of a ``(rows, cols)`` input,
    written out for ``blocks`` (``(bx, by)``
    pairs; every block of the grid when None), one entry a thread, as
    numpy arrays: ``load_word`` (the flat input word its vector starts
    at, -1 when masked), ``load_slot`` (the shared tile's 16-byte slot
    it writes), ``store_word`` (the flat output word its vector starts
    at, -1 when masked) and ``read_words`` (``(threads, 4)``: the shared
    tile's 4-byte words it reads for that vector, in order). ``block``
    and ``thread`` name each entry."""
    if not g.vector:
        raise ValueError("the scalar arm has no vector map")
    gx, gy = g.grid
    if blocks is None:
        blocks = [(bx, by) for bx in range(gx) for by in range(gy)]
    blocks = np.asarray(blocks, dtype=np.int64).reshape(-1, 2)
    chunks = K.TILE // 4
    t = np.arange(VECTOR_THREADS, dtype=np.int64)
    r0 = (blocks[:, 0] * K.TILE)[:, None]
    c0 = (blocks[:, 1] * K.TILE)[:, None]
    lr, q = t // chunks, t % chunks
    r, c = r0 + lr, c0 + 4 * q
    load_word = np.where((r < rows) & (c < cols), r * cols + c, -1)
    load_slot = lr * chunks + (q ^ ((lr >> 2) & 7))
    w, lane = t >> 5, t & 31
    lc, rq = 4 * w + (lane >> 3), lane & 7
    c, r = c0 + lc, r0 + 4 * rq
    store_word = np.where((c < cols) & (r < rows), c * rows + r, -1)
    first = 4 * rq * K.TILE + 4 * (w ^ rq) + (lane >> 3)
    read_words = first[:, None] + K.TILE * np.arange(4)[None, :]
    n = len(blocks)
    return {"block": np.repeat(np.arange(n), VECTOR_THREADS), "thread": np.tile(t, n),
            "load_word": load_word.reshape(-1), "load_slot": np.tile(load_slot, n),
            "store_word": store_word.reshape(-1), "read_words": np.tile(read_words, (n, 1))}


def _simulate(g, x, carry=None):
    """The vector arm on ``x`` (``(rows, cols)`` uint64 words) as the
    map says: returns the output and how many times each output word was
    written."""
    rows, cols = x.shape
    m = transpose_vector_map(g, rows, cols)
    flat = x.reshape(-1)
    slots = K.TILE * K.TILE // 4
    tile = np.zeros((g.grid[0] * g.grid[1], slots, 4), dtype=np.uint64)
    live = m["load_word"] >= 0
    tile[m["block"][live], m["load_slot"][live]] = flat[m["load_word"][live, None] + np.arange(4)]
    words = tile.reshape(len(tile), -1)
    out = np.zeros(rows * cols, dtype=np.uint64)
    hits = np.zeros(rows * cols, dtype=np.int64)
    live = m["store_word"] >= 0
    at = m["store_word"][live, None] + np.arange(4)
    vec = words[m["block"][live, None], m["read_words"][live]]
    if carry is not None:
        vec = vec ^ carry.reshape(-1)[at]
    out[at] = vec
    np.add.at(hits, at.reshape(-1), 1)
    return out.reshape(cols, rows), hits


@pytest.mark.parametrize("carry", [False, True], ids=["plain", "carry"])
@pytest.mark.parametrize("shape", VECTOR_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_vector_arm_writes_every_output_word_once_from_its_input(shape, carry):
    rows, cols = shape
    g = K.transpose_geometry(rows, cols, True)
    assert g.vector
    assert (g.grid[0] - 1) * K.TILE < rows <= g.grid[0] * K.TILE
    assert (g.grid[1] - 1) * K.TILE < cols <= g.grid[1] * K.TILE
    rng = np.random.default_rng(rows * 131 + cols)
    x = rng.integers(0, 1 << 32, shape, dtype=np.uint64)
    c = rng.integers(0, 1 << 32, (cols, rows), dtype=np.uint64) if carry else None
    out, hits = _simulate(g, x, c)
    assert np.array_equal(hits, np.ones(rows * cols, dtype=np.int64))
    want = x.T ^ c if carry else x.T
    assert np.array_equal(out, want)
    # the model's arithmetic is the plain version's answer
    lanes = torch.from_numpy(x.astype(np.int64))
    plain = K.transpose_plain(lanes, None if c is None else torch.from_numpy(c.astype(np.int64)))
    assert np.array_equal(plain.numpy().astype(np.uint64), want)


@pytest.mark.parametrize("block", [(0, 0), (1, 3), (127, 2)])
def test_vector_arm_shared_accesses_are_free_of_bank_conflicts(block):
    """A 16-byte write occupies 4 banks (slot s: banks 4 (s % 8) ..
    + 3, a tile row being 32 banks), served a quarter-warp at a time; a
    4-byte read one bank, a warp at a time. Every thread counts, masked
    or not, and every block maps its threads alike."""
    g = K.transpose_geometry(4096, 128, True)
    m = transpose_vector_map(g, 4096, 128, [block])
    quarter = m["load_slot"].reshape(-1, 8) % 8
    assert all(len(set(row)) == 8 for row in quarter)
    reads = m["read_words"].reshape(-1, 32, 4) % BANKS
    for warp in reads:
        for i in range(4):
            assert len(set(warp[:, i])) == BANKS
    # unpadded and unswizzled, the same (row, column) words would sit in
    # 4 banks, one a column: an 8-way conflict the swizzle takes away
    word = m["read_words"][:32, 0]
    row, chunk = word // K.TILE, word % K.TILE // 4
    col = 4 * (chunk ^ (row >> 2 & 7)) + word % 4
    assert len(set(col % BANKS)) == 4


@pytest.mark.parametrize("shape", VECTOR_SHAPES[:3], ids=lambda s: "x".join(map(str, s)))
def test_vector_arm_coalesces_its_global_accesses(shape):
    """A warp's loads are 4 tile rows of 8 consecutive vectors, its
    stores 4 output rows of 8 consecutive vectors (128-byte runs), in
    every block."""
    g = K.transpose_geometry(*shape, True)
    m = transpose_vector_map(g, *shape, [(g.grid[0] - 1, g.grid[1] - 1)])
    for key in ("load_word", "store_word"):
        runs = m[key].reshape(-1, 4, 8)
        assert (np.diff(runs, axis=-1) == 4).all(), key
        assert (runs[..., 0] % 32 == 0).all(), key


@pytest.mark.parametrize("shape", SCALAR_SHAPES + VECTOR_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_scalar_arm_takes_odd_sides_and_misaligned_pointers(shape):
    rows, cols = shape
    vector = rows % 4 == 0 and cols % 4 == 0
    assert K.transpose_geometry(rows, cols, True).vector == vector
    g = K.transpose_geometry(rows, cols, False)
    assert not g.vector
    assert g.grid == (-(-rows // 32), -(-cols // 32))
    with pytest.raises(ValueError):
        transpose_vector_map(g, rows, cols)


def test_alignment_is_read_from_every_pointer():
    """A view one word into its storage is off the 16-byte boundary;
    a missing carry does not count."""
    base = torch.zeros(4 * 1024 + 4, dtype=torch.int32)
    whole, shifted = base[:4096].view(64, 64), base[1:4097].view(64, 64)
    assert K.vector_aligned(whole, None) and K.vector_aligned(whole, base[4:4100])
    assert not K.vector_aligned(shifted) and not K.vector_aligned(whole, shifted)


def test_geometry_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        K.transpose_geometry(0, 32, True)
    with pytest.raises(ValueError):
        K.transpose_geometry(32, 65535 * 32 + 1, True)


def test_transpose_constants_match_the_cuda_source():
    """The tile the geometry assumes is the kernel's, and the vector arm
    launches one thread a 16-byte chunk of it."""
    src = (Path(K.__file__).parent / "csrc" / "probes.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
    assert int(consts["kTile"]) == K.TILE and consts["kChunks"] == "kTile / 4"
    assert int(consts["kTileRows"]) * 4 == K.TILE
    launches = re.findall(r"transpose_vec_kernel<(?:true|false)><<<grid, ([^,]+),", src)
    assert launches == ["kTile * kChunks"] * 2


def test_transpose_plain_still_runs_on_lanes():
    """The wrapper on CPU tensors is the plain version, for both arms'
    shapes, with and without a carry."""
    rng = np.random.default_rng(3)
    for rows, cols in ((16, 8), (5, 3)):
        x = torch.from_numpy(rng.integers(0, 1 << 32, (rows, cols), dtype=np.int64))
        c = torch.from_numpy(rng.integers(0, 1 << 32, (cols, rows), dtype=np.int64))
        assert torch.equal(K.transpose(x), x.t())
        assert torch.equal(K.transpose(x, c), c ^ x.t())
        assert torch.equal(W.transpose(x, c), c ^ x.t())
