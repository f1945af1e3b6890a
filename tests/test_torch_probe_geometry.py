"""The launch geometry of the probe kernels P1 and P3, held to the
mapping their CUDA kernels walk (``csrc/probes.cu``).

``tpuminter_torch.kernels.probes`` computes each launch on the host
(``xor_const_geometry``, ``walk_step_geometry``) and models, with
numpy, the words or (word, lane) pairs each thread touches
(``xor_const_words``, ``walk_step_pairs``, ``quad_words``): the
kernels' index arithmetic written out. These tests hold that every word
of P1's ``[0, n)`` and every output (word, lane) pair of every P3
instantiation is touched exactly once, across counts, alignments,
batches and grids, and that the layouts give the elementwise form its
16-byte vectors and the quad form its rows, and that the blocks and
forms written here are the ones ``csrc/probes.cu`` launches. CPU only,
no card, no JAX; exact equality throughout.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest

from tpuminter_torch.kernels import probes as K
from tpuminter_torch.ops import walk_layouts as W

#: the counts the kernel's arms meet: a few words, a block's worth of
#: words (scalar arm) and of vectors (aligned arm) and one vector past
#: it, the probes' 2^21 words, the largest count
P1_N = [1, 3, 4, 5, 512, 2048, 2052, 1 << 21, (1 << 21) + 5, (1 << 31) - 1]
#: blocks enumerated in full below this grid; past it, a sample
P1_FULL_GRID = 1 << 13
P3_B = [128, 256, 2048, 6144, 16384]
P3_BLOCKS = [None, 1, 3, 133]


def _p1_block_range(g, block):
    """The words block ``block`` must cover: its slots' run of the
    vectors (or words), and block 0 the tail."""
    per = K.XOR_THREADS
    lo, hi = block * per * g.unit, min((block + 1) * per, g.units) * g.unit
    words = np.arange(lo, hi)
    return np.concatenate([words, np.arange(g.units * g.unit, g.n)]) if block == 0 else words


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", P1_N)
def test_p1_threads_partition_the_words(n, offset):
    """Word offset 0 is the aligned (vector) arm, 1-3 the scalar one."""
    g = K.xor_const_geometry(n, offset == 0)
    assert g.aligned == (offset == 0) and g.grid >= 1
    assert (g.grid - 1) * K.XOR_THREADS < max(g.units, 1) <= g.grid * K.XOR_THREADS
    assert g.tail == (n % 4 if offset == 0 else 0)
    if g.grid <= P1_FULL_GRID:
        words = K.xor_const_words(g)
        assert words.min() == 0 and np.array_equal(np.bincount(words, minlength=n),
                                                   np.ones(n, dtype=np.int64))
        return
    for block in (0, 1, g.grid // 2, g.grid - 2, g.grid - 1):  # the same formula for every block
        assert np.array_equal(np.sort(K.xor_const_words(g, [block])), _p1_block_range(g, block))


def test_p1_geometry_refuses_what_the_kernel_does_not_take():
    for n in (0, 1 << 31):
        with pytest.raises(ValueError):
            K.xor_const_geometry(n, True)


@functools.lru_cache(maxsize=None)
def _covers_once(g) -> bool:
    """Whether a launch's pairs cover each (word, lane) once; the
    elementwise bodies share one geometry, so each is counted once."""
    pairs = K.walk_step_pairs(g)
    return np.array_equal(np.bincount(pairs, minlength=32 * g.batch),
                          np.ones(32 * g.batch, dtype=np.int64))


@pytest.mark.parametrize("blocks", P3_BLOCKS)
@pytest.mark.parametrize("b", P3_B)
@pytest.mark.parametrize("layout, body", K.INSTANTIATIONS)
def test_p3_threads_cover_every_word_and_lane_once(layout, body, b, blocks):
    g = K.walk_step_geometry(b, layout, body, blocks)
    assert g.form == (K.FULL_FORM[layout] if body == "full" else "elementwise")
    assert g.grid == (blocks or (b // K.QUAD_LANES if body == "full"
                                 else -(-8 * b // K.WALK_THREADS)))
    assert _covers_once(g), g


def test_p3_default_forms_and_launch():
    g = K.walk_step_geometry(16384, "grouped", "null")
    assert (g.form, g.grid, g.threads) == ("elementwise", 8 * 16384 // K.WALK_THREADS,
                                           K.WALK_THREADS)
    for layout, form in K.FULL_FORM.items():
        assert (layout, "full") in K.INSTANTIATIONS
        g = K.walk_step_geometry(16384, layout, "full")
        assert (g.form, g.grid, g.threads) == (form, 128, 128 if form == "lane" else 512)
    with pytest.raises(ValueError):
        K.walk_step_geometry(16384 + 64, "grouped", "null")
    with pytest.raises(ValueError):
        K.walk_step_geometry(16384, "grouped", "null", blocks=0)


def test_launch_constants_match_the_cuda_source():
    """The blocks the geometry assumes are the kernels' own, and each
    layout's ``full`` body launches the kernel of its form."""
    src = (Path(K.__file__).parent / "csrc" / "probes.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kXorThreads"]) == K.XOR_THREADS
    assert int(consts["kWalkThreads"]) == K.WALK_THREADS
    assert int(consts["kQuadLanes"]) == K.QUAD_LANES
    kernel = {"lane": "launch_lane<", "quad": "walk_quad_row_kernel<<<"}
    for layout, form in K.FULL_FORM.items():
        case = re.search(rf"case k{layout.capitalize()} \* 4 \+ kFull:\s*(\S+)", src)
        assert case and case.group(1).startswith(kernel[form]), (layout, form)


def test_quad_word_assignment_covers_a_lane_once():
    """Thread t holds B0's words 4t..4t+3 and B1's 16+4t..16+4t+3 in
    salsa.cuh's row layout: r[j] = 4t + ((t + j) & 3), r[0] the
    diagonal word 5t of its 4 x 4 matrix."""
    held = [K.quad_words(t) for t in range(4)]
    assert sorted(w for words in held for w in words) == list(range(32))
    for t, words in enumerate(held):
        assert set(words[:4]) == set(range(4 * t, 4 * t + 4))
        assert set(words[4:]) == set(range(16 + 4 * t, 16 + 4 * t + 4))
        assert words[0] == 5 * t and words[4] == 16 + 5 * t
        assert [words[(j + 1) % 4] - 4 * t for j in range(4)] == [(t + j + 1) % 4 for j in range(4)]


@pytest.mark.parametrize("b", P3_B)
@pytest.mark.parametrize("layout, body", K.INSTANTIATIONS)
def test_layouts_give_the_kernels_their_vectors(layout, body, b):
    """The elementwise form reads vj's words of lanes 4q..4q+3 as one
    16-byte vector (word 0 for one_extract); the quad form a lane's row
    as 8 consecutive 16-byte vectors; the lane form each word of vj once
    (the index map is a permutation of the operand)."""
    lane = np.arange(b)
    if body == "full":
        idx = W.index_map(layout, np.arange(32)[None, :], lane[:, None], b)
        if layout == "row":
            assert np.array_equal(idx, lane[:, None] * 32 + np.arange(32)[None, :])
        assert np.array_equal(np.sort(idx.reshape(-1)), np.arange(32 * b))
        return
    w = np.arange(1 if body == "one_extract" else 32)[:, None, None]
    idx = W.index_map(layout, w, lane.reshape(1, -1, 4), b)
    assert (idx[..., :1] % 4 == 0).all()
    assert (np.diff(idx, axis=-1) == 1).all()


def test_before_after_needs_a_card():
    """The before/after comparison times kernels on the card: asked for
    the CPU it raises before it builds anything; nothing falls back."""
    from tpuminter_torch.probes import before_after

    with pytest.raises(RuntimeError, match="on the card"):
        before_after.run(Path("."), device="cpu")
