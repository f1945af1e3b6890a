"""The port's splitmix64 lanes against the JAX package's.

The plain objective (``ops.splitmix.splitmix64_pair``, K7's plain
version) must equal the reference's u32-pair lanes, its Pallas kernel
(interpret mode, as tests/test_hashcore_dev.py runs it) and the scalar
``objective`` bit for bit, word boundaries and the 2^64 wrap included;
the K7 wrapper must route CPU tensors to it; and each variant's
``LaneSweep`` window partial must equal the reference ``LaneSweep``'s
(jnp engine) on ragged spans. The tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from tpuminter.kernels.splitmix import pallas_splitmix_batch
from tpuminter.ops import splitmix as ref_sm
from tpuminter.workloads import hashcore as ref_hc
from tpuminter_torch import kernels
from tpuminter_torch.kernels import splitmix as K
from tpuminter_torch.ops import splitmix as sm

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1
#: indices where a carry or a cross-word shift is off by one if wrong
EDGES = [0, 1, M32 - 1, M32, 1 << 32, (1 << 32) + 1, (5 << 32) - 1, 1 << 63, M64 - 1, M64]
SEEDS = [0, 1, M64, 0x9E3779B97F4A7C15, 0x0123456789ABCDEF]


def _indices(seed: int, n: int = 384):
    """``n`` numpy-seeded u64 indices of mixed widths, the edges, and
    indices just below 2^64 up to a multiple of 128 (the Pallas
    kernel's lane tile)."""
    rng = np.random.default_rng(seed & M32)
    bits = rng.choice([8, 32, 63, 64], n)
    raw = rng.integers(0, 1 << 63, n, dtype=np.uint64) * np.uint64(2) + rng.integers(
        0, 2, n, dtype=np.uint64)
    idx = [int(v) & ((1 << int(b)) - 1) for v, b in zip(raw, bits)]
    return idx + EDGES + [M64 - i for i in range(-(n + len(EDGES)) % 128)]


def _words(idx):
    return (np.array([i >> 32 for i in idx], np.uint32),
            np.array([i & M32 for i in idx], np.uint32))


def _port_values(seed, idx):
    hi, lo = _words(idx)
    vh, vl = sm.splitmix64_pair(seed, torch.from_numpy(hi.astype(np.int64)),
                                torch.from_numpy(lo.astype(np.int64)))
    return [(h << 32) | l for h, l in zip(vh.tolist(), vl.tolist())]


@pytest.mark.parametrize("seed", SEEDS)
def test_plain_objective_equals_reference_lanes_and_scalar(seed):
    idx = _indices(seed)
    hi, lo = _words(idx)
    rh, rl = ref_sm.splitmix64_pair(np.uint32(seed >> 32), np.uint32(seed & M32), hi, lo)
    ref_lanes = [(int(h) << 32) | int(l) for h, l in zip(np.asarray(rh), np.asarray(rl))]
    got = _port_values(seed, idx)
    assert got == ref_lanes == [ref_hc.objective(seed, i) for i in idx]


@pytest.mark.parametrize("seed", [0, M64, 0x0123456789ABCDEF])
def test_plain_objective_equals_pallas_kernel_interpret_mode(seed):
    idx = _indices(seed, 200)  # 256 lanes
    hi, lo = _words(idx)
    vh, vl = pallas_splitmix_batch(np.uint32(seed >> 32), np.uint32(seed & M32), hi, lo)
    want = [(int(h) << 32) | int(l) for h, l in zip(np.asarray(vh), np.asarray(vl))]
    assert _port_values(seed, idx) == want


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    seed = 0xDEADBEEFCAFEF00D
    idx = _indices(seed, 246)
    hi, lo = (torch.from_numpy(w.astype(np.int64)) for w in _words(idx))
    before = [fn.launches for fn in kernels.KERNELS]
    got = K.splitmix_batch(seed, hi, lo)
    want = K.splitmix_batch_plain(seed, hi, lo)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert [(h << 32) | l for h, l in zip(*(t.tolist() for t in got))] == [
        ref_hc.objective(seed, i) for i in idx]
    assert [fn.launches for fn in kernels.KERNELS] == before  # plain runs are not launches
    empty = torch.zeros(0, dtype=torch.int64)
    assert [t.shape for t in K.splitmix_batch(seed, empty, empty)] == [(0,), (0,)]


@pytest.mark.parametrize("bad", ["seed", "dtype", "shape", "mismatch"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    lanes = torch.arange(8, dtype=torch.int64)
    args = {
        "seed": (1 << 64, lanes, lanes),
        "dtype": (1, lanes.to(torch.int32), lanes),
        "shape": (1, lanes.view(2, 4), lanes.view(2, 4)),
        "mismatch": (1, lanes, lanes[:4]),
    }[bad]
    with pytest.raises(ValueError):
        K.splitmix_batch(*args)


# -- window partials against the reference LaneSweep ------------------------

WIDTH, ROWS = 256, 2  # the reference's test shape: one jit per variant


def _spans(seed):
    """Ragged spans at word boundaries and random bases, numpy-seeded."""
    rng = np.random.default_rng(seed)
    spans = [((1 << 32) - 100, 300), (M64 - 511, 512), (0, 1), (7, WIDTH * ROWS)]
    for _ in range(4):
        lo = int(rng.integers(0, 1 << 62)) << int(rng.integers(0, 2))
        spans.append((lo, int(rng.integers(1, WIDTH * ROWS + 1))))
    return [(lo, lo + n - 1) for lo, n in spans]


@pytest.mark.parametrize("variant,k", [("fmin", 1), ("topk", 5), ("topk", 8), ("fmatch", 1),
                                       ("fsum", 1)])
def test_lane_sweep_partial_equals_reference(variant, k):
    ref = ref_sm.LaneSweep(variant, WIDTH, ROWS, k, "jnp")
    mine = sm.LaneSweep(variant, WIDTH, ROWS, k, "cpu")
    rng = np.random.default_rng(17)
    for lo, hi in _spans(23):
        seed = int(rng.integers(0, 1 << 63)) * 2 + 1
        # thresholds that hit early, late or never
        thr = int(rng.choice([1 << 56, 1 << 60, 0])) if variant == "fmatch" else 0
        want = ref.resolve(ref.dispatch(seed, lo, hi, thr), lo, hi)
        got = mine.resolve(mine.dispatch(seed, lo, hi, thr), lo, hi)
        assert got == want, (variant, seed, lo, hi, thr)


def test_fsum_is_exact_at_maximal_values():
    """The reference's 16-bit-column worst case: every lane near 2^64."""
    seed, lo = M64, (1 << 63) - 17
    hi = lo + WIDTH * ROWS - 1
    ref = ref_sm.LaneSweep("fsum", WIDTH, ROWS, 1, "jnp")
    mine = sm.LaneSweep("fsum", WIDTH, ROWS, 1, "cpu")
    total, count = mine.resolve(mine.dispatch(seed, lo, hi), lo, hi)
    assert [total, count] == ref.resolve(ref.dispatch(seed, lo, hi), lo, hi)
    assert total == sum(ref_hc.objective(seed, i) for i in range(lo, hi + 1))


def test_lane_sweep_rejects_bad_shapes_and_devices(monkeypatch):
    with pytest.raises(ValueError):
        sm.LaneSweep("nope", 256, 2, 1, "cpu")
    with pytest.raises(ValueError):
        sm.LaneSweep("fmin", 0, 2, 1, "cpu")
    with pytest.raises(ValueError):
        sm.LaneSweep("fmin", sm.MAX_WINDOW, 2, 1, "cpu")
    with pytest.raises(ValueError):
        sm.LaneSweep("fmin", 256, 2, 1, "cpu", engine="pallas")
    with pytest.raises(ValueError):
        sm.LaneSweep("fmin", 256, 2, 1, "cpu").dispatch(1, 0, 512)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        sm.LaneSweep("fmin", 256, 2, 1, "cuda")
