"""The layout probes' plain versions and probe modules against the JAX
package's BlockMix and numpy.

``tpuminter_torch.ops.walk_layouts`` (the plain versions of the probe
kernels P1-P3), the wrappers of ``tpuminter_torch.kernels.probes`` on
CPU tensors and the probe modules of ``tpuminter_torch.probes`` must equal
numpy replicas of the ``pallas_call`` bodies of ``scripts/`` (their
layouts, bitcasts and junk chains, built as the scripts build them) and
``tpuminter.ops.scrypt._block_mix_words`` (the Pallas bodies' own
BlockMix, called eagerly on jnp words; each call batches every lane it
needs, since its cost is its count of jnp calls). The scripts are not
imported: they set a process-wide compilation cache when imported.
Sizes: B = 256 lanes, N = 16. The tolerance is exact equality.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuminter.ops.scrypt import _block_mix_words
from tpuminter_torch import kernels
from tpuminter_torch.kernels import build, sass
from tpuminter_torch.kernels import probes as K
from tpuminter_torch.ops import scrypt as S
from tpuminter_torch.ops import walk_layouts as W
from tpuminter_torch.probes import PROBES
from tpuminter_torch.probes import _common as C
from tpuminter_torch.probes import (
    walk_isolate_probe, walk_native_tile_probe, walk_pallas_probe, walk_variants_probe,
    walk_wm2_probe, walk_wm_probe)

B, N = 256, 16
ARGV = ["--device", "cpu", "--b", str(B), "--n", str(N)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions are many small torch calls, which torch's
    intra-op threads slow down here; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _lanes(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _block_mix(planes: np.ndarray) -> np.ndarray:
    """BlockMix of ``(32, L)`` u32 word planes by the reference."""
    return np.stack([np.asarray(w) for w in
                     _block_mix_words([jnp.asarray(p) for p in planes])])


def _operand(vj: np.ndarray, layout: str) -> np.ndarray:
    """``(B, 32)`` gathered rows in ``layout``, built as the scripts
    build them."""
    b = vj.shape[0]
    if layout in ("row", "bitcast"):
        return vj
    if layout == "word":
        return vj.T.reshape(32, b // 128, 128)
    return vj.T.reshape(4, 8, b // 128, 128).transpose(0, 2, 1, 3)  # walk_native_tile


def _words(vj: np.ndarray, layout: str) -> np.ndarray:
    """The ``(32, B)`` words the Pallas bodies read: the rows' words, or
    for ``bitcast`` each 2048-lane block's bytes as ``(32, SUB, 128)``
    (``walk_variants_probe``'s ``vj_ref[...].reshape(32, SUB, LANES)``)."""
    if layout != "bitcast":
        return vj.T
    b = vj.shape[0]
    block = min(2048, b)
    return np.concatenate([vj[i:i + block].reshape(32, block) for i in range(0, b, block)], 1)


@pytest.mark.parametrize("b", [256, 6144])
@pytest.mark.parametrize("layout", W.LAYOUTS)
def test_layout_index_maps_equal_numpy(layout, b):
    vj = np.random.default_rng(b).integers(0, 1 << 32, (b, 32), dtype=np.uint32)
    op = _operand(vj, layout)
    assert op.shape == W.operand_shape(layout, b)
    got = W.layout_words(_lanes(np.ascontiguousarray(op)), layout, b)
    assert torch.equal(got, _lanes(_words(vj, layout)))
    if layout == "bitcast":  # lane b = 2048 i + t, plane p reads vj[2048 i + 64 p + t // 32, t % 32]
        block = min(W.BITCAST_BLOCK, b)
        lane = np.arange(b)
        i, t = lane // block, lane % block
        for p in (0, 5, 31):
            want = vj[block * i + (block // 32) * p + t // 32, t % 32]
            assert torch.equal(got[p], _lanes(want))


def test_bodies_equal_the_pallas_bodies():
    """Every P3 instantiation and ``tr_only`` through the wrappers on CPU
    tensors, against numpy and the reference's BlockMix; no launch is
    counted."""
    rng = np.random.default_rng(3)
    xw = rng.integers(0, 1 << 32, (32, B), dtype=np.uint32)
    xw[:, 0] = 0xFFFFFFFF  # every add carries
    vj = rng.integers(0, 1 << 32, (B, 32), dtype=np.uint32)
    fulls = [layout for layout, body in K.INSTANTIATIONS if body == "full"]
    mixed = _block_mix(np.concatenate([xw ^ _words(vj, layout) for layout in fulls], 1))
    before = [fn.launches for fn in kernels.KERNELS]
    for layout, body in K.INSTANTIATIONS:
        words = _words(vj, layout)
        want = {"null": xw ^ 1, "one_extract": xw ^ words[0], "xor_only": xw ^ words,
                "full": None}[body]
        if want is None:
            k = fulls.index(layout)
            want = mixed[:, k * B:(k + 1) * B]
        got = K.walk_step(_lanes(xw).view(32, B // 128, 128),
                          _lanes(np.ascontiguousarray(_operand(vj, layout))), layout, body)
        assert torch.equal(got.view(32, B), _lanes(want)), (layout, body)
    got = W.walk_step(_lanes(xw).view(32, B // 128, 128), _lanes(vj), "row", "tr_only")
    assert torch.equal(got.view(32, B), _lanes(vj.T))
    assert [fn.launches for fn in kernels.KERNELS] == before


@pytest.mark.parametrize("layout, body, b", [
    ("grouped", "null", B), ("grouped", "one_extract", B), ("grouped", "xor_only", B),
    ("bitcast", "xor_only", B), ("bitcast", "xor_only", 6144)])
def test_library_calls_compute_the_bodies(layout, body, b):
    """The one PyTorch call that the probes time beside P3 computes its
    body's function; the bodies with BlockMix have none."""
    rng = np.random.default_rng(b)
    xw = _lanes(rng.integers(0, 1 << 32, (32, b // 128, 128), dtype=np.uint32))
    vj = _lanes(rng.integers(0, 1 << 32, W.operand_shape(layout, b), dtype=np.uint32))
    got = C.library_call(xw, vj, layout, body)()
    assert torch.equal(got.reshape(xw.shape), W.walk_step(xw, vj, layout, body))
    assert all(C.library_call(xw, vj, lay, "full") is None for lay in ("grouped", "bitcast"))


@pytest.mark.parametrize("name, want", [
    ("16walk_step_kernelILi2ELi3EEEvPKjS2_Pjii", "walk_step_kernel<grouped,full>"),
    ("34search_candidates_hdr_batch_kernelILb1EEEvPKxS2_",
     "search_candidates_hdr_batch_kernel<sched>"),
    ("34search_candidates_hdr_batch_kernelILb0EEEvPKxS2_", "search_candidates_hdr_batch_kernel"),
    ("13reduce_kernelILi9EEEvPKjiPxi", "reduce_kernel<9>"),
    ("11fill_kernelEPxxxi", "fill_kernel")])
def test_sass_names_kernels_readably(name, want):
    ns = "_GLOBAL__N__7a1b2c3d_9_probes_cu_5f6e7d8c"
    assert sass.kernel_name(f"_ZN{len(ns)}{ns}{name}") == want


def test_library_tags_hash_only_the_headers_a_source_includes(tmp_path, monkeypatch):
    for path in build.SOURCES.values():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    (tmp_path / "salsa.cuh").write_bytes((build._CSRC / "salsa.cuh").read_bytes())
    monkeypatch.setattr(build, "_CSRC", tmp_path)
    monkeypatch.setattr(build, "SOURCES", {k: tmp_path / v.name for k, v in build.SOURCES.items()})
    before = {name: build._path(name) for name in build.SOURCES}
    with open(tmp_path / "salsa.cuh", "a") as f:
        f.write("// edited\n")
    changed = {name for name in build.SOURCES if build._path(name) != before[name]}
    assert changed == {"scrypt", "probes"}


@pytest.mark.parametrize("shape", [(256, 32), (64, 128), (37, 1000)])
def test_xor_const_and_transpose_equal_numpy(shape):
    rng = np.random.default_rng(shape[0])
    x = rng.integers(0, 1 << 32, shape, dtype=np.uint32)
    carry = rng.integers(0, 1 << 32, shape[::-1], dtype=np.uint32)
    assert torch.equal(K.xor_const(_lanes(x), 1), _lanes(x ^ 1))
    assert torch.equal(K.xor_const(_lanes(x), 0xFFFFFFFF), _lanes(~x))
    out = _lanes(x)
    assert K.xor_const(out, 7, out=out) is out and torch.equal(out, _lanes(x ^ 7))
    assert torch.equal(K.transpose(_lanes(x)), _lanes(x.T))
    assert torch.equal(K.transpose(_lanes(x), _lanes(carry)), _lanes(carry ^ x.T))


@pytest.fixture(scope="module")
def walk():
    return C.make_walk("cpu", B, N)


@pytest.fixture(scope="module")
def replicas(walk):
    """Four steps of the scripts' ``ref_steps`` (words, the row gather,
    xor, BlockMix) and, in the same BlockMix calls, of
    ``walk_variants_probe``'s ``salsa_only`` chain (the rows bitcast),
    in numpy; and ``xor_only``'s chain."""
    v = walk.v.numpy().astype(np.uint32)
    lane = np.arange(B)
    ref = walk.x.numpy().astype(np.uint32).T
    salsa = xor = ref.copy()

    def gather(carry):
        return v[(carry[16] & (N - 1)).astype(np.int64) * B + lane]

    for _ in range(C.CHECK_STEPS):
        mixed = _block_mix(np.concatenate(
            [ref ^ gather(ref).T, salsa ^ _words(gather(salsa), "bitcast")], 1))
        ref, salsa = mixed[:, :B], mixed[:, B:]
        xor = xor ^ _words(gather(xor), "bitcast")
    return {"ref": ref.T, "salsa_only": salsa, "xor_only": xor}


CHAINS = {
    "16": walk_isolate_probe.DESIGN, "17": walk_native_tile_probe.DESIGN,
    "18-fused": walk_pallas_probe.DESIGN, "20-full": walk_variants_probe.DESIGNS[2],
    "20-full_g1": walk_variants_probe.DESIGNS[3], "22": walk_wm2_probe.DESIGN,
    "23": walk_wm_probe.DESIGN,
}


@pytest.mark.parametrize("site", sorted(CHAINS))
def test_per_step_chain_equals_the_fused_walk(walk, replicas, site):
    """A per-step design's 4-step chain equals the port's fused walk
    (``ops.scrypt.romix_walk``) and the scripts' ``ref_steps`` on the
    reference's BlockMix; ``check_chain`` agrees."""
    design = CHAINS[site]
    assert design.scrypt
    got = C.from_wm(walk, design.chain(walk, C.CHECK_STEPS))
    assert torch.equal(got, S.romix_walk(walk.x, walk.v3, walk.n_log2, C.CHECK_STEPS))
    assert torch.equal(got, _lanes(replicas["ref"]))
    C.check_chain(walk, design)


@pytest.mark.parametrize("name", ["xor_only", "salsa_only"])
def test_bitcast_chains_equal_numpy_replicas(walk, replicas, name):
    design = next(d for d in walk_variants_probe.DESIGNS if d.name == name)
    assert not design.scrypt
    got = design.chain(walk, C.CHECK_STEPS)
    assert torch.equal(got.view(32, B), _lanes(replicas[name]))


def test_tr_dense_junk_chain_equals_numpy_replica(walk):
    """21's chain as written: row 16 of a ``(128, B/4)`` carry, mod N,
    tiled four times, picks the rows; ``carry ^ rows.T``."""
    v = walk.v.numpy().astype(np.uint32)
    carry = walk.x.numpy().astype(np.uint32).reshape(B // 4, 128).T
    got = walk_variants_probe.tr_dense_start(walk)
    assert torch.equal(got, _lanes(carry))
    for _ in range(C.CHECK_STEPS):
        j = np.concatenate([carry[16] & (N - 1)] * 4)[:B].astype(np.int64)
        carry = carry ^ v[j * B + np.arange(B)].reshape(B // 4, 128).T
        got = walk_variants_probe.tr_dense_step(walk, got)
    assert torch.equal(got, _lanes(carry))


@pytest.mark.parametrize("name", PROBES)
def test_probe_main_runs_on_the_cpu(name, capsys):
    assert importlib.import_module(f"tpuminter_torch.probes.{name}").main(ARGV) == 0
    out = capsys.readouterr().out
    assert "cpu, plain versions" in out or "on the CPU" in out
    if name not in ("pallas_launch_overhead_probe", "transpose_micro_probe", "hlo_layout_check"):
        assert "exact=True" in out and "shipping (19)" in out


def test_checks_refuse_bad_inputs_and_a_missing_card():
    xw = torch.zeros((32, 2, 128), dtype=torch.int64)
    with pytest.raises(ValueError):  # not instantiated on the card
        K.walk_step(xw, torch.zeros((B, 32), dtype=torch.int64), "row", "xor_only")
    with pytest.raises(ValueError):
        K.walk_step(xw, torch.zeros((B, 31), dtype=torch.int64), "row", "full")
    with pytest.raises(ValueError):
        K.walk_step(xw, torch.zeros((4, 2, 8, 127), dtype=torch.int64), "grouped", "full")
    with pytest.raises(ValueError):  # int32 words belong on the card
        K.walk_step(xw.to(torch.int32), torch.zeros((B, 32), dtype=torch.int32), "row", "full")
    with pytest.raises(ValueError):  # 3 bitcast blocks and a half
        K.walk_step(torch.zeros((32, 56, 128), dtype=torch.int64),
                    torch.zeros((7168, 32), dtype=torch.int64), "bitcast", "full")
    with pytest.raises(ValueError):
        K.transpose(torch.zeros((4, 5), dtype=torch.int64), torch.zeros((4, 5), dtype=torch.int64))
    with pytest.raises(ValueError):
        K.transpose(torch.zeros(7, dtype=torch.int64))
    with pytest.raises(ValueError):
        K.xor_const(torch.zeros(7, dtype=torch.int64), 1 << 32)
    with pytest.raises(ValueError):
        K.xor_const(torch.zeros(7, dtype=torch.int64), 1, out=torch.zeros(6, dtype=torch.int64))
    for name in PROBES:  # a CUDA request without a card raises; nothing falls back
        with pytest.raises(RuntimeError, match="CUDA device"):
            importlib.import_module(f"tpuminter_torch.probes.{name}").run("cuda", b=B, n=N)
