"""K4 and S2 timed beside their versions before the redesign, in one run.

Not a counterpart of a script: cards differ by about 10% from one run to
the next, so a redesign's move is read only against the old kernel on
the same card. It builds ``csrc/sha256.cu`` and ``csrc/scrypt.cu`` of
another checkout (``--before DIR``, an unpacked checkout of commit
30c4a81, whose C interface this module knows:
``tm_search_candidates_hdr(mid8, tail3, base, n, hw1_cap, handle, grid,
device, stream)``, launched on 8 blocks an SM, and
``tm_scrypt_back(hd, tg, nonces, x, digest, handle, partial, count,
device, stream)`` with 9 partial words a block) into ``build/before/``
with ``kernels.build``'s flags, one ``nvcc`` each, both at once, and
times on the same operands:

- K4 on 2^27 nonces of a roll row (a seeded mainnet-shaped template's
  extranonce 0, rolled on the card; ``hw1_cap`` 0, so no early exit):
  before, and this checkout's, also on 1, 2 and 8 whole waves of its
  resident blocks beside its ``HDR_WAVES``;
- S2 on 2^16 and 2^15 hashes of seeded X at the batch's 5th-smallest
  hash as the target: before, and this checkout's.

Each output is first held equal to the other's and to the plain
version's (K4 also on the genesis row around its winner, at the genesis
target's cap). Each pair is then timed in ``paired_ms``'s interleaved
rounds (``--rounds``, alternating order, medians), and each kernel's
static SASS instructions and registers are read from both builds
(``kernels.sass``).

Run on the card::

    git archive 30c4a81 | tar -x -C build/before_src
    python -m tpuminter_torch.probes.before_after --before build/before_src
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from tpuminter_torch import chain
from tpuminter_torch.kernels import build, sass
from tpuminter_torch.kernels import scrypt as KS
from tpuminter_torch.kernels import sha256 as K
from tpuminter_torch.kernels.sha256 import _sm_count, _stream
from tpuminter_torch.ops import merkle
from tpuminter_torch.ops import scrypt as S
from tpuminter_torch.ops import sha256 as ops
from tpuminter_torch.probes._common import paired_ms, resolve

__all__ = ["load_before", "run", "main"]

ROUNDS = 6
#: K4's nonces a launch on the rolled path, and S2's hashes a batch
K4_N = 1 << 27
S2_COUNTS = (1 << 16, 1 << 15)
#: the kernels compared, by library: (SASS name after, SASS names before)
KERNELS = {"sha256": ("search_candidates_hdr_kernel", ("search_candidates_hdr_kernel",)),
           "scrypt": ("scrypt_back_kernel", ("init_handle_kernel", "scrypt_back_kernel",
                                             "scrypt_fold_kernel"))}
#: K4's whole waves this checkout's kernel is also timed on, beside
#: ``kernels.sha256.HDR_WAVES``
WAVES = (1, 2, 4, 8)
#: the grid the K4 launcher of commit 30c4a81 gave every launch, blocks an SM
BEFORE_BLOCKS_PER_SM = 8
#: u32 words of an S2 block's partial at commit 30c4a81
BEFORE_PARTIAL = 9


def load_before(checkout: Path) -> dict:
    """``checkout``'s ``sha256.cu`` and ``scrypt.cu`` built with
    ``kernels.build``'s flags and loaded, with the C interface of commit
    30c4a81 declared: ``{"sha256": lib, "scrypt": lib}``."""
    csrc = Path(checkout) / "tpuminter_torch" / "kernels" / "csrc"
    out_dir = build.BUILD_DIR.parent / "before"
    out_dir.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in KERNELS:
        src = csrc / f"{name}.cu"
        if not src.is_file():
            raise FileNotFoundError(f"no {src.name} under {checkout}")
        out = out_dir / f"tm_{name}_before.so"
        running[name] = (out, subprocess.Popen(
            [build._nvcc(), *build.FLAGS, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu of {checkout}:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
        libs[name].path = str(out)
    ptr, u32, i32 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int
    k4 = libs["sha256"].tm_search_candidates_hdr
    k4.argtypes = [ptr, ptr, u32, u32, u32, ptr, i32, i32, ptr]
    s2 = libs["scrypt"].tm_scrypt_back
    s2.argtypes = [ctypes.POINTER(build.TmScryptHeader), ctypes.POINTER(build.TmTarget), ptr,
                   ptr, ptr, ptr, ptr, i32, i32, ptr]
    k4.restype = s2.restype = i32
    return libs


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def _equal(outs: dict, what: str) -> None:
    """Every output (a tensor or a tuple of them) equal to the first's."""
    def parts(o):
        return o if isinstance(o, tuple) else (o,)

    (first, want), *rest = outs.items()
    for name, got in rest:
        if not all(torch.equal(g, w) for g, w in zip(parts(got), parts(want))):
            raise RuntimeError(f"{what}: {name} differs from {first}")


def _sass(path: str, kernels) -> dict:
    """Static SASS instructions and registers of ``kernels`` in a build,
    or None without ``cuobjdump``."""
    counts, usage = sass.sass_summary(path), sass.resource_usage(path)
    if counts is None:
        return None
    return {k: {"instructions": sum(counts[k].values()), "registers": usage[k]["REG"]}
            for k in kernels}


def _k4_rows(device) -> tuple:
    """A seeded mainnet-shaped template's extranonce-0 row, rolled on the
    card, and the genesis header's row."""
    rng = np.random.default_rng(10)
    genesis = chain.GENESIS_HEADER.pack()
    job = merkle.build_roll(genesis, rng.bytes(120), rng.bytes(126), 4,
                            tuple(rng.bytes(32) for _ in range(12)))
    zero = torch.zeros(1, dtype=torch.int64, device=device)
    mids, tails = K.extranonce_roll(job, zero, zero)
    tmpl = ops.header_template(genesis)
    g_mid = torch.tensor(list(tmpl.midstate), dtype=torch.int64, device=device)
    g_tail = torch.tensor(list(tmpl.tail[0][:3]), dtype=torch.int64, device=device)
    return (mids[0], tails[0]), (g_mid, g_tail)


def _k4(lib, device, rounds: int) -> dict:
    (mid, tail), (g_mid, g_tail) = _k4_rows(device)
    sms = _sm_count(device.index)

    def before(mid, tail, base, n, cap):
        handle = torch.empty(2, dtype=torch.int64, device=device)
        grid = min(-(-n // K.THREADS), BEFORE_BLOCKS_PER_SM * sms)
        _check(lib.tm_search_candidates_hdr(mid.data_ptr(), tail.data_ptr(), base, n, cap,
                                            handle.data_ptr(), grid, device.index,
                                            _stream(device)), "tm_search_candidates_hdr (before)")
        return handle

    genesis = chain.GENESIS_HEADER
    cap = int(ops.target_to_words(chain.bits_to_target(genesis.bits))[1])
    base = (genesis.nonce - (1 << 21)) & ops.M32
    args = (g_mid, g_tail, base, 1 << 22, cap)
    _equal({"plain": K.search_candidates_hdr_plain(*args), "before": before(*args),
            "after": K.search_candidates_hdr(*args)}, "K4 on the genesis row")
    base = int(np.random.default_rng(11).integers(0, (1 << 32) - K4_N))
    args = (mid, tail, base, K4_N, 0)
    _equal({"plain": K.search_candidates_hdr_plain(*args), "before": before(*args),
            "after": K.search_candidates_hdr(*args)}, f"K4 on {K4_N} nonces")
    resident, _ = K.occupancy(K.OCCUPANCY_KERNELS["search_candidates_hdr"], device.index)

    def after_at(waves):
        """This checkout's kernel on ``waves`` whole waves instead of
        ``HDR_WAVES``."""
        handle = torch.empty(2, dtype=torch.int64, device=device)
        _check(build.library("sha256").tm_search_candidates_hdr(
            mid.data_ptr(), tail.data_ptr(), base, K4_N, 0, handle.data_ptr(),
            waves * resident * sms, device.index, _stream(device)), "tm_search_candidates_hdr")
        return handle

    fns = {"before": lambda: before(*args), "after": lambda: K.search_candidates_hdr(*args)}
    fns.update({f"after, {w} waves": (lambda w=w: after_at(w)) for w in WAVES
                if w != K.HDR_WAVES})
    _equal({name: fn() for name, fn in fns.items()}, f"K4 on {K4_N} nonces at every grid")
    return {"n": K4_N, "paired_ms": paired_ms(fns, device, rounds), "grid": {
        "before": min(-(-K4_N // K.THREADS), BEFORE_BLOCKS_PER_SM * sms),
        "after": K.hdr_grid(K4_N, resident, sms)}, "resident_after": resident,
        "waves_after": K.HDR_WAVES}


def _s2(lib, device, rounds: int) -> dict:
    rng = np.random.default_rng(12)
    words = S.header_to_words(rng.bytes(76))
    big = max(S2_COUNTS)
    x_all = torch.tensor(rng.integers(0, 1 << 32, (big, 32), dtype=np.int64), device=device)
    n_all = torch.tensor(rng.integers(0, 1 << 32, big, dtype=np.int64), device=device)
    hd = build.TmScryptHeader()
    hd.w[:] = list(words)
    out = {}
    for count in S2_COUNTS:
        x, nonces = x_all[:count], n_all[:count]
        digest, _ = KS.scrypt_back(words, nonces, x, [0] * 8)
        raw = digest.cpu().numpy().astype(">u4").tobytes()
        values = sorted(int.from_bytes(raw[i:i + 32], "little") for i in range(0, len(raw), 32))
        target = [int(w) for w in ops.target_to_words(values[4])]
        tg = build.TmTarget()
        tg.w[:] = target

        def before(x=x, nonces=nonces, count=count, tg=tg):
            digest = torch.empty((count, 8), dtype=torch.int64, device=device)
            handle = torch.empty(S.HANDLE_WORDS, dtype=torch.int64, device=device)
            partial = torch.empty(-(-count // KS.THREADS) * BEFORE_PARTIAL, dtype=torch.int32,
                                  device=device)
            _check(lib.tm_scrypt_back(ctypes.byref(hd), ctypes.byref(tg), nonces.data_ptr(),
                                      x.data_ptr(), digest.data_ptr(), handle.data_ptr(),
                                      partial.data_ptr(), count, device.index,
                                      _stream(device)), "tm_scrypt_back (before)")
            return digest, handle

        def after(x=x, nonces=nonces, target=target):
            return KS.scrypt_back(words, nonces, x, target)

        _equal({"plain": KS.scrypt_back_plain(words, nonces, x, target), "before": before(),
                "after": after()}, f"S2 on {count} hashes")
        out[count] = {"paired_ms": paired_ms({"before": before, "after": after}, device,
                                             rounds)}
    blocks, regs = KS.occupancy(device)["scrypt_back"]
    return {"by_count": out, "resident_after": blocks, "registers_after": regs}


def run(before: Path, rounds: int = ROUNDS, device="cuda") -> dict:
    device = resolve(device)
    if device.type != "cuda":
        raise RuntimeError("the comparison times kernels on the card; the CPU has none")
    libs = load_before(before)
    infos = build.build()
    code = {}
    for name, (after_kernel, before_kernels) in KERNELS.items():
        code[name] = {"before": _sass(libs[name].path, before_kernels),
                      "after": _sass(str(infos[name].path), (after_kernel,))}
    return {"device": torch.cuda.get_device_name(device), "rounds": rounds,
            "k4": _k4(libs["sha256"], device, rounds),
            "s2": _s2(libs["scrypt"], device, rounds), "sass": code}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--before", type=Path, required=True,
                    help="an unpacked checkout of commit 30c4a81")
    ap.add_argument("--rounds", type=int, default=ROUNDS,
                    help=f"paired_ms's interleaved rounds (default {ROUNDS})")
    args = ap.parse_args(argv)
    result = run(args.before, args.rounds)
    print(f"before / after on {result['device']}, ms a launch, median of {args.rounds} "
          "interleaved rounds")
    k4 = result["k4"]
    ms = k4["paired_ms"]
    print(f"K4 on {k4['n']} nonces: before {ms['before']:.4f} (grid {k4['grid']['before']}), "
          f"after {ms['after']:.4f} (grid {k4['grid']['after']}: {k4['waves_after']} waves of "
          f"{k4['resident_after']} blocks an SM): {ms['after'] / ms['before']:.3f}x; "
          + ", ".join(f"{name} {t:.4f}" for name, t in ms.items() if "waves" in name))
    for count, row in result["s2"]["by_count"].items():
        ms = row["paired_ms"]
        print(f"S2 on {count} hashes: before {ms['before']:.4f}, after {ms['after']:.4f}: "
              f"{ms['after'] / ms['before']:.3f}x")
    for name, both in result["sass"].items():
        print(f"SASS {name}: before {both['before']}, after {both['after']}")
    print(json.dumps({"before_after": result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
