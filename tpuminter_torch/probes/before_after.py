"""Redesigned kernels timed beside their versions before the redesign, in one run.

Not a counterpart of a script: cards differ by about 10% from one run to
the next, so a redesign's move is read only against the old kernel on
the same card. The module holds a table of comparisons (``COMPARISONS``),
one row for each old C interface, keyed by the commit whose sources it
knows. A row builds that commit's ``csrc/`` sources (an unpacked
checkout, ``--before COMMIT=DIR``) into ``build/before/COMMIT/`` with
``kernels.build``'s flags, one ``nvcc`` each, all at once, holds old
against new against plain on the same operands, times old and new in
``paired_ms``'s interleaved rounds (``--rounds``, alternating order,
medians), and reads each kernel's static SASS instructions and
registers from both builds (``kernels.sass``). The rows:

- ``30c4a81``: K4 and S2. Its C interface:
  ``tm_search_candidates_hdr(mid8, tail3, base, n, hw1_cap, handle,
  grid, device, stream)``, launched on 8 blocks an SM, and
  ``tm_scrypt_back(hd, tg, nonces, x, digest, handle, partial, count,
  device, stream)`` with 9 partial words a block. K4 on 2^27 nonces of a
  roll row (a seeded mainnet-shaped template's extranonce 0, rolled on
  the card; ``hw1_cap`` 0, so no early exit): before, and this
  checkout's, also on 1, 2 and 8 whole waves of its resident blocks
  beside its ``HDR_WAVES`` (K4 is also held equal on the genesis row
  around its winner, at the genesis target's cap); S2 on 2^16 and 2^15
  hashes of seeded X at the batch's 5th-smallest hash as the target.
- ``0a4d045``: R and 11. Its C interface:
  ``tm_extranonce_roll(job, n_blocks, n_pos, depth, en_hi, en_lo, mids,
  tails, rows, device, stream)`` on an int64 job buffer (midstate, tail
  blocks, byte positions, branch, header words), and
  ``tm_row_gather(v, rows, idx, out, count, reps, device, stream)``. R
  on a seeded mainnet-shaped template (250-byte coinbase, 4-byte
  extranonce, 12-deep branch) at 2 and 10 rows, beside R's serial floor
  (``kernels.sha256.serial_floor``) for that template's chain; 11 at the
  probe's shapes (8192 lanes of a 256 MiB V) at 32 and 256 passes, its
  time a pass the slope between them.
- ``fb7f061``: P2. Its C interface: ``tm_transpose_u32(in, xin, out,
  rows, cols, device, stream)``, the padded 32 x 33 tile on 32 x 8
  threads for every shape. P2 at the probes' shapes (B = 16384): ``(B,
  32)`` (sites 14, 18, 20's ``tr_only``, 24), ``(32, B)`` (the probes'
  ``from_wm``), ``(B/4, 128)`` (15) and the same into a carry (21):
  before and this checkout's vector arm, beside ``t().contiguous()``
  (and ``bitwise_xor(carry, x.t())`` for the carry).

Run on the card::

    git archive 30c4a81 | tar -x -C build/before_30c4a81
    git archive 0a4d045 | tar -x -C build/before_0a4d045
    git archive fb7f061 | tar -x -C build/before_fb7f061
    python -m tpuminter_torch.probes.before_after \\
        --before 30c4a81=build/before_30c4a81 --before 0a4d045=build/before_0a4d045 \\
        --before fb7f061=build/before_fb7f061
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from tpuminter_torch import chain
from tpuminter_torch.kernels import build, sass
from tpuminter_torch.kernels import probes as KP
from tpuminter_torch.kernels import scrypt as KS
from tpuminter_torch.kernels import sha256 as K
from tpuminter_torch.kernels.sha256 import _sm_count, _stream
from tpuminter_torch.ops import merkle
from tpuminter_torch.ops import scrypt as S
from tpuminter_torch.ops import sha256 as ops
from tpuminter_torch.ops import walk_layouts as W
from tpuminter_torch.probes._common import MEM_BYTES_PER_S, paired_ms, resolve

__all__ = ["Comparison", "COMPARISONS", "load_before", "run", "main"]

ROUNDS = 6
#: K4's nonces a launch on the rolled path, and S2's hashes a batch
K4_N = 1 << 27
S2_COUNTS = (1 << 16, 1 << 15)
#: K4's whole waves this checkout's kernel is also timed on, beside
#: ``kernels.sha256.HDR_WAVES``
WAVES = (1, 2, 4, 8)
#: the grid the K4 launcher of commit 30c4a81 gave every launch, blocks an SM
BEFORE_BLOCKS_PER_SM = 8
#: u32 words of an S2 block's partial at commit 30c4a81
BEFORE_PARTIAL = 9
#: R's rows a launch: a window's two (its extranonce and the padding
#: rows' 0), and a batched window's roll_batch + 2
ROLL_ROWS = (2, 10)
#: 11's shapes (scripts/romix_pallas_probe.py): rows, lanes, and the two
#: pass counts whose difference gives the time a pass
GATHER_ROWS, GATHER_B, GATHER_REPS = 256 * 8192, 8192, (32, 256)
#: P2's shapes (the probes' at B = 16384), by name, and whether a carry
#: is xored in
P2_SHAPES = {"(B, 32)": ((16384, 32), False), "(32, B)": ((32, 16384), False),
             "(B/4, 128)": ((4096, 128), False), "(B/4, 128) into a carry": ((4096, 128), True)}


@dataclass(frozen=True)
class Comparison:
    """One row: the libraries an old commit's sources build, how its C
    interface is declared, the kernels whose SASS is read (this
    checkout's names, the old build's names), and the measurement."""

    what: str
    sources: Tuple[str, ...]
    declare: Callable[[dict], None]
    kernels: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]]
    measure: Callable[[dict, torch.device, int], dict]
    report: Callable[[dict], list]


def load_before(checkout: Path, commit: str) -> dict:
    """``checkout``'s sources of ``COMPARISONS[commit]`` built with
    ``kernels.build``'s flags into ``build/before/COMMIT/`` and loaded,
    with that commit's C interface declared: ``{name: lib}``."""
    row = COMPARISONS[commit]
    csrc = Path(checkout) / "tpuminter_torch" / "kernels" / "csrc"
    out_dir = build.BUILD_DIR.parent / "before" / commit
    out_dir.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in row.sources:
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
    row.declare(libs)
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


def _sass(path: str, prefixes) -> dict:
    """Static SASS instructions and registers of the kernels of a build
    whose names start with one of ``prefixes``, or None without
    ``cuobjdump``."""
    counts, usage = sass.sass_summary(path), sass.resource_usage(path)
    if counts is None:
        return None
    return {k: {"instructions": sum(counts[k].values()), "registers": usage[k]["REG"]}
            for k in counts if k.startswith(tuple(prefixes))}


def _mainnet_job(seed: int) -> merkle.RollJob:
    """A seeded mainnet-shaped template on the genesis header: a 250-byte
    coinbase with a 4-byte extranonce, and a 12-deep Merkle branch."""
    rng = np.random.default_rng(seed)
    return merkle.build_roll(chain.GENESIS_HEADER.pack(), rng.bytes(120), rng.bytes(126), 4,
                             tuple(rng.bytes(32) for _ in range(12)))


# ---- 30c4a81: K4 and S2 --------------------------------------------------------------

def _declare_30c4a81(libs: dict) -> None:
    ptr, u32, i32 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int
    k4 = libs["sha256"].tm_search_candidates_hdr
    k4.argtypes = [ptr, ptr, u32, u32, u32, ptr, i32, i32, ptr]
    s2 = libs["scrypt"].tm_scrypt_back
    s2.argtypes = [ctypes.POINTER(build.TmScryptHeader), ctypes.POINTER(build.TmTarget), ptr,
                   ptr, ptr, ptr, ptr, i32, i32, ptr]
    k4.restype = s2.restype = i32


def _k4_rows(device) -> tuple:
    """A seeded mainnet-shaped template's extranonce-0 row, rolled on the
    card, and the genesis header's row."""
    job = _mainnet_job(10)
    zero = torch.zeros(1, dtype=torch.int64, device=device)
    mids, tails = K.extranonce_roll(job, zero, zero)
    tmpl = ops.header_template(chain.GENESIS_HEADER.pack())
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


def _measure_30c4a81(libs: dict, device, rounds: int) -> dict:
    return {"k4": _k4(libs["sha256"], device, rounds), "s2": _s2(libs["scrypt"], device, rounds)}


def _report_30c4a81(result: dict) -> list:
    k4 = result["k4"]
    ms = k4["paired_ms"]
    lines = [f"K4 on {k4['n']} nonces: before {ms['before']:.4f} (grid {k4['grid']['before']}), "
             f"after {ms['after']:.4f} (grid {k4['grid']['after']}: {k4['waves_after']} waves of "
             f"{k4['resident_after']} blocks an SM): {ms['after'] / ms['before']:.3f}x; "
             + ", ".join(f"{name} {t:.4f}" for name, t in ms.items() if "waves" in name)]
    for count, row in result["s2"]["by_count"].items():
        ms = row["paired_ms"]
        lines.append(f"S2 on {count} hashes: before {ms['before']:.4f}, after {ms['after']:.4f}: "
                     f"{ms['after'] / ms['before']:.3f}x")
    return lines


# ---- 0a4d045: R and 11 -----------------------------------------------------------------

def _declare_0a4d045(libs: dict) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    roll = libs["sha256"].tm_extranonce_roll
    roll.argtypes = [ptr, i32, i32, i32, ptr, ptr, ptr, ptr, i32, i32, ptr]
    gather = libs["scrypt"].tm_row_gather
    gather.argtypes = [ptr, i64, ptr, ptr, i32, i32, i32, ptr]
    roll.restype = gather.restype = i32


def _old_roll_words(job: merkle.RollJob) -> list:
    """The job as commit 0a4d045's roll read it: int64 words of the
    midstate, the tail blocks, the byte positions (block, word, word
    shift, extranonce shift), the branch, header words 0-8, time, bits."""
    cb = job.coinbase
    out = list(cb.midstate)
    for block in cb.tail:
        out += block
    for pos in cb.positions:
        out += pos
    for sib in job.branch:
        out += sib
    return out + list(job.head9) + list(job.time_bits)


def _roll(lib, device, rounds: int) -> dict:
    job = _mainnet_job(13)
    old_job = torch.tensor(_old_roll_words(job), dtype=torch.int64, device=device)
    cb = job.coinbase
    n_blocks, depth = len(cb.tail), len(job.branch)

    def before(hi, lo):
        b = hi.shape[0]
        mids = torch.empty((b, 8), dtype=torch.int64, device=device)
        tails = torch.empty((b, 3), dtype=torch.int64, device=device)
        _check(lib.tm_extranonce_roll(old_job.data_ptr(), len(cb.tail), len(cb.positions),
                                      len(job.branch), hi.data_ptr(), lo.data_ptr(),
                                      mids.data_ptr(), tails.data_ptr(), b, device.index,
                                      _stream(device)), "tm_extranonce_roll (before)")
        return mids, tails

    out = {"compressions": n_blocks + 1 + 3 * depth + 1}
    for rows in ROLL_ROWS:
        hi = torch.zeros(rows, dtype=torch.int64, device=device)
        lo = torch.arange(rows, dtype=torch.int64, device=device)
        _equal({"plain": K.extranonce_roll_plain(job, hi, lo), "before": before(hi, lo),
                "after": K.extranonce_roll(job, hi, lo)}, f"R on {rows} rows")
        fns = {"before": lambda: before(hi, lo), "after": lambda: K.extranonce_roll(job, hi, lo)}
        if rows == ROLL_ROWS[0]:
            floor = K.serial_floor(n_blocks, depth, device)
            if floor.tolist() != K.serial_floor_plain(n_blocks, depth):
                raise RuntimeError("R's serial floor differs from its plain version")
            fns["serial floor"] = lambda: K.serial_floor(n_blocks, depth, device)
        out[rows] = {"paired_ms": paired_ms(fns, device, rounds)}
    return out


def _gather(lib, device, rounds: int) -> dict:
    rng = np.random.default_rng(14)
    i = torch.arange(GATHER_ROWS, dtype=torch.int64, device=device)[:, None]
    v = (i * 2654435761 + torch.arange(32, dtype=torch.int64, device=device)[None]) & ops.M32
    del i
    v = torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)
    idx = torch.tensor(rng.integers(0, GATHER_ROWS, GATHER_B, dtype=np.int64), device=device)
    sms = _sm_count(device.index)

    def before(reps):
        out = torch.empty(GATHER_B, dtype=torch.int64, device=device)
        _check(lib.tm_row_gather(v.data_ptr(), GATHER_ROWS, idx.data_ptr(), out.data_ptr(),
                                 GATHER_B, reps, device.index, _stream(device)),
               "tm_row_gather (before)")
        return out

    lo, hi = GATHER_REPS
    for reps in GATHER_REPS:
        _equal({"plain": KS.row_gather_plain(v, idx, reps), "before": before(reps),
                "after": KS.row_gather(v, idx, reps)}, f"11 at {reps} passes")
    g = KS.gather_geometry(GATHER_B, hi, sms)
    fns = {}
    for reps in GATHER_REPS:
        fns[f"before @{reps}"] = lambda reps=reps: before(reps)
        fns[f"after @{reps}"] = lambda reps=reps: KS.row_gather(v, idx, reps)
    ms = paired_ms(fns, device, rounds)
    per_pass = {name: (ms[f"{name} @{hi}"] - ms[f"{name} @{lo}"]) / (hi - lo)
                for name in ("before", "after")}
    del v
    torch.cuda.empty_cache()
    return {"rows": GATHER_ROWS, "lanes": GATHER_B, "paired_ms": ms, "ms_a_pass": per_pass,
            "ns_a_row": {name: t * 1e6 / GATHER_B for name, t in per_pass.items()},
            "geometry": {"slices": g.slices, "per": g.per, "grid": g.grid}}


def _measure_0a4d045(libs: dict, device, rounds: int) -> dict:
    return {"roll": _roll(libs["sha256"], device, rounds),
            "gather": _gather(libs["scrypt"], device, rounds)}


def _report_0a4d045(result: dict) -> list:
    roll = result["roll"]
    lines = []
    for rows in ROLL_ROWS:
        ms = roll[rows]["paired_ms"]
        floor = (f"; serial floor ({roll['compressions']} compressions) {ms['serial floor']:.4f}"
                 if "serial floor" in ms else "")
        lines.append(f"R on {rows} rows: before {ms['before']:.4f}, after {ms['after']:.4f}: "
                     f"{ms['after'] / ms['before']:.3f}x{floor}")
    g = result["gather"]
    per = g["ms_a_pass"]
    lines.append(f"11 a pass ({g['lanes']} rows of {g['rows']}; slope {GATHER_REPS[0]} -> "
                 f"{GATHER_REPS[1]} passes): before {per['before']:.6f} ms, after "
                 f"{per['after']:.6f} ({g['geometry']}): {per['after'] / per['before']:.3f}x")
    return lines


# ---- fb7f061: P2 -------------------------------------------------------------------------

def _declare_fb7f061(libs: dict) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    tr = libs["probes"].tm_transpose_u32
    tr.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    tr.restype = i32


def _measure_fb7f061(libs: dict, device, rounds: int) -> dict:
    lib = libs["probes"]
    rng = np.random.default_rng(15)
    out = {}
    for name, ((rows, cols), carry) in P2_SHAPES.items():
        x = torch.tensor(rng.integers(-(1 << 31), 1 << 31, (rows, cols), dtype=np.int64),
                         dtype=torch.int32, device=device)
        c = (torch.tensor(rng.integers(-(1 << 31), 1 << 31, (cols, rows), dtype=np.int64),
                          dtype=torch.int32, device=device) if carry else None)

        def before(x=x, c=c):
            o = torch.empty((x.shape[1], x.shape[0]), dtype=x.dtype, device=device)
            _check(lib.tm_transpose_u32(x.data_ptr(), None if c is None else c.data_ptr(),
                                        o.data_ptr(), x.shape[0], x.shape[1], device.index,
                                        _stream(device)), "tm_transpose_u32 (before)")
            return o

        fns = {"before": before, "after": lambda x=x, c=c: KP.transpose(x, c)}
        plain = KP.transpose_plain(W.to_lanes(x), None if c is None else W.to_lanes(c))
        outs = {"plain": W.to_bits(plain)}
        outs.update({k: fn() for k, fn in fns.items()})
        _equal(outs, f"P2 on {name}")
        fns["torch"] = ((lambda x=x, c=c: torch.bitwise_xor(c, x.t())) if carry
                        else (lambda x=x: x.t().contiguous()))
        out[name] = {"shape": [rows, cols], "carry": carry,
                     "paired_ms": paired_ms(fns, device, rounds),
                     "bytes": (3 if carry else 2) * rows * cols * 4}
    return {"p2": out}


def _report_fb7f061(result: dict) -> list:
    lines = []
    for name, row in result["p2"].items():
        ms = row["paired_ms"]
        bound = row["bytes"] / MEM_BYTES_PER_S * 1e3
        lines.append(f"P2 on {name}: before {ms['before'] * 1e3:.3f} us ({bound / ms['before']:.1%} "
                     f"of its bytes bound), after {ms['after'] * 1e3:.3f} us "
                     f"({bound / ms['after']:.1%}): {ms['after'] / ms['before']:.3f}x; torch "
                     f"{ms['torch'] * 1e3:.3f} us")
    return lines


#: the comparisons, one for each old C interface, by the commit whose
#: sources it builds
COMPARISONS = {
    "30c4a81": Comparison(
        "K4 and S2", ("sha256", "scrypt"), _declare_30c4a81,
        {"sha256": (("search_candidates_hdr_kernel",), ("search_candidates_hdr_kernel",)),
         "scrypt": (("scrypt_back_kernel",), ("init_handle_kernel", "scrypt_back_kernel",
                                               "scrypt_fold_kernel"))},
        _measure_30c4a81, _report_30c4a81),
    "0a4d045": Comparison(
        "R and 11", ("sha256", "scrypt"), _declare_0a4d045,
        {"sha256": (("extranonce_roll_kernel", "serial_floor_kernel"),
                    ("extranonce_roll_kernel",)),
         "scrypt": (("row_gather_kernel",), ("row_gather_kernel",))},
        _measure_0a4d045, _report_0a4d045),
    "fb7f061": Comparison(
        "P2", ("probes",), _declare_fb7f061,
        {"probes": (("transpose_vec_kernel", "transpose_kernel"), ("transpose_kernel",))},
        _measure_fb7f061, _report_fb7f061),
}


def run(befores, rounds: int = ROUNDS, device="cuda") -> dict:
    """Each comparison of ``befores`` (commit → unpacked checkout of it),
    in the table's order: ``{commit: {"what", "result", "sass"}}``."""
    device = resolve(device)
    if device.type != "cuda":
        raise RuntimeError("the comparison times kernels on the card; the CPU has none")
    unknown = set(befores) - set(COMPARISONS)
    if unknown:
        raise ValueError(f"no comparison for {sorted(unknown)}; known: {sorted(COMPARISONS)}")
    infos = build.build()
    out = {"device": torch.cuda.get_device_name(device), "rounds": rounds}
    for commit, row in COMPARISONS.items():
        if commit not in befores:
            continue
        libs = load_before(befores[commit], commit)
        code = {name: {"before": _sass(libs[name].path, old),
                       "after": _sass(str(infos[name].path), new)}
                for name, (new, old) in row.kernels.items()}
        out[commit] = {"what": row.what, "result": row.measure(libs, device, rounds),
                       "sass": code}
    return out


def _before_arg(text: str) -> Tuple[str, Path]:
    commit, sep, path = text.partition("=")
    if not sep or commit not in COMPARISONS:
        raise argparse.ArgumentTypeError(
            f"expected COMMIT=DIR with COMMIT one of {', '.join(COMPARISONS)}")
    return commit, Path(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--before", type=_before_arg, action="append", required=True,
                    metavar="COMMIT=DIR",
                    help="an unpacked checkout of a commit of the table (repeat for each row)")
    ap.add_argument("--rounds", type=int, default=ROUNDS,
                    help=f"paired_ms's interleaved rounds (default {ROUNDS})")
    args = ap.parse_args(argv)
    result = run(dict(args.before), args.rounds)
    print(f"before / after on {result['device']}, ms a launch, median of {args.rounds} "
          "interleaved rounds")
    for commit, row in COMPARISONS.items():
        if commit not in result:
            continue
        print(f"-- against {commit}: {row.what}")
        for line in row.report(result[commit]["result"]):
            print(line)
        for name, both in result[commit]["sass"].items():
            print(f"SASS {name}: before {both['before']}, after {both['after']}")
    print(json.dumps({"before_after": result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
