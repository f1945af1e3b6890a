"""P1 and P3 timed beside their versions before the redesign, in one run.

Not a counterpart of a script: it answers how much of P1's and P3's
move came from the kernels and how much from the probes' timing. It
builds ``csrc/probes.cu`` of another checkout (``--before DIR``, an
unpacked checkout of commit 0c1403f, whose C interface this module
knows: ``tm_xor_const(in, out, n, c, device, stream)`` choosing its own
grid, ``tm_walk_step(layout, body, xw, vj, out, batch, block, blocks,
device, stream)`` with ``blocks <= 0`` for one thread a lane) into
``build/before/`` with ``kernels.build``'s flags, and times on the same
operands, at the probes' B = 16384:

- P1 on 2 MiB (B·32 words, sites 9, 12 and 13) and 4 KiB (1024 words,
  site 10): before, this checkout's, ``torch.bitwise_xor``;
- every P3 instantiation at its one-pass grid, and the row layout's
  ``full`` on one block (``full_g1``): before, this checkout's, and
  ``probes._common.library_call`` where there is one.

Each output is first held equal to the others' and to the plain
version's. Each is then read two ways: ``time_ms`` once each, one after
the other (how the probes read a kernel before ``paired_ms``), and
``paired_ms`` over ``--rounds`` interleaved rounds in alternating order.

Run on the card::

    git archive 0c1403f | tar -x -C build/before_src
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

from tpuminter_torch.kernels import build
from tpuminter_torch.kernels import probes as K
from tpuminter_torch.kernels.sha256 import _stream
from tpuminter_torch.ops import walk_layouts as ops
from tpuminter_torch.probes._common import B, lanes, library_call, paired_ms, resolve, time_ms

__all__ = ["load_before", "run", "main"]

ROUNDS = 6


def load_before(checkout: Path) -> ctypes.CDLL:
    """``checkout``'s ``probes.cu`` built with ``kernels.build``'s flags
    and loaded, with the C interface of commit 0c1403f declared."""
    src = Path(checkout) / "tpuminter_torch" / "kernels" / "csrc" / "probes.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no probes.cu under {checkout}")
    out = build.BUILD_DIR.parent / "before" / "tm_probes_before.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    done = subprocess.run([build._nvcc(), *build.FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(out))
    ptr, u32, i32, i64 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int, ctypes.c_int64
    lib.tm_xor_const.argtypes = [ptr, ptr, i64, u32, i32, ptr]
    lib.tm_walk_step.argtypes = [i32, i32, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.tm_xor_const.restype = lib.tm_walk_step.restype = i32
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def _words(rng, shape, device) -> torch.Tensor:
    x = rng.integers(0, 1 << 32, shape, dtype=np.uint32).astype(np.int64)
    return ops.to_bits(torch.from_numpy(x).to(device))


def _read(fns: dict, want: torch.Tensor, device, rounds: int, what: str) -> dict:
    """Every callable's output held equal to ``want``, then µs a call in
    sequence and in :func:`paired_ms`'s rounds."""
    for name, fn in fns.items():
        if not torch.equal(lanes(fn()).reshape(want.shape), want):
            raise RuntimeError(f"{what}: {name} differs from the plain version")
    sequential = {name: time_ms(fn, device) * 1e3 for name, fn in fns.items()}
    paired = {name: ms * 1e3 for name, ms in paired_ms(fns, device, rounds).items()}
    return {"sequential_us": sequential, "paired_us": paired}


def run(before: Path, b: int = B, rounds: int = ROUNDS, device="cuda") -> dict:
    device = resolve(device)
    if device.type != "cuda":
        raise RuntimeError("the comparison times kernels on the card; the CPU has none")
    lib = load_before(before)
    stream = lambda: _stream(device)  # noqa: E731
    rng = np.random.default_rng(9)
    rows = {}
    for label, n in (("P1 2MiB", b * 32), ("P1 4KiB", 1024)):
        x = _words(rng, (n,), device)
        out = torch.empty_like(x)

        def p1_before(x=x, out=out):
            _check(lib.tm_xor_const(x.data_ptr(), out.data_ptr(), x.numel(), 1, device.index,
                                    stream()), "tm_xor_const (before)")
            return out

        rows[label] = _read({"before": p1_before, "after": lambda x=x: K.xor_const(x, 1),
                             "bitwise_xor": lambda x=x: torch.bitwise_xor(x, 1)},
                            K.xor_const_plain(lanes(x), 1), device, rounds, label)
    xw = _words(rng, (32, b // ops.LANES, ops.LANES), device)
    block = ops.bitcast_block(b)
    cases = [(layout, body, None) for layout, body in K.INSTANTIATIONS] + [("row", "full", 1)]
    for layout, body, blocks in cases:
        vj = _words(rng, ops.operand_shape(layout, b), device)
        out = torch.empty_like(xw)

        def p3_before(vj=vj, out=out, ids=(K._LAYOUT_ID[layout], K._BODY_ID[body]), g=blocks):
            _check(lib.tm_walk_step(*ids, xw.data_ptr(), vj.data_ptr(), out.data_ptr(), b,
                                    block, g or 0, device.index, stream()),
                   "tm_walk_step (before)")
            return out

        fns = {"before": p3_before, "after": lambda vj=vj, lb=(layout, body), g=blocks:
               K.walk_step(xw, vj, *lb, g)}
        library = library_call(xw, vj, layout, body)
        if library is not None and blocks is None:
            fns["library"] = library
        label = f"P3 {layout} x {body}" + ("" if blocks is None else f" on {blocks} block")
        rows[label] = _read(fns, K.walk_step_plain(lanes(xw), lanes(vj), layout, body), device,
                            rounds, label)
    return {"device": torch.cuda.get_device_name(device), "b": b, "rounds": rounds,
            "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--before", type=Path, required=True,
                    help="an unpacked checkout of commit 0c1403f")
    ap.add_argument("--b", type=int, default=B, help=f"lanes (default {B})")
    ap.add_argument("--rounds", type=int, default=ROUNDS,
                    help=f"paired_ms's interleaved rounds (default {ROUNDS})")
    args = ap.parse_args(argv)
    result = run(args.before, args.b, args.rounds)
    print(f"before / after on {result['device']}, µs a launch: in sequence | median of "
          f"{args.rounds} interleaved rounds")
    for label, row in result["rows"].items():
        seq, pair = row["sequential_us"], row["paired_us"]
        ref = "bitwise_xor" if "bitwise_xor" in pair else "library" if "library" in pair else None
        factor = f" (after / {ref} {pair['after'] / pair[ref]:.3f}x)" if ref else ""
        print(f"{label:26s} " + " ".join(f"{k} {v:.3f}" for k, v in seq.items()) + " | "
              + " ".join(f"{k} {v:.3f}" for k, v in pair.items()) + factor)
    print(json.dumps({"before_after": result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
