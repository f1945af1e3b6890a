"""Counterpart of ``scripts/pallas_launch_overhead_probe.py`` (9, 10):
is a kernel's cost per launch, per grid step, or per byte?

The script timed, as slopes between 512 and 2048 chained calls inside
one ``lax.scan``: ``xla_xor`` (``c ^ 1`` in XLA, the control),
``grid8`` and ``grid1`` (``copy_grid``, its ``pallas_call`` at :78: ``x
^ 1`` on ``(B/4, 128)``, 2 MiB, in 8 grid steps or 1) and ``tiny``
(``tiny_step``, :94: the same on ``(8, 128)``, 4 KiB). On the card a
grid step has no counterpart (blocks run in parallel, in no order), so
``grid8`` is eight launches of P1 (``kernels.probes.xor_const``) on 256
KiB each and ``grid1`` one launch on the whole 2 MiB; ``xla_xor`` is
``torch.bitwise_xor(c, 1)``. Each is timed beside the torch calls that
compute the same in the same launches: one ``bitwise_xor`` for ``grid1``
and ``tiny``, eight on the same slices for ``grid8``. (A TPU grid step runs after the one before
it, as a launch does after the launch before it on a stream; eight
thread blocks of one launch would run at once, so they would not ask
the script's question.)

Each slope is taken twice: with the launches issued from Python onto a
stream (the host's issue and the launch are in it), and inside one
captured CUDA graph (the closer counterpart of the compiled scan: the
device's cost a launch alone).

Run: ``python -m tpuminter_torch.probes.pallas_launch_overhead_probe
[--device cpu --b 256]``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuminter_torch.kernels import probes as K
from tpuminter_torch.ops.walk_layouts import to_bits
from tpuminter_torch.probes._common import (
    B, LANES, N, cli, lanes, measure, once_ms, resolve, where)

#: the chained calls of the slope's two runs
REPS_LO, REPS_HI = 512, 2048


def grid8(c):
    """``x ^ 1`` as eight launches, one a slice of 1/8 of the words."""
    out = torch.empty_like(c)
    for part, into in zip(c.view(8, -1), out.view(8, -1)):
        K.xor_const(part, 1, out=into)
    return out


def grid8_library(c):
    """``grid8``'s counterpart in torch: the same eight slices, each one
    ``torch.bitwise_xor(part, 1, out=into)``."""
    out = torch.empty_like(c)
    for part, into in zip(c.view(8, -1), out.view(8, -1)):
        torch.bitwise_xor(part, 1, out=into)
    return out


CASES = {
    "xla_xor": lambda c: torch.bitwise_xor(c, 1),
    "grid8": grid8,
    "grid1": lambda c: K.xor_const(c, 1),
    "tiny": lambda c: K.xor_const(c, 1),
}


def _chain(step, x, reps):
    for _ in range(reps):
        x = step(x)
    return x


def slope_us(step, x, device) -> tuple:
    """µs a call between ``REPS_LO`` and ``REPS_HI`` chained calls: on a
    stream, and (on the card) replayed as one CUDA graph per count."""
    step(x)
    stream = {reps: once_ms(lambda: _chain(step, x, reps), device)[0]
              for reps in (REPS_LO, REPS_HI)}
    per = 1e3 / (REPS_HI - REPS_LO)
    if device.type != "cuda":
        return (stream[REPS_HI] - stream[REPS_LO]) * per, None, stream, None
    graphs, totals = {}, {}
    for reps in (REPS_LO, REPS_HI):
        graphs[reps] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[reps]):
            _chain(step, x, reps)
        graphs[reps].replay()
        totals[reps] = once_ms(graphs[reps].replay, device)[0]
    del graphs
    torch.cuda.empty_cache()
    return ((stream[REPS_HI] - stream[REPS_LO]) * per, (totals[REPS_HI] - totals[REPS_LO]) * per,
            stream, totals)


def run(device="cuda", b: int = B, n: int = N, walk=None) -> dict:
    device = resolve(device) if walk is None else walk.device
    if b % (4 * 8):
        raise ValueError("b must be a multiple of 32")
    rng = np.random.default_rng(0)
    big = torch.from_numpy(rng.integers(0, 2**32, (b // 4, LANES), dtype=np.uint32)
                           .astype(np.int64)).to(device)
    small = torch.from_numpy(rng.integers(0, 2**32, (8, LANES), dtype=np.uint32)
                             .astype(np.int64)).to(device)
    if device.type == "cuda":
        big, small = to_bits(big), to_bits(small)
    lines = [f"slopes {REPS_LO} -> {REPS_HI} chained calls, on {where(device)}:"]
    cases = {}
    for name, step in CASES.items():
        x = small if name == "tiny" else big
        stream_us, graph_us, stream, graph = slope_us(step, x, device)
        cases[name] = dict(stream_us=stream_us, graph_us=graph_us, stream_ms=stream,
                           graph_ms=graph)
        graph_text = (f"; graph {graph_us:8.3f} us/call (totals {graph[REPS_LO]:.1f} / "
                      f"{graph[REPS_HI]:.1f} ms)" if graph_us is not None else "")
        lines.append(f"{name:16s} {stream_us:8.3f} us/call (totals {stream[REPS_LO]:.1f} / "
                     f"{stream[REPS_HI]:.1f} ms){graph_text}")
    sites = {}
    for site, name, x in (("9", "grid1", big), ("10", "tiny", small)):
        step = CASES[name]
        sites[site] = measure(device, lambda: step(x), lambda: K.xor_const_plain(lanes(x), 1),
                              nbytes=2 * x.numel() * 4, ops_count=x.numel(),
                              library=lambda: torch.bitwise_xor(x, 1), wrapper="xor_const",
                              slopes=cases[name])
    sites["9"]["variants"] = {"grid8": dict(measure(
        device, lambda: grid8(big), lambda: K.xor_const_plain(lanes(big), 1),
        nbytes=2 * big.numel() * 4, ops_count=big.numel(),
        library=lambda: grid8_library(big), wrapper="xor_const"),
        slopes=cases["grid8"])}
    return {"probe": "pallas_launch_overhead_probe", "lines": lines, "sites": sites,
            "cases": cases}


def main(argv=None) -> int:
    return cli(run, __doc__, argv)


if __name__ == "__main__":
    raise SystemExit(main())
