"""Counterpart of ``scripts/walk_native_tile_probe.py`` (17): xor +
BlockMix reading the gathered rows in the TPU gather's native tiles.

The script's ``fused_xor_salsa`` (its ``pallas_call`` at :78) read word
``w = 8g + s`` of lane ``b = rb·128 + l`` as ``vjg[g, rb, s, l]``, so
that the operand was the gather's own bytes. Here the operand is made
by torch ops, ``vj.T.reshape(4, 8, B/128, 128)`` with its middle axes
swapped and made contiguous, and the step is P3 with layout
``grouped``, body ``full``.

Stages: 1. four chained steps equal to the fused walk (19's kernel and
its plain version); 2. a ``N``-step walk, the fused walk's µs a step
beside this design's, eager and as one CUDA graph.

Run: ``python -m tpuminter_torch.probes.walk_native_tile_probe
[--device cpu --b 256 --n 16]``.
"""

from __future__ import annotations

from tpuminter_torch.probes._common import (
    B, CHECK_STEPS, N, Design, check_chain, cli, design_lines, grouped_rows, make_walk,
    shipping_us, time_design, where)

DESIGN = Design("fused", "grouped", "full", grouped_rows)


def run(device="cuda", b: int = B, n: int = N, walk=None) -> dict:
    walk = walk if walk is not None else make_walk(device, b, n)
    check_chain(walk, DESIGN)
    ship = shipping_us(walk)
    fused = time_design(walk, DESIGN)
    lines = [
        f"stage1 fused {CHECK_STEPS}-step chain: exact=True (romix_walk and romix_walk_plain)",
        f"stage2 walk, B = {walk.b}, {walk.n} steps, on {where(walk.device)}:",
        f"{'shipping (19)':15s} {ship:8.3f} us/step",
        *design_lines("fused", fused, ship),
    ]
    return {"probe": "walk_native_tile_probe", "lines": lines, "sites": {"17": fused},
            "designs": {"fused": fused}, "shipping_us": ship}


def main(argv=None) -> int:
    return cli(run, __doc__, argv)


if __name__ == "__main__":
    raise SystemExit(main())
