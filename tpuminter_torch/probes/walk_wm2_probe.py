"""Counterpart of ``scripts/walk_wm2_probe.py`` (22): a word-major
gather feeding xor + BlockMix on word planes.

The script's ``fused_xor_salsa`` (its ``pallas_call`` at :71) ran on
the output of an explicit word-major ``lax.gather`` (``output[w, b] =
V[idx[b], w]``). Here the gather is one torch op,
``vflat.t().index_select(1, idx)``, and the step is P3 on word planes
(``kernels.probes.walk_step``, layout ``word``, body ``full``).

Stages: 1. four chained steps equal to the fused walk (19's kernel and
its plain version); 2. a ``N``-step walk, the fused walk's µs a step
beside this design's, eager and as one CUDA graph.

Run: ``python -m tpuminter_torch.probes.walk_wm2_probe [--device cpu
--b 256 --n 16]``.
"""

from __future__ import annotations

from tpuminter_torch.probes._common import (
    B, CHECK_STEPS, N, Design, check_chain, cli, design_lines, make_walk, shipping_us,
    time_design, where, word_rows)

DESIGN = Design("fused", "word", "full", word_rows)


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
    return {"probe": "walk_wm2_probe", "lines": lines, "sites": {"22": fused},
            "designs": {"fused": fused}, "shipping_us": ship}


def main(argv=None) -> int:
    return cli(run, __doc__, argv)


if __name__ == "__main__":
    raise SystemExit(main())
