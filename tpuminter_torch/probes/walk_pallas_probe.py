"""Counterpart of ``scripts/walk_pallas_probe.py``: the walk as per-step
launches on word planes, against the fused walk.

The script's kernels were ``to_wm`` (18: ``(B, 32)`` → ``(32, B/128,
128)``, its ``pallas_call`` at :86) and ``fused_step`` (19, ported as
the fused walk ``kernels.scrypt.romix_walk``). Here ``to_wm`` is P2
(``kernels.probes.transpose``) and a step of the per-step walk is the
row gather (``index_select``) and P3 on row-major rows.

Stages: 1. four chained steps, each step's rows chosen by the last,
equal to the fused walk (19's kernel and its plain version); 2. a
``N``-step walk: the fused walk's µs a step beside the per-step walk's,
driven eagerly and as one CUDA graph.

Run: ``python -m tpuminter_torch.probes.walk_pallas_probe [--device cpu
--b 256 --n 16]``.
"""

from __future__ import annotations

from tpuminter_torch.kernels import probes as K
from tpuminter_torch.probes._common import (
    B, CHECK_STEPS, N, Design, check_chain, cli, design_lines, make_walk, measure, rows,
    shipping_us, time_design, where, words)

DESIGN = Design("fused", "row", "full", rows)


def run(device="cuda", b: int = B, n: int = N, walk=None) -> dict:
    walk = walk if walk is not None else make_walk(device, b, n)
    check_chain(walk, DESIGN)
    x = words(walk, walk.x)
    to_wm = measure(walk.device, lambda: K.transpose(x), lambda: K.transpose_plain(walk.x),
                    nbytes=2 * walk.x.numel() * 4, ops_count=0,
                    library=lambda: x.t().contiguous(), wrapper="transpose",
                    shape=tuple(x.shape))
    ship = shipping_us(walk)
    fused = time_design(walk, DESIGN)
    lines = [
        f"stage1 fused {CHECK_STEPS}-step chain: exact=True (romix_walk and romix_walk_plain)",
        f"to_wm (P2, {tuple(x.shape)} -> (32, {walk.b // 128}, 128)): "
        f"{to_wm['ms'] * 1e3:.3f} us",
        f"stage2 walk, B = {walk.b}, {walk.n} steps, on {where(walk.device)}:",
        f"{'shipping (19)':15s} {ship:8.3f} us/step",
        *design_lines("fused", fused, ship),
    ]
    return {"probe": "walk_pallas_probe", "lines": lines, "sites": {"18": to_wm},
            "designs": {"fused": fused}, "shipping_us": ship}


def main(argv=None) -> int:
    return cli(run, __doc__, argv)


if __name__ == "__main__":
    raise SystemExit(main())
