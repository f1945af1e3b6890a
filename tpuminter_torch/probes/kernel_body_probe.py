"""Counterpart of ``scripts/kernel_body_probe.py`` (8): four kernel
bodies on the native-tile operands of ``walk_native_tile_probe``.

The script's ``make_call`` (its ``pallas_call`` at :91) ran four bodies
in the same scan, each chaining its rows through its own output:
``null_kernel`` (``xw ^ 1``, the rows never read), ``one_extract``
(every word xored with the rows' word 0, the plane ``(g=0, s=0)``: wrong
scrypt on purpose), ``all_extracts`` (xor only) and ``extracts_salsa``
(xor + BlockMix, the walk step). Here each is P3 with layout
``grouped`` and body ``null``, ``one_extract``, ``xor_only`` and
``full``.

Stages: 1. ``extracts_salsa``'s four chained steps equal to the fused
walk (19's kernel and its plain version); 2. each body's ``N``-step
chain, eager and as one CUDA graph, beside the fused walk's µs a step.

Run: ``python -m tpuminter_torch.probes.kernel_body_probe [--device cpu
--b 256 --n 16]``.
"""

from __future__ import annotations

from tpuminter_torch.probes._common import (
    B, CHECK_STEPS, N, Design, check_chain, cli, design_lines, grouped_rows, make_walk,
    shipping_us, time_design, where)

DESIGNS = tuple(Design(name, "grouped", body, grouped_rows) for name, body in (
    ("null_kernel", "null"), ("one_extract", "one_extract"), ("all_extracts", "xor_only"),
    ("extracts_salsa", "full")))


def run(device="cuda", b: int = B, n: int = N, walk=None) -> dict:
    walk = walk if walk is not None else make_walk(device, b, n)
    check_chain(walk, DESIGNS[-1])
    ship = shipping_us(walk)
    timed = {d.name: time_design(walk, d) for d in DESIGNS}
    lines = [
        f"stage1 extracts_salsa {CHECK_STEPS}-step chain: exact=True (romix_walk and "
        "romix_walk_plain)",
        f"stage2, B = {walk.b}, {walk.n} steps, on {where(walk.device)}:",
        f"{'shipping (19)':15s} {ship:8.3f} us/step",
    ]
    for name, site in timed.items():
        lines += design_lines(name, site, ship)
    site = dict(timed["extracts_salsa"],
                variants={k: v for k, v in timed.items() if k != "extracts_salsa"})
    return {"probe": "kernel_body_probe", "lines": lines, "sites": {"8": site},
            "designs": timed, "shipping_us": ship}


def main(argv=None) -> int:
    return cli(run, __doc__, argv)


if __name__ == "__main__":
    raise SystemExit(main())
