"""Counterpart of ``scripts/walk_variants_probe.py`` (20, 21): which
stage of the fused walk step costs the time.

The script's ``wm_call`` (its ``pallas_call`` at :74) ran five bodies on
a word-plane carry and row-major rows, each chaining its rows through
its own output: ``tr_only`` (the rows' transpose alone), ``xor_only``
and ``salsa_only`` (the rows *bitcast* to word planes per block of
2048 lanes, wrong values on purpose: xor, or xor + BlockMix), ``full``
(transpose + xor + BlockMix, the walk step) and ``full_g1`` (the same
function in one grid step). ``tr_dense_call`` (21, :145) xored the rows,
as ``(B/4, 128)``, transposed into a ``(128, B/4)`` carry whose row 16,
tiled four times, picks the next rows: a junk but data-dependent chain,
kept as written.

Here ``tr_only`` and ``tr_dense`` are P2 (``kernels.probes.transpose``,
the latter with ``xor_into``); the others are P3 on layouts ``bitcast``
(``xor_only``, ``salsa_only``) and ``row`` (``full``, ``full_g1``).
``full_g1``'s one grid step becomes one thread block that walks every
lane (a grid of 1 in P3's grid-stride loop), where ``full`` launches one
thread a lane.

Stages: 1. ``full``'s and ``full_g1``'s four chained steps equal to the
fused walk (19's kernel and its plain version); 2. each variant's
``N``-step chain, eager and as one CUDA graph, beside the fused walk's
µs a step.

Run: ``python -m tpuminter_torch.probes.walk_variants_probe [--device cpu
--b 256 --n 16]``.
"""

from __future__ import annotations

import torch

from tpuminter_torch.kernels import probes as K
from tpuminter_torch.probes._common import (
    B, CHECK_STEPS, LANES, N, Design, chain_us, check_chain, cli, design_lines,
    graph_chain_us, lanes, make_walk, measure, rows, shipping_us, time_design, to_wm, where,
    words)

DESIGNS = (
    Design("xor_only", "bitcast", "xor_only", rows),
    Design("salsa_only", "bitcast", "full", rows),
    Design("full", "row", "full", rows),
    Design("full_g1", "row", "full", rows, blocks=1),
)


def tr_only_step(walk, xw):
    """``tr_only``: the next rows' transpose is the new carry (P2)."""
    return K.transpose(rows(walk, walk.j(xw))).view(32, walk.b // LANES, LANES)


def tr_dense_start(walk):
    """21's carry: X's bytes as ``(B/4, 128)``, transposed to ``(128,
    B/4)``."""
    return K.transpose(words(walk, walk.x).view(walk.b // 4, LANES))


def tr_dense_rows(walk, carry):
    """21's next rows as ``(B/4, 128)``: row 16 of the carry mod N, tiled
    four times (``jnp.concatenate([j, j, j, j])[:B]``)."""
    j = carry[16].to(torch.int64) & (walk.n - 1)
    return rows(walk, j.repeat(4)[:walk.b]).view(walk.b // 4, LANES)


def tr_dense_step(walk, carry):
    """21: ``carry ^ rows.T`` (P2 with ``xor_into``)."""
    return K.transpose(tr_dense_rows(walk, carry), xor_into=carry)


def _chain_site(walk, step, start, site):
    site["chain_us"] = chain_us(lambda c: step(walk, c), start, walk.n, walk.device)
    site["graph_us"] = (graph_chain_us(lambda c: step(walk, c), start, walk.n)
                        if walk.device.type == "cuda" else None)
    return site


def run(device="cuda", b: int = B, n: int = N, walk=None) -> dict:
    walk = walk if walk is not None else make_walk(device, b, n)
    for design in DESIGNS[2:]:
        check_chain(walk, design)
    ship = shipping_us(walk)
    timed = {d.name: time_design(walk, d) for d in DESIGNS}
    xw = to_wm(walk, walk.x)
    vj = rows(walk, walk.j(xw))
    timed["tr_only"] = _chain_site(walk, tr_only_step, xw, measure(
        walk.device, lambda: K.transpose(vj), lambda: K.transpose_plain(lanes(vj)),
        nbytes=2 * vj.numel() * 4, ops_count=0, library=lambda: vj.t().contiguous(),
        wrapper="transpose",
        gather_ms=None))
    carry = tr_dense_start(walk)
    dense = tr_dense_rows(walk, carry)
    tr_dense = _chain_site(walk, tr_dense_step, carry, measure(
        walk.device, lambda: K.transpose(dense, xor_into=carry),
        lambda: K.transpose_plain(lanes(dense), lanes(carry)), nbytes=3 * dense.numel() * 4,
        ops_count=dense.numel(), library=lambda: torch.bitwise_xor(carry, dense.t()),
        wrapper="transpose", gather_ms=None))
    lines = [
        f"stage1 full and full_g1 {CHECK_STEPS}-step chains: exact=True (romix_walk and "
        "romix_walk_plain)",
        f"stage2, B = {walk.b}, {walk.n} steps, on {where(walk.device)}:",
        f"{'shipping (19)':15s} {ship:8.3f} us/step",
    ]
    for name in ("tr_only", "xor_only", "salsa_only", "full", "full_g1"):
        site = timed[name]
        if name == "tr_only":
            graph = (f", graph {site['graph_us']:8.3f} us/step"
                     if site["graph_us"] is not None else "")
            lines.append(f"{name:15s} {site['chain_us']:8.3f} us/step{graph}; P2 "
                         f"{site['ms'] * 1e3:.3f} us")
        else:
            lines += design_lines(name, site, ship)
    graph = (f", graph {tr_dense['graph_us']:8.3f} us/step"
             if tr_dense["graph_us"] is not None else "")
    lines.append(f"{'tr_dense':15s} {tr_dense['chain_us']:8.3f} us/step{graph}; P2 "
                 f"{tr_dense['ms'] * 1e3:.3f} us")
    site = dict(timed["full"], variants={k: v for k, v in timed.items() if k != "full"})
    return {"probe": "walk_variants_probe", "lines": lines,
            "sites": {"20": site, "21": tr_dense}, "designs": timed, "shipping_us": ship}


def main(argv=None) -> int:
    return cli(run, __doc__, argv)


if __name__ == "__main__":
    raise SystemExit(main())
