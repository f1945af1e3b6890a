"""Counterpart of ``scripts/walk_isolate_probe.py`` (16): which consumer
of the word-major gather's bytes costs the time.

The script timed four walk bodies on the same word-major operand (the
row gather, transposed): three in XLA, ``one_plane`` (xor plane 16
only), ``all_planes`` (xor all 32, no BlockMix) and ``plus_salsa`` (xor
+ BlockMix), and ``pallas_xs``, its ``fused_xor_salsa`` kernel (its
``pallas_call`` at :73). Here the three XLA bodies are torch ops on
int64 lanes (the plain versions' ops; their cost is their count of
torch calls, so they are timed over :data:`PLAIN_STEPS` steps) and
``pallas_xs`` is P3 with layout ``word``, body ``full``.

Stages: 1. ``pallas_xs``'s four chained steps equal to the fused walk
(19's kernel and its plain version), a check the script did not have;
2. each body's chain, µs a step, beside the fused walk's (``pallas_xs``
over ``N`` steps, eager and as one CUDA graph).

Run: ``python -m tpuminter_torch.probes.walk_isolate_probe [--device cpu
--b 256 --n 16]``.
"""

from __future__ import annotations

from tpuminter_torch.kernels import probes as K
from tpuminter_torch.probes._common import (
    B, CHECK_STEPS, N, Design, chain_us, check_chain, cli, design_lines, lanes, make_walk,
    shipping_us, time_design, to_wm, transposed_rows, where)

#: steps the torch-op bodies are timed over
PLAIN_STEPS = 16
DESIGN = Design("pallas_xs", "word", "full", transposed_rows)


def _operand(walk, carry):
    return lanes(transposed_rows(walk, walk.j(carry)))


def one_plane(walk, carry):
    out = carry.clone()
    out[16] ^= _operand(walk, carry)[16]
    return out


def all_planes(walk, carry):
    return carry ^ _operand(walk, carry)


def plus_salsa(walk, carry):
    return K.walk_step_plain(carry, _operand(walk, carry), "word", "full")


def run(device="cuda", b: int = B, n: int = N, walk=None) -> dict:
    walk = walk if walk is not None else make_walk(device, b, n)
    check_chain(walk, DESIGN)
    ship = shipping_us(walk)
    carry = lanes(to_wm(walk, walk.x))
    torch_ops = {fn.__name__: chain_us(lambda c, fn=fn: fn(walk, c), carry, PLAIN_STEPS,
                                       walk.device)
                 for fn in (one_plane, all_planes, plus_salsa)}
    fused = time_design(walk, DESIGN)
    lines = [
        f"stage1 pallas_xs {CHECK_STEPS}-step chain: exact=True (romix_walk and "
        "romix_walk_plain)",
        f"stage2, B = {walk.b}, on {where(walk.device)}:",
        f"{'shipping (19)':15s} {ship:8.3f} us/step ({walk.n} steps)",
        *(f"{name:15s} {us:8.1f} us/step (torch ops, {PLAIN_STEPS} steps)"
          for name, us in torch_ops.items()),
        *design_lines("pallas_xs", fused, ship),
    ]
    return {"probe": "walk_isolate_probe", "lines": lines, "sites": {"16": fused},
            "designs": {"pallas_xs": fused}, "torch_ops_us": torch_ops, "shipping_us": ship}


def main(argv=None) -> int:
    return cli(run, __doc__, argv)


if __name__ == "__main__":
    raise SystemExit(main())
