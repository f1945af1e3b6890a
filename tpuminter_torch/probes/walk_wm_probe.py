"""Counterpart of ``scripts/walk_wm_probe.py`` (23): the row gather's
transposed view fed to xor + BlockMix on word planes.

The script's ``fused_xor_salsa`` (its ``pallas_call`` at :76) took
``vj.T.reshape(32, B/128, 128)`` of the row gather behind an
optimisation barrier, so that XLA would hand the gather's bytes over
without a layout copy. Here the transposed view is made contiguous by
torch (a copy of the rows, which the script hoped to avoid), and the
step is P3 with layout ``word``, body ``full``.

Stages: 1. four chained steps equal to the fused walk (19's kernel and
its plain version); 2. a ``N``-step walk, the fused walk's µs a step
beside this design's, eager and as one CUDA graph; 3. the script's HLO
grep for body-sized copies becomes ``torch.profiler``'s list of what one
step runs: its torch ops and (on the card) its device kernels, with
the gather's own body-sized copies counted and any other named.

Run: ``python -m tpuminter_torch.probes.walk_wm_probe [--device cpu
--b 256 --n 16]``.
"""

from __future__ import annotations

from collections import Counter

import torch

from tpuminter_torch.kernels import probes as K
from tpuminter_torch.probes._common import (
    B, CHECK_STEPS, N, Design, check_chain, cli, design_lines, make_walk, shipping_us,
    time_design, to_wm, transposed_rows, where)

DESIGN = Design("fused", "word", "full", transposed_rows)
#: the profiler's labels for the gather and P3 in stage 3 (on the CPU, P3's
#: plain version runs torch ops, its own copy among them)
GATHER, STEP = "gather", "P3"


def step_trace(walk) -> dict:
    """Stage 3: what one step runs, from ``torch.profiler``: its
    top-level torch ops (those the step calls, counted, in order of
    first call), its device kernels (on the card), and its copies of a
    body's size (``32·B`` words): those the gather makes (its transposed
    view made contiguous) apart from any other."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = walk.device.type == "cuda"
    xw = to_wm(walk, walk.x)
    DESIGN.step(walk, xw)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities, record_shapes=True) as prof:
        j = walk.j(xw)  # DESIGN.step, with the gather marked
        with record_function(GATHER):
            vj = DESIGN.gather(walk, j)
        with record_function(STEP):
            K.walk_step(xw, vj, DESIGN.layout, DESIGN.body)
        if cuda:
            torch.cuda.synchronize()
    events = prof.events()
    body = 32 * walk.b
    copies = {GATHER: [], STEP: [], "other": []}
    for e in events:
        if (e.name == "aten::copy_" and e.input_shapes and e.input_shapes[0]
                and _numel(e.input_shapes[0]) == body):
            copies[_under(e, (GATHER, STEP)) or "other"].append(f"{e.name} {e.input_shapes[0]}")
    labels = (GATHER, STEP)
    ops = Counter(e.name for e in events if e.device_type == DeviceType.CPU
                  and e.name.startswith("aten::")
                  and (e.cpu_parent is None or e.cpu_parent.name in labels))
    return {
        "ops": [f"{name} x{count}" if count > 1 else name for name, count in ops.items()],
        "kernels": [e.name for e in events
                    if e.device_type == DeviceType.CUDA and e.name not in labels],
        "gather_copies": copies[GATHER],
        "body_copies": copies["other"],
    }


def _under(event, names):
    """The first of ``names`` among the event's enclosing ranges, or None."""
    while event is not None:
        if event.name in names:
            return event.name
        event = event.cpu_parent
    return None


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def run(device="cuda", b: int = B, n: int = N, walk=None) -> dict:
    walk = walk if walk is not None else make_walk(device, b, n)
    check_chain(walk, DESIGN)
    ship = shipping_us(walk)
    fused = time_design(walk, DESIGN)
    trace = step_trace(walk)
    kernels = trace["kernels"] or ["(none traced: no device activity on this device)"]
    lines = [
        f"stage1 fused {CHECK_STEPS}-step chain: exact=True (romix_walk and romix_walk_plain)",
        f"stage2 walk, B = {walk.b}, {walk.n} steps, on {where(walk.device)}:",
        f"{'shipping (19)':15s} {ship:8.3f} us/step",
        *design_lines("fused", fused, ship),
        f"stage3 one step's torch ops: {', '.join(trace['ops'])}",
        f"stage3 one step's device kernels ({len(trace['kernels'])}):",
        *(f"   {k[:160]}" for k in kernels),
        f"stage3 body-sized copies in the gather (its transposed view made contiguous): "
        f"{len(trace['gather_copies'])}; besides P3 and the gather: "
        f"{len(trace['body_copies'])}" + "".join(f"\n   {c}" for c in trace["body_copies"]),
    ]
    return {"probe": "walk_wm_probe", "lines": lines, "sites": {"23": fused},
            "designs": {"fused": fused}, "shipping_us": ship, "trace": trace}


def main(argv=None) -> int:
    return cli(run, __doc__, argv)


if __name__ == "__main__":
    raise SystemExit(main())
