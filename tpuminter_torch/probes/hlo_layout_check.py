"""Counterpart of ``scripts/hlo_layout_check.py`` (24): are there layout
copies around the walk-step kernel?

The script compiled a scan over its ``call`` (``k_tr_only``, its
``pallas_call`` at :37: the rows' transpose into word planes) and listed
the copies XLA put around the custom call. It had no run-time function
of its own. Here ``tr_only`` is P2 (``kernels.probes.transpose``), run
once on one step's gathered rows for its row of the table, and the
card's answer to "what surrounds the kernel" is what was compiled: for
P2 and every instantiation of P3, the global load and store widths,
local memory and registers, from ``cuobjdump`` of the built library
(``walk_wm_probe``'s stage 3 lists what one step launches).

Run: ``python -m tpuminter_torch.probes.hlo_layout_check [--device cpu
--b 256 --n 16]``.
"""

from __future__ import annotations

from tpuminter_torch.kernels import build, sass
from tpuminter_torch.kernels import probes as K
from tpuminter_torch.probes._common import (
    B, N, cli, lanes, make_walk, measure, rows, to_wm, where)

#: the opcodes that move memory: global, local and shared loads and stores
MEMORY_OPS = ("LDG", "STG", "LDL", "STL", "LDS", "STS")


def layout_report() -> list:
    """Per kernel of ``probes.cu``: its memory opcodes (with their
    widths) and its resources, from ``cuobjdump``; an empty list where
    there is none."""
    path = str(build.build()["probes"].path)
    opcodes = sass.sass_summary(path, modifiers=True) or {}
    usage = sass.resource_usage(path) or {}
    lines = []
    for name in sorted(set(opcodes) | set(usage)):
        mem = {op: c for op, c in opcodes.get(name, {}).items()
               if op.split(".")[0] in MEMORY_OPS}
        res = usage.get(name, {})
        lines.append(f"  {name}: registers {res.get('REG', '?')}, local {res.get('LOCAL', '?')} "
                     f"B, stack {res.get('STACK', '?')} B, shared {res.get('SHARED', '?')} B; "
                     + (", ".join(f"{op} x{c}" for op, c in sorted(mem.items())) or "no loads"))
    return lines


def run(device="cuda", b: int = B, n: int = N, walk=None) -> dict:
    walk = walk if walk is not None else make_walk(device, b, n)
    vj = rows(walk, walk.j(to_wm(walk, walk.x)))
    site = measure(walk.device, lambda: K.transpose(vj), lambda: K.transpose_plain(lanes(vj)),
                   nbytes=2 * vj.numel() * 4, ops_count=0, library=lambda: vj.t().contiguous(),
                   wrapper="transpose")
    lines = [f"tr_only (P2, {tuple(vj.shape)} -> (32, {walk.b // 128}, 128)) on "
             f"{where(walk.device)}: equal to its plain version, {site['ms'] * 1e3:.3f} us"]
    if walk.device.type == "cuda":
        report = layout_report()
        lines += (["what was compiled (cuobjdump):", *report] if report
                  else ["cuobjdump not found: no SASS report"])
    else:
        lines.append("no SASS on the CPU: the plain versions ran")
    return {"probe": "hlo_layout_check", "lines": lines, "sites": {"24": site}}


def main(argv=None) -> int:
    return cli(run, __doc__, argv)


if __name__ == "__main__":
    raise SystemExit(main())
