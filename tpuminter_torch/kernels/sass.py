"""What the compiler made of the built kernels: SASS opcode counts and
resources per kernel, read with ``cuobjdump`` from a library that
``kernels.build`` built.

Diagnostics only: ``chip_smoke.py`` prints them after the build, with
each kernel's instructions by issue pipe (:func:`pipe_mix`: Hopper's ALU
pipe and its FMA pipe, which runs every ``IMAD``), and
``probes.hlo_layout_check`` reports the probe kernels' loads, stores,
registers and local memory. Nothing on the miner's path imports this
module. Every function returns None where ``cuobjdump`` is missing.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess

__all__ = ["kernel_name", "sass_summary", "sass_text", "resource_usage", "pipe_of", "pipe_mix",
           "parse_sass", "PIPES"]

#: how each template parameter of a kernel reads, by its value: a bool's
#: name when true (nothing when false), an enum's name; an integer
#: parameter not listed here reads as its value
TEMPLATE_ARGS = {
    "search_candidates_hdr_batch_kernel": (("", "sched"),),
    "transpose_kernel": (("", "xor"),),
    "transpose_vec_kernel": (("", "xor"),),
    "walk_step_kernel": (("row", "word", "grouped", "bitcast"),
                         ("null", "one_extract", "xor_only", "full")),
    "walk_lane_kernel": (("row", "word", "grouped", "bitcast"),),
    "xor_const_kernel": (("scalar", "vec"),),
}


def kernel_name(mangled: str) -> str:
    """A kernel's name from its mangled symbol, without its anonymous
    namespace and with its template arguments (:data:`TEMPLATE_ARGS`):
    ``_ZN41_GLOBAL__N__..._probes_cu_...16walk_step_kernelILi2ELi3EEEv...``
    → ``walk_step_kernel<grouped,full>``; ``..._kernelILb1EEEv...`` of K5
    → ``search_candidates_hdr_batch_kernel<sched>``."""
    pos = 3 if mangled.startswith("_ZN") else 2 if mangled.startswith("_Z") else -1
    name = ""
    while pos >= 0:
        m = re.match(r"\d+", mangled[pos:])
        if not m:
            break
        start = pos + m.end()
        name, pos = mangled[start:start + int(m.group())], start + int(m.group())
        if not name.startswith("_GLOBAL__N"):
            break
    if not name or name.startswith("_GLOBAL__N"):
        return mangled
    args = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[pos:])
    if not args:
        return name
    names = TEMPLATE_ARGS.get(name, ())
    shown = []
    for k, value in enumerate(int(v) for v in re.findall(r"L[a-z](\d+)E", args.group(1))):
        text = names[k][value] if k < len(names) and value < len(names[k]) else str(value)
        if text:
            shown.append(text)
    return name + (f"<{','.join(shown)}>" if shown else "")


#: the issue pipes an instruction is counted on (``pipe_of``)
PIPES = ("alu", "fma", "other")
#: opcodes (without modifiers) the FMA pipe executes: IMAD in every form
#: (IMAD.IADD, IMAD.MOV, IMAD.SHL, IMAD.WIDE, IMAD.HI, ...) and the
#: float multiply-adds
_FMA = {"IMAD", "IMUL", "FFMA", "FMUL", "FADD", "HFMA2", "HMUL2", "HADD2"}
#: opcodes the ALU (INT32) pipe executes: adds, logic, shifts, byte
#: permutes, compares, selects, moves
_ALU = {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "PRMT", "ISETP", "SEL",
        "LEA", "IABS", "IMNMX", "MOV", "FSEL", "FSETP", "PLOP3", "BMSK", "SGXT",
        "P2R", "R2P", "ISCADD", "VIADD", "FMNMX"}


def pipe_of(opcode: str) -> str:
    """The pipe an opcode issues to on Hopper (``alu``, ``fma`` or
    ``other``), by its name without modifiers: every ``IMAD*`` goes to
    the FMA pipe; uniform-datapath (``U*``), memory, shuffle, branch and
    special-function instructions are ``other``."""
    op = opcode.split(".")[0]
    return "fma" if op in _FMA else "alu" if op in _ALU else "other"


def parse_sass(sass: str) -> dict:
    """``cuobjdump -sass`` text → per kernel (:func:`kernel_name`) its
    instructions in order, as ``(address, opcode with modifiers, branch
    target address or None)``; a guard predicate (``@P0``) is dropped."""
    kernels, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = kernel_name(line.split("Function :")[1].strip())
            kernels[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if not name or not m:
            continue
        text = m.group(2).strip()
        if text.startswith("@"):
            text = text.split(None, 1)[1] if " " in text else ""
        op = text.split(" ")[0]
        if not op:
            continue
        target = re.search(r"\b(?:BRA|BRX|JMP)\b.*?(0x[0-9a-f]+)", text)
        kernels[name].append((int(m.group(1), 16), op,
                              int(target.group(1), 16) if target else None))
    return kernels


def pipe_mix(sass: str) -> dict:
    """Per kernel of a ``cuobjdump -sass`` text: its static instruction
    count on each pipe (:func:`pipe_of`) over the whole kernel
    (``"total"``) and over its hot loop (``"loop"``: the span of the
    backward branch that encloses the most instructions, every branch
    inside it included; None for a kernel without a loop). A SHA
    kernel's loop runs one nonce a trip, scrypt's fill and walk one step
    a trip; the counts are static, not executed."""
    out = {}
    for name, insts in parse_sass(sass).items():
        def mix(sel):
            counts = dict.fromkeys(PIPES, 0)
            for addr, op, _ in insts:
                if sel(addr):
                    counts[pipe_of(op)] += 1
            return counts

        # a branch back to an earlier address closes a loop; the branch to
        # itself that ends every kernel does not
        loops = [(target, addr) for addr, _, target in insts
                 if target is not None and target < addr]
        best = max(loops, key=lambda lo_hi: sum(lo_hi[0] <= a <= lo_hi[1] for a, _, _ in insts),
                   default=None)
        out[name] = {"total": mix(lambda a: True),
                     "loop": None if best is None else mix(lambda a: best[0] <= a <= best[1])}
    return out


def sass_text(so_path: str):
    """``cuobjdump -sass`` of a built library, or None without the tool."""
    tool = _cuobjdump()
    if tool is None:
        return None
    return subprocess.run([tool, "-sass", so_path], capture_output=True, text=True,
                          check=True).stdout


def _cuobjdump():
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return tool if os.path.exists(tool) else None


def sass_summary(so_path: str, modifiers: bool = False):
    """Per kernel of a built library (:func:`kernel_name`): its SASS
    opcode counts (from ``cuobjdump -sass``), with the opcodes'
    modifiers (``LDG.E.128``) when ``modifiers`` is true."""
    sass = sass_text(so_path)
    if sass is None:
        return None
    counts = {}
    for name, insts in parse_sass(sass).items():
        counts[name] = {}
        for _, op, _ in insts:
            op = op if modifiers else op.split(".")[0]
            counts[name][op] = counts[name].get(op, 0) + 1
    return counts


def resource_usage(so_path: str):
    """Per kernel of a built library: ``cuobjdump -res-usage``'s fields
    (``REG``, ``STACK``, ``SHARED``, ``LOCAL``, ...)."""
    tool = _cuobjdump()
    if tool is None:
        return None
    text = subprocess.run([tool, "-res-usage", so_path], capture_output=True, text=True,
                          check=True).stdout
    usage, name = {}, None
    for line in text.splitlines():
        if line.strip().startswith("Function "):
            name = kernel_name(line.strip()[len("Function "):].rstrip(":").strip())
        elif name and "REG:" in line:
            usage[name] = {k: int(v) for k, v in re.findall(r"([A-Z]+(?:\[\d+\])?):(\d+)", line)}
            name = None
    return usage


def main(argv=None) -> int:
    """``python -m tpuminter_torch.kernels.sass LIB.so ...``: each
    kernel's static instructions by issue pipe (:func:`pipe_mix`), over
    the whole kernel and over its hot loop."""
    import argparse

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("libraries", nargs="+", help="shared libraries built by kernels.build")
    args = parser.parse_args(argv)
    for path in args.libraries:
        sass = sass_text(path)
        if sass is None:
            parser.error("cuobjdump not found")
        for name, mix in pipe_mix(sass).items():
            print(f"{os.path.basename(path)} {name}: total {mix['total']}, loop {mix['loop']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
