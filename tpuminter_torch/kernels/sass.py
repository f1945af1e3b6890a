"""What the compiler made of the built kernels: SASS opcode counts and
resources per kernel, read with ``cuobjdump`` from a library that
``kernels.build`` built.

Diagnostics only: ``chip_smoke.py`` prints them after the build, and
``probes.hlo_layout_check`` reports the probe kernels' loads, stores,
registers and local memory. Nothing on the miner's path imports this
module. Every function returns None where ``cuobjdump`` is missing.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess

__all__ = ["kernel_name", "sass_summary", "resource_usage"]

#: how each template parameter of a kernel reads, by its value: a bool's
#: name when true (nothing when false), an enum's name; an integer
#: parameter not listed here reads as its value
TEMPLATE_ARGS = {
    "search_candidates_hdr_batch_kernel": (("", "sched"),),
    "transpose_kernel": (("", "xor"),),
    "walk_step_kernel": (("row", "word", "grouped", "bitcast"),
                         ("null", "one_extract", "xor_only", "full")),
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


def _cuobjdump():
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return tool if os.path.exists(tool) else None


def sass_summary(so_path: str, modifiers: bool = False):
    """Per kernel of a built library (:func:`kernel_name`): its SASS
    opcode counts (from ``cuobjdump -sass``), with the opcodes'
    modifiers (``LDG.E.128``) when ``modifiers`` is true."""
    tool = _cuobjdump()
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = kernel_name(line.split("Function :")[1].strip())
            counts[name] = {}
        elif name and line.strip().startswith("/*") and "*/" in line:
            text = line.split("*/", 1)[1].strip()
            if text.startswith("@"):
                text = text.split(None, 1)[1] if " " in text else ""
            op = text.split(" ")[0].rstrip(";")
            op = op if modifiers else op.split(".")[0]
            if op:
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
