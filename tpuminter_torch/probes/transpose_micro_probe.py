"""Counterpart of ``scripts/transpose_micro_probe.py`` (12-15): the cost
of a ``(B, 32)`` u32 copy and transpose, padded and dense.

The script's four kernels (their ``pallas_call``s at :84, :99, :119 and
:140), each chained ``REPS`` times through its carry: ``copy_padded``
(``x ^ 1`` on ``(B, 32)``), ``copy_dense`` (the same bytes as ``(B/4,
128)``), ``transpose_pad`` (``(B, 32)`` → ``(32, B/128, 128)``) and
``transpose_dense`` (``(B/4, 128)`` → ``(128, B/4)``), each output read
back as ``(B, 32)`` for the next call. On the card the padded and
dense shapes are the same bytes: P1 (``kernels.probes.xor_const``) for
the copies, P2 (``kernels.probes.transpose``) for the transposes.

Each prints its µs a call over the chain (eager and, on the card, as
one CUDA graph) and its rate, ``2·B·32·4`` bytes over that time, beside
the kernel's own time and the single torch call that computes the same
(``torch.bitwise_xor``, ``x.t().contiguous()``).

Run: ``python -m tpuminter_torch.probes.transpose_micro_probe [--device
cpu --b 256]``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuminter_torch.kernels import probes as K
from tpuminter_torch.ops.walk_layouts import to_bits
from tpuminter_torch.probes._common import (
    B, N, resolve, chain_us, cli, graph_chain_us, lanes, measure, where)

#: calls a chain makes (the script's REPS)
REPS = 64


def variants(b: int):
    """name → (the kernel's step on a ``(b, 32)`` carry, its plain
    version, the torch call computing the same)."""
    def dense(x):
        return x.view(b // 4, 128)

    return {
        "copy_padded": (lambda x: K.xor_const(x, 1), lambda x: K.xor_const_plain(x, 1),
                        lambda x: torch.bitwise_xor(x, 1)),
        "copy_dense": (lambda x: K.xor_const(dense(x), 1).view(b, 32),
                       lambda x: K.xor_const_plain(dense(x), 1).view(b, 32),
                       lambda x: torch.bitwise_xor(dense(x), 1)),
        "transpose_pad": (lambda x: K.transpose(x).view(b, 32),
                          lambda x: K.transpose_plain(x).view(b, 32),
                          lambda x: x.t().contiguous()),
        "transpose_dense": (lambda x: K.transpose(dense(x)).view(b, 32),
                            lambda x: K.transpose_plain(dense(x)).view(b, 32),
                            lambda x: dense(x).t().contiguous()),
    }


#: the site of each variant in PERF.md's table
SITES = {"copy_padded": "12", "copy_dense": "13", "transpose_pad": "14", "transpose_dense": "15"}


def run(device="cuda", b: int = B, n: int = N, walk=None) -> dict:
    device = resolve(device) if walk is None else walk.device
    if b % 128:
        raise ValueError("b must be a multiple of 128")
    x64 = np.random.default_rng(0).integers(0, 2**32, (b, 32), dtype=np.uint32).astype(np.int64)
    xl = torch.from_numpy(x64).to(device)
    x = xl if device.type == "cpu" else to_bits(xl)
    nbytes = 2 * b * 32 * 4
    sites, lines = {}, [f"B = {b}, {REPS} chained calls, on {where(device)}:"]
    for name, (kernel, plain, library) in variants(b).items():
        site = measure(device, lambda: kernel(x), lambda: plain(lanes(x)), nbytes=nbytes,
                       ops_count=b * 32 if name.startswith("copy") else 0,
                       library=lambda: library(x),
                       wrapper="xor_const" if name.startswith("copy") else "transpose")
        site["chain_us"] = chain_us(kernel, x, REPS, device)
        site["graph_us"] = graph_chain_us(kernel, x, REPS) if device.type == "cuda" else None
        sites[SITES[name]] = site
        graph = (f", graph {site['graph_us']:8.3f} us/call "
                 f"({nbytes / site['graph_us'] / 1e3:6.1f} GB/s)" if site["graph_us"] else "")
        lines.append(f"{name:16s} {site['chain_us']:9.3f} us/call "
                     f"({nbytes / site['chain_us'] / 1e3:6.1f} GB/s r+w){graph}; kernel "
                     f"{site['ms'] * 1e3:.3f} us, torch {site['library_ms'] * 1e3:.3f} us")
    return {"probe": "transpose_micro_probe", "lines": lines, "sites": sites}


def main(argv=None) -> int:
    return cli(run, __doc__, argv)


if __name__ == "__main__":
    raise SystemExit(main())
