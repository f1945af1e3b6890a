"""What every layout probe shares: the V and X, the gathers, the
per-step walk chain and its check, the clocks, the argument parser.

The TPU rounds' probes (``scripts/*_probe.py``) each rebuilt these
inline; here they are one copy. A probe's V is the scripts' ``make_v``
(a murmur-style mix of the row and word index), made on the device; its
X is ``default_rng(0)``'s ``(B, 32)`` u32 words, as the scripts draw it.
Row ``j`` of lane ``b`` is ``v[j·B + b]`` of the flat ``(N·B, 32)`` V,
which is ``(N, B, 32)``: the layout of ``kernels.scrypt.romix_walk``,
the fused walk (19) every per-step design is held against.

Times on the card come from CUDA events: :func:`time_ms` runs its
launches back to back behind a held stream (the device time of a
launch, not the host's issue), :func:`chain_us` drives a chain of steps
eagerly from Python, :func:`graph_chain_us` replays it as one captured
CUDA graph (the counterpart of the scripts' ``lax.scan``, which issues
no launch from the host). On the CPU every time is the host's clock
over the plain versions and is labelled so; it is no device time.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from tpuminter_torch.kernels import probes as K
from tpuminter_torch.kernels import scrypt as KS
from tpuminter_torch.kernels.sha256 import _cuda_device
from tpuminter_torch.ops import walk_layouts as ops

__all__ = [
    "B", "N", "LANES", "M32", "BODY_OPS", "Walk", "Design", "make_walk", "probe_v", "to_wm",
    "from_wm", "rows", "word_rows", "transposed_rows", "grouped_rows", "check_chain",
    "time_ms", "once_ms", "chain_us", "graph_chain_us", "measure", "shipping_us",
    "time_design", "design_lines", "parser", "cli", "where", "words", "lanes", "step_measure",
    "CHECK_STEPS", "resolve", "library_call", "paired_ms", "ROUNDS", "MEM_BYTES_PER_S",
]

#: the scripts' constants: lanes, ROMix's N, lanes of a word plane's row
B, N, LANES = 16384, 1024, ops.LANES
M32 = 0xFFFFFFFF
#: H100 SXM device memory rate (NVIDIA data sheet), for bytes bounds
MEM_BYTES_PER_S = 3.35e12
#: the steps of stage 1's data-dependent chain
CHECK_STEPS = 4
#: back-to-back launches a device time averages over
REPS = 50
#: interleaved rounds of :func:`paired_ms` on the card (its median is kept)
ROUNDS = 3
#: clock cycles the stream is held while the host queues them (~5 ms)
HOLD_CYCLES = 10_000_000
#: integer operations a lane of each walk-step body needs: BlockMix
#: (2 × Salsa20/8 of 128 × (add, funnel shift, xor) + 16 adds, and 32
#: xors) and the 32 xors of V's row; the other bodies' 32 xors
BODY_OPS = {"full": 2 * (128 * 3 + 16) + 32 + 32, "xor_only": 32, "one_extract": 32,
            "null": 32, "tr_only": 0}


def probe_v(rows: int, device, chunk: int = 1 << 20) -> torch.Tensor:
    """The probes' V, ``(rows, 32)``, made on ``device``: row i word j is
    a murmur-style mix of ``i · 2654435761 + j · 0x9E3779B9``
    (``make_v`` of ``scripts/walk_pallas_probe.py``); int32 bit patterns
    on the card, int64 lanes on the CPU."""
    device = torch.device(device)
    v = torch.empty((rows, 32), dtype=K.word_dtype(device), device=device)
    j = torch.arange(32, dtype=torch.int64, device=device)[None]
    for r0 in range(0, rows, chunk):
        i = torch.arange(r0, min(rows, r0 + chunk), dtype=torch.int64, device=device)[:, None]
        h = (i * 2654435761 + j * 0x9E3779B9) & M32
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & M32
        h ^= h >> 13
        v[r0:r0 + chunk] = ops.to_bits(h) if device.type == "cuda" else h
    return v


@dataclass
class Walk:
    """One probe set-up at ``b`` lanes and ``N = n``: the flat V, X as
    int64 lanes, the lane indices, and the fused walk's answers."""

    device: torch.device
    b: int
    n: int
    v: torch.Tensor
    x: torch.Tensor
    lane: torch.Tensor
    _reference: dict = field(default_factory=dict)

    @property
    def n_log2(self) -> int:
        return self.n.bit_length() - 1

    @property
    def v3(self) -> torch.Tensor:
        """V as ``(N, B, 32)``, the fused walk's layout."""
        return self.v.view(self.n, self.b, 32)

    def j(self, xw: torch.Tensor) -> torch.Tensor:
        """The next step's rows, ``X[16] mod N``, from word plane 16."""
        return xw.reshape(32, -1)[16].to(torch.int64) & (self.n - 1)

    def index(self, j: torch.Tensor) -> torch.Tensor:
        return j * self.b + self.lane

    def reference(self, steps: int):
        """``steps`` steps of the fused walk on X: 19's kernel
        (``romix_walk``; its plain version on the CPU) and its plain
        version."""
        if steps not in self._reference:
            self._reference[steps] = (
                KS.romix_walk(self.x, self.v3, self.n_log2, steps),
                KS.romix_walk_plain(self.x, self.v3, self.n_log2, steps))
        return self._reference[steps]


def resolve(device) -> torch.device:
    """``device`` as the probes run on it: the CPU, or a card that torch
    sees (a CUDA request without one raises)."""
    device = torch.device(device)
    return device if device.type == "cpu" else _cuda_device(device)


def make_walk(device, b: int = B, n: int = N, v: Optional[torch.Tensor] = None) -> Walk:
    """The probes' set-up on ``device``; ``v``, a flat ``(n·b, 32)`` V
    from :func:`probe_v`, is made when not given (2 GiB at the scripts'
    sizes, so a caller running several probes makes it once)."""
    device = resolve(device)
    if n < 2 or n & (n - 1) or b < LANES or b % LANES:
        raise ValueError(f"n must be a power of two >= 2 and b a multiple of {LANES}")
    if v is None:
        v = probe_v(n * b, device)
    if tuple(v.shape) != (n * b, 32) or v.device != device:
        raise ValueError(f"v must be ({n * b}, 32) on {device}")
    x = np.random.default_rng(0).integers(0, 2**32, (b, 32), dtype=np.uint32)
    x = torch.from_numpy(x.astype(np.int64)).to(device)
    return Walk(device, b, n, v, x, torch.arange(b, device=device))


def words(walk: Walk, t: torch.Tensor) -> torch.Tensor:
    """int64 lanes → the device's word dtype (int32 bit patterns on the
    card)."""
    return ops.to_bits(t) if walk.device.type == "cuda" else t


def lanes(t: torch.Tensor) -> torch.Tensor:
    """Words of either dtype → int64 lanes."""
    return ops.to_lanes(t) if t.dtype == torch.int32 else t


def to_wm(walk: Walk, x: torch.Tensor) -> torch.Tensor:
    """``(B, 32)`` lanes → ``(32, B/128, 128)`` word planes on P2 (18's
    ``to_wm``), in the device's word dtype."""
    return K.transpose(words(walk, x)).view(32, walk.b // LANES, LANES)


def from_wm(walk: Walk, xw: torch.Tensor) -> torch.Tensor:
    """Word planes → ``(B, 32)`` int64 lanes, on P2."""
    return lanes(K.transpose(xw.reshape(32, walk.b)))


# ---- the gathers: torch ops, as the scripts' gathers were XLA ops ------------

def rows(walk: Walk, j: torch.Tensor) -> torch.Tensor:
    """Row-major ``(B, 32)``: ``vflat.index_select(0, idx)`` (the
    scripts' ``v[j·B + lane]``)."""
    return walk.v.index_select(0, walk.index(j))


def word_rows(walk: Walk, j: torch.Tensor) -> torch.Tensor:
    """Word-major in one op: ``out[w, b] = v[idx[b], w]``, 22's
    ``lax.gather(offset_dims=(0,))``."""
    return walk.v.t().index_select(1, walk.index(j)).view(32, walk.b // LANES, LANES)


def transposed_rows(walk: Walk, j: torch.Tensor) -> torch.Tensor:
    """The row gather's transposed view made contiguous (16's
    ``gather_wm``, 23's ``vj.T`` behind its barrier)."""
    return rows(walk, j).t().contiguous().view(32, walk.b // LANES, LANES)


def grouped_rows(walk: Walk, j: torch.Tensor) -> torch.Tensor:
    """17's native tiles: ``vj.T.reshape(4, 8, B/128, 128)`` with its
    middle axes swapped, made contiguous."""
    return (rows(walk, j).t().reshape(4, 8, walk.b // LANES, LANES).permute(0, 2, 1, 3)
            .contiguous())


@dataclass(frozen=True)
class Design:
    """A per-step walk design: a gather into ``layout`` and P3 with
    ``body`` (``blocks``: its grid, one thread a lane when None)."""

    name: str
    layout: str
    body: str
    gather: Callable[[Walk, torch.Tensor], torch.Tensor]
    blocks: Optional[int] = None

    @property
    def scrypt(self) -> bool:
        """Whether a chain of its steps is scrypt's walk."""
        return self.body == "full" and self.layout != "bitcast"

    def step(self, walk: Walk, xw: torch.Tensor) -> torch.Tensor:
        return K.walk_step(xw, self.gather(walk, walk.j(xw)), self.layout, self.body,
                           self.blocks)

    def chain(self, walk: Walk, steps: int, xw: Optional[torch.Tensor] = None) -> torch.Tensor:
        xw = to_wm(walk, walk.x) if xw is None else xw
        for _ in range(steps):
            xw = self.step(walk, xw)
        return xw


def check_chain(walk: Walk, design: Design, steps: int = CHECK_STEPS) -> None:
    """Stage 1: ``steps`` chained steps of ``design`` (each step's rows
    chosen by the last) against the fused walk, 19's kernel and its
    plain version; raises on a difference."""
    got = from_wm(walk, design.chain(walk, steps))
    for want, what in zip(walk.reference(steps), ("romix_walk", "romix_walk_plain")):
        if not torch.equal(got, want):
            bad = (got != want).nonzero()[:5].tolist()
            raise RuntimeError(f"{design.name}: {steps}-step chain differs from {what} at "
                               f"(lane, word) {bad}")


# ---- clocks ------------------------------------------------------------------

def where(device) -> str:
    """What a time was taken on: the card's name, or the CPU's plain
    versions (a host time, no device metric)."""
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu, plain versions, host clock")


def _events():
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def time_ms(fn: Callable[[], object], device, reps: int = REPS) -> float:
    """Mean time of ``fn`` over ``reps`` calls after a warm-up: on the
    card, its launches run back to back behind a stream held while the
    host queues them, so the events read device time, not the host's
    issue (a hold that ran out before the host had queued them all is
    taken again, four times longer); on the CPU, the host's clock over
    at most three calls."""
    fn()
    if torch.device(device).type != "cuda":
        reps = min(reps, 3)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    hold = HOLD_CYCLES
    while True:
        start, end = _events()
        torch.cuda.synchronize()
        torch.cuda._sleep(hold)
        start.record()
        for _ in range(reps):
            fn()
        held = not start.query()  # the hold still ran when the last call was queued
        end.record()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        if hold >= 64 * HOLD_CYCLES:
            raise RuntimeError("the host could not queue the calls within a 0.3 s hold")
        hold *= 4


def paired_ms(fns: dict, device, rounds: int = ROUNDS) -> dict:
    """:func:`time_ms` of each of ``fns`` (name → callable), taken in
    ``rounds`` interleaved rounds (one on the CPU), every other round in
    reverse order, and the median kept, so that a drift of the card's
    clocks falls on every one alike."""
    rounds = rounds if torch.device(device).type == "cuda" else 1
    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(time_ms(fns[name], device))
    return {name: float(np.median(t)) for name, t in times.items()}


def once_ms(fn: Callable[[], object], device):
    """One call of ``fn`` (a plain version: nothing to warm up), timed;
    returns (ms, its output)."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return (time.perf_counter() - t0) * 1e3, out
    start, end = _events()
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def chain_us(step: Callable, carry, steps: int, device) -> float:
    """µs a step of ``steps`` chained calls ``carry = step(carry)``,
    driven eagerly from Python (after one warm-up step)."""
    step(carry)
    ms, _ = once_ms(lambda: _run_chain(step, carry, steps), device)
    return ms * 1e3 / steps


def _run_chain(step, carry, steps):
    for _ in range(steps):
        carry = step(carry)
    return carry


def graph_chain_us(step: Callable, carry, steps: int) -> float:
    """µs a step of the same chain captured as one CUDA graph and
    replayed (card only): the launches' device-side cost, without the
    host's issue between them."""
    step(carry)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _run_chain(step, carry, steps)
    graph.replay()
    start, end = _events()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    us = start.elapsed_time(end) * 1e3 / steps
    del graph
    torch.cuda.empty_cache()
    return us


def measure(device, kernel: Callable, plain: Callable, *, nbytes: int, ops_count: int,
            library: Optional[Callable] = None, **extra) -> dict:
    """One probe kernel at the probe's shapes: its output against its
    plain version's on the same inputs (``plain`` computes on int64
    lanes; a difference raises), then the kernel's time, the plain
    version's (one call) and the library call's (held equal to the plain
    version first), the kernel's and the library call's in
    :func:`paired_ms`'s interleaved rounds. ``nbytes`` and ``ops_count``
    are the work the function needs, for its bound."""
    got = lanes(kernel())
    plain_ms, want = once_ms(plain, device)
    if got.shape != want.shape:
        raise RuntimeError(f"kernel shape {tuple(got.shape)} vs plain {tuple(want.shape)}")
    err = int((got - want).abs().max()) if got.numel() else 0
    if err:
        raise RuntimeError(f"kernel differs from its plain version by {err}")
    if library is not None and not torch.equal(lanes(library()).reshape(want.shape), want):
        raise RuntimeError("the library call computes another function than the kernel")
    times = paired_ms({"kernel": kernel, **({} if library is None else {"library": library})},
                      device)
    return dict(ms=times["kernel"], plain_ms=plain_ms, library_ms=times.get("library"),
                bytes=nbytes, ops=ops_count, max_abs_err=err, checks=1, **extra)


def library_call(xw: torch.Tensor, vj: torch.Tensor, layout: str,
                 body: str) -> Optional[Callable[[], torch.Tensor]]:
    """One PyTorch call computing P3's function on these operands, where
    one does (the bodies that are a single xor on a view), else None."""
    batch = xw.numel() // 32
    if body == "null":
        return lambda: torch.bitwise_xor(xw, 1)
    if (layout, body) == ("grouped", "one_extract"):
        return lambda: torch.bitwise_xor(xw, vj[0, :, 0, :])
    if (layout, body) == ("grouped", "xor_only"):
        return lambda: torch.bitwise_xor(xw.view(4, 8, *xw.shape[1:]), vj.permute(0, 2, 1, 3))
    if (layout, body) == ("bitcast", "xor_only"):
        block = ops.bitcast_block(batch)
        return lambda: torch.bitwise_xor(xw.view(32, batch // block, block),
                                         vj.view(batch // block, 32, block).transpose(0, 1))
    return None


def step_measure(walk: Walk, design: Design) -> dict:
    """P3 alone on one step's inputs (:func:`measure`), the gather's
    time beside it, and :func:`library_call`'s where there is one."""
    xw = to_wm(walk, walk.x)
    vj = design.gather(walk, walk.j(xw))
    xl, vl = lanes(xw), lanes(vj)
    plane = walk.b * 4
    nbytes = {"null": 2 * 32 * plane, "one_extract": 2 * 32 * plane + plane}.get(
        design.body, 3 * 32 * plane)
    return measure(walk.device, lambda: K.walk_step(xw, vj, design.layout, design.body,
                                                    design.blocks),
                   lambda: K.walk_step_plain(xl, vl, design.layout, design.body),
                   nbytes=nbytes, ops_count=walk.b * BODY_OPS[design.body],
                   library=library_call(xw, vj, design.layout, design.body),
                   wrapper="walk_step", layout=design.layout, body=design.body,
                   blocks=design.blocks,
                   gather_ms=time_ms(lambda: design.gather(walk, walk.j(xw)), walk.device))


def shipping_us(walk: Walk) -> float:
    """µs a step of the fused walk (19, ``romix_walk``): ``N`` steps in
    one launch (its plain version on the CPU)."""
    ms, _ = once_ms(lambda: KS.romix_walk(walk.x, walk.v3, walk.n_log2, walk.n), walk.device)
    if walk.device.type == "cuda":  # the first call above built and warmed it
        ms, _ = once_ms(lambda: KS.romix_walk(walk.x, walk.v3, walk.n_log2, walk.n),
                        walk.device)
    return ms * 1e3 / walk.n


def time_design(walk: Walk, design: Design) -> dict:
    """Stage 2 of a per-step design: its ``N``-step chain's µs a step,
    eager and (on the card) as a CUDA graph, beside P3's own time and
    the gather's."""
    site = step_measure(walk, design)
    xw = to_wm(walk, walk.x)
    site["chain_us"] = chain_us(lambda c: design.step(walk, c), xw, walk.n, walk.device)
    site["graph_us"] = (graph_chain_us(lambda c: design.step(walk, c), xw, walk.n)
                        if walk.device.type == "cuda" else None)
    return site


def design_lines(name: str, site: dict, ship_us: float) -> list:
    """A design's stage-2 lines, beside the fused walk's µs a step (and
    P3's time beside the one torch call computing its function, where
    there is one)."""
    graph = (f", graph {site['graph_us']:8.3f} us/step ({ship_us / site['graph_us']:.2f}x)"
             if site["graph_us"] is not None else "")
    library = (f", one torch call {site['library_ms'] * 1e3:.3f} us"
               if site.get("library_ms") is not None else "")
    return [f"{name:15s} {site['chain_us']:8.3f} us/step ({ship_us / site['chain_us']:.2f}x)"
            f"{graph}; P3 {site['ms'] * 1e3:.3f} us{library}, gather "
            f"{site['gather_ms'] * 1e3:.3f} us"]


# ---- the command line ----------------------------------------------------------

def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (their plain versions)")
    ap.add_argument("--b", type=int, default=B, help=f"lanes (default {B})")
    ap.add_argument("--n", type=int, default=N, help=f"ROMix's N (default {N})")
    return ap


def cli(run: Callable, doc: str, argv=None) -> int:
    """A probe's ``main``: parse, run, print its lines."""
    args = parser(doc).parse_args(argv)
    result = run(args.device, b=args.b, n=args.n)
    for line in result["lines"]:
        print(line)
    return 0
