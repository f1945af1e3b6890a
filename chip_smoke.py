#!/usr/bin/env python3
"""On-card smoke test of tpuminter_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA GPU (an H100
is the target):

    python3 chip_smoke.py

Phases, in order; a failure in any of them exits non-zero (none is
caught), and without a CUDA device the script exits non-zero at once:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: nvcc builds ``tpuminter_torch/kernels/csrc/sha256.cu``;
3. kernels: each kernel against its plain PyTorch version on the same
   inputs on the card (exact integer equality) and against hashlib, then
   each timed at the main path's slab (2^27 nonces) beside its plain
   version and its bound;
4. main path: ``CudaMiner()`` with its defaults mines the genesis header
   over a 2^30-nonce window, a regtest-difficulty window and an
   exhausted exact-min window, and a 2^30-nonce MIN chunk; every result
   is checked with hashlib, and every kernel must have been launched;
5. end to end: the unchanged ``python -m tpuminter.coordinator``, the
   port's ``python -m tpuminter_torch.worker`` and the unchanged
   ``python -m tpuminter.client`` as separate processes, one genesis
   TARGET job and one MIN job, each Result checked with hashlib.

It prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true,
"device": {...}}``. This script imports neither JAX nor the JAX package:
phase 5 only starts that package's coordinator and client as processes.
"""

import hashlib
import json
import os
import shutil
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20260916
GENESIS_NONCE = 2083236893
#: Bitcoin block 1, a second header with a known winning nonce
BLOCK1 = dict(
    version=1,
    prev_hex="000000000019d6689c085ae165831e934ff763ae46a2a6c172b3f1b60a8ce26f",
    merkle_hex="0e3e2357e806b6cdb1f70b54c3a3a17b6714ee1f0e68bebb44a74b1efd512098",
    timestamp=1231469665, bits=0x1D00FFFF, nonce=2573394689,
)
REGTEST_BITS = 0x207FFFFF
CHECK_N = 1 << 20  # nonces per kernel-vs-plain check window
MEM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
#: integer instructions an SM can issue per clock: 4 schedulers x 32 lanes,
#: shared by the INT32 pipe (64 lanes) and IMAD on the FMA pipe, where
#: ptxas places part of the adds; the INT32 pipe alone is reported beside
ISSUE_LANES_PER_SM = 128
INT32_LANES_PER_SM = 64

# Integer instructions per nonce, counted in csrc/sha256.cu at the fewest
# Hopper instructions each source expression needs: one funnel shift
# (SHF) per rotation, one LOP3 per logic expression of up to three
# inputs, one IADD3 per sum of up to three terms, one PRMT per byte
# swap, one ISETP per compare.
ROUND_OPS = 14  # Σ1 3 SHF+LOP3, Ch LOP3, t1 2 IADD3, Σ0 3 SHF+LOP3, Maj LOP3, a, e
SCHEDULE_OPS = 10  # σ0 2 SHF+SHR+LOP3, σ1 the same, 4-term sum 2 IADD3
COMPRESS_OPS = 64 * ROUND_OPS + 48 * SCHEDULE_OPS + 8
# rounds 0-61, whose a chain (Σ0, Maj, a: 6) is dead in rounds 58-61
TRUNCATED_OPS = 62 * ROUND_OPS - 4 * 6 + 46 * SCHEDULE_OPS
INJECT_OPS_PER_BYTE = 2  # extract the nonce byte, OR it into its word
LOOP_OPS = 3  # offset step, nonce add, bound compare


def say(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def first_hash_ops(template) -> int:
    return len(template.tail) * COMPRESS_OPS + INJECT_OPS_PER_BYTE * len(template.positions)


def ops_per_nonce(name: str, template) -> int:
    """Integer instructions one nonce costs in kernel ``name``."""
    first = first_hash_ops(template)
    second = COMPRESS_OPS if template.double else 0
    if name == "sha256_batch":
        return first + second + LOOP_OPS
    if name == "search_candidates":
        return first + TRUNCATED_OPS + 4 + LOOP_OPS  # add, PRMT, 2 ISETP
    if name == "search_target":
        # 8 PRMT for the hash words, 2 ISETP per target word, 2 per min key
        return first + second + 8 + 16 + 18 + LOOP_OPS
    if name == "min_toy":
        return first + second + 2 + 6 + LOOP_OPS  # 64-bit carry, 3-key compare
    raise ValueError(name)


def sass_summary(so_path: str):
    """Per kernel of the built library: SASS instruction count and the
    most frequent opcodes (from cuobjdump), or None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            name = next((k for k in ("sha256_batch", "search_target", "search_candidates",
                                     "min_toy", "reduce", "fill") if k in mangled), mangled)
            name += "<9>" if "ILi9E" in mangled else "<3>" if "ILi3E" in mangled else ""
            counts[name] = {}
        elif name and line.strip().startswith("/*") and "*/" in line:
            text = line.split("*/", 1)[1].strip()
            if text.startswith("@"):
                text = text.split(None, 1)[1] if " " in text else ""
            op = text.split(" ")[0].split(".")[0].rstrip(";")
            if op:
                counts[name][op] = counts[name].get(op, 0) + 1
    return counts


def event_ms(fn, reps: int):
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up
    call, with CUDA events; returns (ms, last output)."""
    out = fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def drain(gen):
    results = [item for item in gen if item is not None]
    if len(results) != 1:
        fail(f"a mine() generator yielded {len(results)} Results")
    return results[0]


class KernelStats:
    def __init__(self, name: str, replaces: str):
        self.name, self.replaces = name, replaces
        self.max_abs_err = 0
        self.checks = 0
        self.timing = None

    def agree(self, got: torch.Tensor, want: torch.Tensor, what: str) -> None:
        """Exact equality of a kernel's output with its plain version's."""
        if got.shape != want.shape:
            fail(f"{self.name} {what}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
        err = int((got - want).abs().max()) if got.numel() else 0
        self.max_abs_err = max(self.max_abs_err, err)
        self.checks += 1
        if err:
            fail(f"{self.name} {what}: kernel {got.flatten()[:12].tolist()} vs "
                 f"plain {want.flatten()[:12].tolist()}")


def phase_kernels(dev, rng):
    from tpuminter_torch import chain
    from tpuminter_torch.cuda_worker import DEFAULT_SLAB
    from tpuminter_torch.kernels import sha256 as K
    from tpuminter_torch.ops import sha256 as ops

    stats = {
        "sha256_batch": KernelStats("sha256_batch", "tpuminter/kernels/sha256.py:87"),
        "search_target": KernelStats("search_target", "tpuminter/kernels/sha256.py:257"),
        "search_candidates": KernelStats(
            "search_candidates", "tpuminter/kernels/sha256.py:371"),
        "min_toy": KernelStats("min_toy", "tpuminter/kernels/sha256.py:733"),
    }
    genesis = chain.GENESIS_HEADER
    hdr = ops.header_template(genesis.pack())
    target = chain.bits_to_target(genesis.bits)
    tw = [int(w) for w in ops.target_to_words(target)]
    data60 = rng.integers(0, 256, 60, dtype=np.uint8).tobytes()
    toy60 = ops.toy_template(data60)
    short = b"hello bitcoin"
    toy_short = ops.toy_template(short)

    # K1: 2^16 seeded nonces through a header and a two-block toy template
    st = stats["sha256_batch"]
    hi = torch.tensor(rng.integers(0, 1 << 32, 1 << 16, dtype=np.int64), device=dev)
    lo = torch.tensor(rng.integers(0, 1 << 32, 1 << 16, dtype=np.int64), device=dev)
    for tmpl, what in ((hdr, "header"), (toy60, "60-byte toy")):
        got = K.sha256_batch(tmpl, hi, lo)
        st.agree(got, K.sha256_batch_plain(tmpl, hi, lo), f"{what} 2^16 nonces")
        rows = got[:8].cpu().tolist()
        for i in range(8):
            h, lw = int(hi[i]), int(lo[i])
            if tmpl.double:
                want = chain.dsha256(genesis.pack()[:76] + struct.pack("<I", lw))
            else:
                want = hashlib.sha256(data60 + struct.pack(">Q", (h << 32) | lw)).digest()
            if tuple(rows[i]) != struct.unpack(">8I", want):
                fail(f"sha256_batch {what} nonce {i} disagrees with hashlib")
    say(f"  sha256_batch: 2^16 nonces x 2 templates equal to plain; 16 digests equal to hashlib")

    # K3: known winners at known offsets, masking, and seeded windows
    st = stats["search_candidates"]
    block1 = chain.BlockHeader(
        BLOCK1["version"], bytes.fromhex(BLOCK1["prev_hex"])[::-1],
        bytes.fromhex(BLOCK1["merkle_hex"])[::-1], BLOCK1["timestamp"],
        BLOCK1["bits"], BLOCK1["nonce"],
    )
    if chain.hash_to_hex(block1.block_hash()) != "00000000839a8e6886ab5951d76f411475428afc90947ee320161bbf18eb6048":
        fail("block 1 header does not hash to block 1")
    b1 = ops.header_template(block1.pack())
    cases = [
        (hdr, GENESIS_NONCE - 1000, 4096, [1, 1000]),
        (hdr, GENESIS_NONCE - 1000, 1001, [1, 1000]),
        (hdr, GENESIS_NONCE - 1000, 1000, [0, K.NOT_FOUND]),
        (b1, BLOCK1["nonce"] - 5000, 1 << 16, [1, 5000]),
    ]
    cases += [(hdr, int(rng.integers(0, 1 << 32)), CHECK_N, None) for _ in range(3)]
    for tmpl, base, n, expect in cases:
        got = K.search_candidates(tmpl, base, n, tw[1], device=dev)
        st.agree(got, K.search_candidates_plain(tmpl, base, n, tw[1], device=dev),
                 f"base {base} n {n}")
        if expect is not None and got.cpu().tolist() != expect:
            fail(f"search_candidates base {base} n {n}: {got.tolist()} != {expect}")
    say(f"  search_candidates: {len(cases)} windows equal to plain; genesis at offset 1000, block 1 at 5000")

    # K2: regtest target (early hit) and an exhausted window's exact min
    st = stats["search_target"]
    regtest = chain.BlockHeader.unpack(genesis.pack()[:72] + struct.pack("<I", REGTEST_BITS) + b"\0" * 4)
    rt = ops.header_template(regtest.pack())
    rtw = [int(w) for w in ops.target_to_words(chain.bits_to_target(REGTEST_BITS))]
    got = K.search_target(rt, rtw, 0, CHECK_N, device=dev)
    st.agree(got[:2], K.search_target_plain(rt, rtw, 0, CHECK_N, device=dev)[:2], "regtest")
    if int(got[0]) != 1:
        fail("search_target found no regtest winner")
    base = GENESIS_NONCE - CHECK_N - 10
    got = K.search_target(hdr, tw, base, CHECK_N, device=dev)
    st.agree(got, K.search_target_plain(hdr, tw, base, CHECK_N, device=dev), "exhausted window")
    row = got.cpu().tolist()
    value = int.from_bytes(b"".join(struct.pack(">I", w) for w in row[2:10]), "big")
    nonce = base + row[10]
    if row[0] != 0 or value != chain.hash_to_int(genesis.with_nonce(nonce).block_hash()):
        fail("search_target exhausted-window minimum disagrees with hashlib")
    say("  search_target: regtest hit and exhausted 2^20 window equal to plain; min equal to hashlib")

    # K6: short and block-straddling messages, and a base_lo wrap
    st = stats["min_toy"]
    for tmpl, data, base in (
        (toy_short, short, 0),
        (toy60, data60, int(rng.integers(0, 1 << 62))),
        (toy_short, short, (7 << 32) | ((1 << 32) - (1 << 19))),
    ):
        got = K.min_toy(tmpl, base >> 32, base & 0xFFFFFFFF, CHECK_N, device=dev)
        st.agree(got, K.min_toy_plain(tmpl, base >> 32, base & 0xFFFFFFFF, CHECK_N, device=dev),
                 f"base {base}")
        fh, fl, off = got.cpu().tolist()
        if (fh << 32) | fl != chain.toy_hash(data, base + off):
            fail(f"min_toy base {base}: fold disagrees with toy_hash")
    say("  min_toy: 3 windows of 2^20 equal to plain (incl. a base_lo wrap); folds equal to toy_hash")

    # timing at the main path's slab; candidate-free inputs so no early exit
    n = DEFAULT_SLAB
    base = int(rng.integers(0, (1 << 32) - n))
    big_hi = torch.tensor(rng.integers(0, 1 << 32, n, dtype=np.int64), device=dev)
    big_lo = torch.tensor(rng.integers(0, 1 << 32, n, dtype=np.int64), device=dev)
    runs = {
        "sha256_batch": (
            hdr, lambda: K.sha256_batch(hdr, big_hi, big_lo),
            lambda: K.sha256_batch_plain(hdr, big_hi, big_lo), 80 * n),
        "search_target": (
            hdr, lambda: K.search_target(hdr, [0] * 8, base, n, device=dev),
            lambda: K.search_target_plain(hdr, [0] * 8, base, n, device=dev), 88),
        "search_candidates": (
            hdr, lambda: K.search_candidates(hdr, base, n, 0, device=dev),
            lambda: K.search_candidates_plain(hdr, base, n, 0, device=dev), 16),
        "min_toy": (
            toy_short, lambda: K.min_toy(toy_short, 0, base, n, device=dev),
            lambda: K.min_toy_plain(toy_short, 0, base, n, device=dev), 24),
    }
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    int_rate = sms * ISSUE_LANES_PER_SM * clock_mhz * 1e6
    say(f"  bound: {sms} SMs x {ISSUE_LANES_PER_SM} integer lanes x {clock_mhz} MHz = "
        f"{int_rate:.4e} op/s (INT32 pipe alone: half); memory {MEM_BYTES_PER_S:.3e} B/s")
    for name, (tmpl, kernel, plain, nbytes) in runs.items():
        ms, got = event_ms(kernel, 5)
        plain_ms, want = event_ms(plain, 1)
        stats[name].agree(got, want, f"slab of {n}")
        ops_n = ops_per_nonce(name, tmpl) * n
        bound_ms = max(nbytes / MEM_BYTES_PER_S, ops_n / int_rate) * 1e3
        int32_pipe_ms = ops_n / (int_rate * INT32_LANES_PER_SM / ISSUE_LANES_PER_SM) * 1e3
        stats[name].timing = dict(
            n=n, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by="bytes" if nbytes / MEM_BYTES_PER_S > ops_n / int_rate else "operations",
            ops_per_nonce=ops_per_nonce(name, tmpl), int32_pipe_ms=int32_pipe_ms,
        )
        say(f"  {name}: {ms:.3f} ms/launch at n={n} ({n / ms / 1e6:.3f} GH/s), plain "
            f"{plain_ms:.1f} ms, bound {bound_ms:.3f} ms, INT32 pipe alone "
            f"{int32_pipe_ms:.3f} ms ({ops_per_nonce(name, tmpl)} op/nonce)")
    del big_hi, big_lo
    torch.cuda.empty_cache()
    return stats


def phase_main_path(card: str):
    from tpuminter_torch import chain, kernels
    from tpuminter_torch.cuda_worker import CudaMiner
    from tpuminter_torch.protocol import MIN_UNTRACKED, PowMode, Request

    genesis = chain.GENESIS_HEADER
    target = chain.bits_to_target(genesis.bits)

    def check_target_result(res, header, tgt, what):
        got = chain.hash_to_int(chain.dsha256(header[:76] + struct.pack("<I", res.nonce)))
        if got != res.hash_value:
            fail(f"{what}: reported hash is not the hash of nonce {res.nonce}")
        if res.found != (got <= tgt):
            fail(f"{what}: found={res.found} but hash <= target is {got <= tgt}")

    for fn in kernels.KERNELS:
        fn.launches = 0
    miner = CudaMiner()
    exact = CudaMiner(exact_min=True)
    # genesis at real difficulty over 2^30 + 4095 nonces (candidate kernel)
    req = Request(1, PowMode.TARGET, GENESIS_NONCE - (1 << 30) + 1, GENESIS_NONCE + 4095,
                  header=genesis.pack(), target=target)
    t0 = time.perf_counter()
    res = drain(miner.mine(req))
    dt = time.perf_counter() - t0
    check_target_result(res, genesis.pack(), target, "genesis")
    if not res.found:
        fail("genesis window: no winner found")
    note = "" if res.nonce == GENESIS_NONCE else f" (an earlier winner than {GENESIS_NONCE}, hashlib-checked)"
    digest = res.hash_value.to_bytes(32, "little")
    say(f"  genesis: nonce {res.nonce} hash {chain.hash_to_hex(digest)}{note}; "
        f"{res.searched} nonces in {dt:.3f} s = {res.searched / dt / 1e9:.3f} GH/s on {card}")
    if res.nonce == GENESIS_NONCE and chain.hash_to_hex(digest) != chain.GENESIS_HASH_HEX:
        fail("genesis hash differs from the genesis block hash")
    # regtest difficulty takes the tracking kernel
    regtest = genesis.pack()[:72] + struct.pack("<I", REGTEST_BITS) + b"\0" * 4
    rt_target = chain.bits_to_target(REGTEST_BITS)
    res = drain(exact.mine(Request(2, PowMode.TARGET, 0, (1 << 20) - 1,
                                   header=regtest, target=rt_target)))
    check_target_result(res, regtest, rt_target, "regtest")
    if not res.found:
        fail("regtest window: no winner")
    say(f"  regtest 0x207fffff: nonce {res.nonce}, found, hashlib-checked")
    # exact-min exhausted window, one full slab below the genesis nonce
    lower = GENESIS_NONCE - (1 << 27)
    t0 = time.perf_counter()
    res = drain(exact.mine(Request(3, PowMode.TARGET, lower, GENESIS_NONCE - 1,
                                   header=genesis.pack(), target=target)))
    dt = time.perf_counter() - t0
    check_target_result(res, genesis.pack(), target, "exact-min window")
    if res.hash_value == MIN_UNTRACKED or res.searched > 1 << 27:
        fail("exact-min window: minimum untracked or over-searched")
    say(f"  exact-min 2^27 window: found={res.found} nonce {res.nonce}, hashlib-checked; "
        f"{res.searched / dt / 1e9:.3f} GH/s on {card}")
    # MIN over 2^30 nonces
    data = b"tpuminter_torch chip smoke"
    t0 = time.perf_counter()
    res = drain(miner.mine(Request(4, PowMode.MIN, 0, (1 << 30) - 1, data=data)))
    dt = time.perf_counter() - t0
    if res.hash_value != chain.toy_hash(data, res.nonce):
        fail("MIN: reported fold is not toy_hash of the reported nonce")
    say(f"  MIN 2^30: nonce {res.nonce} fold {res.hash_value:#018x}, toy_hash-checked; "
        f"{(1 << 30) / dt / 1e9:.3f} GH/s on {card}")
    launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    say(f"  launches on the main path: {launches}")
    for name, count in launches.items():
        if count < 1:
            fail(f"kernel {name} was not launched on the main path")
    return launches


def free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_end_to_end() -> None:
    from tpuminter_torch import chain

    log_dir = os.path.join(ROOT, "build", "tpuminter_torch")
    os.makedirs(log_dir, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    port = free_udp_port()
    addr = f"127.0.0.1:{port}"
    procs, logs = [], []

    def start(name, args):
        log = open(os.path.join(log_dir, f"e2e_{name}.log"), "w")
        logs.append((name, log))
        procs.append(subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, env=env,
                                      stdout=log, stderr=subprocess.STDOUT))

    def client(args):
        out = subprocess.run([sys.executable, "-m", "tpuminter.client", addr, *args,
                              "--timeout", "300"], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=400)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("Result ")]
        if out.returncode != 0 or len(lines) != 1:
            fail(f"client {args[:2]} failed (rc {out.returncode}): {out.stdout}{out.stderr}")
        return lines[0].split()

    try:
        start("coordinator", ["tpuminter.coordinator", str(port)])
        deadline = time.time() + 60
        while "listening" not in open(os.path.join(log_dir, "e2e_coordinator.log")).read():
            if procs[0].poll() is not None or time.time() > deadline:
                fail("the coordinator did not start")
            time.sleep(0.2)
        start("worker", ["tpuminter_torch.worker", addr])
        genesis = chain.GENESIS_HEADER
        _, hash_hex, nonce = client(["--header", genesis.pack().hex(), "--bits", "0x1d00ffff",
                                     "--max-nonce", str(GENESIS_NONCE + 4095)])
        nonce = int(nonce)
        digest = genesis.with_nonce(nonce).block_hash()
        if chain.hash_to_hex(digest) != hash_hex or \
                chain.hash_to_int(digest) > chain.bits_to_target(genesis.bits):
            fail(f"e2e genesis Result {hash_hex} {nonce} fails the hashlib check")
        say(f"  e2e TARGET: Result {hash_hex} {nonce} (hashlib-checked)")
        data = "hello bitcoin"
        _, fold, nonce = client([data, str((1 << 30) - 1)])
        if int(fold) != chain.toy_hash(data.encode(), int(nonce)):
            fail(f"e2e MIN Result {fold} {nonce} fails the toy_hash check")
        say(f"  e2e MIN: Result {fold} {nonce} (toy_hash-checked)")
        if procs[1].poll() is not None:
            fail("the worker exited early")
    except BaseException:
        for name, log in logs:
            log.flush()
            with open(log.name) as fh:
                print(f"--- {name} log tail ---\n{fh.read()[-3000:]}", file=sys.stderr)
        raise
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for _, log in logs:
            log.close()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing to test", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tpuminter_torch.kernels import build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    say("== 1. environment")
    say(f"  python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    say(smi)
    card_tag = f"{card}, {smi.split(',')[-1].strip()} limit"

    say("== 2. build")
    info = build.build()
    say(f"  nvcc built {os.path.relpath(info.path, ROOT)} in {info.seconds:.1f} s")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"  {line.strip()}")
    build.library()
    for kernel, ops_count in (sass_summary(str(info.path)) or {}).items():
        top = sorted(ops_count.items(), key=lambda kv: -kv[1])[:9]
        say(f"  SASS {kernel}: {sum(ops_count.values())} instructions; "
            + ", ".join(f"{op} {c}" for op, c in top))

    say("== 3. kernels against their plain versions")
    stats = phase_kernels(dev, np.random.default_rng(SEED))

    say("== 4. main path (CudaMiner defaults)")
    launches = phase_main_path(card_tag)

    say("== 5. end to end: coordinator + port worker + client processes")
    phase_end_to_end()

    rows = []
    for name, st in stats.items():
        t = st.timing
        rows.append({
            "name": name, "route": "cuda",
            "source": "tpuminter_torch/kernels/csrc/sha256.cu",
            "replaces": st.replaces, "launches": launches[name],
            "max_abs_err": st.max_abs_err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
            "n": t["n"], "ops_per_nonce": t["ops_per_nonce"],
            "int32_pipe_ms": t["int32_pipe_ms"], "checks": st.checks,
        })
    say(f"  total {time.perf_counter() - t_start:.1f} s")
    say(smi)
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
