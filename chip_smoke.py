#!/usr/bin/env python3
"""On-card smoke test of tpuminter_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA GPU (an H100
is the target):

    python3 chip_smoke.py

Phases, in order; a failure in any of them exits non-zero (none is
caught), and without a CUDA device the script exits non-zero at once:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: one nvcc per source under ``tpuminter_torch/kernels/csrc/``
   (``sha256.cu``, ``splitmix.cu``, ``scrypt.cu``, ``probes.cu``), all
   started together; each kernel's SASS by opcode, and K1-K6's (K2, K3
   and K6 in both arms), S1's and 19's instructions a nonce or a hash on
   each issue pipe (ALU, FMA); the grid-stride SHA searches' and S2's
   registers, resident blocks an SM and waves a launch at the main
   path's shape; that the roll (R) uses no local memory (no stack frame
   or spill in ptxas's report, no LDL/STL in its SASS);
3. kernels: each kernel against its plain PyTorch version on the same
   inputs on the card (exact integer equality) and against hashlib or
   ``toy_hash`` (the header arms of K2 and K3 on header templates and
   K6's toy arm on toy templates of 13, 52, 58 and 60 bytes and the
   main path's 26-byte MIN message, across a low-word wrap too, each
   beside its generic kernel on the same template in a form the arm
   does not take, and at every ``len(data) % 64`` (every instantiation
   and byte shift of the arm); K2's header arm also at
   an exhausted window's minimum as the target and one below it; K3's
   generic kernel also on a two-tail-block double-SHA template), the
   roll at extranonce sizes 1, 4 and 8 placed word-aligned, across a
   word and across a block, 12-deep and empty branches, 1, 2, 7 and 10
   rows (and hashlib on two rows of each), the rolled search kernels also
   at the main path's shape (width 2^27, 10 rows, the job's real cap, a
   planted genesis winner, ragged and padding rows), then each timed at
   the main path's shapes (2^27 nonces a launch, 8 rows of 2^27 for the
   batched rolled kernel; K6's arm and generic kernel on the 60-byte
   template too) beside its plain version and its bound
   (``op_count``: the instructions the function needs on the timed
   inputs); K7 (splitmix64) on 2^24 random indices under random seeds
   and on the edge words, against numpy u64 lanes too, and timed at the
   hashcore path's window (2^24 indices); the scrypt kernels S1
   (PBKDF2-in and the ROMix fill), 19 (the walk) and S2 (PBKDF2-out and
   the batch fold) on the path's batch of seeded nonces at N = 1024 (X
   and all of V too), whole and ragged, and at N = 16 on ragged counts
   down to one lane, against hashlib.scrypt on a sample, the fold at a
   planted target; S2's one-launch contract on 2^16 lanes of random X
   (three launches back to back, ragged counts and counts below one
   block, the first winner in the last block); probe 19's stage 1 at its
   shapes and probe 11 (the row gather) against its plain version at 1,
   7, 8191 and 8192 lanes and 0, 1, 3, 32 and 256 passes, on its 256 MiB
   V and on V's of 5 and 1000 rows (the pass stride wraps); then
   S1, 19 and S2 timed at the SCRYPT path's batch and at 2^15 (S2, like
   the roll, as its launches back to back behind a held stream, since
   calls from Python pace it at the host's issue; that reading is
   printed beside; the roll also at 10 rows and beside its serial floor,
   one row's chain of compressions with no loads), 19 per step as
   probe 19's stage 2, 11 per row as probe 11 measured it (behind a held
   stream too), beside ``torch.index_select``;
3b. the layout probes (``tpuminter_torch.probes``, the TPU rounds'
   fifteen remaining ``pallas_call`` sites on the kernels P1-P3 of
   ``csrc/probes.cu``): each kernel against its plain version off the
   probes' shapes (ragged, misaligned, off the tile, one block, other
   grids; P2's vector arm on the probes' shapes with and without a
   carry, its scalar arm on odd sides and on views one word off their
   storage), then every probe module's ``run()`` on one V at the scripts'
   sizes (B = 16384, N = 1024), which holds its kernels against their
   plain versions and each per-step walk chain against ``romix_walk``,
   and times them beside the fused walk (and each site beside its one
   torch call, as a factor); none of them is on the main path;
4. main path, in four parts, each with every launch count set to 0 just
   before it and read just after: (a) fixed headers: ``CudaMiner()``
   with its defaults mines the genesis header over a 2^30-nonce window
   (K3's header arm), a regtest-difficulty window and an exhausted
   exact-min window (K2's header arm), and a 2^30-nonce MIN chunk (K6's
   toy arm), after K1's self-check; the generic K2, K3 and K6 must not
   launch there; (a') the same genesis window through
   ``ProfiledMiner(CudaMiner())`` (the worker's ``--profile``): its
   Result must equal the unwrapped miner's and it must write a trace
   (phase 5 reads the worker process's trace); (b) rolled jobs: the genesis block as a rolled
   job over a 2^30-index window, a mainnet-shaped block template (250-byte
   coinbase, 12-deep Merkle branch) at difficulty 1 over four whole
   extranonces, three times (batched with and without the shared
   schedule, and one segment at a time), and a rolled regtest job on
   the tracking path (K2's header arm). Every result is checked with
   hashlib, and every kernel of each part must have been launched in
   it; (c) hashcore
   workload chunks: ``workloads.compute`` on the card for fmin, top-k
   (k = 8), first-match (a planted first hit 2^31 in) and sum over 2^32
   indices that cross a 2^32 boundary, each equal to the same path on
   K7's plain version and its witnesses recomputed with the scalar
   objective; the four at 2^24 ragged indices against numpy u64 lanes;
   before them, a window sweep and a profiled breakdown of a window's
   device time (which also make the runs after them steady-state);
   (d) SCRYPT chunks through ``CudaMiner()``: a batch sweep (2^14 to
   2^18 nonces), a chunk of the coordinator's size, an exhausted 2^20
   range and the same range at a planted target, the Litecoin genesis
   block, and a rolled SCRYPT job, every Result checked with
   hashlib.scrypt;
4e. the pod worker (``tpuminter_torch.pod_worker``, one process a card):
   (a) one rank on NCCL in this process, ``PodMiner()`` at its defaults,
   every launch count 0 just before its jobs and read just after: the
   genesis header over a 2^30-nonce window (3h), a MIN chunk of 2^30 +
   12,345 nonces (6t; the ragged tail on the rank's card), the genesis
   coinbase rolled over a 2^30-index window at ``roll_batch`` 8 (R and
   K5's sched arm) and 1 (K4), an exhausted exact-min window of 2^29 +
   12,345 nonces (2h) and two SCRYPT ranges of a batch and 333 nonces
   (S1, 19, S2; the Litecoin genesis nonce in the ragged tail of one),
   each Result equal to ``CudaMiner()``'s (run before and after,
   uncounted) on the fields both fix, checked with hashlib,
   ``hashlib.scrypt`` or ``toy_hash``, and its rate printed beside
   ``CudaMiner()``'s; one collective round timed; (b) the same jobs on
   two ranks sharing the card over gloo, as two processes
   (``chip_smoke.py --pod-rank OUT`` with the ``TPUMINTER_*`` triple):
   Results equal to (a)'s, every pod kernel launched on both ranks, no
   JAX module loaded; (c) ``python -m tpuminter_torch.worker ADDR
   --backend pod`` as two such ranks against the unchanged coordinator
   and client: a genesis TARGET job and a MIN job, checked, the
   coordinator's log showing one worker joining, with backend pod, and
   the follower exiting 0 once the leader's session ends;
5. end to end: the unchanged ``python -m tpuminter.coordinator`` (with a
   roll budget and a journal), the port's worker and the unchanged
   ``python -m tpuminter.client`` as separate processes. A MIN job runs
   on ``python -m tpuminter_torch.worker ADDR --codec json``, which is
   then stopped (its session must have sent every Result in JSON); every
   other job on ``python -m tpuminter_torch.worker --coordinator ADDR
   --reconnect --profile DIR`` (at its default codec, binary), whose
   ``torch.profiler`` trace of its first chunk (the genesis job's) must
   hold K3's header arm's kernel events (each kernel of the window is
   printed with its launches and device time): a
   genesis TARGET job, a rolled job (the genesis coinbase,
   extranonces 0-4) and a SCRYPT job (phase 4d's range at its planted
   bits), each Result checked with hashlib; hashcore jobs (fmin and
   top-k over 2^32 indices, equal to phase 4c's; sum and a planted
   first-match over 2^20, checked with numpy); a dict job (top-k over
   6000 candidates, the catalog past the coordinator's window budget,
   checked with hashlib); a crash drill (a MIN job over 2^36 nonces
   through a client with ``--reconnect``, the coordinator killed 1.5 s
   in and restarted from its journal: the worker redials by itself and
   the client prints exactly one Result, equal to ``CudaMiner()``'s);
   each coordinator's log must show the binary worker joining with the
   binary codec and advertising dict and hashcore, the worker's log that
   its session before the crash sent every Result in binary, and no log
   a refused chunk; each job's seconds through the client are kept;
5b. end to end on the port alone: ``python -m tpuminter_torch.coordinator``
   (roll budget 2, a journal), ``python -m tpuminter_torch.worker
   --coordinator ADDR --reconnect`` on the card and ``python -m
   tpuminter_torch.client``, each started with ``python -X importtime``:
   phase 5's genesis job (under a client key), its rolled, MIN and
   SCRYPT jobs, hashcore fmin over 2^32 (equal to phase 4c's), the dict
   top-k and the crash drill (the port's coordinator killed and
   restarted from its journal), each checked as in phase 5 and its
   seconds printed beside phase 5's; then the port's coordinator and
   worker stop, the unchanged ``python -m tpuminter.coordinator`` starts
   on the port's journal with no worker, and the genesis job
   re-submitted under its key must print the identical Result from the
   journal's winner table. No import log of the three may name a
   ``jax``, ``jaxlib`` or ``tpuminter`` module, nor the coordinator's
   or the client's a ``torch`` one.
5c. the coordinator's policies on the port: first ``CudaMiner()`` at its
   defaults on the ranges an audit sends, every launch count 0 just
   before and read just after: 256 nonces at random bases on the fast
   path (3h), on exact-min (2h, ``exact_min=True`` and regtest bits) and
   on MIN (6t, also across a 2^32 low-word boundary), 64 nonces of
   SCRYPT (S1, 19, S2), each Result against hashlib, ``hashlib.scrypt``
   or ``toy_hash``; then ``python -m tpuminter_torch.coordinator`` with a
   journal, ``--roll-budget 2``, ``--audit-rate 1.0``, ``--hedge-after
   0.3``, ``--stats-port 0``, ``--quota-rate 1 --quota-burst 2``,
   ``--max-jobs 4``, ``--park-queue 8 --workload-weight mine=1,dict=2``
   and ``--emit-interval 0.2``, two port workers sharing the card and
   the port's client, all under ``python -X importtime``: a MIN job over
   2^34 nonces (equal to ``CudaMiner()``'s, every audit conclusive), the
   genesis TARGET job (hashlib; its audit counters printed: the fast
   path's sentinel leaves them inconclusive), phase 4d's SCRYPT job
   (audits conclusive), phase 5's dict top-k with ``--stream`` beside a
   MIN job over 2^35 that keeps the workers busy (Partial lines of
   monotone coverage, the final equal to phase 5's), a hedge
   drill (one worker stopped with SIGSTOP just before a MIN job's four
   chunks are dispatched and continued once one is hedged, inside the
   LSP loss horizon: the Result exact, a hedge counted, the stopped
   worker's log showing the Cancel) and three submissions under one
   client key at once (the third parked and drained); then the
   coordinator is killed and restarted from its journal without the
   park queue (its tenant's bucket restored) and the three submissions
   run again (at least one refused and retried by the client, all
   exact). Each incarnation's stats endpoint is read over HTTP before it
   stops, held to what the phase saw, and printed. The import logs as in
   5b.
5d. a failover drill on the port: a hot standby (``python -m
   tpuminter_torch.replication P1 --wal S --port P2 --promote-after
   1.5``), the port's coordinator on P1 with a journal, ``--replicate-to
   127.0.0.1:P2 --replica-ack --roll-budget 2 --stats-port 0``, two port
   workers on the card and the port's client, both given ``P1,P2`` and
   ``--reconnect``, every process under ``python -X importtime``: the
   genesis job under a client key (its seconds beside 5b's), then a MIN
   job over 2^35 nonces; once 16 chunks are settled and the lane's acked
   offset has passed the journal's size read then, the primary is
   killed (SIGKILL). The standby promotes at a fenced epoch, the MIN
   Result must equal ``CudaMiner()``'s, the genesis re-submission is
   answered from the promoted winner table with no job minted, phase
   4d's SCRYPT job runs through the promoted coordinator, and the old
   primary restarted on its journal with ``--replicate-to P2`` must log
   FENCED while the promoted one logs its RepHello rejected. Printed:
   seconds from the kill to the promotion and to the MIN Result, the
   job's coverage in what the standby had acked, in what it adopted and
   in the primary's own journal, and the share mined twice. The import
   logs as in 5b, the standby's free of torch too.

It prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true,
"device": {...}}``. This script imports neither JAX nor the JAX package:
phase 5 starts that package's coordinator and client as processes, and
phase 5b its coordinator on the port's journal.
"""

import dataclasses
import hashlib
import json
import os
import re
import shutil
import signal
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
#: the genesis coinbase transaction: the genesis block as a rolled job
#: splits it at byte 48 around a one-byte extranonce (4, the scriptSig's
#: byte), so global index (4 << 32) | GENESIS_NONCE is the genesis block
GENESIS_COINBASE_HEX = (
    "01000000" "01" + "00" * 32 + "ffffffff" "4d"
    "04ffff001d0104455468652054696d65732030332f4a616e2f32303039204368616e63656c"
    "6c6f72206f6e206272696e6b206f66207365636f6e64206261696c6f757420666f722062616e6b73"
    "ffffffff" "01" "00f2052a01000000" "43"
    "4104678afdb0fe5548271967f1a67130b7105cd6a828e03909a67962e0ea1f61deb649f6bc3f"
    "4cef38c4f35504e51ec112de5c384df7ba0b8d578a4c702b6bf11d5fac"
    "00000000"
)
GENESIS_ROLLED = (4 << 32) | GENESIS_NONCE
CHECK_N = 1 << 20  # nonces per kernel-vs-plain check window
OFFSET_N = 1 << 16  # nonces per window of K6's sweep over every nonce offset
MIN_DATA = b"tpuminter_torch chip smoke"  # the main path's MIN message
ROWS = 8  # rows of the batched rolled kernel at the main path's shape
#: nonces per full row of the plan that holds the batched rolled kernel
#: against its plain version (K4's plain version sweeps ROWS rows' worth)
PLAIN_ROW_N = 1 << 23
#: integer instructions an SM can issue per clock: 4 schedulers x 32 lanes,
#: shared by the INT32 pipe (64 lanes) and IMAD on the FMA pipe, where
#: ptxas places part of the adds; the INT32 pipe alone is reported beside
ISSUE_LANES_PER_SM = 128
INT32_LANES_PER_SM = 64
M32 = 0xFFFFFFFF

# ---- the bound's operation count ------------------------------------------
#
# The integer instructions a function needs on this run's inputs, counted
# on a dataflow graph of SHA-256 at the fewest Hopper instructions per
# expression: one funnel shift (SHF) per rotation, one LOP3 per logic
# expression of up to three inputs, one IADD3 per two additions, one
# PRMT per byte permutation, one ISETP per compare. A value is an int
# when the launch holds it fixed (folded, free), or a node computed once
# per row (ROW: a roll row's header) or once per nonce (NONCE). A sum
# gathers its terms; the fixed and per-row terms of a per-nonce sum are
# added once per row, and a per-nonce sum of one varying term and a
# per-row part is re-associated into the sums that use it. Only nodes
# that the function's outputs need are counted: where a compare settles
# on its first word for all but about 2^-32 of the nonces, only that
# word is an output.

ROW, NONCE = 1, 2
LOOP_OPS = 1  # the nonce: one add per nonce (an unrolled loop amortises its control)


class Node:
    __slots__ = ("level", "cost", "deps", "var", "inv")

    def __init__(self, level, cost, deps, var=None, inv=()):
        self.level, self.cost, self.deps, self.var, self.inv = level, cost, deps, var, inv


def leaf(level):
    return Node(level, 0, [])


def _expr(cost, fn, *xs):
    if all(isinstance(x, int) for x in xs):
        return fn(*xs) & M32
    deps = [x for x in xs if not isinstance(x, int)]
    return Node(max(d.level for d in deps), cost, deps)


def _add(*xs):
    const, row, var = 0, [], []
    for x in xs:
        if isinstance(x, int):
            const += x
        elif x.level == ROW:
            row.append(x)
        elif x.var is not None and len(x.var) == 1:
            var.append(x.var[0])
            for t in x.inv:
                if isinstance(t, int):
                    const += t
                else:
                    row.append(t)
        else:
            var.append(x)
    const &= M32
    row_sum = None
    if row:
        n = len(row) + (const != 0)
        row_sum = row[0] if n == 1 else Node(ROW, n // 2, row)
    if not var:
        return const if row_sum is None else row_sum
    inv = row + ([const] if const else [])
    if len(var) == 1 and not inv:
        return var[0]
    n = len(var) + 1 if inv else len(var)
    return Node(NONCE, n // 2, var + ([row_sum] if row_sum is not None else []), var, inv)


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & M32


def _bsig0(x):
    return _expr(4, lambda v: _rotr(v, 2) ^ _rotr(v, 13) ^ _rotr(v, 22), x)


def _bsig1(x):
    return _expr(4, lambda v: _rotr(v, 6) ^ _rotr(v, 11) ^ _rotr(v, 25), x)


def _ssig0(x):
    return _expr(4, lambda v: _rotr(v, 7) ^ _rotr(v, 18) ^ (v >> 3), x)


def _ssig1(x):
    return _expr(4, lambda v: _rotr(v, 17) ^ _rotr(v, 19) ^ (v >> 10), x)


def _bswap(x):
    return _expr(1, lambda v: int.from_bytes(v.to_bytes(4, "little"), "big"), x)


def _rounds(state, block, count):
    """Working variables after ``count`` rounds, and the e produced by
    each round (``es[60]`` is the candidate test's e60)."""
    from tpuminter_torch.chain import SHA256_K

    w = list(block)
    a, b, c, d, e, f, g, h = state
    es = []
    for i in range(count):
        if i >= 16:
            w.append(_add(_ssig1(w[i - 2]), w[i - 7], _ssig0(w[i - 15]), w[i - 16]))
        t1 = _add(h, _bsig1(e), _expr(1, lambda e, f, g: g ^ (e & (f ^ g)), e, f, g),
                  SHA256_K[i], w[i])
        maj = _expr(1, lambda a, b, c: (a & b) | (c & (a | b)), a, b, c)
        a, b, c, d, e, f, g, h = _add(t1, _bsig0(a), maj), a, b, c, _add(d, t1), e, f, g
        es.append(e)
    return [a, b, c, d, e, f, g, h], es


def _compress(state, block):
    v, _ = _rounds(state, block, 64)
    return [_add(s, x) for s, x in zip(state, v)]


def _second_block(digest):
    return list(digest) + [0x80000000, 0, 0, 0, 0, 0, 0, 256]


def _inject(template, hi, lo):
    """A template's tail blocks with its nonce bytes in place: a word
    that takes nonce bytes is one PRMT or funnel shift of its sources
    (two when it mixes both nonce halves and fixed bytes)."""
    blocks = [list(b) for b in template.tail]
    by_word = {}
    for block, word, wshift, nshift in template.positions:
        by_word.setdefault((block, word), []).append((wshift, nshift))
    for (block, word), parts in by_word.items():
        const, srcs = blocks[block][word], []
        for wshift, nshift in parts:
            src = hi if nshift >= 32 else lo
            if isinstance(src, int):
                const |= ((src >> (nshift % 32)) & 0xFF) << wshift
            elif src not in srcs:
                srcs.append(src)
        blocks[block][word] = (const if not srcs else Node(
            max(s.level for s in srcs), max(1, len(srcs) + (const != 0) - 1), srcs))
    return blocks


def _count(outputs):
    """(per-nonce, per-row) instructions of the nodes ``outputs`` need."""
    cost, seen = {ROW: 0, NONCE: 0}, set()
    stack = [o for o in outputs if isinstance(o, Node)]
    while stack:
        node = stack.pop()
        if id(node) not in seen:
            seen.add(id(node))
            cost[node.level] += node.cost
            stack.extend(node.deps)
    return cost[NONCE], cost[ROW]


def _hdr_e60(mid, tail3, nonce):
    """e60 of an 80-byte header's double SHA from its midstate."""
    first = _compress(mid, list(tail3) + [_bswap(nonce), 0x80000000] + [0] * 10 + [640])
    return _rounds(_h0(), _second_block(first), 61)[1][60]


def _h0():
    from tpuminter_torch.chain import SHA256_H0

    return list(SHA256_H0)


def op_count(name: str, template=None, base_hi: int = 0):
    """(per-nonce, per-row) integer instructions kernel ``name``'s
    function needs on the timed inputs (a launch's template, or a roll
    row's header, held fixed; hash word 0 settles every compare but for
    about 2^-32 of the nonces)."""
    nonce = leaf(NONCE)
    if name.startswith("search_candidates_hdr"):
        # a roll row's header: midstate and tail words per row; e60 == CAND
        per_nonce, per_row = _count([_hdr_e60([leaf(ROW) for _ in range(8)],
                                              [leaf(ROW) for _ in range(3)], nonce)])
        return per_nonce + 1 + LOOP_OPS, per_row
    hi = leaf(NONCE) if name == "sha256_batch" else base_hi
    state = list(template.midstate)
    for block in _inject(template, hi, nonce):
        state = _compress(state, block)
    if name == "sha256_batch":  # every digest word is written
        if template.double:
            state = _compress(_h0(), _second_block(state))
        return _count(state)[0] + LOOP_OPS, 0
    if name in ("min_toy", "min_toy_toy"):  # the fold's high word (digest word 0) against the min
        return _count([state[0]])[0] + 2 + LOOP_OPS, 0
    e60 = _rounds(_h0(), _second_block(state), 61)[1][60]
    if name in ("search_candidates", "search_candidates_header"):  # e60 == CAND
        return _count([e60])[0] + 1 + LOOP_OPS, 0
    if name in ("search_target", "search_target_header"):
        # hash word 0 = bswap(H7 + e60) against the target's and the min's
        # word 0 (< and == each)
        return _count([_bswap(_add(_h0()[7], e60))])[0] + 4 + LOOP_OPS, 0
    raise ValueError(name)


def roll_op_count(job, en_hi: int = 0) -> int:
    """Integer instructions one extranonce row of the roll needs: the
    coinbase's tail blocks and its second hash, three compressions per
    branch level, the header's first block (the job's constants fold)."""
    en = leaf(NONCE)
    state = list(job.coinbase.midstate)
    for block in _inject(job.coinbase, en_hi, en):
        state = _compress(state, block)
    node = _compress(_h0(), _second_block(state))
    for sib in job.branch:
        pair = _compress(_compress(_h0(), node + list(sib)),
                         [0x80000000] + [0] * 14 + [512])
        node = _compress(_h0(), _second_block(pair))
    mid = _compress(_h0(), list(job.head9) + node[:7])
    return _count(mid + [node[7]])[0]


def say(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def issue_rate(dev):
    """(SMs, max SM clock in MHz, integer instructions the card can issue
    a second): the operations side of every bound."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return sms, clock_mhz, sms * ISSUE_LANES_PER_SM * clock_mhz * 1e6


def event_ms(fn, reps: int, warmup: bool = True):
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up
    call unless ``warmup`` is false (a plain version, which has nothing
    to build), with CUDA events; returns (ms, last output)."""
    if warmup:
        fn()
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
    def __init__(self, name: str, replaces: str,
                 source: str = "tpuminter_torch/kernels/csrc/sha256.cu", kernel: str = ""):
        self.name, self.replaces, self.source = name, replaces, source
        self.kernel = kernel or name  # the wrapper whose launches the row reports
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
    from tpuminter_torch.probes._common import MEM_BYTES_PER_S

    stats = {
        "sha256_batch": KernelStats("sha256_batch", "tpuminter/kernels/sha256.py:87"),
        "search_target": KernelStats(
            "search_target", "tpuminter/kernels/sha256.py:257 (any other template)"),
        "search_target_header": KernelStats(
            "search_target_header", "tpuminter/kernels/sha256.py:257 (an 80-byte header's "
            "template)"),
        "search_candidates": KernelStats(
            "search_candidates", "tpuminter/kernels/sha256.py:371 (any double-SHA template)"),
        "search_candidates_header": KernelStats(
            "search_candidates_header", "tpuminter/kernels/sha256.py:371 (an 80-byte header's "
            "template)"),
        "search_candidates_hdr": KernelStats(
            "search_candidates_hdr", "tpuminter/kernels/sha256.py:489"),
        "search_candidates_hdr_batch": KernelStats(
            "search_candidates_hdr_batch", "tpuminter/kernels/sha256.py:606 (sched=False)"),
        "search_candidates_hdr_batch_sched": KernelStats(
            "search_candidates_hdr_batch_sched", "tpuminter/kernels/sha256.py:606 (sched=True)"),
        "min_toy": KernelStats("min_toy", "tpuminter/kernels/sha256.py:733 (any other template)"),
        "min_toy_toy": KernelStats(
            "min_toy_toy", "tpuminter/kernels/sha256.py:733 (a toy template)"),
        "extranonce_roll": KernelStats(
            "extranonce_roll", "tpuminter/ops/merkle.py:84 (jnp program, no pallas_call)"),
        "splitmix_batch": KernelStats(
            "splitmix_batch", "tpuminter/kernels/splitmix.py:65",
            "tpuminter_torch/kernels/csrc/splitmix.cu"),
        "scrypt_front": KernelStats(
            "scrypt_front", "tpuminter/ops/scrypt.py:241-285 (PBKDF2-in) + :190-194 (ROMix "
            "fill), jnp program, no pallas_call", "tpuminter_torch/kernels/csrc/scrypt.cu"),
        "romix_walk": KernelStats(
            "romix_walk", "scripts/walk_pallas_probe.py:106 (fused_step; pallas_call :107)",
            "tpuminter_torch/kernels/csrc/scrypt.cu"),
        "scrypt_back": KernelStats(
            "scrypt_back", "tpuminter/ops/scrypt.py:289-294 (PBKDF2-out) + "
            "tpuminter/jax_worker.py:64 (_scrypt_step fold), jnp program, no pallas_call",
            "tpuminter_torch/kernels/csrc/scrypt.cu"),
        "row_gather": KernelStats(
            "row_gather", "scripts/romix_pallas_probe.py:35 (build_gather_kernel; "
            "pallas_call :78)", "tpuminter_torch/kernels/csrc/scrypt.cu"),
    }
    genesis = chain.GENESIS_HEADER
    hdr = ops.header_template(genesis.pack())
    target = chain.bits_to_target(genesis.bits)
    tw = [int(w) for w in ops.target_to_words(target)]
    data60 = rng.integers(0, 256, 60, dtype=np.uint8).tobytes()
    toy60 = ops.toy_template(data60)
    short = TOY_SHORT
    toy_short = ops.toy_template(short)
    rng2 = np.random.default_rng(SEED + 5)  # the arms' extra inputs; rng's draws stay as they were

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

    # K3, both arms: known winners at known offsets, masking, and seeded
    # windows. A header template takes the header arm, and its
    # generic_form the generic kernel.
    st, sth = stats["search_candidates"], stats["search_candidates_header"]
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
        want = K.search_candidates_plain(tmpl, base, n, tw[1], device=dev)
        before = K.search_candidates_header.launches
        got = K.search_candidates(tmpl, base, n, tw[1], device=dev)
        if K.search_candidates_header.launches != before + 1:
            fail("a header template did not take K3's header arm")
        sth.agree(got, want, f"base {base} n {n}")
        sth.agree(got, K.search_candidates_header_plain(ops.header_words(tmpl), base, n, tw[1],
                                                         device=dev),
                  f"base {base} n {n}, the header arm's plain version")
        st.agree(K.search_candidates(generic_form(tmpl), base, n, tw[1], device=dev), want,
                 f"base {base} n {n}")
        if expect is not None and got.cpu().tolist() != expect:
            fail(f"search_candidates base {base} n {n}: {got.tolist()} != {expect}")
    say(f"  search_candidates, both arms: {len(cases)} windows equal to plain; genesis at offset "
        "1000, block 1 at 5000")
    two, msg, found = two_block_candidate(K, ops, rng, dev)
    if chain.hash_to_int(chain.dsha256(msg[:60] + struct.pack("<I", found) + msg[64:])) >> 224:
        fail(f"two-block template: nonce {found} is not a candidate by hashlib")
    base = max(found - 1000, found >> 30 << 30)  # the kernel found no earlier one there
    for b, n in ((base, 4096), (base, found - base + 1), (found + 1, 4096),
                 (int(rng.integers(0, 1 << 32)), CHECK_N)):
        before = K.search_candidates.launches
        got = K.search_candidates(two, b, n, M32, device=dev)
        if K.search_candidates.launches != before + 1:
            fail("a two-block template did not take K3's generic kernel")
        st.agree(got, K.search_candidates_plain(two, b, n, M32, device=dev),
                 f"two-block template, base {b} n {n}")
        if b == base and got.cpu().tolist() != [1, found - base]:
            fail(f"two-block template: {got.tolist()} misses the candidate at {found}")
    say(f"  search_candidates, generic arm: a 100-byte double-SHA template (two tail blocks), "
        f"its first candidate {found} (hashlib-checked) and 4 windows equal to plain")

    # K2, both arms: a regtest target (an early hit, compared up to it),
    # target 0 (nothing hits: the minimum covers the window) and an
    # exhausted window's exact min. A header template takes the header
    # arm, and its generic_form the generic kernel.
    st, sth = stats["search_target"], stats["search_target_header"]
    regtest = chain.BlockHeader.unpack(genesis.pack()[:72] + struct.pack("<I", REGTEST_BITS) + b"\0" * 4)
    rt = ops.header_template(regtest.pack())
    rtw = [int(w) for w in ops.target_to_words(chain.bits_to_target(REGTEST_BITS))]
    exhausted = GENESIS_NONCE - CHECK_N - 10
    for tmpl, words, base, what in ((rt, rtw, 0, "regtest"),
                                    (hdr, [0] * 8, int(rng2.integers(0, 1 << 32)), "target 0"),
                                    (hdr, tw, exhausted, "exhausted window")):
        want = K.search_target_plain(tmpl, words, base, CHECK_N, device=dev)
        cut = 2 if int(want[0]) else 11  # a hit's min covers only what was swept
        before = K.search_target_header.launches
        got = K.search_target(tmpl, words, base, CHECK_N, device=dev)
        if K.search_target_header.launches != before + 1:
            fail("a header template did not take K2's header arm")
        sth.agree(got[:cut], want[:cut], what)
        sth.agree(got[:cut], K.search_target_header_plain(
            ops.header_words(tmpl), words, base, CHECK_N, device=dev)[:cut],
            f"{what}, the header arm's plain version")
        before = K.search_target.launches
        st.agree(K.search_target(generic_form(tmpl), words, base, CHECK_N, device=dev)[:cut],
                 want[:cut], what)
        if K.search_target.launches != before + 1:
            fail("a generic form did not take K2's generic kernel")
        if what == "regtest" and int(got[0]) != 1:
            fail("search_target found no regtest winner")
    row = got.cpu().tolist()
    value = int.from_bytes(b"".join(struct.pack(">I", w) for w in row[2:10]), "big")
    nonce = exhausted + row[10]
    if row[0] != 0 or value != chain.hash_to_int(genesis.with_nonce(nonce).block_hash()):
        fail("search_target exhausted-window minimum disagrees with hashlib")
    # the header arm at a target whose word 0 ties the minimum's: equal to
    # it (the minimum is the first hit) and one below (nothing hits)
    for delta, expect in ((0, [1, row[10]]), (-1, [0, K.NOT_FOUND])):
        words = [int(w) for w in ops.target_to_words(value + delta)]
        got = K.search_target(hdr, words, exhausted, CHECK_N, device=dev)
        cut = 2 if delta == 0 else 11
        sth.agree(got[:cut], K.search_target_plain(hdr, words, exhausted, CHECK_N,
                                                   device=dev)[:cut],
                  f"the exhausted window's minimum {delta:+d} as the target")
        if got[:2].cpu().tolist() != expect:
            fail(f"search_target at the window's minimum {delta:+d}: {got[:2].tolist()}")
    say("  search_target, both arms: regtest hit, target 0 and exhausted 2^20 windows equal to "
        "plain; min equal to hashlib; the header arm at the min as the target and one below")

    # K6, both arms: short and block-straddling messages, a base_lo wrap,
    # padding spilling into a second block (52 bytes) and a low word
    # straddling the blocks (58), and the main path's MIN message. A toy
    # template takes the toy arm, and its generic_form the generic kernel.
    st, stt = stats["min_toy"], stats["min_toy_toy"]
    data52, data58 = rng2.bytes(52), rng2.bytes(58)
    cases = (
        (short, 0),
        (data60, int(rng.integers(0, 1 << 62))),
        (short, (7 << 32) | ((1 << 32) - (1 << 19))),
        (data52, int(rng2.integers(0, 1 << 62))),
        (data58, int(rng2.integers(0, 1 << 62))),
        (MIN_DATA, 0),
    )
    for data, base in cases:
        tmpl = ops.toy_template(data)
        hi, lo = base >> 32, base & M32
        want = K.min_toy_plain(tmpl, hi, lo, CHECK_N, device=dev)
        before = K.min_toy_toy.launches
        got = K.min_toy(tmpl, hi, lo, CHECK_N, device=dev)
        if K.min_toy_toy.launches != before + 1:
            fail("a toy template did not take K6's toy arm")
        what = f"{len(data)} bytes, base {base}"
        stt.agree(got, want, what)
        stt.agree(got, K.min_toy_toy_plain(ops.toy_words(tmpl), hi, lo, CHECK_N, device=dev),
                  f"{what}, the toy arm's plain version")
        before = K.min_toy.launches
        st.agree(K.min_toy(generic_form(tmpl), hi, lo, CHECK_N, device=dev), want, what)
        if K.min_toy.launches != before + 1:
            fail("a generic form did not take K6's generic kernel")
        fh, fl, off = got.cpu().tolist()
        if (fh << 32) | fl != chain.toy_hash(data, base + off):
            fail(f"min_toy {what}: fold disagrees with toy_hash")
    # every nonce offset len(data) % 64, so every instantiation of the toy
    # arm and every byte shift of its low word: o and 64 + o bytes, the
    # latter across a base_lo wrap
    for o in range(64):
        for data, base in ((rng2.bytes(o), int(rng2.integers(0, 1 << 62))),
                           (rng2.bytes(64 + o),
                            (int(rng2.integers(0, M32)) << 32) | ((1 << 32) - OFFSET_N // 2))):
            hi, lo = base >> 32, base & M32
            before = K.min_toy_toy.launches
            got = K.min_toy(ops.toy_template(data), hi, lo, OFFSET_N, device=dev)
            if K.min_toy_toy.launches != before + 1:
                fail("a toy template did not take K6's toy arm")
            what = f"{len(data)} bytes, base {base}"
            stt.agree(got, K.min_toy_plain(ops.toy_template(data), hi, lo, OFFSET_N,
                                           device=dev), what)
            fh, fl, off = got.cpu().tolist()
            if (fh << 32) | fl != chain.toy_hash(data, base + off):
                fail(f"min_toy {what}: fold disagrees with toy_hash")
    say(f"  min_toy, both arms: {len(cases)} windows of 2^20 (13, 60, 52, 58 and the main "
        f"path's {len(MIN_DATA)} bytes, a base_lo wrap) equal to plain; the toy arm at every "
        f"len(data) % 64 (o and 64 + o bytes, the latter across a wrap; 2^16 nonces) equal "
        "to plain; folds equal to toy_hash")

    rolled = rolled_kernel_checks(dev, rng, stats, tw[1])
    torch.cuda.empty_cache()  # the timings below start from a clean allocator

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
            hdr, lambda: K.search_target(generic_form(hdr), [0] * 8, base, n, device=dev),
            lambda: K.search_target_plain(hdr, [0] * 8, base, n, device=dev), 88),
        "search_target_header": (
            hdr, lambda: K.search_target(hdr, [0] * 8, base, n, device=dev),
            lambda: K.search_target_header_plain(ops.header_words(hdr), [0] * 8, base, n,
                                                 device=dev), 88),
        "search_candidates": (
            hdr, lambda: K.search_candidates(generic_form(hdr), base, n, 0, device=dev),
            lambda: K.search_candidates_plain(hdr, base, n, 0, device=dev), 16),
        "search_candidates_header": (
            hdr, lambda: K.search_candidates(hdr, base, n, 0, device=dev),
            lambda: K.search_candidates_header_plain(ops.header_words(hdr), base, n, 0,
                                                     device=dev), 16),
        "min_toy": (
            toy_short, lambda: K.min_toy(generic_form(toy_short), 0, base, n, device=dev),
            lambda: K.min_toy_plain(toy_short, 0, base, n, device=dev), 24),
        "min_toy_toy": (
            toy_short, lambda: K.min_toy(toy_short, 0, base, n, device=dev),
            lambda: K.min_toy_toy_plain(ops.toy_words(toy_short), 0, base, n, device=dev), 24),
    }
    sms, clock_mhz, int_rate = issue_rate(dev)
    say(f"  bound: {sms} SMs x {ISSUE_LANES_PER_SM} integer lanes x {clock_mhz} MHz = "
        f"{int_rate:.4e} op/s (INT32 pipe alone: half); memory {MEM_BYTES_PER_S:.3e} B/s")
    for name, (tmpl, kernel, plain, nbytes) in runs.items():
        ms, got = event_ms(kernel, 5)
        plain_ms, want = event_ms(plain, 1, warmup=False)
        stats[name].agree(got, want, f"slab of {n}")
        per_nonce, per_row = op_count(name, tmpl)
        record(stats[name], n, n, ms, plain_ms, nbytes, per_nonce, per_nonce * n + per_row,
               int_rate)
    # both K6 kernels on the 60-byte template, whose nonce straddles two
    # tail blocks (the toy arm folds the first on the host)
    per_nonce, _ = op_count("min_toy", toy60)
    for name, tmpl in (("min_toy", generic_form(toy60)), ("min_toy_toy", toy60)):
        ms, got = event_ms(lambda: K.min_toy(tmpl, 0, base, n, device=dev), 5)
        t = stats[name].timing
        t["toy60_ms"], t["toy60_bound_ms"] = ms, per_nonce * n / int_rate * 1e3
        say(f"  {name} on the 60-byte template: {ms:.4f} ms/launch at n={n} "
            f"({n / ms / 1e6:.3f} GH/s), bound {t['toy60_bound_ms']:.4f} ms")
    stats["min_toy"].agree(K.min_toy(generic_form(toy60), 0, base, n, device=dev), got,
                           f"the 60-byte template, slab of {n}, against the toy arm")
    del big_hi, big_lo
    torch.cuda.empty_cache()
    time_rolled_kernels(dev, rng, stats, rolled, int_rate, tw[1])
    torch.cuda.empty_cache()
    splitmix_kernel_checks(dev, rng, stats["splitmix_batch"], int_rate)
    torch.cuda.empty_cache()
    return stats, scrypt_kernel_checks(dev, rng, stats, int_rate)


def generic_form(template):
    """The same template with its nonce bytes listed in reverse order: the
    same function, in a form ``ops.header_words`` does not take, so that
    K3's generic kernel runs on a header's template."""
    return dataclasses.replace(template, positions=template.positions[::-1])


def two_block_candidate(K, ops, rng, dev):
    """(template, message, nonce): a double SHA over a seeded 100-byte
    message with a little-endian nonce at bytes 60-63, so its template
    keeps two tail blocks and takes K3's generic kernel, and the lowest
    candidate nonce (top 32 hash bits zero) of the first such message
    that has one, found by the kernel over [0, 2^32) in 2^30-nonce
    launches."""
    for _ in range(8):
        msg = rng.bytes(60) + bytes(4) + rng.bytes(36)
        two = ops._build_template(msg, 60, [(j, 8 * j) for j in range(4)], double=True)
        if len(two.tail) != 2 or ops.header_words(two) is not None:
            fail("the 100-byte template is not a two-tail-block generic template")
        for chunk in range(4):
            found, off = K.search_candidates(two, chunk << 30, 1 << 30, M32,
                                             device=dev).tolist()
            if found:
                return two, msg, (chunk << 30) + off
    fail("no seeded 100-byte message had a candidate nonce")


def record(st, n, plain_n, ms, plain_ms, nbytes, per_unit, ops_total, int_rate,
           unit="nonce") -> None:
    """A kernel's timing row: its time beside its plain version's and
    its bound, the larger of its bytes over the memory rate and its
    counted instructions over the integer issue rate."""
    from tpuminter_torch.probes._common import MEM_BYTES_PER_S

    ops_ms = ops_total / int_rate * 1e3
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    st.timing = dict(
        n=n, plain_n=plain_n, ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms > ops_ms else "operations", ops_per_nonce=per_unit,
        int32_pipe_ms=ops_ms * ISSUE_LANES_PER_SM / INT32_LANES_PER_SM,
    )
    rate = {"nonce": f"{n / ms / 1e6:.3f} GH/s",
            "index": f"{n / ms / 1e6:.3f} G indices/s",
            "hash": f"{n / ms / 1e3:.4f} MH/s",
            "row": f"{n / ms / 1e6:.3f} G rows/s"}.get(unit, f"{n} {unit}s")
    say(f"  {st.name}: {ms:.4f} ms/launch at n={n} ({rate}), plain "
        f"{plain_ms:.1f} ms at n={plain_n}, bound {max(bytes_ms, ops_ms):.4f} ms, INT32 "
        f"pipe alone {ops_ms * ISSUE_LANES_PER_SM / INT32_LANES_PER_SM:.4f} ms "
        f"({per_unit} op/{unit})")


def i64(values, dev):
    return torch.tensor([int(v) for v in values], dtype=torch.int64, device=dev)


def mainnet_template(rng):
    """A mainnet block template's shape, from the seed: a 250-byte
    coinbase with a 4-byte extranonce, and a 12-deep Merkle branch."""
    return rng.bytes(120), rng.bytes(126), tuple(rng.bytes(32) for _ in range(12))


def host_rows(header80, prefix, suffix, size, branch, ens, ops, chain):
    """(midstates, tail words) of each extranonce's header, by hashlib."""
    cb = chain.CoinbaseTemplate(prefix, suffix, size)
    mids, tails = [], []
    for e in ens:
        t = ops.header_template(chain.rolled_header(header80, cb, branch, e).pack())
        mids.append(list(t.midstate))
        tails.append(list(t.tail[0][:3]))
    return mids, tails


#: the roll's checks across the shapes its host-side placement must get
#: right: extranonce sizes, coinbase prefixes that put the extranonce at
#: tail byte 56 (the mainnet template's: word-aligned), 58 (a 4-byte one
#: crosses a word, an 8-byte one the block) and 63 (every size but 1
#: crosses the block), both branch depths, and a launch's rows (1, a
#: window's 2, 7, roll_batch + 2)
ROLL_SIZES, ROLL_PREFIXES, ROLL_DEPTHS, ROLL_ROW_COUNTS = (1, 4, 8), (120, 122, 127), (12, 0), (
    1, 2, 7, 10)


def roll_shape_checks(dev, st, genesis, K, merkle, ops, chain) -> str:
    """R against its plain version at every shape of the lists above, on
    seeded 64-bit extranonces (bytes past the size set: the kernel must
    drop them as the plain version does), and the first two rows of each
    job against hashlib."""
    rng = np.random.default_rng(SEED + 6)
    jobs = 0
    for size in ROLL_SIZES:
        for plen in ROLL_PREFIXES:
            for depth in ROLL_DEPTHS:
                parts = (rng.bytes(plen), rng.bytes(126), size,
                         tuple(rng.bytes(32) for _ in range(depth)))
                job = merkle.build_roll(genesis, *parts)
                ens = [int(e) for e in rng.integers(0, 1 << 63, max(ROLL_ROW_COUNTS))]
                hi, lo = i64([e >> 32 for e in ens], dev), i64([e & M32 for e in ens], dev)
                want = K.extranonce_roll_plain(job, hi, lo)
                for rows in ROLL_ROW_COUNTS:
                    got = K.extranonce_roll(job, hi[:rows], lo[:rows])
                    for g, w, what in zip(got, want, ("midstates", "tail words")):
                        st.agree(g, w[:rows], f"size {size}, prefix {plen}, {depth}-deep, "
                                 f"{rows} rows: {what}")
                short = [e % (1 << 8 * size) for e in ens[:2]]
                if [t[:2].cpu().tolist() for t in want] != list(
                        host_rows(genesis, *parts, short, ops, chain)):
                    fail(f"extranonce_roll plain, size {size}, prefix {plen}, {depth}-deep: "
                         "not hashlib's")
                jobs += 1
    return (f"{jobs} jobs (sizes {ROLL_SIZES}, prefixes {ROLL_PREFIXES}, depths {ROLL_DEPTHS}) "
            f"at {ROLL_ROW_COUNTS} rows equal to plain, 2 rows each to hashlib")


def rolled_kernel_checks(dev, rng, stats, hw1_cap):
    """The roll, K4 and both K5 arms against their plain versions (and
    the roll against hashlib) on the genesis block as a rolled job and a
    mainnet-shaped template."""
    from tpuminter_torch import chain, rolled
    from tpuminter_torch.kernels import sha256 as K
    from tpuminter_torch.ops import merkle
    from tpuminter_torch.ops import sha256 as ops

    genesis = chain.GENESIS_HEADER.pack()
    cb = bytes.fromhex(GENESIS_COINBASE_HEX)
    g_job = merkle.build_roll(genesis, cb[:48], cb[49:], 1, ())
    prefix, suffix, branch = mainnet_template(rng)
    m_job = merkle.build_roll(genesis, prefix, suffix, 4, branch)
    e_job = merkle.build_roll(genesis, prefix, suffix, 4, ())

    st = stats["extranonce_roll"]
    cases = ((g_job, (cb[:48], cb[49:], 1, ()), [3, 4, 5]),
             (m_job, (prefix, suffix, 4, branch), [0, 1, 2, 3, 0xFFFFFFFF]),
             (e_job, (prefix, suffix, 4, ()), [0, 7, 0xDEADBEEF]))
    for job, parts, ens in cases:
        hi, lo = i64([e >> 32 for e in ens], dev), i64([e & M32 for e in ens], dev)
        got = K.extranonce_roll(job, hi, lo)
        want = K.extranonce_roll_plain(job, hi, lo)
        for g, w, what in zip(got, want, ("midstates", "tail words")):
            st.agree(g, w, f"{len(parts[3])}-deep {what}")
        host = host_rows(genesis, *parts, ens, ops, chain)
        if [t.cpu().tolist() for t in got] != list(host):
            fail(f"extranonce_roll {len(parts[3])}-deep branch disagrees with hashlib")
    g_mids, g_tails = K.extranonce_roll(g_job, i64([0], dev), i64([4], dev))
    if [g_mids[0].tolist(), g_tails[0].tolist()] != [
            list(ops.header_template(genesis).midstate), list(ops.header_template(genesis).tail[0][:3])]:
        fail("extranonce 4 of the genesis coinbase does not roll to the genesis header")
    shapes = roll_shape_checks(dev, st, genesis, K, merkle, ops, chain)
    say("  extranonce_roll: 12-deep and empty branches equal to plain and to hashlib; "
        f"extranonce 4 of the genesis coinbase rolls to the genesis header; {shapes}")

    st = stats["search_candidates_hdr"]
    m_mids, m_tails = K.extranonce_roll(m_job, i64([0, 0], dev), i64([0, 1], dev))
    k4_cases = [
        (g_mids[0], g_tails[0], GENESIS_NONCE - 1000, 4096, [1, 1000]),
        (g_mids[0], g_tails[0], GENESIS_NONCE - 4095, 4096, [1, 4095]),
        (g_mids[0], g_tails[0], GENESIS_NONCE - 4095, 4095, [0, K.NOT_FOUND]),
    ]
    k4_cases += [(m_mids[i % 2], m_tails[i % 2], int(rng.integers(0, 1 << 32)), CHECK_N, None)
                 for i in range(3)]
    for mid, tail, base, n, expect in k4_cases:
        got = K.search_candidates_hdr(mid, tail, base, n, hw1_cap)
        st.agree(got, K.search_candidates_hdr_plain(mid, tail, base, n, hw1_cap),
                 f"base {base} n {n}")
        if expect is not None and got.cpu().tolist() != expect:
            fail(f"search_candidates_hdr base {base} n {n}: {got.tolist()} != {expect}")
    say(f"  search_candidates_hdr: {len(k4_cases)} windows equal to plain; genesis as a "
        "rolled job at offsets 1000 and 4095, masked by n")

    # a mainnet-shaped plan: extranonces 0-2 over full rows, a ragged row,
    # the genesis row with its winner, padding rows
    mids, tails = K.extranonce_roll(
        m_job, i64([0] * 4, dev), i64([0, 1, 2, 2], dev))
    mids = torch.cat([mids, g_mids, torch.zeros((2, 8), dtype=torch.int64, device=dev)])
    tails = torch.cat([tails, g_tails, torch.zeros((2, 3), dtype=torch.int64, device=dev)])
    bases = i64([int(rng.integers(0, 1 << 32)) for _ in range(4)]
                + [GENESIS_NONCE - 1000, 0, 0], dev)
    valids = i64([CHECK_N] * 3 + [12345, CHECK_N, 0, 0], dev)
    arms = []
    for name, sched in (("search_candidates_hdr_batch", False),
                        ("search_candidates_hdr_batch_sched", True)):
        got = getattr(K, name)(mids, tails, bases, valids, CHECK_N, hw1_cap)
        stats[name].agree(got, K.search_candidates_hdr_batch_plain(
            mids, tails, bases, valids, CHECK_N, hw1_cap, sched=sched), "mainnet-shaped plan")
        arms.append(got)
        goffs = i64([k * CHECK_N for k in range(7)], dev)
        if rolled.fold_rows(got, goffs).tolist() != [1, 4 * CHECK_N + 1000]:
            fail(f"{name}: the genesis row's winner is not the plan's first candidate")
    if not torch.equal(arms[0], arms[1]):
        fail("the two arms of search_candidates_hdr_batch disagree")
    say("  search_candidates_hdr_batch, both arms: a 7-row plan (3 extranonces, a ragged "
        "row, the genesis row, 2 padding rows) equal to plain and to each other")
    return dict(m_job=m_job, m_mids=m_mids, m_tails=m_tails, g_mid=g_mids[0], g_tail=g_tails[0])


def time_rolled_kernels(dev, rng, stats, rolled, int_rate, hw1_cap):
    """K4 at the main path's slab, both K5 arms at its width (8 rows of
    2^27 nonces of one extranonce) and the roll at its rows (a window's
    extranonce and the padding rows' extranonce 0), each timed
    candidate-free (cap 0: no early exit) beside its bound. The plain
    versions run at the job's real cap on inputs that hold a winner, and
    each kernel must equal its plain version there: K4 over 2^26 nonces
    with the genesis nonce in the middle; each K5 arm on a plan of the
    main path's shape (width 2^27, roll_batch + 2 = 10 rows): six
    2^23-nonce rows of the mainnet-shaped template, a ragged row, the
    genesis row with its winner 2^22 in, two padding rows."""
    from tpuminter_torch import chain
    from tpuminter_torch.cuda_worker import DEFAULT_SLAB
    from tpuminter_torch.kernels import sha256 as K
    from tpuminter_torch.probes._common import time_ms

    n = DEFAULT_SLAB
    chunk = K.PLAIN_CHUNK["cuda"]
    genesis = chain.GENESIS_HEADER

    def swept(handle, valids):
        """Nonces the plain version hashed: its chunks up to each row's
        first candidate."""
        total = 0
        for (found, off), valid in zip(handle.tolist(), valids):
            total += min(valid, -(-(off + 1) // chunk) * chunk) if found else valid
        return total

    def genesis_candidate(base, handle, what):
        found, off = handle.tolist()
        value = chain.hash_to_int(genesis.with_nonce((base + off) & M32).block_hash())
        if not found or value >> 224 or (value >> 192) & M32 > hw1_cap:
            fail(f"{what}: no hashlib-checked candidate in the genesis row")

    mid, tail = rolled["m_mids"][0], rolled["m_tails"][0]
    g_mid, g_tail = rolled["g_mid"], rolled["g_tail"]
    base = int(rng.integers(0, (1 << 32) - n))
    mids, tails = mid.repeat(ROWS, 1).contiguous(), tail.repeat(ROWS, 1).contiguous()
    bases = i64([k * n for k in range(ROWS)], dev)
    valids = i64([n] * ROWS, dev)
    # the comparison plan at the main path's shape
    p_mids, p_tails = K.extranonce_roll(rolled["m_job"], i64([0] * 7, dev), i64(range(7), dev))
    zeros = torch.zeros((2, 8), dtype=torch.int64, device=dev)
    p_mids = torch.cat([p_mids, g_mid[None], zeros])
    p_tails = torch.cat([p_tails, g_tail[None], zeros[:, :3]])
    genesis_base = GENESIS_NONCE - PLAIN_ROW_N // 2
    p_base_list = [int(rng.integers(0, 1 << 32)) for _ in range(7)] + [genesis_base, 0, 0]
    p_valid_list = [PLAIN_ROW_N] * 6 + [PLAIN_ROW_N - 12345, PLAIN_ROW_N, 0, 0]
    p_bases, p_valids = i64(p_base_list, dev), i64(p_valid_list, dev)
    k4_n = ROWS * PLAIN_ROW_N
    k4_base = GENESIS_NONCE - k4_n // 2

    per_nonce, per_row = op_count("search_candidates_hdr")
    ms, _ = event_ms(lambda: K.search_candidates_hdr(mid, tail, base, n, 0), 5)
    plain_ms, want = event_ms(
        lambda: K.search_candidates_hdr_plain(g_mid, g_tail, k4_base, k4_n, hw1_cap), 1,
        warmup=False)
    got = K.search_candidates_hdr(g_mid, g_tail, k4_base, k4_n, hw1_cap)
    stats["search_candidates_hdr"].agree(got, want, f"{k4_n} nonces around the genesis nonce")
    genesis_candidate(k4_base, got, "search_candidates_hdr")
    record(stats["search_candidates_hdr"], n, swept(want[None], [k4_n]), ms, plain_ms,
           16 + 88, per_nonce, per_nonce * n + per_row, int_rate)
    for name, sched in (("search_candidates_hdr_batch", False),
                        ("search_candidates_hdr_batch_sched", True)):
        fn = getattr(K, name)
        ms, _ = event_ms(lambda: fn(mids, tails, bases, valids, n, 0), 5)
        plain_ms, want = event_ms(lambda: K.search_candidates_hdr_batch_plain(
            p_mids, p_tails, p_bases, p_valids, n, hw1_cap, sched=sched), 1, warmup=False)
        got = fn(p_mids, p_tails, p_bases, p_valids, n, hw1_cap)
        stats[name].agree(got, want, "10-row plan of width 2^27 at the real cap")
        genesis_candidate(genesis_base, got[7], name)
        if got[8:].tolist() != [[0, K.NOT_FOUND]] * 2:
            fail(f"{name}: a padding row reported a candidate")
        record(stats[name], ROWS * n, swept(want, p_valid_list), ms, plain_ms,
               ROWS * (13 * 8 + 16), per_nonce, (per_nonce * n + per_row) * ROWS, int_rate)

    job = rolled["m_job"]
    en_hi, en_lo = i64([0, 0], dev), i64([1, 0], dev)
    paced_ms, got = event_ms(lambda: K.extranonce_roll(job, en_hi, en_lo), 20)
    ms = time_ms(lambda: K.extranonce_roll(job, en_hi, en_lo), dev)
    hi10, lo10 = i64([0] * 10, dev), i64(range(10), dev)
    ms10 = time_ms(lambda: K.extranonce_roll(job, hi10, lo10), dev)
    plain_ms, want = event_ms(lambda: K.extranonce_roll_plain(job, en_hi, en_lo), 1,
                              warmup=False)
    for g, w in zip(got, want):
        stats["extranonce_roll"].agree(g, w, "2 rows, 12-deep")
    # the serial floor: one row's chain of compressions, no loads
    n_blocks, depth = len(job.coinbase.tail), len(job.branch)
    compressions = n_blocks + 1 + 3 * depth + 1
    if K.serial_floor(n_blocks, depth, dev).tolist() != K.serial_floor_plain(n_blocks, depth):
        fail("the roll's serial floor differs from its plain version")
    floor_ms = time_ms(lambda: K.serial_floor(n_blocks, depth, dev), dev)
    per_row = roll_op_count(job)
    record(stats["extranonce_roll"], 2, 2, ms, plain_ms, 4 * len(job.words()) + 2 * 8 * 13,
           per_row, 2 * per_row, int_rate, unit="row")
    stats["extranonce_roll"].timing.update(paced_ms=paced_ms, ms_10_rows=ms10,
                                           serial_floor_ms=floor_ms, compressions=compressions)
    say(f"  extranonce_roll paced by the host (20 calls back to back): {paced_ms:.4f} ms a call; "
        f"10 rows {ms10:.4f} ms; serial floor ({compressions} compressions, one row, no loads) "
        f"{floor_ms:.4f} ms, {floor_ms / ms:.1%} of the roll's time")


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

    reset_launches(kernels)
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
    rates = {"fast": res.searched / dt / 1e9}
    say(f"  genesis: nonce {res.nonce} hash {chain.hash_to_hex(digest)}{note}; "
        f"{res.searched} nonces in {dt:.3f} s = {rates['fast']:.3f} GH/s on {card}")
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
    rates["exact_min"] = res.searched / dt / 1e9
    say(f"  exact-min 2^27 window: found={res.found} nonce {res.nonce}, hashlib-checked; "
        f"{rates['exact_min']:.3f} GH/s on {card}")
    # MIN over 2^30 nonces
    data = MIN_DATA
    t0 = time.perf_counter()
    res = drain(miner.mine(Request(4, PowMode.MIN, 0, (1 << 30) - 1, data=data)))
    dt = time.perf_counter() - t0
    if res.hash_value != chain.toy_hash(data, res.nonce):
        fail("MIN: reported fold is not toy_hash of the reported nonce")
    rates["min"] = (1 << 30) / dt / 1e9
    say(f"  MIN 2^30: nonce {res.nonce} fold {res.hash_value:#018x}, toy_hash-checked; "
        f"{rates['min']:.3f} GH/s on {card}")
    return read_launches(kernels, FIXED_PATH_KERNELS, "fixed-header", FIXED_PATH_GENERIC), rates


def kernel_label(name: str) -> str:
    """A traced kernel's demangled name without its return type, its
    anonymous namespace and its parameter list: ``void (anonymous
    namespace)::k<true>(TmHeader, unsigned int)`` → ``k<true>``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[5:] if name.startswith("void ") else name


def phase_profiled_chunk():
    """One fast-path chunk (phase 4a's genesis window) through
    ``ProfiledMiner(CudaMiner())``, stepped and closed on this thread:
    its Result must equal the unwrapped miner's, and it must write a
    trace. Phase 5 reads the trace of the worker process's own
    ``--profile`` run. Returns the launches."""
    import tempfile

    from tpuminter_torch import chain, kernels
    from tpuminter_torch.cuda_worker import CudaMiner
    from tpuminter_torch.protocol import PowMode, Request
    from tpuminter_torch.worker import ProfiledMiner

    genesis = chain.GENESIS_HEADER
    req = Request(1, PowMode.TARGET, GENESIS_NONCE - (1 << 30) + 1, GENESIS_NONCE + 4095,
                  header=genesis.pack(), target=chain.bits_to_target(genesis.bits))
    want = drain(CudaMiner().mine(req))
    reset_launches(kernels)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as trace_dir:
        miner = ProfiledMiner(CudaMiner(), trace_dir)
        results = [item for item in miner.mine(req) if item is not None]
        miner.close()
        launches = read_launches(kernels, ("search_candidates_header",), "profiled fast-path")
        if results != [want]:
            fail(f"the profiled chunk's Result {results} differs from the unwrapped miner's "
                 f"{want}")
        if miner.trace_path is None:
            fail("ProfiledMiner wrote no trace")
    say("  profiled genesis chunk: Result equal to the unwrapped miner's, trace written")
    return launches


def worker_trace(log_path: str, trace_dir: str, card: str) -> dict:
    """The trace a ``--profile`` worker process wrote into ``trace_dir``
    (its log says when): it must hold 3h's kernel events. Prints each
    kernel of the window with its launches and summed device time;
    returns them with the window's span."""
    deadline = time.time() + 60
    while "wrote the trace" not in open(log_path).read():
        if time.time() > deadline:
            fail(f"the --profile worker wrote no trace into {trace_dir}")
        time.sleep(0.2)
    paths = [name for name in os.listdir(trace_dir) if name.endswith(".pt.trace.json")]
    if len(paths) != 1:
        fail(f"the --profile worker wrote {paths} into {trace_dir}, not one trace")
    with open(os.path.join(trace_dir, paths[0])) as fh:
        events = json.load(fh)["traceEvents"]
    kernels_us: dict = {}
    for ev in events:
        if ev.get("cat") == "kernel":
            name = kernel_label(ev["name"])
            n, us = kernels_us.get(name, (0, 0.0))
            kernels_us[name] = (n + 1, us + float(ev.get("dur", 0)))
    if not any("search_candidates_header_kernel" in k for k in kernels_us):
        fail(f"the worker's trace holds no 3h kernel event: {sorted(kernels_us)}")
    busy = sum(us for _, us in kernels_us.values())
    spans = [(float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0))) for ev in events
             if ev.get("ph") == "X"]
    window_us = max(end for _, end in spans) - min(start for start, _ in spans)
    say(f"  worker --profile trace {paths[0]} ({len(events)} events) of its first chunk's "
        f"steps 1-3 on {card}: the card busy {busy:.1f} us of the window's {window_us:.1f} "
        f"({busy / window_us:.1%})")
    for name, (n, us) in sorted(kernels_us.items(), key=lambda kv: -kv[1][1]):
        say(f"    {name}: {n} launches, {us:.1f} us ({us / busy:.1%} of the window's device "
            "time)")
    return {"window_us": window_us, "kernels": {
        name: {"launches": n, "us": us} for name, (n, us) in kernels_us.items()}}


#: the SASS kernel behind each row of K1-K6, S1 and 19, for its pipe mix
#: (K6's toy arm: its instantiation for the timed message, ``TOY_SHORT``)
PIPE_KERNELS = {
    "sha256_batch": "sha256_batch_kernel", "search_target": "search_target_kernel",
    "search_target_header": "search_target_header_kernel",
    "search_candidates": "search_candidates_kernel",
    "search_candidates_header": "search_candidates_header_kernel",
    "search_candidates_hdr": "search_candidates_hdr_kernel",
    "search_candidates_hdr_batch": "search_candidates_hdr_batch_kernel",
    "search_candidates_hdr_batch_sched": "search_candidates_hdr_batch_kernel<sched>",
    "min_toy": "min_toy_kernel", "min_toy_toy": "min_toy_toy_kernel<{k}>",
    "scrypt_front": "scrypt_front_kernel", "romix_walk": "romix_walk_kernel",
}
#: the MIN message K6 is timed on
TOY_SHORT = b"hello bitcoin"


def pipe_mixes(infos) -> dict:
    """Per row of K1-K6, S1 and 19, its static SASS instructions on
    each issue pipe (``sass.pipe_mix``) for one nonce or one hash: a SHA
    kernel's hot loop runs one nonce a trip (K1 has no loop: its whole
    kernel is one nonce); S1 runs 2^10 fill steps a hash and 19 2^10 walk
    steps, each on four threads, beside the instructions outside its
    loop. Static counts: every branch inside a loop is counted (K2's
    header arm's rounds 61-63 and full compares, which run on few
    nonces, included)."""
    from tpuminter_torch.kernels import scrypt as KS
    from tpuminter_torch.kernels import sass
    from tpuminter_torch.ops import sha256 as ops

    toy_k = ops.toy_launch(ops.toy_words(ops.toy_template(TOY_SHORT)), 0).k

    found = {}
    for lib in ("sha256", "scrypt"):
        text = sass.sass_text(str(infos[lib].path))
        if text is None:
            fail("cuobjdump not found: no pipe mix")
        found.update(sass.pipe_mix(text))
    out = {}
    for row, kernel in PIPE_KERNELS.items():
        kernel = kernel.format(k=toy_k)
        mix = found[kernel]
        loop = mix["loop"] or mix["total"]
        if row in SCRYPT_PATH_KERNELS:
            threads = (KS.FRONT_THREADS_PER_HASH if row == "scrypt_front"
                       else KS.WALK_THREADS_PER_HASH)
            per = {p: threads * (loop[p] * SCRYPT_N + mix["total"][p] - loop[p])
                   for p in sass.PIPES}
            unit = "hash"
        else:
            per, unit = dict(loop), "nonce"
        out[row] = dict(per, unit=unit)
        say(f"  pipes {kernel}: a {unit} {per['alu']} ALU, {per['fma']} FMA (IMAD), "
            f"{per['other']} other; ALU {per['alu'] / max(1, per['alu'] + per['fma']):.1%} of "
            "the integer issue")
    return out


#: the kernels each part of the main path must launch; the generic K2, K3
#: and K6 must not launch on the fixed-header path (every fixed-header
#: job's template takes a header arm, every MIN job's the toy arm)
FIXED_PATH_KERNELS = ("sha256_batch", "search_target_header", "search_candidates_header",
                      "min_toy_toy")
FIXED_PATH_GENERIC = ("search_target", "search_candidates", "min_toy")
ROLLED_PATH_KERNELS = ("sha256_batch", "search_target_header", "search_candidates_hdr",
                       "search_candidates_hdr_batch", "search_candidates_hdr_batch_sched",
                       "extranonce_roll")
#: row_gather (probe 11) is not on it: the miner never launches it
SCRYPT_PATH_KERNELS = ("scrypt_front", "romix_walk", "scrypt_back")


def roll_local_memory(infos) -> None:
    """R keeps every message word in registers: ptxas reports no stack
    frame and no spills for it, and its SASS has no local load or store
    (LDL/STL). Fails otherwise."""
    from tpuminter_torch.kernels import sass

    lines = infos["sha256"].log.splitlines()
    reports = [lines[i + 2].strip() for i, line in enumerate(lines[:-2])
               if "Compiling entry" in line and "extranonce_roll_kernel" in line]
    for report in reports:
        if re.findall(r"(\d+) bytes", report) != ["0", "0", "0"]:
            fail(f"extranonce_roll_kernel uses local memory: {report}")
    counts = sass.sass_summary(str(infos["sha256"].path)) or {}
    local = {k: {op: c for op, c in ops_.items() if op in ("LDL", "STL")}
             for k, ops_ in counts.items() if k.startswith("extranonce_roll_kernel")}
    if not counts or any(local.values()):
        fail(f"extranonce_roll_kernel's SASS: {local or 'not read (no cuobjdump)'}")
    say(f"  extranonce_roll_kernel: {reports or ['(built before: no ptxas report)']}; no LDL/STL "
        "in its SASS")


def wave_report(dev) -> dict:
    """Registers, resident blocks an SM and waves a launch at the main
    path's shape of every grid-stride SHA search kernel (K4 on 2^27
    nonces at its own grid; 3h, 2h and 6t on a 2^27 slab and both K5
    arms on 8 rows of 2^27 at 8 blocks an SM) and of S2 at the SCRYPT
    batch: a launch of a fractional number of waves (above one) runs
    its last wave part-empty."""
    from tpuminter_torch.cuda_worker import DEFAULT_SCRYPT_BATCH, DEFAULT_SLAB
    from tpuminter_torch.kernels import scrypt as KS
    from tpuminter_torch.kernels import sha256 as K
    from tpuminter_torch.ops import sha256 as ops

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = DEFAULT_SLAB
    toy_k = ops.toy_launch(ops.toy_words(ops.toy_template(MIN_DATA)), 0).k
    rows = {name: (which, n * ROWS if name.startswith("search_candidates_hdr_batch") else n)
            for name, which in K.OCCUPANCY_KERNELS.items()}
    rows["min_toy_toy"] = (K.OCCUPANCY_TOY + toy_k, n)
    out = {}
    for name, (which, count) in rows.items():
        resident, regs = K.occupancy(which, dev.index)
        grid = (K.hdr_grid(count, resident, sms) if name == "search_candidates_hdr"
                else K._grid(count, dev.index))
        out[name] = dict(registers=regs, blocks_per_sm=resident, grid=grid,
                         waves=grid / (resident * sms))
    b = DEFAULT_SCRYPT_BATCH["cuda"]
    blocks, regs = KS.occupancy(dev)["scrypt_back"]
    grid = -(-b // KS.THREADS)
    out["scrypt_back"] = dict(registers=regs, blocks_per_sm=blocks, grid=grid,
                              waves=grid / (blocks * sms))
    for name, r in out.items():
        say(f"  occupancy {name}: {r['registers']} registers, {r['blocks_per_sm']} blocks an SM, "
            f"grid {r['grid']} at the path's shape = {r['waves']:.3f} waves")
    return out


def reset_launches(kernels) -> None:
    for fn in kernels.KERNELS:
        fn.launches = 0


def read_launches(kernels, required, path, absent=()):
    launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    say(f"  launches on the {path} path: {launches}")
    for name in required:
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on the {path} path")
    for name in absent:
        if launches[name]:
            fail(f"kernel {name} was launched on the {path} path")
    return launches


def phase_rolled_path(card: str, rng):
    from tpuminter_torch import chain, kernels
    from tpuminter_torch.cuda_worker import CudaMiner
    from tpuminter_torch.protocol import MIN_UNTRACKED, PowMode, Request

    genesis = chain.GENESIS_HEADER
    target = chain.bits_to_target(genesis.bits)
    cb = bytes.fromhex(GENESIS_COINBASE_HEX)

    def check(req, res, what):
        """Re-roll the reported index's header on the host and re-hash."""
        en, nonce = chain.split_global(res.nonce, req.nonce_bits)
        tmpl = chain.CoinbaseTemplate(req.coinbase_prefix, req.coinbase_suffix,
                                      req.extranonce_size)
        hdr = chain.rolled_header(req.header, tmpl, req.branch, en).with_nonce(nonce)
        got = chain.hash_to_int(hdr.block_hash())
        if got != res.hash_value or res.found != (got <= req.target):
            fail(f"{what}: the Result fails the hashlib check")
        return en, nonce

    def mine(miner, req):
        """A Result and its time, up to the end of the device work the
        run launched (a window abandoned in flight above a winner
        included)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = drain(miner.mine(req))
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    reset_launches(kernels)
    # (a) the genesis block as a rolled job, 2^30 + 4095 indices
    req = Request(11, PowMode.TARGET, GENESIS_ROLLED - (1 << 30) + 1, GENESIS_ROLLED + 4095,
                  header=genesis.pack(), target=target, coinbase_prefix=cb[:48],
                  coinbase_suffix=cb[49:], extranonce_size=1, nonce_bits=32)
    res, dt = mine(CudaMiner(), req)
    en, nonce = check(req, res, "genesis as a rolled job")
    if not res.found:
        fail("genesis as a rolled job: no winner")
    note = "" if res.nonce == GENESIS_ROLLED else " (an earlier winner, hashlib-checked)"
    say(f"  genesis as a rolled job: extranonce {en} nonce {nonce}{note}; {res.searched} "
        f"indices in {dt:.3f} s = {res.searched / dt / 1e9:.3f} GH/s on {card}")
    rates = {"genesis_rolled": res.searched / dt / 1e9}
    # (b) a mainnet-shaped template at difficulty 1 over four whole extranonces
    prefix, suffix, branch = mainnet_template(rng)
    req = Request(12, PowMode.TARGET, 0, (4 << 32) - 1, header=genesis.pack(),
                  target=target, coinbase_prefix=prefix, coinbase_suffix=suffix,
                  extranonce_size=4, branch=branch, nonce_bits=32)
    results = []
    for label, miner in (("roll_batch=8, sched on", CudaMiner()),
                         ("roll_batch=8, sched off", CudaMiner(sched_share=False)),
                         ("roll_batch=1 (K4)", CudaMiner(roll_batch=1))):
        res, dt = mine(miner, req)
        en, nonce = check(req, res, f"mainnet-shaped job, {label}")
        results.append(res)
        rates[label] = res.searched / dt / 1e9
        say(f"  mainnet-shaped job, {label}: found={res.found} extranonce {en} nonce "
            f"{nonce}, hashlib-checked; {res.searched} indices in {dt:.3f} s = "
            f"{rates[label]:.3f} GH/s on {card}")
    if any(r != results[0] for r in results):
        fail(f"the mainnet-shaped job's three Results differ: {results}")
    # (b') the same template at target 1 over one whole extranonce: no
    # winner, so every window is swept (the path's sustained rate)
    req = dataclasses.replace(req, job_id=14, lower=5 << 32, upper=(6 << 32) - 1, target=1)
    res, dt = mine(CudaMiner(), req)
    if res.found or res.searched != 1 << 32:
        fail(f"sustained run: unexpected Result {res}")
    if res.hash_value != MIN_UNTRACKED:
        check(req, res, "sustained run")  # the surfaced candidates' minimum
    rates["sustained"] = res.searched / dt / 1e9
    say(f"  mainnet-shaped template, target 1, one whole extranonce: exhausted, "
        f"{res.searched} indices in {dt:.3f} s = {rates['sustained']:.3f} GH/s on {card}")
    # (c) a rolled regtest job: the tracking path
    regtest = genesis.pack()[:72] + struct.pack("<I", REGTEST_BITS) + b"\0" * 4
    req = Request(13, PowMode.TARGET, (4 << 32) - 2048, (4 << 32) + 2047, header=regtest,
                  target=chain.bits_to_target(REGTEST_BITS), coinbase_prefix=prefix,
                  coinbase_suffix=suffix, extranonce_size=4, branch=branch, nonce_bits=32)
    res, _ = mine(CudaMiner(), req)
    en, nonce = check(req, res, "rolled regtest job")
    if not res.found:
        fail("rolled regtest job: no winner")
    say(f"  rolled regtest job (tracking path): extranonce {en} nonce {nonce}, found, "
        "hashlib-checked")
    return read_launches(kernels, ROLLED_PATH_KERNELS, "rolled"), rates



# ---- hashcore (K7) ----------------------------------------------------------

M64 = (1 << 64) - 1
GOLDEN, MIX1, MIX2 = 0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB
#: integer instructions one splitmix64 index needs at the fewest Hopper
#: instructions: index + 1 and + seed, two 64-bit adds (IADD3 with its
#: carry, 2 each); three 64-bit products by constants (IMAD.WIDE.U32 of
#: the low words and two IMADs of the cross terms, 3 each); three 64-bit
#: xor-shifts (two SHF for the shifted words, two LOP3 for the xors, 4
#: each)
SPLITMIX_OPS = 2 * 2 + 3 * 3 + 3 * 4
#: 2^32 hashcore indices from here cross the 5 · 2^32 word boundary
HC_BASE = (5 << 32) - (1 << 31)
HC_N = 1 << 32
#: a first-match run's planted first hit: 2^31 + 12345 indices in, with a
#: value so small that an earlier hit has odds of about 2^-13
HC_PLANT_AT, HC_PLANT_VALUE = (1 << 31) + 12345, 1 << 20
HC_K = 8
#: the ragged numpy-checked runs: 2^24 + 777 indices from just below 3 · 2^40
NP_LO, NP_N = (3 << 40) - 12345, (1 << 24) + 777
#: the window sweep: lanes per row (8 rows a window), indices per run
HC_SWEEP_WIDTHS = tuple(1 << b for b in range(14, 22))
HC_SWEEP_N = 1 << 28


def objective(seed: int, index: int) -> int:
    """The hashcore objective, scalar: splitmix64 of seed + (index + 1) · golden."""
    z = (seed + (index + 1) * GOLDEN) & M64
    z = ((z ^ (z >> 30)) * MIX1) & M64
    z = ((z ^ (z >> 27)) * MIX2) & M64
    return z ^ (z >> 31)


def np_objective(seed: int, idx: np.ndarray) -> np.ndarray:
    """The objective on numpy u64 lanes (mod-2^64 arithmetic)."""
    with np.errstate(over="ignore"):
        z = np.uint64(seed) + (idx + np.uint64(1)) * np.uint64(GOLDEN)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(MIX1)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(MIX2)
        return z ^ (z >> np.uint64(31))


def np_values(seed: int, lo: int, n: int) -> np.ndarray:
    """The objective over ``[lo, lo + n)`` on numpy u64 lanes."""
    return np_objective(seed, np.arange(n, dtype=np.uint64) + np.uint64(lo))


def planted_seed(index: int, value: int) -> int:
    """The seed under which ``objective(seed, index) == value``: the
    mixing after the seed's add is a bijection of u64, so undo it."""
    def unxorshift(x, s):
        y = x
        for _ in range(64 // s + 1):
            y = x ^ (y >> s)
        return y

    z = unxorshift(value, 31) * pow(MIX2, -1, 1 << 64) & M64
    z = unxorshift(z, 27) * pow(MIX1, -1, 1 << 64) & M64
    z = unxorshift(z, 30)
    seed = (z - (index + 1) * GOLDEN) & M64
    if objective(seed, index) != value:
        fail("planted_seed: the inverse mix is wrong")
    return seed


def np_fold(variant: str, seed: int, lo: int, n: int, threshold: int = 0, k: int = HC_K):
    """``(searched, acc)`` of a hashcore chunk from numpy u64 lanes: an
    independent reference for ``workloads.compute``."""
    v = np_values(seed, lo, n)
    if variant == "fmin":
        i = int(np.argmin(v))
        return n, [int(v[i]), lo + i]
    if variant == "topk":
        return n, [[int(v[j]), lo + int(j)] for j in np.argsort(v, kind="stable")[:k]]
    if variant == "fmatch":
        hits = np.flatnonzero(v <= np.uint64(threshold))
        if not len(hits):
            return n, [None, None, n]
        j = int(hits[0])
        return min((j // 2048 + 1) * 2048, n), [lo + j, int(v[j]), j + 1]
    total = (int((v >> np.uint64(32)).sum()) << 32) + int((v & np.uint64(M32)).sum())
    return n, [total, n]


def hc_request(variant, seed, lo, n, threshold=0, k=HC_K, job_id=21):
    from tpuminter_torch.protocol import PowMode, Request
    from tpuminter_torch.workloads import hashcore

    return Request(job_id, PowMode.MIN, lo, lo + n - 1, workload="hashcore",
                   data=hashcore.pack_params(variant, seed, threshold, k))


def hc_decode(req, result):
    """``(searched, acc)`` of a hashcore WorkResult for ``req``."""
    from tpuminter_torch.workloads import hashcore

    return result.searched, hashcore.HashCore().fold_for(req).decode(result.payload)


def check_witnesses(req, searched, acc, what):
    """A claim's witnesses recompute with the scalar objective, lie in
    the chunk and have the claimed shape."""
    from tpuminter_torch.workloads import hashcore

    p = hashcore.parse_params(req.data)
    lo, hi = req.lower, req.upper
    if p.variant == "fmin":
        pairs = [acc]
    elif p.variant == "topk":
        pairs = acc
        if len(pairs) != min(p.k, hi - lo + 1) or pairs != sorted(pairs) or \
                len({i for _, i in pairs}) != len(pairs):
            fail(f"{what}: top-k claim is not {p.k} distinct sorted pairs")
    elif p.variant == "fmatch":
        index, value, probes = acc
        if value > p.threshold or probes != index - lo + 1:
            fail(f"{what}: first-match claim {acc} is inconsistent")
        pairs = [[value, index]]
    else:
        return
    for value, index in pairs:
        if not lo <= index <= hi or objective(p.seed, index) != value:
            fail(f"{what}: witness {value} at {index} does not recompute")


def splitmix_kernel_checks(dev, rng, st, int_rate):
    """K7 against its plain version on the card, exact: 2^24 random u64
    indices under 8 random seeds, and the edge words (index 2^64 - 1,
    high-word carries) under seeds 0, 2^64 - 1 and one more, against the
    scalar objective too; a sample against numpy u64 lanes; then timed at
    the hashcore path's window beside its plain version and its bound."""
    from tpuminter_torch.kernels import splitmix as K7
    from tpuminter_torch.ops import splitmix as sm

    n = 1 << 21
    for _ in range(8):
        seed = int(rng.integers(0, 1 << 63)) * 2 + int(rng.integers(0, 2))
        hi = torch.tensor(rng.integers(0, 1 << 32, n, dtype=np.int64), device=dev)
        lo = torch.tensor(rng.integers(0, 1 << 32, n, dtype=np.int64), device=dev)
        got = K7.splitmix_batch(seed, hi, lo)
        for g, w, what in zip(got, K7.splitmix_batch_plain(seed, hi, lo), ("high", "low")):
            st.agree(g, w, f"seed {seed:#x}, 2^21 random indices, {what} words")
        def u64(words):
            return (words[0][:4096].cpu().numpy().astype(np.uint64) << np.uint64(32)) | \
                words[1][:4096].cpu().numpy().astype(np.uint64)

        if not np.array_equal(u64(got), np_objective(seed, u64((hi, lo)))):
            fail("splitmix_batch disagrees with numpy u64 lanes")
    edges = [0, 1, M32 - 1, M32, 1 << 32, (1 << 32) + 1, (1 << 33) - 1, (7 << 32) - 1, 1 << 63,
             M64 - 1, M64]
    ehi, elo = i64([e >> 32 for e in edges], dev), i64([e & M32 for e in edges], dev)
    for seed in (0, M64, GOLDEN):
        got = K7.splitmix_batch(seed, ehi, elo)
        for g, w in zip(got, K7.splitmix_batch_plain(seed, ehi, elo)):
            st.agree(g, w, f"edge words, seed {seed:#x}")
        if [(h << 32) | low for h, low in zip(*(t.tolist() for t in got))] != \
                [objective(seed, e) for e in edges]:
            fail(f"splitmix_batch edge words under seed {seed:#x} disagree with the objective")
    say(f"  splitmix_batch: 2^24 random indices under 8 seeds and {len(edges)} edge words "
        "under 3 seeds equal to plain; samples equal to numpy u64 lanes and the objective")

    w = sm.ROWS * sm.DEFAULT_WIDTH
    ih, il = sm.index_words(HC_BASE, torch.arange(w, dtype=torch.int64, device=dev))
    seed = int(rng.integers(0, 1 << 63))
    ms, got = event_ms(lambda: K7.splitmix_batch(seed, ih, il), 20)
    plain_ms, want = event_ms(lambda: K7.splitmix_batch_plain(seed, ih, il), 1, warmup=False)
    for g, v in zip(got, want):
        st.agree(g, v, f"one window of {w} indices")
    record(st, w, w, ms, plain_ms, 32 * w, SPLITMIX_OPS, SPLITMIX_OPS * w, int_rate,
           unit="index")
    return ms


def hashcore_window_sweep(dev, rng, k7_ms):
    """Each variant at each window (8 rows of 2^14 .. 2^21 lanes) over
    2^28 indices: G indices/s through the window loop of
    ``HashCore.compute`` (two windows in flight, one read each); and at
    the default window, the device time of a window's dispatch (CUDA
    events over back-to-back dispatches) against the host's time to
    issue it, K7's part of it, and a profiler trace's device-busy share
    of a 2^28-index ``workloads.compute`` run."""
    from tpuminter_torch.ops import splitmix as sm
    from tpuminter_torch.search import pipeline_spans
    from tpuminter_torch.workloads import hashcore

    seed, n = int(rng.integers(0, 1 << 63)), HC_SWEEP_N
    sweep_rates = {}
    for variant in sm.VARIANTS:
        fold = hashcore.HashCore().fold_for(hc_request(variant, seed, HC_BASE, 1))
        row = {}
        for width in HC_SWEEP_WIDTHS:
            sw = sm.lane_sweep(variant, k=HC_K, width=width, device=dev)
            spans = [(g, min(g + sw.window - 1, HC_BASE + n - 1))
                     for g in range(HC_BASE, HC_BASE + n, sw.window)]
            sw.resolve(sw.dispatch(seed, *spans[0]), *spans[0])  # first use: build, allocate
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            acc = fold.initial()
            for (g, e), h in pipeline_spans(spans, lambda s: sw.dispatch(seed, s[0], s[1], 0)):
                acc = fold.combine(acc, sw.resolve(h, g, e))
            row[sw.window] = n / (time.perf_counter() - t0) / 1e9
        sweep_rates[variant] = row
        say(f"  window sweep, {variant}: " + ", ".join(
            f"2^{w.bit_length() - 1} {r:.3f}" for w, r in row.items()) + " G indices/s")
    breakdown = {}
    for variant in sm.VARIANTS:
        sw = sm.lane_sweep(variant, k=HC_K, device=dev)
        lo, hi = HC_BASE, HC_BASE + sw.window - 1
        dev_ms, _ = event_ms(lambda: sw.dispatch(seed, lo, hi, 0), 10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            sw.dispatch(seed, lo, hi, 0)
        host_ms = (time.perf_counter() - t0) / 10 * 1e3
        torch.cuda.synchronize()
        req = hc_request(variant, seed, HC_BASE, n)
        busy_ms, k7_busy_ms, wall_ms = profile_compute(req, dev)
        breakdown[variant] = dict(window=sw.window, device_ms=dev_ms, host_issue_ms=host_ms,
                                  k7_ms=k7_ms, fold_ms=dev_ms - k7_ms, busy_ms=busy_ms,
                                  k7_busy_ms=k7_busy_ms, wall_ms=wall_ms)
        busy = ("not measured (no device time in the trace)" if busy_ms is None else
                f"device busy {busy_ms:.3f} of {wall_ms:.3f} ms wall "
                f"({busy_ms / wall_ms:.1%}; idle {1 - busy_ms / wall_ms:.1%}), K7 "
                f"{k7_busy_ms:.3f} ms of it")
        say(f"  window of {sw.window}, {variant}: device {dev_ms:.4f} ms/window (K7 "
            f"{k7_ms:.4f}, index words + fold {dev_ms - k7_ms:.4f}), host issue "
            f"{host_ms:.4f} ms/window; 2^28 through workloads.compute under the profiler "
            f"(its own host cost included): {busy}")
    return sweep_rates, breakdown


def profile_compute(req, dev):
    """Device-busy time (the sum of the trace's device kernel times), K7's
    part of it and the wall time of one ``workloads.compute`` run under
    ``torch.profiler``; busy is None where the trace has no device time."""
    from torch.profiler import ProfilerActivity, profile

    from tpuminter_torch import workloads

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drain(workloads.compute(req, device=dev))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = k7 = 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms = ev.time_range.elapsed_us() / 1e3
            busy += ms
            if "splitmix_batch_kernel" in ev.name:
                k7 += ms
    return (busy or None), k7, wall_ms


def phase_hashcore_path(dev, card: str, rng, k7_ms, breakdown):
    """Each variant through ``workloads.compute`` on the card over 2^32
    indices from HC_BASE (first-match: to its planted first hit), and
    fmin and top-k over [0, 2^32 - 1] for phase 5, with every launch
    count 0 before and read after; then each held against the same path
    on K7's plain version, its witnesses recomputed with the scalar
    objective; the four variants at 2^24 ragged indices against numpy.
    A run's device share is its windows times a window's device time
    (``breakdown``, measured untraced) over its wall time."""
    from tpuminter_torch import kernels, workloads
    from tpuminter_torch.kernels import splitmix as K7
    from tpuminter_torch.workloads import hashcore

    seed = int(rng.integers(0, 1 << 63)) * 2 + 1
    fm_seed = planted_seed(HC_BASE + HC_PLANT_AT, HC_PLANT_VALUE)
    runs = [hc_request("fmin", seed, HC_BASE, HC_N), hc_request("topk", seed, HC_BASE, HC_N),
            hc_request("fmatch", fm_seed, HC_BASE, HC_N, threshold=HC_PLANT_VALUE),
            hc_request("fsum", seed, HC_BASE, HC_N)]
    e2e_seed = int(rng.integers(0, 1 << 63))
    e2e_runs = {v: hc_request(v, e2e_seed, 0, HC_N) for v in ("fmin", "topk")}

    def run(req, engine="kernel"):
        torch.cuda.synchronize()
        before = K7.splitmix_batch.launches
        t0 = time.perf_counter()
        res = drain(workloads.compute(req, device=dev, engine=engine))
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, K7.splitmix_batch.launches - before

    reset_launches(kernels)
    done, rates = [], {}
    for req in runs:
        res, dt, launched = run(req)
        done.append((req, res, dt, launched))
    e2e = {v: hc_decode(req, run(req)[0]) for v, req in e2e_runs.items()}
    e2e["seed"] = e2e_seed
    launches = read_launches(kernels, ("splitmix_batch",), "hashcore")
    for req, res, dt, launched in done:
        variant = hashcore.parse_params(req.data).variant
        plain, plain_dt, _ = run(req, engine="plain")
        if plain != res:
            fail(f"hashcore {variant}: the kernel path {res} differs from the plain path {plain}")
        searched, acc = hc_decode(req, res)
        check_witnesses(req, searched, acc, f"hashcore {variant}")
        if variant == "fmatch" and (acc[0] != HC_BASE + HC_PLANT_AT or
                                    searched != min((HC_PLANT_AT // 2048 + 1) * 2048, HC_N)):
            fail(f"hashcore fmatch: {searched} {acc} is not the planted first hit")
        if variant != "fmatch" and searched != HC_N:
            fail(f"hashcore {variant}: searched {searched}, want {HC_N}")
        device_share = launched * breakdown[variant]["device_ms"] / (dt * 1e3)
        rates[variant] = dict(g_per_s=searched / dt / 1e9, seconds=dt, k7_launches=launched,
                              k7_share=launched * k7_ms / (dt * 1e3),
                              device_share=device_share, plain_seconds=plain_dt)
        say(f"  hashcore {variant}: {searched} indices in {dt:.3f} s = "
            f"{searched / dt / 1e9:.3f} G indices/s on {card}; K7 {launched} launches, "
            f"{rates[variant]['k7_share']:.1%} of the wall time; windows x device time "
            f"{device_share:.1%} of it; equal to the plain path ({plain_dt:.1f} s); "
            "witnesses recomputed")
    for variant in ("fmin", "topk"):
        check_witnesses(e2e_runs[variant], *e2e[variant], f"hashcore {variant} [0, 2^32)")
    np_seed = int(rng.integers(0, 1 << 63))
    np_plant = planted_seed(NP_LO + 9_000_001, 1 << 30)
    for variant in ("fmin", "topk", "fmatch", "fsum"):
        s, thr = (np_plant, 1 << 30) if variant == "fmatch" else (np_seed, 0)
        req = hc_request(variant, s, NP_LO, NP_N, threshold=thr)
        got = hc_decode(req, run(req)[0])
        want = np_fold(variant, s, NP_LO, NP_N, thr)
        if got != want:
            fail(f"hashcore {variant} at 2^24 + 777 indices: {got} != numpy {want}")
    say(f"  hashcore, all four variants over {NP_N} indices from {NP_LO}: equal to numpy "
        "u64 lanes (searched included)")
    return launches, rates, e2e


# ---- scrypt (S1, 19, S2 and the row-gather probe 11) -----------------------

#: integer operations of Salsa20/8: 128 x (add, funnel shift, xor) + 16 adds;
#: BlockMix (r = 1) is two of them and 32 xors; a walk step xors in V's row
SALSA_OPS = 128 * 3 + 16
BLOCKMIX_OPS = 2 * SALSA_OPS + 32
WALK_STEP_OPS = BLOCKMIX_OPS + 32
SCRYPT_N_LOG2 = 10
SCRYPT_N = 1 << SCRYPT_N_LOG2
#: the Litecoin genesis block: its double SHA and its scrypt value (below
#: its target), for the known-answer run
LTC_GENESIS = dict(
    version=1, prev_hex="00" * 32,
    merkle_hex="97ddfbbae6be97fd6cdf3e7ca13232a3afff2353e29badfab7f73011edd4ced9",
    timestamp=1317972665, bits=0x1E0FFFF0, nonce=2084524493,
)
LTC_GENESIS_DSHA = "12a765e31ffd4059bada1e25190f6e98c99d9714d334efa41a195a7e7e04bfe2"
LTC_GENESIS_SCRYPT = 0x0000050C34A64B415B6B15B37F2216634B5B1669CB9A2E38D76F7213B0671E00
#: lanes of the kernels' plain check at N = 16 (at N = 1024 it runs at
#: the path's batch: an int64 plain V of 16 GiB at 2^16), and the lanes a
#: ragged count leaves out of its V
SCRYPT_CHECK_N = 1 << 12
SCRYPT_RAGGED = 333
#: the path's batch before it rose to 2^16, one wave of S1 (8 blocks of 32
#: hashes an SM): checked ragged and timed beside the path's batch
SCRYPT_HALF_BATCH = 1 << 15
#: the batch sweep of phase 4d, and the batches each of its runs mines
SCRYPT_SWEEP = tuple(1 << b for b in range(14, 19))
SCRYPT_SWEEP_BATCHES = 4
#: the exhausted range of phase 4d (also phase 5's job), the Litecoin
#: genesis window's nonces past the genesis nonce, and the rolled job's
#: indices on each side of its extranonce boundary
SCRYPT_RANGE, SCRYPT_WINDOW_TAIL, SCRYPT_ROLLED_HALF = 1 << 20, 4095, 1 << 15
#: the coordinator's SCRYPT chunk for the port worker: 16384 nonces a lane
#: hint over SCRYPT_CHUNK_DIVISOR (8192), at the worker's 32768 lanes
SCRYPT_COORD_CHUNK = 16_384 * 32_768 // 8_192
#: the batches the coordinator-size chunk is mined at (4, 2 and 1 batches
#: a chunk), and the timed runs at each
SCRYPT_CHUNK_SWEEP, SCRYPT_CHUNK_REPS = (1 << 14, 1 << 15, 1 << 16), 5
#: probe 19's shapes (scripts/walk_pallas_probe.py) and probe 11's
#: (scripts/romix_pallas_probe.py): its rows, batch and rep counts
WALK_B = 16_384
GATHER_ROWS, GATHER_B, GATHER_REPS = 256 * 8192, 8192, (32, 256)


def sha_ops() -> int:
    """Integer instructions of one SHA-256 compression with every input
    word varying (``op_count``'s rules)."""
    return _count(_compress([leaf(NONCE) for _ in range(8)], [leaf(NONCE) for _ in range(16)]))[0]


def handle_from_values(values, target: int):
    """The packed batch result (``ops.scrypt.batch_fold``) computed on
    the host from each lane's hash value."""
    def words(v):
        return [(v >> (32 * (7 - j))) & M32 for j in range(8)]

    wins = [i for i, v in enumerate(values) if v <= target]
    lane_min = min(range(len(values)), key=lambda i: (values[i], i))
    first = wins[0] if wins else 0x7FFFFFFF
    return ([int(bool(wins)), first] + words(values[lane_min]) + [lane_min]
            + (words(values[first]) if wins else [0] * 8))


def compact_at_least(target: int) -> int:
    """The compact bits of the smallest encodable target >= ``target``."""
    for exponent in range(3, 35):
        mantissa = -(-target // (1 << (8 * (exponent - 3))))
        if mantissa <= 0x7FFFFF:
            return (exponent << 24) | mantissa
    fail(f"target {target:#x} has no compact encoding")


def scrypt_values(digest: torch.Tensor) -> list:
    """``(B, 8)`` BE digest words → each lane's 256-bit hash value
    (little-endian bytes)."""
    raw = digest.cpu().numpy().astype(">u4").tobytes()
    return [int.from_bytes(raw[i:i + 32], "little") for i in range(0, len(raw), 32)]


def check_fold(st, hw, nonces, x, xp, what) -> float:
    """``scrypt_back`` on ``x`` against its plain version on ``xp`` and
    against the host's fold of its digests, at no target, the batch's
    5th-smallest hash (its largest, below 5 lanes) and every hash;
    returns the plain version's ms."""
    from tpuminter_torch.kernels import scrypt as KS
    from tpuminter_torch.ops import sha256 as ops

    digest, _ = KS.scrypt_back(hw, nonces, x, [0] * 8)
    values = scrypt_values(digest)
    for target in (0, sorted(values)[min(4, len(values) - 1)], (1 << 256) - 1):
        tw = [int(w) for w in ops.target_to_words(target)]
        digest, handle = KS.scrypt_back(hw, nonces, x, tw)
        ms, (dp, hp) = event_ms(lambda: KS.scrypt_back_plain(hw, nonces, xp, tw), 1,
                                warmup=False)
        st.agree(digest, dp, f"digests, {what}")
        st.agree(handle, hp, f"fold, {what}, target {target:#x}")
        if handle.tolist() != handle_from_values(values, target):
            fail(f"scrypt_back fold, {what}, target {target:#x}: {handle.tolist()} "
                 "disagrees with the host's fold of the digests")
    return ms


def s2_contract_checks(st, hw, b, dev, rng) -> None:
    """S2's one-launch contract on ``b`` lanes of random X, each launch
    equal to its plain version: three launches back to back on other X
    and targets, with no wait between (a ticket the last block did not
    reset would fold the next launch wrongly), ragged counts and counts
    below one block, and a batch whose first winner lies in its last
    block (the batch's minimum, which the count puts there, as the
    target)."""
    from tpuminter_torch.kernels import scrypt as KS
    from tpuminter_torch.ops import sha256 as ops

    x = torch.tensor(rng.integers(0, 1 << 32, (b, 32), dtype=np.int64), device=dev)
    nonces = torch.tensor(rng.integers(0, 1 << 32, b, dtype=np.int64), device=dev)
    values = scrypt_values(KS.scrypt_back_plain(hw, nonces, x, [0] * 8)[0])

    def target(v):
        return [int(w) for w in ops.target_to_words(v)]

    def span(lo, count, kth):
        return (nonces[lo:lo + count], x[lo:lo + count],
                target(sorted(values[lo:lo + count])[min(kth, count - 1)]))

    spans = [span(0, b // 3, 3), span(b // 7, b // 3 + 1000, 4), span(b // 2, b // 3 + 2000, 0)]
    outs = [KS.scrypt_back(hw, *sp) for sp in spans]  # queued back to back
    for k, (sp, (digest, handle)) in enumerate(zip(spans, outs)):
        dp, hp = KS.scrypt_back_plain(hw, *sp)
        st.agree(digest, dp, f"digests, launch {k + 1} of 3 back to back")
        st.agree(handle, hp, f"fold, launch {k + 1} of 3 back to back")
    for count in (b - 1, b - KS.THREADS + 1, KS.THREADS + 1, KS.THREADS - 1, 64, 1):
        sp = span(0, count, 2)
        (digest, handle), (dp, hp) = KS.scrypt_back(hw, *sp), KS.scrypt_back_plain(hw, *sp)
        st.agree(digest, dp, f"digests, {count} lanes")
        st.agree(handle, hp, f"fold, {count} lanes")
    low = min(range(b), key=lambda i: (values[i], i))
    count = min(b, (low // KS.THREADS + 1) * KS.THREADS)
    sp = (nonces[:count], x[:count], target(values[low]))
    (digest, handle), (dp, hp) = KS.scrypt_back(hw, *sp), KS.scrypt_back_plain(hw, *sp)
    st.agree(handle, hp, f"fold, the winner in the last block ({count} lanes)")
    st.agree(digest, dp, f"digests, the winner in the last block ({count} lanes)")
    if handle[:2].tolist() != [1, low]:
        fail(f"scrypt_back: the winner {low} in the last block of {count} lanes was not found: "
             f"{handle[:2].tolist()}")
    say(f"  scrypt_back, one launch: 3 launches back to back, {b - 1}, {b - KS.THREADS + 1}, "
        f"{KS.THREADS + 1}, {KS.THREADS - 1}, 64 and 1 lanes, and the first winner {low} in the "
        f"last block of {count} lanes, equal to plain")


#: 11's checks: lane counts (one, a part of a warp's rows, one short of
#: the probe's, the probe's), pass counts, and small V's whose rows wrap
#: the pass stride (977) within a launch
GATHER_CHECK_COUNTS, GATHER_CHECK_REPS, GATHER_SMALL_ROWS = (1, 7, 8191, 8192), (
    0, 1, 3, 32, 256), (5, 1000)


def gather_checks(dev, s11, KS, vg, idx) -> str:
    """11 against its plain version at every count and pass count above,
    on the probe's V and on small ones (bit patterns of seeded words)."""
    from tpuminter_torch.ops.walk_layouts import to_bits

    rng = np.random.default_rng(SEED + 7)
    small = {rows: to_bits(torch.tensor(rng.integers(0, 1 << 32, (rows, 32), dtype=np.int64),
                                        device=dev)) for rows in GATHER_SMALL_ROWS}
    cases = [(vg, idx)] + [(v, idx % rows) for rows, v in small.items()]
    for v, lanes in cases:
        for count in GATHER_CHECK_COUNTS:
            for reps in GATHER_CHECK_REPS:
                sub = lanes[:count]
                s11.agree(KS.row_gather(v, sub, reps), KS.row_gather_plain(v, sub, reps),
                          f"{count} lanes, {reps} passes, {v.shape[0]} rows")
    return (f"equal to plain at {GATHER_CHECK_COUNTS} lanes x {GATHER_CHECK_REPS} passes on "
            f"{GATHER_ROWS} rows and on {GATHER_SMALL_ROWS} (wrapping)")


def scrypt_kernel_checks(dev, rng, stats, int_rate):
    """S1 → 19 → S2 against their plain versions on the card, exact: the
    path's batch of seeded nonces at N = 1024, whole and ragged (also 2^15
    - 333 lanes) in its V (X and all of V, the digests, and the fold
    against no target, the batch's 5th-smallest hash and every hash), the
    same at N = 16 on 2^12, 1000, 2^12 - 3, 5 and 1 lanes of a 2^12-lane
    V, S2's fold at the sweep's largest batch; 110 digests against
    hashlib.scrypt. Probe 19's stage 1 (B = 16384, N = 1024, its V made
    on the card, a 4-step chain) and 11 against its plain version. Then
    each timed: S1, 19 and S2 at the path's batch and at 2^15, 19 per
    step over a 1024-step walk at probe 19's B and the path's, 11 as the
    slope between 32 and 256 passes at probe 11's batch beside
    ``torch.index_select``."""
    from tpuminter_torch.cuda_worker import DEFAULT_SCRYPT_BATCH
    from tpuminter_torch.kernels import scrypt as KS
    from tpuminter_torch.ops import scrypt as S
    from tpuminter_torch.ops import sha256 as ops
    from tpuminter_torch.ops.walk_layouts import to_bits
    from tpuminter_torch.probes._common import MEM_BYTES_PER_S, probe_v, time_ms

    s1, s19, s2, s11 = (stats[k] for k in ("scrypt_front", "romix_walk", "scrypt_back",
                                           "row_gather"))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    occ = KS.occupancy(dev)
    wave = {k: b * KS.THREADS * sms // KS.THREADS_PER_HASH[k] for k, (b, _) in occ.items()}
    say(f"  scrypt occupancy: (blocks of {KS.THREADS} per SM, registers) {occ}; hashes in "
        f"flight a wave {wave}")
    hdr76 = rng.bytes(76)
    hw = S.header_to_words(hdr76)
    b = DEFAULT_SCRYPT_BATCH["cuda"]
    nonces = torch.tensor(rng.integers(0, 1 << 32, b, dtype=np.int64), device=dev)
    plain = {}
    # (n_log2, V's lane stride, lanes): the path's batch at N = 1024, whole
    # and ragged, and 2^15 ragged (S2's fold then takes several grid-stride
    # iterations over its block partials, as every batch of the path
    # does), then N = 16; the ragged counts leave S1's and 19's last warp
    # (eight hashes of four threads) part full, down to one hash
    cases = ((SCRYPT_N_LOG2, b, b), (SCRYPT_N_LOG2, b, b - SCRYPT_RAGGED),
             (SCRYPT_N_LOG2, b, SCRYPT_HALF_BATCH - SCRYPT_RAGGED),
             (4, SCRYPT_CHECK_N, SCRYPT_CHECK_N), (4, SCRYPT_CHECK_N, 1000),
             (4, SCRYPT_CHECK_N, SCRYPT_CHECK_N - 3), (4, SCRYPT_CHECK_N, 5),
             (4, SCRYPT_CHECK_N, 1))
    for n_log2, stride, count in cases:
        what = f"N=2^{n_log2}, {count} lanes of a {stride}-lane V"
        nz = nonces[:count]
        v = KS.romix_scratch(n_log2, stride, dev)
        v.fill_(-1)  # lanes the kernel does not write stay all ones
        vp = torch.zeros((1 << n_log2, stride, 32), dtype=torch.int64, device=dev)
        x = KS.scrypt_front(hw, nz, n_log2, v)
        ms_f, xp = event_ms(lambda: KS.scrypt_front_plain(hw, nz, n_log2, vp), 1, warmup=False)
        s1.agree(x, xp, f"X, {what}")
        s1.agree(v[:, :count].to(torch.int64) & M32, vp[:, :count], f"V, {what}")
        if not bool((v[:, count:] == -1).all()):
            fail(f"scrypt_front wrote V lanes past its count, {what}")
        x = KS.romix_walk(x, v, n_log2, 1 << n_log2)
        ms_w, xp = event_ms(lambda: KS.romix_walk_plain(xp, vp, n_log2, 1 << n_log2), 1,
                            warmup=False)
        s19.agree(x, xp, f"{1 << n_log2}-step walk, {what}")
        del v, vp
        torch.cuda.empty_cache()
        ms_b = check_fold(s2, hw, nz, x, xp, what)
        digest, _ = KS.scrypt_back(hw, nz, x, [0] * 8)
        for i in range(64 if n_log2 == SCRYPT_N_LOG2 and count == stride else min(8, count)):
            hdr = hdr76 + struct.pack("<I", int(nz[i]))
            want = hashlib.scrypt(hdr, salt=hdr, n=1 << n_log2, r=1, p=1, dklen=32)
            if tuple(digest[i].tolist()) != struct.unpack(">8I", want):
                fail(f"scrypt digest of nonce {int(nz[i])}, {what}, disagrees with hashlib")
        if n_log2 == SCRYPT_N_LOG2 and count == stride:
            plain = {"front": ms_f, "walk": ms_w, "back": ms_b}
        del x, xp
        torch.cuda.empty_cache()
    # S2's fold at the sweep's largest batch, on random X: the most block
    # partials any batch of the path folds
    big = SCRYPT_SWEEP[-1]
    xb = torch.tensor(rng.integers(0, 1 << 32, (big, 32), dtype=np.int64), device=dev)
    nb = torch.tensor(rng.integers(0, 1 << 32, big, dtype=np.int64), device=dev)
    for count in (big, big - SCRYPT_RAGGED):
        check_fold(s2, hw, nb[:count], xb[:count], xb[:count], f"{count} lanes of random X")
    del xb, nb
    s2_contract_checks(s2, hw, b, dev, rng)
    say(f"  scrypt_front, romix_walk, scrypt_back: {b} nonces (the path's batch) and "
        f"{b - SCRYPT_RAGGED} and {SCRYPT_HALF_BATCH - SCRYPT_RAGGED} in a {b}-lane V at N = "
        f"1024, {SCRYPT_CHECK_N}, 1000, "
        f"{SCRYPT_CHECK_N - 3}, 5 and 1 in a {SCRYPT_CHECK_N}-lane V at N = 16, equal to plain "
        "(X, all of V and no lane past the count, digests, the fold at three targets incl. the "
        "batch's 5th-smallest hash) and "
        f"to the host's fold; scrypt_back's fold also on {big} and {big - SCRYPT_RAGGED} lanes "
        "of random X; 110 digests equal to hashlib.scrypt")

    # probe 19, stage 1: its shapes and its V, a 4-step chain
    v = probe_v(SCRYPT_N * WALK_B, dev).view(SCRYPT_N, WALK_B, 32)
    x0 = torch.tensor(rng.integers(0, 1 << 32, (WALK_B, 32), dtype=np.int64), device=dev)
    s19.agree(KS.romix_walk(x0, v, SCRYPT_N_LOG2, 4),
              KS.romix_walk_plain(x0, v, SCRYPT_N_LOG2, 4), "probe 19 stage 1, 4-step chain")
    ms, _ = event_ms(lambda: KS.romix_walk(x0, v, SCRYPT_N_LOG2, SCRYPT_N), 3)
    walk_us = {"probe_b": ms * 1e3 / SCRYPT_N}
    say(f"  romix_walk, probe 19 stage 1 (B = {WALK_B}, N = 1024, its V): 4-step chain equal "
        f"to plain; stage 2: {walk_us['probe_b']:.3f} us/step over a 1024-step walk "
        f"({WALK_B / walk_us['probe_b']:.1f} M rows/s)")
    del v
    torch.cuda.empty_cache()

    # S1, 19 and S2 at the path's batch, and at 2^15 beside it
    batch_ms = {}
    for count in sorted({b, SCRYPT_HALF_BATCH}):
        v = KS.romix_scratch(SCRYPT_N_LOG2, count, dev)
        nz = torch.tensor(rng.integers(0, 1 << 32, count, dtype=np.int64), device=dev)
        ms1, x = event_ms(lambda: KS.scrypt_front(hw, nz, SCRYPT_N_LOG2, v), 3)
        ms19, x = event_ms(lambda: KS.romix_walk(x, v, SCRYPT_N_LOG2, SCRYPT_N), 3)
        paced2, _ = event_ms(lambda: KS.scrypt_back(hw, nz, x, [0] * 8), 5)
        ms2 = time_ms(lambda: KS.scrypt_back(hw, nz, x, [0] * 8), dev)
        batch_ms[count] = {"front": ms1, "walk": ms19, "back": ms2, "back_paced": paced2}
        say(f"  at a batch of {count}: S1 {ms1:.4f} ms, 19 {ms19:.4f}, S2 {ms2:.4f} (paced by "
            f"the host, 5 calls back to back: {paced2:.4f})")
        del v, x
        torch.cuda.empty_cache()
    ms1, ms19, ms2 = (batch_ms[b][k] for k in ("front", "walk", "back"))
    walk_us["path_b"] = ms19 * 1e3 / SCRYPT_N
    sha = sha_ops()
    row = SCRYPT_N * 128
    record(s1, b, b, ms1, plain["front"], b * (8 + row + 256),
           SCRYPT_N * BLOCKMIX_OPS + 13 * sha, b * (SCRYPT_N * BLOCKMIX_OPS + 13 * sha),
           int_rate, unit="hash")
    record(s19, b, b, ms19, plain["walk"], b * (256 + row + 256), SCRYPT_N * WALK_STEP_OPS,
           b * SCRYPT_N * WALK_STEP_OPS, int_rate, unit="hash")
    # the bound counts the function's work: PBKDF2-out's 4 compressions and
    # the 8-word compare (the kernel also recomputes the key and HMAC states)
    record(s2, b, b, ms2, plain["back"], b * (8 + 256 + 64) + 8 * 19, 4 * sha + 16,
           b * (4 * sha + 16), int_rate, unit="hash")
    s2.timing["paced_ms"] = batch_ms[b]["back_paced"]
    kernel_mhs = b / (ms1 + ms19 + ms2) / 1e3
    say(f"  romix_walk at the path's batch ({b}): {walk_us['path_b']:.3f} us/step; S1 + 19 + "
        f"S2 together {ms1 + ms19 + ms2:.3f} ms a batch = {kernel_mhs:.4f} MH/s "
        f"({sha} instructions a SHA-256 compression)")

    # 11: the row-gather probe at its rows and batch
    i = torch.arange(GATHER_ROWS, dtype=torch.int64, device=dev)[:, None]
    vg = to_bits((i * 2654435761 + torch.arange(32, dtype=torch.int64, device=dev)[None]) & M32)
    del i
    idx = torch.tensor(rng.integers(0, GATHER_ROWS, GATHER_B, dtype=np.int64), device=dev)
    lo, hi = GATHER_REPS
    checks = gather_checks(dev, s11, KS, vg, idx)
    plain_ms, want = event_ms(lambda: KS.row_gather_plain(vg, idx, lo), 1, warmup=False)
    s11.agree(KS.row_gather(vg, idx, lo), want, f"{lo} passes of {GATHER_B} rows of {GATHER_ROWS}")
    ms_lo = time_ms(lambda: KS.row_gather(vg, idx, lo), dev)
    ms_hi = time_ms(lambda: KS.row_gather(vg, idx, hi), dev)
    lib_ms, _ = event_ms(lambda: torch.index_select(vg, 0, idx), 20)
    per_pass = (ms_hi - ms_lo) / (hi - lo)
    g = KS.gather_geometry(GATHER_B, hi, sms)
    # a pass reads one 128-byte row a lane, but lanes and passes meet on
    # the same rows (this run's idx: the rows of 256 passes are ~63%
    # distinct): the bytes bound counts each distinct row once, over the
    # slope between the two pass counts (idx read and out written once a
    # launch fall outside it)
    def distinct(reps):
        steps = torch.arange(reps, dtype=torch.int64, device=dev) * 977
        return int(torch.unique((idx[:, None] + steps[None]) % GATHER_ROWS).numel())

    pass_bytes = (distinct(hi) - distinct(lo)) * 128 / (hi - lo)
    record(s11, GATHER_B, GATHER_B, per_pass, plain_ms / lo, pass_bytes, 32,
           32 * GATHER_B, int_rate, unit="row")
    s11.timing.update(library_ms=lib_ms, ms_at_reps={lo: ms_lo, hi: ms_hi},
                      ns_per_row=per_pass * 1e6 / GATHER_B,
                      bound_every_read_ms=GATHER_B * 128 / MEM_BYTES_PER_S * 1e3,
                      geometry=dict(slices=g.slices, per=g.per, grid=g.grid))
    say(f"  row_gather (probe 11): {checks}; {ms_lo:.4f} ms at {lo} passes, {ms_hi:.4f} at {hi} "
        f"(launches behind a held stream; {g.slices} slices of {g.per} passes, {g.grid} "
        f"blocks): {per_pass * 1e6 / GATHER_B:.4f} ns per 128-byte row "
        f"({128 * GATHER_B / per_pass / 1e6:.1f} GB/s of reads; {pass_bytes / GATHER_B:.1f} "
        f"distinct bytes a row read, {pass_bytes / per_pass / 1e6:.1f} GB/s); index_select of "
        f"one pass {lib_ms:.4f} ms ({lib_ms * 1e6 / GATHER_B:.3f} ns per row)")
    del vg
    torch.cuda.empty_cache()
    return {"kernel_mhs": kernel_mhs, "batch": b, "walk_us_per_step": walk_us,
            "batch_ms": ms1 + ms19 + ms2, "kernel_ms_by_batch": batch_ms, "occupancy": occ,
            "wave": wave}


# ---- the layout probes (P1-P3: sites 8-10, 12-18 and 20-24) -------------------

#: site → (row name, the TPU kernel it replaces (def; pallas_call))
PROBE_SITES = {
    "8": ("probe8_kernel_body", "scripts/kernel_body_probe.py:84 (make_call; pallas_call :91)"),
    "9": ("probe9_copy_grid", "scripts/pallas_launch_overhead_probe.py:74 (copy_grid; "
          "pallas_call :78)"),
    "10": ("probe10_tiny_step", "scripts/pallas_launch_overhead_probe.py:93 (tiny_step; "
           "pallas_call :94)"),
    "12": ("probe12_copy_padded", "scripts/transpose_micro_probe.py:83 (copy_padded; "
           "pallas_call :84)"),
    "13": ("probe13_copy_dense", "scripts/transpose_micro_probe.py:97 (copy_dense; "
           "pallas_call :99)"),
    "14": ("probe14_transpose_pad", "scripts/transpose_micro_probe.py:118 (transpose_pad; "
           "pallas_call :119)"),
    "15": ("probe15_transpose_dense", "scripts/transpose_micro_probe.py:138 (transpose_dense; "
           "pallas_call :140)"),
    "16": ("probe16_walk_isolate", "scripts/walk_isolate_probe.py:70 (fused_xor_salsa; "
           "pallas_call :73)"),
    "17": ("probe17_walk_native_tile", "scripts/walk_native_tile_probe.py:73 (fused_xor_salsa; "
           "pallas_call :78)"),
    "18": ("probe18_to_wm", "scripts/walk_pallas_probe.py:84 (to_wm; pallas_call :86)"),
    "20": ("probe20_wm_call", "scripts/walk_variants_probe.py:62 (wm_call; pallas_call :74)"),
    "21": ("probe21_tr_dense", "scripts/walk_variants_probe.py:144 (tr_dense_call; "
           "pallas_call :145)"),
    "22": ("probe22_walk_wm2", "scripts/walk_wm2_probe.py:68 (fused_xor_salsa; pallas_call :71)"),
    "23": ("probe23_walk_wm", "scripts/walk_wm_probe.py:73 (fused_xor_salsa; pallas_call :76)"),
    "24": ("probe24_hlo_layout_check", "scripts/hlo_layout_check.py:36 (call; pallas_call :37)"),
}
#: the sites each P3 instantiation serves (the edge checks record on them)
P3_SITES = {("grouped", "null"): ("8",), ("grouped", "one_extract"): ("8",),
            ("grouped", "xor_only"): ("8",), ("grouped", "full"): ("8", "17"),
            ("word", "full"): ("16", "22", "23"), ("row", "full"): ("20",),
            ("bitcast", "xor_only"): ("20",), ("bitcast", "full"): ("20",)}
P1_SITES, P2_SITES = ("9", "10", "12", "13"), ("14", "15", "18", "20", "21", "24")


def probe_stats() -> dict:
    p3 = {site for sites in P3_SITES.values() for site in sites}
    return {site: KernelStats(
        name, replaces, "tpuminter_torch/kernels/csrc/probes.cu",
        "walk_step" if site in p3 else "xor_const" if site in P1_SITES else "transpose")
        for site, (name, replaces) in PROBE_SITES.items()}


#: P1's edge counts: every count below 10 at every word offset, and
#: around the probes' 2^21 words, where the aligned arm has a tail of
#: 0-3 words
P1_SMALL_N = tuple(range(1, 10))
P1_EDGE_N = ((1 << 21) - 5, (1 << 21) - 1, (1 << 21) + 1, (1 << 21) + 5)
#: P2's shapes: the probes' (``_common.to_wm``, ``from_wm``; 15 and 21's
#: ``(B/4, 128)``) and sides that are multiples of 4 but not of a tile,
#: on the vector arm; sides that are not multiples of 4, on the scalar arm
P2_VECTOR_SHAPES = ((16_384, 32), (32, 16_384), (4096, 128), (1000, 36), (36, 1000))
P2_SCALAR_SHAPES = ((1000, 37), (37, 1000), (33, 1))
#: P3's (batch, blocks): the probes' B at one pass and on grids of 3 and
#: 133 blocks (fewer and more blocks than the quad form's 128 groups),
#: one block, three bitcast blocks, and the smallest batch
P3_EDGE = ((16_384, None), (16_384, 3), (16_384, 133), (2048, 1), (6144, None), (128, None),
           (128, 3))


def probe_edge_checks(dev, rng, stats) -> int:
    """P1-P3 against their plain versions where the probes' shapes do not
    reach: P1 at 1-9 words at word offsets 0-3 (the offsets take its
    scalar arm) and at 2^21 - 5, - 1, + 1 and + 5 words aligned and
    misaligned, and in place; P2 on the probes' shapes and on sides that
    are multiples of 4 but not of a tile (its vector arm), on sides that
    are not multiples of 4 (its scalar arm), each with and without a
    carry, and on views one word off their storage (the scalar arm);
    every P3 instantiation on
    random words at each of ``P3_EDGE``'s batches and grids. Each check
    is recorded on the sites that use it."""
    from tpuminter_torch.kernels import probes as KP
    from tpuminter_torch.ops import walk_layouts as W

    def words(*shape):
        return torch.tensor(rng.integers(0, 1 << 32, shape, dtype=np.int64), device=dev)

    def agree(sites, got, want, what):
        for site in sites:
            stats[site].agree(W.to_lanes(got), want, what)

    checks = 0
    for n in P1_SMALL_N:
        x = words(n + 3)
        xb = W.to_bits(x)
        for off in range(4):
            c = int(rng.integers(0, 1 << 32))
            agree(P1_SITES, KP.xor_const(xb[off:off + n], c), x[off:off + n] ^ c,
                  f"{n} words at word offset {off}")
            checks += 1
    for n in P1_EDGE_N:
        x = words(n + 1)
        xb = W.to_bits(x)
        agree(P1_SITES, KP.xor_const(xb[:n], 0xDEADBEEF), x[:n] ^ 0xDEADBEEF, f"{n} words")
        agree(P1_SITES, KP.xor_const(xb[1:], 7), x[1:] ^ 7, f"{n} words misaligned by one")
        checks += 2
    inplace = xb.clone()
    KP.xor_const(inplace, 1, out=inplace)
    agree(P1_SITES, inplace, x ^ 1, "in place")
    shifted = xb.clone()[1:]
    KP.xor_const(shifted, 1, out=shifted)
    agree(P1_SITES, shifted, x[1:] ^ 1, "in place, misaligned by one")
    checks += 2
    for r, c in P2_SCALAR_SHAPES + P2_VECTOR_SHAPES:
        a, carry = words(r, c), words(c, r)
        arm = "vector" if (r, c) in P2_VECTOR_SHAPES else "scalar"
        agree(P2_SITES, KP.transpose(W.to_bits(a)), KP.transpose_plain(a), f"({r}, {c}), {arm}")
        agree(P2_SITES, KP.transpose(W.to_bits(a), W.to_bits(carry)),
              KP.transpose_plain(a, carry), f"({r}, {c}) into a carry, {arm}")
        checks += 2
    for r, c in P2_VECTOR_SHAPES[:3]:
        # a view one word into its storage (and a carry so) takes the scalar arm
        a, carry = words(r * c + 1), words(c * r + 1)
        ab, cb = W.to_bits(a), W.to_bits(carry)
        agree(P2_SITES, KP.transpose(ab[1:].view(r, c)), KP.transpose_plain(a[1:].view(r, c)),
              f"({r}, {c}) one word off its storage")
        agree(P2_SITES, KP.transpose(ab[:-1].view(r, c), cb[1:].view(c, r)),
              KP.transpose_plain(a[:-1].view(r, c), carry[1:].view(c, r)),
              f"({r}, {c}) into a carry one word off its storage")
        checks += 2
    for (layout, body), sites in P3_SITES.items():
        for b, blocks in P3_EDGE:
            xw = words(32, b // 128, 128)
            vj = words(*W.operand_shape(layout, b))
            agree(sites, KP.walk_step(W.to_bits(xw), W.to_bits(vj), layout, body, blocks),
                  KP.walk_step_plain(xw, vj, layout, body),
                  f"{layout} x {body}, B = {b}, blocks {blocks or 'one a lane'}")
            checks += 1
    return checks


def record_site(st, site: dict, int_rate: float) -> None:
    """A probe site's row: the probe's measurements beside the bound of
    the work its function needs (each input read once, each output
    written once; the operations counted in ``probes._common``); its
    ``n`` is the words the function moves."""
    from tpuminter_torch.probes._common import MEM_BYTES_PER_S

    def bound(s):
        ops_ms = s["ops"] / int_rate * 1e3
        bytes_ms = s["bytes"] / MEM_BYTES_PER_S * 1e3
        return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"

    bound_ms, bound_by = bound(site)
    st.max_abs_err = max(st.max_abs_err, site["max_abs_err"])
    st.checks += site["checks"]
    detail = {k: site[k] for k in ("layout", "body", "blocks", "gather_ms", "chain_us",
                                   "graph_us", "bytes", "ops") if site.get(k) is not None}
    detail["variants"] = {
        name: dict(ms=v["ms"], plain_ms=v["plain_ms"], library_ms=v.get("library_ms"),
                   bound_ms=bound(v)[0], **{k: v[k] for k in ("chain_us", "graph_us",
                                                              "gather_ms", "slopes") if k in v})
        for name, v in site.get("variants", {}).items()}
    if "slopes" in site:
        detail["slopes"] = site["slopes"]
    st.timing = dict(n=site["bytes"] // 4, plain_n=site["bytes"] // 4, ms=site["ms"],
                     plain_ms=site["plain_ms"], library_ms=site.get("library_ms"),
                     bound_ms=bound_ms, bound_by=bound_by, ops_per_nonce=0,
                     int32_pipe_ms=site["ops"] / int_rate * 1e3 * ISSUE_LANES_PER_SM
                     / INT32_LANES_PER_SM, probe=detail)
    lib = (f", torch {site['library_ms'] * 1e3:.3f} us (kernel / torch "
           f"{site['ms'] / site['library_ms']:.3f}x)" if site.get("library_ms") else "")
    say(f"  {st.name}: {site['ms'] * 1e3:.3f} us/launch, bound {bound_ms * 1e3:.3f} us by "
        f"{bound_by} ({bound_ms / site['ms']:.1%}), plain {site['plain_ms']:.3f} ms{lib}")
    for name, v in detail["variants"].items():
        if v.get("library_ms"):
            say(f"    {name}: {v['ms'] * 1e3:.3f} us/launch ({v['bound_ms'] / v['ms']:.1%} of "
                f"its bound), torch {v['library_ms'] * 1e3:.3f} us (kernel / torch "
                f"{v['ms'] / v['library_ms']:.3f}x)")


def phase_probes(dev, rng, int_rate) -> dict:
    """The layout probes: P1-P3 against their plain versions at other
    shapes (:func:`probe_edge_checks`), then every module of
    ``tpuminter_torch.probes`` on one V at the scripts' sizes (B =
    16384, N = 1024): each holds its kernels against their plain
    versions at its shapes and its per-step chains against
    ``romix_walk``, raising on a difference, and times them. Returns
    the sites' stats."""
    import importlib

    from tpuminter_torch.probes import PROBES
    from tpuminter_torch.probes._common import B, N, make_walk

    stats = probe_stats()
    checks = probe_edge_checks(dev, rng, stats)
    say(f"  P1-P3: {checks} edge checks equal to their plain versions (P1 at 1-9 words at "
        "every word offset, around 2^21 words aligned and not, in place; P2 on both arms, "
        "with and without a carry, and one word off its storage; "
        "every P3 instantiation at B = 16384 on 128, 3 and 133 blocks, 2048 in one block, "
        "6144 over three bitcast blocks, 128 at one pass and on 3 blocks)")
    torch.cuda.empty_cache()
    walk = make_walk(dev, B, N)
    for name in PROBES:
        t0 = time.perf_counter()
        result = importlib.import_module(f"tpuminter_torch.probes.{name}").run(dev, walk=walk)
        say(f"  -- {name} ({time.perf_counter() - t0:.1f} s)")
        for line in result["lines"]:
            say(f"     {line}")
        for site, measured in result["sites"].items():
            record_site(stats[site], measured, int_rate)
    del walk
    torch.cuda.empty_cache()
    return stats


def ltc_genesis():
    from tpuminter_torch import chain

    g = LTC_GENESIS
    header = chain.BlockHeader(g["version"], bytes.fromhex(g["prev_hex"])[::-1],
                               bytes.fromhex(g["merkle_hex"])[::-1], g["timestamp"],
                               g["bits"], g["nonce"])
    if chain.hash_to_hex(header.block_hash()) != LTC_GENESIS_DSHA:
        fail("the Litecoin genesis header does not double-SHA to its block hash")
    if chain.hash_to_int(chain.scrypt_hash(header.pack())) != LTC_GENESIS_SCRYPT:
        fail("the Litecoin genesis header does not scrypt to its known value")
    return header


def phase_scrypt_path(dev, card: str, rng, kernels_info):
    """The SCRYPT path through ``CudaMiner()``, every launch count 0
    before and read after: a batch sweep (2^14 to 2^18 lanes, four
    batches each, at target 1: every lane mined), one chunk of the
    coordinator's size at batches 2^14, 2^15 and 2^16 (equal Results),
    an exhausted 2^20 range (the Litecoin genesis
    header, nonces [0, 2^20)) at target 1, the same range at a planted
    target (for phase 5), the Litecoin genesis block as a known answer,
    and a rolled SCRYPT job (the Bitcoin genesis coinbase split at byte
    48) that must give scrypt's answer, not double SHA's. Every Result is
    checked with hashlib."""
    from tpuminter_torch import chain, kernels
    from tpuminter_torch.cuda_worker import CudaMiner
    from tpuminter_torch.protocol import PowMode, Request

    ltc = ltc_genesis()

    def mine(miner, req):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = drain(miner.mine(req))
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def check(req, res, what):
        """Re-hash the Result's index with hashlib (a rolled job's header
        re-rolled on the host)."""
        header = req.header
        nonce = res.nonce
        if req.rolled:
            en, nonce = chain.split_global(res.nonce, req.nonce_bits)
            tmpl = chain.CoinbaseTemplate(req.coinbase_prefix, req.coinbase_suffix,
                                          req.extranonce_size)
            header = chain.rolled_header(header, tmpl, req.branch, en).pack()
        hdr = chain.BlockHeader.unpack(header).with_nonce(nonce).pack()
        value = chain.hash_to_int(chain.scrypt_hash(hdr))
        if value != res.hash_value or res.found != (value <= req.target):
            fail(f"{what}: the Result {res} fails the hashlib.scrypt check")
        return hdr

    # a batch's device time at each batch of the sweep (CUDA events over
    # back-to-back S1 + 19 + S2), before the counted run
    batch_ms = {}
    for b in SCRYPT_SWEEP:
        batch_ms[b] = event_ms(lambda: scrypt_dispatch(ltc.pack(), b, dev), 2)[0]
        torch.cuda.empty_cache()
    reset_launches(kernels)
    rates = {"kernel_mhs": kernels_info["kernel_mhs"], "sweep": {}}
    # (a) the batch sweep
    for b in SCRYPT_SWEEP:
        miner = CudaMiner(scrypt_batch=b)
        lower = int(rng.integers(0, 1 << 31))
        req = Request(31, PowMode.SCRYPT, lower, lower + SCRYPT_SWEEP_BATCHES * b - 1,
                      header=ltc.pack(), target=1)
        mine(miner, dataclasses.replace(req, upper=lower + b - 1))  # first use: scratch
        res, dt = mine(miner, req)
        check(req, res, f"sweep at batch {b}")
        if res.found or res.searched != SCRYPT_SWEEP_BATCHES * b:
            fail(f"sweep at batch {b}: unexpected Result {res}")
        rates["sweep"][b] = dict(mhs=res.searched / dt / 1e6, v_bytes=b * SCRYPT_N * 128,
                                 batch_ms=batch_ms[b], wall_ms=dt * 1e3,
                                 device_share=SCRYPT_SWEEP_BATCHES * batch_ms[b] / (dt * 1e3))
        say(f"  batch {b}: {res.searched / dt / 1e6:.4f} MH/s, V {b * SCRYPT_N * 128 / 2**30:.0f}"
            f" GiB; {SCRYPT_SWEEP_BATCHES} batches x {batch_ms[b]:.3f} ms of device time = "
            f"{rates['sweep'][b]['device_share']:.1%} of {dt * 1e3:.3f} ms wall on {card}")
        del miner
        torch.cuda.empty_cache()
    # (b) one chunk at the coordinator's size, at each batch that splits it
    # into whole batches; the median of SCRYPT_CHUNK_REPS timed runs each
    req = Request(32, PowMode.SCRYPT, 1 << 24, (1 << 24) + SCRYPT_COORD_CHUNK - 1,
                  header=ltc.pack(), target=1)
    rates["coord_chunk_sweep"] = {}
    chunk_results = set()
    for b in SCRYPT_CHUNK_SWEEP:
        miner = CudaMiner(scrypt_batch=b)
        mine(miner, req)  # first use: scratch
        runs = [mine(miner, req) for _ in range(SCRYPT_CHUNK_REPS)]
        dt = sorted(t for _, t in runs)[SCRYPT_CHUNK_REPS // 2]
        for res, _ in runs:
            check(req, res, f"coordinator-size chunk at batch {b}")
            chunk_results.add(res)
        rates["coord_chunk_sweep"][b] = dict(mhs=SCRYPT_COORD_CHUNK / dt / 1e6, seconds=dt,
                                             batches=-(-SCRYPT_COORD_CHUNK // b))
        say(f"  one coordinator-size chunk ({SCRYPT_COORD_CHUNK} nonces) at batch {b} "
            f"({-(-SCRYPT_COORD_CHUNK // b)} batches): median {dt * 1e3:.3f} ms of "
            f"{SCRYPT_CHUNK_REPS} = {SCRYPT_COORD_CHUNK / dt / 1e6:.4f} MH/s on {card}")
        del miner
        torch.cuda.empty_cache()
    if len(chunk_results) != 1:
        fail(f"the coordinator-size chunk's Result differs by batch: {chunk_results}")
    miner = CudaMiner()
    mine(miner, req)  # first use: scratch
    rates["coord_chunk"] = dict(nonces=SCRYPT_COORD_CHUNK,
                                **rates["coord_chunk_sweep"][miner.scrypt_batch])
    best = max(SCRYPT_CHUNK_SWEEP, key=lambda b: rates["coord_chunk_sweep"][b]["mhs"])
    say(f"  the chunk is fastest at batch {best}; the default batch is {miner.scrypt_batch}")
    # (c) an exhausted 2^20 range, the exact minimum; the same at another batch
    req = Request(33, PowMode.SCRYPT, 0, SCRYPT_RANGE - 1, header=ltc.pack(), target=1)
    res, dt = mine(miner, req)
    check(req, res, "exhausted 2^20 range")
    if res.found or res.searched != SCRYPT_RANGE:
        fail(f"exhausted 2^20 range: unexpected Result {res}")
    other = drain(CudaMiner(scrypt_batch=3 << 14).mine(req))
    if other != res:
        fail(f"the exhausted 2^20 range's minimum differs by batch: {res} vs {other}")
    rates["range_2_20"] = dict(mhs=res.searched / dt / 1e6, seconds=dt,
                               share_of_kernels=res.searched / dt / 1e6 / kernels_info["kernel_mhs"])
    say(f"  exhausted 2^20 range at target 1: min at nonce {res.nonce}, hashlib-checked, equal "
        f"at batch {3 << 14}; {dt:.3f} s = {res.searched / dt / 1e6:.4f} MH/s on {card}, "
        f"{rates['range_2_20']['share_of_kernels']:.1%} of S1 + 19 + S2's own rate")
    # the same range at a planted target: phase 5's job
    bits = compact_at_least(res.hash_value)
    planted = dataclasses.replace(req, job_id=34, target=chain.bits_to_target(bits))
    first = drain(miner.mine(planted))
    check(planted, first, "planted 2^20 range")
    if not first.found or first.nonce > res.nonce:
        fail(f"planted 2^20 range: {first} is not at or below the minimum's nonce {res.nonce}")
    e2e = {"bits": bits, "header": ltc.pack(), "max_nonce": SCRYPT_RANGE - 1, "first": first}
    say(f"  the same range at bits {bits:#010x}: first winner {first.nonce}, searched "
        f"{first.searched}, hashlib-checked")
    # (d) the Litecoin genesis block
    g = LTC_GENESIS["nonce"]
    req = Request(35, PowMode.SCRYPT, g - SCRYPT_RANGE + 1, g + SCRYPT_WINDOW_TAIL, header=ltc.pack(),
                  target=chain.bits_to_target(ltc.bits))
    res, dt = mine(miner, req)
    check(req, res, "Litecoin genesis")
    if not res.found or res.nonce > g:
        fail(f"Litecoin genesis: {res} is not a winner at or below {g}")
    if res.nonce == g and res.hash_value != LTC_GENESIS_SCRYPT:
        fail("Litecoin genesis: the winner's value is not the genesis block's")
    note = "" if res.nonce == g else f" (an earlier winner than {g}, hashlib-checked)"
    say(f"  Litecoin genesis: nonce {res.nonce} value {res.hash_value:#066x}{note}; "
        f"searched {res.searched} in {dt:.3f} s on {card}")
    # (e) a rolled SCRYPT job across an extranonce boundary
    cb = bytes.fromhex(GENESIS_COINBASE_HEX)
    genesis = chain.GENESIS_HEADER.pack()
    req = Request(36, PowMode.SCRYPT, (4 << 32) - SCRYPT_ROLLED_HALF,
                  (4 << 32) + SCRYPT_ROLLED_HALF - 1,
                  header=genesis, target=1, coinbase_prefix=cb[:48], coinbase_suffix=cb[49:],
                  extranonce_size=1, nonce_bits=32)
    low = drain(miner.mine(req))
    check(req, low, "rolled SCRYPT job, exhausted")
    req = dataclasses.replace(req, target=low.hash_value)
    res = drain(miner.mine(req))
    hdr = check(req, res, "rolled SCRYPT job, planted")
    if (res.nonce, res.found, res.searched) != (low.nonce, True, low.nonce - req.lower + 1):
        fail(f"rolled SCRYPT job: {res} is not the planted minimum at {low.nonce}")
    if chain.hash_to_int(chain.dsha256(hdr)) == res.hash_value:
        fail("rolled SCRYPT job: the Result is the double-SHA answer")
    en, nonce = chain.split_global(res.nonce, 32)
    say(f"  rolled SCRYPT job (extranonces 3-4, 2^16 indices): the planted minimum at "
        f"extranonce {en} nonce {nonce}, found, searched {res.searched}; hashlib.scrypt-checked "
        "on the re-rolled header, and not the double-SHA value")
    launches = read_launches(kernels, SCRYPT_PATH_KERNELS, "SCRYPT")
    return launches, rates, e2e


def scrypt_dispatch(header80, b, dev):
    """One batch of the SCRYPT path's dispatch (S1, 19, S2 at N = 1024)
    on ``b`` nonces, queued, with a scratch of its own."""
    from tpuminter_torch import kernels
    from tpuminter_torch.ops import scrypt as S

    v = kernels.romix_scratch(SCRYPT_N_LOG2, b, dev)
    words = S.header_to_words(header80[:76])
    nonces = torch.arange(b, dtype=torch.int64, device=dev)
    x = kernels.scrypt_front(words, nonces, SCRYPT_N_LOG2, v)
    x = kernels.romix_walk(x, v, SCRYPT_N_LOG2, SCRYPT_N)
    return kernels.scrypt_back(words, nonces, x, [0] * 8)[1]


# ---- the pod worker (PodMiner, one process a card) --------------------------

#: every kernel the pod's jobs launch, on every rank: K1 (the self-check),
#: 3h (TARGET), 2h (exact-min), 6t (MIN), R and K5's sched arm (rolled,
#: roll_batch 8), K4 (rolled, roll_batch 1), S1, 19 and S2 (SCRYPT)
POD_PATH_KERNELS = ("sha256_batch", "search_candidates_header", "search_target_header",
                    "min_toy_toy", "extranonce_roll", "search_candidates_hdr_batch_sched",
                    "search_candidates_hdr", "scrypt_front", "romix_walk", "scrypt_back")
#: nonces past the pod's whole spans in the exact-min and MIN jobs, which
#: the rank's own card sweeps (the ragged tails)
POD_RAGGED = 12_345
#: collective rounds timed a layout (one int64, the candidate sweep's
#: all_reduce(MIN) and its host read)
POD_ROUNDS = 2000


def pod_jobs():
    """``[(miner kwargs, [(label, request), ...]), ...]``: the pod phase's
    jobs, grouped by miner, in the order every rank runs them."""
    from tpuminter_torch import chain
    from tpuminter_torch.protocol import PowMode, Request

    genesis = chain.GENESIS_HEADER
    target = chain.bits_to_target(genesis.bits)
    cb = bytes.fromhex(GENESIS_COINBASE_HEX)
    rolled = Request(11, PowMode.TARGET, GENESIS_ROLLED - (1 << 30) + 1, GENESIS_ROLLED + 4095,
                     header=genesis.pack(), target=target, coinbase_prefix=cb[:48],
                     coinbase_suffix=cb[49:], extranonce_size=1, nonce_bits=32)
    ltc = ltc_genesis()
    scrypt_n = (1 << 16) + SCRYPT_RAGGED  # a batch and a ragged tail
    return [
        ({}, [
            ("genesis", Request(1, PowMode.TARGET, GENESIS_NONCE - (1 << 30) + 1,
                                GENESIS_NONCE + 4095, header=genesis.pack(), target=target)),
            ("min", Request(4, PowMode.MIN, 0, (1 << 30) + POD_RAGGED - 1, data=MIN_DATA)),
            ("rolled_rb8", rolled),
            ("scrypt_exhausted", Request(21, PowMode.SCRYPT, ltc.nonce + 1,
                                         ltc.nonce + scrypt_n, header=ltc.pack(), target=1)),
            # the Litecoin genesis nonce 100 nonces into the ragged tail
            ("scrypt_window", Request(22, PowMode.SCRYPT, ltc.nonce - (1 << 16) - 100,
                                      ltc.nonce - (1 << 16) - 101 + scrypt_n, header=ltc.pack(),
                                      target=chain.bits_to_target(ltc.bits))),
        ]),
        ({"exact_min": True}, [
            ("exact_exhausted", Request(3, PowMode.TARGET, GENESIS_NONCE - (1 << 29) - POD_RAGGED,
                                        GENESIS_NONCE - 1, header=genesis.pack(),
                                        target=target)),
        ]),
        ({"roll_batch": 1}, [("rolled_rb1", rolled)]),
    ]


def timed_mine(miner, req):
    """A Result and its seconds, up to the end of the device work it
    queued."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = drain(miner.mine(req))
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def collective_us(pod) -> float:
    """µs of one round of the candidate sweep's collective on ``pod``: an
    ``all_reduce(MIN)`` of one int64 on the rank's card and its host read."""
    t = torch.ones(1, dtype=torch.int64, device=pod.device)
    int(pod.all_reduce_min(t)[0])
    t0 = time.perf_counter()
    for _ in range(POD_ROUNDS):
        int(pod.all_reduce_min(t)[0])
    return (time.perf_counter() - t0) / POD_ROUNDS * 1e6


def run_pod_jobs(pod, passes: int = 2) -> dict:
    """Every pod job on this rank (:func:`pod_jobs`), ``passes`` times: the
    leader mines them through ``PodMiner(pod=pod)`` at its defaults but
    the group's kwargs, a follower replays them. Returns the leader's
    ``{label: [found, nonce, hash, searched, [seconds a pass]]}`` (empty
    on a follower); every pass must give the same Result. The first pass
    pays the first uses (the collectives' set-up, V, the self-check)."""
    from tpuminter_torch.pod_worker import PodMiner, follower_loop

    out = {}
    for kwargs, jobs in pod_jobs():
        miner = PodMiner(pod=pod, spmd_leader=pod.is_leader and pod.world > 1, **kwargs)
        if pod.is_leader:
            for _ in range(passes):
                for label, req in jobs:
                    res, dt = timed_mine(miner, req)
                    got = [res.found, res.nonce, res.hash_value, res.searched]
                    if label in out and out[label][:4] != got:
                        fail(f"pod {label}: a second pass gave {got}, not {out[label][:4]}")
                    out.setdefault(label, got + [[]])[4].append(dt)
            miner.close()
        else:
            follower_loop(miner)
        del miner
        torch.cuda.empty_cache()
    return out


def pod_rank_main(out_path: str) -> int:
    """``chip_smoke.py --pod-rank OUT``: one rank of phase 4e (b)'s pod, from
    the ``TPUMINTER_*`` triple; writes its Results, launch counts and
    collective round to OUT as JSON."""
    sys.path.insert(0, ROOT)
    from tpuminter_torch import kernels
    from tpuminter_torch.parallel import distributed

    pod = distributed.init_from_env("cuda")
    if pod is None:
        fail("--pod-rank needs TPUMINTER_COORD_ADDR, TPUMINTER_NUM_PROCS and TPUMINTER_PROC_ID")
    reset_launches(kernels)
    results = run_pod_jobs(pod)
    launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    round_us = collective_us(pod)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tpuminter"))
    out = dict(rank=pod.rank, world=pod.world, backend=pod.backend, device=str(pod.device),
               results=results, launches=launches, collective_us=round_us, loaded=loaded)
    pod.close()
    if loaded:
        fail(f"a pod rank loaded {loaded}")
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    return 0


def free_tcp_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def repo_env(**extra) -> dict:
    """This environment with the repository on ``PYTHONPATH``, and ``extra``."""
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def pod_env(store: str, world: int, rank: int) -> dict:
    """A pod rank's environment: the ``TPUMINTER_*`` rendezvous triple."""
    return repo_env(TPUMINTER_COORD_ADDR=store, TPUMINTER_NUM_PROCS=str(world),
                    TPUMINTER_PROC_ID=str(rank))


def check_pod_result(label: str, req, got) -> None:
    """Hold a pod Result ``[found, nonce, hash, ...]`` to hashlib (the
    double SHA of its header, re-rolled for a rolled job),
    ``hashlib.scrypt`` or ``toy_hash``."""
    from tpuminter_torch import chain
    from tpuminter_torch.protocol import MIN_UNTRACKED, PowMode

    found, nonce, value = got[:3]
    if req.mode == PowMode.MIN:
        ok = value == chain.toy_hash(req.data, nonce)
    elif value == MIN_UNTRACKED:
        ok = not found
    else:
        header = chain.BlockHeader.unpack(req.header)
        if req.rolled:
            en, nonce = chain.split_global(nonce, req.nonce_bits)
            tmpl = chain.CoinbaseTemplate(req.coinbase_prefix, req.coinbase_suffix,
                                          req.extranonce_size)
            header = chain.rolled_header(req.header, tmpl, req.branch, en)
        packed = header.with_nonce(nonce).pack()
        digest = chain.scrypt_hash(packed) if req.mode == PowMode.SCRYPT else chain.dsha256(packed)
        ok = value == chain.hash_to_int(digest) and found == (value <= req.target)
    if not ok:
        fail(f"pod {label}: the Result {got[:4]} fails its hashlib check")


def phase_pod(card: str):
    """Phase 4e: the pod worker. (a) one rank on NCCL in this process,
    ``PodMiner()`` at its defaults, every job beside ``CudaMiner()``'s
    (run before and after it, uncounted), each miner over the jobs twice
    (the second pass warm); (b) two ranks sharing the card
    over gloo, as two processes, equal to (a); (c) the worker CLI at
    ``--backend pod`` as two ranks against the unchanged coordinator and
    client. Returns (a)'s launch counts and the phase's numbers."""
    from tpuminter_torch import kernels
    from tpuminter_torch.cuda_worker import CudaMiner
    from tpuminter_torch.parallel import distributed

    groups = pod_jobs()
    reqs = {label: req for _, jobs in groups for label, req in jobs}
    cuda = {label: [] for label in reqs}

    def run_cuda():  # two passes a miner, as the pod's
        for kwargs, jobs in groups:
            miner = CudaMiner(**kwargs)
            for _ in range(2):
                for label, req in jobs:
                    cuda[label].append(timed_mine(miner, req))
            del miner
            torch.cuda.empty_cache()

    run_cuda()
    pod = distributed.init_pod(f"127.0.0.1:{free_tcp_port()}", 1, 0, device="cuda")
    if pod.backend != "nccl":
        fail(f"one rank on one card took {pod.backend}, not nccl")
    reset_launches(kernels)
    one = run_pod_jobs(pod)
    launches = read_launches(kernels, POD_PATH_KERNELS, "pod (one rank, NCCL)")
    rounds = {"nccl_one_rank": collective_us(pod)}
    pod.close()
    run_cuda()
    rates = {}
    for label, req in reqs.items():
        got, want = one[label], cuda[label][0][0]
        check_pod_result(label, req, got)
        fixed = 4 if (req.mode.value == "min" or not want.found) else 3
        if got[:fixed] != [want.found, want.nonce, want.hash_value, want.searched][:fixed]:
            fail(f"pod {label}: {got[:4]} != CudaMiner()'s {want}")
        unit, scale = ("MH/s", 1e6) if req.mode.value == "scrypt" else ("GH/s", 1e9)
        rates[label] = {"pod_one_rank": [got[3] / dt / scale for dt in got[4]],
                        "cuda": [r.searched / dt / scale for r, dt in cuda[label]], "unit": unit}
    say(f"  (a) one rank on NCCL, PodMiner() defaults: every Result equal to CudaMiner()'s on "
        f"the fields both fix and hashlib-checked; a collective round (all_reduce MIN, one "
        f"int64, and its host read) {rounds['nccl_one_rank']:.1f} µs")

    # (b) two ranks sharing the one card, over gloo
    log_dir = os.path.join(ROOT, "build", "tpuminter_torch")
    os.makedirs(log_dir, exist_ok=True)
    store = f"127.0.0.1:{free_tcp_port()}"
    procs = []
    t0 = time.perf_counter()
    for rank in range(2):
        env = pod_env(store, 2, rank)
        log = open(os.path.join(log_dir, f"pod_rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--pod-rank",
             os.path.join(log_dir, f"pod_rank{rank}.json")], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    try:
        for proc, _ in procs:
            proc.wait(timeout=300)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for rank, (proc, _) in enumerate(procs):
        if proc.returncode != 0:
            with open(os.path.join(log_dir, f"pod_rank{rank}.log")) as fh:
                print(fh.read()[-4000:], file=sys.stderr)
            fail(f"two-rank pod: rank {rank} exited with {proc.returncode}")
    two = []
    for rank in range(2):
        with open(os.path.join(log_dir, f"pod_rank{rank}.json")) as fh:
            two.append(json.load(fh))
    if [r["backend"] for r in two] != ["gloo", "gloo"] or any(r["loaded"] for r in two):
        fail(f"two-rank pod: backends {[r['backend'] for r in two]}, loaded "
             f"{[r['loaded'] for r in two]}")
    for r in two:
        missing = [k for k in POD_PATH_KERNELS if r["launches"][k] < 1]
        if missing:
            fail(f"two-rank pod: rank {r['rank']} never launched {missing}")
    for label in reqs:
        got = two[0]["results"][label]
        if got[:4] != one[label][:4]:
            fail(f"two-rank pod {label}: {got[:4]} != one rank's {one[label][:4]}")
        unit_scale = 1e6 if rates[label]["unit"] == "MH/s" else 1e9
        rates[label]["pod_two_ranks_one_card"] = [got[3] / dt / unit_scale for dt in got[4]]
    rounds["gloo_two_ranks"] = [r["collective_us"] for r in two]
    say(f"  (b) two ranks sharing the card over gloo ({time.perf_counter() - t0:.1f} s with "
        f"their start): every Result equal to (a)'s, every pod kernel launched on both ranks; "
        f"a collective round {rounds['gloo_two_ranks'][0]:.1f} / "
        f"{rounds['gloo_two_ranks'][1]:.1f} µs; rank launches {[r['launches'] for r in two]}")
    for label, r in rates.items():
        one_r, two_r, cuda_r = r["pod_one_rank"], r["pod_two_ranks_one_card"], r["cuda"]
        say(f"  pod {label}: {one_r[1]:.4f} {r['unit']} one rank (NCCL), {two_r[1]:.4f} two ranks "
            f"sharing the card (gloo), beside CudaMiner() {cuda_r[1]:.4f} / {cuda_r[3]:.4f} "
            f"(before / after), second passes, on {card}; first passes {one_r[0]:.4f}, "
            f"{two_r[0]:.4f}, {cuda_r[0]:.4f} / {cuda_r[2]:.4f}")
    e2e_seconds = phase_pod_end_to_end(log_dir)
    return launches, {"rates": rates, "collective_us": rounds, "e2e_seconds": e2e_seconds}


def phase_pod_end_to_end(log_dir: str) -> float:
    """(c): ``python -m tpuminter_torch.worker ADDR --backend pod`` as two
    ranks sharing the card, against the unchanged coordinator; the
    unchanged client sends a genesis TARGET job and a MIN job. The
    coordinator must see one worker join, with backend pod; SIGINT to the
    leader ends its session, whose close releases the follower."""
    from tpuminter_torch import chain

    t0 = time.perf_counter()
    addr = f"127.0.0.1:{free_udp_port()}"
    store = f"127.0.0.1:{free_tcp_port()}"
    procs, logs = [], []

    def start(name, args, env):
        log = open(os.path.join(log_dir, f"pod_e2e_{name}.log"), "w")
        logs.append((name, log))
        procs.append(subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, env=env,
                                      stdout=log, stderr=subprocess.STDOUT))
        return procs[-1]

    def log_text(name):
        with open(os.path.join(log_dir, f"pod_e2e_{name}.log")) as fh:
            return fh.read()

    def client(args):
        out = subprocess.run([sys.executable, "-m", "tpuminter.client", addr, *args,
                              "--timeout", "120"], cwd=ROOT, env=repo_env(),
                             capture_output=True, text=True, timeout=180)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("Result ")]
        if out.returncode != 0 or len(lines) != 1:
            fail(f"pod client {args[:2]} failed (rc {out.returncode}): {out.stdout}{out.stderr}")
        return lines[0].split()

    try:
        coordinator = start("coordinator", ["tpuminter.coordinator", addr.split(":")[1]],
                            repo_env())
        deadline = time.time() + 60
        while "listening" not in log_text("coordinator"):
            if coordinator.poll() is not None or time.time() > deadline:
                fail("the pod phase's coordinator did not start")
            time.sleep(0.2)
        workers = [start(f"rank{r}", ["tpuminter_torch.worker", addr, "--backend", "pod"],
                         pod_env(store, 2, r)) for r in range(2)]
        genesis = chain.GENESIS_HEADER
        _, hash_hex, nonce = client(["--header", genesis.pack().hex(), "--bits", "0x1d00ffff",
                                     "--max-nonce", str(GENESIS_NONCE + 4095)])
        digest = genesis.with_nonce(int(nonce)).block_hash()
        if chain.hash_to_hex(digest) != hash_hex or \
                chain.hash_to_int(digest) > chain.bits_to_target(genesis.bits):
            fail(f"pod e2e genesis Result {hash_hex} {nonce} fails the hashlib check")
        data = "hello bitcoin"
        _, fold, min_nonce = client([data, str((1 << 30) - 1)])
        if int(fold) != chain.toy_hash(data.encode(), int(min_nonce)):
            fail(f"pod e2e MIN Result {fold} {min_nonce} fails the toy_hash check")
        joins = [ln for ln in log_text("coordinator").splitlines() if " joined (backend=" in ln]
        if len(joins) != 1 or "backend=pod" not in joins[0]:
            fail(f"the coordinator's joins are not one pod worker: {joins}")
        say(f"  (c) --backend pod, two ranks sharing the card: e2e TARGET Result {hash_hex} "
            f"{nonce} (hashlib-checked), MIN Result {fold} {min_nonce} (toy_hash-checked); "
            f"coordinator log: {joins[0].split('INFO')[-1].strip()}")
        workers[0].send_signal(signal.SIGINT)  # the leader's session ends; close() stops rank 1
        for w in workers:
            w.wait(timeout=60)
        if workers[1].returncode != 0:
            fail(f"the follower rank exited with {workers[1].returncode}")
        seconds = time.perf_counter() - t0
        say(f"  (c) the leader's SIGINT released the follower, which exited 0; {seconds:.1f} s")
        return seconds
    except BaseException:
        for name, log in logs:
            log.flush()
            print(f"--- pod {name} log tail ---\n{log_text(name)[-3000:]}", file=sys.stderr)
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for _, log in logs:
            log.close()


#: phase 5's dict job: candidates (past the coordinator's 32 KiB window
#: budget), top-k slots and seed
DICT_N, DICT_K, DICT_SEED = 6000, 8, 42
#: phase 5's crash drill: a MIN job of 2^36 nonces (~4 s of the card, 128
#: of the coordinator's chunks), and how long it runs before the
#: coordinator is killed
CRASH_DATA, CRASH_N, CRASH_AFTER_S = b"tpuminter_torch crash drill", 1 << 36, 1.5


def free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_end_to_end(hc_expect, scrypt_job, card: str):
    """The process-level phase; ``hc_expect`` holds phase 4c's
    ``(searched, acc)`` of fmin and top-k over [0, 2^32) under its
    ``"seed"``, ``scrypt_job`` phase 4d's planted SCRYPT job. A port
    worker pinned to ``--codec json`` answers the MIN job against a
    journaled coordinator and is stopped; then the port worker at its
    default codec (binary) with ``--reconnect`` and ``--profile`` runs
    every other job (its trace, of the genesis job's first chunk, is
    read back by :func:`worker_trace`), and :func:`crash_drill` kills
    and restarts the coordinator under it. Returns each job's seconds
    through the client (``seconds``, by job; the hashcore jobs under
    ``"hashcore"``), the worker's trace window and the crash drill's
    Result through ``CudaMiner()``."""
    from tpuminter_torch import chain
    from tpuminter_torch.cuda_worker import CudaMiner
    from tpuminter_torch.protocol import PowMode, Request

    crash_expect = drain(CudaMiner().mine(Request(9, PowMode.MIN, 0, CRASH_N - 1,
                                                  data=CRASH_DATA)))

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

    journal = os.path.join(log_dir, "e2e_coordinator.wal")
    if os.path.exists(journal):
        os.remove(journal)
    coordinator = ["tpuminter.coordinator", str(port), "--roll-budget", "2", "--journal", journal]

    def start_coordinator(name):
        start(name, coordinator)
        proc, deadline = procs[-1], time.time() + 60
        while "listening" not in open(os.path.join(log_dir, f"e2e_{name}.log")).read():
            if proc.poll() is not None or time.time() > deadline:
                fail(f"the coordinator ({name}) did not start")
            time.sleep(0.2)
        return proc

    def log_text(name):
        with open(os.path.join(log_dir, f"e2e_{name}.log")) as fh:
            return fh.read()

    trace_dir = os.path.join(log_dir, "e2e_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    try:
        coordinator_proc = start_coordinator("coordinator")
        # a worker pinned to JSON (what it speaks to a coordinator that
        # never sends binary), for the MIN job only
        start("worker_json", ["tpuminter_torch.worker", addr, "--codec", "json"])
        json_worker = procs[-1]
        data = "hello bitcoin"
        t0 = time.perf_counter()
        _, fold, nonce = client([data, str((1 << 30) - 1)])
        seconds = {"min": time.perf_counter() - t0}
        if int(fold) != chain.toy_hash(data.encode(), int(nonce)):
            fail(f"e2e MIN Result {fold} {nonce} fails the toy_hash check")
        say(f"  e2e MIN: Result {fold} {nonce} (toy_hash-checked) from the --codec json worker "
            f"({seconds['min']:.1f} s through the client)")
        json_worker.send_signal(signal.SIGINT)  # ends its session, which logs what it sent
        json_worker.wait(timeout=30)
        sessions = re.findall(r"(\d+) Results sent, (\d+) of them binary", log_text("worker_json"))
        if len(sessions) != 1 or int(sessions[0][0]) == 0 or int(sessions[0][1]) != 0:
            fail(f"the --codec json worker's session sent no Results or some in binary: "
                 f"{sessions}")
        joined = re.search(r"miner (\d+) joined \(backend=cuda[^)]*codec=json",
                           log_text("coordinator"))
        if joined is None:
            fail("the coordinator's log shows no cuda worker joining with codec=json")
        deadline = time.time() + 30
        while f"miner {joined.group(1)} died" not in log_text("coordinator"):
            if time.time() > deadline:
                fail("the coordinator did not see the --codec json worker go")
            time.sleep(0.2)
        say(f"  --codec json worker: joined with codec=json, sent {sessions[0][0]} Results, all "
            "in JSON; stopped")
        # the port worker at its defaults (the binary codec), redialing a
        # lost coordinator, tracing its first chunk
        start("worker", ["tpuminter_torch.worker", "--coordinator", addr, "--reconnect",
                         "--profile", trace_dir])
        worker = procs[-1]
        genesis = chain.GENESIS_HEADER
        t0 = time.perf_counter()
        _, hash_hex, nonce = client(["--header", genesis.pack().hex(), "--bits", "0x1d00ffff",
                                     "--max-nonce", str(GENESIS_NONCE + 4095)])
        seconds["genesis"] = time.perf_counter() - t0
        nonce = int(nonce)
        digest = genesis.with_nonce(nonce).block_hash()
        if chain.hash_to_hex(digest) != hash_hex or \
                chain.hash_to_int(digest) > chain.bits_to_target(genesis.bits):
            fail(f"e2e genesis Result {hash_hex} {nonce} fails the hashlib check")
        say(f"  e2e TARGET: Result {hash_hex} {nonce} (hashlib-checked; "
            f"{seconds['genesis']:.1f} s through the client, the worker's first chunk)")
        window = worker_trace(os.path.join(log_dir, "e2e_worker.log"), trace_dir, card)
        cb = bytes.fromhex(GENESIS_COINBASE_HEX)
        t0 = time.perf_counter()
        _, hash_hex, en_arg, nonce_arg = client([
            "--header", genesis.pack().hex(), "--bits", "0x1d00ffff",
            "--coinbase-prefix", cb[:48].hex(), "--coinbase-suffix", cb[49:].hex(),
            "--extranonce-size", "1", "--max-extranonce", "4"])
        dt = seconds["rolled"] = time.perf_counter() - t0
        en, nonce = int(en_arg.split("=")[1]), int(nonce_arg.split("=")[1])
        hdr = chain.rolled_header(genesis.pack(), chain.CoinbaseTemplate(cb[:48], cb[49:], 1),
                                  (), en).with_nonce(nonce)
        digest = hdr.block_hash()
        if chain.hash_to_hex(digest) != hash_hex or \
                chain.hash_to_int(digest) > chain.bits_to_target(genesis.bits):
            fail(f"e2e rolled Result {hash_hex} extranonce={en} nonce={nonce} fails the "
                 "hashlib check")
        say(f"  e2e rolled: Result {hash_hex} extranonce={en} nonce={nonce} "
            f"(re-rolled and hashlib-checked; {dt:.1f} s through the client)")
        # SCRYPT: phase 4d's range at its planted bits
        t0 = time.perf_counter()
        _, hash_hex, nonce = client([
            "--header", scrypt_job["header"].hex(), "--bits", hex(scrypt_job["bits"]),
            "--scrypt", "--max-nonce", str(scrypt_job["max_nonce"])])
        scrypt_seconds = seconds["scrypt"] = time.perf_counter() - t0
        hdr = chain.BlockHeader.unpack(scrypt_job["header"]).with_nonce(int(nonce)).pack()
        digest = chain.scrypt_hash(hdr)
        if chain.hash_to_hex(digest) != hash_hex or \
                chain.hash_to_int(digest) > chain.bits_to_target(scrypt_job["bits"]):
            fail(f"e2e SCRYPT Result {hash_hex} {nonce} fails the hashlib.scrypt check")
        first = scrypt_job["first"]
        same = "equal to" if int(nonce) == first.nonce else "not"
        say(f"  e2e SCRYPT: Result {hash_hex} {nonce} (hashlib.scrypt-checked; {same} phase 4d's "
            f"first winner {first.nonce}; {scrypt_seconds:.1f} s through the client)")
        seconds["hashcore"] = phase_end_to_end_hashcore(addr, env, hc_expect)
        seconds["dict"] = phase_end_to_end_dict(addr, env, log_dir)
        seconds["crash"] = crash_drill(addr, env, coordinator_proc, start_coordinator,
                                       crash_expect)
        coord_log = log_text("coordinator") + log_text("coordinator2")
        joins = {name: [ln for ln in log_text(name).splitlines()
                        if "joined (backend=cuda" in ln and "codec=bin" in ln]
                 for name in ("coordinator", "coordinator2")}
        if not all(joins.values()) or not all("workloads=dict,hashcore" in ln
                                              for lns in joins.values() for ln in lns):
            fail(f"the coordinators' logs show no cuda worker advertising the binary codec "
                 f"and dict,hashcore in each incarnation: {joins}")
        say(f"  coordinator log: {joins['coordinator'][0].split('INFO')[-1].strip()}")
        sessions = [ln for ln in log_text("worker").splitlines() if "Results sent" in ln]
        sent = [tuple(map(int, re.search(r"(\d+) Results sent, (\d+) of them binary",
                                         ln).groups())) for ln in sessions]
        if not sent or not all(n > 0 and b == n for n, b in sent):
            fail(f"the worker's session before the crash sent no Results or some in JSON: "
                 f"{sessions}")
        say(f"  worker log: the session before the crash sent {sent[0][0]} Results, all in "
            "the binary codec, to a coordinator that answered every job")
        refusals = [ln for ln in coord_log.splitlines() if "refused chunk" in ln]
        refusals += [ln for name in ("worker_json", "worker") for ln in
                     log_text(name).splitlines() if "refusing chunk" in ln]
        if refusals:
            fail(f"the port worker refused chunks: {refusals[:4]}")
        say("  coordinator and worker logs: no refused chunk")
        if worker.poll() is not None:
            fail("the worker exited early")
        return seconds, window, crash_expect
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


def crash_drill(addr, env, coordinator, restart, expect, client=("-m", "tpuminter.client"),
                label="e2e") -> float:
    """A MIN job (``CRASH_DATA`` over ``CRASH_N`` nonces) through a
    client with ``--reconnect`` (``client``: the interpreter arguments
    that start it): ``CRASH_AFTER_S`` into it the coordinator is killed
    (SIGKILL) and restarted from its journal on the same port; the port
    worker redials by itself. The client must print exactly one Result,
    equal to ``expect`` (the same job through ``CudaMiner()`` in this
    process). Returns the job's seconds."""
    t0 = time.perf_counter()
    client = subprocess.Popen(
        [sys.executable, *client, addr, CRASH_DATA.decode(), str(CRASH_N - 1),
         "--reconnect", "--client-key", f"chip-smoke-crash-{label}", "--timeout", "300"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        time.sleep(CRASH_AFTER_S)
        if client.poll() is not None:
            fail("crash drill: the job ended before the coordinator was killed")
        coordinator.kill()
        coordinator.wait()
        restart("coordinator2")
        out, err = client.communicate(timeout=400)
        if label != "e2e":
            check_imports(f"{label} crash-drill client", err, torch_too=True)
    finally:
        if client.poll() is None:
            client.kill()
            client.wait()
    seconds = time.perf_counter() - t0
    lines = [ln for ln in out.splitlines() if ln.startswith("Result ")]
    if client.returncode != 0 or len(lines) != 1:
        fail(f"crash drill: client rc {client.returncode}: {out}{err}")
    _, fold, nonce = lines[0].split()
    if (int(fold), int(nonce)) != (expect.hash_value, expect.nonce):
        fail(f"crash drill: Result {fold} {nonce} != CudaMiner's {expect.hash_value} "
             f"{expect.nonce}")
    say(f"  {label} crash drill: MIN over 2^{CRASH_N.bit_length() - 1} nonces, the coordinator "
        f"killed {CRASH_AFTER_S} s in and restarted from its journal: one Result {fold} "
        f"{nonce}, equal to CudaMiner's ({seconds:.1f} s through the client)")
    return seconds


def dict_score(seed: int, candidate: bytes) -> int:
    """The dict workload's objective: the low 64 bits, little-endian, of
    ``SHA-256(seed_le8 ‖ candidate)``."""
    digest = hashlib.sha256(struct.pack("<Q", seed) + candidate).digest()
    return int.from_bytes(digest[:8], "little")


def dict_catalog(log_dir):
    """Phase 5's dict catalog: DICT_N seeded candidates written one a
    line to a file for the client; returns the file's path, the
    candidates and their top-k as hashlib scores them."""
    rng = np.random.default_rng(SEED + 5)
    cands = [b"candidate-%05d-%s" % (i, rng.bytes(6).hex().encode()) for i in range(DICT_N)]
    path = os.path.join(log_dir, "e2e_dict_candidates.txt")
    with open(path, "wb") as fh:
        fh.write(b"\n".join(cands) + b"\n")
    want = sorted([dict_score(DICT_SEED, c), i] for i, c in enumerate(cands))[:DICT_K]
    return path, cands, want


def phase_end_to_end_dict(addr, env, log_dir, client=("-m", "tpuminter.client"),
                          label="e2e") -> float:
    """A dict job through a client (``client``: the interpreter
    arguments that start it; the unchanged one by default): top-k (k =
    8) over a seeded catalog of DICT_N candidates, past the
    coordinator's 32 KiB window budget (its chunks ride window Setups),
    answered by the port worker alone and checked with hashlib. Returns
    its seconds."""
    path, _cands, want = dict_catalog(log_dir)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, *client, addr, "--workload", "dict",
                          "--variant", "topk", "--k", str(DICT_K), "--seed", str(DICT_SEED),
                          "--candidates", path, "--timeout", "300"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=400)
    seconds = time.perf_counter() - t0
    if label != "e2e":
        check_imports(f"{label} dict client", out.stderr, torch_too=True)
    if out.returncode != 0 or "Result [dict] topk" not in out.stdout:
        fail(f"client dict job failed (rc {out.returncode}): {out.stdout}{out.stderr}")
    searched = int(re.search(r"searched=(\d+)", out.stdout).group(1))
    pairs = [[int(v), int(i)] for v, i in re.findall(r"value=(\d+) index=(\d+)", out.stdout)]
    if (searched, pairs) != (DICT_N, want):
        fail(f"e2e dict topk: searched={searched} {pairs} != hashlib's {want}")
    say(f"  {label} dict topk (k = {DICT_K}) over {DICT_N} candidates: {pairs[0]} ... "
        f"searched={searched}, equal to hashlib ({seconds:.1f} s through the client)")
    return seconds


def phase_end_to_end_hashcore(addr, env, hc_expect) -> dict:
    """Hashcore jobs through the unchanged client: fmin and top-k (k = 8)
    over [0, 2^32), which must equal phase 4c's; sum over 2^20 indices
    and a first-match over 2^20 with a planted first hit (its index and
    value), both checked with numpy (the coordinator recomputes these claims on its host, so
    they stay small)."""
    def client(args):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "tpuminter.client", addr, "--workload",
                              "hashcore", *args, "--timeout", "300"], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=400)
        if out.returncode != 0 or "Result [hashcore]" not in out.stdout:
            fail(f"client {args[:2]} failed (rc {out.returncode}): {out.stdout}{out.stderr}")
        searched = int(re.search(r"searched=(\d+)", out.stdout).group(1))
        return out.stdout, searched, time.perf_counter() - t0

    seconds = {}
    seed = hc_expect["seed"]
    for variant in ("fmin", "topk"):
        text, searched, seconds[variant] = client(
            ["--variant", variant, "--seed", str(seed), "--k", str(HC_K),
             "--max-nonce", str(HC_N - 1)])
        pairs = [[int(v), int(i)] for v, i in re.findall(r"value=(\d+) index=(\d+)", text)]
        want_searched, want = hc_expect[variant]
        if (searched, pairs) != (want_searched, [want] if variant == "fmin" else want):
            fail(f"e2e hashcore {variant}: {searched} {pairs} != phase 4c's {hc_expect[variant]}")
        say(f"  e2e hashcore {variant} over 2^32: {pairs[0]}{' ...' if len(pairs) > 1 else ''} "
            f"searched={searched}, equal to phase 4c ({seconds[variant]:.1f} s through the client)")
    n = 1 << 20
    sum_seed = seed ^ 0x5A5A
    text, searched, seconds["fsum"] = client(
        ["--variant", "fsum", "--seed", str(sum_seed), "--max-nonce", str(n - 1)])
    total, count = map(int, re.search(r"total=(\d+) count=(\d+)", text).groups())
    if [searched, [total, count]] != list(np_fold("fsum", sum_seed, 0, n)):
        fail(f"e2e hashcore fsum: total={total} count={count} searched={searched} != numpy")
    say(f"  e2e hashcore fsum over 2^20: total={total} count={count}, equal to numpy "
        f"({seconds['fsum']:.1f} s)")
    fm_seed, thr = planted_seed(700_001, 1 << 30), 1 << 30
    text, searched, seconds["fmatch"] = client(
        ["--variant", "fmatch", "--seed", str(fm_seed), "--threshold", str(thr),
         "--max-nonce", str(n - 1)])
    got = [int(x) for x in re.search(r"index=(\d+) value=(\d+) probes=(\d+)", text).groups()]
    want = np_fold("fmatch", fm_seed, 0, n, thr)[1]
    # probes count from the matching chunk's start, which the coordinator carves
    if got[:2] != want[:2]:
        fail(f"e2e hashcore fmatch: index and value {got[:2]} != numpy {want[:2]}")
    say(f"  e2e hashcore fmatch over 2^20: index={got[0]} value={got[1]} probes={got[2]}, "
        f"equal to numpy ({seconds['fmatch']:.1f} s)")
    return seconds

#: the roots no port process may import: the JAX stack and the JAX package
#: (the port's coordinator and client add torch: a coordinator host needs
#: no CUDA stack)
FORBIDDEN_ROOTS = ("jax", "jaxlib", "tpuminter")
#: ``python -X importtime``'s line for one imported module (a module
#: imported on one thread while another imports can log a negative time)
IMPORTTIME = re.compile(r"^import time:\s+-?\d+\s+\|\s+-?\d+\s+\|\s+(\S+)", re.M)


def check_imports(name: str, text: str, torch_too: bool) -> list:
    """The modules ``python -X importtime`` logged in ``text``; fails on
    none (the flag was lost) or on a forbidden root among them."""
    mods = [m.strip() for m in IMPORTTIME.findall(text)]
    if not mods:
        fail(f"{name}: no python -X importtime lines in its log")
    roots = FORBIDDEN_ROOTS + (("torch",) if torch_too else ())
    bad = sorted({m for m in mods if m.split(".")[0] in roots})
    if bad:
        fail(f"{name} imported {bad[:8]}")
    return mods


def phase_port_control_plane(hc_expect, scrypt_job, crash_expect, phase5, card: str) -> dict:
    """Phase 5b: the port's three roles as processes, each started with
    ``python -X importtime``: ``tpuminter_torch.coordinator`` (roll
    budget 2, a journal), ``tpuminter_torch.worker --coordinator ADDR
    --reconnect`` on the card and ``tpuminter_torch.client``. Jobs:
    phase 5's genesis TARGET job (under a client key), its rolled job,
    its MIN job, its SCRYPT job, hashcore fmin over 2^32 (equal to phase
    4c's), the dict top-k and the crash drill. Then the port's
    coordinator and worker stop, the unchanged ``tpuminter.coordinator``
    starts on the port's journal with no worker, and the genesis job
    re-submitted under its key must print the identical Result, answered
    from the journal's winner table. No process may import JAX or the
    JAX package, nor the coordinator or the client torch. Prints each
    job's seconds beside phase 5's (``phase5``) and returns them."""
    from tpuminter_torch import chain

    log_dir = os.path.join(ROOT, "build", "tpuminter_torch")
    os.makedirs(log_dir, exist_ok=True)
    env = repo_env()
    port = free_udp_port()
    addr = f"127.0.0.1:{port}"
    journal = os.path.join(log_dir, "e2e5b_coordinator.wal")
    if os.path.exists(journal):
        os.remove(journal)
    procs, logs = [], []
    importtime = (sys.executable, "-X", "importtime", "-m")

    def log_text(name):
        with open(os.path.join(log_dir, f"e2e5b_{name}.log")) as fh:
            return fh.read()

    def start(name, args, python=importtime):
        log = open(os.path.join(log_dir, f"e2e5b_{name}.log"), "w")
        logs.append((name, log))
        procs.append(subprocess.Popen([*python, *args], cwd=ROOT, env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
        return procs[-1]

    def start_coordinator(name, module="tpuminter_torch.coordinator", extra=("--roll-budget", "2"),
                          python=importtime):
        proc = start(name, [module, str(port), *extra, "--journal", journal], python)
        deadline = time.time() + 60
        while "listening" not in log_text(name):
            if proc.poll() is not None or time.time() > deadline:
                fail(f"phase 5b: the coordinator ({name}) did not start")
            time.sleep(0.2)
        return proc

    seconds = {}

    def client(job, args):
        t0 = time.perf_counter()
        out = subprocess.run([*importtime, "tpuminter_torch.client", addr, *args,
                              "--timeout", "300"], cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=400)
        seconds[job] = time.perf_counter() - t0
        check_imports(f"the {job} job's client", out.stderr, torch_too=True)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("Result ")]
        if out.returncode != 0 or len(lines) != 1:
            fail(f"phase 5b client {job} failed (rc {out.returncode}): {out.stdout}"
                 f"{out.stderr[-2000:]}")
        return out.stdout, lines

    def beside(job, text):
        p5 = phase5["hashcore"]["fmin"] if job == "hashcore fmin" else phase5[job]
        say(f"  5b {job}: {text} ({seconds[job]:.1f} s through the port's client; phase 5 "
            f"{p5:.1f} s; {card})")

    try:
        coordinator = start_coordinator("coordinator")
        worker = start("worker", ["tpuminter_torch.worker", "--coordinator", addr,
                                  "--reconnect"])
        genesis = chain.GENESIS_HEADER
        genesis_args = ["--header", genesis.pack().hex(), "--bits", hex(genesis.bits),
                        "--max-nonce", str(GENESIS_NONCE + 4095), "--client-key",
                        "chip-smoke-5b-genesis"]
        _, lines = client("genesis", genesis_args)
        genesis_line = lines[0]
        _, hash_hex, nonce = genesis_line.split()
        digest = genesis.with_nonce(int(nonce)).block_hash()
        if chain.hash_to_hex(digest) != hash_hex or \
                chain.hash_to_int(digest) > chain.bits_to_target(genesis.bits):
            fail(f"5b genesis Result {hash_hex} {nonce} fails the hashlib check")
        beside("genesis", f"Result {hash_hex} {nonce} (hashlib-checked)")
        cb = bytes.fromhex(GENESIS_COINBASE_HEX)
        _, lines = client("rolled", [
            "--header", genesis.pack().hex(), "--bits", hex(genesis.bits),
            "--coinbase-prefix", cb[:48].hex(), "--coinbase-suffix", cb[49:].hex(),
            "--extranonce-size", "1", "--max-extranonce", "4"])
        _, hash_hex, en_arg, nonce_arg = lines[0].split()
        en, nonce = int(en_arg.split("=")[1]), int(nonce_arg.split("=")[1])
        digest = chain.rolled_header(genesis.pack(), chain.CoinbaseTemplate(cb[:48], cb[49:], 1),
                                     (), en).with_nonce(nonce).block_hash()
        if chain.hash_to_hex(digest) != hash_hex or \
                chain.hash_to_int(digest) > chain.bits_to_target(genesis.bits):
            fail(f"5b rolled Result {hash_hex} extranonce={en} nonce={nonce} fails hashlib")
        beside("rolled", f"Result {hash_hex} extranonce={en} nonce={nonce} (re-rolled and "
               "hashlib-checked)")
        data = "hello bitcoin"
        _, lines = client("min", [data, str((1 << 30) - 1)])
        _, fold, nonce = lines[0].split()
        if int(fold) != chain.toy_hash(data.encode(), int(nonce)):
            fail(f"5b MIN Result {fold} {nonce} fails the toy_hash check")
        beside("min", f"Result {fold} {nonce} (toy_hash-checked)")
        _, lines = client("scrypt", [
            "--header", scrypt_job["header"].hex(), "--bits", hex(scrypt_job["bits"]),
            "--scrypt", "--max-nonce", str(scrypt_job["max_nonce"])])
        _, hash_hex, nonce = lines[0].split()
        hdr = chain.BlockHeader.unpack(scrypt_job["header"]).with_nonce(int(nonce)).pack()
        digest = chain.scrypt_hash(hdr)
        if chain.hash_to_hex(digest) != hash_hex or \
                chain.hash_to_int(digest) > chain.bits_to_target(scrypt_job["bits"]):
            fail(f"5b SCRYPT Result {hash_hex} {nonce} fails the hashlib.scrypt check")
        beside("scrypt", f"Result {hash_hex} {nonce} (hashlib.scrypt-checked)")
        text, _ = client("hashcore fmin", [
            "--workload", "hashcore", "--variant", "fmin", "--seed", str(hc_expect["seed"]),
            "--max-nonce", str(HC_N - 1)])
        searched = int(re.search(r"searched=(\d+)", text).group(1))
        pair = [int(x) for x in re.search(r"value=(\d+) index=(\d+)", text).groups()]
        if (searched, pair) != tuple(hc_expect["fmin"]):
            fail(f"5b hashcore fmin: {searched} {pair} != phase 4c's {hc_expect['fmin']}")
        beside("hashcore fmin", f"{pair} searched={searched}, equal to phase 4c")
        seconds["dict"] = phase_end_to_end_dict(
            addr, env, log_dir, client=importtime[1:] + ("tpuminter_torch.client",), label="5b")
        beside("dict", "equal to hashlib")
        seconds["crash"] = crash_drill(
            addr, env, coordinator, lambda name: start_coordinator(name), crash_expect,
            client=importtime[1:] + ("tpuminter_torch.client",), label="5b")
        beside("crash", "one Result, equal to CudaMiner's")
        joins = [ln for name in ("coordinator", "coordinator2") for ln in
                 log_text(name).splitlines() if "joined (backend=cuda" in ln]
        if len(joins) < 2 or not all("codec=bin" in ln and "workloads=dict,hashcore" in ln
                                     for ln in joins):
            fail(f"5b: the port's coordinators show no binary cuda worker joining each "
                 f"incarnation: {joins}")
        if "recovered 1 live job(s)" not in log_text("coordinator2"):
            fail("5b: the restarted coordinator recovered no job from its journal")
        if worker.poll() is not None:
            fail("5b: the port's worker exited early")
        # the cross-implementation recovery: the unchanged coordinator on
        # the port's journal, no worker, answers the genesis job from it
        for proc in procs:
            proc.terminate()
        for proc in procs:
            proc.wait(timeout=30)
        for name, text in (("coordinator", log_text("coordinator")),
                           ("coordinator2", log_text("coordinator2")),
                           ("worker", log_text("worker"))):
            check_imports(f"the port's {name}", text, torch_too=name != "worker")
        start_coordinator("reference", "tpuminter.coordinator", (),
                          (sys.executable, "-m"))
        _, lines = client("genesis again", genesis_args)
        if lines != [genesis_line]:
            fail(f"5b: the unchanged coordinator on the port's journal answered {lines}, "
                 f"not {genesis_line}")
        if "re-delivering the journaled winner" not in log_text("reference"):
            fail("5b: the unchanged coordinator did not answer from the journal's winners")
        say(f"  5b the unchanged tpuminter.coordinator on the port's journal, no worker: the "
            f"genesis job re-submitted under its key printed the identical Result "
            f"({seconds['genesis again']:.2f} s)")
        say("  5b imports (python -X importtime): no jax, jaxlib or tpuminter module in the "
            "port's coordinator, worker and client processes; no torch in its coordinator "
            "and client")
        return seconds
    except BaseException:
        for name, log in logs:
            log.flush()
            print(f"--- 5b {name} log tail ---\n{log_text(name)[-3000:]}", file=sys.stderr)
        raise
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for _, log in logs:
            log.close()


# ---- phase 5c: the coordinator's policies on the card -----------------------

#: nonces an audit re-mines (the coordinator's AUDIT_SAMPLE and
#: AUDIT_SAMPLE_SCRYPT), the shapes phase 5c holds the kernels at
AUDIT_N, AUDIT_N_SCRYPT = 256, 64
#: phase 5c's coordinator: every single-loop policy on. Hedging at 0.3 s,
#: well inside the loss horizon of the LSP settings the roles use (5
#: silent epochs of 250 ms: a stopped worker is lost 1.0-1.25 s after its
#: last heartbeat), so the hedge drill's stopped worker is hedged and
#: continued before it is lost
HEDGE_AFTER = 0.3
POLICY_FLAGS = ("--roll-budget", "2", "--audit-rate", "1.0", "--hedge-after", str(HEDGE_AFTER),
                "--stats-port", "0", "--stats-interval", "0.5", "--quota-rate", "1",
                "--quota-burst", "2", "--max-jobs", "4", "--emit-interval", "0.2")
PARK_FLAGS = ("--park-queue", "8", "--workload-weight", "mine=1,dict=2")
#: the audited MIN job, the hedge drill's job (four 2^29-nonce chunks),
#: the MIN job the dict stream runs beside, and the admission drills'
#: jobs (three a drill under one client key)
AUDITED_DATA, AUDITED_N = b"tpuminter_torch audited", 1 << 34
HEDGE_DATA, HEDGE_N = b"tpuminter_torch hedge drill", 1 << 31
LOAD_DATA, LOAD_N = b"tpuminter_torch beside the stream", 1 << 35
QUOTA_DATA, QUOTA_N, QUOTA_KEY = "tpuminter_torch quota", 1 << 24, "chip-smoke-5c-tenant"
#: three submissions under one client key at once through the port's
#: client (``submit``), each printed, and the admission refusals it retried
ADMISSION_DRILL = r"""
import asyncio, logging, sys
from tpuminter_torch.client import submit
from tpuminter_torch.protocol import PowMode, Request
host, port, key, base, n, data = sys.argv[1:7]
refused = []
class Refusals(logging.Handler):
    def emit(self, record):
        if "admission refused" in record.getMessage():
            refused.append(record.getMessage())
log = logging.getLogger("tpuminter_torch.client")
log.setLevel(logging.INFO)
log.addHandler(Refusals())
reqs = [Request(int(base) + i, PowMode.MIN, 0, int(n) - 1, data=b"%s-%d" % (data.encode(), i))
        for i in range(3)]
async def main():
    return await asyncio.gather(*(submit(host, int(port), r, client_key=key) for r in reqs))
for r in asyncio.run(asyncio.wait_for(main(), 120)):
    print("Result", r.job_id, r.hash_value, r.nonce, r.searched)
print("Refused", len(refused))
"""


#: one MIN job through the port's client, submitted when a line arrives on
#: stdin (so the caller can stop a worker just before it)
HEDGE_DRILL = r"""
import asyncio, sys
from tpuminter_torch.client import submit
from tpuminter_torch.protocol import PowMode, Request
host, port, n, data = sys.argv[1:5]
print("ready", flush=True)
sys.stdin.readline()
req = Request(1, PowMode.MIN, 0, int(n) - 1, data=data.encode())
r = asyncio.run(asyncio.wait_for(submit(host, int(port), req), 120))
print("Result", r.hash_value, r.nonce)
"""
#: a worker's log line for a Cancel, mid-chunk or between chunks
CANCELLED = re.compile(r"worker: job \d+ cancelled[^\n]*")


def phase_audit_shapes(card: str, rng):
    """``CudaMiner()`` at its defaults on the ranges an audit sends: 256
    nonces on the fast path (3h), on exact-min (2h: ``exact_min=True``
    at the genesis target, and the defaults at regtest bits) and on MIN
    (6t, also across a 2^32 low-word boundary); 64 nonces of SCRYPT (S1,
    19, S2). Random bases; every Result against hashlib,
    ``hashlib.scrypt`` or ``toy_hash``; every launch count 0 just before
    and read just after. Returns the counts and each range's ms."""
    from tpuminter_torch import chain, kernels
    from tpuminter_torch.cuda_worker import CudaMiner
    from tpuminter_torch.protocol import MIN_UNTRACKED, PowMode, Request

    genesis = chain.GENESIS_HEADER.pack()
    target = chain.bits_to_target(chain.GENESIS_HEADER.bits)
    regtest = genesis[:72] + struct.pack("<I", REGTEST_BITS) + b"\0" * 4
    ltc = ltc_genesis().pack()
    ltc_target = chain.bits_to_target(LTC_GENESIS["bits"])
    reset_launches(kernels)
    miner, exact = CudaMiner(), CudaMiner(exact_min=True)
    ms = {}

    def mine(label, m, req):
        t0 = time.perf_counter()
        res = drain(m.mine(req))
        ms.setdefault(label, []).append((time.perf_counter() - t0) * 1e3)
        return res

    def expect(req, hashes, tracked=True):
        """The Result the reference's rules give: the first winner with
        ``searched`` up to it, else the exact minimum (the fast path
        tracks it only when a candidate surfaced)."""
        for i, (h, n) in enumerate(hashes):
            if req.mode.targeted and h <= req.target:
                return (n, h, True, i + 1)
        h, n = min(hashes)
        if not tracked and h >> 224:
            return (req.lower, MIN_UNTRACKED, False, len(hashes))
        return (n, h, req.mode == PowMode.MIN, len(hashes))

    def dsha(header, lo, hi):
        return [(chain.hash_to_int(chain.dsha256(header[:76] + struct.pack("<I", n))), n)
                for n in range(lo, hi + 1)]

    for i in range(2):
        lo = int(rng.integers(0, (1 << 32) - AUDIT_N))
        req = Request(60 + i, PowMode.TARGET, lo, lo + AUDIT_N - 1, header=genesis, target=target)
        res = mine("3h", miner, req)
        want = expect(req, dsha(genesis, req.lower, req.upper), tracked=False)
        if (res.nonce, res.hash_value, res.found, res.searched) != want:
            fail(f"audit shape, fast path [{lo}, {req.upper}]: {res} != hashlib's {want}")
        res = mine("2h", exact, req)
        want = expect(req, dsha(genesis, req.lower, req.upper))
        if (res.nonce, res.hash_value, res.found, res.searched) != want:
            fail(f"audit shape, exact-min [{lo}, {req.upper}]: {res} != hashlib's {want}")
        rt = Request(62 + i, PowMode.TARGET, lo, lo + AUDIT_N - 1, header=regtest,
                     target=chain.bits_to_target(REGTEST_BITS))
        res = mine("2h", miner, rt)
        want = expect(rt, dsha(regtest, rt.lower, rt.upper))
        if (res.nonce, res.hash_value, res.found, res.searched) != want:
            fail(f"audit shape, regtest [{lo}, {rt.upper}]: {res} != hashlib's {want}")
    for lo in (int(rng.integers(0, 1 << 40)), (1 << 32) - AUDIT_N // 2):
        req = Request(64, PowMode.MIN, lo, lo + AUDIT_N - 1, data=MIN_DATA)
        res = mine("6t", miner, req)
        want = expect(req, [(chain.toy_hash(MIN_DATA, n), n) for n in range(lo, lo + AUDIT_N)])
        if (res.nonce, res.hash_value, res.found, res.searched) != want:
            fail(f"audit shape, MIN [{lo}, {req.upper}]: {res} != toy_hash's {want}")
    for i in range(2):
        lo = int(rng.integers(0, (1 << 32) - AUDIT_N_SCRYPT))
        req = Request(65 + i, PowMode.SCRYPT, lo, lo + AUDIT_N_SCRYPT - 1, header=ltc,
                      target=ltc_target)
        res = mine("S1+19+S2", miner, req)
        hashes = [(chain.hash_to_int(chain.scrypt_hash(ltc[:76] + struct.pack("<I", n))), n)
                  for n in range(req.lower, req.upper + 1)]
        want = expect(req, hashes)
        if (res.nonce, res.hash_value, res.found, res.searched) != want:
            fail(f"audit shape, SCRYPT [{lo}, {req.upper}]: {res} != hashlib.scrypt's {want}")
    launches = read_launches(kernels, ("sha256_batch", "search_candidates_header",
                                       "search_target_header", "min_toy_toy") +
                             SCRYPT_PATH_KERNELS, "audit-shape", FIXED_PATH_GENERIC)
    for label, runs in ms.items():
        say(f"  audit shape {label}: {len(runs)} ranges of {AUDIT_N_SCRYPT if label[0] == 'S' else AUDIT_N} "
            f"nonces, each Result checked; ms a range {', '.join(f'{t:.3f}' for t in runs)} on {card}")
    del miner, exact
    torch.cuda.empty_cache()
    return launches, {k: [round(t, 3) for t in v] for k, v in ms.items()}


def stats_get(stats_port: int) -> dict:
    """One GET of a coordinator's stats endpoint."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{stats_port}", timeout=10) as rsp:
        return json.load(rsp)


def phase_port_policies(scrypt_job, card: str) -> dict:
    """Phase 5c: the port's coordinator as a process with a journal and
    every single-loop policy on (audits at rate 1, hedging, the stats
    endpoint, quotas, the job cap, the park queue, streaming), two port
    workers sharing the card, the port's client; every process under
    ``python -X importtime``. Jobs: an audited MIN job over 2^34 nonces
    (exact against ``CudaMiner()``, every audit conclusive), the genesis
    TARGET job (hashlib; its audit counters printed), phase 4d's SCRYPT
    job (audits conclusive), phase 5's dict top-k streamed beside a MIN
    job over 2^35 (Partial lines, monotone coverage, the final equal to
    phase 5's), a hedge drill (one worker stopped with SIGSTOP while its
    chunks are in flight, continued inside the LSP loss horizon: the
    Result exact, a hedge counted, the loser's log showing the Cancel),
    and three
    submissions under one client key at once: parked and drained here.
    Then the coordinator is killed and restarted from its journal
    without the park queue (the tenant's bucket restored from the
    journal) and the three submissions again: refused and retried by
    the client. Each incarnation's stats endpoint is read before it
    stops and held to what the phase saw. Returns the numbers."""
    from tpuminter_torch import chain
    from tpuminter_torch.cuda_worker import CudaMiner
    from tpuminter_torch.protocol import PowMode, Request

    audited = drain(CudaMiner().mine(Request(70, PowMode.MIN, 0, AUDITED_N - 1,
                                             data=AUDITED_DATA)))
    hedged = drain(CudaMiner().mine(Request(71, PowMode.MIN, 0, HEDGE_N - 1, data=HEDGE_DATA)))
    quota_expect = [drain(CudaMiner().mine(Request(
        72, PowMode.MIN, 0, QUOTA_N - 1, data=b"%s-%d" % (QUOTA_DATA.encode(), i))))
        for i in range(3)]
    torch.cuda.empty_cache()
    log_dir = os.path.join(ROOT, "build", "tpuminter_torch")
    os.makedirs(log_dir, exist_ok=True)
    env = repo_env()
    port = free_udp_port()
    addr = f"127.0.0.1:{port}"
    journal = os.path.join(log_dir, "e2e5c_coordinator.wal")
    if os.path.exists(journal):
        os.remove(journal)
    importtime = (sys.executable, "-X", "importtime")
    procs, logs, out = [], [], {"seconds": {}}

    def log_text(name):
        with open(os.path.join(log_dir, f"e2e5c_{name}.log")) as fh:
            return fh.read()

    def start(name, args):
        log = open(os.path.join(log_dir, f"e2e5c_{name}.log"), "w")
        logs.append((name, log))
        procs.append(subprocess.Popen([*importtime, "-m", *args], cwd=ROOT, env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
        return procs[-1]

    def start_coordinator(name, flags):
        proc = start(name, ["tpuminter_torch.coordinator", str(port), *flags, "--journal",
                            journal])
        deadline = time.time() + 60
        while not (m := re.search(r"stats endpoint on http://127.0.0.1:(\d+)", log_text(name))):
            if proc.poll() is not None or time.time() > deadline:
                fail(f"phase 5c: the coordinator ({name}) did not start")
            time.sleep(0.1)
        return proc, int(m.group(1))

    def wait_workers(stats_port, n=2):
        deadline = time.time() + 120
        while len(stats_get(stats_port)["workers"]) < n:
            if time.time() > deadline:
                fail(f"phase 5c: {n} workers did not join")
            time.sleep(0.2)

    def client(job, args, python=("-m", "tpuminter_torch.client", addr)):
        t0 = time.perf_counter()
        res = subprocess.run([*importtime, *python, *args], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
        out["seconds"][job] = time.perf_counter() - t0
        check_imports(f"the 5c {job} client", res.stderr, torch_too=True)
        if res.returncode != 0:
            fail(f"phase 5c client {job} failed (rc {res.returncode}): {res.stdout}"
                 f"{res.stderr[-2000:]}")
        return res.stdout

    def result_line(job, text):
        lines = [ln for ln in text.splitlines() if ln.startswith("Result ")]
        if len(lines) != 1:
            fail(f"phase 5c {job}: {len(lines)} Result lines: {text}")
        return lines[0].split()

    def audits(stats_port):
        s = stats_get(stats_port)["stats"]
        return {k: s[k] for k in ("audits_done", "audits_failed", "audits_inconclusive")}

    def admission_drill(label, stats_port, base):
        text = client(label, [addr.split(":")[0], str(port), QUOTA_KEY, str(base), str(QUOTA_N),
                              QUOTA_DATA], python=("-c", ADMISSION_DRILL))
        got = [ln.split() for ln in text.splitlines() if ln.startswith("Result ")]
        refused = int(re.search(r"^Refused (\d+)", text, re.M).group(1))
        if len(got) != 3:
            fail(f"phase 5c {label}: {text}")
        for (_, jid, h, n, searched), want in zip(got, quota_expect):
            if (int(h), int(n), int(searched)) != (want.hash_value, want.nonce, QUOTA_N):
                fail(f"phase 5c {label}: job {jid} {h} {n} != CudaMiner's {want}")
        return refused

    try:
        coordinator, sp = start_coordinator("coordinator", POLICY_FLAGS + PARK_FLAGS)
        workers = [start(f"worker{i}", ["tpuminter_torch.worker", "--coordinator", addr,
                                        "--reconnect"]) for i in range(2)]
        wait_workers(sp)
        # 1. the audited MIN job: exact, and every audit conclusive
        _, fold, nonce = result_line("min", client("min", [AUDITED_DATA.decode(),
                                                           str(AUDITED_N - 1)]))
        if (int(fold), int(nonce)) != (audited.hash_value, audited.nonce):
            fail(f"5c MIN: {fold} {nonce} != CudaMiner's {audited.hash_value} {audited.nonce}")
        a_min = audits(sp)
        if a_min["audits_done"] < 1 or a_min["audits_failed"] or a_min["audits_inconclusive"]:
            fail(f"5c MIN: the audits did not all conclude: {a_min}")
        say(f"  5c MIN over 2^34, audited: Result {fold} {nonce}, equal to CudaMiner's; "
            f"{a_min} ({out['seconds']['min']:.1f} s through the port's client; {card})")
        # 2. the genesis TARGET job: the fast path's sentinel leaves its audits inconclusive
        genesis = chain.GENESIS_HEADER
        _, hash_hex, nonce = result_line("genesis", client("genesis", [
            "--header", genesis.pack().hex(), "--bits", hex(genesis.bits), "--max-nonce",
            str(GENESIS_NONCE + 4095)]))
        digest = genesis.with_nonce(int(nonce)).block_hash()
        if chain.hash_to_hex(digest) != hash_hex or \
                chain.hash_to_int(digest) > chain.bits_to_target(genesis.bits):
            fail(f"5c genesis Result {hash_hex} {nonce} fails the hashlib check")
        time.sleep(0.3)  # the retired job's audits in flight settle
        a_gen = audits(sp)
        delta = {k: a_gen[k] - a_min[k] for k in a_gen}
        say(f"  5c genesis TARGET: Result {hash_hex} {nonce} (hashlib-checked); its audits "
            f"{delta} ({out['seconds']['genesis']:.1f} s)")
        # 3. phase 4d's SCRYPT job: its audits conclude
        _, hash_hex, nonce = result_line("scrypt", client("scrypt", [
            "--header", scrypt_job["header"].hex(), "--bits", hex(scrypt_job["bits"]),
            "--scrypt", "--max-nonce", str(scrypt_job["max_nonce"])]))
        hdr = chain.BlockHeader.unpack(scrypt_job["header"]).with_nonce(int(nonce)).pack()
        digest = chain.scrypt_hash(hdr)
        if chain.hash_to_hex(digest) != hash_hex or \
                chain.hash_to_int(digest) > chain.bits_to_target(scrypt_job["bits"]):
            fail(f"5c SCRYPT Result {hash_hex} {nonce} fails the hashlib.scrypt check")
        time.sleep(0.3)
        a_scr = audits(sp)
        delta_s = {k: a_scr[k] - a_gen[k] for k in a_scr}
        if delta_s["audits_failed"] or delta_s["audits_inconclusive"]:
            fail(f"5c SCRYPT: an audit failed or ended inconclusive: {delta_s}")
        say(f"  5c SCRYPT: Result {hash_hex} {nonce} (hashlib.scrypt-checked); its audits "
            f"{delta_s} ({out['seconds']['scrypt']:.1f} s)")
        # 4. phase 5's dict top-k, streamed beside a MIN job that keeps both
        # workers busy, so its chunks settle between MIN chunks: a dict job
        # alone on the fleet settles within one journal fsync, and a stream
        # whose last settle retires the job before its first is durable
        # emits nothing
        path, _cands, want = dict_catalog(log_dir)
        busy = subprocess.Popen([*importtime, "-m", "tpuminter_torch.client", addr,
                                 LOAD_DATA.decode(), str(LOAD_N - 1), "--timeout", "120"],
                                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        procs.append(busy)
        deadline = time.time() + 30
        while not stats_get(sp)["jobs_active"]:
            if busy.poll() is not None or time.time() > deadline:
                fail("5c: the MIN job beside the dict stream did not start")
            time.sleep(0.02)
        text = client("dict stream", ["--workload", "dict", "--variant", "topk", "--k",
                                      str(DICT_K), "--seed", str(DICT_SEED), "--candidates",
                                      path, "--stream"])
        partials = [int(c) for c, _t in re.findall(r"^Partial \[(\d+)/(\d+) ", text, re.M)]
        pairs = [[int(v), int(i)] for v, i in re.findall(r"value=(\d+) index=(\d+)",
                                                         text.split("Result [dict]")[-1])]
        searched = int(re.search(r"searched=(\d+)", text).group(1))
        if not partials or partials != sorted(set(partials)) or partials[-1] >= DICT_N:
            fail(f"5c dict stream: Partial coverage {partials} is empty or not monotone")
        if (searched, pairs) != (DICT_N, want):
            fail(f"5c dict stream: searched={searched} {pairs} != phase 5's {want}")
        text, err = busy.communicate(timeout=120)
        check_imports("the 5c busy MIN client", err, torch_too=True)
        _, fold, nonce = result_line("busy MIN", text)
        if int(fold) != chain.toy_hash(LOAD_DATA, int(nonce)):
            fail(f"5c MIN beside the stream: Result {fold} {nonce} fails the toy_hash check")
        say(f"  5c dict top-k streamed beside a MIN job over 2^35: {len(partials)} Partial "
            f"lines, coverage {partials}, the final equal to phase 5's "
            f"({out['seconds']['dict stream']:.1f} s); the MIN job's Result toy_hash-checked")
        # 6. the hedge drill: stop a worker, submit, continue it once hedged
        hedged_before = stats_get(sp)["stats"]["chunks_hedged"]
        died_before = log_text("coordinator").count(" died")
        cancels = CANCELLED.findall(log_text("worker1"))
        drill = subprocess.Popen([*importtime, "-c", HEDGE_DRILL, addr.split(":")[0], str(port),
                                  str(HEDGE_N), HEDGE_DATA.decode()], cwd=ROOT, env=env,
                                 stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
        procs.append(drill)
        if drill.stdout.readline().strip() != "ready":
            fail("5c hedge drill: the client did not start")
        workers[1].send_signal(signal.SIGSTOP)
        t_stop = time.perf_counter()
        try:
            drill.stdin.write("go\n")
            drill.stdin.flush()
            while (stats_get(sp)["stats"]["chunks_hedged"] == hedged_before
                   and time.perf_counter() - t_stop < 0.7):
                time.sleep(0.01)
            time.sleep(0.1)  # the backup mines its copy (one 2^29-nonce chunk)
        finally:
            workers[1].send_signal(signal.SIGCONT)
        stopped = time.perf_counter() - t_stop
        text, err = drill.communicate(timeout=120)
        out["seconds"]["hedge"] = time.perf_counter() - t_stop
        check_imports("the 5c hedge client", err, torch_too=True)
        _, fold, nonce = result_line("hedge", text)
        if (int(fold), int(nonce)) != (hedged.hash_value, hedged.nonce):
            fail(f"5c hedge drill: {fold} {nonce} != CudaMiner's {hedged.hash_value} "
                 f"{hedged.nonce}")
        if log_text("coordinator").count(" died") != died_before:
            fail(f"5c hedge drill: the stopped worker was lost ({stopped:.3f} s stopped)")
        hedges = stats_get(sp)["stats"]["chunks_hedged"] - hedged_before
        if hedges < 1:
            fail(f"5c hedge drill: no chunk hedged in {stopped:.3f} s stopped")
        deadline = time.time() + 10
        while len(CANCELLED.findall(log_text("worker1"))) <= len(cancels):
            if time.time() > deadline:
                fail("5c hedge drill: the stopped worker's log shows no Cancel")
            time.sleep(0.1)
        loser_line = CANCELLED.findall(log_text("worker1"))[len(cancels)]
        out["hedge"] = {"stopped_s": round(stopped, 3), "hedged": hedges}
        say(f"  5c hedge drill: a worker stopped {stopped:.3f} s with its chunks in flight; "
            f"{hedges} chunk(s) hedged onto the other, Result {fold} {nonce} equal to "
            f"CudaMiner's; the stopped worker's log: {loser_line!r} "
            f"({out['seconds']['hedge']:.1f} s)")
        # 5a. three submissions under one key at once: the third parks
        refused = admission_drill("admission (park)", sp, 100)
        snap1 = stats_get(sp)
        s1 = snap1["stats"]
        if (s1["jobs_done"] != 9 or s1["emits_sent"] < 1 or s1["chunks_hedged"] < 1
                or s1["jobs_parked"] < 1 or s1["parked_drained"] < 1 or refused
                or s1["refused_admission"] or s1["audits_failed"]):
            fail(f"5c: the stats endpoint disagrees with the phase: {s1} (refused {refused})")
        say(f"  5c three submissions under one key at once, --park-queue 8: {s1['jobs_parked']} "
            f"parked and drained, none refused; all three exact "
            f"({out['seconds']['admission (park)']:.1f} s)")
        say(f"  5c stats endpoint: {json.dumps(snap1, sort_keys=True)}")
        time.sleep(1.0)  # the stats tick journals the tenant's bucket
        coordinator.kill()
        coordinator.wait()
        # 5b. restarted from the journal without the park queue: refused, retried
        coordinator, sp = start_coordinator("coordinator2", POLICY_FLAGS)
        restored = stats_get(sp)["quota_buckets"]
        if restored < 1:
            fail("5c: the restarted coordinator restored no tenant bucket from its journal")
        wait_workers(sp)
        refused = admission_drill("admission (refuse)", sp, 200)
        snap2 = stats_get(sp)
        s2 = snap2["stats"]
        if refused < 1 or s2["refused_admission"] < 1 or s2["jobs_done"] != 3:
            fail(f"5c: no refusal retried, or the endpoint disagrees: {s2} (refused {refused})")
        say(f"  5c restarted from its journal ({restored} tenant bucket restored), no park "
            f"queue: the same three submissions, {refused} refused and retried by the client, "
            f"all three exact ({out['seconds']['admission (refuse)']:.1f} s)")
        say(f"  5c stats endpoint: {json.dumps(snap2, sort_keys=True)}")
        for w in workers:
            if w.poll() is not None:
                fail("5c: a port worker exited early")
        for proc in procs:
            proc.terminate()
        for proc in procs:
            proc.wait(timeout=30)
        for name in ("coordinator", "coordinator2", "worker0", "worker1"):
            check_imports(f"the 5c {name}", log_text(name), torch_too=not name.startswith("w"))
        say("  5c imports (python -X importtime): no jax, jaxlib or tpuminter module in any "
            "process; no torch in the coordinator and the clients")
        out.update(stats=s1, stats_restarted=s2, audits_min=a_min,
                   audits_genesis=delta, audits_scrypt=delta_s, partials=len(partials))
        return out
    except BaseException:
        for name, log in logs:
            log.flush()
            print(f"--- 5c {name} log tail ---\n{log_text(name)[-3000:]}", file=sys.stderr)
        raise
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGCONT)
                proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for _, log in logs:
            log.close()


# ---- phase 5d: a failover drill on the card ----------------------------------

#: the MIN job across the kill (64 of the coordinator's 2^29-nonce chunks),
#: the chunks settled before the kill, and the standby's promotion threshold
FAILOVER_DATA, FAILOVER_N = b"tpuminter_torch failover drill", 1 << 35
FAILOVER_SETTLED = 16
PROMOTE_AFTER_S = 1.5


def settled_count(state, data: bytes, n: int) -> int:
    """Nonces of the MIN job over ``data`` that a replayed journal state
    holds settled (0 when the job is not live in it)."""
    for job in state.jobs.values():
        if job.request.data == data:
            return n - sum(hi - lo + 1 for lo, hi in job.remaining)
    return 0


def phase_port_failover(scrypt_job, phase5b, card: str) -> dict:
    """Phase 5d: a port standby (``python -m tpuminter_torch.replication
    P1 --wal S --port P2 --promote-after 1.5``), the port's coordinator
    on P1 with a journal, ``--replicate-to 127.0.0.1:P2 --replica-ack
    --roll-budget 2 --stats-port 0``, two port workers on the card and
    the port's client, both given ``P1,P2`` and ``--reconnect``; every
    process under ``python -X importtime``. The genesis TARGET job under
    a client key (its seconds beside phase 5b's: the replica-ack's
    cost), then a MIN job over 2^35 nonces: once ``FAILOVER_SETTLED``
    chunks are settled and the lane's acked offset has passed the
    journal's size read then, the primary is killed (SIGKILL). The
    standby promotes; the MIN Result must equal ``CudaMiner()``'s, the
    genesis re-submission is answered from the winner table (no job
    minted), phase 4d's SCRYPT job runs through the promoted
    coordinator, and the old primary restarted on its journal with
    ``--replicate-to P2`` must be fenced. Returns the drill's figures."""
    from tpuminter_torch import chain
    from tpuminter_torch.cuda_worker import CudaMiner
    from tpuminter_torch.journal import replay, scan
    from tpuminter_torch.protocol import PowMode, Request
    from tpuminter_torch.replication import FENCE_JUMP

    expect = drain(CudaMiner().mine(Request(80, PowMode.MIN, 0, FAILOVER_N - 1,
                                            data=FAILOVER_DATA)))
    torch.cuda.empty_cache()
    log_dir = os.path.join(ROOT, "build", "tpuminter_torch")
    os.makedirs(log_dir, exist_ok=True)
    env = repo_env()
    p1 = free_udp_port()
    p2 = free_udp_port()
    while p2 == p1:
        p2 = free_udp_port()
    addrs = f"127.0.0.1:{p1},127.0.0.1:{p2}"
    wal, copy = (os.path.join(log_dir, f"e2e5d_{n}.wal") for n in ("primary", "standby"))
    for path in (wal, copy):
        if os.path.exists(path):
            os.remove(path)
    importtime = (sys.executable, "-X", "importtime")
    procs, logs, out = [], [], {"seconds": {}}

    def log_text(name):
        with open(os.path.join(log_dir, f"e2e5d_{name}.log")) as fh:
            return fh.read()

    def start(name, args):
        log = open(os.path.join(log_dir, f"e2e5d_{name}.log"), "w")
        logs.append((name, log))
        procs.append(subprocess.Popen([*importtime, "-m", *args], cwd=ROOT, env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
        return procs[-1]

    def wait_log(name, pattern, seconds, what):
        deadline = time.time() + seconds
        while not (m := re.search(pattern, log_text(name))):
            if time.time() > deadline:
                fail(f"phase 5d: {what}")
            time.sleep(0.01)
        return m

    def client_args(args):
        return [*importtime, "-m", "tpuminter_torch.client", addrs, *args, "--reconnect",
                "--timeout", "300"]

    def client(job, args):
        t0 = time.perf_counter()
        res = subprocess.run(client_args(args), cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=400)
        out["seconds"][job] = time.perf_counter() - t0
        check_imports(f"the 5d {job} client", res.stderr, torch_too=True)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("Result ")]
        if res.returncode != 0 or len(lines) != 1:
            fail(f"phase 5d client {job} failed (rc {res.returncode}): {res.stdout}"
                 f"{res.stderr[-2000:]}")
        return lines[0]

    def primary_stats():
        return stats_get(stats_port)

    try:
        start("standby", ["tpuminter_torch.replication", f"127.0.0.1:{p1}", "--wal", copy,
                          "--port", str(p2), "--promote-after", str(PROMOTE_AFTER_S)])
        wait_log("standby", r"standby listening on port", 60, "the standby did not start")
        primary = start("primary", ["tpuminter_torch.coordinator", str(p1), "--journal", wal,
                                    "--replicate-to", f"127.0.0.1:{p2}", "--replica-ack",
                                    "--roll-budget", "2", "--stats-port", "0"])
        stats_port = int(wait_log("primary", r"stats endpoint on http://127.0.0.1:(\d+)", 60,
                                  "the primary did not start").group(1))
        deadline = time.time() + 30
        while not primary_stats()["replication"][0]["synced"]:
            if time.time() > deadline:
                fail("phase 5d: the primary's lane never synced with the standby")
            time.sleep(0.05)
        workers = [start(f"worker{i}", ["tpuminter_torch.worker", "--coordinator", addrs,
                                        "--reconnect"]) for i in range(2)]
        # 4. the genesis job under a key: answered once a standby acked its finish
        genesis = chain.GENESIS_HEADER
        genesis_args = ["--header", genesis.pack().hex(), "--bits", hex(genesis.bits),
                        "--max-nonce", str(GENESIS_NONCE + 4095), "--client-key",
                        "chip-smoke-5d-genesis"]
        genesis_line = client("genesis", genesis_args)
        _, hash_hex, nonce = genesis_line.split()
        digest = genesis.with_nonce(int(nonce)).block_hash()
        if chain.hash_to_hex(digest) != hash_hex or \
                chain.hash_to_int(digest) > chain.bits_to_target(genesis.bits):
            fail(f"5d genesis Result {hash_hex} {nonce} fails the hashlib check")
        say(f"  5d genesis TARGET, --replica-ack: Result {hash_hex} {nonce} (hashlib-checked; "
            f"{out['seconds']['genesis']:.2f} s through the port's client; phase 5b "
            f"{phase5b['genesis']:.2f} s; {card})")
        deadline = time.time() + 60
        while len(primary_stats()["workers"]) < 2:
            if time.time() > deadline:
                fail("phase 5d: two workers did not join the primary")
            time.sleep(0.05)
        # 5. the MIN job; kill the primary once enough is settled and acked
        base = primary_stats()["stats"]["results_accepted"]
        t_start = time.perf_counter()
        min_client = subprocess.Popen(
            client_args([FAILOVER_DATA.decode(), str(FAILOVER_N - 1), "--client-key",
                         "chip-smoke-5d-min"]),
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs.append(min_client)
        deadline = time.time() + 120
        while (snap := primary_stats())["stats"]["results_accepted"] - base < FAILOVER_SETTLED:
            if min_client.poll() is not None or time.time() > deadline:
                fail(f"phase 5d: the MIN job settled no {FAILOVER_SETTLED} chunks before it "
                     f"ended: {snap['stats']}")
            time.sleep(0.005)
        size_then = os.path.getsize(wal)
        while (snap := primary_stats())["replication"][0]["acked"] < size_then:
            if min_client.poll() is not None or time.time() > deadline:
                fail(f"phase 5d: the standby never acked past {size_then} bytes: "
                     f"{snap['replication']}")
            time.sleep(0.002)
        acked = snap["replication"][0]["acked"]
        settled_chunks = snap["stats"]["results_accepted"] - base
        primary.kill()
        t_kill = time.perf_counter()
        primary.wait()
        lane = snap["replication"][0]
        # 6. the standby promotes; the MIN job ends on it
        wait_log("standby", r"standby PROMOTED", 60, "the standby never promoted")
        out["promote_s"] = time.perf_counter() - t_kill
        text, err = min_client.communicate(timeout=300)
        out["result_s"] = time.perf_counter() - t_kill
        out["seconds"]["min"] = time.perf_counter() - t_start
        check_imports("the 5d MIN client", err, torch_too=True)
        lines = [ln for ln in text.splitlines() if ln.startswith("Result ")]
        if min_client.returncode != 0 or len(lines) != 1:
            fail(f"phase 5d MIN: rc {min_client.returncode}: {text}{err[-2000:]}")
        _, fold, nonce = lines[0].split()
        if (int(fold), int(nonce)) != (expect.hash_value, expect.nonce):
            fail(f"5d MIN across the kill: {fold} {nonce} != CudaMiner's {expect.hash_value} "
                 f"{expect.nonce}")
        promoted = re.search(r"standby PROMOTED: epoch (\d+) \(fenced (\d+) \+ (\d+)\)",
                             log_text("standby"))
        epoch, fenced_from = int(promoted.group(1)), int(promoted.group(2))
        if epoch < fenced_from + FENCE_JUMP:
            fail(f"5d: promoted at epoch {epoch}, not fenced above {fenced_from}")
        say(f"  5d MIN over 2^{FAILOVER_N.bit_length() - 1}, the primary killed after {settled_chunks} settled chunks, "
            f"the standby acked {acked} bytes: Result {fold} {nonce}, equal to CudaMiner's; "
            f"promoted {out['promote_s']:.2f} s after the kill at epoch {epoch} (the primary's "
            f"{fenced_from} + {FENCE_JUMP}), the Result {out['result_s']:.2f} s after it")
        # the genesis job again: from the promoted winner table, no job minted
        minted = len(re.findall(r"client \d+ submitted job", log_text("standby")))
        again = client("genesis again", genesis_args)
        if again != genesis_line:
            fail(f"5d: the promoted coordinator answered the genesis job with {again}, not "
                 f"{genesis_line}")
        if "re-delivering the journaled winner" not in log_text("standby") or \
                len(re.findall(r"client \d+ submitted job", log_text("standby"))) != minted:
            fail("5d: the genesis re-submission was not answered from the winner table")
        say(f"  5d the genesis job re-submitted under its key: the identical Result from the "
            f"promoted winner table, no job minted ({out['seconds']['genesis again']:.2f} s)")
        # 7. phase 4d's SCRYPT job through the promoted coordinator
        line = client("scrypt", ["--header", scrypt_job["header"].hex(), "--bits",
                                 hex(scrypt_job["bits"]), "--scrypt", "--max-nonce",
                                 str(scrypt_job["max_nonce"])])
        _, hash_hex, nonce = line.split()
        hdr = chain.BlockHeader.unpack(scrypt_job["header"]).with_nonce(int(nonce)).pack()
        digest = chain.scrypt_hash(hdr)
        if chain.hash_to_hex(digest) != hash_hex or \
                chain.hash_to_int(digest) > chain.bits_to_target(scrypt_job["bits"]):
            fail(f"5d SCRYPT Result {hash_hex} {nonce} fails the hashlib.scrypt check")
        say(f"  5d SCRYPT through the promoted coordinator: Result {hash_hex} {nonce} "
            f"(hashlib.scrypt-checked; {out['seconds']['scrypt']:.2f} s)")
        # what the primary had settled at its death, read before it restarts
        with open(wal, "rb") as fh:
            primary_settled = settled_count(replay(scan(fh.read())[0]), FAILOVER_DATA,
                                            FAILOVER_N)
        # 8. the old primary restarted on its journal: fenced
        start("zombie", ["tpuminter_torch.coordinator", str(p1), "--journal", wal,
                         "--replicate-to", f"127.0.0.1:{p2}"])
        wait_log("zombie", r"FENCED", 30, "the restarted old primary was not fenced")
        rejected = wait_log("standby", r"REJECTING RepHello epoch (\d+) \(own epoch (\d+)\)", 30,
                            "the promoted coordinator logged no RepHello rejected").groups()
        say(f"  5d the old primary restarted on its journal: FENCED; the promoted coordinator "
            f"rejected its RepHello (epoch {rejected[0]} against its own {rejected[1]})")
        for w in workers:
            if w.poll() is not None:
                fail("5d: a port worker exited early")
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in procs:
            proc.wait(timeout=30)
        for name in ("standby", "primary", "zombie", "worker0", "worker1"):
            check_imports(f"the 5d {name}", log_text(name), torch_too=not name.startswith("w"))
        # the standby's copy: what it acked before the kill, what it adopted
        with open(copy, "rb") as fh:
            data = fh.read()
        records, _ = scan(data)
        fence = next(i for i, r in enumerate(records)
                     if r["k"] == "boot" and int(r["epoch"]) >= FENCE_JUMP)
        adopted = settled_count(replay(records[:fence]), FAILOVER_DATA, FAILOVER_N)
        acked_cov = settled_count(replay(scan(data[:acked])[0]), FAILOVER_DATA, FAILOVER_N)
        out.update(settled_chunks=settled_chunks, acked_bytes=acked, lane=lane, epoch=epoch,
                   acked_coverage=acked_cov, adopted_coverage=adopted,
                   primary_coverage=primary_settled,
                   remined_share=(primary_settled - adopted) / FAILOVER_N)
        say(f"  5d coverage of the MIN job: {acked_cov} nonces in what the standby had acked "
            f"at the last read before the kill, {adopted} adopted by the promotion, "
            f"{primary_settled} settled in the primary's own journal at its death; mined "
            f"twice: {primary_settled - adopted} nonces, {out['remined_share']:.4f} of the "
            f"range (chunks in flight at the kill not counted)")
        say("  5d imports (python -X importtime): no jax, jaxlib or tpuminter module in any "
            "process; no torch in the standby, the coordinators and the clients")
        return out
    except BaseException:
        for name, log in logs:
            log.flush()
            print(f"--- 5d {name} log tail ---\n{log_text(name)[-3000:]}", file=sys.stderr)
        raise
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for _, log in logs:
            log.close()



# ---- phase 5e: the sharded coordinator on the card --------------------------

#: phase 5e's MIN job: SIGKILLed once this many of its nonces are settled
#: in the writer journal
SHARDED_DATA, SHARDED_N = b"tpuminter_torch sharded drill", 1 << 34
SHARDED_SETTLED = 1 << 31
#: workers phase 5e may start on the card to staff every shard
SHARDED_MAX_WORKERS = 8
STATS_LINE = re.compile(r"stats: (.*)$", re.M)


def child_pids(pid: int) -> list:
    """The processes whose parent is ``pid`` (from /proc)."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            out.append(int(entry))
    return out


def pid_alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def phase_port_sharded(scrypt_job, hc_expect, phase5b, card: str) -> dict:
    """Phase 5e: the port's sharded coordinator on the card, every process
    under ``python -X importtime``. (a) ``tpuminter_torch.coordinator
    --loops 2 --journal J`` (writer mode); port workers (``--coordinator
    ADDR --reconnect``) started on the one card until SIGUSR1's per-shard
    stats show a miner on each shard (at most ``SHARDED_MAX_WORKERS``);
    the port's client runs genesis (3h), phase 4d's SCRYPT job (S1, 19,
    S2), hashcore fmin over 2^32 (K7) and a MIN job over 2^34 (`6t`)
    under a client key, each checked as phase 5b checks it. Once the
    writer journal holds ``SHARDED_SETTLED`` of the MIN job's nonces the
    coordinator is SIGKILLed and restarted with ``--procs 2`` on the same
    journal (recovery crosses from the writer file to per-shard
    segments); the workers redial, every shard is staffed again, and the
    client's re-submission must be answered once, equal to
    ``CudaMiner()``'s answer. (b) On the ``--procs 2`` coordinator: the
    genesis job under its key again (the identical Result, from the
    winner table both segments hold), a fresh genesis job and SCRYPT;
    SIGUSR1's per-shard seam counters must mirror (``fwd_out``/``fwd_in``,
    ``binds_gossiped``/``binds_learned``) with no ``seam_drops``; after
    SIGTERM no shard process may be left. No coordinator or client may
    import torch, and no process JAX or the JAX package. Returns the
    phase's figures."""
    from tpuminter_torch import chain
    from tpuminter_torch.cuda_worker import CudaMiner
    from tpuminter_torch.journal import replay, scan, segment_paths
    from tpuminter_torch.protocol import PowMode, Request

    expect = drain(CudaMiner().mine(Request(90, PowMode.MIN, 0, SHARDED_N - 1,
                                            data=SHARDED_DATA)))
    torch.cuda.empty_cache()
    log_dir = os.path.join(ROOT, "build", "tpuminter_torch")
    os.makedirs(log_dir, exist_ok=True)
    env = repo_env()
    port = free_udp_port()
    addr = f"127.0.0.1:{port}"
    wal = os.path.join(log_dir, "e2e5e_coordinator.wal")
    for path in [wal, *segment_paths(wal)]:
        if os.path.exists(path):
            os.remove(path)
    importtime = (sys.executable, "-X", "importtime")
    procs, logs, workers = [], [], []
    out = {"seconds": {}}

    def log_text(name):
        with open(os.path.join(log_dir, f"e2e5e_{name}.log")) as fh:
            return fh.read()

    def start(name, args):
        log = open(os.path.join(log_dir, f"e2e5e_{name}.log"), "w")
        logs.append((name, log))
        procs.append(subprocess.Popen([*importtime, "-m", *args], cwd=ROOT, env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
        return procs[-1]

    def start_coordinator(name, flags):
        proc = start(name, ["tpuminter_torch.coordinator", str(port), "--journal", wal, *flags])
        deadline = time.time() + 60
        while "coordinator listening" not in log_text(name):
            if proc.poll() is not None or time.time() > deadline:
                fail(f"phase 5e: the coordinator ({name}) did not start")
            time.sleep(0.05)
        return proc

    def shard_stats(name, proc):
        """SIGUSR1, then the dump it logs: a list of per-shard dicts."""
        before = len(STATS_LINE.findall(log_text(name)))
        proc.send_signal(signal.SIGUSR1)
        deadline = time.time() + 20
        while len(found := STATS_LINE.findall(log_text(name))) <= before:
            if proc.poll() is not None or time.time() > deadline:
                fail(f"phase 5e: {name} logged no stats on SIGUSR1")
            time.sleep(0.02)
        snap = json.loads(found[-1])
        return snap["shards"] if isinstance(snap, dict) else snap

    def staff(name, proc):
        """Wait for every live worker to join; add one while a shard has
        none, up to SHARDED_MAX_WORKERS."""
        while True:
            deadline = time.time() + 60
            while True:
                shards = shard_stats(name, proc)
                miners = [s["miners"] for s in shards]
                if sum(miners) >= sum(w.poll() is None for w in workers):
                    break
                if time.time() > deadline:
                    fail(f"phase 5e: the workers did not all join {name}: {miners}")
                time.sleep(0.25)
            if all(miners):
                return miners
            if len(workers) >= SHARDED_MAX_WORKERS:
                fail(f"phase 5e: a shard of {name} has no miner after {len(workers)} workers: "
                     f"{miners}")
            workers.append(start(f"worker{len(workers)}", [
                "tpuminter_torch.worker", "--coordinator", addr, "--reconnect"]))

    def client_args(args):
        return [*importtime, "-m", "tpuminter_torch.client", addr, *args, "--timeout", "300"]

    def client(job, args):
        t0 = time.perf_counter()
        res = subprocess.run(client_args(args), cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=400)
        out["seconds"][job] = time.perf_counter() - t0
        check_imports(f"the 5e {job} client", res.stderr, torch_too=True)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("Result ")]
        if res.returncode != 0 or len(lines) != 1:
            fail(f"phase 5e client {job} failed (rc {res.returncode}): {res.stdout}"
                 f"{res.stderr[-2000:]}")
        return res.stdout, lines[0]

    def beside(job, text, b5=None):
        b5 = phase5b.get(job) if b5 is None else b5
        b5_text = f"; phase 5b {b5:.2f} s" if b5 is not None else ""
        say(f"  5e {job}: {text} ({out['seconds'][job]:.2f} s through the port's client"
            f"{b5_text}; {card})")

    genesis = chain.GENESIS_HEADER
    genesis_args = ["--header", genesis.pack().hex(), "--bits", hex(genesis.bits),
                    "--max-nonce", str(GENESIS_NONCE + 4095)]

    def check_genesis(job, line):
        _, hash_hex, nonce = line.split()
        digest = genesis.with_nonce(int(nonce)).block_hash()
        if chain.hash_to_hex(digest) != hash_hex or \
                chain.hash_to_int(digest) > chain.bits_to_target(genesis.bits):
            fail(f"5e {job} Result {hash_hex} {nonce} fails the hashlib check")
        return hash_hex, nonce

    def check_scrypt(line):
        _, hash_hex, nonce = line.split()
        hdr = chain.BlockHeader.unpack(scrypt_job["header"]).with_nonce(int(nonce)).pack()
        digest = chain.scrypt_hash(hdr)
        if chain.hash_to_hex(digest) != hash_hex or \
                chain.hash_to_int(digest) > chain.bits_to_target(scrypt_job["bits"]):
            fail(f"5e SCRYPT Result {hash_hex} {nonce} fails the hashlib.scrypt check")
        return hash_hex, nonce

    scrypt_args = ["--header", scrypt_job["header"].hex(), "--bits", hex(scrypt_job["bits"]),
                   "--scrypt", "--max-nonce", str(scrypt_job["max_nonce"])]
    try:
        t_phase = time.perf_counter()
        # (a) two loops, one writer journal
        loops = start_coordinator("loops", ["--loops", "2"])
        workers.extend(start(f"worker{i}", ["tpuminter_torch.worker", "--coordinator", addr,
                                            "--reconnect"]) for i in range(3))
        miners = staff("loops", loops)
        out["staff_s"] = time.perf_counter() - t_phase
        say(f"  5e --loops 2: {len(workers)} workers on the card, miners a shard {miners} "
            f"({out['staff_s']:.1f} s to staff both)")
        _, line = client("genesis", [*genesis_args, "--client-key", "chip-smoke-5e-genesis"])
        genesis_line = line
        hash_hex, nonce = check_genesis("genesis", line)
        beside("genesis", f"Result {hash_hex} {nonce} (hashlib-checked)")
        _, line = client("scrypt", scrypt_args)
        hash_hex, nonce = check_scrypt(line)
        beside("scrypt", f"Result {hash_hex} {nonce} (hashlib.scrypt-checked)")
        text, _ = client("hashcore fmin", [
            "--workload", "hashcore", "--variant", "fmin", "--seed", str(hc_expect["seed"]),
            "--max-nonce", str(HC_N - 1)])
        searched = int(re.search(r"searched=(\d+)", text).group(1))
        pair = [int(x) for x in re.search(r"value=(\d+) index=(\d+)", text).groups()]
        if (searched, pair) != tuple(hc_expect["fmin"]):
            fail(f"5e hashcore fmin: {searched} {pair} != phase 4c's {hc_expect['fmin']}")
        beside("hashcore fmin", f"{pair} searched={searched}, equal to phase 4c")
        loads = shard_stats("loops", loops)
        # the MIN job; SIGKILL once enough of it is settled in the writer journal
        t_min = time.perf_counter()
        min_client = subprocess.Popen(
            client_args([SHARDED_DATA.decode(), str(SHARDED_N - 1), "--reconnect",
                         "--client-key", "chip-smoke-5e-min"]),
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs.append(min_client)
        deadline = time.time() + 120
        while True:
            with open(wal, "rb") as fh:
                settled = settled_count(replay(scan(fh.read())[0]), SHARDED_DATA, SHARDED_N)
            if settled >= SHARDED_SETTLED:
                break
            if min_client.poll() is not None or time.time() > deadline:
                fail(f"phase 5e: the MIN job settled {settled} nonces, not "
                     f"{SHARDED_SETTLED}, before it ended")
            time.sleep(0.005)
        loops.kill()
        t_kill = time.perf_counter()
        loops.wait()
        out["settled_at_kill"] = settled
        out["into_min_at_kill_s"] = t_kill - t_min
        with open(wal, "rb") as fh:
            at_kill = replay(scan(fh.read())[0])
        # restarted as two shard processes: writer file -> segments
        procs_coord = start_coordinator("procs", ["--procs", "2"])
        out["restart_s"] = time.perf_counter() - t_kill
        segs = segment_paths(wal)
        if os.path.exists(wal) or len(segs) != 2:
            fail(f"5e: the --procs 2 restart left {wal} and segments {segs}")
        miners = staff("procs", procs_coord)
        text, err = min_client.communicate(timeout=300)
        out["kill_to_answer_s"] = time.perf_counter() - t_kill
        out["seconds"]["min"] = time.perf_counter() - t_min
        check_imports("the 5e MIN client", err, torch_too=True)
        lines = [ln for ln in text.splitlines() if ln.startswith("Result ")]
        if min_client.returncode != 0 or len(lines) != 1:
            fail(f"phase 5e MIN: rc {min_client.returncode}: {text}{err[-2000:]}")
        _, fold, nonce = lines[0].split()
        if (int(fold), int(nonce)) != (expect.hash_value, expect.nonce):
            fail(f"5e MIN across the kill: {fold} {nonce} != CudaMiner's {expect.hash_value} "
                 f"{expect.nonce}")
        say(f"  5e MIN over 2^{SHARDED_N.bit_length() - 1}: --loops 2 SIGKILLed "
            f"{out['into_min_at_kill_s']:.2f} s in with {settled} nonces settled in the writer "
            f"journal ({len(at_kill.jobs)} live job), restarted as --procs 2 on it "
            f"(segments {', '.join(os.path.basename(p) for p in segs)}; up "
            f"{out['restart_s']:.2f} s after the kill, miners a shard {miners}, {len(workers)} "
            f"workers in all): one Result {fold} {nonce}, equal to CudaMiner's, "
            f"{out['kill_to_answer_s']:.2f} s after the kill ({out['seconds']['min']:.2f} s "
            f"through the client)")
        # (b) the two shard processes
        _, again = client("genesis again", [*genesis_args, "--client-key",
                                            "chip-smoke-5e-genesis"])
        if again != genesis_line:
            fail(f"5e: --procs 2 answered the genesis job with {again}, not {genesis_line}")
        beside("genesis again", "the identical Result from the winner table the segments hold",
               b5=phase5b.get("genesis again"))
        _, line = client("genesis fresh", [*genesis_args, "--client-key",
                                           "chip-smoke-5e-genesis-procs"])
        hash_hex, nonce = check_genesis("genesis fresh", line)
        beside("genesis fresh", f"Result {hash_hex} {nonce} (hashlib-checked)",
               b5=phase5b.get("genesis"))
        _, line = client("scrypt procs", scrypt_args)
        hash_hex, nonce = check_scrypt(line)
        beside("scrypt procs", f"Result {hash_hex} {nonce} (hashlib.scrypt-checked)",
               b5=phase5b.get("scrypt"))
        shards = shard_stats("procs", procs_coord)
        if len(shards) != 2:
            fail(f"5e: SIGUSR1 reported {len(shards)} shard processes: {shards}")
        s0, s1 = (s["seam"] for s in sorted(shards, key=lambda s: s["shard"]))
        mirrored = (s0["fwd_out"] == s1["fwd_in"] and s1["fwd_out"] == s0["fwd_in"]
                    and s0["binds_gossiped"] == s1["binds_learned"]
                    and s1["binds_gossiped"] == s0["binds_learned"])
        if not mirrored or s0["seam_drops"] or s1["seam_drops"]:
            fail(f"5e: the seam's counters do not mirror: {s0} {s1}")
        out["loops_shards"] = [{k: s[k] for k in ("shard", "conns", "miners", "results_accepted",
                                                  "forwarded_out", "handoff_in")} for s in loads]
        out["procs_shards"] = [{"shard": s["shard"], "conns": s["conns"], "miners": s["miners"],
                                "results_accepted": s["stats"]["results_accepted"],
                                "jobs_done": s["stats"]["jobs_done"],
                                "seam_rebinds_honored": s["stats"]["seam_rebinds_honored"],
                                **s["seam"]} for s in shards]
        say(f"  5e --loops 2 shards: {json.dumps(out['loops_shards'])}")
        say(f"  5e --procs 2 shards (SIGUSR1): {json.dumps(out['procs_shards'])}")
        # SIGTERM: the group stops, no shard process left
        kids = child_pids(procs_coord.pid)
        if len(kids) < 2:
            fail(f"5e: the --procs 2 coordinator has {len(kids)} child processes")
        procs_coord.terminate()
        procs_coord.wait(timeout=30)
        deadline = time.time() + 10
        while (left := [k for k in kids if pid_alive(k)]) and time.time() < deadline:
            time.sleep(0.05)
        if left:
            fail(f"5e: processes {left} of the --procs 2 coordinator outlived its SIGTERM")
        for w in workers:
            if w.poll() is not None:
                fail("5e: a port worker exited early")
        for name in ("loops", "procs"):
            check_imports(f"the 5e {name} coordinator", log_text(name), torch_too=True)
        for i in range(len(workers)):
            check_imports(f"the 5e worker{i}", log_text(f"worker{i}"), torch_too=False)
        out["children_reaped"] = len(kids)
        out["workers"] = len(workers)
        out["phase_s"] = time.perf_counter() - t_phase
        say(f"  5e SIGTERM: the --procs 2 coordinator and its {len(kids)} child processes "
            f"(shards and multiprocessing's resource tracker) gone; imports (python -X "
            f"importtime): no jax, jaxlib or tpuminter module anywhere, no torch in the "
            f"coordinators (parent and shard processes) and the clients; phase "
            f"{out['phase_s']:.1f} s")
        return out
    except BaseException:
        for name, log in logs:
            log.flush()
            print(f"--- 5e {name} log tail ---\n{log_text(name)[-3000:]}", file=sys.stderr)
        raise
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for _, log in logs:
            log.close()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing to test", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--pod-rank"]:
        return pod_rank_main(sys.argv[2])
    sys.path.insert(0, ROOT)
    from tpuminter_torch.kernels import build, sass

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)

    def phase(title):
        say(f"== {title}   [{time.perf_counter() - t_start:.1f} s]")

    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    phase("1. environment")
    say(f"  python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    say(smi)
    card_tag = f"{card}, {smi.split(',')[-1].strip()} limit"

    phase("2. build")
    t0 = time.perf_counter()
    infos = build.build()
    say(f"  nvcc, one per source, all started together: {time.perf_counter() - t0:.1f} s")
    for name, info in infos.items():
        say(f"  built {os.path.relpath(info.path, ROOT)} in {info.seconds:.1f} s")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                say(f"  {line.strip()}")
        build.library(name)
        for kernel, ops_count in (sass.sass_summary(str(info.path)) or {}).items():
            top = sorted(ops_count.items(), key=lambda kv: -kv[1])[:9]
            say(f"  SASS {kernel}: {sum(ops_count.values())} instructions; "
                + ", ".join(f"{op} {c}" for op, c in top))
    pipes = pipe_mixes(infos)
    roll_local_memory(infos)
    waves = wave_report(dev)

    phase("3. kernels against their plain versions")
    stats, scrypt_info = phase_kernels(dev, np.random.default_rng(SEED))

    phase("3b. layout probes (P1-P3) against their plain versions and the fused walk")
    stats.update(phase_probes(dev, np.random.default_rng(SEED + 4), issue_rate(dev)[2]))

    phase("4a. main path, fixed headers (CudaMiner defaults)")
    fixed, fixed_rates = phase_main_path(card_tag)
    phase("4a'. the fixed-header path through ProfiledMiner (--profile)")
    profiled = phase_profiled_chunk()
    phase("4b. main path, rolled jobs")
    rolled, rates = phase_rolled_path(card_tag, np.random.default_rng(SEED + 1))

    phase("4c. main path, hashcore workload chunks")
    hc_rng = np.random.default_rng(SEED + 2)
    k7_ms = stats["splitmix_batch"].timing["ms"]
    sweep_rates, breakdown = hashcore_window_sweep(dev, hc_rng, k7_ms)
    hashcore, hc_rates, hc_expect = phase_hashcore_path(dev, card_tag, hc_rng, k7_ms,
                                                        breakdown)
    torch.cuda.empty_cache()

    phase("4d. main path, SCRYPT chunks")
    scrypt, scrypt_rates, scrypt_job = phase_scrypt_path(
        dev, card_tag, np.random.default_rng(SEED + 3), scrypt_info)
    torch.cuda.empty_cache()

    phase("4e. the pod worker: one rank on NCCL, two ranks sharing the card over gloo, "
          "--backend pod end to end")
    pod_launches, pod_info = phase_pod(card_tag)
    torch.cuda.empty_cache()

    phase("5. end to end: coordinator + port worker + client processes")
    e2e_seconds, window, crash_expect = phase_end_to_end(hc_expect, scrypt_job, card_tag)
    hc_e2e_seconds, scrypt_rates["e2e_seconds"] = e2e_seconds["hashcore"], e2e_seconds["scrypt"]
    dict_seconds, crash_seconds = e2e_seconds["dict"], e2e_seconds["crash"]

    phase("5b. end to end on the port alone: its coordinator, worker and client processes")
    port_seconds = phase_port_control_plane(hc_expect, scrypt_job, crash_expect, e2e_seconds,
                                            card_tag)

    phase("5c. the coordinator's policies on the port: audits, hedging, admission, streaming, "
          "the stats endpoint")
    audit_launches, audit_ms = phase_audit_shapes(card_tag, np.random.default_rng(SEED + 6))
    policies = phase_port_policies(scrypt_job, card_tag)

    phase("5d. a failover drill on the port: WAL shipping to a hot standby, the primary "
          "killed mid-job, the standby promoted, the old primary fenced")
    failover = phase_port_failover(scrypt_job, port_seconds, card_tag)

    phase("5e. the sharded coordinator on the port: --loops 2 with a writer journal, killed "
          "mid-job and restarted as --procs 2 on it")
    sharded = phase_port_sharded(scrypt_job, hc_expect, port_seconds, card_tag)

    paths = {"fixed": fixed, "profiled": profiled, "rolled": rolled, "hashcore": hashcore,
             "scrypt": scrypt, "pod": pod_launches, "audit": audit_launches}
    rows = []
    for name, st in stats.items():
        t = st.timing
        path = ("fixed" if name in FIXED_PATH_KERNELS + FIXED_PATH_GENERIC else
                "hashcore" if name == "splitmix_batch" else
                "scrypt" if name in SCRYPT_PATH_KERNELS + ("row_gather",) or name in PROBE_SITES
                else "rolled")
        rows.append({
            "name": st.name, "route": "cuda", "source": st.source,
            "replaces": st.replaces, "launches": paths[path][st.kernel],
            "launches_by_path": {p: counts[st.kernel] for p, counts in paths.items()},
            "max_abs_err": st.max_abs_err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms"),
            "n": t["n"], "plain_n": t.get("plain_n", t["n"]),
            "ops_per_nonce": t["ops_per_nonce"],
            "int32_pipe_ms": t["int32_pipe_ms"], "checks": st.checks,
            **({"pipes": pipes[name]} if name in pipes else {}),
            **({"occupancy": waves[name]} if name in waves else {}),
            **{k: t[k] for k in ("ms_at_reps", "ns_per_row", "probe", "toy60_ms",
                                 "toy60_bound_ms", "paced_ms", "ms_10_rows", "serial_floor_ms",
                                 "compressions", "geometry", "bound_every_read_ms") if k in t},
        })
    say(json.dumps({"hashcore": {"rates": hc_rates, "window_sweep_g_per_s": sweep_rates,
                                 "window_breakdown": breakdown,
                                 "e2e_seconds": hc_e2e_seconds}}))
    say(json.dumps({"fixed_ghs": fixed_rates}))
    say(json.dumps({"profiled_window": window}))
    say(json.dumps({"rolled_ghs": rates}))
    say(json.dumps({"dict": {"e2e_seconds": dict_seconds, "candidates": DICT_N}}))
    say(json.dumps({"crash_drill": {"e2e_seconds": crash_seconds, "nonces": CRASH_N}}))
    say(json.dumps({"control_plane": {"phase5_seconds": e2e_seconds,
                                      "phase5b_seconds": port_seconds}}))
    say(json.dumps({"pod": pod_info}))
    say(json.dumps({"policies": {"audit_shape_ms": audit_ms, **policies}}))
    say(json.dumps({"failover": failover}))
    say(json.dumps({"sharded": sharded}))
    say(json.dumps({"scrypt": {"rates": scrypt_rates, "kernels": {
        k: v for k, v in scrypt_info.items() if k != "kernel_mhs"}}}))
    say(f"  total {time.perf_counter() - t_start:.1f} s")
    say(smi)
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
