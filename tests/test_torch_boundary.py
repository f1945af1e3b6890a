"""The port's boundary: tpuminter_torch and chip_smoke.py never import
JAX or the JAX package, and the port's control plane (coordinator,
client, journal, replication, the sharded coordinators, the affinity
detector, LSP server) loads no torch either, in a sharded coordinator's
shard processes included.

The runtime check runs in a subprocess, because this test process has
already imported JAX (tests/conftest.py does, for the JAX package's
tests); the static check parses every source file of the port.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "tpuminter_torch"
FORBIDDEN = {"jax", "jaxlib", "tpuminter"}

_PROBE = r"""
import importlib, pkgutil, sys
import tpuminter_torch
for mod in pkgutil.walk_packages(tpuminter_torch.__path__, "tpuminter_torch."):
    importlib.import_module(mod.name)
from tpuminter_torch.cuda_worker import CudaMiner
from tpuminter_torch.protocol import PowMode, Request
from tpuminter_torch import chain
miner = CudaMiner(device="cpu")
res = [r for r in miner.mine(Request(1, PowMode.MIN, 0, 255, data=b"x")) if r][0]
assert res.hash_value == min(chain.toy_hash(b"x", n) for n in range(256))
g = chain.GENESIS_HEADER
res = [r for r in miner.mine(Request(2, PowMode.TARGET, g.nonce - 5, g.nonce + 5,
       header=g.pack(), target=chain.bits_to_target(g.bits))) if r][0]
assert res.found and res.nonce == g.nonce
cb = bytes(range(60))
rolled = Request(3, PowMode.TARGET, 0, (3 << 8) - 1, header=g.pack(), target=1 << 255,
                 coinbase_prefix=cb[:20], coinbase_suffix=cb[20:], extranonce_size=1,
                 branch=(cb[:32],), nonce_bits=8)
res = [r for r in miner.mine(rolled) if r][0]
tmpl = chain.CoinbaseTemplate(cb[:20], cb[20:], 1)
en, nonce = chain.split_global(res.nonce, 8)
hdr = chain.rolled_header(g.pack(), tmpl, (cb[:32],), en).with_nonce(nonce)
assert res.found and chain.hash_to_int(hdr.block_hash()) == res.hash_value <= 1 << 255
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tpuminter"))
print("LOADED", bad)
"""


def test_port_runs_without_loading_jax_or_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "LOADED []"


_CONTROL_PLANE_PROBE = r"""
import sys
import tpuminter_torch.coordinator, tpuminter_torch.client, tpuminter_torch.journal
import tpuminter_torch.replication, tpuminter_torch.multiloop, tpuminter_torch.multiproc
import tpuminter_torch.analysis.affinity
import tpuminter_torch.lsp.server, tpuminter_torch.lsp.srunner, tpuminter_torch.lsp.crunner
from tpuminter_torch import workloads
assert workloads.names() == ("dict", "hashcore")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "jaxlib", "tpuminter"))
print("LOADED", bad)
"""


def test_control_plane_loads_neither_torch_nor_jax():
    """A coordinator host needs no CUDA stack: the port's coordinator,
    client, journal and LSP server import no torch, no JAX and nothing
    of the JAX package."""
    out = subprocess.run(
        [sys.executable, "-c", _CONTROL_PLANE_PROBE], cwd=ROOT, capture_output=True,
        text=True, timeout=60,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "LOADED []"


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_port_source_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = {
        str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & FORBIDDEN)
        for f in files
    }
    assert {f: roots for f, roots in offenders.items() if roots} == {}


_POLICY_FLAGS = ["--roll-budget", "2", "--hedge-after", "1", "--audit-rate", "1.0",
                 "--stats-port", "0", "--quota-rate", "1", "--quota-burst", "2",
                 "--quota-tier", "gold=4", "--max-jobs", "4", "--retry-after-ms", "100",
                 "--winners-ttl", "60", "--unbound-ttl", "60", "--park-queue", "8",
                 "--workload-weight", "mine=1,dict=2", "--emit-interval", "0.2"]


def test_coordinator_with_every_policy_flag_loads_neither_torch_nor_jax(tmp_path):
    """``python -X importtime -m tpuminter_torch.coordinator`` with a
    journal and every policy flag: it serves its stats endpoint, dumps
    the same snapshot to its log on SIGUSR1, and no module of torch,
    JAX or the JAX package appears in its import log."""
    import json
    import re
    import signal
    import time
    import urllib.request

    log = tmp_path / "coordinator.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m", "tpuminter_torch.coordinator", "0",
             "--journal", str(tmp_path / "c.wal"), *_POLICY_FLAGS],
            cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + 30
            while not (m := re.search(r"stats endpoint on http://127.0.0.1:(\d+)",
                                      log.read_text())):
                assert proc.poll() is None and time.monotonic() < deadline, log.read_text()
                time.sleep(0.05)
            with urllib.request.urlopen(f"http://127.0.0.1:{m.group(1)}", timeout=5) as rsp:
                snap = json.load(rsp)
            assert snap["stats"]["jobs_done"] == 0 and "journal" in snap
            proc.send_signal(signal.SIGUSR1)
            while "stats: {" not in log.read_text():
                assert proc.poll() is None and time.monotonic() < deadline, log.read_text()
                time.sleep(0.05)
        finally:
            proc.kill()
            proc.wait()
    mods = re.findall(r"^import time:\s+\d+\s+\|\s+\d+\s+\|\s+(\S+)", log.read_text(), re.M)
    assert "tpuminter_torch.journal" in {m.strip() for m in mods}
    bad = sorted({m for m in mods
                  if m.split(".")[0] in ("torch", "jax", "jaxlib", "tpuminter")})
    assert bad == []


def test_standby_cli_promotes_fenced_and_loads_neither_torch_nor_jax(tmp_path):
    """``python -X importtime -m tpuminter_torch.replication`` over a WAL
    copy whose primary never connects: once ``--promote-after`` passes it
    promotes replay-free at the copy's epoch plus ``FENCE_JUMP`` and
    serves as the coordinator, and no module of torch, JAX or the JAX
    package appears in its import log."""
    import re
    import time

    from tpuminter_torch.journal import encode_record

    wal = tmp_path / "standby.wal"
    wal.write_bytes(encode_record({"k": "boot", "epoch": 3}))
    log = tmp_path / "standby.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m", "tpuminter_torch.replication",
             "127.0.0.1:9", "--wal", str(wal), "--promote-after", "0.2"],
            cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + 30
            while "serving as coordinator on port" not in log.read_text():
                assert proc.poll() is None and time.monotonic() < deadline, log.read_text()
                time.sleep(0.05)
        finally:
            proc.kill()
            proc.wait()
    text = log.read_text()
    assert f"standby PROMOTED: epoch {3 + (1 << 16)} (fenced 0 + {1 << 16})" in text
    mods = {m.strip() for m in re.findall(r"^import time:\s+\d+\s+\|\s+\d+\s+\|\s+(\S+)",
                                          text, re.M)}
    assert {"tpuminter_torch.replication", "tpuminter_torch.coordinator"} <= mods
    assert sorted(m for m in mods
                  if m.split(".")[0] in ("torch", "jax", "jaxlib", "tpuminter")) == []


_SHARDED = ("multiloop.py", "multiproc.py", "analysis/__init__.py", "analysis/affinity.py")


def test_the_sharded_modules_import_no_torch():
    offenders = {name: sorted(set(_imported_roots(PORT / name)) & (FORBIDDEN | {"torch"}))
                 for name in _SHARDED}
    assert {n: roots for n, roots in offenders.items() if roots} == {}


@pytest.mark.parametrize("flags, copies", [(["--loops", "2"], 1), (["--procs", "2"], 2)])
def test_a_sharded_coordinator_and_its_shards_load_neither_torch_nor_jax(tmp_path, flags,
                                                                          copies):
    """``python -X importtime -m tpuminter_torch.coordinator`` sharded with
    a journal: it comes up and dumps its per-shard stats on SIGUSR1, and
    no module of torch, JAX or the JAX package appears in the import log
    of the parent or of any spawned shard process (``-X importtime``
    passes to them; the parent runs the coordinator as ``__main__`` and
    imports it by name once more for its loops, while each of two shard
    processes imports it by name once)."""
    import re
    import signal
    import time

    log = tmp_path / "coordinator.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m", "tpuminter_torch.coordinator", "0",
             "--journal", str(tmp_path / "c.wal"), *flags],
            cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + 30
            while "coordinator listening on port" not in log.read_text():
                assert proc.poll() is None and time.monotonic() < deadline, log.read_text()
                time.sleep(0.05)
            proc.send_signal(signal.SIGUSR1)
            while "stats: " not in log.read_text():
                assert proc.poll() is None and time.monotonic() < deadline, log.read_text()
                time.sleep(0.05)
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=20)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    text = log.read_text()
    # a module imported on a loop thread while another thread imports
    # can log a negative self time
    mods = re.findall(r"^import time:\s+-?\d+\s+\|\s+-?\d+\s+\|\s+(\S+)", text, re.M)
    assert [m.strip() for m in mods].count("tpuminter_torch.coordinator") == copies, text[-2000:]
    assert sorted({m for m in mods
                   if m.split(".")[0] in ("torch", "jax", "jaxlib", "tpuminter")}) == []
    assert '"shards"' in text or '"seam"' in text
