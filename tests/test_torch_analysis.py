"""The reference's static checkers over the port, and the port's runtime
loop-affinity detector.

- The six checkers of ``tpuminter.analysis`` run over ``tpuminter_torch/``
  against the port's own ``tpuminter_torch/analysis/allowlist.json``:
  every finding must be allowlisted, every entry must match a finding
  and carry a reason, and the sharded modules (``multiloop.py``,
  ``multiproc.py``) may hold only entries whose checker, qualname and
  symbol the reference's allowlist grants its own module.
- ``tpuminter_torch.analysis.affinity`` records a cross-loop mutation
  (and raises in strict mode), stays silent for the executor seam and
  after a rebind, and exposes the reference's names.
"""

import asyncio
import json
import os
import subprocess
import sys
import threading

import pytest

from tpuminter.analysis import affinity as ref_affinity
from tpuminter.analysis.core import CHECKERS, Allowlist, default_allowlist_path, run_project
from tpuminter_torch.analysis import affinity

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ALLOWLIST = os.path.join(ROOT, "tpuminter_torch", "analysis", "allowlist.json")
SHARDED = ("tpuminter_torch/multiloop.py", "tpuminter_torch/multiproc.py")


@pytest.fixture(scope="module")
def report():
    return run_project(ROOT, ("tpuminter_torch",), allowlist=Allowlist.load(PORT_ALLOWLIST))


@pytest.mark.parametrize("checker", CHECKERS)
def test_the_port_is_clean_under_its_allowlist(report, checker):
    fresh = [f.render() for f in report.findings if f.checker == checker]
    stale = [e for e in report.stale_entries if e["checker"] == checker]
    assert fresh == [] and stale == []


def test_every_entry_has_a_reason_and_earns_it(report):
    entries = Allowlist.load(PORT_ALLOWLIST).entries
    assert entries and len(report.suppressed) >= len(entries)
    for entry in entries:
        assert entry["path"].startswith("tpuminter_torch/")
        assert len(entry["reason"].split()) >= 8, entry


def test_the_sharded_modules_hold_only_the_references_grants():
    with open(default_allowlist_path(), encoding="utf-8") as fh:
        granted = {(e["checker"], e["path"].replace("tpuminter/", "tpuminter_torch/", 1),
                    e["qualname"], e["symbol"]) for e in json.load(fh)}
    with open(PORT_ALLOWLIST, encoding="utf-8") as fh:
        mine = [e for e in json.load(fh) if e["path"] in SHARDED]
    assert mine
    for e in mine:
        assert (e["checker"], e["path"], e["qualname"], e["symbol"]) in granted, e


def test_the_thread_and_proc_seam_checkers_read_the_sharded_modules():
    """The checkers key on ``threading.Thread`` and ``Process``: both
    modules are analyzed, not skipped, and pass with the entries above."""
    rep = run_project(ROOT, SHARDED, checkers=("thread-seam", "proc-seam"),
                      allowlist=Allowlist.load(PORT_ALLOWLIST))
    assert rep.findings == []
    assert {f.symbol for f in rep.suppressed} == {"shard.stop_mode"}


# -- the runtime detector -------------------------------------------------------------

class _Owned:
    def __init__(self):
        self.value = 0
        affinity.stamp(self)


def _on_other_loop(fn):
    def body():
        async def main():
            fn()

        asyncio.run(main())

    t = threading.Thread(target=body, name="intruder-loop")
    t.start()
    t.join(10)


@pytest.fixture
def detector():
    affinity.enable()
    affinity.reset()
    yield
    affinity.disable()
    affinity.reset()


def test_a_cross_loop_write_is_recorded(detector):
    obj = _Owned()
    obj.value = 1  # the owner thread: fine
    _on_other_loop(lambda: setattr(obj, "value", 2))
    (v,) = affinity.violations()
    assert v["cls"] == "_Owned" and v["attr"] == "value"
    assert v["writer_thread"] == "intruder-loop"
    assert affinity.owner_ident(obj) == v["owner_ident"]


def test_the_executor_seam_and_a_rebind_are_not_violations(detector):
    obj = _Owned()
    t = threading.Thread(target=lambda: setattr(obj, "value", 3))  # no loop there
    t.start()
    t.join(10)

    def adopt_then_write():
        affinity.rebind(obj)
        obj.value = 4

    _on_other_loop(adopt_then_write)
    assert affinity.violations() == [] and obj.value == 4


def test_strict_mode_raises():
    affinity.enable(strict=True)
    affinity.reset()
    errors = []
    try:
        obj = _Owned()

        def write():
            try:
                obj.value = 5
            except affinity.LoopAffinityError as exc:
                errors.append(exc)

        _on_other_loop(write)
    finally:
        affinity.disable()
        affinity.reset()
    assert len(errors) == 1 and obj.value == 0


def test_disabled_stamp_is_free_and_the_names_are_the_references():
    obj = _Owned()
    assert type(obj) is _Owned and affinity.owner_ident(obj) is None
    assert set(ref_affinity.__all__) <= set(affinity.__all__)


def test_the_environment_variable_turns_it_on():
    probe = ("from tpuminter_torch.analysis import affinity as a; "
             "print(a.enabled(), a._strict)")
    env = dict(os.environ, TPUMINTER_LOOP_AFFINITY="1", TPUMINTER_LOOP_AFFINITY_STRICT="1")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "True"]
