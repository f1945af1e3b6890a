"""Runtime race detection for the port's control plane.

Counterpart of ``tpuminter.analysis``. The port keeps only the runtime
half, :mod:`tpuminter_torch.analysis.affinity`: with
``TPUMINTER_LOOP_AFFINITY=1`` the coordinator, the journal and the
replication lanes are stamped with their owning loop's thread, and every
mutation that arrives from another event loop's thread is recorded.

The static half, the reference's ``ast`` checkers, runs over this
package from the tests (``tests/test_torch_analysis.py``) against the
port's own :file:`allowlist.json` beside this file; the port does not
copy them. Production modules import this package for the affinity
hooks only, so this ``__init__`` imports nothing.
"""
