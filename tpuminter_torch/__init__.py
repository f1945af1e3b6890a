"""tpuminter_torch: the PyTorch/CUDA port of tpuminter for NVIDIA Hopper.

A package of its own beside ``tpuminter`` (the JAX/TPU reference, left
unchanged). It imports ``torch`` and numpy, never ``jax`` and nothing of
``tpuminter``: what it needs of the reference's framework-free modules
(chain, protocol, the LSP) it keeps as its own copies, and its only
contact with the JAX package is the wire protocol and the journal's
file format.

All three roles run from here: ``python -m tpuminter_torch.coordinator
PORT``, ``python -m tpuminter_torch.worker HOST:PORT`` and ``python -m
tpuminter_torch.client HOST:PORT ...``. The worker mines TARGET
(fixed-header and rolled, extranonce included) and MIN chunks on
hand-written CUDA kernels (``kernels/csrc/sha256.cu``), SCRYPT chunks on
three more (``kernels/csrc/scrypt.cu``) and computes hashcore workload
chunks on another (``kernels/csrc/splitmix.cu``), returning the Results
and WorkResults the reference workers return; its entry points run on
``cuda`` unless the caller passes ``device="cpu"``, which runs the
kernels' plain PyTorch versions. The coordinator (single-loop, or
sharded with ``--loops`` or ``--procs``), the client, the journal, the
replication standby and the LSP server run on the host and import no
``torch``.

Module counterparts (each module's docstring names its own):

- ``chain`` ← ``tpuminter.chain``
- ``protocol`` ← ``tpuminter.protocol`` (both codecs of the three roles' kinds)
- ``lsp`` ← ``tpuminter.lsp`` (client, server, the echo runners)
- ``coordinator`` ← ``tpuminter.coordinator`` (its shard hooks and CLI
  included)
- ``multiloop`` ← ``tpuminter.multiloop`` (N shards on N event loops)
- ``multiproc`` ← ``tpuminter.multiproc`` (N shard processes and their seam)
- ``replication`` ← ``tpuminter.replication``
- ``analysis`` ← ``tpuminter.analysis`` (the runtime ``affinity``
  detector; the static checkers run over the port from the tests)
- ``client`` ← ``tpuminter.client``
- ``journal`` ← ``tpuminter.journal`` (the file, and the shards' segments)
- ``ops.sha256`` ← ``tpuminter.ops.sha256`` + the integer half of
  ``tpuminter.ops.symbolic``
- ``ops.merkle`` ← ``tpuminter.ops.merkle``
- ``ops.splitmix`` ← ``tpuminter.ops.splitmix``
- ``ops.scrypt`` ← ``tpuminter.ops.scrypt``
- ``kernels`` ← ``tpuminter.kernels.sha256`` and ``tpuminter.kernels.splitmix``;
  ``kernels.scrypt`` ← the scrypt walk and row-gather probes
  (``scripts/walk_pallas_probe.py``, ``scripts/romix_pallas_probe.py``)
- ``workloads`` ← ``tpuminter.workloads`` (registry, folds, hashcore,
  dict; the worker's compute and the coordinator's verification)
- ``search`` ← ``tpuminter.search``
- ``rolled`` ← ``tpuminter.rolled``
- ``cuda_worker`` ← ``tpuminter.tpu_worker`` (its SCRYPT dialect ←
  ``tpuminter.jax_worker.JaxMiner._mine_scrypt``)
- ``worker`` ← ``tpuminter.worker``
- ``parallel`` ← ``tpuminter.parallel`` (``distributed``: the rendezvous
  and the leader's channel on ``torch.distributed``; ``mesh``: the pod
  sweeps)
- ``pod_worker`` ← ``tpuminter.pod_worker`` (``--backend pod``: one
  process a card)
"""

__version__ = "0.1.0"
