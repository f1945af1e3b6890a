"""Multi-card pods: one process a card on ``torch.distributed``.

Counterpart of ``tpuminter.parallel``. The reference shards the nonce
axis over the chips of a slice with ``shard_map``; the port runs one
process a card (``parallel.distributed``: the rendezvous, the sweep
group, the leader's control channel), each rank sweeping its own share
on the port's kernels, with ``torch.distributed`` collectives folding
the ranks' answers (``parallel.mesh``). ``pod_worker.PodMiner`` is the
miner on top.
"""

from tpuminter_torch.parallel.distributed import Pod, init_from_env, init_pod
from tpuminter_torch.parallel.mesh import (
    candidate_sweep,
    exact_sweep,
    min_sweep,
    rolled_sweep,
    scrypt_sweep,
)

__all__ = ["Pod", "init_from_env", "init_pod", "candidate_sweep", "exact_sweep", "min_sweep",
           "rolled_sweep", "scrypt_sweep"]
