"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions
(counterpart of ``tpuminter.kernels``)."""

from tpuminter_torch.kernels.sha256 import (
    KERNELS,
    extranonce_roll,
    min_toy,
    search_candidates,
    search_candidates_hdr,
    search_candidates_hdr_batch,
    search_candidates_hdr_batch_sched,
    search_target,
    sha256_batch,
)

__all__ = [
    "KERNELS", "extranonce_roll", "min_toy", "search_candidates",
    "search_candidates_hdr", "search_candidates_hdr_batch",
    "search_candidates_hdr_batch_sched", "search_target", "sha256_batch",
]
