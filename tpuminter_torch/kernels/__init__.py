"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions
(counterpart of ``tpuminter.kernels``)."""

from tpuminter_torch.kernels.sha256 import (
    KERNELS,
    min_toy,
    search_candidates,
    search_target,
    sha256_batch,
)

__all__ = ["KERNELS", "min_toy", "search_candidates", "search_target", "sha256_batch"]
