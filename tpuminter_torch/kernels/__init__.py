"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions
(counterpart of ``tpuminter.kernels``)."""

from tpuminter_torch.kernels import sha256 as _sha256
from tpuminter_torch.kernels.sha256 import (
    extranonce_roll,
    min_toy,
    min_toy_toy,
    search_candidates,
    search_candidates_header,
    search_candidates_hdr,
    search_candidates_hdr_batch,
    search_candidates_hdr_batch_sched,
    search_target,
    search_target_header,
    sha256_batch,
)
from tpuminter_torch.kernels import scrypt as _scrypt
from tpuminter_torch.kernels.scrypt import (
    romix_scratch,
    romix_walk,
    row_gather,
    scrypt_back,
    scrypt_front,
)
from tpuminter_torch.kernels.splitmix import splitmix_batch
from tpuminter_torch.kernels import probes as _probes

#: every kernel wrapper, in table order (K1-K6 with the header arms of K2
#: and K3 and K6's toy arm, the roll, K7, the scrypt kernels S1, 19, S2
#: and 11, then the layout probes' P1-P3)
KERNELS = _sha256.KERNELS + (splitmix_batch,) + _scrypt.KERNELS + _probes.KERNELS

__all__ = [
    "KERNELS", "extranonce_roll", "min_toy", "min_toy_toy", "romix_scratch", "romix_walk",
    "row_gather", "scrypt_back", "scrypt_front", "search_candidates", "search_candidates_header",
    "search_candidates_hdr", "search_candidates_hdr_batch",
    "search_candidates_hdr_batch_sched", "search_target", "search_target_header",
    "sha256_batch", "splitmix_batch",
]
