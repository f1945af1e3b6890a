"""K7: the splitmix64 kernel's wrapper, its plain version and its launch count.

Counterpart of ``tpuminter.kernels.splitmix`` (``pallas_splitmix_batch``).
:func:`splitmix_batch` runs the CUDA kernel (``csrc/splitmix.cu``) for
index words on the card and the plain version
(``ops.splitmix.splitmix64_pair``) for index words on the CPU, chosen
only by where its inputs lie; a CUDA request launches the kernel or
raises. Words travel as contiguous 1-D int64 tensors holding
``[0, 2^32)``; the kernel launches on torch's current stream.
``splitmix_batch.launches`` counts its launches (plain runs are not
counted).
"""

from __future__ import annotations

import torch

from tpuminter_torch.kernels import build
from tpuminter_torch.kernels.sha256 import (
    _check_lanes, _cuda_device, _grid, _same_device, _stream,
)
from tpuminter_torch.ops.splitmix import splitmix64_pair

__all__ = ["splitmix_batch", "splitmix_batch_plain"]

_I64 = torch.int64
_M64 = (1 << 64) - 1


#: the plain version: u32-pair arithmetic on int64 lanes, on the inputs' device
splitmix_batch_plain = splitmix64_pair


def splitmix_batch(seed: int, idx_hi: torch.Tensor, idx_lo: torch.Tensor):
    """Objective values for a batch of global indices: seed (u64) and
    ``(N,)`` index words ``hi``/``lo`` → ``(N,)`` value words
    ``(value_hi, value_lo)``, each ``splitmix64(seed + (index + 1) ·
    golden)`` (≡ the JAX package's ``pallas_splitmix_batch``). Unlike
    the Pallas kernel, ``N`` need not be a multiple of 128."""
    if not 0 <= seed <= _M64:
        raise ValueError(f"seed={seed} is not a u64")
    n = idx_lo.shape[0] if idx_lo.dim() == 1 else -1
    _check_lanes("idx_hi", idx_hi, (n,))
    _check_lanes("idx_lo", idx_lo, (n,))
    device = _same_device(idx_hi, idx_lo)
    if device.type == "cpu":
        return splitmix_batch_plain(seed, idx_hi, idx_lo)
    device = _cuda_device(device)
    val_hi = torch.empty(n, dtype=_I64, device=device)
    val_lo = torch.empty(n, dtype=_I64, device=device)
    if n:
        err = build.library("splitmix").tm_splitmix_batch(
            seed, idx_hi.data_ptr(), idx_lo.data_ptr(), val_hi.data_ptr(),
            val_lo.data_ptr(), n, _grid(n, device.index), device.index, _stream(device),
        )
        if err != 0:
            raise RuntimeError(f"tm_splitmix_batch failed: CUDA error {err}")
        splitmix_batch.launches += 1
    return val_hi, val_lo


splitmix_batch.launches = 0
