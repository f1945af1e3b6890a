"""One process per card: the pod's rendezvous, its sweep collectives and
the leader → follower channel, on ``torch.distributed``.

Counterpart of ``tpuminter.parallel.distributed``. The reference joins
every host into one ``jax.distributed`` cluster and lets ``shard_map``
place the collectives; here each card gets a process of its own, and a
:class:`Pod` holds what a rank needs:

- **The rendezvous.** :func:`init_from_env` reads the reference's own
  triple, ``TPUMINTER_COORD_ADDR`` (``HOST:PORT`` of rank 0's store),
  ``TPUMINTER_NUM_PROCS`` and ``TPUMINTER_PROC_ID``; rank ``r`` mines on
  ``cuda:{r % torch.cuda.device_count()}``, or on the CPU when asked.
  ``TPUMINTER_HEARTBEAT_S`` (default 30) is the sweep group's timeout: a
  collective that waits longer, or whose peer died, raises.
- **The sweep group** carries the sweeps' collectives
  (``parallel.mesh``) on small int64 tensors. Its backend follows from
  the layout, decided once, before any sweep: NCCL when every rank has a
  card of its own, gloo when two ranks share a card (NCCL refuses that)
  or the ranks run on the CPU. Nothing falls back from one to the other;
  on gloo the tensors cross to the host for the collective.
- **The control channel** is the default group, gloo on host tensors:
  :meth:`Pod.broadcast_flag` and :meth:`Pod.broadcast_bytes` mirror the
  leader's request stream and step flags to the followers
  (``pod_worker.follower_loop``). A follower waits in it for as long as
  the leader has no chunk, so its timeout is :data:`CONTROL_TIMEOUT`;
  a leader that dies closes its sockets, and gloo raises on the follower
  at once.

The reference framed every broadcast in one fixed 4096-byte shape,
because separately compiled CPU collectives could share a channel tag
under jax and gloo matched a flag with a payload. Here collectives are
issued eagerly, in program order, from the one thread that steps the
miner, and each group numbers its own: a broadcast's length travels
first and the payload follows in one tensor of exactly that length, so
no frame is needed.
"""

from __future__ import annotations

import logging
import os
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["Pod", "init_from_env", "init_pod", "rank_device", "ENV_ADDR", "ENV_NPROCS",
           "ENV_PID", "ENV_HEARTBEAT", "DEFAULT_HEARTBEAT_S", "CONTROL_TIMEOUT"]

log = logging.getLogger("tpuminter_torch.parallel")

ENV_ADDR = "TPUMINTER_COORD_ADDR"
ENV_NPROCS = "TPUMINTER_NUM_PROCS"
ENV_PID = "TPUMINTER_PROC_ID"
ENV_HEARTBEAT = "TPUMINTER_HEARTBEAT_S"
#: seconds a sweep collective may wait for its peers
DEFAULT_HEARTBEAT_S = 30.0
#: the control channel's timeout: a follower idles in it between chunks
CONTROL_TIMEOUT = timedelta(days=30)


@dataclass
class Pod:
    """One rank's view of its pod. ``group`` is None for a pod of one
    process, whose collectives are the identity."""

    rank: int
    world: int
    device: torch.device
    #: the sweep collectives' group and its backend ("nccl", "gloo", or
    #: "none" for one process)
    group: Optional[object] = None
    backend: str = "none"

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    # -- the sweep group ----------------------------------------------------

    def _on_group(self, t: torch.Tensor) -> torch.Tensor:
        # gloo's collectives take host tensors here; NCCL's stay on the card
        return t.cpu() if self.backend == "gloo" else t.contiguous()

    def all_reduce_min(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise minimum of ``t`` over the ranks (a new tensor,
        on the host under gloo)."""
        if self.group is None:
            return t
        t = self._on_group(t).clone()
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t``, stacked in rank order: ``(world, *t.shape)``
        (on the host under gloo)."""
        if self.group is None:
            return t.unsqueeze(0)
        t = self._on_group(t)
        out = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(out, t, group=self.group)
        return torch.stack(out)

    # -- the control channel --------------------------------------------------

    def broadcast_flag(self, value: Optional[int] = None) -> int:
        """One int from the leader to every rank (followers pass None)."""
        buf = torch.tensor([0 if value is None else value], dtype=torch.int64)
        if self.world > 1:
            dist.broadcast(buf, src=0)
        return int(buf[0])

    def broadcast_bytes(self, data: Optional[bytes] = None) -> bytes:
        """A byte string from the leader (followers pass None): its length,
        then the bytes in one tensor of that length."""
        n = self.broadcast_flag(None if data is None else len(data))
        if n == 0:
            return b""
        if data is not None:
            buf = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        else:
            buf = torch.empty(n, dtype=torch.uint8)
        if self.world > 1:
            dist.broadcast(buf, src=0)
        return buf.numpy().tobytes()

    def close(self) -> None:
        """Leave the pod: destroy its process groups."""
        if self.group is not None and dist.is_initialized():
            dist.destroy_process_group()
            self.group = None


def rank_device(rank: int, device="cuda") -> torch.device:
    """Rank ``rank``'s device: ``cuda:{rank % device_count}`` for a CUDA
    request (raises when torch sees no card), the CPU when asked."""
    device = torch.device(device)
    if device.type == "cpu":
        return torch.device("cpu")
    if device.type != "cuda":
        raise ValueError(f"device must be cuda or cpu, got {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("a pod rank needs a CUDA device and torch sees none; "
                           "device='cpu' runs the kernels' plain versions")
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_pod(addr: str, world: int, rank: int, *, device="cuda",
             heartbeat_s: float = DEFAULT_HEARTBEAT_S) -> Pod:
    """Join the pod of ``world`` processes whose rank 0 serves the store at
    ``addr`` (``HOST:PORT``) as rank ``rank``, and choose the sweep
    group's backend from the layout (module docstring)."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a pod of {world}")
    device = rank_device(rank, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://{addr}", world_size=world,
                            rank=rank, timeout=CONTROL_TIMEOUT)
    places = [None] * world
    dist.all_gather_object(places, (socket.gethostname(), device.type, device.index))
    if len({kind for _, kind, _ in places}) != 1:
        raise RuntimeError(f"a pod's ranks must share one device type: {places}")
    shared = device.type == "cpu" or len(set(places)) < world
    backend = "gloo" if shared else "nccl"
    group = dist.new_group(backend=backend, timeout=timedelta(seconds=heartbeat_s))
    if rank == 0:
        log.info("pod of %d rank(s) on %s: sweep collectives over %s (%s)", world,
                 ", ".join(f"{h}/{k}:{i}" if i is not None else f"{h}/{k}"
                           for h, k, i in places), backend,
                 "the CPU" if device.type == "cpu" else
                 "ranks share a card" if shared else "a card a rank")
    return Pod(rank, world, device, group, backend)


def init_from_env(device="cuda") -> Optional[Pod]:
    """The pod the ``TPUMINTER_*`` triple describes, or None when
    ``TPUMINTER_COORD_ADDR`` is unset (this process is not a rank)."""
    addr = os.environ.get(ENV_ADDR)
    if addr is None:
        return None
    return init_pod(addr, int(os.environ[ENV_NPROCS]), int(os.environ[ENV_PID]),
                    device=device,
                    heartbeat_s=float(os.environ.get(ENV_HEARTBEAT, DEFAULT_HEARTBEAT_S)))
