"""Several processes joined into one mesh: the counterpart of ``jax.distributed``.

:func:`initialize` joins this process to a group of ``num_processes`` over
``torch.distributed`` (a TCP rendezvous at ``coordinator_address``, the
``gloo`` backend by default). From then on
:func:`~super_resolution_tpu_torch.parallel.mesh.make_mesh` spans every
process of the group, and the one thing that crosses between them during a
solve is the all-reduce of :func:`~super_resolution_tpu_torch.parallel.collectives.psum_together`.

``gloo`` is the backend on the CPU and, on a host with one card, on the card
too: NCCL does not take two ranks on one GPU. Nothing here finds a cluster
by itself: the caller gives the address, the process count and the rank.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

__all__ = ["initialize", "shutdown", "is_initialized", "process_count", "process_index"]


def initialize(coordinator_address: str, num_processes: int, process_id: int, backend: str = "gloo",
               timeout_s: float = 120.0) -> None:
    """Join the group: ``coordinator_address`` is ``host:port`` of the rendezvous
    (process 0 listens there), ``process_id`` this process's rank. Raises if
    the group does not form within ``timeout_s`` or is already formed."""
    if dist.is_initialized():
        raise RuntimeError("A process group is already initialized in this process.")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not in [0, {num_processes}).")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                            rank=int(process_id), timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Leave the group (nothing to do when there is none)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Processes in the group; 1 without one."""
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if is_initialized() else 0


def all_reduce_sum(buffer: torch.Tensor) -> None:
    """Sum ``buffer`` over the group, in place."""
    dist.all_reduce(buffer, op=dist.ReduceOp.SUM)
