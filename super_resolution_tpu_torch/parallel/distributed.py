"""Several processes joined into one mesh: the counterpart of ``jax.distributed``.

:func:`initialize` joins this process to a group of ``num_processes`` over
``torch.distributed`` (a TCP rendezvous at ``coordinator_address``, the
``gloo`` backend by default). From then on
:func:`~super_resolution_tpu_torch.parallel.mesh.make_mesh` spans every
process of the group. Three calls carry what crosses between processes during a solve
(``parallel/collectives.py`` and ``parallel/sharded.py`` make them):
:func:`all_reduce_sum` (cost and gradient partials, dot products),
:func:`exchange` (the rims of tiles and the one-band ring between
neighbouring shards) and :func:`all_gather` (a value assembled at the IRLS
seam).

``gloo`` is the backend on the CPU and, on a host with one card, on the card
too: NCCL does not take two ranks on one GPU. On an H100 with torch 2.11,
``gloo``'s all-reduce and all-gather take CUDA tensors (they go through host
memory inside the backend); its send and receive do not: given a device
pointer, its TCP transport aborts the process ("writev: Bad address").
:func:`exchange` therefore stages a CUDA piece through pinned host memory.
Nothing here finds a cluster by itself: the caller gives the address, the
process count and the rank.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

__all__ = ["initialize", "shutdown", "is_initialized", "process_count", "process_index", "all_reduce_sum",
           "exchange", "all_gather"]


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


def _host_buffer(tensor: torch.Tensor) -> torch.Tensor:
    """Where the point-to-point calls read or write ``tensor``: itself on the
    CPU when contiguous, else a buffer of its shape (pinned for a CUDA tensor)."""
    if tensor.device.type == "cpu":
        return tensor if tensor.is_contiguous() else torch.empty_like(tensor, memory_format=torch.contiguous_format)
    if tensor.device.type != "cuda":
        raise ValueError(f"gloo's point-to-point calls take no {tensor.device.type} tensor.")
    return torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)


def exchange(sends, receives) -> None:
    """Point-to-point: post every ``(peer, tag, tensor)`` of ``sends`` and of
    ``receives`` in one ``dist.batch_isend_irecv`` and wait for all of them;
    each received tensor is written in place. Messages are matched by peer
    and tag, so a tag names one message of the call between two processes.

    CUDA tensors cross through pinned host memory (see the module's
    docstring): the sent pieces are copied out and their streams
    synchronised before anything is posted, the received ones copied in on
    the current stream afterwards.
    """
    if not sends and not receives:
        return
    outgoing = []
    for peer, tag, tensor in sends:
        host = _host_buffer(tensor)
        if host is not tensor:
            host.copy_(tensor, non_blocking=True)
        outgoing.append((peer, tag, host))
    for device in {t.device for _, _, t in sends if t.device.type == "cuda"}:
        torch.cuda.current_stream(device).synchronize()
    incoming = [(peer, tag, tensor, _host_buffer(tensor)) for peer, tag, tensor in receives]
    ops = [dist.P2POp(dist.isend, host, peer, tag=tag) for peer, tag, host in outgoing]
    ops += [dist.P2POp(dist.irecv, host, peer, tag=tag) for peer, tag, _, host in incoming]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for _, _, tensor, host in incoming:
        if host is not tensor:
            tensor.copy_(host, non_blocking=True)


def all_gather(tensor: torch.Tensor) -> torch.Tensor:
    """Every process's ``tensor`` (one shape and dtype in all), stacked in rank
    order along a new first dimension, on ``tensor``'s device, in every process."""
    out = torch.empty(process_count() * tensor.numel(), dtype=tensor.dtype, device=tensor.device)
    dist.all_gather_into_tensor(out, tensor.reshape(-1).contiguous())
    return out.reshape((process_count(),) + tuple(tensor.shape))
