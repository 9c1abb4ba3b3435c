"""Device mesh for multi-device solving.

The reference is single-threaded C++; every scaling axis it loops over
serially is a mesh axis here, as in the JAX package's ``parallel/mesh.py``:

- ``frame`` — the K low-res observations: per-evaluation cost and gradient
  are summed over the axis.
- ``band``  — spectral channels / PCA components.
- ``row`` / ``col`` — spatial tiles of the HR estimate with halo exchange
  sized by the stencil footprint (blur radius + max shift + scale).

A :class:`Mesh` is named axes over a list of *shards*, each living on a
``torch.device``. A device may hold several shards: on a host with one card
every shard of a ``{"row": 2, "col": 2}`` mesh lives on that card (and the
tests put them all on ``cpu``); on a host with four cards each shard has its
own. One process drives its shards, in shard order, as the JAX package's
single controller does.

Once :func:`~super_resolution_tpu_torch.parallel.distributed.initialize` has
joined several processes (the counterpart of ``jax.distributed.initialize``),
:func:`make_mesh` spans all of them, as a JAX mesh over ``jax.devices()``
does: the shards are dealt to the processes in contiguous blocks of shard
order, each process places and drives only its own, and what crosses between
processes goes through ``torch.distributed`` (``parallel/collectives.py``).
Only the ``frame`` axis may cross a process boundary: a ``band``, ``row`` or
``col`` neighbour is always in the same process, so the halo exchanges and
the dot products of the solve stay local and one all-reduce per evaluation
is all that crosses.
"""

from __future__ import annotations

import itertools
import math

import torch

from super_resolution_tpu_torch._device import resolve_device
from super_resolution_tpu_torch.parallel import distributed

__all__ = ["Mesh", "make_mesh", "FRAME_AXIS", "BAND_AXIS", "ROW_AXIS", "COL_AXIS"]

FRAME_AXIS = "frame"
BAND_AXIS = "band"
ROW_AXIS = "row"
COL_AXIS = "col"


class Mesh:
    """Named axes over shards; shard ``i`` has the coordinates ``coords(i)``
    (row-major over ``axis_names``), belongs to process ``processes[i]`` and
    lives on ``devices[i]`` there. ``processes`` defaults to this process
    for every shard; ``process_index`` is this process's rank."""

    def __init__(self, axis_names, sizes, devices, processes=None, process_index: int = 0):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in sizes)))
        self.devices = [torch.device(d) for d in devices]
        if len(self.devices) != self.num_shards:
            raise ValueError(f"Mesh {self.shape} needs {self.num_shards} shard devices, got {len(self.devices)}.")
        self.process_index = int(process_index)
        self.processes = [self.process_index] * self.num_shards if processes is None else [int(p) for p in processes]
        if len(self.processes) != self.num_shards:
            raise ValueError(f"Mesh {self.shape} needs {self.num_shards} shard owners, got {len(self.processes)}.")
        self._coords = [
            dict(zip(self.axis_names, index))
            for index in itertools.product(*(range(n) for n in self.shape.values()))
        ]
        self.local_shards = [i for i, p in enumerate(self.processes) if p == self.process_index]
        if not self.local_shards:
            raise ValueError(f"Process {self.process_index} owns no shard of the mesh {self.shape}.")
        for group in self.groups([a for a in self.axis_names if a != FRAME_AXIS]):
            if len({self.processes[i] for i in group}) > 1:
                raise ValueError(
                    f"Only the frame axis may span processes; the mesh {self.shape} over "
                    f"{self.num_processes} processes would split a band, row or col axis between them "
                    "(put 'frame' first and make its size a multiple of the process count).")

    @property
    def num_processes(self) -> int:
        return len(set(self.processes))

    @property
    def spans_processes(self) -> bool:
        return self.num_processes > 1

    def is_local(self, shard: int) -> bool:
        return self.processes[shard] == self.process_index

    @property
    def num_shards(self) -> int:
        return math.prod(self.shape.values())

    def size(self, axis: str) -> int:
        """Number of shards along ``axis``; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def coords(self, shard: int) -> dict[str, int]:
        return self._coords[shard]

    def shard_at(self, coords: dict[str, int]) -> int:
        index = 0
        for name, n in self.shape.items():
            index = index * n + coords[name]
        return index

    def neighbor(self, shard: int, axis: str, step: int, wrap: bool = False) -> int | None:
        """The shard ``step`` places along ``axis``; ``None`` past the end unless ``wrap``."""
        coords = dict(self._coords[shard])
        n = self.size(axis)
        position = coords.get(axis, 0) + step
        if wrap:
            position %= n
        if not 0 <= position < n:
            return None
        if axis in self.shape:
            coords[axis] = position
        return self.shard_at(coords)

    def groups(self, axes) -> list[list[int]]:
        """Shards grouped so that the members of a group differ only along ``axes``."""
        axes = [a for a in axes if a in self.shape]
        keyed: dict[tuple, list[int]] = {}
        for shard, coords in enumerate(self._coords):
            key = tuple(v for name, v in coords.items() if name not in axes)
            keyed.setdefault(key, []).append(shard)
        return list(keyed.values())

    def unique_devices(self) -> list[torch.device]:
        """The devices of this process's shards."""
        return list(dict.fromkeys(self.devices[i] for i in self.local_shards))

    def __repr__(self) -> str:
        processes = f", processes={self.num_processes}" if self.spans_processes else ""
        return f"Mesh({self.shape}, devices={[str(d) for d in self.unique_devices()]}{processes})"


def make_mesh(axis_sizes: dict[str, int] | None = None, devices=None) -> Mesh:
    """Build a mesh from ``{axis_name: size}``.

    ``devices``: this process's devices to deal its shards over, in turn
    (``None``: every visible CUDA card; raises without one). The shards may
    outnumber the devices, several then share one. One axis may be ``-1`` to
    absorb the device count: its size is the number of devices over the
    product of the other sizes. The shards must be a multiple of the devices. No sizes at all gives a ``frame`` axis with a
    shard per device.

    After :func:`~super_resolution_tpu_torch.parallel.distributed.initialize`
    the mesh spans every process of the group, each bringing ``devices``: the
    device count above is the processes' together, and process ``p`` owns
    the ``p``-th block of ``num_shards / num_processes`` shards in shard
    order (``ValueError`` if they do not divide, or if an axis other than
    ``frame`` would cross a process boundary).
    """
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("A mesh needs at least one device.")
    num_processes, rank = distributed.process_count(), distributed.process_index()
    n = len(devices) * num_processes
    if not axis_sizes:
        axis_sizes = {FRAME_AXIS: n}
    names = list(axis_sizes.keys())
    sizes = [int(s) for s in axis_sizes.values()]
    if sizes.count(-1) > 1:
        raise ValueError("At most one mesh axis may be -1.")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if known < 1 or n % known:
            raise ValueError(f"{n} devices not divisible by {known}.")
        sizes[sizes.index(-1)] = n // known
    if any(s < 1 for s in sizes):
        raise ValueError(f"Mesh axis sizes must be positive, got {dict(zip(names, sizes))}.")
    shards = math.prod(sizes)
    if shards % n:
        raise ValueError(f"Mesh {dict(zip(names, sizes))} of {shards} shards cannot be dealt evenly over {n} devices.")
    if shards % num_processes:
        raise ValueError(f"{shards} shards cannot be dealt evenly to {num_processes} processes.")
    per_process = shards // num_processes
    return Mesh(names, sizes, [devices[(i % per_process) % len(devices)] for i in range(shards)],
                processes=[i // per_process for i in range(shards)], process_index=rank)
