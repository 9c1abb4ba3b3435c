"""A value spread over the shards of a mesh, so that ``minimize`` runs on it.

The JAX package hands ``minimize`` a global array with a sharding and lets
the compiler partition the CG loop's vector algebra. Here the state of an
inner solve is a :class:`Sharded`: one local tensor per shard, each on its
shard's device, for the whole solve. ``x``, the gradient, the search
direction and the constants never leave their devices; per evaluation only
rims, one band, frame partials and scalars cross (``parallel/collectives.py``).

A ``Sharded`` knows which mesh axes PARTITION it and along which tensor
dimension (``{"band": 0}``, ``{"row": 1, "col": 2}``); along every other
mesh axis it is REPLICATED: the shards there hold equal values. A scalar of
the CG loop (``alpha``, ``beta``, a cost) is a ``Sharded`` with no
partitioning axis, one 0-d tensor per device.

Elementwise torch functions and operators work shard by shard through
``__torch_function__`` and the operator methods; a plain Python number or a
``Sharded`` scalar broadcasts. Shards that hold the same part of the value
on the same device share one tensor object (the work is done once per
device, not once per shard), so the locals are read-only: nothing in
``minimize`` writes in place but the L-BFGS memory, one slot per step
(:meth:`Sharded.per_shard`, once per distinct piece); the fused IRLS solve
writes its buffers with :meth:`Sharded.copy_` / :meth:`Sharded.fill_`. The
one reduction is :meth:`Sharded.vdot`: dots per shard, summed over the
partitioning axes only, never over an axis along which the value is
replicated. ``bool()`` / ``float()`` read this process's first shard.

On a mesh that spans processes a ``Sharded`` holds this process's shards
only (``parts[i]`` is ``None`` for another process's shard). A scalar is
replicated in every process, bit for bit: a dot product over pieces that lie
in several processes ends in one all-reduce, whose result every process
gets alike, so every process takes every branch of the solve alike.
:meth:`Sharded.to_global` gathers the pieces of other processes.
"""

from __future__ import annotations

import operator

import torch

from super_resolution_tpu_torch.parallel import distributed
from super_resolution_tpu_torch.parallel.collectives import all_reduce, sum_to_devices
from super_resolution_tpu_torch.parallel.mesh import Mesh

__all__ = ["Sharded"]


class Elementwise:
    """What a solve's state that is not one tensor shares: torch functions,
    the operators and :meth:`per_shard` all run through the subclass's
    ``_apply(func, args, kwargs)`` (:class:`Sharded`: shard by shard;
    ``data_parallel``'s band stack: on its one tensor)."""

    @classmethod
    def _apply(cls, func, args, kwargs):
        raise NotImplementedError

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return cls._apply(func, args, kwargs or {})

    @classmethod
    def per_shard(cls, fn, *operands):
        """``fn`` of the operands' local tensors (other operands pass as they are)."""
        return cls._apply(fn, operands, {})

    def _binary(func, reflected=False):  # noqa: N805 - builds the operator methods below
        def method(self, other):
            return type(self)._apply(func, (other, self) if reflected else (self, other), {})
        return method

    __add__ = _binary(operator.add)
    __radd__ = _binary(operator.add, True)
    __sub__ = _binary(operator.sub)
    __rsub__ = _binary(operator.sub, True)
    __mul__ = _binary(operator.mul)
    __rmul__ = _binary(operator.mul, True)
    __truediv__ = _binary(operator.truediv)
    __rtruediv__ = _binary(operator.truediv, True)
    __lt__ = _binary(operator.lt)
    __le__ = _binary(operator.le)
    __gt__ = _binary(operator.gt)
    __ge__ = _binary(operator.ge)
    __eq__ = _binary(operator.eq)
    __ne__ = _binary(operator.ne)
    __and__ = _binary(operator.and_)
    __or__ = _binary(operator.or_)
    __getitem__ = _binary(operator.getitem)
    __hash__ = None
    del _binary

    def __neg__(self):
        return type(self)._apply(operator.neg, (self,), {})

    def __abs__(self):
        return type(self)._apply(operator.abs, (self,), {})

    def __invert__(self):
        return type(self)._apply(operator.invert, (self,), {})


class Sharded(Elementwise):
    """``parts[i]`` is shard ``i``'s local tensor; ``partition`` maps each
    partitioning mesh axis to the tensor dimension it splits."""

    def __init__(self, mesh: Mesh, parts, partition: dict[str, int] | None = None):
        parts = list(parts)
        if len(parts) != mesh.num_shards:
            raise ValueError(f"{len(parts)} local tensors for a mesh of {mesh.num_shards} shards.")
        self.mesh = mesh
        self.parts = parts
        ndim = parts[mesh.local_shards[0]].ndim
        self.partition = {
            axis: dim % ndim for axis, dim in (partition or {}).items() if mesh.size(axis) > 1
        }

    # ------------------------------------------------------------ placement

    @classmethod
    def from_global(cls, mesh: Mesh, tensor: torch.Tensor, partition: dict[str, int] | None = None) -> "Sharded":
        """Split ``tensor`` along the partitioned dimensions and put every
        piece on its shard's device (a copy per device, not per shard, where
        shards hold the same piece; this process's shards only)."""
        probe = cls(mesh, [tensor] * mesh.num_shards, partition)
        for axis, dim in probe.partition.items():
            if tensor.shape[dim] % mesh.size(axis):
                raise ValueError(
                    f"Dimension {dim} of size {tensor.shape[dim]} is not divisible by mesh axis "
                    f"{axis!r} of size {mesh.size(axis)}.")
        placed: dict[tuple, torch.Tensor] = {}
        parts = [None] * mesh.num_shards
        for shard in mesh.local_shards:
            key = probe._key(shard)
            if key not in placed:
                piece = tensor
                for axis, dim in probe.partition.items():
                    n = tensor.shape[dim] // mesh.size(axis)
                    piece = piece.narrow(dim, mesh.coords(shard)[axis] * n, n)
                placed[key] = piece.to(mesh.devices[shard]).contiguous()
            parts[shard] = placed[key]
        return cls(mesh, parts, probe.partition)

    def to_global(self, device=None) -> torch.Tensor:
        """The whole value as one tensor on ``device`` (default: this process's
        first shard's), the same in every process. Where some process lacks
        a piece, every process takes part in one all-gather of the pieces
        (each counted at its :meth:`_owner`); without a process group that
        raises ``ValueError``."""
        device = self.local(0).device if device is None else torch.device(device)
        mesh = self.mesh
        pieces = {}  # where -> the local tensor of that piece
        for shard in mesh.local_shards:
            pieces.setdefault(self._where(shard), self.parts[shard])
        every_piece = {self._where(i) for i in range(mesh.num_shards)}
        held = {p: {self._where(i) for i in range(mesh.num_shards) if mesh.processes[i] == p}
                for p in set(mesh.processes)}
        if any(pieces_of_p != every_piece for pieces_of_p in held.values()):
            if not distributed.is_initialized():
                raise ValueError("Part of this value lies in another process; it cannot be assembled here "
                                 "without a process group (parallel.distributed.initialize).")
            pieces = self._gathered()
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for where, part in pieces.items():
            view = out
            for (_, dim), coord in zip(self.partition.items(), where):
                view = view.narrow(dim, coord * part.shape[dim], part.shape[dim])
            view.copy_(part, non_blocking=True)
        return out

    def _where(self, shard: int) -> tuple:
        """The piece shard ``shard`` holds: its coordinates on the partitioning axes."""
        coords = self.mesh.coords(shard)
        return tuple(coords[axis] for axis in self.partition)

    def _owner(self, shard: int) -> bool:
        """True for the one shard that stands for its piece over all processes:
        coordinate 0 on every axis that does not partition the value."""
        return all(v == 0 for axis, v in self.mesh.coords(shard).items() if axis not in self.partition)

    def _gathered(self) -> dict:
        """Every piece, from one all-gather in which each process sends the
        pieces of its owner shards (zeros where it owns fewer than another)."""
        mesh = self.mesh
        owners = [i for i in range(mesh.num_shards) if self._owner(i)]
        by_process = {p: [i for i in owners if mesh.processes[i] == p] for p in sorted(set(mesh.processes))}
        slots = max(len(shards) for shards in by_process.values())
        like = self.local(0)
        mine = [self.parts[i].to(like.device) for i in by_process[mesh.process_index]]
        mine += [like.new_zeros(like.shape)] * (slots - len(mine))
        gathered = distributed.all_gather(torch.stack(mine))
        return {self._where(i): gathered[p][slot] for p, shards in by_process.items() for slot, i in enumerate(shards)}

    def _key(self, shard: int) -> tuple:
        """Shards with equal keys hold the same piece on the same device."""
        coords = self.mesh.coords(shard)
        return (self.mesh.devices[shard],) + tuple(coords[axis] for axis in self.partition)

    # ----------------------------------------------------------- inspection

    @property
    def dtype(self) -> torch.dtype:
        return self.local(0).dtype

    @property
    def shape(self) -> tuple[int, ...]:
        """The whole value's shape."""
        shape = list(self.local(0).shape)
        for axis, dim in self.partition.items():
            shape[dim] *= self.mesh.size(axis)
        return tuple(shape)

    @property
    def ndim(self) -> int:
        return self.local(0).ndim

    def local(self, index: int) -> torch.Tensor:
        """The tensor of this process's ``index``-th shard (all shards in one process: shard ``index``)."""
        return self.parts[self.mesh.local_shards[index]]

    def distinct_parts(self) -> list[torch.Tensor]:
        """This process's local tensors, each once."""
        return list({id(self.parts[i]): self.parts[i] for i in self.mesh.local_shards}.values())

    def copy_(self, other: "Sharded") -> "Sharded":
        """Write ``other`` into this value's tensors in place, shard by shard."""
        for shard in self.mesh.local_shards:
            if self.parts[shard] is not other.parts[shard]:
                self.parts[shard].copy_(other.parts[shard])
        return self

    def fill_(self, value) -> "Sharded":
        for part in self.distinct_parts():
            part.fill_(value)
        return self

    def __bool__(self) -> bool:
        return bool(self.local(0))

    def __float__(self) -> float:
        return float(self.local(0))

    def __repr__(self) -> str:
        return (f"Sharded({self.mesh.shape}, partition={self.partition}, "
                f"local shape {tuple(self.local(0).shape)}, {self.dtype})")

    # ------------------------------------------------------------ elementwise

    @classmethod
    def _apply(cls, func, args, kwargs):
        """``func`` shard by shard; once per distinct (device, piece)."""
        operands = [a for a in list(args) + list(kwargs.values()) if isinstance(a, Sharded)]
        mesh = operands[0].mesh
        partition: dict[str, int] = {}  # dimensions counted from the right, as broadcasting aligns them
        for operand in operands:
            if operand.mesh is not mesh:
                raise ValueError("Operands live on different meshes.")
            for axis, dim in operand.partition.items():
                if partition.setdefault(axis, dim - operand.ndim) != dim - operand.ndim:
                    raise ValueError(f"Operands are partitioned differently along mesh axis {axis!r}.")
        result_of: dict[tuple, torch.Tensor] = {}
        parts = [None] * mesh.num_shards
        for shard in mesh.local_shards:
            coords = mesh.coords(shard)
            key = (mesh.devices[shard],) + tuple(coords[axis] for axis in partition)
            if key not in result_of:
                pick = lambda a: a.parts[shard] if isinstance(a, Sharded) else a
                local = func(*[pick(a) for a in args], **{k: pick(v) for k, v in kwargs.items()})
                if not isinstance(local, torch.Tensor):
                    raise NotImplementedError(f"{func} does not return a tensor; it cannot run on a Sharded.")
                result_of[key] = local
            parts[shard] = result_of[key]
        if partition and parts[mesh.local_shards[0]].ndim < -min(partition.values()):
            raise NotImplementedError(f"{func} dropped a partitioned dimension; it cannot run on a Sharded.")
        return Sharded(mesh, parts, partition)

    def map(self, fn) -> "Sharded":
        """``fn(local) -> local`` on every shard; ``fn`` must keep the partitioned dimensions in place."""
        return Sharded._apply(fn, (self,), {})

    def to(self, dtype: torch.dtype) -> "Sharded":
        return self if dtype == self.dtype else self.map(lambda t: t.to(dtype))

    def new_full(self, size, value) -> "Sharded":
        """A replicated constant of this value's dtype, one tensor per device (``size`` is usually ``()``)."""
        made = {d: torch.full(size, value, dtype=self.dtype, device=d) for d in self.mesh.unique_devices()}
        return Sharded(self.mesh, [made[d] if self.mesh.is_local(i) else None
                                   for i, d in enumerate(self.mesh.devices)])

    def vdot(self, other: "Sharded") -> "Sharded":
        """``<self, other>`` over the whole value, as a replicated scalar.

        One dot per distinct piece, summed in shard order over the
        partitioning axes only: along an axis where the value is replicated
        (``frame``) every shard holds the same piece, and it counts once.
        Where the pieces lie in several processes, each process sums the
        dots of its owner shards (:meth:`_owner`; zero if it has none) and
        one all-reduce adds the processes' sums; otherwise every process holds
        every piece and sums them itself, with no call between processes.
        """
        if other.partition != self.partition or other.mesh is not self.mesh:
            raise ValueError("vdot needs two values sharded the same way.")
        mesh = self.mesh
        crossing = any(mesh.crosses_processes(group) for group in mesh.groups(self.partition))
        dots, seen = [], set()
        for shard in mesh.local_shards:
            where = self._where(shard)
            if where in seen or (crossing and not self._owner(shard)):
                continue
            seen.add(where)
            dots.append(torch.dot(self.parts[shard].reshape(-1), other.parts[shard].reshape(-1)))
        if crossing:
            home = mesh.devices[mesh.local_shards[0]]
            total = sum_to_devices(dots, [home])[home] if dots else self.local(0).new_zeros(())
            all_reduce(total)
            dots = [total]
        totals = sum_to_devices(dots, mesh.unique_devices())
        return Sharded(mesh, [totals[d] if mesh.is_local(i) else None for i, d in enumerate(mesh.devices)])
