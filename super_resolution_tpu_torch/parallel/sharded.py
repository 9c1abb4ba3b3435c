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
device, not once per shard), so the locals are read-only: nothing here or in
``minimize`` writes in place but the L-BFGS memory, one slot per step
(:meth:`Sharded.per_shard`, once per distinct piece). The one reduction is
:meth:`Sharded.vdot`: dots per shard, summed over the partitioning axes
only, never over an axis along which the value is replicated. ``bool()`` /
``float()`` read shard 0.
"""

from __future__ import annotations

import operator

import torch

from super_resolution_tpu_torch.parallel.collectives import sum_to_devices
from super_resolution_tpu_torch.parallel.mesh import Mesh

__all__ = ["Sharded"]


class Sharded:
    """``parts[i]`` is shard ``i``'s local tensor; ``partition`` maps each
    partitioning mesh axis to the tensor dimension it splits."""

    def __init__(self, mesh: Mesh, parts, partition: dict[str, int] | None = None):
        parts = list(parts)
        if len(parts) != mesh.num_shards:
            raise ValueError(f"{len(parts)} local tensors for a mesh of {mesh.num_shards} shards.")
        self.mesh = mesh
        self.parts = parts
        ndim = parts[0].ndim
        self.partition = {
            axis: dim % ndim for axis, dim in (partition or {}).items() if mesh.size(axis) > 1
        }

    # ------------------------------------------------------------ placement

    @classmethod
    def from_global(cls, mesh: Mesh, tensor: torch.Tensor, partition: dict[str, int] | None = None) -> "Sharded":
        """Split ``tensor`` along the partitioned dimensions and put every
        piece on its shard's device (a copy per device, not per shard, where
        shards hold the same piece)."""
        probe = cls(mesh, [tensor] * mesh.num_shards, partition)
        for axis, dim in probe.partition.items():
            if tensor.shape[dim] % mesh.size(axis):
                raise ValueError(
                    f"Dimension {dim} of size {tensor.shape[dim]} is not divisible by mesh axis "
                    f"{axis!r} of size {mesh.size(axis)}.")
        placed: dict[tuple, torch.Tensor] = {}
        parts = []
        for shard in range(mesh.num_shards):
            key = probe._key(shard)
            if key not in placed:
                piece = tensor
                for axis, dim in probe.partition.items():
                    n = tensor.shape[dim] // mesh.size(axis)
                    piece = piece.narrow(dim, mesh.coords(shard)[axis] * n, n)
                placed[key] = piece.to(mesh.devices[shard]).contiguous()
            parts.append(placed[key])
        return cls(mesh, parts, probe.partition)

    def to_global(self, device=None) -> torch.Tensor:
        """The whole value as one tensor on ``device`` (default: shard 0's)."""
        device = self.parts[0].device if device is None else torch.device(device)
        shape = list(self.parts[0].shape)
        for axis, dim in self.partition.items():
            shape[dim] *= self.mesh.size(axis)
        out = torch.empty(shape, dtype=self.dtype, device=device)
        done = set()
        for shard, part in enumerate(self.parts):
            coords = self.mesh.coords(shard)
            where = tuple(coords[axis] for axis in self.partition)
            if where in done:
                continue
            done.add(where)
            view = out
            for axis, dim in self.partition.items():
                view = view.narrow(dim, coords[axis] * part.shape[dim], part.shape[dim])
            view.copy_(part, non_blocking=True)
        return out

    def _key(self, shard: int) -> tuple:
        """Shards with equal keys hold the same piece on the same device."""
        coords = self.mesh.coords(shard)
        return (self.mesh.devices[shard],) + tuple(coords[axis] for axis in self.partition)

    # ----------------------------------------------------------- inspection

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def ndim(self) -> int:
        return self.parts[0].ndim

    def local(self, shard: int) -> torch.Tensor:
        return self.parts[shard]

    def __bool__(self) -> bool:
        return bool(self.parts[0])

    def __float__(self) -> float:
        return float(self.parts[0])

    def __repr__(self) -> str:
        return (f"Sharded({self.mesh.shape}, partition={self.partition}, "
                f"local shape {tuple(self.parts[0].shape)}, {self.dtype})")

    # ------------------------------------------------------------ elementwise

    @staticmethod
    def _apply(func, args, kwargs):
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
        parts = []
        for shard in range(mesh.num_shards):
            coords = mesh.coords(shard)
            key = (mesh.devices[shard],) + tuple(coords[axis] for axis in partition)
            if key not in result_of:
                pick = lambda a: a.parts[shard] if isinstance(a, Sharded) else a
                local = func(*[pick(a) for a in args], **{k: pick(v) for k, v in kwargs.items()})
                if not isinstance(local, torch.Tensor):
                    raise NotImplementedError(f"{func} does not return a tensor; it cannot run on a Sharded.")
                result_of[key] = local
            parts.append(result_of[key])
        if partition and parts[0].ndim < -min(partition.values()):
            raise NotImplementedError(f"{func} dropped a partitioned dimension; it cannot run on a Sharded.")
        return Sharded(mesh, parts, partition)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return cls._apply(func, args, kwargs or {})

    @staticmethod
    def per_shard(fn, *operands) -> "Sharded":
        """``fn`` of each shard's locals of the ``Sharded`` operands (other
        operands pass as they are), once per distinct (device, piece)."""
        return Sharded._apply(fn, operands, {})

    def map(self, fn) -> "Sharded":
        """``fn(local) -> local`` on every shard; ``fn`` must keep the partitioned dimensions in place."""
        return Sharded._apply(fn, (self,), {})

    def to(self, dtype: torch.dtype) -> "Sharded":
        return self if dtype == self.dtype else self.map(lambda t: t.to(dtype))

    def new_full(self, size, value) -> "Sharded":
        """A replicated constant of this value's dtype, one tensor per device (``size`` is usually ``()``)."""
        made = {d: torch.full(size, value, dtype=self.dtype, device=d) for d in self.mesh.unique_devices()}
        return Sharded(self.mesh, [made[d] for d in self.mesh.devices])

    def vdot(self, other: "Sharded") -> "Sharded":
        """``<self, other>`` over the whole value, as a replicated scalar.

        One dot per distinct piece, summed in shard order over the
        partitioning axes only: along an axis where the value is replicated
        (``frame``) every shard holds the same piece, and it counts once.
        """
        if other.partition != self.partition or other.mesh is not self.mesh:
            raise ValueError("vdot needs two values sharded the same way.")
        dots, seen = [], set()
        for shard in range(self.mesh.num_shards):
            coords = self.mesh.coords(shard)
            where = tuple(coords[axis] for axis in self.partition)
            if where in seen:
                continue
            seen.add(where)
            dots.append(torch.dot(self.parts[shard].reshape(-1), other.parts[shard].reshape(-1)))
        totals = sum_to_devices(dots, self.mesh.devices)
        return Sharded(self.mesh, [totals[d] for d in self.mesh.devices])

    def _binary(func, reflected=False):  # noqa: N805 - builds the operator methods below
        def method(self, other):
            return Sharded._apply(func, (other, self) if reflected else (self, other), {})
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
        return Sharded._apply(operator.neg, (self,), {})

    def __abs__(self):
        return Sharded._apply(operator.abs, (self,), {})

    def __invert__(self):
        return Sharded._apply(operator.invert, (self,), {})
