"""What crosses between the shards of a mesh during one objective evaluation.

The port's stand-in for the JAX package's ``lax.psum`` / ``lax.ppermute`` /
``lax.axis_index`` inside ``shard_map``. Every function takes a
:class:`~super_resolution_tpu_torch.parallel.mesh.Mesh` and ``parts``, a list
with one tensor per shard in the mesh's shard order, each on its shard's
device (``None`` for a shard of another process), and returns such a list.
A process drives its own shards, so within it a "collective" is a loop:

- between shards on one device it is slices, concatenations and adds;
- between shards on different devices the piece that crosses is moved with
  ``Tensor.to(device, non_blocking=True)`` on the current streams (PyTorch
  orders a cross-device copy on both devices' streams). No extra streams.

Between processes (a mesh that spans several, see ``parallel/mesh.py``):

- a sum is first taken over the process's own members of each group, then
  one ``torch.distributed`` all-reduce of one flat buffer carries every
  group that has members in more than one process (:func:`psum_together`);
- a rim or a band whose neighbour lies in another process crosses point to
  point: each process posts what its shards owe the other processes' shards
  and takes what its own need, in one batched exchange
  (:func:`distributed.exchange`) per axis of :func:`halo_gather` and of
  :func:`halo_scatter_sum`, and per direction of the spectral ring. The
  pieces are copies, and the adds run in the one-process order, so these
  results are the one-process ones bit for bit.

Sums run in shard order, so a result does not depend on timing. What
crosses per evaluation: the ``q``-wide rims of the tiles (:func:`halo_gather`
out, :func:`halo_scatter_sum` back), one band per band shard
(:func:`spectral_halo_extend` / :func:`spectral_halo_return`), the gradient
partials of the frame shards (:func:`psum` over ``frame``) and the 0-d cost
partials. :data:`counts` counts the calls: ``psum`` every sum over shards
(one per evaluation of a sharded objective, however many shards),
``all_reduce`` and ``all_reduce_bytes`` the all-reduces between processes
and their buffers' bytes (the port's counterpart of the all-reduces the JAX
package's compiled program holds; ``Sharded.vdot`` makes them too),
``exchange`` and ``exchange_bytes`` the point-to-point exchanges this
process made and the bytes it sent in them.
"""

from __future__ import annotations

import torch

from super_resolution_tpu_torch.parallel import distributed
from super_resolution_tpu_torch.parallel.mesh import BAND_AXIS, COL_AXIS, ROW_AXIS, Mesh

__all__ = [
    "counts",
    "reset_counts",
    "all_reduce",
    "sum_to_devices",
    "psum",
    "psum_together",
    "halo_gather",
    "halo_scatter_sum",
    "spectral_halo_extend",
    "spectral_halo_return",
]

# Calls since the module was imported (see the module's docstring).
counts: dict[str, int] = {"psum": 0, "all_reduce": 0, "all_reduce_bytes": 0, "exchange": 0, "exchange_bytes": 0}


def reset_counts() -> None:
    for name in counts:
        counts[name] = 0


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device, non_blocking=True)


def sum_to_devices(values, devices) -> dict[torch.device, torch.Tensor]:
    """Sum ``values`` (tensors of one shape, on any devices) in the order given,
    on the first one's device, and hand the total to each of ``devices``."""
    home = values[0].device
    total = values[0]
    for v in values[1:]:
        total = total + _to(v, home)
    return {device: _to(total, device) for device in dict.fromkeys(devices)}


def psum(mesh: Mesh, parts, axes) -> list[torch.Tensor]:
    """Per shard, the sum over the shards that differ from it only along ``axes``.

    Members of a group that share a device get the same tensor object; treat
    the results as read-only.
    """
    return psum_together(mesh, [(parts, axes)])[0]


def all_reduce(buffer: torch.Tensor) -> None:
    """Sum ``buffer`` over the processes in place, counted in :data:`counts`."""
    distributed.all_reduce_sum(buffer)
    counts["all_reduce"] += 1
    counts["all_reduce_bytes"] += buffer.numel() * buffer.element_size()


def psum_together(mesh: Mesh, values) -> list[list[torch.Tensor]]:
    """:func:`psum` of several values at once: ``values`` is a list of
    ``(parts, axes)``, the result one list of per-shard sums for each.

    Each group is summed over this process's members in shard order. Where
    groups have members in more than one process, the local sums of every
    such group of every value then cross in ONE all-reduce of one flat
    buffer (the first local shard's device and dtype), laid out alike in
    every process: a process with no member in a group posts zeros there. A
    crossing sum is then the processes' local sums added by the backend,
    not the shards' in shard order. A group wholly in one process never
    crosses. Counts one ``psum`` per call.
    """
    counts["psum"] += 1
    grouped = [(parts, mesh.groups(axes)) for parts, axes in values]
    sums = []
    for parts, groups in grouped:
        group_sums = []
        for group in groups:
            members = [i for i in group if mesh.is_local(i)]
            home = mesh.devices[members[0]] if members else None
            group_sums.append(sum_to_devices([parts[i] for i in members], [home])[home] if members else None)
        sums.append(group_sums)
    crossing = [(v, g) for v, (_, groups) in enumerate(grouped) for g, group in enumerate(groups)
                if mesh.crosses_processes(group)]
    if crossing:
        home = mesh.devices[mesh.local_shards[0]]
        like = [parts[mesh.local_shards[0]] for parts, _ in grouped]  # each value's shape and dtype
        pieces = [like[v].new_zeros(like[v].shape) if sums[v][g] is None else sums[v][g] for v, g in crossing]
        buffer = torch.cat([_to(p, home).to(like[0].dtype).reshape(-1) for p in pieces])
        all_reduce(buffer)
        for (v, g), total in zip(crossing, torch.split(buffer, [p.numel() for p in pieces])):
            sums[v][g] = total.reshape(like[v].shape).to(like[v].dtype)
    out = []
    for (parts, groups), group_sums in zip(grouped, sums):
        result = [None] * mesh.num_shards
        for group, total in zip(groups, group_sums):
            members = [i for i in group if mesh.is_local(i)]
            if members:
                placed = sum_to_devices([total], [mesh.devices[i] for i in members])
                for i in members:
                    result[i] = placed[mesh.devices[i]]
        out.append(result)
    return out


def _slab(x: torch.Tensor, dim: int, width: int, step: int) -> torch.Tensor:
    """The ``width``-wide slab of ``x`` along ``dim`` that touches the shard
    whose neighbour at ``step`` ``x`` is: its trailing slab for ``step`` -1
    (``x`` comes before), its leading one for +1."""
    return x.narrow(dim, x.shape[dim] - width if step < 0 else 0, width)


def _neighbour_slabs(mesh: Mesh, parts, axis: str, dim: int, width: int, steps) -> dict:
    """``{(i, step): slab}`` for every local shard ``i`` and ``step`` of
    ``steps`` that has a neighbour ``j`` along ``axis``: :func:`_slab` of
    ``parts[j]``, on ``i``'s device. A neighbour in another process sends it
    in one :func:`distributed.exchange`, in which this process also sends
    what its own shards owe the shards of other processes; message tags are
    ``2 * receiving shard + (step > 0)``."""
    slabs, sends, receives = {}, [], []
    for i in mesh.local_shards:
        for step in steps:
            j = mesh.neighbor(i, axis, step)
            if j is not None and mesh.is_local(j):
                slabs[(i, step)] = _to(_slab(parts[j], dim, width, step), parts[i].device)
            elif j is not None:
                shape = list(parts[i].shape)
                shape[dim] = width
                slabs[(i, step)] = parts[i].new_empty(shape)
                receives.append((mesh.processes[j], 2 * i + (step > 0), slabs[(i, step)]))
            # The shard whose neighbour at `step` shard i is.
            k = mesh.neighbor(i, axis, -step)
            if k is not None and not mesh.is_local(k):
                sends.append((mesh.processes[k], 2 * k + (step > 0), _slab(parts[i], dim, width, step)))
    if sends or receives:
        distributed.exchange(sends, receives)
        counts["exchange"] += 1
        counts["exchange_bytes"] += sum(t.numel() * t.element_size() for _, _, t in sends)
    return slabs


# ------------------------------------------------------------------ spatial halo


def _edge(x: torch.Tensor, q: int, dim: int, leading: bool) -> torch.Tensor:
    edge = x.narrow(dim, 0 if leading else x.shape[dim] - 1, 1)
    return edge.expand(*[q if d == dim % x.ndim else n for d, n in enumerate(x.shape)])


def _exchange_axis(mesh: Mesh, parts, q: int, axis: str, dim: int, border: str):
    """Pad ``dim`` of every shard with ``q`` rows from each neighbour along ``axis``."""
    # The leading pad is the previous tile's trailing rows, and the other way round.
    rims = _neighbour_slabs(mesh, parts, axis, dim, q, (-1, 1))
    out = [None] * len(parts)
    for i in mesh.local_shards:
        x = parts[i]
        pieces = []
        for step, leading in ((-1, True), (1, False)):
            if (i, step) in rims:
                piece = rims[(i, step)]
            elif border == "edge":
                piece = _edge(x, q, dim, leading)
            else:
                piece = x.new_zeros([q if d == dim % x.ndim else n for d, n in enumerate(x.shape)])
            pieces.append(piece)
        out[i] = torch.cat([pieces[0], x, pieces[1]], dim=dim)
    return out


def _check_halo(parts, q: int, border: str) -> None:
    if border not in ("zero", "edge"):
        raise ValueError(f"Unknown border {border!r}; options: 'zero', 'edge'")
    if q < 1:
        raise ValueError(f"The halo must be at least 1 pixel wide, got {q}.")
    for x in parts:
        if x is not None and q > min(x.shape[-2], x.shape[-1]):
            raise ValueError(
                f"Stencil halo ({q}) exceeds the local tile size ({x.shape[-2]}x{x.shape[-1]}); "
                "use fewer tiles or a larger image (single-hop halo exchange)."
            )


def halo_gather(mesh: Mesh, parts, q: int, border: str = "zero") -> list[torch.Tensor]:
    """Every tile ``[..., th, tw]`` grown to ``[..., th + 2q, tw + 2q]`` by its
    neighbours' rims along ``row`` and ``col``: rows first, then columns of
    the row-extended tiles, so the corners ride along.

    At the image's border the rim is zero (``"zero"``: the operators' zero
    border) or repeats the edge pixel (``"edge"``: forward differences vanish
    there, the TV truncation rule).
    """
    _check_halo(parts, q, border)
    parts = _exchange_axis(mesh, parts, q, ROW_AXIS, -2, border)
    return _exchange_axis(mesh, parts, q, COL_AXIS, -1, border)


def _scatter_axis(mesh: Mesh, parts, q: int, axis: str, dim: int, border: str):
    """Adjoint of :func:`_exchange_axis`: crop the centre and add the rims into
    the neighbours that own them (or, with ``"edge"``, into the edge row that
    was repeated)."""
    # The previous tile's trailing rim overlaps this tile's leading rows.
    rims = _neighbour_slabs(mesh, parts, axis, dim, q, (-1, 1))
    out = [None] * len(parts)
    for i in mesh.local_shards:
        g = parts[i]
        size = g.shape[dim]
        center = g.narrow(dim, q, size - 2 * q).clone()
        csize = size - 2 * q
        for step, leading in ((-1, True), (1, False)):
            if (i, step) in rims:
                center.narrow(dim, 0 if leading else csize - q, q).add_(rims[(i, step)])
            elif border == "edge":
                rim = g.narrow(dim, 0 if leading else size - q, q).sum(dim=dim, keepdim=True)
                center.narrow(dim, 0 if leading else csize - 1, 1).add_(rim)
        out[i] = center
    return out


def halo_scatter_sum(mesh: Mesh, parts, q: int, border: str = "zero") -> list[torch.Tensor]:
    """Exact adjoint of :func:`halo_gather` with the same ``border`` (reverse
    axis order): ``[..., th + 2q, tw + 2q]`` back to ``[..., th, tw]``, every
    rim added into the tile that owns those pixels. A rim beyond the image's
    border is dropped (``"zero"``) or folded onto the edge pixel (``"edge"``)."""
    if border not in ("zero", "edge"):
        raise ValueError(f"Unknown border {border!r}; options: 'zero', 'edge'")
    parts = _scatter_axis(mesh, parts, q, COL_AXIS, -1, border)
    return _scatter_axis(mesh, parts, q, ROW_AXIS, -2, border)


# ----------------------------------------------------------------- spectral halo


def spectral_halo_extend(mesh: Mesh, parts) -> list[torch.Tensor]:
    """Append the one-band spectral halo for 3D TV over a band-sharded stack.

    Band shard ``b`` gets shard ``b + 1``'s FIRST band as an extra last
    channel; the shard holding the last band of all duplicates its own last
    band instead, so that ``dz == 0`` there: the reference's zero forward
    difference at the final band.
    """
    halos = _neighbour_slabs(mesh, parts, BAND_AXIS, 0, 1, (1,))
    out = [None] * len(parts)
    for i in mesh.local_shards:
        x = parts[i]
        out[i] = torch.cat([x, halos.get((i, 1), x[-1:])], dim=0)
    return out


def spectral_halo_return(mesh: Mesh, parts) -> list[torch.Tensor]:
    """Drop the halo channel of every extended gradient and add what the
    PREVIOUS band shard's kernel put into its halo channel (the cross-shard
    3D-TV contribution) onto this shard's first band. The last shard's halo
    term is exactly zero by construction and goes nowhere."""
    halos = _neighbour_slabs(mesh, parts, BAND_AXIS, 0, 1, (-1,))
    out = [None] * len(parts)
    for i in mesh.local_shards:
        grad = parts[i][:-1]
        if (i, -1) in halos:
            grad = grad.clone()
            grad[:1].add_(halos[(i, -1)])
        out[i] = grad
    return out
