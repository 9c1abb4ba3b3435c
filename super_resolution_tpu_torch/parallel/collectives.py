"""What crosses between the shards of a mesh during one objective evaluation.

The port's stand-in for the JAX package's ``lax.psum`` / ``lax.ppermute`` /
``lax.axis_index`` inside ``shard_map``. Every function takes a
:class:`~super_resolution_tpu_torch.parallel.mesh.Mesh` and ``parts``, a list
with one tensor per shard in the mesh's shard order, each on its shard's
device, and returns such a list. One process drives all shards, so a
"collective" is a loop:

- between shards on one device it is slices, concatenations and adds;
- between shards on different devices the piece that crosses is moved with
  ``Tensor.to(device, non_blocking=True)`` on the current streams (PyTorch
  orders a cross-device copy on both devices' streams). No extra streams.

Sums run in shard order, so a result does not depend on timing. What
crosses per evaluation: the ``q``-wide rims of the tiles (:func:`halo_gather`
out, :func:`halo_scatter_sum` back), one band per band shard
(:func:`spectral_halo_extend` / :func:`spectral_halo_return`), the gradient
partials of the frame shards (:func:`psum` over ``frame``) and the 0-d cost
partials.
"""

from __future__ import annotations

import torch

from super_resolution_tpu_torch.parallel.mesh import BAND_AXIS, COL_AXIS, ROW_AXIS, Mesh

__all__ = [
    "sum_to_devices",
    "psum",
    "halo_gather",
    "halo_scatter_sum",
    "spectral_halo_extend",
    "spectral_halo_return",
]


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
    out = [None] * mesh.num_shards
    for group in mesh.groups(axes):
        totals = sum_to_devices([parts[i] for i in group], [mesh.devices[i] for i in group])
        for i in group:
            out[i] = totals[mesh.devices[i]]
    return out


# ------------------------------------------------------------------ spatial halo


def _edge(x: torch.Tensor, q: int, dim: int, leading: bool) -> torch.Tensor:
    edge = x.narrow(dim, 0 if leading else x.shape[dim] - 1, 1)
    return edge.expand(*[q if d == dim % x.ndim else n for d, n in enumerate(x.shape)])


def _exchange_axis(mesh: Mesh, parts, q: int, axis: str, dim: int, border: str):
    """Pad ``dim`` of every shard with ``q`` rows from each neighbour along ``axis``."""
    out = []
    for i, x in enumerate(parts):
        pieces = []
        for step, leading in ((-1, True), (1, False)):
            j = mesh.neighbor(i, axis, step)
            if j is not None:
                # The leading pad is the previous tile's trailing rows, and the other way round.
                src = parts[j]
                piece = _to(src.narrow(dim, src.shape[dim] - q if leading else 0, q), x.device)
            elif border == "edge":
                piece = _edge(x, q, dim, leading)
            else:
                piece = x.new_zeros([q if d == dim % x.ndim else n for d, n in enumerate(x.shape)])
            pieces.append(piece)
        out.append(torch.cat([pieces[0], x, pieces[1]], dim=dim))
    return out


def _check_halo(parts, q: int, border: str) -> None:
    if border not in ("zero", "edge"):
        raise ValueError(f"Unknown border {border!r}; options: 'zero', 'edge'")
    if q < 1:
        raise ValueError(f"The halo must be at least 1 pixel wide, got {q}.")
    for x in parts:
        if q > min(x.shape[-2], x.shape[-1]):
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
    out = []
    for i, g in enumerate(parts):
        size = g.shape[dim]
        center = g.narrow(dim, q, size - 2 * q).clone()
        csize = size - 2 * q
        for step, leading in ((-1, True), (1, False)):
            j = mesh.neighbor(i, axis, step)
            if j is not None:
                # The previous tile's trailing rim overlaps this tile's leading rows.
                src = parts[j]
                rim = _to(src.narrow(dim, src.shape[dim] - q if leading else 0, q), g.device)
                center.narrow(dim, 0 if leading else csize - q, q).add_(rim)
            elif border == "edge":
                rim = g.narrow(dim, 0 if leading else size - q, q).sum(dim=dim, keepdim=True)
                center.narrow(dim, 0 if leading else csize - 1, 1).add_(rim)
        out.append(center)
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
    out = []
    for i, x in enumerate(parts):
        j = mesh.neighbor(i, BAND_AXIS, 1)
        halo = x[-1:] if j is None else _to(parts[j][:1], x.device)
        out.append(torch.cat([x, halo], dim=0))
    return out


def spectral_halo_return(mesh: Mesh, parts) -> list[torch.Tensor]:
    """Drop the halo channel of every extended gradient and add what the
    PREVIOUS band shard's kernel put into its halo channel (the cross-shard
    3D-TV contribution) onto this shard's first band. The last shard's halo
    term is exactly zero by construction and goes nowhere."""
    out = []
    for i, g in enumerate(parts):
        grad = g[:-1]
        j = mesh.neighbor(i, BAND_AXIS, -1)
        if j is not None:
            grad = grad.clone()
            grad[:1].add_(_to(parts[j][-1:], g.device))
        out.append(grad)
    return out
