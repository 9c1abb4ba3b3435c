"""Spatially tiled MAP objective with explicit halo exchange.

For HR images too large for one device, the estimate is tiled over a
(``row``, ``col``) mesh, as in the JAX package's ``parallel/halo.py``. The
degradation stencil (translational warp + PSF blur + decimation) and the
regulariser reach a few pixels past each tile edge, so per evaluation:

- **gather**: every tile takes a ``q``-wide rim of ``x`` from its
  neighbours (rows, then columns of the row-extended tiles, which carries
  the corners); at the image's border the rim is zero, the operators' own
  zero border;
- **kernel**: the fused objective runs on the extended tile in SHARD MODE
  (``ops/cuda/degrade.py``): the tile's origin in the image is
  ``(i * th - q, j * tw - q)``, every border test runs in the image's
  coordinates, the data residual counts only on the LR pixels the tile owns
  (the observations are zero-padded by ``q / s`` to match), and the fused
  TV / BTV constants are zero on the rim, so that each regulariser term is
  counted by exactly one shard and its gradient into a neighbour's pixels
  comes back through the scatter;
- **scatter-sum**: the gradient's rims are added into the tiles that own
  those pixels, the exact adjoint of the gather, in reverse axis order;
- **cost**: the per-tile partials are summed over all shards.

The halo is ``q = roundup_s(max(ceil(max|shift|) + 1 + ksize // 2, reach of
the regulariser, s))``: a multiple of the scale, so that the extended tile's
LR grid is the image's. It comes from the shifts the objective is BUILT
with, read once on the host (the JAX package sized it from a static shift
bound, which the port does not have); a tiled objective therefore takes no
new shifts afterwards. A halo wider than a tile is refused (the exchange is
single-hop). Tiles must be multiples of the scale.

:func:`make_tiled_vg` serves CUDA and CPU shards alike: the port's objective
has one choice, made by where the tensor lives, so the JAX module's traced
twin (``make_tiled_map_value_and_grad``) has no counterpart of its own.
"""

from __future__ import annotations

from typing import Sequence

import torch

from super_resolution_tpu_torch.parallel.collectives import halo_gather, halo_scatter_sum
from super_resolution_tpu_torch.parallel.mesh import COL_AXIS, ROW_AXIS, Mesh
from super_resolution_tpu_torch.parallel.sharded_objective import make_sharded_vg, required_halo

__all__ = ["required_halo", "make_tiled_vg", "halo_gather", "halo_scatter_sum"]


def make_tiled_vg(mesh: Mesh, observations, shifts, blur_kernel, scale: int,
                  regularizers: Sequence[tuple[object, float]] = (), dtype: torch.dtype = torch.float32):
    """The objective tiled over the mesh's ``row`` / ``col`` axes (either may
    be missing), optionally with ``band`` (channel blocks; the data term and
    2D TV / BTV are band-separable, so gradients stay band-local) and
    ``frame`` (each shard its frames and shifts; one more gradient sum).

    Arguments and result as :func:`~.sharded_objective.make_sharded_vg`;
    ``value_and_grad.halo`` is ``q``. Raises for 3D spectral TV, for a halo
    wider than a tile and for tiles that are not multiples of ``scale``.
    """
    if ROW_AXIS not in mesh.shape and COL_AXIS not in mesh.shape:
        raise ValueError("Mesh must have a 'row' or a 'col' axis for spatial tiling.")
    return make_sharded_vg(mesh, observations, shifts, blur_kernel, scale, regularizers, dtype)
