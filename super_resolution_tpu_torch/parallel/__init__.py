"""Solving on a device mesh: band, frame and row/col shards (see ``mesh.py``)."""

from super_resolution_tpu_torch.parallel.halo import make_tiled_vg, required_halo
from super_resolution_tpu_torch.parallel.mesh import (
    BAND_AXIS,
    COL_AXIS,
    FRAME_AXIS,
    ROW_AXIS,
    Mesh,
    make_mesh,
)
from super_resolution_tpu_torch.parallel.sharded import Sharded
from super_resolution_tpu_torch.parallel.sharded_objective import (
    make_band_sharded_solver,
    make_band_sharded_vg,
    make_frame_sharded_vg,
    make_sharded_vg,
)

__all__ = [
    "make_mesh", "Mesh", "Sharded", "FRAME_AXIS", "BAND_AXIS", "ROW_AXIS", "COL_AXIS",
    "make_sharded_vg", "make_band_sharded_vg", "make_frame_sharded_vg", "make_band_sharded_solver",
    "make_tiled_vg", "required_halo",
]
