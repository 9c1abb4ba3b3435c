"""The port's GIF reader against the JAX loader (OpenCV's GIF decoder) on
the same bytes: files built by hand (global and local colour tables,
interlaced frames, a frame smaller than the screen, a transparent index, a
second frame, tables of 2 to 256 colours, long runs and table resets) and
files ``cv2.imwrite`` writes (BGR and BGRA). ``read_image`` is array-equal to
``cv2.imread(..., IMREAD_UNCHANGED)``, the port's ``load_image`` to the JAX
one. Writing GIF raises ``NotImplementedError`` naming GIF."""

import cv2
import numpy as np
import pytest
import torch

from super_resolution_tpu.utils.data_loader import load_image as j_load_image

from super_resolution_tpu_torch.utils import image_io
from super_resolution_tpu_torch.utils.data_loader import load_image
from super_resolution_tpu_torch.utils.gif import read_gif
from torch_format_builders import gif_bytes

CPU = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _same(tmp_path, data):
    ours = read_gif(data)
    theirs = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    assert theirs is not None and ours.shape == theirs.shape and ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)
    path = str(tmp_path / "image.gif")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(load_image(path, **CPU).hidden_array.numpy(),
                                  np.asarray(j_load_image(path).hidden_array))
    return ours


CASES = {
    "plain": dict(),
    "interlaced": dict(interlaced=True),
    "transparent": dict(transparent=3),
    "local_table": dict(local=True),
    "sub_frame": dict(screen=(30, 21), origin=(5, 3), background=6),
    "sub_frame_interlaced_transparent": dict(screen=(30, 21), origin=(2, 4), interlaced=True, transparent=1,
                                             background=2),
    "local_table_sub_frame_transparent": dict(local=True, screen=(25, 19), origin=(1, 2), transparent=0),
    "background_is_transparent": dict(screen=(26, 20), origin=(3, 3), transparent=4, background=4),
    "two_frames": dict(frames=True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_read_as_the_jax_loader(tmp_path, name):
    case = dict(CASES[name])
    rng = np.random.default_rng(len(name))
    palette = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    indices = rng.integers(0, 16, (13, 19)).astype(np.uint8)
    local = case.pop("local", False)
    if case.pop("frames", False):
        case["frames"] = [(rng.integers(0, 16, (13, 19)), (0, 0))]
    _same(tmp_path, gif_bytes(indices, None if local else palette, local_palette=palette if local else None, **case))


@pytest.mark.parametrize("colours", [2, 4, 256])
@pytest.mark.parametrize("hw", [(1, 1), (7, 9), (120, 170)])
def test_table_sizes_and_lzw(tmp_path, hw, colours):
    rng = np.random.default_rng(colours + hw[0])
    palette = rng.integers(0, 256, (colours, 3)).astype(np.uint8)
    indices = rng.integers(0, colours, hw).astype(np.uint8)
    indices[: hw[0] // 2] = indices[: hw[0] // 2, :1]  # long runs on top, noise below
    _same(tmp_path, gif_bytes(indices, palette, interlaced=hw[0] > 1))


@pytest.mark.parametrize("channels", [3, 4])
def test_files_opencv_writes(tmp_path, channels):
    rng = np.random.default_rng(channels)
    image = rng.integers(0, 256, (37, 53, channels)).astype(np.uint8)
    if channels == 4:
        image[..., 3] = rng.integers(0, 2, (37, 53)) * 255
    out = _same(tmp_path, cv2.imencode(".gif", image)[1].tobytes())
    assert out.shape[2] == channels


def test_writing_gif_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="GIF"):
        image_io.write_image(str(tmp_path / "out.gif"), np.zeros((4, 4, 3), np.uint8))


def test_corrupt_data_raises():
    palette = np.arange(12, dtype=np.uint8).reshape(4, 3)
    good = gif_bytes(np.zeros((8, 8), np.uint8), palette)
    with pytest.raises(ValueError, match="Not a GIF"):
        read_gif(b"GIF90a" + good[6:])
    with pytest.raises(ValueError):
        read_gif(good[:30])
    with pytest.raises(ValueError, match="background index"):
        read_gif(good[:11] + b"\x09" + good[12:])
