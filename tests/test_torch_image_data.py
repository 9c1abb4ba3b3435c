"""The port's ImageData and colour conversion against the JAX package's, in
float64 on the CPU, on the same seeded numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from super_resolution_tpu.image import ImageData as JImageData
from super_resolution_tpu.image import SpectralMode as JMode
from super_resolution_tpu.image import bgr_to_ycrcb as j_bgr_to_ycrcb
from super_resolution_tpu.image import ycrcb_to_bgr as j_ycrcb_to_bgr

from super_resolution_tpu_torch import convert
from super_resolution_tpu_torch.image import ImageData, SpectralMode, bgr_to_ycrcb, ycrcb_to_bgr

CPU = dict(device="cpu", dtype=torch.float64)
TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pixels(shape, seed, scale=255.0):
    return np.random.default_rng(seed).random(shape) * scale


def _same(port, jax_array, tol=TOL):
    a = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    b = np.asarray(jax_array)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= tol


def _pair(array, **kw):
    """The same image on both sides."""
    return ImageData(array, **kw, **CPU), JImageData(jnp.asarray(array), **kw)


@pytest.mark.parametrize("direction", ["to_ycrcb", "to_bgr", "round_trip"])
def test_colour_conversion(direction):
    x = _pixels((3, 9, 11), 1, 1.0)
    t = torch.from_numpy(x)
    if direction == "to_ycrcb":
        _same(bgr_to_ycrcb(t), j_bgr_to_ycrcb(jnp.asarray(x)))
    elif direction == "to_bgr":
        _same(ycrcb_to_bgr(t), j_ycrcb_to_bgr(jnp.asarray(x)))
    else:
        _same(ycrcb_to_bgr(bgr_to_ycrcb(t)), x, 1e-3)  # OpenCV's rounded constants
        _same(ycrcb_to_bgr(bgr_to_ycrcb(t)), j_ycrcb_to_bgr(j_bgr_to_ycrcb(jnp.asarray(x))))


@pytest.mark.parametrize("shape,kw", [
    ((7, 9), {}),
    ((7, 9, 3), {}),
    ((5, 7, 9), {"channel_major": True}),
    ((7, 9, 2), {"normalize": "always"}),
    ((7, 9), {"normalize": "never"}),
])
def test_construction_layout_normalisation_and_mode(shape, kw):
    arr = _pixels(shape, 2)
    port, jax_image = _pair(arr, **kw)
    _same(port.hidden_array, jax_image.hidden_array)
    assert port.spectral_mode.name == jax_image.spectral_mode.name
    assert (port.num_channels, port.total_num_channels) == (jax_image.num_channels, jax_image.total_num_channels)
    assert (port.size, port.shape_hw, port.num_pixels) == (jax_image.size, jax_image.shape_hw, jax_image.num_pixels)
    assert port.pixel_value(0, 2, 3) == pytest.approx(jax_image.pixel_value(0, 2, 3), abs=TOL)
    _same(port.channel(0), jax_image.channel(0))
    # Values in [0, 1] are taken as they are; "auto" refuses what is outside [0, 255].
    small = _pixels(shape, 3, 1.0)
    _same(ImageData(small, **kw, **CPU).hidden_array, JImageData(jnp.asarray(small), **kw).hidden_array)
    if kw.get("normalize", "auto") == "auto":
        with pytest.raises(ValueError, match="Invalid pixel range"):
            ImageData(arr + 300.0, **kw, **CPU)
        with pytest.raises(ValueError, match="Invalid pixel range"):
            JImageData(jnp.asarray(arr + 300.0), **kw)


def test_empty_image_channels_and_arithmetic():
    port, jax_image = ImageData(), JImageData()
    assert port.is_empty() and jax_image.is_empty()
    assert (port.num_channels, port.size, port.shape_hw) == (0, (0, 0), (0, 0))
    with pytest.raises(ValueError, match="empty"):
        port.array
    bands = [_pixels((6, 8), 10 + i) for i in range(4)]
    for band in bands:
        port.add_channel(band, **CPU)
        jax_image.add_channel(jnp.asarray(band))
        assert port.spectral_mode.name == jax_image.spectral_mode.name
    _same(port.hidden_array, jax_image.hidden_array)
    with pytest.raises(ValueError, match="Channel size"):
        port.add_channel(np.zeros((5, 8)))
    with pytest.raises(IndexError):
        port.channel(4)
    other, j_other = _pair(_pixels((4, 6, 8), 20, 1.0), channel_major=True)
    _same((port * 0.5).hidden_array, (jax_image * 0.5).hidden_array)
    _same((port / 3.0).hidden_array, (jax_image / 3.0).hidden_array)
    _same((port + other).hidden_array, (jax_image + j_other).hidden_array)
    with pytest.raises(ValueError, match="identical shapes"):
        port + ImageData(np.zeros((3, 6, 8)), channel_major=True, **CPU)


# Additive resizing takes integer ratios only (in the JAX package too).
@pytest.mark.parametrize("method,size", [
    (method, size) for method in ("nearest", "linear", "cubic", "additive") for size in (2.0, 0.5, (13, 5))
    if not (method == "additive" and size == (13, 5))
])
def test_resized(method, size):
    port, jax_image = _pair(_pixels((3, 10, 12), 4, 1.0), channel_major=True)
    out, j_out = port.resized(size, method=method), jax_image.resized(size, method=method)
    _same(out.hidden_array, j_out.hidden_array)
    assert out.spectral_mode.name == j_out.spectral_mode.name
    with pytest.raises(ValueError, match="positive"):
        port.resized(0.0)


@pytest.mark.parametrize("luminance_only", [False, True])
def test_change_color_space_and_luminance_view(luminance_only):
    port, jax_image = _pair(_pixels((9, 11, 3), 5))
    ycc = port.change_color_space(SpectralMode.COLOR_YCRCB, luminance_only=luminance_only)
    j_ycc = jax_image.change_color_space(JMode.COLOR_YCRCB, luminance_only=luminance_only)
    _same(ycc.array, j_ycc.array)
    _same(ycc.hidden_array, j_ycc.hidden_array)
    assert ycc.num_channels == j_ycc.num_channels == (1 if luminance_only else 3)
    assert ycc.total_num_channels == j_ycc.total_num_channels == 3
    back, j_back = ycc.change_color_space(SpectralMode.COLOR_BGR), j_ycc.change_color_space(JMode.COLOR_BGR)
    _same(back.hidden_array, j_back.hidden_array)
    assert back.num_channels == 3
    same, j_same = ycc.change_color_space(SpectralMode.COLOR_YCRCB), j_ycc.change_color_space(JMode.COLOR_YCRCB)
    _same(same.array, j_same.array)
    # Carried across from the JAX side: the same view.
    carried = convert.image_data(np.asarray(j_ycc.hidden_array), j_ycc.spectral_mode.name, luminance_only, **CPU)
    _same(carried.array, j_ycc.array)
    with pytest.raises(ValueError, match="non-color"):
        ImageData(_pixels((5, 6, 7), 6, 1.0), channel_major=True, **CPU).change_color_space(SpectralMode.COLOR_BGR)


def test_interpolate_color_from():
    colour, j_colour = _pair(_pixels((8, 10, 3), 7))
    ycc = colour.change_color_space(SpectralMode.COLOR_YCRCB, luminance_only=True)
    j_ycc = j_colour.change_color_space(JMode.COLOR_YCRCB, luminance_only=True)
    luminance = _pixels((1, 16, 20), 8, 1.0)  # a super-resolved luminance channel
    port = ImageData(luminance, normalize="never", channel_major=True, **CPU)
    jax_image = JImageData(jnp.asarray(luminance), normalize="never", channel_major=True)
    out, j_out = port.interpolate_color_from(ycc), jax_image.interpolate_color_from(j_ycc)
    _same(out.hidden_array, j_out.hidden_array)
    assert out.spectral_mode == SpectralMode.COLOR_YCRCB and out.num_channels == 3
    _same(out.change_color_space(SpectralMode.COLOR_BGR).hidden_array,
          j_out.change_color_space(JMode.COLOR_BGR).hidden_array)
    with pytest.raises(ValueError, match="single-channel"):
        colour.interpolate_color_from(ycc)


@pytest.mark.parametrize("shape,mode", [
    ((1, 9, 11), None), ((2, 9, 11), None), ((3, 9, 11), None), ((3, 9, 11), "COLOR_YCRCB"), ((7, 9, 11), None),
])
def test_visualization_image_is_exact(shape, mode):
    # Out of range and exactly-representable values: the clip, the truncation
    # and the channel choice (0, n // 2, n - 1) all show.
    arr = _pixels(shape, 9, 1.4) - 0.2
    arr.reshape(-1)[:4] = [0.2, 1.0 / 255.0, 0.5, 1.0]
    kw = dict(normalize="never", channel_major=True)
    if mode is not None:
        kw["spectral_mode"] = SpectralMode[mode]
    port = ImageData(arr, **kw, **CPU)
    jax_image = JImageData(jnp.asarray(arr), **{**kw, "spectral_mode": None if mode is None else JMode[mode]})
    vis, j_vis = port.visualization_image(), jax_image.visualization_image()
    assert vis.dtype == j_vis.dtype == np.uint8 and vis.shape == j_vis.shape
    np.testing.assert_array_equal(vis, j_vis)


def test_report_fields_equal(capsys):
    arr = _pixels((4, 6, 7), 11, 1.6) - 0.3
    port = ImageData(arr, normalize="never", channel_major=True, **CPU)
    jax_image = JImageData(jnp.asarray(arr), normalize="never", channel_major=True)
    report, j_report = port.report(), jax_image.report()
    assert vars(report) == vars(j_report)
    report.print()
    port_out = capsys.readouterr().out
    j_report.print()
    assert port_out == capsys.readouterr().out


def test_placement():
    arr = _pixels((5, 6, 3), 12)
    default = ImageData(arr, device="cpu")
    assert default.dtype == torch.float32 and default.device.type == "cpu"
    t = torch.from_numpy(arr).to(torch.float64)
    kept = ImageData(t)  # a tensor stays on its device, in its floating dtype
    assert kept.dtype == torch.float64 and kept.device.type == "cpu"
    as_float = ImageData(torch.from_numpy(arr.astype(np.uint8)))
    assert as_float.dtype == torch.float32
    np.testing.assert_allclose(as_float.hidden_array.numpy(), ImageData(arr.astype(np.uint8), device="cpu").hidden_array.numpy())
    assert ImageData(kept).hidden_array is kept.hidden_array
