"""ImageData — the N-channel image container (equivalent of
``src/image/image_data.{h,cpp}``).

A thin host-level wrapper over one channel-major ``[C, H, W]`` tensor plus
spectral-mode metadata. The pixel payload is one dense tensor, so it moves to
the device in one transfer and feeds the solvers directly (``.array``). The
channel-major layout matches the reference's canonical ``GetPixelIndex``
flattening (``src/util/util.cpp:81-89``):
``index = channel * H * W + row * W + col``.

Placement is explicit. A tensor that is passed in stays on its device (and
keeps a floating dtype); a numpy array goes to ``device``, which defaults to
``"cuda"`` as every entry point of the port does, in ``dtype`` (default
float32). Nothing here falls back to the CPU.

Semantics replicated from the reference:

- Normalization on ingest: values are divided by 255 when the max exceeds 1
  under NORMALIZE mode (``image_data.cpp:282-291``); the checked constructor
  rejects values outside [0, 255] (``image_data.cpp:218-235``). The check
  reads the max (and min) back to the host once, when the image is made;
  images made inside a solve pass ``normalize="never"`` and read nothing.
- Spectral mode auto-detection: 3 channels -> BGR color, >3 -> hyperspectral
  (``image_data.cpp:36-44``).
- Luminance-only YCrCb: ``num_channels`` reports 1 and the chroma channels are
  hidden until conversion back to BGR, which bilinearly interpolates them to
  the (possibly super-resolved) luminance size (``image_data.cpp:144-168,
  404-406, 490-495``).
- The four resize modes (see :mod:`super_resolution_tpu_torch.ops.resize`).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from super_resolution_tpu_torch._device import resolve_device
from super_resolution_tpu_torch.image.color import bgr_to_ycrcb, ycrcb_to_bgr
from super_resolution_tpu_torch.ops.resize import linear_resize as _linear_resize
from super_resolution_tpu_torch.ops.resize import resize as _resize

__all__ = ["ImageData", "SpectralMode", "ImageDataReport"]


class SpectralMode(enum.Enum):
    """Mirror of ``ImageSpectralMode`` (``src/image/image_data.h:73-83``)."""

    NONE = "none"
    HYPERSPECTRAL = "hyperspectral"
    HYPERSPECTRAL_PCA = "hyperspectral_pca"
    COLOR_BGR = "color_bgr"
    COLOR_YCRCB = "color_ycrcb"

    @property
    def is_color(self) -> bool:
        return self in (SpectralMode.COLOR_BGR, SpectralMode.COLOR_YCRCB)

    @property
    def is_hyperspectral(self) -> bool:
        return self in (SpectralMode.HYPERSPECTRAL, SpectralMode.HYPERSPECTRAL_PCA)


def _default_spectral_mode(num_channels: int) -> SpectralMode:
    if num_channels == 3:
        return SpectralMode.COLOR_BGR
    if num_channels > 3:
        return SpectralMode.HYPERSPECTRAL
    return SpectralMode.NONE


class ImageDataReport:
    """Image statistics (``src/image/image_data.h:87-107``), read on the host."""

    def __init__(self, image: "ImageData"):
        arr = image.hidden_array.detach().cpu().numpy()
        self.image_size = image.size  # (width, height)
        self.num_channels = arr.shape[0]
        neg = arr < 0.0
        over = arr > 1.0
        self.num_negative_pixels = int(neg.sum())
        self.num_over_one_pixels = int(over.sum())
        neg_per_channel = neg.reshape(arr.shape[0], -1).sum(axis=1)
        over_per_channel = over.reshape(arr.shape[0], -1).sum(axis=1)
        self.channel_with_most_negative_pixels = int(neg_per_channel.argmax())
        self.max_num_negative_pixels_in_one_channel = int(neg_per_channel.max())
        self.channel_with_most_over_one_pixels = int(over_per_channel.argmax())
        self.max_num_over_one_pixels_in_one_channel = int(over_per_channel.max())
        # Reference initializes extremes to [1, 0] so they only tighten outward
        # (``image_data.cpp:581-583``).
        self.smallest_pixel_value = float(min(arr.min(), 1.0))
        self.largest_pixel_value = float(max(arr.max(), 0.0))

    def print(self) -> None:
        n = self.image_size[0] * self.image_size[1] * self.num_channels
        print(
            f"Image Statistics: {self.image_size[0]} x {self.image_size[1]} "
            f"x {self.num_channels} ({n} pixels)"
        )
        print(f"  Num negative pixels: {self.num_negative_pixels}")
        print(f"  Num over one pixels: {self.num_over_one_pixels}")
        print(f"  Minimum pixel value: {self.smallest_pixel_value}")
        print(f"  Maximum pixel value: {self.largest_pixel_value}")


def _placed(array, device, dtype) -> torch.Tensor:
    """``array`` as a floating tensor: a tensor stays where it is unless
    ``device`` / ``dtype`` are given; a numpy array goes to ``device``
    (default ``"cuda"``) as ``dtype`` (default float32)."""
    if isinstance(array, torch.Tensor):
        t = array
        if dtype is None and not t.is_floating_point():
            dtype = torch.float32
        return t.to(device=t.device if device is None else resolve_device(device), dtype=dtype or t.dtype)
    dev = resolve_device("cuda" if device is None else device)
    t = torch.tensor(np.asarray(array))  # a copy: the input may be read-only
    return t.to(device=dev, dtype=dtype or torch.float32)


class ImageData:
    """N-channel float image over a ``[C, H, W]`` tensor.

    Constructors accept ``[H, W]``, ``[H, W, C]`` (OpenCV layout) or
    ``[C, H, W]`` (pass ``channel_major=True``) arrays or tensors.
    ``normalize`` mirrors the reference's three ingest behaviors:

    - ``"auto"``  — checked range [0, 255], divide by 255 iff max > 1
      (default ctor, ``image_data.cpp:218-235``)
    - ``"always"``— NORMALIZE_IMAGE: divide by 255 iff max > 1
    - ``"never"`` — DO_NOT_NORMALIZE_IMAGE: values taken as-is

    ``device`` / ``dtype``: see the module docstring.
    """

    def __init__(
        self,
        array=None,
        normalize: str = "auto",
        channel_major: bool = False,
        spectral_mode: SpectralMode | None = None,
        _luminance_only: bool = False,
        device=None,
        dtype: torch.dtype | None = None,
    ):
        self._luminance_only = _luminance_only
        if array is None:
            self._array = None
            self._mode = SpectralMode.NONE
            return
        if isinstance(array, ImageData):
            self._array = array.hidden_array
            self._mode = array.spectral_mode
            self._luminance_only = array._luminance_only
            return
        arr = _placed(array, device, dtype)
        if arr.ndim == 2:
            arr = arr[None]
        elif arr.ndim == 3 and not channel_major:
            arr = torch.movedim(arr, -1, 0)
        elif arr.ndim != 3:
            raise ValueError(f"Expected 2D or 3D image array, got shape {tuple(arr.shape)}")
        self._array = _apply_normalization(arr.contiguous(), normalize)
        self._mode = spectral_mode or _default_spectral_mode(arr.shape[0])

    # ---------------------------------------------------------------- basics

    @property
    def array(self) -> torch.Tensor:
        """Visible channels as ``[C, H, W]`` (luminance-only hides chroma)."""
        if self._array is None:
            raise ValueError("Image is empty.")
        if self._is_luminance_view():
            return self._array[:1]
        return self._array

    @property
    def hidden_array(self) -> torch.Tensor:
        """All channels, including hidden chroma."""
        if self._array is None:
            raise ValueError("Image is empty.")
        return self._array

    @property
    def device(self) -> torch.device:
        return self.hidden_array.device

    @property
    def dtype(self) -> torch.dtype:
        return self.hidden_array.dtype

    @property
    def spectral_mode(self) -> SpectralMode:
        return self._mode

    def set_spectral_mode(self, mode: SpectralMode) -> None:
        self._mode = mode

    def _is_luminance_view(self) -> bool:
        return self._mode == SpectralMode.COLOR_YCRCB and self._luminance_only

    @property
    def num_channels(self) -> int:
        """Visible channel count; 1 for luminance-only YCrCb (``image_data.cpp:490-495``)."""
        if self._array is None:
            return 0
        return 1 if self._is_luminance_view() else self._array.shape[0]

    @property
    def total_num_channels(self) -> int:
        return 0 if self._array is None else self._array.shape[0]

    @property
    def size(self) -> tuple[int, int]:
        """(width, height), matching the reference's cv::Size convention."""
        if self._array is None:
            return (0, 0)
        return (self._array.shape[2], self._array.shape[1])

    @property
    def shape_hw(self) -> tuple[int, int]:
        if self._array is None:
            return (0, 0)
        return (self._array.shape[1], self._array.shape[2])

    @property
    def num_pixels(self) -> int:
        w, h = self.size
        return w * h

    def is_empty(self) -> bool:
        return self._array is None

    # -------------------------------------------------------------- channels

    def add_channel(self, channel, normalize: str = "always", device=None, dtype=None) -> None:
        """Append a ``[H, W]`` channel (``image_data.cpp:267-296``); it joins
        the image's device and dtype (an empty image places it as the
        constructor does)."""
        if self._array is not None:
            device, dtype = self._array.device, self._array.dtype
        ch = _placed(channel, device, dtype)
        if ch.ndim != 2:
            raise ValueError("add_channel expects a single [H, W] band.")
        ch = _apply_normalization(ch[None], normalize)
        if self._array is None:
            self._array = ch
        else:
            if ch.shape[1:] != self._array.shape[1:]:
                raise ValueError(
                    f"Channel size {tuple(ch.shape[1:])} != image size {tuple(self._array.shape[1:])}"
                )
            self._array = torch.cat([self._array, ch], dim=0)
        self._mode = _default_spectral_mode(self._array.shape[0])

    def channel(self, index: int) -> torch.Tensor:
        if not 0 <= index < self.num_channels:
            raise IndexError("Channel index out of bounds.")
        return self.array[index]

    def pixel_value(self, channel: int, row: int, col: int) -> float:
        return float(self.channel(channel)[row, col])

    # ---------------------------------------------------------------- resize

    def resized(self, new_size, method: str = "nearest") -> "ImageData":
        """Return a resized copy. ``new_size`` is (width, height) or a scalar scale.

        All channels (including hidden chroma) resize together, mirroring
        ``image_data.cpp:310-364``.
        """
        if self._array is None:
            raise ValueError("Cannot resize an empty image.")
        if isinstance(new_size, (int, float)):
            if new_size <= 0:
                raise ValueError("Scale factor must be positive.")
            w, h = self.size
            new_size = (int(w * new_size), int(h * new_size))
        w, h = int(new_size[0]), int(new_size[1])
        if w <= 0 or h <= 0:
            raise ValueError("Images must have a positive size.")
        return self._with_array(_resize(self._array, (h, w), method=method))

    # ----------------------------------------------------------------- color

    def change_color_space(self, new_mode: SpectralMode, luminance_only: bool = False) -> "ImageData":
        """BGR <-> YCrCb conversion (``image_data.cpp:366-425``). Returns a copy."""
        if not self._mode.is_color:
            raise ValueError("Cannot convert a non-color image to another color space.")
        if not new_mode.is_color:
            raise ValueError("new_mode must be a color mode.")
        if new_mode == self._mode:
            return ImageData(self)
        arr = self._array
        if self._mode == SpectralMode.COLOR_BGR and new_mode == SpectralMode.COLOR_YCRCB:
            return ImageData(
                bgr_to_ycrcb(arr), normalize="never", channel_major=True,
                spectral_mode=new_mode, _luminance_only=luminance_only,
            )
        if self._mode == SpectralMode.COLOR_YCRCB and new_mode == SpectralMode.COLOR_BGR:
            if self._luminance_only:
                arr = _interpolate_color(arr, tuple(arr[0].shape))
            return ImageData(
                ycrcb_to_bgr(arr), normalize="never", channel_major=True, spectral_mode=new_mode,
            )
        raise ValueError(f"Unsupported color conversion {self._mode} -> {new_mode}.")

    def interpolate_color_from(self, color_image: "ImageData") -> "ImageData":
        """Adopt interpolated chroma from ``color_image`` (``image_data.cpp:453-463``).

        ``self`` must expose a single (luminance) channel; the two color
        channels of ``color_image`` are bilinearly resized to this image's
        size. Returns a new 3-channel image in ``color_image``'s color space.
        """
        if self.num_channels != 1:
            raise ValueError("Color can only be interpolated into single-channel images.")
        if color_image.total_num_channels != 3:
            raise ValueError("The color image must have 3 channels.")
        lum = self.array[0]
        chroma = _interpolate_color(color_image.hidden_array, tuple(lum.shape))[1:]
        arr = torch.cat([lum[None], chroma.to(device=lum.device, dtype=lum.dtype)], dim=0)
        return ImageData(arr, normalize="never", channel_major=True, spectral_mode=color_image.spectral_mode)

    # ------------------------------------------------------------ arithmetic

    def _with_array(self, arr) -> "ImageData":
        out = ImageData()
        out._array = arr
        out._mode = self._mode
        out._luminance_only = self._luminance_only
        return out

    def __mul__(self, scalar: float) -> "ImageData":
        return self._with_array(self.hidden_array * scalar)

    def __truediv__(self, scalar: float) -> "ImageData":
        return self._with_array(self.hidden_array * (1.0 / scalar))

    def __add__(self, other: "ImageData") -> "ImageData":
        if other.hidden_array.shape != self.hidden_array.shape:
            raise ValueError("Images must have identical shapes to be added.")
        return self._with_array(self.hidden_array + other.hidden_array)

    # --------------------------------------------------------- visualization

    def visualization_image(self) -> np.ndarray:
        """uint8 HxW or HxWx3 (BGR) image for display/save (``image_data.cpp:539-574``).

        Values are clipped to [0, 1] and scaled by 255 with truncation, not
        rounding; of more than three channels, 0, n // 2 and n - 1 are shown
        as B, G and R.
        """
        if self._array is None:
            raise ValueError("Image is empty.")
        arr = self._array
        n = arr.shape[0]
        if n < 3:
            mono = np.clip(arr[0].detach().cpu().numpy(), 0.0, 1.0)
            return (mono * 255).astype(np.uint8)
        if self._mode == SpectralMode.COLOR_YCRCB:
            return self.change_color_space(SpectralMode.COLOR_BGR).visualization_image()
        bgr = torch.stack([arr[0], arr[n // 2], arr[n - 1]])
        img = np.clip(torch.movedim(bgr, 0, -1).detach().cpu().numpy(), 0.0, 1.0)
        return (img * 255).astype(np.uint8)

    def report(self) -> ImageDataReport:
        return ImageDataReport(self)


def _apply_normalization(arr: torch.Tensor, normalize: str) -> torch.Tensor:
    if normalize not in ("auto", "always", "never"):
        raise ValueError(f"Unknown normalize mode {normalize!r}")
    if normalize == "never":
        return arr
    if arr.numel():
        max_val, min_val = torch.stack([arr.max(), arr.min()]).tolist()  # one read-back
    else:
        max_val = min_val = 0.0
    if normalize == "auto" and (min_val < 0 or max_val > 255):
        raise ValueError(
            "Invalid pixel range: auto-normalization requires values in "
            "[0, 255]. Use normalize='never' for arbitrary values."
        )
    if max_val > 1.0:
        # A divisor on the tensor's device: CUDA turns division by a host
        # scalar into a product with its reciprocal, which is not the CPU's
        # (or the JAX package's) correctly rounded quotient.
        arr = arr / torch.tensor(255.0, dtype=arr.dtype, device=arr.device)
    return arr


def _interpolate_color(channels: torch.Tensor, target_hw) -> torch.Tensor:
    """Bilinearly resize the three channels to the luminance size
    (``image_data.cpp:144-168``); a channel already at that size is kept."""
    out = []
    for ch in channels[:3]:
        if tuple(ch.shape) != tuple(target_hw):
            ch = _linear_resize(ch, target_hw)
        out.append(ch)
    return torch.stack(out)
