"""Image display utilities (equivalent of ``src/util/visualization.{h,cpp}``).

The reference offers an interactive OpenCV window with drag-to-zoom
(``visualization.cpp:58-136``); :class:`ZoomInteraction` reproduces that
state machine (left-drag draws a selection rectangle and zooms in on
release, right-click zooms back out, an interrupted drag cancels) with the
rendering callback injected, so the logic runs without a display. Mouse
events arrive with OpenCV's event codes, kept here as the port's own
constants.

The port has no GUI toolkit, so display always takes the JAX package's
headless branch: the image is written as a PNG (with the port's own writer)
to ``<temp dir>/<title>.png``, the path is printed and returned. Where the
JAX package shrinks an image with ``cv2.resize`` (bilinear, fixed-point), the
port uses its own bilinear resize in floating point and rounds, so a shrunk
image may differ from OpenCV's by one grey level.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from super_resolution_tpu_torch.ops.resize import linear_resize
from super_resolution_tpu_torch.utils.image_io import write_image

__all__ = [
    "display_image",
    "display_images_side_by_side",
    "ZoomInteraction",
    "EVENT_MOUSEMOVE",
    "EVENT_LBUTTONDOWN",
    "EVENT_RBUTTONDOWN",
    "EVENT_LBUTTONUP",
    "EVENT_FLAG_LBUTTON",
]

# OpenCV's mouse-event codes (``cv::MouseEventTypes``, ``cv::MouseEventFlags``).
EVENT_MOUSEMOVE = 0
EVENT_LBUTTONDOWN = 1
EVENT_RBUTTONDOWN = 2
EVENT_LBUTTONUP = 4
EVENT_FLAG_LBUTTON = 1

_MAX_DISPLAY_W = 1250
_MAX_DISPLAY_H = 850
_SELECTION_COLOR = (0, 255, 255)  # yellow, like the reference


def _resize_uint8(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Bilinear resize of a uint8 ``HxW`` / ``HxWxC`` image to ``size`` = (width, height)."""
    t = torch.from_numpy(np.ascontiguousarray(image)).to(torch.float64)
    if t.ndim == 3:
        t = torch.movedim(t, -1, 0)
    out = linear_resize(t, (size[1], size[0]))
    if out.ndim == 3:
        out = torch.movedim(out, 0, -1)
    return np.clip(np.rint(out.numpy()), 0, 255).astype(np.uint8)


def _draw_rectangle(image: np.ndarray, p0, p1, color) -> None:
    """One-pixel outline between corners ``p0`` and ``p1`` ((x, y)), clipped to the image."""
    h, w = image.shape[:2]
    x0, x1 = sorted((p0[0], p1[0]))
    y0, y1 = sorted((p0[1], p1[1]))
    value = color if image.ndim == 3 else color[0]
    xs = slice(max(x0, 0), min(x1, w - 1) + 1)
    ys = slice(max(y0, 0), min(y1, h - 1) + 1)
    for y in (y0, y1):
        if 0 <= y < h:
            image[y, xs] = value
    for x in (x0, x1):
        if 0 <= x < w:
            image[ys, x] = value


class ZoomInteraction:
    """Mouse-driven zoom state machine (``visualization.cpp:58-136``).

    Events arrive via :meth:`on_mouse` with OpenCV event codes; ``show`` is
    the injected render callback. Behavior:

    - left-press (not zoomed): start a drag; while dragging, the current
      selection rectangle is drawn over the image.
    - left-release: crop to the selection, rescale it to fit the display
      bounds, and show it (now zoomed in).
    - a drag whose left button is no longer held (mouse left the window)
      cancels and restores the original.
    - right-press while zoomed: restore the original image.
    """

    def __init__(self, image: np.ndarray, show):
        self.image = image
        self._show = show
        self.drag_start = (0, 0)
        self.dragging = False
        self.zoomed = False

    def on_mouse(self, event: int, x: int, y: int, flags: int = 0) -> None:
        if event == EVENT_RBUTTONDOWN and self.zoomed:
            self._show(self.image)
            self.zoomed = False
        if event == EVENT_LBUTTONDOWN and not self.zoomed:
            self.drag_start = (x, y)
            self.dragging = True
        if self.dragging and event != EVENT_LBUTTONDOWN and not (
            flags & EVENT_FLAG_LBUTTON
        ) and event != EVENT_LBUTTONUP:
            self._show(self.image)
            self.dragging = False
        if event == EVENT_LBUTTONUP and self.dragging:
            x0, y0 = self.drag_start
            left, top = min(x, x0), min(y, y0)
            w, h = abs(x - x0), abs(y - y0)
            if w > 0 and h > 0:
                crop = self.image[top: top + h, left: left + w]
                scale = min(_MAX_DISPLAY_W / w, _MAX_DISPLAY_H / h)
                crop = _resize_uint8(crop, (max(1, int(w * scale)), max(1, int(h * scale))))
                self._show(crop)
                self.zoomed = True
            self.dragging = False
        elif self.dragging:
            overlay = self.image.copy()
            _draw_rectangle(overlay, self.drag_start, (x, y), _SELECTION_COLOR)
            self._show(overlay)


def _fit(image: np.ndarray) -> np.ndarray:
    h, w = image.shape[:2]
    scale = min(_MAX_DISPLAY_W / w, _MAX_DISPLAY_H / h, 1.0)
    if scale < 1.0:
        image = _resize_uint8(image, (int(w * scale), int(h * scale)))
    return image


def _vis(image) -> np.ndarray:
    if hasattr(image, "visualization_image"):
        return image.visualization_image()
    arr = image.detach().cpu().numpy() if isinstance(image, torch.Tensor) else np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    return arr


def _save(image: np.ndarray, title: str) -> str:
    path = os.path.join(
        tempfile.gettempdir(), f"{title.lower().replace(' ', '_').replace('.', '')}.png"
    )
    write_image(path, image)
    print(f"[headless] saved '{title}' to {path}")
    return path


def display_image(image, title: str = "Image") -> str:
    """Write the image (fitted to 1250x850) as a PNG; returns its path."""
    return _save(_fit(_vis(image)), title)


def display_images_side_by_side(images, title: str = "Images") -> str:
    """Horizontal stitch (``visualization.cpp:138-169``); smaller images are
    padded to the tallest height. Returns the PNG's path."""
    mats = [_vis(img) for img in images]
    max_h = max(m.shape[0] for m in mats)
    padded = []
    for m in mats:
        if m.ndim == 2:
            m = np.repeat(m[..., None], 3, axis=-1)
        pad = max_h - m.shape[0]
        if pad:
            m = np.concatenate([m, np.zeros((pad,) + m.shape[1:], dtype=m.dtype)], axis=0)
        padded.append(m)
    stitched = np.concatenate(padded, axis=1)
    return _save(_fit(stitched), title)
