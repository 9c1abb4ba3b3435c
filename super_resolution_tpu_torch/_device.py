"""Device and tensor placement helpers shared by the port's entry points."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "as_tensor", "as_chw"]


def resolve_device(device) -> torch.device:
    """Return ``torch.device(device)``; raise if it names CUDA and none is present.

    Entry points default to ``"cuda"``: a caller that wants the CPU says so.
    Nothing falls back to the CPU on its own.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but no CUDA device is "
            "available; pass device='cpu' explicitly to run the plain "
            "PyTorch versions on the CPU."
        )
    return dev


def as_tensor(array, device, dtype: torch.dtype) -> torch.Tensor:
    """Numpy array / sequence / tensor -> contiguous tensor on ``device``."""
    if isinstance(array, torch.Tensor):
        t = array
    else:
        t = torch.tensor(np.asarray(array))  # a copy: the input may be read-only
    return t.to(device=device, dtype=dtype).contiguous()


def as_chw(image, device, dtype: torch.dtype) -> torch.Tensor:
    """Image as a ``[C, H, W]`` tensor (a 2D input gains a channel axis)."""
    t = as_tensor(image, device, dtype)
    if t.ndim == 2:
        t = t[None]
    return t
