"""Video: frames read from MP4 / QuickTime, Matroska / WebM and AVI files or
from image directories (:class:`VideoLoader`, :func:`read_video_frames`),
and super-resolved a window at a time (:class:`VideoSuperResolver`)."""

from super_resolution_tpu_torch.video.video_loader import VideoLoader, read_video_frames  # noqa: F401
from super_resolution_tpu_torch.video.super_resolver import VideoSuperResolver  # noqa: F401
