from super_resolution_tpu_torch.video.video_loader import VideoLoader  # noqa: F401
from super_resolution_tpu_torch.video.super_resolver import VideoSuperResolver  # noqa: F401
