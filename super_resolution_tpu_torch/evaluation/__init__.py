from super_resolution_tpu_torch.evaluation.metrics import psnr  # noqa: F401
