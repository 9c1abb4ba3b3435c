from super_resolution_tpu_torch.evaluation.metrics import (  # noqa: F401
    GroundTruthEvaluator,
    PeakSignalToNoiseRatioEvaluator,
    StructuralSimilarityEvaluator,
    psnr,
    ssim,
)
