"""Serving: load weights and answer classification and segmentation
requests."""

from closerlook3d_tpu_torch.serving.predictor import Predictor  # noqa: F401
