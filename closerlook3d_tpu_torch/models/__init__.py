"""Models: the residual point trunk, PosPool and adaptive-weight
aggregation, heads."""

from closerlook3d_tpu_torch.models.build import (  # noqa: F401
    ClassificationModel,
    build_classification,
    build_model,
)
