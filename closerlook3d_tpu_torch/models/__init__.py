"""Models: the residual point trunk, the four local aggregation families
(PosPool, adaptive weight, point-wise MLP, pseudo-grid), heads."""

from closerlook3d_tpu_torch.models.build import (  # noqa: F401
    ClassificationModel,
    MultiPartSegModel,
    SceneSegModel,
    build_classification,
    build_model,
)
