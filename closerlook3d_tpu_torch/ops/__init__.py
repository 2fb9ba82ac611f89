"""Point-cloud ops: each hand-written CUDA kernel with its plain version.

  ball_query             <- ops/pallas/neighbors.py ball-query kernels
  furthest_point_sample  <- ops/pallas/sampling.py FPS kernel
  pospool_fused          <- ops/pallas/aggregation.py PosPool xyz fwd + bwd
  neighborhood_max       <- ops/pallas/gather_reduce.py masked max fwd + bwd
  group_features, masked_* reductions: plain gathers.
"""

from closerlook3d_tpu_torch.ops.aggregation import pospool_fused  # noqa: F401
from closerlook3d_tpu_torch.ops.grouping import (  # noqa: F401
    group_features,
    group_xyz,
    masked_avg,
    masked_max,
    masked_sum,
    neighborhood_max,
)
from closerlook3d_tpu_torch.ops.neighbors import (  # noqa: F401
    ball_query,
    pairwise_dist2,
)
from closerlook3d_tpu_torch.ops.sampling import (  # noqa: F401
    furthest_point_sample,
)
