"""Point-cloud ops: each hand-written CUDA kernel with its plain version.

  ball_query             <- ops/pallas/neighbors.py ball-query kernels
  furthest_point_sample  <- ops/pallas/sampling.py FPS kernel
  pospool_fused          <- ops/pallas/aggregation.py PosPool xyz and
                            sin/cos fwd + bwd
  neighborhood_moments   <- ops/pallas/moments.py moments fwd + bwd
  neighborhood_max       <- ops/pallas/gather_reduce.py masked max fwd + bwd
  pwmlp_minmax_stats     <- ops/pallas/gather_reduce.py point-wise MLP
                            min/max + BN statistics fwd + bwd
  gather_sub_minmax      <- ops/pallas/gather_reduce.py point-wise MLP
                            gather-subtract min/max fwd + bwd
  pseudo_grid_fused      <- ops/pallas/pseudo_grid.py kernel-point
                            correlation fwd + bwd
  knn                    <- ops/pallas/neighbors.py 1-NN (chunked) and
                            k-NN kernels
  group_features, masked_* reductions, grid_subsample, nearest_upsample,
  three_interpolate: plain PyTorch (no kernel in either package; the
  last two reach knn).

Importing this package registers the ``cl3d`` ops (``library.py``): each
forward family that an eval forward reaches, and ``grid_subsample``, as
one ``torch.library`` op that ``torch.export`` captures.
"""

from closerlook3d_tpu_torch.ops.aggregation import pospool_fused  # noqa: F401
from closerlook3d_tpu_torch.ops.gather_reduce import (  # noqa: F401
    gather_sub_minmax,
    pwmlp_minmax_stats,
)
from closerlook3d_tpu_torch.ops.grouping import (  # noqa: F401
    group_features,
    group_xyz,
    masked_avg,
    masked_max,
    masked_min,
    masked_sum,
    neighborhood_max,
)
from closerlook3d_tpu_torch.ops.interpolate import (  # noqa: F401
    nearest_upsample,
    three_interpolate,
)
from closerlook3d_tpu_torch.ops.moments import (  # noqa: F401
    neighborhood_moments,
)
from closerlook3d_tpu_torch.ops.neighbors import (  # noqa: F401
    ball_query,
    knn,
    pairwise_dist2,
)
from closerlook3d_tpu_torch.ops.pseudo_grid import (  # noqa: F401
    pseudo_grid_fused,
)
from closerlook3d_tpu_torch.ops.sampling import (  # noqa: F401
    furthest_point_sample,
    grid_subsample,
)
