"""Data parallelism over ``torch.distributed``: the process layout and
batch placement (``mesh.py``), the reductions across processes
(``collectives.py``) and a launcher of ranks in one host
(``spawn.py``)."""

from closerlook3d_tpu_torch.parallel.collectives import (  # noqa: F401
    all_processes_concat,
    all_processes_min,
    all_processes_sum,
    all_reduce_sum,
    reduce_gradients,
    reduce_sum,
)
from closerlook3d_tpu_torch.parallel.mesh import (  # noqa: F401
    Layout,
    layout,
    make_mesh,
    maybe_initialize_distributed,
    shard_batch,
)
