"""Host-side (numpy) data: the dataset readers and factory, augmentations,
batching and its prefetcher, the host Morton sort and geometry
precompute, and the on-disk checker (``check.py``)."""

from closerlook3d_tpu_torch.data.build import build_dataset  # noqa: F401
from closerlook3d_tpu_torch.data.loader import (  # noqa: F401
    BatchIterator,
    build_features,
)
