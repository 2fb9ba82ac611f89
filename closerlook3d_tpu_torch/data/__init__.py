"""Host-side (numpy) data: the dataset readers and factory, augmentations,
batching, the host Morton sort and geometry precompute."""
