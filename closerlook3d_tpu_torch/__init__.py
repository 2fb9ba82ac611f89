"""PyTorch and CUDA port of closerlook3d_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's module names (``ops/neighbors.py``,
``models/backbone.py``, ...) so each counterpart is easy to find. Every
kernel the JAX package writes in Pallas for the TPU becomes a CUDA kernel
written by hand under ``csrc/``, with a plain PyTorch version beside it in
the same module: CUDA tensors go to the kernel, CPU tensors to the plain
version (``ops/dispatch.py``). This package imports ``torch`` and never
``jax``, ``flax``, ``ml_collections`` or ``closerlook3d_tpu``.

Ported so far: ModelNet40 classification with PosPool (xyz, sin/cos) and
the adaptive weight, served through ``serving.predictor.Predictor`` and
trained through ``train/`` (``make_optimizer``, ``create_train_state``,
``make_train_step``).
"""

__version__ = "0.1.0"

from closerlook3d_tpu_torch.utils.config import load_config  # noqa: F401
