"""PyTorch and CUDA port of closerlook3d_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's module names (``ops/neighbors.py``,
``models/backbone.py``, ...) so each counterpart is easy to find. Every
kernel the JAX package writes in Pallas for the TPU becomes a CUDA kernel
written by hand under ``csrc/``, with a plain PyTorch version beside it in
the same module: CUDA tensors go to the kernel, CPU tensors to the plain
version (``ops/dispatch.py``). This package imports ``torch`` and never
``jax``, ``flax``, ``ml_collections`` or ``closerlook3d_tpu``.

Ported so far: classification, part and scene segmentation with every
operator family, served through ``serving.predictor.Predictor`` or an
exported artifact (``serving/export.py``, ``cli/export.py``: each kernel
family a ``cl3d`` op of ``ops/library.py``) and
trained through ``train/`` (``make_optimizer``, ``create_train_state``,
``make_train_step``) and its engine (``train/loop.py::Trainer``, with
checkpoints, auto-resume, validation and scalar logs); the evaluators
(``train/evaluate.py``), the dataset readers and factory (``data/``), the
device Morton sort (``ops/spatial.py``), the command-line entry points
(``cli/train.py``, with ``--check_data``, and ``cli/evaluate.py``) and
data parallelism over ``torch.distributed`` (``parallel/``: one process a
rank under torchrun, the step of N ranks that of one process on their N
batches together).
"""

__version__ = "0.1.0"

from closerlook3d_tpu_torch.utils.config import load_config  # noqa: F401
