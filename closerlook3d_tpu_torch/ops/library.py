"""The port's operator namespace, ``cl3d``: each forward kernel family as
one ``torch.library`` op.

``torch.export`` cannot trace through a kernel's ``ctypes`` launch
(``ops/kernels.py``), and a plain version traced in its place would give
an exported program that runs no kernel at all. So each family that an
eval-mode forward reaches is an op of its own, ``torch.ops.cl3d.<name>``,
which an exported graph holds as one node:

  * its implementation is the family's device dispatch: it reads the
    module's ``use_kernel`` at call time, so a CUDA tensor launches the
    kernel (or raises) and a CPU tensor takes the plain version; the same
    Python function is registered for the CPU and the CUDA dispatch keys;
  * its fake implementation gives outputs of the real shapes, dtypes and
    contiguity from the inputs' metadata alone, so that ``torch.export``
    (and ``torch.library.opcheck``) trace it without running it.

Each op is defined in the module that holds its wrappers, so importing
``closerlook3d_tpu_torch.ops`` registers them all, and a process that
loads an exported program needs that import and no model code. The ops
carry no autograd formula: the differentiable families call them inside
their ``torch.autograd.Function``'s forward (``ops/aggregation.py``
etc.), or directly where grad is off; the training-only families (K6f,
K13) and every backward stay plain launches.
"""

from __future__ import annotations

import torch

NAMESPACE = "cl3d"
LIB = torch.library.Library(NAMESPACE, "DEF")


def define(schema: str, impl, fake):
    """Define ``cl3d::<schema>`` with ``impl`` on the CPU and CUDA keys
    and ``fake`` for fake tensors; returns the op's default overload."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    for key in ("CPU", "CUDA"):
        LIB.impl(name, impl, key)
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def contiguous(*tensors):
    """The outputs as the fake implementations describe them: contiguous
    (a plain version may return a view, e.g. the first k of a sort)."""
    return tuple(t.contiguous() for t in tensors)
