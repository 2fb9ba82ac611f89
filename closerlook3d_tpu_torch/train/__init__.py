"""Training: schedules and optimizer, train state, train and eval steps,
metrics, the evaluators (``evaluate.py``).

The engine around them (``Trainer``, checkpoints, logging, CLI) is not
ported yet (ROADMAP A).
"""

from closerlook3d_tpu_torch.train.schedules import (  # noqa: F401
    make_lr_schedule,
    make_optimizer,
)
from closerlook3d_tpu_torch.train.state import (  # noqa: F401
    TrainState,
    create_train_state,
)
from closerlook3d_tpu_torch.train.step import (  # noqa: F401
    make_eval_step,
    make_train_step,
)
