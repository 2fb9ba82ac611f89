"""Training: schedules and optimizers (SGD, AdamW), train state, train
and eval steps, metrics, the evaluators (``evaluate.py``), checkpoints
(``checkpoints.py``) and the engine that drives them (``loop.py::Trainer``,
behind ``cli/train.py``).
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
