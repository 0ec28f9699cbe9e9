"""``repro_torch.train``: AdamW, the train step and checkpoints."""
from repro_torch.train.optimizer import (  # noqa: F401
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
)
from repro_torch.train.train_step import (  # noqa: F401
    init_train_state,
    make_train_step,
)
