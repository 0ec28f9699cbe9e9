"""``repro_torch.train``: AdamW, the train step, checkpoints and the
synthetic data stream."""
from repro_torch.train.data import stream, synthetic_batch  # noqa: F401
from repro_torch.train.optimizer import (  # noqa: F401
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
)
from repro_torch.train.train_step import (  # noqa: F401
    init_train_state,
    make_train_step,
    optimizer_view,
    value_and_grad,
)
