"""``repro_torch.estimators``: pluggable, stateful load estimators.

Built-ins: ``current`` (the paper's), ``ewma``, ``quantile`` (sliding
peak-window quantile) and ``learned`` (an MLP predictor, trained through
:mod:`repro_torch.train`).
"""
from repro_torch.estimators.base import (  # noqa: F401
    EstimatorState,
    StatelessAdapter,
    as_stateful,
    is_stateful,
    zeros_state,
)
from repro_torch.estimators.builtin import (  # noqa: F401
    CurrentEstimator,
    EwmaEstimator,
    QuantileWindowEstimator,
    ring_chronological,
    ring_push,
)
from repro_torch.estimators.learned import (  # noqa: F401
    LearnedUsageEstimator,
    UsagePredictor,
    make_dataset,
    mlp_apply,
    mlp_init,
    train_usage_predictor,
)
from repro_torch.estimators.registry import (  # noqa: F401
    get_estimator,
    list_estimators,
    register_estimator,
    resolve_estimator,
)
