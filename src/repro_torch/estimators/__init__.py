"""``repro_torch.estimators``: pluggable, stateful load estimators."""
from repro_torch.estimators.base import (  # noqa: F401
    EstimatorState,
    as_stateful,
    is_stateful,
    zeros_state,
)
from repro_torch.estimators.builtin import (  # noqa: F401
    CurrentEstimator,
    EwmaEstimator,
)
from repro_torch.estimators.registry import (  # noqa: F401
    get_estimator,
    list_estimators,
    register_estimator,
    resolve_estimator,
)
