"""``repro_torch.api``: policies, registry, admission core and Experiment."""
from repro_torch.api.admission import (  # noqa: F401
    NEG_INF,
    KernelInputs,
    PolicyContext,
    TaskView,
    admit_one,
    admit_queue,
    committed_load,
    dominant,
    fits,
    least_loaded_score,
    mask_infeasible,
    pick_node,
    usage_load,
)
from repro_torch.api.protocols import (  # noqa: F401
    Estimator,
    PenaltyController,
    PlacementPolicy,
    policy_default_params,
    policy_prepare_params,
    policy_queue_order,
    policy_supports_kernel,
)
from repro_torch.api.registry import (  # noqa: F401
    KIND_TO_NAME,
    get_policy,
    list_policies,
    register_policy,
    resolve_policy,
)
from repro_torch.api.policies import (  # noqa: F401
    AimdPenaltyController,
    BestFitUsagePolicy,
    FlexFifoPolicy,
    FlexLrfPolicy,
    LeastFitPolicy,
    OversubPolicy,
    PriorityFlexPolicy,
    resolve_estimator,
)
from repro_torch.estimators import (  # noqa: F401
    EstimatorState,
    get_estimator,
    list_estimators,
    register_estimator,
)
from repro_torch.api.experiment import Experiment  # noqa: F401
