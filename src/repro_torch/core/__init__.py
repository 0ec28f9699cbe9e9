"""Flex core: types, allocation, QoS, penalty control, the legacy
schedulers and the simulator."""
from repro_torch.core.types import (  # noqa: F401
    CLASS_BATCH,
    CLASS_PRODUCTION,
    CLASS_SYSTEM,
    CPU,
    MEM,
    NUM_CLASSES,
    NUM_RESOURCES,
    NUM_SRC_BUCKETS,
    ControllerState,
    FlexParams,
    NodeState,
    SchedulerKind,
    SimConfig,
    SimResult,
    SlotMetrics,
    TaskSet,
)
from repro_torch.core.noise import GeneratorNoise, ReplayNoise  # noqa: F401
from repro_torch.core.penalty import update_penalty  # noqa: F401
from repro_torch.core.schedulers import (  # noqa: F401
    fifo_scheduler,
    lrf_scheduler,
    node_scores,
    place_task,
    schedule_queue,
)
from repro_torch.core.allocation import waterfill, wfs_allocate  # noqa: F401
from repro_torch.core.qos import (  # noqa: F401
    cluster_qos,
    task_qos,
    violation_fraction,
)
from repro_torch.core.simulator import (  # noqa: F401
    build_arrival_table,
    run,
    simulate,
)
