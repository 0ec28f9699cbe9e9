"""The serving engine (Flex admission over replicas) and its stream driver."""
from repro_torch.serving.engine import (  # noqa: F401
    ADMISSION_MODES,
    AdmissionPolicy,
    EngineConfig,
    EngineStats,
    Request,
    ServeEngine,
    resolve_engine_policy,
)
from repro_torch.serving.stream import (  # noqa: F401
    RequestStream,
    StreamConfig,
)
