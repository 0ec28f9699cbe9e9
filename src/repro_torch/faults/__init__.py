"""Fault injection and QoS-pressure graceful degradation (port of
``repro.faults``): static-shape fault event tables for the simulator, and
the windowed-QoS degradation controller."""
from repro_torch.faults.degrade import (  # noqa: F401
    push_window,
    select_victims,
    under_pressure,
    victim_rank,
)
from repro_torch.faults.injection import (  # noqa: F401
    FaultConfig,
    FaultSchedule,
    backoff_delay,
    crash_burst,
    install_config_validator,
    jitter_table,
    sample_schedule,
    usage_surge,
)
