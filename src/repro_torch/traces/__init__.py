"""Workload generation and run summaries."""
from repro_torch.traces.generator import (  # noqa: F401
    ARRIVAL_PATTERNS,
    TraceParams,
    arrival_counts,
    generate_calibrated,
    generate_taskset,
    n_tasks_for_offered_load,
    scale_demand,
)
from repro_torch.traces import analysis  # noqa: F401
