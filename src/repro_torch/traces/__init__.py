"""Workload generation and run summaries."""
from repro_torch.traces.generator import (  # noqa: F401
    TraceParams,
    generate_calibrated,
    generate_taskset,
    n_tasks_for_offered_load,
)
from repro_torch.traces import analysis  # noqa: F401
