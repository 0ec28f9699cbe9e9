"""The model substrate (dense family) on PyTorch."""
from repro_torch.models.model import (  # noqa: F401
    DenseLM,
    Model,
    build_model,
    cache_specs,
    init_cache,
)
