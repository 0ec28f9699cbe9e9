"""The model substrate (dense, moe, ssm and hybrid families) on PyTorch."""
from repro_torch.models.model import (  # noqa: F401
    LM,
    Model,
    build_model,
    cache_specs,
    init_cache,
)
