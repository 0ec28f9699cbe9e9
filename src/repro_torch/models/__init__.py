"""The model substrate (dense, moe, ssm, hybrid, encdec and vlm
families) on PyTorch."""
from repro_torch.models.model import (  # noqa: F401
    LM,
    EncDec,
    Model,
    build_model,
    cache_specs,
    init_cache,
)
from repro_torch.models.layers import kernels_allowed, no_kernels  # noqa: F401
