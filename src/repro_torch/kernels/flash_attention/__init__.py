"""Blocked flash attention: CUDA for the card, plain PyTorch for the CPU."""
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    attention_ref)
