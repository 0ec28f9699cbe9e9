"""Blocked flash attention: CUDA for the card, plain PyTorch for the CPU."""
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    FlashAttention, flash_attention)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    attention_bwd_ref, attention_lse_ref, attention_ref)
