"""llava-next(1.6)-mistral-7b — VLM: mistral backbone + anyres tiling stub.

The vision tower/projector is a STUB per the assignment: input_specs()
provides precomputed patch embeddings (batch, n_patches, d_model) that the
backbone prepends to the token embeddings.
"""
from repro_torch.configs.base import ModelConfig, shrink

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14_336, vocab_size=32_000, n_patches=576,
)

def smoke_config():
    return shrink(CONFIG)
