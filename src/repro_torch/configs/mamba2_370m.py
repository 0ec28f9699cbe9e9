"""mamba2-370m — SSD (state-space duality), attention-free [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig, shrink

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=0,
    vocab_size=50_280, ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    conv_width=4, ssd_chunk=256, tie_embeddings=True,
)

def smoke_config():
    return shrink(CONFIG)
