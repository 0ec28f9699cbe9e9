"""The Flex filter+score+argmax kernel: CUDA for the card, plain PyTorch
for the CPU."""
from repro_torch.kernels.flex_score.ops import flex_pick_node  # noqa: F401
from repro_torch.kernels.flex_score.ref import (  # noqa: F401
    NEG_INF,
    pick_node_ref,
)
