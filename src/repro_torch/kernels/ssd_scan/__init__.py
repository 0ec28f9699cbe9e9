"""Chunked SSD (Mamba2) scan: CUDA for the card, plain PyTorch for the
CPU."""
from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: F401
from repro_torch.kernels.ssd_scan.ref import ssd_ref  # noqa: F401
