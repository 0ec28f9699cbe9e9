"""PyTorch port of the Flex reproduction, for NVIDIA Hopper GPUs.

Mirrors the JAX package ``repro`` module for module; the JAX package is
the reference the port is held against.  Entry points take a ``device``
argument that defaults to ``"cuda"``.
"""
