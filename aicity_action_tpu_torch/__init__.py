"""PyTorch / CUDA port of ``aicity_action_tpu`` for one NVIDIA H100.

The JAX package beside it stays the reference. This package serves the AI
City Track 3 main path: sliding-window scoring with MViT-v2-B 16x4 @ 448,
whose four TPU kernels (norm1+qkv, LN-fused flash attention, norm2+MLP and
the final LayerNorm) are hand-written CUDA kernels here (``csrc/``), built
with nvcc at first use and bound with ctypes (``ops/kernels``).

Entry points take ``device=`` (default ``"cuda"``) and never fall back to the
CPU on their own; on the CPU every kernel wrapper runs its plain PyTorch
version, which is what the CPU tests compare with the JAX package.
"""

from .device import compute_dtype, resolve_device

__all__ = ["compute_dtype", "resolve_device"]
