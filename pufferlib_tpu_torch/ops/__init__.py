"""Tensor ops: plain PyTorch versions (gae, losses) and the CUDA kernels
that replace the JAX package's Pallas kernels (ops/cuda)."""
from pufferlib_tpu_torch.ops.gae import compute_gae, compute_gae_flat
from pufferlib_tpu_torch.ops.losses import ppo_losses

__all__ = ['compute_gae', 'compute_gae_flat', 'ppo_losses']
