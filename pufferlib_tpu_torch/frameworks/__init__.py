"""Bridges to other frameworks (counterpart of pufferlib_tpu/frameworks/):
reference PufferLib checkpoints (torch_import), CleanRL's import path
(cleanrl), Stable-Baselines3 (sb3) and RLlib (rllib). sb3 and rllib import
their framework inside each function: neither is installed here."""
