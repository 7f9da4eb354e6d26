"""Training: the fused PPO trainer (ppo), its profiling and checkpoints."""
