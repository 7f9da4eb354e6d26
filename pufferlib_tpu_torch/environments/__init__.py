"""Environment zoo of the port (pufferlib_tpu/environments/). The
first-party envs live in pufferlib_tpu_torch.ocean; so far this package
holds the mock-space suite, environments.test (ROADMAP, queue 1)."""
