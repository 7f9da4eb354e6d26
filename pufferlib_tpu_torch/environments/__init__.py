"""Environment zoo of the port (pufferlib_tpu/environments/). The
first-party envs live in pufferlib_tpu_torch.ocean; here the mock-space
suite (environments.test), the pixel envs (atari, procgen) and the zoo
bindings whose policies reach an LSTM kernel (nethack, minihack, nmmo,
nmmo3, pokemon_red). The other bindings are ROADMAP queue 1 item 7."""
