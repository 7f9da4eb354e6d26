"""Environment zoo of the port (pufferlib_tpu/environments/). The
first-party envs live in pufferlib_tpu_torch.ocean; here the mock-space
suite (environments.test, with the host fixtures and the fake backends
the card runs) and every package of the JAX zoo: the pixel envs (atari,
procgen), the bindings whose policies reach an LSTM kernel (nethack,
minihack, nmmo, nmmo3, pokemon_red), and bsuite, butterfly,
classic_control, crafter, dm_control, dm_lab, griddly, links_awaken,
magent, microrts, minerl, minigrid, nocturne, open_spiel, slimevolley,
smac, stable_retro and vizdoom. Each package has env_creator and make
(which raises the JAX binding's ImportError where its backend is
missing) and a wrap(env) that applies the binding's own wrapper stack
to a backend env; none imports torch or gymnasium at its top level, as
envpool workers import them."""
