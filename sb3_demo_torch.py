"""Minimal Stable-Baselines3 demo over the port's env wrappers (counterpart
of sb3_demo.py; reference sb3_demo.py): host envs are adapted to real
gymnasium.Env instances (host_env.GymnasiumAdapter), so SB3 consumes them
directly. Needs stable_baselines3, which is not installed here: it raises
ImportError.

Usage: python sb3_demo_torch.py [--env nethack] [--timesteps 2000]
"""
import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--env', type=str, default='cartpole')
    parser.add_argument('--timesteps', type=int, default=2000)
    parser.add_argument('--n-envs', type=int, default=4)
    args = parser.parse_args(argv)

    from pufferlib_tpu_torch.config.cli import load_config
    from pufferlib_tpu_torch.frameworks.sb3 import train_sb3

    cfg, env_module, creator = load_config(args.env, argv=[
        '--env', args.env])
    model = train_sb3(creator, env_kwargs=dict(cfg.env_kwargs),
        n_envs=args.n_envs, total_timesteps=args.timesteps)
    model.save(f'ppo_{args.env}')
    return model


if __name__ == '__main__':
    main()
