"""RLlib PPO driver over the port's env bridge (counterpart of
rllib_ppo.py; reference rllib_ppo.py, which the reference itself marks
legacy: CleanRL-style training is the supported path there and here).
Registers a puffer env with Ray Tune and runs PPO. Needs ray[rllib],
which is not installed here: it raises ImportError.

Usage: python rllib_ppo_torch.py [--env nethack] [--iterations 3]
"""
import argparse


def make_rllib_tuner(env_name, creator, *, num_workers=1,
        train_batch_size=1024, sgd_minibatch_size=128, num_sgd_iter=4,
        training_iterations=3):
    """A Ray Tune Tuner over RLlib PPO for a puffer env creator
    (reference rllib_ppo.py:30-100, the modern ray.tune API)."""
    from ray import tune
    from ray.rllib.algorithms.ppo import PPOConfig

    from pufferlib_tpu_torch.frameworks import rllib as puffer_rllib
    puffer_rllib.register_env(env_name, creator)

    config = (PPOConfig()
        .environment(env=env_name)
        .env_runners(num_env_runners=num_workers)
        .training(train_batch_size=train_batch_size,
            minibatch_size=sgd_minibatch_size,
            num_epochs=num_sgd_iter))
    return tune.Tuner(
        'PPO',
        param_space=config.to_dict(),
        run_config=tune.RunConfig(
            stop={'training_iteration': training_iterations}),
    )


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--env', type=str, default='cartpole')
    parser.add_argument('--iterations', type=int, default=3)
    args = parser.parse_args(argv)

    try:
        import ray  # noqa: F401
    except ImportError as e:
        raise ImportError(
            'rllib_ppo_torch requires ray[rllib], which is not installed '
            'in this image') from e

    from pufferlib_tpu_torch.config.cli import load_config
    cfg, env_module, creator = load_config(args.env, argv=[
        '--env', args.env])
    kwargs = dict(cfg.env_kwargs)
    tuner = make_rllib_tuner(args.env, lambda: creator(**kwargs),
        training_iterations=args.iterations)
    return tuner.fit()


if __name__ == '__main__':
    main()
