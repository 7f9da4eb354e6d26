"""Minimal CleanRL-style PPO over the port's device vector engine — what
training.ppo automates, written out longhand for reading
(examples/cleanrl_style_ppo.py on pufferlib_tpu_torch).

256 lanes of Ocean squared, 64 steps a rollout, 30 epochs of one
full-batch Adam step (lr 0.017, eps 1e-5) on `Default` (hidden 64). The
GAE goes through the GAE kernel (ops/cuda/gae.py) on the card and through
its plain version, ops.compute_gae, on the CPU. Prints one line an
epoch: the mean score of the episodes that ended in it, and the policy
loss.

Run: python examples/cleanrl_style_ppo_torch.py [--device cpu]
(on the card unless --device cpu).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

NUM_ENVS, T, EPOCHS = 256, 64, 30
GAMMA, LAM, LR = 0.99, 0.95, 0.017


def main(argv=None):
    import torch

    import pufferlib_tpu_torch.vector as vector
    from pufferlib_tpu_torch import resolve_device
    from pufferlib_tpu_torch.models import Default, Policy
    from pufferlib_tpu_torch.ocean import env_creator
    from pufferlib_tpu_torch.ops import ppo_losses
    from pufferlib_tpu_torch.ops.cuda.gae import compute_gae_cuda
    from pufferlib_tpu_torch.vector import make_env_ops

    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default='cuda')
    device = resolve_device(parser.parse_args(argv).device)

    vecenv = vector.make(env_creator('squared'), backend=vector.Device,
        num_envs=NUM_ENVS, device=device)
    env = vecenv.env
    policy = Policy(Default(obs_shape=vecenv.single_observation_space.shape,
        action_space=vecenv.single_action_space, hidden_size=64,
        generator=torch.Generator().manual_seed(0))).to(device)
    reset_batch, step_batch = make_env_ops(env, vecenv.emulated)
    optimizer = torch.optim.Adam(policy.parameters(), lr=LR, eps=1e-5)
    generator = torch.Generator(device=device).manual_seed(0)
    states, obs, dones = reset_batch(env.sample_reset(NUM_ENVS, device,
        generator))

    @torch.no_grad()
    def rollout(states, obs, dones):
        traj = {k: [] for k in ('obs', 'action', 'logprob', 'value',
            'reward', 'done', 'score')}
        for _ in range(T):
            action, logprob, _, value = policy(obs, generator=generator)
            states, next_dones, next_obs, reward, done, _, infos = \
                step_batch(states, dones, action, env.sample_reset(NUM_ENVS,
                    device, generator), env.sample_step(NUM_ENVS, device,
                    generator))
            for k, v in (('obs', obs), ('action', action),
                    ('logprob', logprob), ('value', value.reshape(-1)),
                    ('reward', reward), ('done', done.float()),
                    ('score', infos.get('score', reward * 0))):
                traj[k].append(v)
            obs, dones = next_obs, next_dones
        traj = {k: torch.stack(v) for k, v in traj.items()}
        last_value = policy.get_value(obs).reshape(-1).float()
        return states, obs, dones, traj, last_value

    def update(traj, last_value):
        adv = compute_gae_cuda(traj['reward'].float().contiguous(),
            traj['value'].float().contiguous(), traj['done'].contiguous(),
            last_value.contiguous(), GAMMA, LAM)
        ret = adv + traj['value']

        def flat(x):
            return x.reshape((T * NUM_ENVS,) + tuple(x.shape[2:]))
        _, newlogprob, entropy, newvalue = policy(flat(traj['obs']),
            action=flat(traj['action']))
        loss, stats = ppo_losses(newlogprob, flat(traj['logprob']), entropy,
            newvalue.reshape(-1), flat(traj['value']), flat(adv), flat(ret),
            clip_coef=0.2)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return stats

    for epoch in range(EPOCHS):
        states, obs, dones, traj, last_value = rollout(states, obs, dones)
        stats = update(traj, last_value)
        score = traj['score'].sum() / traj['done'].sum().clamp(min=1)
        print(f'epoch {epoch:3d}  score {float(score):.3f}  '
            f'pg {float(stats["policy_loss"]):+.4f}', flush=True)


if __name__ == '__main__':
    main()
