"""Self-play with the PyTorch port: PolicyPool routing, a checkpointed
opponent and Elo (examples/selfplay.py on pufferlib_tpu_torch).

Agent 0 of each Multiagent env is driven by the learner, agent 1 by a
frozen opponent saved as model_000000.pt (training/checkpoint.py's
name) and read back through PolicyStore; the episode scores feed the
sqlite Elo ranker. 16 steps.

Run: python examples/selfplay_torch.py [--device cpu] [--store DIR]
(on the card unless --device cpu; the store defaults to
experiments/puffer_selfplay in the checkout).
"""
import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    import numpy as np
    import torch

    import pufferlib_tpu_torch.vector as vector
    from pufferlib_tpu_torch import resolve_device
    from pufferlib_tpu_torch.models import Default, Policy
    from pufferlib_tpu_torch.ocean import env_creator
    from pufferlib_tpu_torch.policy_pool import PolicyPool
    from pufferlib_tpu_torch.policy_ranker import Ranker
    from pufferlib_tpu_torch.policy_store import PolicyStore

    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--store', default=os.path.join(REPO, 'experiments',
        'puffer_selfplay'))
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.store, exist_ok=True)

    vecenv = vector.make(env_creator('multiagent'),
        env_kwargs=dict(episode_stats=False), num_envs=8, device=device)

    def make_policy(seed):
        return Policy(Default(obs_shape=vecenv.single_observation_space.shape,
            action_space=vecenv.single_action_space, hidden_size=32,
            generator=torch.Generator().manual_seed(seed))).to(device)

    policy = make_policy(0)
    learner = policy.state_dict()
    torch.save(make_policy(1).state_dict(),
        os.path.join(args.store, 'model_000000.pt'))

    store = PolicyStore(args.store)
    print('opponents in store:', store.policy_names())
    opponent = store.get_policy(store.policy_names()[-1])

    pool = PolicyPool(policy, [learner, opponent], learner_mask=[True, False],
        num_agents=vecenv.num_agents)
    ranker = Ranker(os.path.join(args.store, 'ratings.sqlite'))
    generator = torch.Generator(device=device).manual_seed(0)

    obs, _ = vecenv.reset(seed=0)
    learner_rows = pool.learner_agent_mask.cpu().numpy()
    scores = {'learner': [], 'opponent': []}
    with torch.no_grad():
        for _ in range(16):
            actions, logprobs, entropy, values, _ = pool.forward(obs,
                generator=generator)
            obs, rew, done, trunc, infos = vecenv.step(actions)
            rew = np.asarray(torch.as_tensor(rew).cpu())
            scores['learner'].append(rew[learner_rows].mean())
            scores['opponent'].append(rew[~learner_rows].mean())
    vecenv.close()

    ratings = ranker.update({
        'learner': float(np.mean(scores['learner'])),
        'model_000000': float(np.mean(scores['opponent'])),
    })
    ranker.close()
    means = {k: float(np.mean(v)) for k, v in scores.items()}
    print('mean scores:', {k: round(v, 3) for k, v in means.items()})
    print('elo:', {k: round(v, 1) for k, v in ratings.items()})
    return dict(scores=means, ratings=ratings)


if __name__ == '__main__':
    main()
