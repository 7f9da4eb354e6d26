"""Self-play in the PyTorch port (policy_pool, policy_store, policy_ranker,
examples/selfplay_torch.py) against the JAX package's, on the CPU.

- PolicyPool: the JAX pool and the port's, two policies from different
  flax inits (carried by convert.py), the uniforms drawn from the JAX
  pool's per-policy keys and handed to the port's: actions exact,
  logprobs and entropy within 1e-6, values within 1e-5 and the routed
  state within 1e-6 (f32), for a Default pool, an LSTM pool and a
  transformer pool, all agents in order and a reordered partial batch
  (agent_ids). The reference's routing contract (tests/test_selfplay.py,
  opposite strong logit biases) and the agent_ids refusal.
- PolicyStore lists and loads the model_*.pt files training/checkpoint.py
  writes, and refuses a file that is no state_dict.
- Ranker: the same ratings as the JAX Ranker on the same updates, and
  persistence.
- The example as a subprocess on the CPU.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from pufferlib_tpu import spaces as jspaces
from pufferlib_tpu.models import Default as JaxDefault
from pufferlib_tpu.models import LSTMWrapper as JaxLSTMWrapper
from pufferlib_tpu.models import Policy as JaxPolicy
from pufferlib_tpu.models import RecurrentPolicy as JaxRecurrentPolicy
from pufferlib_tpu.models import TransformerPolicy as JaxTransformerPolicy
from pufferlib_tpu.models import TransformerWrapper as JaxTransformerWrapper
from pufferlib_tpu.policy_pool import PolicyPool as JaxPolicyPool
from pufferlib_tpu.policy_ranker import Ranker as JaxRanker
from pufferlib_tpu.policy_ranker import update_elo as jax_update_elo
from pufferlib_tpu.policy_ranker import win_prob as jax_win_prob

import pufferlib_tpu_torch.vector as vector
from pufferlib_tpu_torch import spaces
from pufferlib_tpu_torch.convert import (
    default_state_dict, lstm_state_dict, transformer_state_dict)
from pufferlib_tpu_torch.exceptions import APIUsageError
from pufferlib_tpu_torch.models import (
    Default, LSTMWrapper, Policy, RecurrentPolicy, TransformerPolicy,
    TransformerWrapper)
from pufferlib_tpu_torch.ocean import env_creator
from pufferlib_tpu_torch.policy_pool import PolicyPool, cycle_selector
from pufferlib_tpu_torch.policy_ranker import Ranker, update_elo, win_prob
from pufferlib_tpu_torch.policy_store import PolicyStore
from pufferlib_tpu_torch.training import checkpoint, ppo

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS = (5,)
ACT = 3
HIDDEN = 16
AGENTS = 6


def _jax_policy(kind):
    default = JaxDefault(obs_shape=OBS, action_space=jspaces.Discrete(ACT),
        hidden_size=HIDDEN)
    if kind == 'default':
        return JaxPolicy(default)
    if kind == 'lstm':
        return JaxRecurrentPolicy(JaxLSTMWrapper(policy=default,
            obs_shape=OBS, input_size=HIDDEN, hidden_size=HIDDEN,
            use_pallas=False))
    return JaxTransformerPolicy(JaxTransformerWrapper(policy=default,
        obs_shape=OBS, input_size=HIDDEN, hidden_size=HIDDEN, window=4,
        num_heads=4))


def _port_policy(kind):
    default = Default(obs_shape=OBS, action_space=spaces.Discrete(ACT),
        hidden_size=HIDDEN)
    if kind == 'default':
        return Policy(default), default_state_dict
    if kind == 'lstm':
        return RecurrentPolicy(LSTMWrapper(default, obs_shape=OBS,
            input_size=HIDDEN, hidden_size=HIDDEN)), lstm_state_dict
    return TransformerPolicy(TransformerWrapper(default, obs_shape=OBS,
        input_size=HIDDEN, hidden_size=HIDDEN, window=4, num_heads=4)), \
        transformer_state_dict


def _init(jpolicy, kind, seed):
    obs = jnp.zeros((1,) + OBS, jnp.float32)
    if kind == 'default':
        return jpolicy.init(jax.random.PRNGKey(seed), obs)
    return jpolicy.init(jax.random.PRNGKey(seed), obs,
        jpolicy.initial_state(1))


def _jax_uniforms(key, num_policies, rows):
    """The uniforms the JAX pool's policy p draws: its key is split(key,
    P)[p], which sample_logits splits once more for its one component."""
    return [np.array(jax.random.uniform(jax.random.split(k, 1)[0],
        (rows,), dtype=jnp.float32))
        for k in jax.random.split(key, num_policies)]


@pytest.mark.parametrize('partial', [False, True])
@pytest.mark.parametrize('kind', ['default', 'lstm', 'transformer'])
def test_pool_matches_jax(kind, partial):
    jpolicy = _jax_policy(kind)
    params = [_init(jpolicy, kind, seed) for seed in (0, 1)]
    jpool = JaxPolicyPool(jpolicy, params, learner_mask=[True, False],
        num_agents=AGENTS)
    policy, convert = _port_policy(kind)
    pool = PolicyPool(policy, [{f'module.{k}': v for k, v in convert(
        jax.tree.map(np.asarray, p)).items()} for p in params],
        learner_mask=[True, False], num_agents=AGENTS)
    np.testing.assert_array_equal(pool.learner_agent_mask.numpy(),
        np.asarray(jpool.learner_agent_mask))
    np.testing.assert_array_equal(pool.policy_map.numpy(),
        np.asarray(jpool.policy_map))

    rng = np.random.RandomState(3)
    agent_ids = np.array([5, 0, 3, 2]) if partial else None
    rows = AGENTS if agent_ids is None else len(agent_ids)
    obs = rng.randn(rows, *OBS).astype(np.float32)
    state = None
    if kind != 'default':
        lead = 1 if kind == 'lstm' else 4
        state = (rng.randn(lead, rows, HIDDEN).astype(np.float32),
            rng.randn(1, rows, HIDDEN).astype(np.float32))
    key = jax.random.PRNGKey(7)
    jout = jpool.forward(jnp.asarray(obs), None if state is None
        else tuple(map(jnp.asarray, state)), key=key, agent_ids=agent_ids)
    u = [torch.from_numpy(x) for x in _jax_uniforms(key, 2, rows)]
    with torch.no_grad():
        out = pool.forward(torch.from_numpy(obs), None if state is None
            else tuple(map(torch.from_numpy, state)), agent_ids=agent_ids,
            u=u)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jout[0]))
    for got, want, atol in zip(out[1:4], jout[1:4], (1e-6, 1e-6, 1e-5)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
            atol=atol)
    if kind == 'default':
        assert out[4] is None and jout[4] is None
        return
    for got, want in zip(out[4], jout[4]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
            atol=1e-6)
    # both policies must show in the routed rows
    pmap = np.asarray(jpool.policy_map)[agent_ids if partial
        else np.arange(AGENTS)]
    assert set(pmap.tolist()) == {0, 1}


def _biased(policy, logit0):
    """The policy's state_dict with its fused head [logit_0, logit_1,
    logit_2, value] cleared and biased toward action 0 or 1."""
    state = {k: v.clone() for k, v in policy.state_dict().items()}
    state['module.head.weight'].zero_()
    state['module.head.bias'].copy_(torch.tensor([logit0, -logit0, -50.0,
        0.0]))
    return state


def test_pool_routes_by_policy_map():
    """The reference's contract (tests/test_selfplay.py): agents of the
    cycle selector's policy 0 act 0, those of policy 1 act 1; agent_ids
    routes a partial batch; a full batch of the wrong size is refused."""
    policy = Policy(Default(obs_shape=(4,), action_space=spaces.Discrete(3),
        hidden_size=8, generator=torch.Generator().manual_seed(0)))
    pool = PolicyPool(policy, [_biased(policy, 50.0), _biased(policy, -50.0)],
        learner_mask=[True, False], num_agents=6,
        policy_selector=cycle_selector)
    generator = torch.Generator().manual_seed(1)
    actions, *_, state = pool.forward(torch.zeros(6, 4), generator=generator)
    assert actions.tolist() == [0, 1, 0, 1, 0, 1] and state is None
    assert pool.learner_agent_mask.tolist() == [True, False] * 3
    actions, *_ = pool.forward(torch.zeros(3, 4), generator=generator,
        agent_ids=[3, 4, 1])
    assert actions.tolist() == [1, 0, 1]
    with pytest.raises(ValueError, match='agent_ids'):
        pool.forward(torch.zeros(4, 4), generator=generator)
    pool.update_params(1, _biased(policy, 50.0))
    actions, *_ = pool.forward(torch.zeros(6, 4), generator=generator)
    assert actions.tolist() == [0] * 6


def test_store_lists_and_loads_checkpoints(tmp_path):
    """PolicyStore over a trainer's checkpoint directory: the model_*.pt
    files training/checkpoint.py writes (not trainer_state.pt), each the
    policy's state_dict; a pickled module or a dict of other objects is
    refused with an APIUsageError (a reference checkpoint comes back
    converted: tests/test_torch_frameworks.py)."""
    vecenv = vector.make(env_creator('squared'), num_envs=4, device='cpu')
    policy = Policy(Default(obs_shape=vecenv.single_observation_space.shape,
        action_space=vecenv.single_action_space, hidden_size=8))
    data = ppo.create(ppo.default_config(batch_size=32, minibatch_size=16,
        bptt_horizon=4, device='cpu', verbose=False, data_dir=str(tmp_path)),
        vecenv, policy)
    path = checkpoint.save_checkpoint(data)
    data.epoch = 3
    checkpoint.save_checkpoint(data)
    store = PolicyStore(os.path.dirname(path))
    assert store.policy_names() == ['model_000000', 'model_000003']
    loaded = store.get_policy('model_000003')
    want = policy.state_dict()
    assert sorted(loaded) == sorted(want)
    for k, v in want.items():
        assert torch.equal(loaded[k], v), k

    torch.save(torch.nn.Linear(2, 2), str(tmp_path / 'model_000009.pt'))
    torch.save({'step': 3}, str(tmp_path / 'model_000010.pt'))
    other = PolicyStore(str(tmp_path))
    assert other.policy_names() == ['model_000009', 'model_000010']
    for name in other.policy_names():
        with pytest.raises(APIUsageError, match='holds no policy state_dict'):
            other.get_policy(name)


def test_ranker_matches_jax(tmp_path):
    for a, b, s in ((1000.0, 1000.0, 1.0), (1100.0, 950.0, 0.0),
            (870.5, 1203.25, 0.5)):
        assert win_prob(a, b) == jax_win_prob(a, b)
        assert update_elo(a, b, s) == jax_update_elo(a, b, s)
    ours = Ranker(str(tmp_path / 'port.sqlite'))
    theirs = JaxRanker(str(tmp_path / 'jax.sqlite'))
    rounds = [{'a': 1.0, 'b': 0.0}, {'a': 0.5, 'b': 0.5, 'c': 0.7},
        {'anchor': 0.2, 'a': 0.9, 'c': 0.1}, {'b': 1.0, 'c': 1.0}]
    for scores in rounds:
        assert ours.update(scores) == theirs.update(scores)
    assert ours.ratings() == theirs.ratings()
    assert ours.ratings()['anchor'] == 1000.0
    ratings = ours.ratings()
    ours.close()
    theirs.close()
    again = Ranker(str(tmp_path / 'port.sqlite'))
    assert again.ratings() == ratings
    games = dict(again.conn.execute('SELECT name, games FROM ratings'))
    assert games == {'a': 3, 'b': 3, 'c': 3, 'anchor': 1}
    again.close()


def test_selfplay_example_on_the_cpu(tmp_path):
    proc = subprocess.run([sys.executable, 'examples/selfplay_torch.py',
        '--device', 'cpu', '--store', str(tmp_path)], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "opponents in store: ['model_000000']" in proc.stdout
    assert 'elo:' in proc.stdout
    assert (tmp_path / 'ratings.sqlite').exists()
