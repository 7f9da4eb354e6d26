"""RLlib bridge (counterpart of pufferlib_tpu/frameworks/rllib.py;
reference pufferlib/frameworks/rllib.py:24-141).

- env side: `register_env` puts a puffer env creator into Ray Tune's
  registry (PettingZoo envs wrapped as ParallelPettingZooEnv, gymnasium
  ones as host_env.GymnasiumAdapter, since RLlib isinstance-checks the
  gymnasium contract); `read_checkpoints` / `create_policies`.
- model side: `make_policy` adapts the port's own policy modules, which
  are nn.Modules already, to RLlib's custom model interface: it wraps
  them and converts nothing. A feed-forward module returns (logits,
  value) from forward; a recurrent one is the port's LSTMWrapper (or a
  RecurrentPolicy around it), which takes and gives (h, c) as
  (num_layers, B, hidden_size) where RLlib keeps (B, num_layers,
  hidden_size).

ray is imported inside each function: it is not installed here.
"""
import os


def _pettingzoo_like(env):
    return hasattr(env, 'possible_agents')


def register_env(name, env_creator):
    """Register a puffer env creator with Ray Tune (ref rllib.py:27-29)."""
    if not isinstance(name, str):
        raise TypeError('Name must be a str')
    from ray.tune.registry import register_env as tune_register_env

    def make(config):
        env = env_creator()
        if _pettingzoo_like(env):
            from ray.rllib.env import ParallelPettingZooEnv
            return ParallelPettingZooEnv(env)
        from pufferlib_tpu_torch.host_env import (
            GymnasiumAdapter, GymnasiumPufferEnv)
        if isinstance(env, GymnasiumPufferEnv):
            return GymnasiumAdapter(env)
        return env

    tune_register_env(name, make)


def read_checkpoints(tune_path):
    """Checkpoints of the single trial under `tune_path`
    (ref rllib.py:31-48)."""
    folders = sorted(f.path for f in os.scandir(tune_path) if f.is_dir())
    if len(folders) > 1:
        raise ValueError('Tune folder contains multiple trials')
    if not folders:
        return []
    from ray.train.rl import RLCheckpoint
    out = []
    for f in sorted(os.listdir(folders[0])):
        if f.startswith('checkpoint'):
            path = os.path.join(folders[0], f)
            out.append([f, RLCheckpoint(path)])
    return out


def create_policies(n, observation_space=None, action_space=None,
        config=None):
    """n named PolicySpecs for multi-policy training
    (ref rllib.py:50-57)."""
    from ray.rllib.policy.policy import PolicySpec
    return {f'policy_{i}': PolicySpec(
        policy_class=None,
        observation_space=observation_space,
        action_space=action_space,
        config=dict(config or {}),
    ) for i in range(n)}


def _flat_logits(logits):
    """RLlib's MultiCategorical reads the decoders' logits side by side."""
    import torch
    return torch.cat(logits, dim=-1) if isinstance(logits, (list, tuple)) \
        else logits


def make_policy(policy_cls, lstm_layers=0):
    """An RLlib custom model class over `policy_cls(**kwargs)`, a port
    module: with lstm_layers == 0 a TorchModelV2 whose forward runs the
    feed-forward module (Default, a zoo Policy, or Policy around one);
    else a RecurrentNetwork whose forward_rnn runs the LSTMWrapper (or
    RecurrentPolicy). The module is a submodule (`self.net`), so its
    parameters are the adapter's. Positional args go to the RLlib base
    (obs_space, action_space, num_outputs, model_config, name); kwargs to
    policy_cls. value_function() is the value of the last forward,
    flattened."""
    import torch

    recurrent = lstm_layers > 0
    if recurrent:
        from ray.rllib.models.torch.recurrent_net import (
            RecurrentNetwork as _Base)
    else:
        from ray.rllib.models.torch.torch_modelv2 import (
            TorchModelV2 as _Base)

    class _PufferAdapter(_Base, torch.nn.Module):
        def __init__(self, *rllib_args, **policy_kwargs):
            torch.nn.Module.__init__(self)
            _Base.__init__(self, *rllib_args)
            self.net = policy_cls(**policy_kwargs)
            self._value_out = None

        def _inner(self):
            # Policy / RecurrentPolicy hold the module as .module
            return getattr(self.net, 'module', self.net)

        def value_function(self):
            return torch.reshape(self._value_out, (-1,))

    if recurrent:

        class PufferRLlibRecurrentModel(_PufferAdapter):
            def get_initial_state(self, batch_size=1):
                lstm = self._inner()
                dims = (lstm.num_layers, lstm.hidden_size)
                return [torch.zeros(dims), torch.zeros(dims)]

            def forward_rnn(self, inputs, state, seq_lens):
                B, T = inputs.shape[:2]
                h, c = (s.transpose(0, 1).contiguous() for s in state)
                logits, value, (h, c) = self._inner()(inputs, (h, c))
                self._value_out = value
                return (_flat_logits(logits).reshape(B, T, -1),
                    [h.transpose(0, 1), c.transpose(0, 1)])

        return PufferRLlibRecurrentModel

    class PufferRLlibModel(_PufferAdapter):
        def forward(self, input_dict, state, seq_lens):
            logits, value = self._inner()(input_dict['obs'])
            self._value_out = value
            return _flat_logits(logits), state

    return PufferRLlibModel
