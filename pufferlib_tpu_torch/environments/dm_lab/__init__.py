"""DeepMind Lab binding (counterpart of
pufferlib_tpu/environments/dm_lab/__init__.py; reference
pufferlib/environments/dm_lab/environment.py, which goes dm_lab ->
shimmy DmLabCompatibilityV0; here the adapter is first-party, on the
port's spaces: RGB_INTERLEAVED observations and the standard IMPALA
discrete action set). make needs deepmind_lab, which is not installed
here: it raises.
"""
import functools

import numpy as np

# the IMPALA dm-lab action set: (look_lr, look_ud, strafe, move,
# fire, jump, crouch) raw action vectors per discrete action
ACTION_SET = np.array([
    (0, 0, 0, 1, 0, 0, 0),    # forward
    (0, 0, 0, -1, 0, 0, 0),   # backward
    (0, 0, -1, 0, 0, 0, 0),   # strafe left
    (0, 0, 1, 0, 0, 0, 0),    # strafe right
    (-20, 0, 0, 0, 0, 0, 0),  # look left
    (20, 0, 0, 0, 0, 0, 0),   # look right
    (-20, 0, 0, 1, 0, 0, 0),  # forward + look left
    (20, 0, 0, 1, 0, 0, 0),   # forward + look right
    (0, 0, 0, 0, 1, 0, 0),    # fire
], dtype=np.intc)


class DmLabToGymnasium:
    """deepmind_lab.Lab -> gymnasium adapter: RGB_INTERLEAVED frames,
    Discrete(len(ACTION_SET)) actions, 4-frame action repeat."""

    def __init__(self, lab, width=96, height=72, action_repeat=4):
        from pufferlib_tpu_torch import spaces
        self._lab = lab
        self._action_repeat = action_repeat
        self.observation_space = spaces.Box(
            0, 255, (height, width, 3), np.uint8)
        self.action_space = spaces.Discrete(len(ACTION_SET))
        self.render_mode = None

    def _obs(self):
        return np.asarray(
            self._lab.observations()['RGB_INTERLEAVED'], np.uint8)

    def reset(self, seed=None, options=None):
        self._lab.reset(seed=seed)
        return self._obs(), {}

    def step(self, action):
        raw = ACTION_SET[int(action)]
        reward = self._lab.step(raw, num_steps=self._action_repeat)
        done = not self._lab.is_running()
        if done:
            self._lab.reset()
        return self._obs(), float(reward), done, False, {}

    def close(self):
        self._lab.close()


def env_creator(name='seekavoid_arena_01'):
    return functools.partial(make, name)


def wrap(lab, width=96, height=72):
    """The binding's stack over a deepmind_lab.Lab: DmLabToGymnasium,
    EpisodeStats, GymnasiumPufferEnv."""
    from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv
    from pufferlib_tpu_torch.postprocess import EpisodeStats
    env = DmLabToGymnasium(lab, width=width, height=height)
    return GymnasiumPufferEnv(env=EpisodeStats(env))


def make(name='seekavoid_arena_01', width=96, height=72,
        render_mode=None):
    try:
        import deepmind_lab
    except ImportError as e:
        raise ImportError('deepmind_lab is not installed') from e
    lab = deepmind_lab.Lab(name, ['RGB_INTERLEAVED'],
        config={'width': str(width), 'height': str(height)})
    return wrap(lab, width=width, height=height)
