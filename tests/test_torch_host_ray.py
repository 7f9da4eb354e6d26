"""The port's HostRay (vector_host.HostRay; reference vector.py:449-574)
against a fake, synchronous ray, as tests/test_host_ray.py drives the
JAX package's: the same counter env through the port's HostRay, the
port's HostSerial and the JAX package's HostRay gives the same obs,
rewards and terminals; in env-pool mode (batch_size < num_envs) ray.wait
picks the first-ready workers and the agent ids map back to their rows,
as the JAX package's do. ray is not installed here."""
import sys
import types

import numpy as np
import pytest

gymnasium = pytest.importorskip('gymnasium')

from pufferlib_tpu import vector_host as jvector_host
from pufferlib_tpu.host_env import GymnasiumPufferEnv as JaxGymnasiumPufferEnv

from pufferlib_tpu_torch import vector_host
from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv


class _FakeFuture:
    def __init__(self, value, order):
        self.value = value
        self.order = order


class _FakeMethod:
    def __init__(self, method, counter):
        self._method = method
        self._counter = counter

    def remote(self, *args, **kwargs):
        self._counter[0] += 1
        return _FakeFuture(self._method(*args, **kwargs), self._counter[0])


class _FakeActor:
    def __init__(self, obj, counter):
        self._obj = obj
        self._counter = counter

    def __getattr__(self, name):
        return _FakeMethod(getattr(self._obj, name), self._counter)


def _install_fake_ray(monkeypatch):
    counter = [0]
    killed = []

    class RemoteClass:
        def __init__(self, cls):
            self._cls = cls

        def remote(self, *args, **kwargs):
            return _FakeActor(self._cls(*args, **kwargs), counter)

    ray = types.ModuleType('ray')
    ray.is_initialized = lambda: True
    ray.init = lambda **kw: None
    ray.kill = killed.append
    ray.remote = RemoteClass
    ray.get = lambda futures: [f.value for f in futures] \
        if isinstance(futures, list) else futures.value
    ray.wait = lambda futures, num_returns=1: (
        sorted(futures, key=lambda f: f.order)[:num_returns],
        sorted(futures, key=lambda f: f.order)[num_returns:])
    ray.killed = killed
    monkeypatch.setitem(sys.modules, 'ray', ray)
    return ray


class CountingEnv(gymnasium.Env):
    """A deterministic counter whose episodes end every 4 steps."""
    observation_space = gymnasium.spaces.Box(0, 1000, (2,), np.float32)
    action_space = gymnasium.spaces.Discrete(2)
    render_mode = None

    def __init__(self):
        self.t = 0

    def reset(self, seed=None, options=None):
        self.t = 0 if seed is None else seed % 5
        return np.array([self.t, 0], np.float32), {}

    def step(self, action):
        self.t += 1
        return (np.array([self.t, float(action)], np.float32),
            float(self.t), self.t % 4 == 0, False, {})


def _creator():
    return GymnasiumPufferEnv(env=CountingEnv())


def _jax_creator():
    return JaxGymnasiumPufferEnv(env=CountingEnv())


def _rollout(vec, steps=7, seed=7):
    obs, _ = vec.reset(seed=seed)
    out = [np.array(obs)]
    rng = np.random.RandomState(0)
    for _ in range(steps):
        o, r, t, tr, _ = vec.step(rng.randint(0, 2, vec.num_agents))[:5]
        out += [np.array(o), np.array(r), np.array(t), np.array(tr)]
    vec.close()
    return out


def test_host_ray_matches_serial_and_jax(monkeypatch):
    ray = _install_fake_ray(monkeypatch)
    got = _rollout(vector_host.make(_creator, num_envs=4,
        backend=vector_host.HostRay))
    assert len(ray.killed) == 4
    serial = _rollout(vector_host.make(_creator, num_envs=4,
        backend=vector_host.HostSerial))
    jax_ray = _rollout(jvector_host.make(_jax_creator, num_envs=4,
        backend=jvector_host.HostRay))
    for a, b, c in zip(got, serial, jax_ray):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_host_ray_env_pool_matches_jax(monkeypatch):
    _install_fake_ray(monkeypatch)
    results = []
    for module, creator in ((vector_host, _creator),
            (jvector_host, _jax_creator)):
        vec = module.make(creator, num_envs=4, num_workers=4, batch_size=2,
            backend=module.HostRay)
        vec.async_reset(seed=0)
        rec = []
        for step in range(5):
            obs, rew, term, trunc, infos, ids, mask = vec.recv()
            assert obs.shape == (2, 2) and len(ids) == 2 and mask.all()
            rec.append((np.array(obs), np.array(rew), np.array(ids)))
            vec.send(np.full(2, step % 2, np.int64))
        vec.close()
        results.append(rec)
    for (o, r, i), (jo, jr, ji) in zip(*results):
        np.testing.assert_array_equal(o, jo)
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(i, ji)


def test_host_ray_checks_its_geometry(monkeypatch):
    _install_fake_ray(monkeypatch)
    with pytest.raises(vector_host.APIUsageError):
        vector_host.make(_creator, num_envs=4, num_workers=3,
            backend=vector_host.HostRay)


def test_host_ray_names_ray_when_absent(monkeypatch):
    monkeypatch.setitem(sys.modules, 'ray', None)
    with pytest.raises(ImportError, match='ray'):
        vector_host.make(_creator, num_envs=2, backend=vector_host.HostRay)
