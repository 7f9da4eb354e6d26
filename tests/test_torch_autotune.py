"""The port's host autotune (vector_host.profile_env, _candidate_configs,
autotune; reference vector.py:669-854) against the JAX package's:
the candidate strategies equal exactly over a grid of inputs, the
single-env profile reads the same diagnostics, and autotune benchmarks
and picks a configuration end to end."""
import itertools

import numpy as np
import pytest

from pufferlib_tpu import vector_host as jvector_host

from pufferlib_tpu_torch import vector_host
from pufferlib_tpu_torch.environments.test.host_fixtures import (
    GymnasiumPerformanceEnv)
from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv


def _delay_env():
    return GymnasiumPufferEnv(env=GymnasiumPerformanceEnv(
        delay_mean=0.0002, delay_std=0))


def _named(configs):
    return [{k: (v.__name__ if k == 'backend' else v) for k, v in c.items()}
        for c in configs]


GRID = list(itertools.product((1, 2, 4, 6, 8), (4, 16, 24, 64),
    (1, 2, 3, 4, 8), (0.1, 1.0)))


def test_candidate_configs_match_jax():
    for batch_size, max_envs, cores, throughput in GRID:
        got = vector_host._candidate_configs(batch_size, max_envs, cores,
            throughput)
        want = jvector_host._candidate_configs(batch_size, max_envs, cores,
            throughput)
        assert _named(got) == _named(want), (batch_size, max_envs, cores,
            throughput)
        assert all(c['backend'] in (vector_host.HostSerial,
            vector_host.HostMultiprocessing) for c in got)


def test_profile_env_diagnostics():
    prof = vector_host.profile_env(_delay_env, time_per_test=0.4)
    assert set(prof) == set(jvector_host.profile_env(
        _delay_env, time_per_test=0.1))
    # a 0.2 ms busy-spin a step: hundreds to thousands of steps/s
    assert 100 < prof.sps < 50_000
    assert prof.step_std_pct >= 0
    assert 0 <= prof.reset_pct < 100
    assert prof.ram_gb_per_env > 0
    assert prof.obs_size_gb == 4 / 1e9  # (1,) float32
    assert np.isclose(prof.bandwidth_gbs, prof.obs_size_gb * prof.sps)
    assert np.isclose(prof.throughput_gbs, prof.bandwidth_gbs
        * prof.num_cores)


def test_autotune_end_to_end(capsys):
    out = vector_host.autotune(_delay_env, batch_size=2, max_envs=4,
        time_per_config=0.4, max_configs=3)
    assert out is not None and out.best_sps > 0
    assert out.best['num_envs'] >= 2
    assert 1 <= len(out.results) <= 3
    assert 'Best:' in capsys.readouterr().out


def test_autotune_refuses_a_batch_past_max_envs():
    with pytest.raises(vector_host.APIUsageError):
        vector_host.autotune(_delay_env, batch_size=8, max_envs=4,
            time_per_config=0.1)
