"""The port's dashboard (pufferlib_tpu_torch.training.dashboard) against
the JAX package's: abbreviate, duration and print_dashboard's text equal
exactly; the hook reads the trainer's fields; the utilization sampler's
device gauge reads the card's memory, 0 for a CPU trainer."""
import time
from collections import deque

import numpy as np
import pytest
import torch

from pufferlib_tpu.training import dashboard as jdashboard

from pufferlib_tpu_torch.namespace import namespace
from pufferlib_tpu_torch.training import dashboard

torch.set_num_threads(1)

NUMBERS = [0, 0.4, 1, 950, 999.9, 1000, 12_345, 999_999, 1_000_000,
    42_000_000, 3_200_000_000, 7.5e12, 1e15]
SECONDS = [0, 0.9, 5, 59, 60, 61, 120, 3599, 3600, 3661, 7200, 86_400 * 3]


def test_abbreviate_matches_jax():
    for num in NUMBERS:
        assert dashboard.abbreviate(num) == jdashboard.abbreviate(num), num


def test_duration_matches_jax():
    for seconds in SECONDS:
        assert dashboard.duration(seconds) == jdashboard.duration(seconds), \
            seconds


def _utilization():
    # fixed gauges: the sampler thread's readings are the host's
    return namespace(cpu_util=deque([12.5, 37.5]), cpu_mem=deque([40.0]),
        device_mem=deque([10.0, 20.0]))


def _profile():
    return namespace(SPS=1.2e7, uptime=125.0, remaining=600.0,
        eval_time=10.0, eval_forward_time=6.0, env_time=2.0,
        eval_misc_time=2.0, train_time=20.0, train_forward_time=8.0,
        learn_time=10.0, train_misc_time=2.0)


def _render(module, capsys, **kwargs):
    module.print_dashboard('squared', _utilization(), 1_234_567, 42,
        _profile(), {'policy_loss': 0.12, 'value_loss': 0.5,
            'entropy': 1.1},
        {'score': 0.93, 'episode_return': 4.2, 'Media/map': object()},
        msg='hello world', **kwargs)
    return capsys.readouterr().out


@pytest.mark.parametrize('clear', [False, True])
def test_print_dashboard_matches_jax(capsys, monkeypatch, clear):
    monkeypatch.setenv('COLUMNS', '200')
    out = _render(dashboard, capsys, clear=clear, max_stats=[0])
    want = _render(jdashboard, capsys, clear=clear, max_stats=[0])
    assert out == want
    assert 'squared' in out and 'hello world' in out
    assert 'policy_loss' in out and 'score' in out
    assert 'Media/map' not in out  # not a number: skipped


def test_dashboard_hook_reads_the_trainer(capsys, monkeypatch):
    monkeypatch.setenv('COLUMNS', '200')
    data = namespace(config=namespace(env='memory'),
        utilization=_utilization(), global_step=999, epoch=3,
        profile=_profile(), losses={'policy_loss': 0.0},
        stats={'score': 1.0}, msg='')
    dashboard.make_dashboard_hook(clear_first=False)(data)
    out = capsys.readouterr().out
    jdashboard.make_dashboard_hook(clear_first=False)(data)
    assert out == capsys.readouterr().out
    assert 'memory' in out


def test_device_gauge_reads_zero_on_the_cpu():
    assert dashboard.device_memory_fraction(None) == 0.0
    assert dashboard.device_memory_fraction(torch.device('cpu')) == 0.0


def test_device_gauge_reads_the_card(monkeypatch):
    calls = []

    def mem_get_info(device):
        calls.append(device)
        return 3 * 2 ** 30, 4 * 2 ** 30

    monkeypatch.setattr(torch.cuda, 'mem_get_info', mem_get_info)
    card = torch.device('cuda', 0)
    assert dashboard.device_memory_fraction(card) == 0.25
    assert calls == [card]


def test_device_gauge_does_not_hide_a_card_error(monkeypatch):
    def mem_get_info(device):
        raise RuntimeError('CUDA error')

    monkeypatch.setattr(torch.cuda, 'mem_get_info', mem_get_info)
    with pytest.raises(RuntimeError, match='CUDA error'):
        dashboard.device_memory_fraction(torch.device('cuda', 0))


def test_utilization_samples_on_the_cpu():
    u = dashboard.Utilization(delay=0.02, device=torch.device('cpu'))
    deadline = time.time() + 5
    while len(u.device_mem) < 2 and time.time() < deadline:
        time.sleep(0.02)
    u.stop()
    u.join(timeout=5)
    assert not u.is_alive()
    assert len(u.cpu_util) >= 1 and len(u.cpu_mem) >= 1
    assert np.all(np.asarray(u.device_mem) == 0.0)
