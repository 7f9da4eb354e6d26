"""bench_torch.py's output contract on the CPU (BENCH_SMOKE=1, a small
size): one JSON line per metric with bench.py's four keys plus `device`,
the headline (ocean_squared_ppo_sps) last, the conv line under
BENCH_ONLY=conv; the MLP minibatch rule; and without a card, a
non-smoke run fails instead of measuring the CPU."""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch  # noqa: E402

KEYS = {'metric', 'value', 'unit', 'vs_baseline', 'device'}
DEVICE_KEYS = {'card', 'cpu_count', 'loadavg_before', 'loadavg_after',
    'window_s', 'process_cpu_s'}


def _run(**env):
    env = dict(os.environ, OMP_NUM_THREADS='2', **env)
    return subprocess.run([sys.executable, 'bench_torch.py'],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)


def _lines(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(l) for l in proc.stdout.splitlines() if l.strip()]


@pytest.mark.parametrize('only,metrics', [
    (None, ['ocean_squared_ppo_lstm_sps', 'ocean_squared_ppo_sps']),
    ('conv', ['ocean_visual_ppo_conv_lstm_sps']),
])
def test_smoke_lines(only, metrics):
    env = {'BENCH_SMOKE': '1'}
    if only:
        env['BENCH_ONLY'] = only
    lines = _lines(_run(**env))
    assert [r['metric'] for r in lines] == metrics
    for rec in lines:
        assert set(rec) == KEYS, rec
        assert rec['unit'] == 'steps/s' and rec['value'] > 0
        assert rec['vs_baseline'] == round(rec['value'] / 1e7, 4)
        assert set(rec['device']) == DEVICE_KEYS
        assert rec['device']['card'] == 'cpu'
        assert rec['device']['cpu_count'] == os.cpu_count()
        assert len(rec['device']['loadavg_before']) == 3
        assert rec['device']['window_s'] > 0
        assert rec['device']['process_cpu_s'] > 0


def test_without_a_card_the_bench_fails():
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    proc = _run(BENCH_ONLY='mlp')
    assert proc.returncode != 0
    assert 'cuda' in proc.stderr and not proc.stdout.strip()


def test_mlp_minibatch(monkeypatch):
    monkeypatch.delenv('BENCH_MINIBATCH', raising=False)
    # bench.py's minibatch at hidden 128 at both widths, and its smoke's
    assert bench_torch.mlp_minibatch(8192 * 64, 16) == 131072
    assert bench_torch.mlp_minibatch(32768 * 64, 16) == 131072
    assert bench_torch.mlp_minibatch(64 * 16, 16) == 256
    monkeypatch.setenv('BENCH_MINIBATCH', '65536')
    assert bench_torch.mlp_minibatch(32768 * 64, 16) == 65536
    monkeypatch.setenv('BENCH_MINIBATCH', '100000')
    with pytest.raises(ValueError, match='divide'):
        bench_torch.mlp_minibatch(32768 * 64, 16)
