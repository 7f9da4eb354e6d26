"""Headline benchmark of pufferlib_tpu_torch: PPO throughput on Ocean
`squared`, on one NVIDIA GPU (counterpart of bench.py).

    python3 bench_torch.py                  # the three lines below
    BENCH_ONLY=mlp|lstm|conv|scaling|transformer python3 bench_torch.py
    BENCH_SMOKE=1 python3 bench_torch.py    # the CPU, a small size

Measures end-to-end env steps/s of the fused trainer (rollout, GAE and
the PPO update, all on the card): squared (distance 3, one target),
Default hidden 128 in bf16 with the rollout's observations stored in
bf16. Each line builds its trainer, runs a warm-up chunk of BENCH_CHUNK
(10) epochs, then times BENCH_EPOCHS (200) epochs in chunks of
BENCH_CHUNK through ppo.step_many, ending in torch.cuda.synchronize.

Prints one JSON line per metric, in this order:
  ocean_squared_ppo_sps_8k_lanes   8192 lanes x 64 steps
  ocean_squared_ppo_lstm_sps       the same through LSTMWrapper(128)
                                   (the enc5 kernels), minibatch batch/4
  ocean_squared_ppo_sps            the headline, 32768 lanes x 64, last
and with BENCH_ONLY=conv only ocean_visual_ppo_conv_lstm_sps
(VisualTarget through Convolutional + LSTMWrapper(128) in bf16, the
resident cat kernels), with BENCH_ONLY=transformer only
ocean_squared_ppo_transformer_sps (the same squared through
TransformerWrapper(128) in BENCH_DTYPE: window 16, 4 heads, ffn_mult 2;
100 epochs by default, minibatch batch / 4). Each line has bench.py's
keys (metric, value, unit, vs_baseline) and `device`: the card's name
and power limit as nvidia-smi reports them, the host's CPU count, its
load average before and after the timed window, the window's seconds and
this process's CPU seconds in it (the trainers wait on the host).

The MLP lines' minibatch is BENCH_MINIBATCH rows (131072), capped at a
quarter of the batch: bench.py's minibatch at hidden 128 at both widths,
so that each line does the reference line's PPO work per epoch. It is
checked against ppo.create's contracts and printed to stderr.

On a machine with two or more cards the lines of bench.py's run_scaling
print before the headline: `ocean_squared_scaling_eff_{n}dev` for each n
in BENCH_SCALING_DEVICES ('2 4 8') up to the card count, the weak-scaling
efficiency of tools/bench_scaling_torch.py (one NCCL rank a card, 256
lanes a card x 32 steps, 5 epochs; the best of BENCH_SCALING_ATTEMPTS,
2), each with `device` as the other lines: its window is the child
process's whole run (every width, builds included), its CPU seconds all
ranks' together. With fewer cards no scaling line prints and stderr says why;
BENCH_ONLY=scaling then exits non-zero. The conv and transformer lines
are opt-in, as in bench.py. Without a card the script raises, unless
BENCH_SMOKE=1.
"""
import json
import os
import sys
import tempfile
import time

BASELINE_SPS = 10_000_000.0


def device_record(card, window):
    return {
        'card': card,
        'cpu_count': os.cpu_count(),
        'loadavg_before': list(window['load_before']),
        'loadavg_after': list(window['load_after']),
        'window_s': window['seconds'],
        'process_cpu_s': window['cpu_seconds'],
    }


def card_line(device):
    """nvidia-smi's name and power limit of the card, 'cpu' on the CPU."""
    if device.type != 'cuda':
        return 'cpu'
    from pufferlib_tpu_torch.ops.cuda import timing
    return timing.card_line()


def mlp_minibatch(batch_size, horizon):
    """The MLP lines' minibatch (rows), checked against ppo.create's
    divisibility contracts."""
    rows = min(int(os.environ.get('BENCH_MINIBATCH', 131072)),
        batch_size // 4)
    if rows <= 0 or batch_size % rows or rows % horizon:
        raise ValueError(f'BENCH_MINIBATCH {rows} must divide the batch '
            f'{batch_size} and be a multiple of bptt_horizon {horizon}')
    return rows


def timed_window(data, device, epochs, chunk):
    """(steps/s, window) of ppo.step_many over `epochs` epochs in chunks
    of `chunk`, after a warm-up chunk; the window ends when the card has
    finished. window: the host's load average before and after, the
    window's seconds and this process's CPU seconds in it (near the
    window's, one host thread is busy all the time)."""
    import torch
    from pufferlib_tpu_torch.training import ppo

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    ppo.step_many(data, chunk)
    sync()
    reps = max(epochs // chunk, 1)
    load_before = os.getloadavg()
    cpu = time.process_time()
    start = time.perf_counter()
    for _ in range(reps):
        ppo.step_many(data, chunk)
    sync()
    elapsed = time.perf_counter() - start
    window = dict(load_before=load_before, load_after=os.getloadavg(),
        seconds=elapsed, cpu_seconds=time.process_time() - cpu)
    return reps * chunk * data.config.batch_size / elapsed, window


def line(metric, sps, card, window):
    return {
        'metric': metric,
        'value': round(sps, 1),
        'unit': 'steps/s',
        'vs_baseline': round(sps / BASELINE_SPS, 4),
        'device': device_record(card, window),
    }


def trainer_config(ppo, env, batch_size, minibatch_size, device,
        bf16_obs):
    return ppo.default_config(
        env=env,
        batch_size=batch_size,
        minibatch_size=minibatch_size,
        bptt_horizon=16,
        # done_training (a checkpoint, the metrics' read) never fires in
        # the window
        total_timesteps=batch_size * 1_000_000,
        anneal_lr=False,
        obs_store_dtype='bfloat16' if bf16_obs else None,
        verbose=False,
        data_dir=os.path.join(tempfile.gettempdir(), 'puffer_torch_bench'),
        checkpoint_interval=1_000_000,
        device=device,
    )


def run_one(recurrent, smoke, num_envs=None, metric_suffix=''):
    """bench.py's run_one (bench.py:25-108) on the port, and with
    recurrent='transformer' its run_transformer (bench.py:166-220): the
    policy is Default alone (recurrent None), inside LSTMWrapper ('lstm'),
    or inside TransformerWrapper ('transformer': window 16, 4 heads,
    ffn_mult 2). Both recurrent lines take bptt 16 and minibatch batch / 4."""
    import torch
    import pufferlib_tpu_torch.vector as vector
    from pufferlib_tpu_torch import resolve_device
    from pufferlib_tpu_torch.models import (Default, LSTMWrapper, Policy,
        RecurrentPolicy, TransformerPolicy, TransformerWrapper)
    from pufferlib_tpu_torch.ocean import env_creator
    from pufferlib_tpu_torch.training import ppo

    transformer = recurrent == 'transformer'
    device = resolve_device('cpu' if smoke else 'cuda')
    if smoke:
        num_envs = 32 if transformer else 64
        horizon, hidden, epochs = 16, 64, 3
    else:
        if num_envs is None:
            num_envs = int(os.environ.get('BENCH_NUM_ENVS', 8192))
        horizon = int(os.environ.get('BENCH_HORIZON', 64))
        hidden = int(os.environ.get('BENCH_HIDDEN', 128))
        epochs = int(os.environ.get('BENCH_EPOCHS',
            100 if transformer else 200))
    chunk = int(os.environ.get('BENCH_CHUNK', 10))
    card = card_line(device)

    batch_size = num_envs * horizon
    vecenv = vector.make(env_creator('squared'),
        env_kwargs=dict(distance_to_target=3, num_targets=1),
        num_envs=num_envs, device=device)
    dtype = getattr(torch, os.environ.get('BENCH_DTYPE', 'bfloat16'))
    obs_shape = vecenv.single_observation_space.shape
    module = Default(obs_shape=obs_shape,
        action_space=vecenv.single_action_space, hidden_size=hidden,
        dtype=dtype, generator=torch.Generator().manual_seed(0))
    metric = {None: 'ocean_squared_ppo_sps',
        'lstm': 'ocean_squared_ppo_lstm_sps',
        'transformer': 'ocean_squared_ppo_transformer_sps'}[recurrent]
    metric += metric_suffix
    generator = torch.Generator().manual_seed(1)
    if recurrent is None:
        policy = Policy(module)
        minibatch_size = mlp_minibatch(batch_size, 16)
    else:
        if transformer:
            policy = TransformerPolicy(TransformerWrapper(module,
                obs_shape=obs_shape, input_size=hidden, hidden_size=hidden,
                window=16, num_heads=4, ffn_mult=2, dtype=dtype,
                generator=generator))
        else:
            policy = RecurrentPolicy(LSTMWrapper(module, obs_shape=obs_shape,
                input_size=hidden, hidden_size=hidden, dtype=dtype,
                generator=generator))
        # num_minibatches == T // bptt_horizon: time-slab minibatches
        minibatch_size = batch_size // 4
    print(f'bench_torch: {metric}: {num_envs} lanes x {horizon}, batch '
        f'{batch_size}, minibatch {minibatch_size}, {device}', file=sys.stderr,
        flush=True)
    data = ppo.create(trainer_config(ppo, 'squared', batch_size,
        minibatch_size, device, dtype == torch.bfloat16), vecenv, policy)
    sps, window = timed_window(data, device, epochs, chunk)
    vecenv.close()
    return line(metric, sps, card, window)


def run_conv(smoke=False):
    """bench.py's run_conv (bench.py:111-164): VisualTarget pixels (uint8
    NCHW) through Convolutional + LSTMWrapper(128) in bf16, the resident
    cat kernels (Convolutional has no encoder contract)."""
    import torch
    import pufferlib_tpu_torch.vector as vector
    from pufferlib_tpu_torch import resolve_device
    from pufferlib_tpu_torch.models import (
        Convolutional, LSTMWrapper, RecurrentPolicy)
    from pufferlib_tpu_torch.ocean import env_creator
    from pufferlib_tpu_torch.training import ppo

    device = resolve_device('cpu' if smoke else 'cuda')
    if smoke:
        num_envs, horizon, epochs = 32, 16, 3
    else:
        num_envs = int(os.environ.get('BENCH_NUM_ENVS', 4096))
        horizon = int(os.environ.get('BENCH_HORIZON', 64))
        epochs = int(os.environ.get('BENCH_EPOCHS', 50))
    chunk = int(os.environ.get('BENCH_CHUNK', 5))
    card = card_line(device)
    batch_size = num_envs * horizon
    vecenv = vector.make(env_creator('visual'), num_envs=num_envs,
        device=device)
    obs_shape = vecenv.single_observation_space.shape
    module = Convolutional(vecenv.single_action_space, framestack=2,
        flat_size=64, hidden_size=128, dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(0))
    policy = RecurrentPolicy(LSTMWrapper(module, obs_shape=obs_shape,
        input_size=128, hidden_size=128, dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(1)))
    data = ppo.create(trainer_config(ppo, 'visual', batch_size,
        batch_size // 4, device, False), vecenv, policy)
    sps, window = timed_window(data, device, epochs, chunk)
    vecenv.close()
    return line('ocean_visual_ppo_conv_lstm_sps', sps, card, window)


def scaling_devices(cards):
    """The widths of the scaling lines: BENCH_SCALING_DEVICES up to
    `cards`, none with fewer than two cards."""
    widths = [int(d) for d in os.environ.get('BENCH_SCALING_DEVICES',
        '2 4 8').split()]
    return [n for n in widths if 2 <= n <= cards] if cards >= 2 else []


def run_scaling(cards):
    """bench.py's run_scaling (bench.py:223-270) on the port: the lines
    `ocean_squared_scaling_eff_{n}dev` from tools/bench_scaling_torch.py
    in a child process, the best of BENCH_SCALING_ATTEMPTS runs a
    width."""
    import subprocess
    devices = scaling_devices(cards)
    if not devices:
        return []
    attempts = int(os.environ.get('BENCH_SCALING_ATTEMPTS', 2))
    best, windows = {}, {}
    for _ in range(max(attempts, 1)):
        load_before = os.getloadavg()
        cpu = _children_cpu_seconds()
        start = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), 'tools',
            'bench_scaling_torch.py'), '--devices', '1',
            *[str(d) for d in devices], '--envs-per-dev', '256',
            '--horizon', '32', '--epochs', '5'], capture_output=True,
            text=True, timeout=2400)
        if proc.returncode:
            raise RuntimeError('tools/bench_scaling_torch.py exited '
                f'{proc.returncode}: {proc.stderr[-2000:]}')
        window = dict(load_before=load_before, load_after=os.getloadavg(),
            seconds=time.perf_counter() - start,
            cpu_seconds=_children_cpu_seconds() - cpu)
        for text in proc.stdout.splitlines():
            rec = json.loads(text)
            n = rec.get('devices')
            if n in devices and rec['scaling_efficiency'] > best.get(n, 0):
                best[n] = rec['scaling_efficiency']
                windows[n] = window
        if len(best) == len(devices) and min(best.values()) >= 0.8:
            break
    from pufferlib_tpu_torch.ops.cuda import timing
    card = timing.card_line()
    return [{
        'metric': f'ocean_squared_scaling_eff_{n}dev',
        'value': eff,
        'unit': 'x',
        'vs_baseline': round(eff / 0.8, 4),
        'device': device_record(card, windows[n]),
    } for n, eff in sorted(best.items())]


def _children_cpu_seconds():
    """CPU seconds of this process's finished children so far."""
    t = os.times()
    return t.children_user + t.children_system


def main():
    smoke = os.environ.get('BENCH_SMOKE') == '1'
    only = os.environ.get('BENCH_ONLY')
    if only not in (None, 'mlp', 'lstm', 'conv', 'scaling', 'transformer'):
        raise SystemExit(f'BENCH_ONLY={only!r}: expected mlp, lstm, conv, '
            'scaling or transformer')
    if only == 'conv':
        print(json.dumps(run_conv(smoke=smoke)), flush=True)
        return 0
    if only == 'transformer':
        print(json.dumps(run_one('transformer', smoke=smoke)), flush=True)
        return 0
    import torch
    cards = 0 if smoke else torch.cuda.device_count()
    if not scaling_devices(cards):
        why = (f'bench_torch: no scaling line: {cards} card(s) here, the '
            'scaling lines need two or more (one NCCL rank a card)')
        if only == 'scaling':
            raise SystemExit(why)
        print(why, file=sys.stderr, flush=True)
    if only == 'scaling':
        for rec in run_scaling(cards):
            print(json.dumps(rec), flush=True)
        return 0
    # the headline (MLP) line last, for a parser of the last line
    if only is None and not smoke:
        print(json.dumps(run_one(None, smoke=False, num_envs=8192,
            metric_suffix='_8k_lanes')), flush=True)
    if only != 'mlp':
        print(json.dumps(run_one('lstm', smoke=smoke)), flush=True)
    if only is None:
        # the scaling lines before the headline
        for rec in run_scaling(cards):
            print(json.dumps(rec), flush=True)
    if only != 'lstm':
        headline_envs = None if (smoke or 'BENCH_NUM_ENVS' in os.environ) \
            else 32768
        print(json.dumps(run_one(None, smoke=smoke,
            num_envs=headline_envs)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
