"""Validate the PyTorch port's LSTM kernels on one NVIDIA GPU: (1) kernel
timing, lstm_scan_fused and lstm_scan forward+backward at the bench
shapes (T=16, B=8192, D=H=128, bf16); (2) learning, the recurrent PPO
trainer on Ocean squared reaches score > 0.9 in 40 epochs with finite
losses. The counterpart of tools/validate_lstm_tpu.py.

    python3 tools/validate_lstm_torch.py                 # enc5 kernels
    python3 tools/validate_lstm_torch.py --kernel cat    # or off

Runs on the card; main(device='cpu') is for rehearsals (the kernels'
plain versions, host-clock times labelled as such). Raises, and exits
non-zero, when the card is missing or the proof fails.
"""
import argparse
import math
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

LSTM_KERNELS = ('enc5', 'cat', 'off')


def fwd_bwd_ms(fn, args, device, reps=30):
    """Mean ms of one forward and backward of fn(*args) -> (outs, hT, cT)
    under the loss sum(outs ** 2) + sum(hT * cT), gradients in every
    argument that requires one. On the card: device time by CUDA events,
    each call after an L2 flush. On the CPU: the host's clock."""
    import torch
    from pufferlib_tpu_torch.ops.cuda.timing import l2_flush_buffer, timed_ms
    inputs = [a for a in args if torch.is_tensor(a) and a.requires_grad]

    def run():
        outs, hT, cT = fn(*args)
        loss = outs.float().square().sum() + (hT * cT).sum()
        return torch.autograd.grad(loss, inputs)
    if device.type == 'cuda':
        return timed_ms(run, l2_flush_buffer(device), reps=reps)
    run()
    start = time.perf_counter()
    for _ in range(reps):
        run()
    return (time.perf_counter() - start) / reps * 1e3


def time_kernels(device, T=16, B=8192, H=128, reps=30, seed=0):
    """{'fused': ms, 'xp': ms}: lstm_scan_fused and lstm_scan forward +
    backward in bf16 at (T, B, D = H), inputs from the seed."""
    import torch
    from pufferlib_tpu_torch.ops.cuda.lstm_scan import (
        lstm_scan, lstm_scan_fused)
    gen = torch.Generator().manual_seed(seed)
    bf16 = torch.bfloat16

    def normal(*shape, scale=1.0, dtype=torch.float32):
        t = torch.randn(*shape, generator=gen) * scale
        return t.to(dtype).to(device).requires_grad_()
    x = normal(T, B, H, dtype=bf16)
    xp = normal(T, B, 4 * H, dtype=bf16)
    w_ih, w_hh = normal(H, 4 * H, scale=0.1), normal(H, 4 * H, scale=0.1)
    b = torch.zeros(4 * H, device=device, requires_grad=True)
    h0 = torch.zeros(B, H, device=device)
    c0 = torch.zeros(B, H, device=device)
    return {
        'fused': fwd_bwd_ms(lstm_scan_fused, (x, h0, c0, w_ih, w_hh, b, bf16),
            device, reps),
        'xp': fwd_bwd_ms(lstm_scan, (xp, h0, c0, w_hh, bf16), device, reps),
    }


def learning_proof(device, kernel='enc5', num_envs=1024, horizon=64,
        epochs=40, hidden=128, dtype_name='bfloat16', learning_rate=0.015,
        seed=0):
    """Train squared with RecurrentPolicy(LSTMWrapper(Default)) for
    `epochs` epochs of num_envs x horizon steps (minibatch batch / 4,
    bptt 16, obs stored in the compute dtype when it is bf16). Returns
    dict(score, policy_loss, steps, seconds)."""
    import torch
    import pufferlib_tpu_torch.vector as vector
    from pufferlib_tpu_torch.models import (
        Default, LSTMWrapper, RecurrentPolicy)
    from pufferlib_tpu_torch.ocean import env_creator
    from pufferlib_tpu_torch.training import ppo
    dtype = getattr(torch, dtype_name)
    batch = num_envs * horizon
    vecenv = vector.make(env_creator('squared'),
        env_kwargs=dict(distance_to_target=3, num_targets=1),
        num_envs=num_envs, device=device)
    obs_shape = vecenv.single_observation_space.shape
    module = Default(obs_shape=obs_shape,
        action_space=vecenv.single_action_space, hidden_size=hidden,
        dtype=dtype, generator=torch.Generator().manual_seed(seed))
    policy = RecurrentPolicy(LSTMWrapper(module, obs_shape=obs_shape,
        input_size=hidden, hidden_size=hidden, dtype=dtype, kernel=kernel,
        generator=torch.Generator().manual_seed(seed + 1)))
    config = ppo.default_config(env='squared', batch_size=batch,
        minibatch_size=batch // 4, bptt_horizon=16,
        learning_rate=learning_rate, total_timesteps=batch * epochs,
        obs_store_dtype='bfloat16' if dtype_name == 'bfloat16' else None,
        verbose=False, data_dir=os.path.join(REPO, 'experiments',
            'validate_lstm'), checkpoint_interval=10 ** 6, seed=seed,
        device=device)
    data = ppo.create(config, vecenv, policy)
    start = time.perf_counter()
    while data.global_step < config.total_timesteps:
        ppo.step(data)
    score = data.stats.get('score', float('nan'))
    loss = data.losses.policy_loss
    return dict(score=score, policy_loss=loss, steps=data.global_step,
        seconds=time.perf_counter() - start)


def main(device='cuda', kernel='enc5'):
    """The whole validation at the reference's settings; returns
    dict(card, kernel, timings, learning). Raises unless the loss is
    finite and score > 0.9."""
    import torch
    from pufferlib_tpu_torch import resolve_device
    from pufferlib_tpu_torch.ops.cuda.timing import card_line
    if kernel not in LSTM_KERNELS:
        raise ValueError(f'kernel must be one of {LSTM_KERNELS}, got '
            f'{kernel!r}')
    device = resolve_device(device)
    on_card = device.type == 'cuda'
    card = card_line() if on_card else 'cpu (host clock, no device times)'
    print(f'kernel={kernel} device={device} card: {card}', flush=True)
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False

    T, B, H = 16, 8192, 128
    timings = time_kernels(device, T, B, H)
    for name, ms in timings.items():
        print(f'{name:5s} fwd+bwd: {ms:.3f} ms ({T}x{B}x{H}) on {card}',
            flush=True)

    learning = learning_proof(device, kernel)
    print(f'learning: score={learning["score"]:.4f} '
        f'policy_loss={learning["policy_loss"]:.4f} '
        f'({learning["steps"]} steps, {learning["seconds"]:.1f} s) on {card}',
        flush=True)
    if not math.isfinite(learning['policy_loss']):
        raise AssertionError(f'non-finite loss {learning["policy_loss"]}')
    if not learning['score'] > 0.9:
        raise AssertionError(
            f'LSTM learning regressed: score={learning["score"]}')
    print('VALIDATION OK', flush=True)
    return dict(card=card, kernel=kernel, timings=timings, learning=learning)


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--kernel', choices=LSTM_KERNELS, default='enc5',
        help="LSTMWrapper's kernel for the learning proof")
    main(kernel=parser.parse_args().kernel)
