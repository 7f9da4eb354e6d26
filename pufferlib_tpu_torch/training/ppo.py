"""PuffeRL in PyTorch: the fused PPO trainer on one CUDA device.

Counterpart of pufferlib_tpu/training/ppo.py, with `Policy` or with
`RecurrentPolicy(LSTMWrapper(...))`. Everything stays on the device: the
rollout steps the policy and the env lanes as batched tensors and writes
the batch into buffers on the card;
GAE runs as one CUDA kernel (ops/cuda/gae.py); the update runs
update_epochs x minibatch PPO with Adam. Metrics stay on the device until
they are read (TrainerData.stats / .losses / .infos); nothing in the
rollout or update synchronises with the host, except the once-per-epoch
read of the last approx_kl when target_kl is set.

API parity with the JAX trainer: default_config/create/evaluate/train/
step/step_many/close, the same config fields, losses/* metric names and
batch/minibatch/bptt divisibility contracts.

Where the two differ:
- Randomness comes from one torch.Generator per trainer (seeded by
  config.seed), not from JAX keys: the same seed gives other draws.
- Adam is torch.optim.Adam(eps=1e-5), the formula of
  optax.scale_by_adam(eps=1e-5); the global-norm clip is written out as
  in the JAX update (scale = min(1, max_norm / (gnorm + 1e-12))).
- target_kl early stop skips the optimizer step of the masked
  minibatches, as the JAX select keeps the old params and optimizer
  state; their stats still count in the means.
- The rollout buffers are allocated once and reused: a batch returned
  by evaluate() is overwritten by the next rollout.

Recurrent policies follow the JAX trainer: the rollout carries the LSTM
state through episode ends (no reset at `done`, ppo.py:390-427) and
stores it at each BPTT segment start (`lstm0`); every minibatch starts
from those stored states. With num_minibatches == T // bptt_horizon (and
lstm_time_slab_minibatches on) a minibatch is one time slab of all
agents, fed time-major; otherwise it is a group of agent-major segments.
"""
import uuid

import torch

from pufferlib_tpu_torch import resolve_device
from pufferlib_tpu_torch.exceptions import APIUsageError
from pufferlib_tpu_torch.models import count_params
from pufferlib_tpu_torch.namespace import Namespace, namespace
from pufferlib_tpu_torch.ops.cuda.gae import compute_gae_cuda
from pufferlib_tpu_torch.ops.losses import ppo_losses
from pufferlib_tpu_torch.training import checkpoint as ckpt
from pufferlib_tpu_torch.training.profile import (
    Profile, make_losses, profile as profile_deco)
from pufferlib_tpu_torch.vector import make_env_ops, make_mask_fn


def default_config(**overrides):
    """Train-section defaults, as pufferlib_tpu's (ppo.py:71) with
    device='cuda'."""
    cfg = namespace(
        env='squared',
        exp_id=None,
        data_dir='experiments',
        seed=1,
        total_timesteps=10_000_000,
        learning_rate=2.5e-4,
        anneal_lr=True,
        gamma=0.99,
        gae_lambda=0.95,
        update_epochs=4,
        norm_adv=True,
        clip_coef=0.1,
        clip_vloss=True,
        vf_coef=0.5,
        vf_clip_coef=0.1,
        max_grad_norm=0.5,
        ent_coef=0.01,
        target_kl=None,
        batch_size=32768,
        minibatch_size=8192,
        bptt_horizon=16,
        # partition minibatches by a free contiguous reshape of the
        # time-major batch instead of the BPTT agent-major permutation.
        # Changes minibatch composition, and so the per-minibatch
        # advantage normalization; False reproduces the agent-major
        # composition
        mlp_contiguous_minibatches=True,
        # recurrent: when num_minibatches == T // bptt_horizon, a minibatch
        # is one time slab of all agents, run time-major; False keeps the
        # agent-major segment grouping (ppo.py:104-109)
        lstm_time_slab_minibatches=True,
        # dtype name of the stored rollout obs (e.g. 'bfloat16'); None
        # keeps the env's
        obs_store_dtype=None,
        checkpoint_interval=200,
        device='cuda',
        verbose=True,
        # materialize device metrics at the profile interval even with
        # no verbose sink (sweeps read stats_history)
        track_history=False,
    )
    for k, v in overrides.items():
        cfg[k] = v
    if cfg.exp_id is None:
        cfg.exp_id = f'{cfg.env}-{uuid.uuid4().hex[:8]}'
    return cfg


class TrainerData(Namespace):
    """Trainer state record. step()/step_many() leave the newest metrics
    on the device (`pending`); reading .stats/.losses/.infos materializes
    them first. Internal hot paths read the shadow fields
    (_stats/_losses/_infos) to avoid the device sync."""

    @property
    def stats(self):
        _materialize_metrics(self)
        return self.__dict__['_stats']

    @stats.setter
    def stats(self, value):
        self.__dict__['_stats'] = value

    @property
    def losses(self):
        _materialize_metrics(self)
        return self.__dict__['_losses']

    @losses.setter
    def losses(self, value):
        self.__dict__['_losses'] = value

    @property
    def infos(self):
        _materialize_metrics(self)
        return self.__dict__['_infos']

    @infos.setter
    def infos(self, value):
        self.__dict__['_infos'] = value


def create(config, vecenv, policy, device=None):
    """Initialize train state on `device` (config.device when None, CUDA
    by default; raises when CUDA is asked for and absent). vecenv must be
    a vector.Device on the same device. The policy is moved there."""
    device = resolve_device(config.device if device is None else device)
    if vecenv.device != device:
        raise APIUsageError(
            f'vecenv runs on {vecenv.device}, the trainer on {device}')
    env = vecenv.env
    num_envs = vecenv.num_envs_total
    total_agents = vecenv.num_agents

    batch_size = config.batch_size
    minibatch_size = config.minibatch_size or batch_size
    horizon = config.bptt_horizon

    if batch_size % total_agents != 0:
        raise APIUsageError('batch_size must be divisible by total agents')
    T = batch_size // total_agents
    if T % horizon != 0:
        raise APIUsageError(
            f'rollout length {T} must be divisible by bptt_horizon')
    if batch_size % minibatch_size != 0:
        raise APIUsageError('batch_size must be divisible by minibatch_size')
    if minibatch_size % horizon != 0:
        raise APIUsageError(
            'minibatch_size must be divisible by bptt_horizon')

    num_minibatches = batch_size // minibatch_size
    seg_rows = minibatch_size // horizon
    num_segments = total_agents * (T // horizon)
    if num_minibatches * seg_rows != num_segments:
        raise APIUsageError('minibatch geometry does not tile the batch')

    generator = torch.Generator(device=device)
    generator.manual_seed(config.seed)

    reset_batch, step_batch = make_env_ops(env, vecenv.emulated)
    env_states, obs, dones = reset_batch(
        env.sample_reset(num_envs, device, generator))

    policy.to(device)
    recurrent = getattr(policy, 'lstm', None) is not None
    lstm_state = policy.initial_state(total_agents, device=device) \
        if recurrent else None
    optimizer = torch.optim.Adam(policy.parameters(),
        lr=config.learning_rate, betas=(0.9, 0.999), eps=1e-5)

    obs_shape = tuple(vecenv.single_observation_space.shape)
    rollout_fn = make_rollout_fn(policy, env, step_batch, config, T,
        generator, mask_fn=make_mask_fn(env))
    update_fn = make_update_fn(policy, optimizer, config, T, total_agents,
        num_minibatches, seg_rows, obs_shape)

    carry = dict(env=env_states, done=dones, obs=obs, lstm=lstm_state)
    return TrainerData(
        config=config,
        vecenv=vecenv,
        policy=policy,
        optimizer=optimizer,
        device=device,
        generator=generator,
        carry=carry,
        rollout_fn=rollout_fn,
        update_fn=update_fn,
        pending=None,
        batch=None,
        profile=Profile(),
        _losses=make_losses(),
        _stats={},
        _infos={},
        stats_history=[],
        global_step=0,
        epoch=0,
        last_lr=config.learning_rate,
        msg=f'Model Size: {count_params(policy)} parameters',
    )


def make_rollout_fn(policy, env, step_batch, config, T, generator,
        mask_fn=None):
    """rollout(carry, draws=None) -> (carry, batch, info_sums,
    episode_count).

    T fused policy+env steps; the batch is (T, N, ...) time-major over
    N agent rows (lanes x agents, agent-major within a lane), obs
    flattened to (T, N, numel) in config.obs_store_dtype. With a
    recurrent policy the batch also holds `lstm0`, the state at each BPTT
    segment start, (h, c) each (T // bptt_horizon, layers, N, H). With
    mask_fn (vector.make_mask_fn) it holds `mask` (T, N) float32, the
    validity of each row in the state its action was computed from
    (ppo.py:422-425). The buffers are allocated at the first call and
    reused. `draws` ({'u': (T, N, k) sampler uniforms, 'reset': (T, lanes,
    ...) env reset draws, and 'step': (T, lanes, ...) env step draws for
    an env that draws at each step}) replaces the generator's, so a test
    can replay another implementation's randomness."""
    store_dtype = config.get('obs_store_dtype', None)
    store_dtype = getattr(torch, store_dtype) if store_dtype else None
    recurrent = getattr(policy, 'lstm', None) is not None
    horizon = config.bptt_horizon
    bufs = {}

    def store(name, t, value, dtype=None, length=T):
        if name not in bufs:
            bufs[name] = torch.empty((length,) + tuple(value.shape),
                dtype=dtype or value.dtype, device=value.device)
        bufs[name][t] = value

    @torch.no_grad()
    def rollout(carry, draws=None):
        c = carry
        for t in range(T):
            obs = c['obs']
            u = None if draws is None else draws['u'][t]
            lstm = c['lstm']
            if recurrent:
                if t % horizon == 0:
                    for name, s in zip(('lstm0_h', 'lstm0_c'), lstm):
                        store(name, t // horizon, s, length=T // horizon)
                action, logprob, _, value, lstm = policy(obs, lstm,
                    generator=generator, u=u)
            else:
                action, logprob, _, value = policy(obs, generator=generator,
                    u=u)
            lanes = c['done'].shape[0]
            if draws is None:
                reset_draws = env.sample_reset(lanes, obs.device, generator)
                step_draws = env.sample_step(lanes, obs.device, generator)
            else:
                reset_draws = draws['reset'][t]
                step_draws = draws['step'][t] if 'step' in draws else None
            if mask_fn is not None:
                store('mask', t, mask_fn(c['env']))
            (env_states, done_next, next_obs, reward, done, trunc,
                infos) = step_batch(c['env'], c['done'], action, reset_draws,
                step_draws)

            store('obs', t, obs.reshape(obs.shape[0], -1), store_dtype)
            store('action', t, action)
            store('logprob', t, logprob)
            store('value', t, value.reshape(-1))
            store('reward', t, reward)
            store('done', t, done, torch.float32)
            store('ended', t, done | trunc)
            for k, v in infos.items():
                store('info/' + k, t, v)
            # the LSTM state carries through episode ends, as in JAX
            c = dict(env=env_states, done=done_next, obs=next_obs,
                lstm=lstm)

        batch = {k: bufs[k] for k in
            ('obs', 'action', 'logprob', 'value', 'reward', 'done', 'mask')
            if k in bufs}
        # bootstrap value for GAE at the rollout end
        last_value = policy.get_value(c['obs'], c['lstm']) if recurrent \
            else policy.get_value(c['obs'])
        batch['last_value'] = last_value.reshape(-1).float().contiguous()
        if recurrent:
            batch['lstm0'] = (bufs['lstm0_h'], bufs['lstm0_c'])
        info_sums = {k[len('info/'):]: v.sum() for k, v in bufs.items()
            if k.startswith('info/')}
        episode_count = bufs['ended'].sum()
        return c, batch, info_sums, episode_count

    return rollout


def make_update_fn(policy, optimizer, config, T, total_agents,
        num_minibatches, seg_rows, obs_shape):
    """update(batch, lr) -> mean stats: GAE + update_epochs x minibatch
    PPO on the policy's parameters, in place (ppo.py:462-711)."""
    h = config.bptt_horizon
    n_seg = T // h
    S = total_agents * n_seg
    mb_rows = seg_rows * h
    params = list(policy.parameters())
    recurrent = getattr(policy, 'lstm', None) is not None
    # recurrent time slabs (ppo.py:605-620): minibatch i is the i-th
    # bptt_horizon steps of every agent, a free slice of the time-major
    # batch
    time_slab = (recurrent and num_minibatches == n_seg
        and config.get('lstm_time_slab_minibatches', True))
    contiguous = time_slab or (not recurrent
        and config.get('mlp_contiguous_minibatches', True))
    has_target_kl = config.target_kl is not None
    if config.get('shuffle_minibatches', False):
        raise NotImplementedError('shuffle_minibatches is not ported')

    def segment(x):
        """(T, N, ...) -> (S*h, ...) rows, segment-major: minibatch i is
        rows [i*mb_rows, (i+1)*mb_rows)."""
        rest = tuple(x.shape[2:])
        if contiguous:
            # a free reshape of the time-major batch (ppo.py:634-635)
            return x.reshape((S * h,) + rest)
        # segment s = n*n_seg + c holds agent n's c-th BPTT chunk
        x = x.reshape((n_seg, h, total_agents) + rest).movedim(2, 0)
        return x.reshape((S * h,) + rest)

    def segment_lstm(x):
        """(n_seg, layers, N, H) -> (S, layers, H), segment-major."""
        x = x.movedim(2, 0)
        return x.reshape((S,) + tuple(x.shape[2:]))

    def minibatch_state(lstm0, i):
        """The stored (h, c) at the start of minibatch i, each
        (layers, rows, H)."""
        if time_slab:
            return lstm0[0][i], lstm0[1][i]
        return tuple(s[i * seg_rows:(i + 1) * seg_rows].movedim(0, 1)
            for s in lstm0)

    def minibatch_update(mb, state, lr, stop):
        if recurrent:
            lead = (h, seg_rows) if time_slab else (seg_rows, h)
            obs = mb['obs'].reshape(lead + tuple(obs_shape))
            _, newlogprob, entropy, newvalue, _ = policy(obs, state,
                action=mb['action'], time_major=time_slab)
        else:
            obs = mb['obs'].reshape((mb_rows,) + tuple(obs_shape))
            _, newlogprob, entropy, newvalue = policy(obs,
                action=mb['action'])
        loss, stats = ppo_losses(
            newlogprob=newlogprob,
            logprob=mb['logprob'],
            entropy=entropy,
            newvalue=newvalue,
            values=mb['value'],
            advantages=mb['advantages'],
            returns=mb['returns'],
            clip_coef=config.clip_coef,
            vf_clip_coef=config.vf_clip_coef,
            vf_coef=config.vf_coef,
            ent_coef=config.ent_coef,
            norm_adv=config.norm_adv,
            clip_vloss=config.clip_vloss,
            mask=mb.get('mask'),
        )
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in params]
        # optax.global_norm: sqrt of the sum of every leaf's squares
        gnorm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        stats['grad_norm'] = gnorm
        if not stop:
            scale = (config.max_grad_norm / (gnorm + 1e-12)).clamp(max=1.0)
            for g in grads:
                g.mul_(scale)
            for group in optimizer.param_groups:
                group['lr'] = lr
            optimizer.step()
        return stats

    def run_epochs(seg_batch, lstm0, lr):
        all_stats = []
        stop = False
        for _ in range(config.update_epochs):
            for i in range(num_minibatches):
                mb = {k: v[i * mb_rows:(i + 1) * mb_rows]
                    for k, v in seg_batch.items()}
                state = minibatch_state(lstm0, i) if recurrent else None
                all_stats.append(minibatch_update(mb, state, lr, stop))
            if has_target_kl and not stop:
                # the one host read per epoch (ppo.py:583-585)
                stop = bool(all_stats[-1]['approx_kl'] > config.target_kl)
        return {k: torch.stack([s[k] for s in all_stats]).mean()
            for k in all_stats[0]}

    def update(batch, lr):
        advantages = compute_gae_cuda(batch['reward'], batch['value'],
            batch['done'], batch['last_value'], config.gamma,
            config.gae_lambda)
        returns = advantages + batch['value']

        seg_batch = dict(
            obs=segment(batch['obs']),
            action=segment(batch['action']),
            logprob=segment(batch['logprob']),
            value=segment(batch['value']),
            advantages=segment(advantages),
            returns=segment(returns),
        )
        if 'mask' in batch:
            # the agent mask goes through the same segmenting
            # (ppo.py:690-691)
            seg_batch['mask'] = segment(batch['mask'])
        lstm0 = None
        if recurrent:
            lstm0 = batch['lstm0'] if time_slab else tuple(
                segment_lstm(s) for s in batch['lstm0'])
        mean_stats = run_epochs(seg_batch, lstm0, lr)

        y_true = returns.reshape(-1)
        y_pred = batch['value'].reshape(-1)
        var_y = y_true.var(correction=0)
        mean_stats['explained_variance'] = torch.where(var_y == 0,
            torch.nan, 1 - (y_true - y_pred).var(correction=0) / var_y)
        mean_stats['adv_var'] = advantages.var(correction=0)
        return mean_stats

    return update


def _lr(config, global_step):
    """Learning rate at a post-rollout step count (ppo.py:243-259)."""
    if not config.anneal_lr:
        return config.learning_rate
    frac = 1.0 - global_step / config.total_timesteps
    return config.learning_rate * max(frac, 0.0)


def _epoch(data):
    """Rollout + GAE + update, all on the device."""
    lr = _lr(data.config, data.global_step + data.config.batch_size)
    data.carry, batch, info_sums, episode_count = data.rollout_fn(data.carry)
    stats = data.update_fn(batch, lr)
    data.global_step += data.config.batch_size
    data.epoch += 1
    data.last_lr = lr
    return stats, info_sums, episode_count


@profile_deco
def evaluate(data):
    """Rollout phase: collect the training batch on the device and
    aggregate episode stats (a host read)."""
    with data.profile.eval_forward:
        data.carry, batch, info_sums, episode_count = data.rollout_fn(
            data.carry)
        if data.device.type == 'cuda':
            torch.cuda.synchronize(data.device)

    with data.profile.eval_misc:
        data.batch = batch
        data.global_step += data.config.batch_size
        data.pending = (None, info_sums, episode_count)
        _materialize_metrics(data)
    return data.stats, data.infos


@profile_deco
def train(data):
    """Update phase: GAE + PPO on the batch of the last evaluate(), then
    logging and checkpointing."""
    config, profile = data.config, data.profile
    if data.batch is None:
        raise APIUsageError('call evaluate() before train()')

    with profile.learn:
        lr = _lr(config, data.global_step)
        stats = data.update_fn(data.batch, lr)
        losses = _host_losses(stats)

    with profile.train_misc:
        data.batch = None
        data.losses = losses
        data.epoch += 1
        data.last_lr = lr
        done_training = data.global_step >= config.total_timesteps
        if (profile.update(data) or done_training) and config.verbose:
            _print_progress(data)
        if data.epoch % config.checkpoint_interval == 0 or done_training:
            ckpt.save_checkpoint(data)
            data.msg = f'Checkpoint saved at update {data.epoch}'


def step(data):
    """One fused epoch: rollout + GAE + PPO update, metrics left on the
    device. Returns the last-materialized stats without a device sync."""
    stats, info_sums, episode_count = _epoch(data)
    data.pending = (stats, info_sums, episode_count)
    _after_epochs(data, 1)
    return data.__dict__['_stats']


def step_many(data, epochs):
    """`epochs` fused epochs; same semantics as calling step() `epochs`
    times (the last epoch's losses, info sums and episode counts summed
    over all), with reporting once at the end."""
    info_total, count_total = {}, 0
    for _ in range(epochs):
        stats, info_sums, episode_count = _epoch(data)
        for k, v in info_sums.items():
            info_total[k] = info_total.get(k, 0) + v
        count_total = count_total + episode_count
    data.pending = (stats, info_total, count_total)
    _after_epochs(data, epochs)
    return data.__dict__['_stats']


def _after_epochs(data, epochs):
    config = data.config
    done_training = data.global_step >= config.total_timesteps
    wants_metrics = config.verbose or config.get('track_history', False)
    if (data.profile.update(data) or done_training) and wants_metrics:
        _materialize_metrics(data)
        if config.verbose:
            _print_progress(data)
    if done_training or data.epoch % config.checkpoint_interval < epochs:
        ckpt.save_checkpoint(data)
        data.msg = f'Checkpoint saved at update {data.epoch}'


def _print_progress(data):
    print(f'epoch {data.epoch} step {data.global_step} '
        f'SPS {data.profile.SPS:.3g} '
        f'loss {data.losses.policy_loss:.4f} '
        + ' '.join(f'{k}={v:.3f}' for k, v in data.stats.items()))


def _host_losses(stats):
    """losses/* namespace from device stats, in one transfer."""
    losses = make_losses()
    keys = [k for k in losses if k in stats]
    values = torch.stack([stats[k].float() for k in keys]).tolist()
    for k, v in zip(keys, values):
        losses[k] = v
    return losses


def _materialize_metrics(data):
    """Pull the most recent device metrics to the host, in one
    transfer."""
    if data.pending is None:
        return
    stats, info_sums, episode_count = data.pending
    data.pending = None
    if stats is not None:
        data.losses = _host_losses(stats)
    keys = list(info_sums)
    values = torch.stack([info_sums[k].double() for k in keys]
        + [torch.as_tensor(episode_count).double().to(
            data.device)]).tolist()
    infos = dict(zip(keys, values[:-1]))
    valid = infos.pop('_valid', None)
    denom = valid if valid is not None else values[-1]
    data.stats = {k: v / denom for k, v in infos.items() if denom > 0}
    data.infos = infos
    record_stats(data)


def record_stats(data):
    """Append the current stats snapshot to data.stats_history, bounded
    by decimation."""
    history = data.get('stats_history')
    if history is None:
        return
    numeric = {k: v for k, v in data.__dict__['_stats'].items()
        if isinstance(v, (int, float))}
    if numeric:
        history.append((data.global_step, numeric))
        if len(history) > 8192:  # keep memory bounded on long runs
            del history[::2]


def close(data):
    data.vecenv.close()


def train_loop(data, fused=True):
    """Run until total_timesteps. fused=True uses step(); fused=False the
    evaluate()/train() split."""
    while data.global_step < data.config.total_timesteps:
        if fused:
            step(data)
        else:
            evaluate(data)
            train(data)
    _materialize_metrics(data)
    return data
