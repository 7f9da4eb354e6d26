"""PuffeRL in PyTorch: the fused PPO trainer on one CUDA device.

Counterpart of pufferlib_tpu/training/ppo.py, with `Policy`,
`RecurrentPolicy(LSTMWrapper(...))` or
`TransformerPolicy(TransformerWrapper(...))`. Everything stays on the device: the
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

Recurrent policies follow the JAX trainer: the rollout carries the
state through episode ends (no reset at `done`, ppo.py:390-427) and
stores it at each BPTT segment start (`lstm0`); every minibatch starts
from those stored states. The state is a pair of (lead, N, H) tensors,
each with its own leading size: the LSTM's layers for both, the
transformer's window and 1; every step below keeps the two apart. With num_minibatches == T // bptt_horizon (and
lstm_time_slab_minibatches on) a minibatch is one time slab of all
agents, fed time-major; otherwise it is a group of agent-major segments.

Under a mesh (parallel.make_mesh / make_mesh_2d, `create(..., mesh=)`)
one process runs each rank, and k ranks train what one trains, up to the
order of float sums (the JAX mesh's contract):
- rank r of the env axis's k steps lanes [r * L / k, (r + 1) * L / k) of
  the vecenv's L (agent rows likewise); vecenv and config.batch_size stay
  global, as in JAX;
- every rank seeds its generator with config.seed and draws every draw
  at the global width (the sampler's uniforms, then the env's reset and
  step draws, then the shuffle permutations), keeping its own block: at
  k = 1 this is the no-mesh stream;
- minibatch i holds the rows of minibatch i of one rank, an equal share
  on each: the time slabs and the contiguous MLP layout (a minibatch a
  multiple of the agent rows) split that way as they lie; the agent-major
  and shuffled layouts gather the batch once after GAE (a zero-padded
  byte all-reduce) and take segments [r::k] of each minibatch;
- every mean of the loss is global (ops/losses.py), one all-reduce of a
  flat gradient buffer a minibatch sums the ranks' parts, and the stats,
  explained variance, info sums and episode counts are global, so every
  rank takes the same target_kl decision;
- GAE runs on each rank's own lanes (the JAX shard_map), with no
  collective;
- under a 'model' axis the params shard by the JAX rule
  (parallel.param_shardings: every parameter of two or more dims, Linear
  and conv weights, the LSTM cell's and the attention's matrices,
  embedding tables), each split one a DTensor of this rank's block, and
  Adam's moments follow it (Adam runs its per-tensor loop there: one
  foreach call cannot mix DTensors and tensors); the split grads' sums
  of squares are summed over the axis before the global norm; the CUDA
  kernels are refused there (a DTensor cannot enter them);
- checkpoint files, the progress line, the dashboard and wandb are rank
  0's; a collective they need is called by every rank.
"""
import time
import uuid

import torch
import torch.distributed as dist

from pufferlib_tpu_torch import resolve_device, spaces
from pufferlib_tpu_torch.exceptions import APIUsageError
from pufferlib_tpu_torch.models import count_params
from pufferlib_tpu_torch.namespace import Namespace, namespace
from pufferlib_tpu_torch.ops.cuda.gae import compute_gae_cuda
from pufferlib_tpu_torch.ops.losses import ppo_losses
from pufferlib_tpu_torch.training import checkpoint as ckpt
from pufferlib_tpu_torch.training.profile import Profile, make_losses
from pufferlib_tpu_torch.utils import profile as profile_deco
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
        # each update epoch draws a permutation of the BPTT segments and
        # cuts its minibatches from it (ppo.py:547-575)
        shuffle_minibatches=False,
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
        # host trainer only: keep the obs batch in host RAM and copy one
        # minibatch to the card per update (reference
        # clean_pufferl.py:388-391)
        cpu_offload=False,
        # host trainer only: double-buffer the rollout when the envpool
        # has >= 2 worker groups
        pipeline_rollout=True,
        # dtype name of the stored rollout obs (e.g. 'bfloat16'); None
        # keeps the env's
        obs_store_dtype=None,
        checkpoint_interval=200,
        device='cuda',
        # carried as the JAX trainer carries it (ppo.py:118), read nowhere
        compile=True,
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


def create(config, vecenv, policy, device=None, wandb=None, mesh=None):
    """Initialize train state on `device` (config.device when None, CUDA
    by default; raises when CUDA is asked for and absent). vecenv must be
    a vector.Device on the same device. The policy is moved there.
    wandb: the wandb module (or a stand-in with its surface), the sink of
    the metrics and of the model artifact at close(); the caller imports
    it, and passes it on every rank or on none.
    mesh: a DeviceMesh with an 'env' axis (parallel.make_mesh), and
    optionally a 'model' axis (make_mesh_2d): this process trains as its
    rank of it (the module docstring). Every rank builds the same policy
    from the same seed (checked here: rank 0's params are broadcast and
    compared) and passes the same global vecenv and config."""
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

    recurrent = getattr(policy, 'lstm', None) is not None
    axis = None
    if mesh is not None:
        axis = _mesh_axis(mesh, policy, device, recurrent, num_envs,
            total_agents, seg_rows, vecenv.single_action_space)
    lanes = slice(None) if axis is None else axis.lanes

    generator = torch.Generator(device=device)
    generator.manual_seed(config.seed)

    reset_batch, step_batch = make_env_ops(env, vecenv.emulated)
    env_states, obs, dones = reset_batch(
        env.sample_reset(num_envs, device, generator)[lanes])

    policy.to(device)
    if axis is not None:
        _check_same_params(policy)
        # one run, one directory: rank 0's exp_id (default_config draws
        # a new one in each process)
        exp_id = [config.exp_id]
        dist.broadcast_object_list(exp_id, src=0)
        config.exp_id = exp_id[0]
        if axis.plan.dims:
            from pufferlib_tpu_torch.parallel.mesh import shard_params
            shard_params(policy, axis.plan, axis.model)
    rows = total_agents if axis is None else total_agents // axis.k
    lstm_state = policy.initial_state(rows, device=device) \
        if recurrent else None
    split = axis is not None and bool(axis.plan.dims)
    optimizer = torch.optim.Adam(policy.parameters(),
        lr=config.learning_rate, betas=(0.9, 0.999), eps=1e-5,
        foreach=False if split else None)

    obs_shape = tuple(vecenv.single_observation_space.shape)
    rollout_fn = make_rollout_fn(policy, env, step_batch, config, T,
        generator, mask_fn=make_mask_fn(env), axis=axis)
    update_fn = make_update_fn(policy, optimizer, config, T, total_agents,
        num_minibatches, seg_rows, obs_shape, generator, axis=axis)

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
        mesh=mesh,
        rank=0 if mesh is None else dist.get_rank(),
        pending=None,
        batch=None,
        profile=Profile(),
        _losses=make_losses(),
        _stats={},
        _infos={},
        stats_history=[],
        wandb=wandb,
        global_step=0,
        epoch=0,
        last_lr=config.learning_rate,
        msg=f'Model Size: {count_params(policy)} parameters',
        last_log_time=0.0,
        utilization=None,
        dashboard=None,
    )


def _mesh_axis(mesh, policy, device, recurrent, num_envs, total_agents,
        seg_rows, action_space):
    """create()'s checks of a mesh, and what the trainer keeps of it:
    parallel.mesh.env_axis's record, plus this rank's `lanes` and `rows`
    slices, the global `num_envs` and agent rows (`width`), the sampler's
    uniforms a row (`components`) and the tensor-parallel `plan`."""
    from pufferlib_tpu_torch.parallel.mesh import (
        ShardingPlan, env_axis, param_shardings)
    if torch.device(mesh.device_type).type != device.type:
        raise APIUsageError(f'the mesh is on {mesh.device_type}, the '
            f'trainer on {device}')
    axis = env_axis(mesh)
    k = axis.k
    for what, n in (('lanes', num_envs), ('agent rows', total_agents),
            ('segments a minibatch (minibatch_size // bptt_horizon)',
                seg_rows)):
        if n % k:
            raise APIUsageError(f'{n} {what} do not divide over the env '
                f'axis of {k} ranks')
    axis.plan = ShardingPlan()
    if axis.model is not None:
        module = policy.module
        inner = getattr(module, 'policy', None)
        use_kernel = getattr(module, 'use_kernel', False)
        # LSTMWrapper's None is a kernel on the card, Default's is not
        if (use_kernel is True or (recurrent and use_kernel is None)
                or getattr(inner, 'use_kernel', False) is True):
            raise APIUsageError("a mesh with a 'model' axis (tensor "
                'parallelism) requires use_kernel=False on the policy '
                'module (LSTMWrapper / Default): a sharded weight cannot '
                'enter the CUDA kernels')
        axis.plan = param_shardings(mesh, policy)
    lane_n, row_n = num_envs // k, total_agents // k
    axis.lanes = slice(axis.r * lane_n, (axis.r + 1) * lane_n)
    axis.rows = slice(axis.r * row_n, (axis.r + 1) * row_n)
    axis.num_envs = num_envs
    axis.width = total_agents
    axis.components = len(action_space.nvec) if isinstance(action_space,
        spaces.MultiDiscrete) else 1
    return axis


def _check_same_params(policy):
    """Every rank must start from rank 0's params (each builds them from
    the same seed): broadcast rank 0's and compare, raising on every rank
    together when one differs."""
    from pufferlib_tpu_torch.parallel.mesh import full
    flat = torch.cat([full(p.detach()).reshape(-1).float()
        for p in policy.parameters()])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    bad = torch.tensor(float(not torch.equal(ref, flat)), device=flat.device)
    dist.all_reduce(bad)
    if bad.item():
        raise APIUsageError(f'the policy params differ from rank 0\'s on '
            f'{int(bad.item())} rank(s): build the policy from the same '
            'seed on every rank')


def _all_reduce_stack(values, group):
    """The tensors of `values` (on one device) summed over the group, in
    one all-reduce of float64 (exact for counts); returns the stacked
    sums."""
    total = torch.stack([v.double() for v in values])
    dist.all_reduce(total, group=group)
    return total


def make_rollout_fn(policy, env, step_batch, config, T, generator,
        mask_fn=None, axis=None):
    """rollout(carry, draws=None) -> (carry, batch, info_sums,
    episode_count).

    T fused policy+env steps; the batch is (T, N, ...) time-major over
    N agent rows (lanes x agents, agent-major within a lane), obs
    flattened to (T, N, numel) in config.obs_store_dtype. With a
    recurrent policy the batch also holds `lstm0`, the state at each BPTT
    segment start, its two tensors each (T // bptt_horizon, lead, N, H)
    with its own leading size (the LSTM's layers; the transformer's window
    and 1). With
    mask_fn (vector.make_mask_fn) it holds `mask` (T, N) float32, the
    validity of each row in the state its action was computed from
    (ppo.py:422-425). The buffers are allocated at the first call and
    reused. `draws` ({'u': (T, N, k) sampler uniforms, 'reset': (T, lanes,
    ...) env reset draws, and 'step': (T, lanes, ...) env step draws for
    an env that draws at each step}) replaces the generator's, so a test
    can replay another implementation's randomness.

    axis (create's, under a mesh): the carry holds this rank's lanes;
    every draw is made (or injected) at the global width and sliced to
    them, and the info sums and episode count come back summed over the
    env axis."""
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
            if axis is not None:
                if u is None:
                    u = torch.rand((axis.width, axis.components),
                        generator=generator, device=obs.device)
                u = u[axis.rows]
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
            width = c['done'].shape[0] if axis is None else axis.num_envs
            if draws is None:
                reset_draws = env.sample_reset(width, obs.device, generator)
                step_draws = env.sample_step(width, obs.device, generator)
            else:
                reset_draws = draws['reset'][t]
                step_draws = draws['step'][t] if 'step' in draws else None
            if axis is not None:
                reset_draws = reset_draws[axis.lanes]
                if step_draws is not None:
                    step_draws = step_draws[axis.lanes]
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
        if axis is not None:
            total = _all_reduce_stack(list(info_sums.values())
                + [episode_count], axis.group).unbind()
            info_sums = dict(zip(info_sums, total[:-1]))
            episode_count = total[-1]
        return c, batch, info_sums, episode_count

    return rollout


def make_minibatch_update(policy, optimizer, config, seg_rows, obs_shape,
        time_major=False, axis=None):
    """One PPO minibatch update (ppo.py:462-532): update(mb, lr, stop) ->
    stats, in place on the policy's parameters. mb is a dict of (rows, h,
    ...) tensors, or with time_major (the recurrent time-slab layout)
    (h, rows, ...); obs rows flat or native-shaped, both reshaped to
    obs_shape here; a recurrent policy's state in lstm_h / lstm_c,
    each (lead, rows, H) time-major, else (rows, lead, H). With `stop`
    (target_kl's early stop) the stats are computed and the step skipped,
    as the JAX select keeps the old params. Shared by make_epoch_runner
    and the host trainer's cpu_offload path.

    axis (create's, under a mesh): mb is this rank's share of the
    minibatch (seg_rows its segments); the loss's means are over the
    whole minibatch, one all-reduce of a flat buffer sums the ranks'
    gradients over the env axis, and the grads split over the model axis
    have their sums of squares summed over it before the global norm."""
    h = config.bptt_horizon
    params = list(policy.parameters())
    recurrent = getattr(policy, 'lstm', None) is not None
    obs_shape = tuple(obs_shape)
    env_group = None if axis is None else axis.group
    if axis is not None:
        from pufferlib_tpu_torch.parallel.mesh import local, split_of
        split = [split_of(p) is not None for p in params]

    def update(mb, lr, stop=False):
        lead = (h, seg_rows) if time_major else (seg_rows, h)
        obs = mb['obs'].reshape(lead + obs_shape)
        action = mb['action'].reshape(
            (seg_rows * h,) + tuple(mb['action'].shape[2:]))
        if recurrent:
            state = (mb['lstm_h'], mb['lstm_c'])
            if not time_major:
                state = tuple(s.movedim(0, 1) for s in state)
            _, newlogprob, entropy, newvalue, _ = policy(obs, state,
                action=action, time_major=time_major)
        else:
            _, newlogprob, entropy, newvalue = policy(
                obs.reshape((seg_rows * h,) + obs_shape), action=action)
        loss, stats = ppo_losses(
            newlogprob=newlogprob,
            logprob=mb['logprob'].reshape(-1),
            entropy=entropy,
            newvalue=newvalue,
            values=mb['value'].reshape(-1),
            advantages=mb['advantages'].reshape(-1),
            returns=mb['returns'].reshape(-1),
            clip_coef=config.clip_coef,
            vf_clip_coef=config.vf_clip_coef,
            vf_coef=config.vf_coef,
            ent_coef=config.ent_coef,
            norm_adv=config.norm_adv,
            clip_vloss=config.clip_vloss,
            mask=mb['mask'].reshape(-1) if 'mask' in mb else None,
            group=env_group,
        )
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in params]
        if axis is None:
            # optax.global_norm: sqrt of the sum of every leaf's squares
            gnorm = torch.stack([g.square().sum() for g in grads]).sum(
                ).sqrt()
        else:
            grads = [local(g) for g in grads]
            _sum_over(grads, env_group)
            squares = [g.square().sum() for g in grads]
            gnorm = torch.stack([q for q, s in zip(squares, split)
                if not s]).sum()
            if any(split):
                part = torch.stack([q for q, s in zip(squares, split)
                    if s]).sum().reshape(1)
                dist.all_reduce(part, group=axis.model.get_group())
                gnorm = gnorm + part[0]
            gnorm = gnorm.sqrt()
        stats['grad_norm'] = gnorm
        if not stop:
            scale = (config.max_grad_norm / (gnorm + 1e-12)).clamp(max=1.0)
            for g in grads:
                g.mul_(scale)
            for group in optimizer.param_groups:
                group['lr'] = lr
            optimizer.step()
        return stats

    return update


def _sum_over(tensors, group):
    """Sum each tensor over the group's ranks, in place, in one all-reduce
    of a flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def _gather_rows(tensors, dims, axis):
    """Each tensor's blocks along its dim from every rank of the env
    axis, concatenated in rank order, on every rank. One all-reduce of a
    zero-padded byte buffer: rank r writes its bytes into row r, so each
    summed byte is one rank's plus zeros, the bits exactly (NCCL, and
    gloo on CUDA tensors, both run it)."""
    k, r = axis.k, axis.r
    parts = [t.movedim(d, 0).contiguous() for t, d in zip(tensors, dims)]
    raw = [p.reshape(-1).view(torch.uint8) for p in parts]
    buf = torch.zeros((k, sum(b.numel() for b in raw)), dtype=torch.uint8,
        device=raw[0].device)
    buf[r] = torch.cat(raw)
    dist.all_reduce(buf, group=axis.group)
    out, offset = [], 0
    for p, d, b in zip(parts, dims, raw):
        block = buf[:, offset:offset + b.numel()].contiguous().view(p.dtype)
        out.append(block.reshape((k * p.shape[0],) + tuple(p.shape[1:]))
            .movedim(0, d))
        offset += b.numel()
    return out


def _global_variances(xs, group):
    """Population variance of each flat tensor over every rank's rows:
    the means in one all-reduce, then the squared deviations in one."""
    n = len(xs)
    first = _all_reduce_stack([x.new_tensor(float(x.numel())) for x in xs]
        + [x.sum() for x in xs], group)
    counts, means = first[:n], first[n:] / first[:n]
    second = _all_reduce_stack([(x.double() - m).square().sum()
        for x, m in zip(xs, means)], group)
    return (second / counts).float()


def shuffle_permutations(config, S, generator):
    """(update_epochs, S) segment permutations of shuffle_minibatches,
    drawn from `generator` on its device (ppo.py:553-556)."""
    return torch.stack([torch.randperm(S, generator=generator,
        device=generator.device) for _ in range(config.update_epochs)])


def make_epoch_runner(policy, optimizer, config, seg_rows, num_minibatches,
        S, obs_shape, time_major=False, prestacked=False, axis=None,
        gathered=False):
    """The PPO epoch x minibatch loop over pre-segmented data
    (ppo.py:535-595): run_epochs(seg_batch, lr, perms=None) -> mean
    stats.

    seg_batch: dict of (S, h, ...) tensors [+ lstm_h / lstm_c (S, lead,
    H)], or with prestacked (the recurrent time-slab layout) already
    (num_minibatches, ...) per minibatch. With shuffle_minibatches,
    minibatch i of epoch e is segments perms[e][i * seg_rows:(i + 1) *
    seg_rows] (perms from shuffle_permutations, or another
    implementation's, which a test injects); else the i-th contiguous
    run. Shared by the device trainer and the host trainer (ppo_host).

    axis (create's, under a mesh): seg_rows and S stay global; this rank
    runs seg_rows // k segments a minibatch. seg_batch is this rank's own
    segments, or with `gathered` every rank's, of which rank r takes
    segments [r::k] of each minibatch."""
    has_target_kl = config.target_kl is not None
    shuffle = config.get('shuffle_minibatches', False)
    k, r = (1, 0) if axis is None else (axis.k, axis.r)
    rows = seg_rows // k
    mb_update = make_minibatch_update(policy, optimizer, config, rows,
        obs_shape, time_major=time_major, axis=axis)
    if prestacked and shuffle:
        raise APIUsageError(
            'shuffle_minibatches requires the segment-major layout '
            '(set lstm_time_slab_minibatches=False)')

    def minibatch(seg_batch, i, perm):
        if perm is not None:
            idx = perm[i * seg_rows:(i + 1) * seg_rows]
            if gathered:
                idx = idx[r::k]
            return {k_: v[idx] for k_, v in seg_batch.items()}
        if prestacked:
            return {k_: v[i] for k_, v in seg_batch.items()}
        if gathered:
            return {k_: v[i * seg_rows + r:(i + 1) * seg_rows:k]
                for k_, v in seg_batch.items()}
        return {k_: v[i * rows:(i + 1) * rows]
            for k_, v in seg_batch.items()}

    def run_epochs(seg_batch, lr, perms=None):
        if shuffle and perms is None:
            raise APIUsageError('shuffle_minibatches needs the epochs\' '
                'segment permutations (shuffle_permutations)')
        all_stats = []
        stop = False
        for epoch in range(config.update_epochs):
            perm = perms[epoch] if shuffle else None
            for i in range(num_minibatches):
                all_stats.append(mb_update(minibatch(seg_batch, i, perm),
                    lr, stop))
            if has_target_kl and not stop:
                # the one host read per epoch (ppo.py:583-585); under a
                # mesh approx_kl is global, so every rank stops together
                stop = bool(all_stats[-1]['approx_kl'] > config.target_kl)
        return {k_: torch.stack([s[k_] for s in all_stats]).mean()
            for k_ in all_stats[0]}

    return run_epochs


def make_update_fn(policy, optimizer, config, T, total_agents,
        num_minibatches, seg_rows, obs_shape, generator=None, axis=None):
    """update(batch, lr, perms=None) -> mean stats: GAE + update_epochs x
    minibatch PPO on the policy's parameters, in place
    (ppo.py:598-711). With shuffle_minibatches the epochs' segment
    permutations are drawn from `generator` unless perms is given.

    axis (create's, under a mesh): batch holds this rank's agent rows of
    the total_agents; GAE runs on them. The time slabs, and the contiguous
    MLP layout with a minibatch a multiple of total_agents, train on them
    as they lie (minibatch i of each rank is its rows of the global
    minibatch i); the other layouts gather the batch after GAE and take
    their share of each minibatch. explained_variance and adv_var are
    over every rank's rows."""
    h = config.bptt_horizon
    n_seg = T // h
    S = total_agents * n_seg
    recurrent = getattr(policy, 'lstm', None) is not None
    shuffle = config.get('shuffle_minibatches', False)
    # recurrent time slabs (ppo.py:605-620): minibatch i is the i-th
    # bptt_horizon steps of every agent, a free slice of the time-major
    # batch
    time_slab = (recurrent and num_minibatches == n_seg and not shuffle
        and config.get('lstm_time_slab_minibatches', True))
    contiguous = not recurrent and config.get(
        'mlp_contiguous_minibatches', True)
    gather = axis is not None and not time_slab and (shuffle
        or not contiguous or (seg_rows * h) % total_agents != 0)
    agents = total_agents if axis is None or gather \
        else total_agents // axis.k
    run_epochs = make_epoch_runner(policy, optimizer, config, seg_rows,
        num_minibatches, S, obs_shape, time_major=time_slab,
        prestacked=time_slab, axis=axis, gathered=gather)

    def segment(x):
        """(T, agents, ...) -> (agents * n_seg, h, ...) segments."""
        rest = tuple(x.shape[2:])
        if time_slab:
            # (n_seg, h, N, ...): a free reshape, minibatch c is the c-th
            # time slab, already time-major
            return x.reshape((n_seg, h) + tuple(x.shape[1:]))
        if contiguous:
            # a free reshape of the time-major batch (ppo.py:634-635)
            return x.reshape((agents * n_seg, h) + rest)
        # segment s = n*n_seg + c holds agent n's c-th BPTT chunk
        x = x.reshape((n_seg, h, agents) + rest).movedim(2, 0)
        return x.reshape((agents * n_seg, h) + rest)

    def segment_lstm(x):
        """(n_seg, lead, N, H) -> (N * n_seg, lead, H), segment-major."""
        x = x.movedim(2, 0)
        return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))

    def update(batch, lr, perms=None):
        advantages = compute_gae_cuda(batch['reward'], batch['value'],
            batch['done'], batch['last_value'], config.gamma,
            config.gae_lambda)
        returns = advantages + batch['value']

        fields = dict(obs=batch['obs'], action=batch['action'],
            logprob=batch['logprob'], value=batch['value'],
            advantages=advantages, returns=returns)
        if 'mask' in batch:
            # the agent mask goes through the same segmenting
            # (ppo.py:690-691)
            fields['mask'] = batch['mask']
        lstm0 = batch.get('lstm0')
        if gather:
            names = list(fields)
            whole = _gather_rows(list(fields.values())
                + list(lstm0 or ()), [1] * len(names)
                + [2] * len(lstm0 or ()), axis)
            fields = dict(zip(names, whole))
            if recurrent:
                lstm0 = tuple(whole[len(names):])
        seg_batch = {name: segment(v) for name, v in fields.items()}
        if recurrent:
            # time slabs: (n_seg, lead, N, H), minibatch-leading as is
            if not time_slab:
                lstm0 = tuple(segment_lstm(s) for s in lstm0)
            seg_batch['lstm_h'], seg_batch['lstm_c'] = lstm0
        if shuffle and perms is None:
            perms = shuffle_permutations(config, S, generator)
        mean_stats = run_epochs(seg_batch, lr, perms)

        y_true = returns.reshape(-1)
        y_pred = batch['value'].reshape(-1)
        if axis is None:
            var_y = y_true.var(correction=0)
            var_diff = (y_true - y_pred).var(correction=0)
            adv_var = advantages.var(correction=0)
        else:
            var_y, var_diff, adv_var = _global_variances([y_true,
                y_true - y_pred, advantages.reshape(-1)], axis.group)
        mean_stats['explained_variance'] = torch.where(var_y == 0,
            torch.nan, 1 - var_diff / var_y)
        mean_stats['adv_var'] = adv_var
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
def evaluate(data, draws=None):
    """Rollout phase: collect the training batch on the device and
    aggregate episode stats (a host read). draws: make_rollout_fn's, at
    the global width under a mesh (a test replays another
    implementation's)."""
    with data.profile.eval_forward:
        data.carry, batch, info_sums, episode_count = data.rollout_fn(
            data.carry, draws)
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
        if profile.update(data) or done_training:
            report(data)
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
    # track_history: sweeps read the run's metric series
    wants_metrics = (data.dashboard is not None or config.verbose
        or data.wandb is not None or config.get('track_history', False))
    if (data.profile.update(data) or done_training) and wants_metrics:
        _materialize_metrics(data)
        report(data)
    if done_training or data.epoch % config.checkpoint_interval < epochs:
        ckpt.save_checkpoint(data)
        data.msg = f'Checkpoint saved at update {data.epoch}'


def report(data):
    """The metric sinks: the dashboard hook, else (verbose) a progress
    line; then wandb. Shared with the host trainer. Under a mesh, rank
    0's alone (the metrics they read are global already)."""
    if data.get('rank', 0) != 0:
        return
    if data.dashboard is not None:
        data.dashboard(data)
    elif data.config.verbose:
        print(f'epoch {data.epoch} step {data.global_step} '
            f'SPS {data.profile.SPS:.3g} '
            f'loss {data.losses.policy_loss:.4f} '
            + ' '.join(f'{k}={v:.3f}' for k, v in data.stats.items()
                if isinstance(v, float)))
    _log_wandb(data)


def _log_wandb(data):
    """wandb sink, at most one log every 3 s (the JAX trainer's metric
    names, ppo.py:901-917)."""
    if data.wandb is None or data.global_step == 0:
        return
    if time.time() - data.last_log_time <= 3.0:
        return
    data.last_log_time = time.time()
    data.wandb.log({
        '0verview/SPS': data.profile.SPS,
        '0verview/agent_steps': data.global_step,
        '0verview/epoch': data.epoch,
        '0verview/learning_rate': data.last_lr,
        **{f'environment/{k}': v for k, v in data.stats.items()},
        **{f'losses/{k}': v for k, v in data.losses.items()},
        **{f'performance/{k}': v for k, v in data.profile},
    })


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


def record_stats(data, stats=None):
    """Append the current stats snapshot (`stats`, else the trainer's
    materialized ones) to data.stats_history, bounded by decimation."""
    history = data.get('stats_history')
    if history is None:
        return
    if stats is None:
        stats = data.__dict__['_stats']
    numeric = {k: v for k, v in stats.items()
        if isinstance(v, (int, float))}
    if numeric:
        history.append((data.global_step, numeric))
        if len(history) > 8192:  # keep memory bounded on long runs
            del history[::2]


def close(data):
    """Close the envs; with wandb, save a checkpoint, log it as the
    `{exp_id}_model` artifact and finish the run (ppo.py:964-970). Shared
    with the host trainer (ppo_host.py:479-486). Under a mesh every rank
    with wandb takes part in the checkpoint; rank 0 logs and finishes."""
    data.vecenv.close()
    if data.wandb is not None:
        model_path = ckpt.save_checkpoint(data)
        if data.get('rank', 0) != 0:
            return
        artifact = data.wandb.Artifact(
            f'{data.config.exp_id}_model', type='model')
        artifact.add_file(model_path)
        data.wandb.run.log_artifact(artifact)
        data.wandb.finish()


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
