"""PPO trainer for host (CPU) environments feeding the card.

Counterpart of pufferlib_tpu/training/ppo_host.py: the bridge trainer
for external envs (Atari, NetHack...) that cannot run on the device.
Workers simulate on the host (vector_host); the policy's forward and the
PPO update run on the card, and so does the per-env LSTM state. Mirrors
the reference clean_pufferl.py flow: recv -> forward -> store -> send
until the Experience buffer fills, then sort by (env_id, step), flat GAE
(the reference's semantics, on the card through the GAE kernel), the
minibatched update of training.ppo's epoch runner.

Each recv's observations go to the card through pinned staging memory
with non_blocking copies, and the forward's outputs come back the same
way behind a CUDA event: nothing in the dispatch synchronises, so with
a pipelined envpool (>= 2 worker groups) the env step of one group
overlaps the forward of the other, as the JAX async dispatch does.

Reference citations: Experience (clean_pufferl.py:380-482), evaluate
(:76-154), train (:157-292).
"""
from collections import defaultdict

import numpy as np
import torch

from pufferlib_tpu_torch import resolve_device
from pufferlib_tpu_torch.exceptions import APIUsageError
from pufferlib_tpu_torch.models import TransformerWrapper, count_params
from pufferlib_tpu_torch.namespace import namespace
from pufferlib_tpu_torch.ops.cuda.gae import compute_gae_flat_cuda
from pufferlib_tpu_torch.training import checkpoint as ckpt
from pufferlib_tpu_torch.training import media
from pufferlib_tpu_torch.training.ppo import (
    close, default_config, make_epoch_runner, make_minibatch_update,
    record_stats, report, shuffle_permutations)
from pufferlib_tpu_torch.training.profile import Profile, make_losses
from pufferlib_tpu_torch.utils import profile as profile_deco
from pufferlib_tpu_torch.utils import unroll_nested_dict

__all__ = ['Experience', 'default_config', 'create', 'evaluate', 'train',
    'close']


class Experience:
    """Flat numpy storage with (env_id, step) sort keys (reference
    clean_pufferl.py:380-482); the LSTM state of every agent, (layers,
    agents, H) float32, on `device`."""

    def __init__(self, batch_size, bptt_horizon, minibatch_size, obs_shape,
            obs_dtype, atn_shape, atn_dtype, lstm_total_agents=0,
            lstm_layers=1, lstm_hidden=0, device='cpu'):
        if minibatch_size is None:
            minibatch_size = batch_size
        self.obs = np.zeros((batch_size, *obs_shape), dtype=obs_dtype)
        self.actions = np.zeros((batch_size, *atn_shape), dtype=atn_dtype)
        self.logprobs = np.zeros(batch_size, np.float32)
        self.rewards = np.zeros(batch_size, np.float32)
        self.dones = np.zeros(batch_size, np.float32)
        self.truncateds = np.zeros(batch_size, np.float32)
        self.values = np.zeros(batch_size, np.float32)

        self.lstm_h = self.lstm_c = None
        if lstm_hidden:
            assert lstm_total_agents > 0
            shape = (lstm_layers, lstm_total_agents, lstm_hidden)
            self.lstm_h = torch.zeros(shape, dtype=torch.float32,
                device=device)
            self.lstm_c = torch.zeros_like(self.lstm_h)

        if batch_size % minibatch_size:
            raise APIUsageError('batch_size must be divisible by '
                'minibatch_size')
        if minibatch_size % bptt_horizon:
            raise APIUsageError('minibatch_size must be divisible by '
                'bptt_horizon')
        self.num_minibatches = batch_size // minibatch_size
        self.minibatch_rows = minibatch_size // bptt_horizon

        self.batch_size = batch_size
        self.bptt_horizon = bptt_horizon
        self.minibatch_size = minibatch_size
        # parallel sort-key arrays filled alongside the data rows;
        # sort_training_data lexsorts them into (agent, time) order
        self.key_agent = np.zeros(batch_size, np.int64)
        self.key_step = np.zeros(batch_size, np.int64)
        self.ptr = 0
        self.step = 0
        # per-agent stored-row counts + LSTM state snapshots at BPTT
        # segment starts, keyed (agent_id, segment_index): the update
        # starts each segment from the state the rollout had there
        self.agent_step = {}
        self.lstm_snap = {}

    @property
    def full(self):
        return self.ptr >= self.batch_size

    def store(self, obs, value, action, logprob, reward, done, env_id,
            mask, lstm_h_prev=None, lstm_c_prev=None):
        """One recv's rows where `mask` holds, up to the capacity.
        lstm_h_prev / lstm_c_prev: host copies of every agent's state
        before this forward, where some stored agent starts a segment."""
        ptr = self.ptr
        indices = np.where(mask)[0][:self.batch_size - ptr]
        end = ptr + len(indices)
        self.obs[ptr:end] = obs[indices]
        self.values[ptr:end] = value[indices]
        self.actions[ptr:end] = action[indices]
        self.logprobs[ptr:end] = logprob[indices]
        self.rewards[ptr:end] = reward[indices]
        self.dones[ptr:end] = done[indices]
        self.key_agent[ptr:end] = env_id[indices]
        self.key_step[ptr:end] = self.step
        if self.lstm_h is not None:
            h = self.bptt_horizon
            for i in indices:
                a = int(env_id[i])
                t_a = self.agent_step.get(a, 0)
                if t_a % h == 0 and lstm_h_prev is not None:
                    self.lstm_snap[(a, t_a // h)] = (
                        np.array(lstm_h_prev[:, a]),
                        np.array(lstm_c_prev[:, a]))
                self.agent_step[a] = t_a + 1
        self.ptr = end
        self.step += 1

    def sort_training_data(self):
        """Row permutation into (agent, time) order: agent-contiguous
        blocks whose h-length runs are the BPTT segments (np.lexsort is
        stable, so ties keep arrival order as the reference's stable
        sort, clean_pufferl.py:452-464)."""
        n = self.ptr
        idxs = np.lexsort((self.key_step[:n], self.key_agent[:n]))
        self.sorted_agents = self.key_agent[idxs]
        self.ptr = 0
        self.step = 0
        self.agent_step = {}
        return idxs


def create(config, vecenv, policy, device=None, wandb=None):
    """Initialize the host-env trainer (reference clean_pufferl.create) on
    `device` (config.device when None, CUDA by default; raises when CUDA
    is asked for and absent). The policy is moved there. wandb: the sink
    of the metrics and of the model artifact at close(), as in
    training.ppo.create."""
    device = resolve_device(config.device if device is None else device)
    if isinstance(getattr(policy, 'lstm', None), TransformerWrapper):
        # the per-env state here is the LSTM's (layers, agents, H) pair,
        # as in the JAX host trainer (ppo_host.py:145-146)
        raise APIUsageError('the host trainer keeps LSTM state only and '
            'takes no TransformerPolicy: train it with the device trainer, '
            'training.ppo.create')
    vecenv.async_reset(config.seed)
    obs_space = vecenv.single_observation_space
    atn_space = vecenv.single_action_space
    total_agents = vecenv.num_agents
    recurrent = getattr(policy, 'lstm', None) is not None

    policy.to(device)
    lstm_hidden = policy.lstm.hidden_size if recurrent else 0
    lstm_layers = policy.lstm.num_layers if recurrent else 0
    experience = Experience(config.batch_size, config.bptt_horizon,
        config.minibatch_size, obs_space.shape, obs_space.dtype,
        atn_space.shape, np.int32, lstm_total_agents=total_agents,
        lstm_layers=lstm_layers, lstm_hidden=lstm_hidden, device=device)

    optimizer = torch.optim.Adam(policy.parameters(),
        lr=config.learning_rate, betas=(0.9, 0.999), eps=1e-5)
    generator = torch.Generator(device=device)
    generator.manual_seed(config.seed)
    # the minibatch shuffle's permutations index host arrays too (the
    # cpu_offload path), so they are drawn on the host
    shuffle_generator = torch.Generator()
    shuffle_generator.manual_seed(config.seed)

    seg_rows = config.minibatch_size // config.bptt_horizon
    S = experience.num_minibatches * seg_rows
    run_epochs = make_epoch_runner(policy, optimizer, config, seg_rows,
        experience.num_minibatches, S, obs_space.shape)
    # cpu_offload: train() copies one minibatch at a time to the card
    run_minibatch = make_minibatch_update(policy, optimizer, config,
        seg_rows, obs_space.shape) if config.get('cpu_offload') else None

    return namespace(
        config=config,
        vecenv=vecenv,
        policy=policy,
        optimizer=optimizer,
        device=device,
        generator=generator,
        shuffle_generator=shuffle_generator,
        experience=experience,
        run_epochs=run_epochs,
        run_minibatch=run_minibatch,
        profile=Profile(),
        losses=make_losses(),
        global_step=0,
        epoch=0,
        last_lr=config.learning_rate,
        stats={},
        infos={},
        stats_history=[],
        wandb=wandb,
        msg=f'Model Size: {count_params(policy)} parameters',
        last_log_time=0.0,
        utilization=None,
        dashboard=None,
    )


def _to_device(array, device):
    """A host array on `device`: through pinned staging memory and a
    non_blocking copy on the card (the caching host allocator keeps the
    staging block until the copy has run), as it is on the CPU."""
    host = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != 'cuda':
        return host
    staged = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    staged.copy_(host)
    return staged.to(device, non_blocking=True)


def _to_host(tensors, device):
    """(host tensors, event): non_blocking copies into pinned memory and
    the event after them on the card; the tensors are read after
    event.synchronize(). On the CPU the tensors themselves, no event."""
    if device.type != 'cuda':
        return tensors, None
    out = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
        t, non_blocking=True) for t in tensors)
    event = torch.cuda.Event()
    event.record()
    return out, event


def _recv_and_dispatch(data, rec, u=None):
    """The forward for one recv'd batch, queued on the card and not
    waited for: observations in, actions, logprobs and values queued back
    to pinned host memory. The LSTM state of the batch's agents is
    gathered and scattered on the card (index_select / index_copy_). u:
    the sampler's uniforms, injected by a test, else drawn from
    data.generator."""
    config, experience, device = data.config, data.experience, data.device
    o, r, d, t, info, env_id, mask = rec[:7]
    token = rec[7] if len(rec) > 7 else None
    # LSTM segment-start snapshots are only consumed when some incoming
    # agent sits at a BPTT boundary, which the host knows before the
    # forward: the other steps copy no state back
    bptt = config.bptt_horizon
    need_snap = experience.lstm_h is not None and any(
        experience.agent_step.get(int(a), 0) % bptt == 0 for a in env_id)
    obs = _to_device(o, device)
    with torch.no_grad():
        if experience.lstm_h is None:
            action, logprob, _, value = data.policy(obs,
                generator=data.generator, u=u)
            prev = ()
        else:
            ids = _to_device(np.asarray(env_id, np.int64), device)
            h, c = experience.lstm_h, experience.lstm_c
            state = (h.index_select(1, ids), c.index_select(1, ids))
            action, logprob, _, value, (hs, cs) = data.policy(obs, state,
                generator=data.generator, u=u)
            prev = (h.clone(), c.clone()) if need_snap else ()
            h.index_copy_(1, ids, hs)
            c.index_copy_(1, ids, cs)
    fetch, event = _to_host((action, logprob, value.reshape(-1).float())
        + prev, device)
    return namespace(o=o, r=r, d=d, info=info, env_id=env_id, mask=mask,
        token=token, need_snap=need_snap, fetch=fetch, event=event)


def _finish_batch(data, p, infos, profile):
    """Wait for a dispatched batch's outputs, store the transition, and
    return the actions to the pool."""
    experience = data.experience
    with profile.eval_forward:
        if p.event is not None:
            p.event.synchronize()
    actions, logprob, value = (t.numpy() for t in p.fetch[:3])
    h_prev = p.fetch[3].numpy() if p.need_snap else None
    c_prev = p.fetch[4].numpy() if p.need_snap else None
    with profile.eval_misc:
        # the pipelined drain can arrive after the buffer filled; those
        # rows are dropped by store(), so they do not count as progress
        if experience.ptr < experience.batch_size:
            data.global_step += int(np.sum(p.mask))
        experience.store(np.asarray(p.o), value, actions, logprob,
            np.asarray(p.r), np.asarray(p.d, np.float32),
            np.asarray(p.env_id), np.asarray(p.mask),
            lstm_h_prev=h_prev, lstm_c_prev=c_prev)
        for i in p.info:
            for k, v in unroll_nested_dict(i):
                infos[k].append(v)
    with profile.env:
        if p.token is not None:
            data.vecenv.send_to(actions, p.token)
        else:
            data.vecenv.send(actions)


@profile_deco
def evaluate(data, draws=None):
    """Rollout loop: recv -> forward on the card -> store -> send
    (reference clean_pufferl.py:76-154).

    When the envpool exposes >= 2 disjoint worker groups
    (vecenv.supports_pipeline) the loop runs double-buffered: batch B's
    forward is queued before batch A's outputs are waited for, so the
    env step of one group overlaps the card's work on the other.
    config.pipeline_rollout=False turns that off. draws: an iterator of
    the sampler's uniforms, one tensor per forward, which a test injects
    to replay another implementation's draws."""
    config, profile, experience = data.config, data.profile, data.experience
    infos = defaultdict(list)

    def dispatch(rec):
        return _recv_and_dispatch(data, rec,
            None if draws is None else next(draws))

    pipelined = (config.get('pipeline_rollout', True)
        and getattr(data.vecenv, 'supports_pipeline', False))
    if pipelined:
        pending = None
        while not experience.full:
            with profile.env:
                rec = data.vecenv.recv_async()
            with profile.eval_misc:
                nxt = dispatch(rec)
            if pending is not None:
                _finish_batch(data, pending, infos, profile)
            pending = nxt
        if pending is not None:
            # store() truncates at capacity (reference semantics), so
            # draining the last in-flight batch is safe
            _finish_batch(data, pending, infos, profile)
    else:
        while not experience.full:
            with profile.env:
                rec = data.vecenv.recv()
            with profile.eval_misc:
                p = dispatch(rec)
            _finish_batch(data, p, infos, profile)

    with profile.eval_misc:
        data.stats = {}
        # *_map infos become wandb Images (reference
        # clean_pufferl.py:125-146); media keys skip numeric averaging
        media_keys = media.collect_media_stats(infos, data.stats,
            data.wandb, data)
        for k, v in infos.items():
            if k in media_keys:
                continue
            try:
                data.stats[k] = float(np.mean(v))
            except (TypeError, ValueError):
                continue
        record_stats(data, data.stats)
    return data.stats, infos


def _train_offloaded(data, seg_batch, lr, perms):
    """cpu_offload update loop (reference clean_pufferl.py:388-391): the
    (batch, *obs) array stays in host RAM; each minibatch's rows are
    copied to the card on their own (pinned staging, non_blocking), so
    that the card holds one minibatch of observations at a time. Leaves
    already on the card are sliced there. The per-minibatch early stop
    of the reference (clean_pufferl.py:256-258) reads approx_kl only
    when target_kl is set."""
    config, experience, device = data.config, data.experience, data.device
    rows = experience.minibatch_rows
    M = experience.num_minibatches
    stats_sum = None
    n = 0
    for epoch in range(config.update_epochs):
        for m in range(M):
            if perms is not None:
                idx = perms[epoch][m * rows:(m + 1) * rows]
                mb = {k: _to_device(v[idx.numpy()], device)
                    if isinstance(v, np.ndarray) else v[idx.to(device)]
                    for k, v in seg_batch.items()}
            else:
                mb = {k: _to_device(v[m * rows:(m + 1) * rows], device)
                    if isinstance(v, np.ndarray)
                    else v[m * rows:(m + 1) * rows]
                    for k, v in seg_batch.items()}
            stats = data.run_minibatch(mb, lr)
            stats_sum = stats if stats_sum is None else {
                k: stats_sum[k] + v for k, v in stats.items()}
            n += 1
            if config.target_kl is not None and \
                    float(stats['approx_kl']) > config.target_kl:
                break
        else:
            continue
        break
    return {k: v / n for k, v in stats_sum.items()}


@profile_deco
def train(data, perms=None):
    """Sort, flat GAE on the card, minibatched PPO on the card (reference
    clean_pufferl.py:157-292). perms: the shuffle's (update_epochs, S)
    segment permutations, injected by a test; else drawn from
    data.shuffle_generator where shuffle_minibatches is on."""
    config, profile, experience = data.config, data.profile, data.experience
    device = data.device

    with profile.train_misc:
        idxs = experience.sort_training_data()
        values_np = experience.values[idxs]
        dones, values, rewards = (_to_device(a, device) for a in (
            experience.dones[idxs], values_np, experience.rewards[idxs]))
        advantages = compute_gae_flat_cuda(dones, values, rewards,
            config.gamma, config.gae_lambda)
        returns = advantages + values

        h = config.bptt_horizon
        M = experience.num_minibatches
        S = M * experience.minibatch_rows
        # minibatch-major segment order, so that the epoch runner's
        # contiguous slices are exactly these minibatches
        sorted_pos = np.arange(experience.batch_size).reshape(
            experience.minibatch_rows, M, h).transpose(1, 0, 2).reshape(S, h)
        row_idx = idxs[sorted_pos]  # (S, h) direct rows, one gather each
        pos = _to_device(sorted_pos, device)

        seg_batch = dict(
            obs=experience.obs[row_idx],
            action=experience.actions[row_idx],
            logprob=experience.logprobs[row_idx],
            value=values[pos],
            advantages=advantages[pos],
            returns=returns[pos],
        )
        if experience.lstm_h is not None:
            layers = experience.lstm_h.shape[0]
            hidden = experience.lstm_h.shape[2]
            lstm_h_seg = np.zeros((S, layers, hidden), np.float32)
            lstm_c_seg = np.zeros((S, layers, hidden), np.float32)
            # each segment starts from the state the rollout had there:
            # after the (agent, time) sort an agent's rows are
            # contiguous, and its rank in its block // h is the segment
            # index keyed in lstm_snap
            agents_sorted = experience.sorted_agents
            change = np.r_[True, agents_sorted[1:] != agents_sorted[:-1]]
            group_start = np.maximum.accumulate(
                np.where(change, np.arange(len(agents_sorted)), 0))
            rank = np.arange(len(agents_sorted)) - group_start
            for s_i in range(S):
                p0 = sorted_pos[s_i, 0]
                agent = int(agents_sorted[p0])
                snap = experience.lstm_snap.get((agent, int(rank[p0]) // h))
                if snap is not None:
                    lstm_h_seg[s_i], lstm_c_seg[s_i] = snap
            seg_batch['lstm_h'] = lstm_h_seg
            seg_batch['lstm_c'] = lstm_c_seg
            experience.lstm_snap = {}

        lr = config.learning_rate
        if config.anneal_lr:
            lr *= 1.0 - data.global_step / config.total_timesteps
        if config.get('shuffle_minibatches', False) and perms is None:
            perms = shuffle_permutations(config, S, data.shuffle_generator)

    with profile.learn:
        if data.run_minibatch is not None:
            stats = _train_offloaded(data, seg_batch, lr, perms)
        else:
            seg_batch = {k: _to_device(v, device)
                if isinstance(v, np.ndarray) else v
                for k, v in seg_batch.items()}
            stats = data.run_epochs(seg_batch, lr, None if perms is None
                else perms.to(device))
        keys = list(stats)
        values_host = torch.stack([stats[k].float() for k in keys]
            + [advantages.var(correction=0)]).tolist()

    with profile.train_misc:
        losses = make_losses()
        for k, v in zip(keys, values_host):
            if k in losses:
                losses[k] = v
        returns_np = returns.cpu().numpy()
        var_y = float(np.var(returns_np))
        losses.explained_variance = float('nan') if var_y == 0 else \
            1 - float(np.var(returns_np - values_np)) / var_y
        losses.adv_var = values_host[-1]
        data.losses = losses
        data.epoch += 1
        data.last_lr = lr

        done_training = data.global_step >= config.total_timesteps
        if profile.update(data) or done_training:
            report(data)
        if data.epoch % config.checkpoint_interval == 0 or done_training:
            ckpt.save_checkpoint(data)
