"""PPO losses (pufferlib_tpu/ops/losses.py): the clipped policy loss, the
clipped value loss and the entropy bonus, plus the losses/* stats. An
optional mask drops padded or non-learner rows from every mean.

With a process group (the env axis of a mesh, training/ppo.py) each rank
holds its share of the minibatch's rows, and every mean is over the
whole minibatch: the rank's sum divided by the count all-reduced over
the group. The loss is the rank's part of the global loss, so its
gradient is the rank's part of the global gradient (the trainer sums
those); the advantage normalisation and the stats are global."""
import torch
import torch.distributed as dist


def _masked_mean(x, mask=None):
    if mask is None:
        return x.mean()
    mask = mask.to(x.dtype)
    return (x * mask).sum() / mask.sum().clamp(min=1.0)


def _all_reduce(x, group):
    dist.all_reduce(x, group=group)
    return x


def ppo_losses(newlogprob, logprob, entropy, newvalue, values, advantages,
        returns, clip_coef=0.1, vf_clip_coef=0.1, vf_coef=0.5,
        ent_coef=0.01, norm_adv=True, clip_vloss=True, mask=None,
        group=None):
    """All inputs flat (N,). Returns (loss, stats dict); the stats are
    detached tensors. group: the process group whose ranks hold the rest
    of the minibatch (None: this call holds all of it)."""
    if group is None:
        def mean(x):
            return _masked_mean(x, mask)
    else:
        weight = None if mask is None else mask.to(advantages.dtype)
        local = advantages.new_tensor(float(advantages.numel())) \
            if weight is None else weight.sum()
        parts = [local, advantages.sum() if weight is None
            else (advantages * weight).sum()] if norm_adv else [local]
        sums = _all_reduce(torch.stack(parts).detach().float(), group)
        count = sums[0].clamp(min=1.0)

        def mean(x):
            """This rank's part of the global (masked) mean."""
            return (x if weight is None else x * weight).sum() / count

    logratio = newlogprob - logprob
    ratio = logratio.exp()

    # approx KL (http://joschu.net/blog/kl-approx.html), as diagnostics
    old_approx_kl = mean(-logratio)
    approx_kl = mean((ratio - 1) - logratio)
    clipfrac = mean(((ratio - 1.0).abs() > clip_coef).float())

    adv = advantages
    if norm_adv:
        if group is None:
            adv_mean = mean(adv)
            std = mean((adv - adv_mean) ** 2).sqrt()
        else:
            adv_mean = sums[1] / count
            std = _all_reduce(mean((adv - adv_mean) ** 2).detach(),
                group).sqrt()
        adv = (adv - adv_mean) / (std + 1e-8)

    pg_loss1 = -adv * ratio
    pg_loss2 = -adv * ratio.clamp(1 - clip_coef, 1 + clip_coef)
    pg_loss = mean(torch.maximum(pg_loss1, pg_loss2))

    newvalue = newvalue.reshape(-1)
    if clip_vloss:
        v_loss_unclipped = (newvalue - returns) ** 2
        v_clipped = values + (newvalue - values).clamp(
            -vf_clip_coef, vf_clip_coef)
        v_loss_clipped = (v_clipped - returns) ** 2
        v_loss = 0.5 * mean(torch.maximum(v_loss_unclipped, v_loss_clipped))
    else:
        v_loss = 0.5 * mean((newvalue - returns) ** 2)

    entropy_loss = mean(entropy)
    loss = pg_loss - ent_coef * entropy_loss + v_loss * vf_coef

    stats = dict(
        policy_loss=pg_loss,
        value_loss=v_loss,
        entropy=entropy_loss,
        old_approx_kl=old_approx_kl,
        approx_kl=approx_kl,
        clipfrac=clipfrac,
    )
    if group is not None:
        # the global stats: the ranks' parts summed, in one all-reduce
        total = _all_reduce(torch.stack([v.detach().float()
            for v in stats.values()]), group)
        return loss, dict(zip(stats, total.unbind()))
    return loss, {k: v.detach() for k, v in stats.items()}
