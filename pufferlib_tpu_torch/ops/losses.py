"""PPO losses (pufferlib_tpu/ops/losses.py): the clipped policy loss, the
clipped value loss and the entropy bonus, plus the losses/* stats. An
optional mask drops padded or non-learner rows from every mean."""
import torch


def _masked_mean(x, mask=None):
    if mask is None:
        return x.mean()
    mask = mask.to(x.dtype)
    return (x * mask).sum() / mask.sum().clamp(min=1.0)


def ppo_losses(newlogprob, logprob, entropy, newvalue, values, advantages,
        returns, clip_coef=0.1, vf_clip_coef=0.1, vf_coef=0.5,
        ent_coef=0.01, norm_adv=True, clip_vloss=True, mask=None):
    """All inputs flat (N,). Returns (loss, stats dict); the stats are
    detached tensors."""
    logratio = newlogprob - logprob
    ratio = logratio.exp()

    # approx KL (http://joschu.net/blog/kl-approx.html), as diagnostics
    old_approx_kl = _masked_mean(-logratio, mask)
    approx_kl = _masked_mean((ratio - 1) - logratio, mask)
    clipfrac = _masked_mean(((ratio - 1.0).abs() > clip_coef).float(), mask)

    adv = advantages
    if norm_adv:
        mean = _masked_mean(adv, mask)
        std = _masked_mean((adv - mean) ** 2, mask).sqrt()
        adv = (adv - mean) / (std + 1e-8)

    pg_loss1 = -adv * ratio
    pg_loss2 = -adv * ratio.clamp(1 - clip_coef, 1 + clip_coef)
    pg_loss = _masked_mean(torch.maximum(pg_loss1, pg_loss2), mask)

    newvalue = newvalue.reshape(-1)
    if clip_vloss:
        v_loss_unclipped = (newvalue - returns) ** 2
        v_clipped = values + (newvalue - values).clamp(
            -vf_clip_coef, vf_clip_coef)
        v_loss_clipped = (v_clipped - returns) ** 2
        v_loss = 0.5 * _masked_mean(
            torch.maximum(v_loss_unclipped, v_loss_clipped), mask)
    else:
        v_loss = 0.5 * _masked_mean((newvalue - returns) ** 2, mask)

    entropy_loss = _masked_mean(entropy, mask)
    loss = pg_loss - ent_coef * entropy_loss + v_loss * vf_coef

    stats = dict(
        policy_loss=pg_loss,
        value_loss=v_loss,
        entropy=entropy_loss,
        old_approx_kl=old_approx_kl,
        approx_kl=approx_kl,
        clipfrac=clipfrac,
    )
    return loss, {k: v.detach() for k, v in stats.items()}
