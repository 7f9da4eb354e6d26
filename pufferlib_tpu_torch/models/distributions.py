"""Categorical/MultiDiscrete sampling, logprob, entropy.

Counterpart of pufferlib_tpu/models/distributions.py. A single logits
tensor is Discrete; a list of logits tensors is MultiDiscrete; logprob
and entropy sum over components. Sampling draws its uniforms from an
explicit torch.Generator, or takes them injected (`u`), which is how the
tests replay the JAX sampler's draws.
"""
import torch


def log_prob(logits, value):
    """logprob of integer actions under normalized logits (B, A)."""
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, value.long().unsqueeze(-1)).squeeze(-1)


def entropy(logits):
    """Entropy of a categorical given unnormalized logits (B, A)."""
    logp = torch.log_softmax(logits, dim=-1)
    p = logp.exp()
    # p=0 terms contribute 0 (not 0*-inf=NaN) under -inf action masks
    return -torch.where(p > 0, p * logp, 0).sum(dim=-1)


def _sample_categorical(logits, u):
    """Inverse-CDF categorical sample from one uniform per row, u of
    shape logits.shape[:-1].

    Zero-probability safety (masked -inf logits): the cdf is accumulated
    in f32, u is scaled by cdf[-1] so rounding can never push it past the
    last positive-probability segment, and `cdf <= u` skips flat
    (zero-probability) segments: index k is chosen iff
    cdf[k-1] <= u < cdf[k], an empty interval whenever p_k == 0."""
    probs = torch.softmax(logits.float(), dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    u = u.unsqueeze(-1) * cdf[..., -1:]
    return (cdf <= u).sum(dim=-1).clamp(0, logits.shape[-1] - 1)


def sample_logits(logits, action=None, generator=None, u=None):
    """Sample (or evaluate) (multi)discrete actions.

    logits: (B, A) tensor [Discrete] or list of (B, A_i) tensors
    [MultiDiscrete]. When action is None, samples with uniforms `u`
    ((B,) for Discrete, (B, k) for MultiDiscrete), or draws them from
    `generator`; otherwise evaluates the given actions: (B,) for
    Discrete, (B, k) for MultiDiscrete. Returns (action, logprob,
    entropy) with logprob and entropy summed over components.
    """
    is_discrete = not isinstance(logits, (list, tuple))
    logits_list = [logits] if is_discrete else list(logits)
    batch = logits_list[0].shape[0]

    if action is None:
        if u is None:
            u = torch.rand((batch, len(logits_list)), generator=generator,
                device=logits_list[0].device)
        u = u.reshape(batch, -1)
        actions = [_sample_categorical(l, u[:, i])
            for i, l in enumerate(logits_list)]
    else:
        action = action.reshape(batch, -1)
        actions = [action[:, i] for i in range(len(logits_list))]

    logprob = sum(log_prob(l, a) for l, a in zip(logits_list, actions))
    ent = sum(entropy(l) for l in logits_list)

    if is_discrete:
        return actions[0], logprob, ent
    return torch.stack(actions, dim=-1), logprob, ent
