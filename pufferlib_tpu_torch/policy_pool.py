"""Multi-policy batched inference for self-play.

Counterpart of pufferlib_tpu/policy_pool.py (reference
pufferlib/pytorch.py:208-258): a policy_map assigns each agent to a
policy; forward runs every policy and routes each agent's outputs from
its own; only learner policies contribute training data
(learner_agent_mask). As in the JAX package, each policy runs on the
whole batch and each agent's row is gathered after: the P policies share
one module, run through torch.func.functional_call with their own
state_dicts.
"""
import torch
from torch.func import functional_call


def cycle_selector(sample_idx, num_policies):
    return sample_idx % num_policies


class PolicyPool:
    def __init__(self, policy, state_dicts, learner_mask, num_agents,
            policy_selector=cycle_selector):
        """policy: a models.Policy / RecurrentPolicy (the module is
        shared); state_dicts: one state_dict of that policy per pool
        member, moved to the policy's device."""
        if len(learner_mask) != len(state_dicts):
            raise ValueError(f'{len(learner_mask)} learner_mask entries for '
                f'{len(state_dicts)} policies')
        self.policy = policy
        self.device = next(policy.parameters()).device
        self.state_dicts = [self._on_device(s) for s in state_dicts]
        self.learner_mask = torch.as_tensor(learner_mask, dtype=torch.bool,
            device=self.device)
        self.num_policies = len(state_dicts)
        self.policy_map = torch.tensor([
            policy_selector(i, self.num_policies)
            for i in range(num_agents)], dtype=torch.int64,
            device=self.device)
        self.recurrent = hasattr(policy, 'initial_state')
        #: True for agents whose data should train (reference learner rows)
        self.learner_agent_mask = self.learner_mask[self.policy_map]

    def _on_device(self, state_dict):
        return {k: v.to(self.device) for k, v in state_dict.items()}

    def update_params(self, policy_idx, state_dict):
        self.state_dicts[policy_idx] = self._on_device(state_dict)

    def forward(self, obs, state=None, generator=None, agent_ids=None,
            u=None):
        """Returns (actions, logprobs, entropy, values, new_state) with
        each agent's row produced by its assigned policy (new_state None
        for a non-recurrent policy).

        generator draws each policy's sampling uniforms, or u (a list of
        P uniform tensors, each as models.sample_logits takes them)
        replaces them. agent_ids: optional (B,) global agent indices for
        partial or reordered batches (async env-pool recv); omitted, the
        batch must be all agents in fixed order."""
        if agent_ids is not None:
            pmap = self.policy_map[torch.as_tensor(agent_ids,
                dtype=torch.int64, device=self.device)]
        else:
            if obs.shape[0] != self.policy_map.shape[0]:
                raise ValueError(
                    f'obs batch {obs.shape[0]} != num_agents '
                    f'{self.policy_map.shape[0]}; pass agent_ids for '
                    'partial batches')
            pmap = self.policy_map
        if u is not None and len(u) != self.num_policies:
            raise ValueError(f'{len(u)} uniform tensors for '
                f'{self.num_policies} policies')

        outs, new_states = [], []
        for p, state_dict in enumerate(self.state_dicts):
            kwargs = dict(generator=generator,
                u=None if u is None else u[p])
            if self.recurrent:
                a, lp, ent, val, st = functional_call(self.policy,
                    state_dict, (obs, state), kwargs)
                new_states.append(st)
            else:
                a, lp, ent, val = functional_call(self.policy, state_dict,
                    (obs,), kwargs)
            outs.append((a, lp, ent, val.reshape(-1)))

        rows = torch.arange(pmap.shape[0], device=pmap.device)

        def gather(stacked):
            # stacked: (P, B, ...) -> each agent's row from its policy
            return stacked[pmap, rows]

        actions, logprobs, entropy, values = (
            gather(torch.stack([o[i] for o in outs])) for i in range(4))
        if not self.recurrent:
            return actions, logprobs, entropy, values, None
        # the state's batch axis is 1, whatever its leading size: the
        # LSTM's (layers, B, H) pair, the transformer's (window, B, H)
        # and (1, B, H)
        new_state = tuple(gather(torch.stack([s[i].movedim(1, 0)
            for s in new_states])).movedim(0, 1)
            for i in range(len(new_states[0])))
        return actions, logprobs, entropy, values, new_state
