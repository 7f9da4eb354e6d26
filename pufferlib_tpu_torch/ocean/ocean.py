"""Ocean: first-party micro-environments, batched over lanes in PyTorch.

Counterpart of pufferlib_tpu/ocean/ocean.py. This slice ports `Squared`
(ocean.py:336-447); the other envs follow (ROADMAP, queue 1).
"""
import numpy as np
import torch

from pufferlib_tpu_torch import spaces
from pufferlib_tpu_torch.environment import PufferEnv, Step


class Squared(PufferEnv):
    """Grid navigation to perimeter targets.

    The agent starts at the centre; targets lie on the perimeter; reward
    is 1 - L_inf distance to the closest live target / distance_to_target.
    Reaching the perimeter teleports the agent back to the centre. The
    observation is +1 at every target of the episode (hit targets stay
    visible) and -1 at the agent.

    Reset draws, one row per lane: with num_targets == 1 an int64 index
    into the perimeter (N,); otherwise uniforms (N, n_perim) whose top
    num_targets entries choose the targets (k of n without replacement).
    """

    MOVES = np.array(
        [(0, -1), (0, 1), (-1, 0), (1, 0), (1, -1), (-1, -1), (1, 1),
         (-1, 1)], dtype=np.int32)

    def __init__(self, distance_to_target=1, num_targets=-1):
        grid_size = 2 * distance_to_target + 1
        if num_targets == -1:
            num_targets = 4 * distance_to_target
        self.distance_to_target = distance_to_target
        self.num_targets = num_targets
        self.grid_size = grid_size
        self.max_ticks = num_targets * distance_to_target
        perim = [(x, y) for x in range(grid_size) for y in range(grid_size)
            if x == 0 or y == 0 or x == grid_size - 1 or y == grid_size - 1]
        self.perimeter = np.array(perim, dtype=np.int32)
        self.observation_space = spaces.Box(
            low=-1, high=1, shape=(grid_size, grid_size))
        self.action_space = spaces.Discrete(8)
        self._consts = {}

    def _const(self, device):
        """Per-device constant tensors, made once."""
        key = str(device)
        if key not in self._consts:
            g = self.grid_size
            self._consts[key] = dict(
                tx=torch.as_tensor(self.perimeter[:, 0], device=device),
                ty=torch.as_tensor(self.perimeter[:, 1], device=device),
                cell=torch.as_tensor(
                    self.perimeter[:, 0] * g + self.perimeter[:, 1],
                    dtype=torch.int64, device=device),
                moves=torch.as_tensor(self.MOVES, device=device),
                perim_iota=torch.arange(len(self.perimeter), device=device),
                centre=torch.tensor([self.distance_to_target] * 2,
                    dtype=torch.int32, device=device),
            )
        return self._consts[key]

    def _obs(self, chosen, pos):
        """(N, G, G) grid: +1 at every target of the episode, -1 at the
        agent."""
        c = self._const(chosen.device)
        g = self.grid_size
        n = chosen.shape[0]
        grid = torch.zeros(n, g * g, dtype=torch.float32,
            device=chosen.device)
        grid[:, c['cell']] = chosen.float()
        agent = (pos[:, 0] * g + pos[:, 1]).long()
        grid.scatter_add_(1, agent[:, None],
            torch.full((n, 1), -1.0, device=chosen.device))
        return grid.reshape(n, g, g)

    def sample_reset(self, num_lanes, device, generator=None):
        n_perim = self.perimeter.shape[0]
        if self.num_targets == 1:
            return torch.randint(0, n_perim, (num_lanes,),
                generator=generator, device=device)
        return torch.rand((num_lanes, n_perim), generator=generator,
            device=device)

    def reset(self, draws):
        c = self._const(draws.device)
        n = draws.shape[0]
        if self.num_targets == 1:
            chosen = c['perim_iota'] == draws[:, None]
        else:
            idx = torch.topk(draws, self.num_targets, dim=1).indices
            chosen = torch.zeros(draws.shape, dtype=torch.bool,
                device=draws.device).scatter_(1, idx, True)
        state = dict(
            chosen=chosen,
            alive=chosen,
            agent_pos=c['centre'].expand(n, 2).clone(),
            tick=torch.zeros(n, dtype=torch.int32, device=draws.device),
        )
        return state, self._obs(chosen, state['agent_pos'])

    def step(self, state, action):
        c = self._const(action.device)
        d = self.distance_to_target
        alive = state['alive']

        # as the JAX env's one-hot contraction: an out-of-range action
        # moves nowhere instead of indexing out of bounds
        action = action.reshape(-1)
        n_moves = len(self.MOVES)
        valid = ((action >= 0) & (action < n_moves)).int()[:, None]
        move = c['moves'][action.clamp(0, n_moves - 1).long()] * valid
        x = state['agent_pos'][:, 0] + move[:, 0]
        y = state['agent_pos'][:, 1] + move[:, 1]

        dist = torch.maximum((x[:, None] - c['tx']).abs(),
            (y[:, None] - c['ty']).abs())
        min_dist = dist.masked_fill(~alive, 1 << 20).amin(dim=1)
        # XLA compiles the JAX env's `1 - min_dist / d` into one fused
        # multiply-add by the float32 reciprocal of d; float64 arithmetic
        # (exact here) rounded once to float32 gives the same bits
        reward = (1.0 - min_dist.double() * float(np.float32(1.0 / d))
            ).float()

        hit = alive & (c['tx'] == x[:, None]) & (c['ty'] == y[:, None])
        alive = alive & ~hit

        dist_from_origin = torch.maximum((x - d).abs(), (y - d).abs())
        on_perim = dist_from_origin >= d
        pos = torch.where(on_perim[:, None], c['centre'],
            torch.stack([x, y], dim=1))

        tick = state['tick'] + 1
        done = tick >= self.max_ticks
        remaining = alive.int().sum(dim=1)
        # times the float32 reciprocal, as XLA compiles the division
        score = (self.num_targets - remaining).float() * (
            1.0 / self.num_targets)
        info = {'score': score.masked_fill(~done, 0.0)}
        new_state = dict(chosen=state['chosen'], alive=alive,
            agent_pos=pos, tick=tick)
        obs = self._obs(state['chosen'], pos)
        return Step(new_state, obs, reward, done, torch.zeros_like(done),
            info)
