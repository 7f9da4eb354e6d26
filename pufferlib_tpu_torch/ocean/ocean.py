"""Ocean: first-party micro-environments, batched over lanes in PyTorch.

Counterpart of pufferlib_tpu/ocean/ocean.py: Bandit, Memory, Multiagent,
Password, Performance, PerformanceEmpiric, Spaces, Squared, Stochastic and
VisualTarget, each written once over a batch of lanes. Randomness comes in
as per-lane draws (environment.py): reset draws for Memory, Spaces,
Squared and VisualTarget, step draws for Bandit's reward noise and the
Performance envs' spread. Bandit's and Password's solutions come from
numpy's RandomState(hard_fixed_seed) on the host, as in the JAX package.

Where XLA on the CPU contracts `a * b + c` into one fused multiply-add
(Squared's and Stochastic's rewards, Bandit's noise, the Performance
targets), the port
computes in float64 and rounds once to float32, which gives the JAX
package's values (ROADMAP, faults 3.6 and 3.10).
"""
import time

import numpy as np
import torch

from pufferlib_tpu_torch import spaces
from pufferlib_tpu_torch.environment import PufferEnv, Step
from pufferlib_tpu_torch.ops.cuda.burn import burn


def _render_blocks(vals):
    """Shared ANSI block renderer (1 -> blue, 0 -> red, else gray)."""
    chars = []
    for val in np.asarray(vals).ravel():
        c = 94 if val == 1 else 91 if val == 0 else 90
        chars.append(f'\033[{c}m██\033[0m')
    return ''.join(chars)


def _lane(state, lane):
    """One lane of a batched state, as numpy (for render)."""
    return {k: v[lane].cpu().numpy() for k, v in state.items()}


class _Consts:
    """Per-device copies of an env's constant arrays, made once."""

    def __init__(self):
        self._by_device = {}

    def get(self, name, array, device):
        key = (name, str(device))
        if key not in self._by_device:
            self._by_device[key] = torch.as_tensor(array, device=device)
        return self._by_device[key]


def _fma32(a, b, c):
    """float32(a * b + c) rounded once, as XLA's fused multiply-add gives
    it: the float64 product of two float32 values is exact."""
    return (torch.as_tensor(a).double() * torch.as_tensor(b).double()
        + torch.as_tensor(c).double()).float()


class Bandit(PufferEnv):
    """Multi-armed bandit. One-step episodes; the solution arm is fixed by
    hard_fixed_seed across all instances (ocean.py:41-71). With
    reward_noise, each step draws one standard normal z a lane. The JAX
    package's normal is sqrt(2) x erfinv(u); XLA folds sqrt(2) x
    reward_scale into one float32 constant k and fuses erfinv(u) x k +
    correct, then multiplies by reward_scale in float32. The port does
    the same with erfinv(u) = z / float32(sqrt(2)), so a draw handed in
    as the unrounded float64 product sqrt(2) x erfinv(u) gives the JAX
    package's reward."""

    SQRT2 = float(np.float32(np.sqrt(2)))

    def __init__(self, num_actions=4, reward_scale=1, reward_noise=0,
            hard_fixed_seed=42):
        self.num_actions = num_actions
        self.reward_scale = reward_scale
        self.reward_noise = reward_noise
        rng = np.random.RandomState(hard_fixed_seed)
        self.solution_idx = int(rng.randint(0, num_actions))
        self.observation_space = spaces.Box(low=-1, high=1, shape=(1,))
        self.action_space = spaces.Discrete(num_actions)
        self.render_mode = 'ansi'

    def sample_step(self, num_lanes, device, generator=None):
        if self.reward_noise == 0:
            return None
        return torch.randn(num_lanes, generator=generator, device=device)

    def reset(self, draws):
        return {}, torch.ones(draws.shape[0], 1, device=draws.device)

    def step(self, state, action, draws=None):
        n = action.shape[0]
        correct = (action == self.solution_idx).float()
        reward = correct
        if self.reward_noise != 0:
            scale = np.float32(self.reward_scale)
            k = float(np.float32(self.SQRT2 * float(scale)))
            reward = (correct.double() + draws.double() / self.SQRT2 * k
                ).float() * torch.tensor(scale, device=action.device)
        elif self.reward_scale != 1:
            reward = correct * self.reward_scale
        done = torch.ones(n, dtype=torch.bool, device=action.device)
        return Step(state, torch.ones(n, 1, device=action.device), reward,
            done, torch.zeros_like(done), {'score': correct})


class Memory(PufferEnv):
    """Repeat the observed sequence after a delay (ocean.py:74-129).
    Reset draws: (N, horizon) bits of the solution; its last
    mem_length + mem_delay entries are set to -1."""

    def __init__(self, mem_length=1, mem_delay=0):
        self.mem_length = mem_length
        self.mem_delay = mem_delay
        self.horizon = 2 * mem_length + mem_delay
        self.observation_space = spaces.Box(low=-1, high=1, shape=(1,))
        self.action_space = spaces.Discrete(2)
        self.render_mode = 'ansi'

    def sample_reset(self, num_lanes, device, generator=None):
        return torch.randint(0, 2, (num_lanes, self.horizon),
            generator=generator, device=device)

    def reset(self, draws):
        n = draws.shape[0]
        solution = draws.float()
        solution[:, -(self.mem_length + self.mem_delay):] = -1
        state = dict(
            solution=solution,
            submission=torch.full((n, self.horizon), -1.0,
                device=draws.device),
            tick=torch.ones(n, dtype=torch.int32, device=draws.device),
        )
        return state, solution[:, 0:1].clone()

    def step(self, state, action, draws=None):
        L, delay = self.mem_length, self.mem_delay
        tick = state['tick']
        action = action.float()
        solution, submission = state['solution'], state['submission']

        in_show = tick < L
        in_recall = tick >= L + delay
        iota = torch.arange(self.horizon, device=tick.device)
        tick_mask = iota == tick[:, None]
        ob = torch.where(in_show, (solution * tick_mask).sum(dim=1), 0.0)
        idx = (tick - L - delay).clamp(0, self.horizon - 1)
        sol = (solution * (iota == idx[:, None])).sum(dim=1)
        reward = torch.where(in_show, (action == 0).float(), 0.0)
        reward = torch.where(in_recall, (action == sol).float(), reward)
        submission = torch.where(in_recall[:, None] & tick_mask,
            action[:, None], submission)

        tick = tick + 1
        terminal = tick == self.horizon
        score = (solution[:, :L] == submission[:, -L:]).all(dim=1).float()
        info = {'score': torch.where(terminal, score, 0.0)}
        new_state = dict(solution=solution, submission=submission, tick=tick)
        return Step(new_state, ob[:, None], reward, terminal,
            torch.zeros_like(terminal), info)

    def render(self, state, lane=0):
        s = _lane(state, lane)
        return (_render_blocks(s['solution']) + ' Solution\n'
            + _render_blocks(s['submission']) + ' Prediction\n')


class Multiagent(PufferEnv):
    """Two-agent one-step env: agent 0 must act 0, agent 1 must act 1
    (ocean.py:132-157). Obs (N, 2, 1); reward, done and the score
    (N, 2)."""

    num_agents = 2

    def __init__(self):
        self.observation_space = spaces.Box(low=0, high=1, shape=(1,))
        self.action_space = spaces.Discrete(2)
        self.render_mode = 'ansi'
        self._consts = _Consts()

    def _obs(self, n, device):
        obs = self._consts.get('obs', np.array([[0.0], [1.0]], np.float32),
            device)
        return obs.expand(n, 2, 1).clone()

    def reset(self, draws):
        return {}, self._obs(draws.shape[0], draws.device)

    def step(self, state, action, draws=None):
        n = action.shape[0]
        action = action.reshape(n, 2)
        reward = torch.stack([(action[:, 0] == 0).float(),
            (action[:, 1] == 1).float()], dim=1)
        done = torch.ones(n, 2, dtype=torch.bool, device=action.device)
        return Step(state, self._obs(n, action.device), reward, done,
            torch.zeros_like(done), {'score': reward})


class Password(PufferEnv):
    """Guess a fixed binary password digit by digit (ocean.py:160-195).
    The solution is the JAX package's (hard_fixed_seed)."""

    def __init__(self, password_length=5, hard_fixed_seed=42):
        self.password_length = password_length
        rng = np.random.RandomState(hard_fixed_seed)
        self.solution = rng.randint(
            0, 2, size=password_length).astype(np.float32)
        self.observation_space = spaces.Box(
            low=0, high=1, shape=(password_length,))
        self.action_space = spaces.Discrete(2)
        self.render_mode = 'ansi'
        self._consts = _Consts()

    def reset(self, draws):
        n = draws.shape[0]
        obs = torch.full((n, self.password_length), -1.0,
            device=draws.device)
        tick = torch.zeros(n, dtype=torch.int32, device=draws.device)
        return dict(observation=obs, tick=tick), obs

    def step(self, state, action, draws=None):
        device = action.device
        mask = torch.arange(self.password_length, device=device) \
            == state['tick'][:, None]
        obs = torch.where(mask, action.float()[:, None],
            state['observation'])
        tick = state['tick'] + 1
        terminal = tick == self.password_length
        solution = self._consts.get('solution', self.solution, device)
        solved = (obs == solution).all(dim=1).float()
        reward = torch.where(terminal, solved, 0.0)
        return Step(dict(observation=obs, tick=tick), obs, reward, terminal,
            torch.zeros_like(terminal), {'score': reward})

    def render(self, state, lane=0):
        return (_render_blocks(self.solution) + ' Solution\n'
            + _render_blocks(_lane(state, lane)['observation'])
            + ' Prediction\n')


def _calibrate_work_rate(device):
    """Burn iterations per second on `device`, so that Performance delays
    are real seconds (ocean.py:200-222). The slope of two sizes cancels
    the launch and the sync. On the card the burn kernel is timed with
    CUDA events; on the CPU its plain version with the host clock, at
    sizes a thousand times smaller."""
    device = torch.device(device)
    x = torch.zeros(1, device=device)
    cuda = device.type == 'cuda'

    def timed(k):
        iters = torch.full((1,), k, dtype=torch.int32, device=device)
        burn(x, iters)  # warm-up (the kernel's build and load)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            burn(x, iters)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        burn(x, iters)
        return time.perf_counter() - t0

    k1, k2 = (1_000_000, 5_000_000) if cuda else (1_000, 5_000)
    t1, t2 = timed(k1), timed(k2)
    return max(int((k2 - k1) / max(t2 - t1, 1e-9)), 1)


class _Burner(PufferEnv):
    """The Performance envs' common part: a constant obs, reward 0, never
    done, and device work each step: `iters` rounds of the burn on a
    per-lane float x that nothing observes. Step draws: one standard
    normal a lane where the work is spread."""

    def __init__(self, spread, bandwidth):
        self.spread = spread
        self.bandwidth = bandwidth
        self.observation_space = spaces.Box(
            low=-2**20, high=2**20, shape=(bandwidth,), dtype=np.float32)
        self.action_space = spaces.Discrete(2)
        self._obs = np.random.RandomState(0).uniform(
            -1, 1, bandwidth).astype(np.float32)
        self.render_mode = 'ansi'
        self._consts = _Consts()

    def _obs_batch(self, n, device):
        obs = self._consts.get('obs', self._obs, device)
        return obs.expand(n, self.bandwidth).clone()

    def sample_step(self, num_lanes, device, generator=None):
        if not self.spread:
            return None
        return torch.randn(num_lanes, generator=generator, device=device)

    def reset(self, draws):
        n = draws.shape[0]
        return (dict(x=torch.zeros(n, device=draws.device)),
            self._obs_batch(n, draws.device))

    def _iters(self, n, device, draws):
        raise NotImplementedError

    def step(self, state, action, draws=None):
        n, device = action.shape[0], action.device
        x = burn(state['x'], self._iters(n, device, draws))
        done = torch.zeros(n, dtype=torch.bool, device=device)
        return Step(dict(x=x), self._obs_batch(n, device),
            torch.zeros(n, device=device), done, done.clone(), {})


class Performance(_Burner):
    """Synthetic-delay perf probe (ocean.py:225-254): each step burns
    delay_mean (+ delay_std x a normal draw) seconds of device time per
    lane, at the measured rate of the burn kernel (calibrated at the
    first step, on its device, when a delay is asked for)."""

    def __init__(self, delay_mean=0, delay_std=0, bandwidth=1):
        super().__init__(delay_std, bandwidth)
        self.delay_mean = delay_mean
        self.delay_std = delay_std
        self.work_per_second = None if (delay_mean or delay_std) \
            else 10_000_000

    def _iters(self, n, device, draws):
        if self.work_per_second is None:
            self.work_per_second = _calibrate_work_rate(device)
        target = torch.full((n,), float(np.float32(self.delay_mean)),
            device=device)
        if self.delay_std:
            target = _fma32(np.float32(self.delay_std), draws, target)
        return (target * self.work_per_second).to(torch.int32).clamp(min=0)


class PerformanceEmpiric(_Burner):
    """Counted-work perf probe (ocean.py:257-292): each step burns
    count_n (+ count_std x a normal draw) rounds per lane."""

    def __init__(self, count_n=0, count_std=0, bandwidth=1):
        super().__init__(count_std, bandwidth)
        self.count_n = count_n
        self.count_std = count_std

    def _iters(self, n, device, draws):
        target = torch.full((n,), float(np.float32(self.count_n)),
            device=device)
        if self.count_std:
            target = _fma32(np.float32(self.count_std), draws, target)
        return target.to(torch.int32).clamp(min=0)


class Spaces(PufferEnv):
    """Hierarchical Dict obs + Dict action env (ocean.py:295-333): the
    image action is the sign of the image's sum, the flat action the
    sign of the flat's sum, 0.5 reward each. Exercises the emulation
    layer end to end. Reset draws (N, 30) float32: the (5, 5) image's
    normals, then the flat's five values in {-1, 0, 1}."""

    def __init__(self):
        self.observation_space = spaces.Dict({
            'image': spaces.Box(low=0, high=1, shape=(5, 5),
                dtype=np.float32),
            'flat': spaces.Box(low=0, high=1, shape=(5,), dtype=np.int8),
        })
        self.action_space = spaces.Dict({
            'image': spaces.Discrete(2),
            'flat': spaces.Discrete(2),
        })
        self.render_mode = 'ansi'

    def sample_reset(self, num_lanes, device, generator=None):
        image = torch.randn((num_lanes, 25), generator=generator,
            device=device)
        flat = torch.randint(-1, 2, (num_lanes, 5), generator=generator,
            device=device)
        return torch.cat([image, flat.float()], dim=1)

    def reset(self, draws):
        n = draws.shape[0]
        image = draws[:, :25].reshape(n, 5, 5).contiguous()
        flat = draws[:, 25:].to(torch.int8)
        obs = {'flat': flat, 'image': image}
        state = dict(
            obs=obs,
            image_sign=image.sum(dim=(1, 2)) > 0,
            flat_sign=flat.sum(dim=1) > 0,
        )
        return state, obs

    def step(self, state, action, draws=None):
        reward = (0.5 * (state['image_sign'] == (action['image'] == 1))
            + 0.5 * (state['flat_sign'] == (action['flat'] == 1)))
        done = torch.ones_like(state['image_sign'])
        return Step(state, state['obs'], reward.float(), done,
            torch.zeros_like(done), {'score': reward.float()})


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
        g = grid_size
        self._arrays = dict(
            tx=self.perimeter[:, 0],
            ty=self.perimeter[:, 1],
            cell=(self.perimeter[:, 0] * g + self.perimeter[:, 1]).astype(
                np.int64),
            moves=self.MOVES,
            perim_iota=np.arange(len(self.perimeter)),
            centre=np.full(2, distance_to_target, np.int32),
        )
        self._consts = _Consts()

    def _const(self, device):
        """Per-device constant tensors, made once."""
        return {k: self._consts.get(k, a, device)
            for k, a in self._arrays.items()}

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

    def step(self, state, action, draws=None):
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

    def render(self, state, lane=0):
        s = _lane(state, lane)
        grid = self._obs(torch.as_tensor(s['chosen'])[None],
            torch.as_tensor(s['agent_pos'])[None])[0].numpy()
        return ''.join(_render_blocks(np.where(row == 1, 1,
            np.where(row == -1, 0, 2))) + '\n' for row in grid)


class Stochastic(PufferEnv):
    """The optimal policy is mixed: play 0 with probability p
    (ocean.py:450-479). Deterministic env; tests stochastic policy
    learning."""

    def __init__(self, p=0.75, horizon=1000):
        self.p = p
        self.horizon = horizon
        self.observation_space = spaces.Box(low=0, high=1, shape=(1,))
        self.action_space = spaces.Discrete(2)
        self.render_mode = 'ansi'

    def reset(self, draws):
        n = draws.shape[0]
        zeros = torch.zeros(n, dtype=torch.int32, device=draws.device)
        return (dict(tick=zeros, count=zeros.clone()),
            torch.zeros(n, 1, device=draws.device))

    def step(self, state, action, draws=None):
        tick = state['tick'] + 1
        count = state['count'] + (action == 0).int()
        terminal = tick == self.horizon
        p = float(np.float32(self.p))
        atn0_frac = count.float() / tick.float()
        gap = p - atn0_frac
        proximity = _fma32(-gap, gap, 1.0)
        on_policy = torch.where(action == 0, atn0_frac < p, atn0_frac >= p)
        reward = torch.where(on_policy, proximity, 0.0)
        info = {'score': torch.where(terminal, proximity, 0.0)}
        return Step(dict(tick=tick, count=count),
            torch.zeros(tick.shape[0], 1, device=tick.device), reward,
            terminal, torch.zeros_like(terminal), info)


class VisualTarget(PufferEnv):
    """Pixel-observation navigation, the conv policies' learning-proof
    micro-env (ocean.py:482-587): the agent and a target on a
    grid_size x grid_size grid, each a cell_px block in its own uint8
    channel (NCHW). Reward: 0.1 x the Manhattan distance closed, plus 1 on
    reaching the target. Reset draws (N, 4) int: the agent's cell, then the
    target's (shifted one column, wrapping, where it is the agent's)."""

    MOVES = np.array(
        [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)], dtype=np.int32)

    def __init__(self, grid_size=10, cell_px=4, horizon=32):
        self.grid_size = grid_size
        self.cell_px = cell_px
        self.horizon = horizon
        px = grid_size * cell_px
        self.observation_space = spaces.Box(
            low=0, high=255, shape=(2, px, px), dtype=np.uint8)
        self.action_space = spaces.Discrete(5)
        self.render_mode = 'ansi'
        self._px_cell = np.arange(px, dtype=np.int32) // cell_px
        self._consts = _Consts()

    def _obs(self, agent, target):
        """(N, 2, px, px) uint8: channel 0 the agent's block, 1 the
        target's."""
        cell = self._consts.get('px_cell', self._px_cell, agent.device)

        def block(pos):
            row = (cell == pos[:, 0:1]).to(torch.uint8)
            col = (cell == pos[:, 1:2]).to(torch.uint8)
            return 255 * row[:, :, None] * col[:, None, :]
        return torch.stack([block(agent), block(target)], dim=1)

    def sample_reset(self, num_lanes, device, generator=None):
        return torch.randint(0, self.grid_size, (num_lanes, 4),
            generator=generator, device=device)

    def reset(self, draws):
        g = self.grid_size
        agent = draws[:, :2].int()
        target = draws[:, 2:].int()
        same = (agent == target).all(dim=1)
        shifted = torch.stack([target[:, 0], (target[:, 1] + 1) % g], dim=1)
        target = torch.where(same[:, None], shifted, target)
        tick = torch.zeros(draws.shape[0], dtype=torch.int32,
            device=draws.device)
        state = dict(agent=agent, target=target, tick=tick)
        return state, self._obs(agent, target)

    def step(self, state, action, draws=None):
        g = self.grid_size
        agent, target = state['agent'], state['target']
        # as the JAX env's one-hot contraction: an out-of-range action
        # moves nowhere
        moves = self._consts.get('moves', self.MOVES, action.device)
        n_moves = len(self.MOVES)
        valid = ((action >= 0) & (action < n_moves)).int()[:, None]
        move = moves[action.clamp(0, n_moves - 1).long()] * valid
        new = (agent + move).clamp(0, g - 1)

        d_prev = (agent - target).abs().sum(dim=1)
        d_new = (new - target).abs().sum(dim=1)
        reached = d_new == 0
        reward = 0.1 * (d_prev - d_new).float() + reached.float()

        tick = state['tick'] + 1
        done = reached | (tick >= self.horizon)
        info = {'score': torch.where(done, reached.float(), 0.0)}
        new_state = dict(agent=new, target=target, tick=tick)
        return Step(new_state, self._obs(new, target), reward, done,
            torch.zeros_like(done), info)

    def render(self, state, lane=0):
        s = _lane(state, lane)
        g = self.grid_size
        grid = np.full((g, g), 2, np.int32)
        grid[tuple(s['target'])] = 1
        grid[tuple(s['agent'])] = 0
        return '\n'.join(_render_blocks(row) for row in grid) + '\n'
