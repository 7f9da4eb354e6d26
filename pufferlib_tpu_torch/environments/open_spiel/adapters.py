"""OpenSpiel adapters (counterpart of
pufferlib_tpu/environments/open_spiel/adapters.py), on the port's spaces.

Parity: reference pufferlib/environments/open_spiel/
gymnasium_environment.py (single-player vs a pool of graded MCTS bots,
uct_c=2, max_simulations in [min, max], random side + bot per episode,
win_mcts_{n} info at terminal) and pettingzoo_environment.py
(sequential multiplayer adapter). pyspiel is imported where a game is
loaded by name and open_spiel's MCTS where the bots are made, so the
module loads anywhere; `game` takes an already loaded game (or a
stand-in with pyspiel's methods) in place of the name.
"""
import numpy as np

from pufferlib_tpu_torch import spaces


def _solve_chance_nodes(state, rng):
    while state.is_chance_node():
        actions, probs = zip(*state.chance_outcomes())
        state.apply_action(rng.choice(actions, p=probs))


def _obs_dict(game, state, n_actions):
    mask = np.zeros(n_actions, np.int8)
    mask[state.legal_actions(state.current_player())] = 1
    return {
        'obs': np.reshape(np.asarray(state.observation_tensor(),
            np.float32), -1),
        'action_mask': mask,
    }


def _load(game_name, game):
    if game is not None:
        return game
    import pyspiel
    return pyspiel.load_game(game_name)


def _spaces(game):
    n_actions = game.num_distinct_actions()
    obs = spaces.Dict({
        'obs': spaces.Box(low=0.0, high=1.0,
            shape=(game.observation_tensor_size(),), dtype=np.float32),
        'action_mask': spaces.Box(low=0, high=1, shape=(n_actions,),
            dtype=np.int8),
    })
    return n_actions, obs, spaces.Discrete(n_actions)


class OpenSpielSingleAgentEnv:
    """Play one side against a randomly drawn MCTS bot each episode."""

    def __init__(self, game_name='connect_four', n_rollouts=5,
            min_simulations=10, max_simulations=50, game=None):
        self.game = _load(game_name, game)
        self.n_rollouts = n_rollouts
        self.min_simulations = min_simulations
        self.max_simulations = max_simulations
        self.n_actions, self.observation_space, self.action_space = \
            _spaces(self.game)
        self.render_mode = 'ansi'
        self._bots = None
        self._rng = np.random.RandomState(0)

    def _create_bots(self, seed):
        from open_spiel.python.algorithms import mcts
        rnd = np.random.RandomState(seed)
        evaluator = mcts.RandomRolloutEvaluator(
            n_rollouts=self.n_rollouts, random_state=rnd)
        return [mcts.MCTSBot(game=self.game, uct_c=2, max_simulations=a,
            evaluator=evaluator, random_state=rnd,
            child_selection_fn=mcts.SearchNode.puct_value, solve=True)
            for a in range(self.min_simulations, self.max_simulations + 1)]

    def reset(self, seed=None, options=None):
        if self._bots is None:
            self._rng = np.random.RandomState(seed)
            self._bots = self._create_bots(seed if seed is not None else 0)
        self.state = self.game.new_initial_state()
        self.bot = self._bots[self._rng.randint(len(self._bots))]
        # randomly choose which side the agent plays
        if self._rng.rand() < 0.5:
            _solve_chance_nodes(self.state, self._rng)
            self.state.apply_action(self.bot.step(self.state))
        _solve_chance_nodes(self.state, self._rng)
        self.player = self.state.current_player()
        return _obs_dict(self.game, self.state, self.n_actions), {}

    def step(self, action):
        _solve_chance_nodes(self.state, self._rng)
        self.state.apply_action(int(action))
        if not self.state.is_terminal():
            _solve_chance_nodes(self.state, self._rng)
            self.state.apply_action(self.bot.step(self.state))
        _solve_chance_nodes(self.state, self._rng)

        reward = self.state.returns()[self.player]
        terminated = self.state.is_terminal()
        info = {}
        if terminated:
            info[f'win_mcts_{self.bot.max_simulations}'] = int(reward == 1)
            obs = {
                'obs': np.zeros(self.game.observation_tensor_size(),
                    np.float32),
                'action_mask': np.ones(self.n_actions, np.int8),
            }
        else:
            obs = _obs_dict(self.game, self.state, self.n_actions)
        return obs, float(reward), terminated, False, info

    def render(self):
        return str(self.state)

    def close(self):
        pass


class OpenSpielPettingZooEnv:
    """Sequential multiplayer adapter (parallel API with a per-agent
    mask; only the current player acts each tick)."""

    def __init__(self, game_name='connect_four', game=None):
        self.game = _load(game_name, game)
        self.n_actions, self._obs_space, self._atn_space = _spaces(self.game)
        n = self.game.num_players()
        self.possible_agents = list(range(n))
        self.agents = list(self.possible_agents)
        self._rng = np.random.RandomState(0)
        self.render_mode = 'ansi'

    def observation_space(self, agent):
        return self._obs_space

    def action_space(self, agent):
        return self._atn_space

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self.state = self.game.new_initial_state()
        _solve_chance_nodes(self.state, self._rng)
        self.agents = list(self.possible_agents)
        obs = {a: self._agent_obs(a) for a in self.agents}
        return obs, {a: {} for a in self.agents}

    def _agent_obs(self, agent):
        cur = self.state.current_player()
        mask = np.zeros(self.n_actions, np.int8)
        if agent == cur and not self.state.is_terminal():
            mask[self.state.legal_actions(cur)] = 1
        return {'obs': np.reshape(np.asarray(
            self.state.observation_tensor(agent), np.float32), -1),
            'action_mask': mask}

    def step(self, actions):
        cur = self.state.current_player()
        self.state.apply_action(int(actions[cur]))
        _solve_chance_nodes(self.state, self._rng)
        terminal = self.state.is_terminal()
        returns = self.state.returns() if terminal else None
        obs, rew, term, trunc, info = {}, {}, {}, {}, {}
        for a in self.agents:
            obs[a] = self._agent_obs(a)
            rew[a] = float(returns[a]) if terminal else 0.0
            term[a] = terminal
            trunc[a] = False
            info[a] = {}
        if terminal:
            self.agents = []
        return obs, rew, term, trunc, info

    def render(self):
        return str(self.state)

    def close(self):
        pass
