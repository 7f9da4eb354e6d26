"""Host-side vectorization for external CPU envs (gymnasium/pettingzoo),
counterpart of pufferlib_tpu/vector_host.py.

Parity: reference pufferlib/vector.py — Serial (:70) and the
shared-memory Multiprocessing envpool (:218): per-worker RawArray slabs
for obs/atn/rew/term/trunc/mask, a one-byte semaphore per worker with
busy-wait, infos over pipes, batched async recv with contiguous worker
blocks. Same sync + async protocol and flag FSM as the device engine.

This is the bridge that lets Atari/NetHack-class CPU envs feed the
trainer on the card (training/ppo_host.py): workers simulate and write
slabs; the driver assembles batches, which the trainer copies to the
card. Neither torch nor gymnasium is imported here: every spawned worker
imports this module and its env creator's. HostRay imports ray when it is
built; profile_env / autotune (reference vector.py:669-854) pick an
envpool configuration for the CLI (psutil, imported when called).
"""
import multiprocessing
import os
import time
from multiprocessing import RawArray

# a forked child of a process whose CUDA context or torch threads exist
# inherits them broken; spawn gives workers a clean interpreter. Env
# creators must be picklable.
_mp = multiprocessing.get_context('spawn')

import numpy as np

from pufferlib_tpu_torch import native as native_driver, spaces
from pufferlib_tpu_torch.exceptions import APIUsageError
from pufferlib_tpu_torch.host_env import (
    GymnasiumPufferEnv, NativePufferEnv, PettingZooPufferEnv)
from pufferlib_tpu_torch.namespace import namespace

RESET = 0
STEP = 1
SEND = 2
RECV = 3
CLOSE = 4
MAIN = 5
INFO = 6


def recv_precheck(vecenv):
    if vecenv.flag != RECV:
        raise APIUsageError('Call reset before stepping')
    vecenv.flag = SEND


def send_precheck(vecenv):
    if vecenv.flag != SEND:
        raise APIUsageError('Call (async) reset + recv before sending')
    vecenv.flag = RECV


def make_seeds(seed, num_envs):
    if isinstance(seed, int):
        return [seed + i for i in range(num_envs)]
    return list(seed)


def joint_space(space, n):
    if isinstance(space, spaces.Discrete):
        return spaces.MultiDiscrete([space.n] * n)
    if isinstance(space, spaces.MultiDiscrete):
        return spaces.Box(low=0, high=np.repeat(
            space.nvec[None] - 1, n, axis=0),
            shape=(n, len(space.nvec)), dtype=space.dtype)
    if isinstance(space, spaces.Box):
        return spaces.Box(low=np.repeat(space.low[None], n, axis=0),
            high=np.repeat(space.high[None], n, axis=0),
            shape=(n, *space.shape), dtype=space.dtype)
    raise ValueError(f'Unsupported space: {space}')


def _wrap(creator, args, kwargs, buf=None):
    env = creator(*(args or ()), **(kwargs or {}))
    if isinstance(env, (GymnasiumPufferEnv, PettingZooPufferEnv,
            NativePufferEnv)):
        env.buf = buf
        return env
    if hasattr(env, 'possible_agents'):
        return PettingZooPufferEnv(env=env, buf=buf)
    if hasattr(env, 'num_agents') and hasattr(
            env, 'single_observation_space'):
        # native puffer-style env (flat per-agent arrays, no emulation)
        # regardless of agent count — GymnasiumPufferEnv speaks a
        # different (unbatched) protocol
        return NativePufferEnv(env=env, buf=buf)
    return GymnasiumPufferEnv(env=env, buf=buf)


class HostSerial:
    """Python-loop backend over host envs writing one shared buffer
    (reference vector.py:70-166)."""

    def __init__(self, env_creators, env_args=None, env_kwargs=None,
            num_envs=1, buf=None, seed=42, **kwargs):
        self.seed = seed
        creators = env_creators if isinstance(env_creators, (list, tuple)) \
            else [env_creators] * num_envs
        self.envs = [_wrap(creators[i % len(creators)], env_args,
            env_kwargs) for i in range(num_envs)]
        driver = self.envs[0]
        self.driver_env = driver
        self.emulated = driver.emulated
        self.agents_per_env = [e.num_agents for e in self.envs]
        self.agents_per_batch = sum(self.agents_per_env)
        self.num_agents = self.agents_per_batch
        self.single_observation_space = driver.single_observation_space \
            if hasattr(driver, 'single_observation_space') \
            else driver.observation_space
        self.single_action_space = driver.single_action_space \
            if hasattr(driver, 'single_action_space') \
            else driver.action_space
        self.observation_space = joint_space(
            self.single_observation_space, self.agents_per_batch)
        self.action_space = joint_space(
            self.single_action_space, self.agents_per_batch)
        self.agent_ids = np.arange(self.num_agents)
        self.initialized = False
        self.flag = RESET
        self.buf = buf

    def _assign_buffers(self, buf):
        ptr = 0
        for i, env in enumerate(self.envs):
            end = ptr + self.agents_per_env[i]
            env.buf = namespace(
                observations=buf.observations[ptr:end],
                rewards=buf.rewards[ptr:end],
                terminals=buf.terminals[ptr:end],
                truncations=buf.truncations[ptr:end],
                masks=buf.masks[ptr:end])
            ptr = end

    def async_reset(self, seed=None):
        self.flag = RECV
        if seed is None:
            seed = getattr(self, 'seed', 42)
        seeds = make_seeds(seed, len(self.envs))
        if self.buf is None:
            obs_space = self.single_observation_space
            self.buf = namespace(
                observations=np.zeros(
                    (self.agents_per_batch, *obs_space.shape),
                    dtype=obs_space.dtype),
                rewards=np.zeros(self.agents_per_batch, dtype=np.float32),
                terminals=np.zeros(self.agents_per_batch, dtype=bool),
                truncations=np.zeros(self.agents_per_batch, dtype=bool),
                masks=np.ones(self.agents_per_batch, dtype=bool))
        self._assign_buffers(self.buf)

        self.infos = []
        for env, s in zip(self.envs, seeds):
            _, info = env.reset(seed=s)
            if info:
                self.infos.append(info)

    def send(self, actions):
        send_precheck(self)
        actions = np.asarray(actions)
        if not self.initialized:
            self.initialized = True
        self.infos = []
        ptr = 0
        for idx, env in enumerate(self.envs):
            end = ptr + self.agents_per_env[idx]
            atns = actions[ptr:end]
            if env.done:
                _, info = env.reset()
            else:
                if env.num_agents == 1:
                    result = env.step(atns[0])
                else:
                    result = env.step(atns)
                info = result[-1]
            if info:
                self.infos.append(info)
            ptr = end

    def recv(self):
        recv_precheck(self)
        buf = self.buf
        return (buf.observations, buf.rewards, buf.terminals,
            buf.truncations, self.infos, self.agent_ids, buf.masks)

    def reset(self, seed=42):
        self.async_reset(seed)
        obs, _, _, _, infos, _, _ = self.recv()
        return obs, infos

    def step(self, actions):
        self.send(actions)
        obs, rew, term, trunc, infos, _, _ = self.recv()
        return obs, rew, term, trunc, infos

    def close(self):
        for env in self.envs:
            env.close()

    @property
    def num_envs(self):
        return self.agents_per_batch


def _worker_process(env_creators, env_args, env_kwargs, envs_per_worker,
        obs_shape, obs_dtype, atn_shape, atn_dtype, agents_per_worker,
        worker_idx, send_pipe, recv_pipe, shm, oversubscribed=False):
    """Worker: a HostSerial of envs_per_worker envs writing directly into
    this worker's shared-memory slab; busy-waits its semaphore byte
    (reference vector.py:168-216)."""
    sem = np.frombuffer(shm['semaphores'], dtype=np.uint8)[
        worker_idx:worker_idx + 1]
    a = agents_per_worker
    lo, hi = worker_idx * a, (worker_idx + 1) * a
    obs_numel = int(np.prod(obs_shape))
    atn_numel = int(np.prod(atn_shape)) if atn_shape else 1
    buf = namespace(
        observations=np.frombuffer(shm['observations'],
            dtype=obs_dtype)[lo * obs_numel:hi * obs_numel].reshape(
            a, *obs_shape),
        rewards=np.frombuffer(shm['rewards'], dtype=np.float32)[lo:hi],
        terminals=np.frombuffer(shm['terminals'], dtype=bool)[lo:hi],
        truncations=np.frombuffer(shm['truncations'], dtype=bool)[lo:hi],
        masks=np.frombuffer(shm['masks'], dtype=bool)[lo:hi])
    atn_arr = np.frombuffer(shm['actions'], dtype=atn_dtype)[
        lo * atn_numel:hi * atn_numel].reshape(a, *atn_shape) \
        if atn_shape else np.frombuffer(shm['actions'],
            dtype=atn_dtype)[lo:hi]

    envs = HostSerial(env_creators, env_args, env_kwargs,
        num_envs=envs_per_worker, buf=buf)

    start = time.time()
    while True:
        flag = sem[0]
        if flag == RESET:
            seeds = recv_pipe.recv()
            envs.async_reset(seeds)
            infos = envs.infos
            # publish the semaphore ONCE after any pipe traffic: a
            # MAIN-then-INFO double write races the driver into missing
            # the infos and re-reading a stale batch
            if infos:
                send_pipe.send(infos)
                sem[0] = INFO
            else:
                sem[0] = MAIN
            start = time.time()
        elif flag == STEP:
            envs.flag = SEND  # worker drives the FSM: recv is implicit
            envs.send(atn_arr.copy())
            infos = envs.infos
            if infos:
                send_pipe.send(infos)
                sem[0] = INFO
            else:
                sem[0] = MAIN
            start = time.time()
        elif flag == CLOSE:
            envs.close()
            sem[0] = MAIN
            return
        elif oversubscribed:
            # more workers than cores: never hot-spin, the driver and
            # sibling workers need this core
            time.sleep(0.0002)
        elif time.time() - start > 0.5:
            time.sleep(0.01)


class HostMultiprocessing:
    """Shared-memory envpool: workers write slabs, driver batches the
    first-ready (or contiguous) worker blocks (reference
    vector.py:218-447).

    native: None (the JAX package's behaviour) runs the C++ driver core
    (native.py: the spin-wait and the slab gather) where it builds and
    loads, else the Python loop; True requires it and raises where it
    cannot be had; False runs the Python loop."""

    def __init__(self, env_creators, env_args=None, env_kwargs=None,
            num_envs=1, num_workers=None, batch_size=None, seed=42,
            zero_copy=False, native=None, **kwargs):
        # zero_copy=True returns the internal gather buffers from recv()
        # (overwritten by the next recv) — fastest, reference
        # vector.py:362-381 semantics. Default False: recv returns
        # fresh copies, matching the Python fallback path.
        self.zero_copy = zero_copy
        self.seed = seed
        num_workers = num_workers or num_envs
        if num_envs % num_workers != 0:
            raise APIUsageError('num_envs must be divisible by num_workers')
        envs_per_worker = num_envs // num_workers

        # driver env: spaces/metadata only
        driver = _wrap(env_creators if not isinstance(
            env_creators, (list, tuple)) else env_creators[0],
            env_args, env_kwargs)
        self.driver_env = driver
        self.emulated = driver.emulated
        agents_per_env = driver.num_agents
        agents_per_worker = agents_per_env * envs_per_worker
        self.num_agents = num_envs * agents_per_env
        self.single_observation_space = driver.single_observation_space
        self.single_action_space = driver.single_action_space
        driver.close()

        batch_size = batch_size or num_envs
        if num_envs % batch_size != 0:
            raise APIUsageError('num_envs must be divisible by batch_size')
        self.batch_size = batch_size
        self.workers_per_batch = batch_size // envs_per_worker
        if self.workers_per_batch < 1:
            raise APIUsageError('batch_size must be >= envs_per_worker')
        self.agents_per_batch = self.workers_per_batch * agents_per_worker
        self.agents_per_worker = agents_per_worker
        self.num_workers = num_workers
        self.envs_per_worker = envs_per_worker

        obs_space = self.single_observation_space
        atn_space = self.single_action_space
        obs_shape = obs_space.shape
        atn_shape = atn_space.shape
        obs_ct = int(np.prod(obs_shape)) * self.num_agents
        atn_ct = self.num_agents * (int(np.prod(atn_shape))
            if atn_shape else 1)
        self.shm = dict(
            observations=RawArray(
                np.ctypeslib.as_ctypes_type(np.dtype(obs_space.dtype)),
                obs_ct),
            actions=RawArray(np.ctypeslib.as_ctypes_type(
                np.dtype(atn_space.dtype)), atn_ct),
            rewards=RawArray('f', self.num_agents),
            terminals=RawArray('b', self.num_agents),
            truncations=RawArray('b', self.num_agents),
            masks=RawArray('b', self.num_agents),
            semaphores=RawArray('B', num_workers),
        )
        self.obs_arr = np.frombuffer(self.shm['observations'],
            dtype=obs_space.dtype).reshape(self.num_agents, *obs_shape)
        self.atn_arr = np.frombuffer(self.shm['actions'],
            dtype=atn_space.dtype).reshape(self.num_agents, *atn_shape) \
            if atn_shape else np.frombuffer(self.shm['actions'],
            dtype=atn_space.dtype)
        self.rew_arr = np.frombuffer(self.shm['rewards'], dtype=np.float32)
        self.term_arr = np.frombuffer(self.shm['terminals'], dtype=bool)
        self.trunc_arr = np.frombuffer(self.shm['truncations'], dtype=bool)
        self.mask_arr = np.frombuffer(self.shm['masks'], dtype=bool)
        self.sem = np.frombuffer(self.shm['semaphores'], dtype=np.uint8)
        self.sem[:] = MAIN

        # oversubscribed hosts (workers + driver > cores): hot spinning
        # starves the processes being waited on — everyone naps instead
        oversubscribed = num_workers + 1 > (os.cpu_count() or 1)
        self._spin_us = 0 if oversubscribed else 500_000
        # steady-state watchdog (seconds); a worker's FIRST wait covers
        # its spawn + module import, which under heavy host load (e.g. a
        # parallel test suite compiling XLA programs) can far exceed the
        # steady-state budget — give it a generous one-time allowance,
        # tracked PER WORKER: with batch < num_envs the first ready
        # batch only proves the fastest workers imported
        self._timeout_s = float(os.environ.get('PUFFER_HOST_TIMEOUT_S', 30))
        self._first_timeout_s = max(self._timeout_s, float(
            os.environ.get('PUFFER_HOST_FIRST_TIMEOUT_S', 300)))
        self._contacted = set()

        self.processes = [None] * num_workers
        self.send_pipes = [None] * num_workers
        self.recv_pipes = [None] * num_workers
        creators_list = env_creators if isinstance(
            env_creators, (list, tuple)) else None
        self._spawn_spec = (env_creators, creators_list, env_args,
            env_kwargs, obs_shape, np.dtype(obs_space.dtype), atn_shape,
            np.dtype(atn_space.dtype), oversubscribed)
        # elastic recovery: >0 allows that many dead-worker respawns
        # before giving up (the reference has no recovery at all —
        # SURVEY.md aux; 0 reproduces its fail-fast behavior)
        self._restarts_left = int(kwargs.pop('restart_workers', 0) or 0)
        self._seeds = None  # last async_reset seeds, for re-seeding
        # workers revived since their last gather: their first batch
        # rows surface as zero-reward truncations (aborted episodes)
        self._pending_abort = set()
        self._last_alive_check = time.time()
        for i in range(num_workers):
            self._spawn_worker(i)

        self.agent_ids = np.arange(self.num_agents).reshape(
            num_workers, agents_per_worker)
        self.initialized = False
        self.flag = RESET
        self.prev_workers = ()
        # pipelined protocol state: worker groups recv'd but not yet
        # sent back (recv_async/send_to)
        self._outstanding = set()

        # native driver core (C++ spin + slab gather), or the Python loop
        self._lib = None if native is False else native_driver.load(
            required=bool(native))
        self._native = native_driver
        if self._lib is not None:
            B = self.agents_per_batch
            self._obs_batch = np.empty((B, *obs_shape),
                dtype=obs_space.dtype)
            self._rew_batch = np.empty(B, np.float32)
            self._term_batch = np.empty(B, bool)
            self._trunc_batch = np.empty(B, bool)
            self._mask_batch = np.empty(B, bool)

    def _spawn_worker(self, i, defer_start=False):
        """(Re)create worker i: fresh pipes + process over the same
        shared-memory slabs. Used at init and by elastic recovery.
        With defer_start the caller publishes protocol state (seeds,
        semaphore) before starting the child."""
        (env_creators, creators_list, env_args, env_kwargs, obs_shape,
            obs_dtype, atn_shape, atn_dtype,
            oversubscribed) = self._spawn_spec
        # each worker owns its contiguous slice of the creators
        worker_creators = env_creators if creators_list is None \
            else list(creators_list[i * self.envs_per_worker:
                (i + 1) * self.envs_per_worker])
        # on respawn: release the dead worker's pipe fds (and any
        # buffered INFO payload) instead of leaking them until GC
        for pipes in (self.send_pipes, self.recv_pipes):
            if pipes[i] is not None:
                try:
                    pipes[i].close()
                except OSError:
                    pass
        main_send, worker_recv = _mp.Pipe()
        worker_send, main_recv = _mp.Pipe()
        p = _mp.Process(target=_worker_process, args=(
            worker_creators, env_args, env_kwargs,
            self.envs_per_worker, obs_shape, obs_dtype, atn_shape,
            atn_dtype, self.agents_per_worker, i, worker_send,
            worker_recv, self.shm, oversubscribed), daemon=True)
        self.processes[i] = p
        self.send_pipes[i] = main_send
        self.recv_pipes[i] = main_recv
        if not defer_start:
            p.start()
        return p

    def _revive_dead(self):
        """Elastic recovery: respawn dead workers while the
        restart_workers budget lasts. The respawned worker re-seeds its
        env slice; the aborted episodes surface at the next gather as
        zero-reward truncations (_pending_abort). All-or-nothing: if the
        remaining budget cannot cover every dead worker, nothing is
        respawned and the caller fail-fasts. Returns True if workers
        were restarted."""
        dead = [i for i, p in enumerate(self.processes)
            if not p.is_alive()]
        if not dead or len(dead) > self._restarts_left:
            return False
        self._restarts_left -= len(dead)
        for i in dead:
            self._contacted.discard(i)  # fresh spawn/import allowance
            p = self._spawn_worker(i, defer_start=True)
            # publish seeds + RESET BEFORE the child starts: it must
            # never consume the dead worker's stale STEP semaphore
            if self._seeds is not None:
                self.send_pipes[i].send(
                    self._seeds[i * self.envs_per_worker:
                        (i + 1) * self.envs_per_worker])
            else:
                self.send_pipes[i].send(
                    make_seeds(getattr(self, 'seed', 42) + 1_000_003 * i,
                        self.envs_per_worker))
            self.sem[i] = RESET
            p.start()
            self._pending_abort.add(i)
        return True

    def async_reset(self, seed=None):
        self.flag = RECV
        if seed is None:
            seed = getattr(self, 'seed', 42)
        seeds = make_seeds(seed, self.num_workers * self.envs_per_worker)
        self._seeds = seeds
        for i in range(self.num_workers):
            lo = i * self.envs_per_worker
            self.send_pipes[i].send(seeds[lo:lo + self.envs_per_worker])
            self.sem[i] = RESET

    def _drain_infos(self, workers):
        infos = []
        for w in workers:
            if self.sem[w] == INFO:
                infos.extend(self.recv_pipes[w].recv())
                self.sem[w] = MAIN
        return infos

    def _wait_ready_python(self, candidates=None):
        if candidates is None:
            candidates = range(self.num_workers)
        ready = []
        last_alive_check = time.time()
        while len(ready) < self.workers_per_batch:
            for w in candidates:
                if w in ready:
                    continue
                if self.sem[w] in (MAIN, INFO):
                    ready.append(w)
                    if len(ready) == self.workers_per_batch:
                        break
            if self._spin_us == 0 and len(ready) < self.workers_per_batch:
                time.sleep(0.0002)  # oversubscribed: don't hot-spin
            if time.time() - last_alive_check > 1.0:
                last_alive_check = time.time()
                self._check_alive()
        return ready

    def _check_alive(self):
        """Raises on unrecoverable worker death; returns True if dead
        workers were revived (restart_workers budget), False if all
        workers are alive."""
        if any(not p.is_alive() for p in self.processes):
            if self._revive_dead():
                return True
            raise RuntimeError(
                'env worker died (creator must be a picklable '
                'module-level callable under spawn; pass '
                'restart_workers=N to auto-respawn crashed workers)')
        return False

    def _wait(self, candidates):
        """First workers_per_batch ready workers among `candidates`."""
        # elastic mode: a dead worker OUTSIDE the satisfied batch group
        # never trips the wait watchdog (envpool mode keeps being served
        # by the live workers) — sweep liveness periodically so its env
        # slice doesn't silently drop out of training
        if self._restarts_left > 0 and \
                time.time() - self._last_alive_check > 1.0:
            self._last_alive_check = time.time()
            self._revive_dead()
        while True:
            timeout_s = self._timeout_s if self._contacted.issuperset(
                candidates) else self._first_timeout_s
            if self._lib is None:
                ready = self._wait_ready_python(candidates)
                break
            # C++ spin (GIL released) with a watchdog
            try:
                ready = self._native.wait_ready(self._lib, self.sem,
                    np.asarray(candidates, dtype=np.int32),
                    self.workers_per_batch,
                    timeout_us=int(timeout_s * 1e6),
                    spin_us=self._spin_us)
            except TimeoutError:
                if self._check_alive():  # raises if unrecoverable
                    continue  # revived a dead worker: wait again
                raise  # all workers alive: genuine stall
            ready = ready.tolist()
            break
        self._contacted.update(ready)
        return ready

    def _gather(self, ready, copy):
        infos = self._drain_infos(ready)
        idx = self.agent_ids[list(ready)].ravel()

        if self._lib is not None:
            # one-pass slab -> batch gather per array (C++ memcpy)
            apw = self.agents_per_worker
            blocks = np.asarray(ready, np.int64)
            g = self._native
            obs_row = self.obs_arr.dtype.itemsize * int(
                np.prod(self.obs_arr.shape[1:]))
            g.gather_rows(self._lib, self.obs_arr, self._obs_batch,
                blocks, obs_row * apw)
            g.gather_rows(self._lib, self.rew_arr, self._rew_batch,
                blocks, 4 * apw)
            g.gather_rows(self._lib, self.term_arr, self._term_batch,
                blocks, apw)
            g.gather_rows(self._lib, self.trunc_arr, self._trunc_batch,
                blocks, apw)
            g.gather_rows(self._lib, self.mask_arr, self._mask_batch,
                blocks, apw)
            self._mark_aborted(ready, self._rew_batch, self._trunc_batch)
            if not copy:
                return (self._obs_batch, self._rew_batch,
                    self._term_batch, self._trunc_batch, infos, idx,
                    self._mask_batch)
            return (self._obs_batch.copy(), self._rew_batch.copy(),
                self._term_batch.copy(), self._trunc_batch.copy(),
                infos, idx, self._mask_batch.copy())

        rew, trunc = self.rew_arr[idx], self.trunc_arr[idx]
        self._mark_aborted(ready, rew, trunc)
        return (self.obs_arr[idx], rew, self.term_arr[idx],
            trunc, infos, idx, self.mask_arr[idx])

    def _mark_aborted(self, ready, rew, trunc):
        """First gathered batch of a revived worker: its in-flight
        episodes were lost to the crash — surface them as zero-reward
        truncations so the trainer cuts GAE/LSTM state there instead of
        stitching the dead episode into the fresh reset (the worker's
        own reset cleared the slab flags, so this is driver-side)."""
        aborted = self._pending_abort.intersection(ready)
        if not aborted:
            return
        apw = self.agents_per_worker
        order = list(ready)
        for w in aborted:
            k = order.index(w)
            rew[k * apw:(k + 1) * apw] = 0.0
            trunc[k * apw:(k + 1) * apw] = True
        self._pending_abort.difference_update(aborted)

    def recv(self):
        recv_precheck(self)
        ready = self._wait(np.arange(self.num_workers, dtype=np.int32))
        if self.workers_per_batch == self.num_workers:
            # full-sync mode returns worker order (reference
            # vector.py:352-361); async modes keep completion order
            ready = sorted(ready)
        self.prev_workers = tuple(ready)
        return self._gather(ready, copy=not self.zero_copy)

    def send(self, actions):
        send_precheck(self)
        self._dispatch_actions(actions, self.prev_workers)
        # mixed use: a plain send() answering a recv_async batch must
        # release its workers or they stay excluded from future waits
        self._outstanding.difference_update(self.prev_workers)

    def _dispatch_actions(self, actions, workers):
        actions = np.asarray(actions)
        idx = self.agent_ids[list(workers)].ravel()
        self.atn_arr[idx] = actions.reshape(
            (len(idx),) + self.atn_arr.shape[1:])
        for w in workers:
            self.sem[w] = STEP

    # ---- pipelined protocol (double-buffered rollouts) ---------------
    # recv_async/send_to relax the strict recv->send alternation: the
    # driver may hold several recv'd batches "outstanding" and answer
    # them out of band by token, so a device forward for batch B can be
    # dispatched BEFORE batch A's results are fetched (the host trainer
    # overlaps accelerator round-trips this way; reference analog:
    # the async envpool rationale, vector.py:329-410).

    @property
    def supports_pipeline(self):
        """True when >= 2 disjoint worker groups exist, so one can be
        in flight on the device while another is being recv'd."""
        return self.num_workers >= 2 * self.workers_per_batch

    def recv_async(self):
        """Like recv(), but returns (..., token) and leaves the batch
        outstanding until send_to(actions, token). Always copies (the
        scratch batch buffers are reused by the next recv)."""
        if self.flag == RESET:
            raise APIUsageError('recv_async before async_reset')
        candidates = [w for w in range(self.num_workers)
            if w not in self._outstanding]
        if len(candidates) < self.workers_per_batch:
            raise APIUsageError(
                'recv_async: every worker group is already outstanding; '
                'send_to one first')
        self.flag = SEND  # keep plain send() usable for the last batch
        ready = self._wait(np.asarray(candidates, dtype=np.int32))
        token = tuple(ready)
        self._outstanding.update(ready)
        self.prev_workers = token
        out = self._gather(ready, copy=True)
        return out + (token,)

    def send_to(self, actions, token):
        """Answer an outstanding recv_async batch by token."""
        missing = [w for w in token if w not in self._outstanding]
        if missing:
            raise APIUsageError(f'send_to: workers {missing} are not '
                'outstanding (wrong or reused token)')
        self._dispatch_actions(actions, token)
        self._outstanding.difference_update(token)
        if not self._outstanding:
            self.flag = RECV

    def reset(self, seed=42):
        self.async_reset(seed)
        obs, _, _, _, infos, _, _ = self.recv()
        return obs, infos

    def step(self, actions):
        self.send(actions)
        obs, rew, term, trunc, infos, _, _ = self.recv()
        return obs, rew, term, trunc, infos

    def close(self):
        # ask workers to close their envs (releases emulator processes,
        # files, sockets), then join; terminate only as a fallback
        self.sem[:] = CLOSE
        deadline = time.time() + 2.0
        for p in self.processes:
            p.join(max(deadline - time.time(), 0.1))
        for p in self.processes:
            if p.is_alive():
                p.terminate()
        for pipe in self.send_pipes + self.recv_pipes:
            pipe.close()

    @property
    def num_envs(self):
        return self.agents_per_batch


def profile_env(env_creator, env_args=None, env_kwargs=None,
        time_per_test=2.0):
    """Single-env profile: SPS, step-time std %, reset %, RAM/env and
    obs bandwidth (reference vector.py:684-737)."""
    import psutil
    proc = psutil.Process()
    load_ram = proc.memory_info().rss
    # _wrap handles raw gymnasium/pettingzoo creators (method-style
    # observation_space(agent) etc.) exactly like the backends do
    env = _wrap(env_creator, env_args, env_kwargs)
    num_agents = env.num_agents
    obs_space = env.single_observation_space
    atn_space = env.single_action_space
    env.reset(seed=0)
    if num_agents == 1:
        actions = [atn_space.sample() for _ in range(1000)]
    else:
        actions = [np.stack([atn_space.sample()
            for _ in range(num_agents)]) for _ in range(1000)]

    steps = 0
    idle_ram = proc.memory_info().rss
    step_times, reset_times = [], []
    start = time.time()
    while time.time() - start < time_per_test:
        s = time.time()
        if env.done:
            env.reset()
            reset_times.append(time.time() - s)
        else:
            env.step(actions[steps % 1000])
            step_times.append(time.time() - s)
        steps += 1
        idle_ram = max(idle_ram, proc.memory_info().rss)
    env.close()

    sum_time = sum(step_times) + sum(reset_times)
    sps = steps * num_agents / max(sum_time, 1e-9)
    obs_size_gb = (np.prod(obs_space.shape)
        * np.dtype(obs_space.dtype).itemsize * num_agents / 1e9)
    cores = psutil.cpu_count(logical=False) or 1
    prof = namespace(
        sps=sps,
        step_std_pct=100 * float(np.std(step_times))
            / max(float(np.mean(step_times)), 1e-9) if step_times else 0.0,
        reset_pct=100 * sum(reset_times) / max(sum_time, 1e-9),
        ram_gb_per_env=max(1, idle_ram - load_ram) / 1e9,
        obs_size_gb=obs_size_gb,
        bandwidth_gbs=obs_size_gb * sps,
        num_cores=cores,
        num_agents=num_agents,
    )
    prof.throughput_gbs = prof.bandwidth_gbs * cores
    return prof


def _candidate_configs(batch_size, max_envs, cores, throughput):
    """The reference's 5 candidate strategies (vector.py:760-820):
    one-batch-per-core, full-async, contiguous-blocks, full-sync,
    serial."""
    configs = []
    # 1: one batch per core
    strategy_cores = max(min(cores, max_envs // batch_size), 1)
    configs.append(dict(num_envs=batch_size * strategy_cores,
        num_workers=strategy_cores, batch_size=batch_size,
        backend=HostMultiprocessing))
    # 2/3: full async + contiguous blocks over envs_per_worker ladder
    min_epw = int(np.ceil((batch_size + 1) / cores))
    for envs_per_worker in range(max(min_epw, 1), batch_size + 1):
        num_envs = envs_per_worker * cores
        if num_envs > max_envs:
            break
        if batch_size % envs_per_worker != 0:
            continue
        if num_envs % batch_size != 0:
            continue  # make() requires num_envs % batch_size == 0
        # full async (copies out of the slabs)
        configs.append(dict(num_envs=num_envs, num_workers=cores,
            batch_size=batch_size, zero_copy=False,
            backend=HostMultiprocessing))
        if throughput > 0.5:
            # contiguous blocks, zero-copy (reference strategy 3)
            configs.append(dict(num_envs=num_envs, num_workers=cores,
                batch_size=batch_size, zero_copy=True,
                backend=HostMultiprocessing))
    # 4: full sync
    for strategy_cores in range(cores, 1, -1):
        if batch_size % strategy_cores == 0:
            configs.append(dict(num_envs=batch_size,
                num_workers=strategy_cores, batch_size=batch_size,
                backend=HostMultiprocessing))
    # 5: serial
    configs.append(dict(num_envs=batch_size, backend=HostSerial))
    # dedup preserving order
    seen, out = set(), []
    for c in configs:
        key = (c['num_envs'], c.get('num_workers'),
            c.get('batch_size'), c.get('zero_copy'),
            c['backend'].__name__)
        if key not in seen:
            seen.add(key)
            out.append(c)
    return out


def autotune(env_creator, env_args=None, env_kwargs=None, batch_size=None,
        max_envs=64, max_env_ram_gb=32, max_batch_hbm_gb=0.05,
        time_per_config=2.0, max_configs=None):
    """Find the best host-envpool config (reference vector.py:669-854):
    profile a single env (SPS / step std / reset % / RAM / bandwidth),
    cap env counts by RAM and core divisibility, then benchmark the
    reference's 5 candidate strategies and report the winner."""
    prof = profile_env(env_creator, env_args, env_kwargs,
        time_per_test=min(time_per_config, 2.0))
    cores = prof.num_cores
    print('Profile complete')
    print(f'    SPS: {prof.sps:.3f}')
    print(f'    STD: {prof.step_std_pct:.3f}%')
    print(f'    Reset: {prof.reset_pct:.3f}%')
    print(f'    RAM: {1000 * prof.ram_gb_per_env:.3f} MB/env')
    print(f'    Bandwidth: {prof.bandwidth_gbs:.3f} GB/s')
    print(f'    Throughput: {prof.throughput_gbs:.3f} GB/s '
        f'({cores} cores)')

    # cap envs by RAM FIRST so batch_size and every candidate config
    # respect the budget (reference vector.py:741-745)
    max_by_ram = int(max_env_ram_gb // prof.ram_gb_per_env)
    if max_by_ram < max_envs:
        max_envs = max(max_by_ram, 1)
        print(f'Reducing max envs to {max_envs} based on RAM')
    if batch_size is None:
        batch_size = max(min(max_envs, 2 * cores) // 2, 1)
    if max_envs < batch_size:
        raise APIUsageError('max_envs < batch_size')
    # cap by core divisibility (reference :752-756)
    hardware_envs = max_envs - (max_envs % cores)
    if hardware_envs > batch_size and hardware_envs != max_envs:
        max_envs = hardware_envs
        print(f'Reducing max envs to {max_envs} based on core division')
    # batch obs must fit the device staging budget (reference :758
    # checks VRAM)
    if max_batch_hbm_gb // max(prof.obs_size_gb, 1e-12) < batch_size:
        raise APIUsageError('batch obs exceed max_batch_hbm_gb')

    configs = _candidate_configs(batch_size, max_envs, cores,
        prof.throughput_gbs)
    if max_configs:
        configs = configs[:max_configs]
    results = []
    for config in configs:
        desc = {k: (v.__name__ if k == 'backend' else v)
            for k, v in config.items()}
        try:
            vec = make(env_creator, env_args, env_kwargs, **config)
            vec.async_reset()
            obs, *_ = vec.recv()
            steps = 0
            start = time.time()
            while time.time() - start < time_per_config:
                vec.send(np.zeros((len(obs),
                    *vec.single_action_space.shape), np.int64))
                obs, *_ = vec.recv()
                steps += len(obs)
            sps = steps / (time.time() - start)
            vec.close()
            results.append((sps, desc))
            print(f'SPS: {sps:.0f}  {desc}')
        except Exception as e:
            print(f'failed: {desc}: {e}')
    if not results:
        return None
    best_sps, best = max(results, key=lambda kv: kv[0])
    print(f'Best: {best} ({best_sps:.0f} SPS)')
    return namespace(profile=prof, best=best, best_sps=best_sps,
        results=results)


class HostRay:
    """Ray-actor envpool: each remote actor runs a HostSerial of
    envs_per_worker envs (reference vector.py:449-574). batch_size <
    num_envs enables env-pool mode via ray.wait on first-ready actors.

    Requires ray, imported at construction; raises ImportError naming it
    where it is not installed.
    """

    def __init__(self, env_creators, env_args=None, env_kwargs=None,
            num_envs=1, num_workers=None, batch_size=None, seed=42,
            **kwargs):
        self.seed = seed
        try:
            import ray
        except ImportError as e:
            raise ImportError(
                'HostRay requires ray, which is not installed; use '
                'HostMultiprocessing instead') from e
        if not ray.is_initialized():
            ray.init(include_dashboard=False, ignore_reinit_error=True)
        self._ray = ray

        num_workers = num_workers or num_envs
        if num_envs % num_workers != 0:
            raise APIUsageError('num_envs must be divisible by num_workers')
        envs_per_worker = num_envs // num_workers
        batch_size = batch_size or num_envs
        if num_envs % batch_size != 0:
            raise APIUsageError('num_envs must be divisible by batch_size')
        self.workers_per_batch = batch_size // envs_per_worker
        if self.workers_per_batch < 1:
            raise APIUsageError('batch_size must be >= envs_per_worker')
        self.envs_per_worker = envs_per_worker
        self.num_workers = num_workers
        self.batch_size = batch_size
        self.env_pool = batch_size != num_envs

        driver = _wrap(env_creators if not isinstance(
            env_creators, (list, tuple)) else env_creators[0],
            env_args, env_kwargs)
        self.driver_env = driver
        self.emulated = driver.emulated
        self.agents_per_env = driver.num_agents
        self.num_agents = num_envs * driver.num_agents
        self.agents_per_worker = driver.num_agents * envs_per_worker
        self.agents_per_batch = self.workers_per_batch \
            * self.agents_per_worker
        self.single_observation_space = driver.single_observation_space
        self.single_action_space = driver.single_action_space
        driver.close()

        remote_serial = ray.remote(HostSerial)
        self.workers = [remote_serial.remote(
            env_creators, env_args, env_kwargs, num_envs=envs_per_worker)
            for _ in range(num_workers)]
        self.futures = None
        self.prev_env_ids = list(range(self.workers_per_batch))
        self.flag = RESET
        self.initialized = False

    def async_reset(self, seed=None):
        self.flag = RECV
        if seed is None:
            seed = getattr(self, 'seed', 42)
        self.futures = [w.reset.remote(seed + i * self.envs_per_worker)
            for i, w in enumerate(self.workers)]
        # per-future kind: reset futures return (obs, infos), step
        # futures a 5-tuple — both kinds coexist in env-pool mode
        self.future_kind = ['reset'] * self.num_workers

    def _normalize(self, result, kind):
        a = self.agents_per_worker
        if kind == 'reset':
            obs, infos = result
            return (obs, np.zeros(a, np.float32), np.zeros(a, bool),
                np.zeros(a, bool), infos or [])
        obs, rew, term, trunc, infos = result
        return obs, rew, term, trunc, (infos or [])

    def recv(self):
        recv_precheck(self)
        ray = self._ray
        if self.env_pool:
            ready, _ = ray.wait(
                self.futures, num_returns=self.workers_per_batch)
            env_ids = [self.futures.index(f) for f in ready]
            results = ray.get(ready)
        else:
            env_ids = list(range(self.workers_per_batch))
            results = ray.get(self.futures[:self.workers_per_batch])
        self.prev_env_ids = env_ids

        results = [self._normalize(r, self.future_kind[e])
            for e, r in zip(env_ids, results)]
        obs = np.concatenate([r[0] for r in results])
        rew = np.concatenate([r[1] for r in results])
        term = np.concatenate([r[2] for r in results])
        trunc = np.concatenate([r[3] for r in results])
        infos = [i for r in results for i in r[4]]
        agent_ids = np.concatenate([np.arange(
            e * self.agents_per_worker, (e + 1) * self.agents_per_worker)
            for e in env_ids])
        mask = np.ones(self.agents_per_batch, bool)
        return obs, rew, term, trunc, infos, agent_ids, mask

    def send(self, actions):
        send_precheck(self)
        actions = np.asarray(actions)
        per_worker = np.array_split(actions, self.workers_per_batch)
        for e, atns in zip(self.prev_env_ids, per_worker):
            self.futures[e] = self.workers[e].step.remote(atns)
            self.future_kind[e] = 'step'

    def reset(self, seed=42):
        self.async_reset(seed)
        obs, _, _, _, infos, _, _ = self.recv()
        return obs, infos

    def step(self, actions):
        self.send(actions)
        return self.recv()[:5]

    def close(self):
        for w in self.workers:
            self._ray.kill(w)

    @property
    def num_envs(self):
        return self.num_agents


def make(env_creator, env_args=None, env_kwargs=None, backend=HostSerial,
        num_envs=1, num_workers=None, batch_size=None, seed=42, **kwargs):
    """Host vectorization factory (reference vector.py:577-637)."""
    if num_envs < 1:
        raise APIUsageError('num_envs must be at least 1')
    if batch_size is not None and num_envs % batch_size != 0:
        raise APIUsageError('num_envs must be divisible by batch_size')
    if backend in (HostMultiprocessing, HostRay):
        return backend(env_creator, env_args, env_kwargs,
            num_envs=num_envs, num_workers=num_workers,
            batch_size=batch_size, seed=seed, **kwargs)
    return HostSerial(env_creator, env_args, env_kwargs,
        num_envs=num_envs, seed=seed, **kwargs)
