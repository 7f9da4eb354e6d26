"""Trainer profiling: per-phase timers + SPS (pufferlib_tpu/training/
profile.py and the Profiler of pufferlib_tpu/utils.py).

Device work is asynchronous: a phase timer measures the device only where
the phase ends in a synchronising read (evaluate/train do; the fused
step does not)."""
import time

from pufferlib_tpu_torch.namespace import namespace


class Profiler:
    """Context-manager wall-clock timer with call accounting."""

    def __init__(self):
        self.elapsed = 0.0
        self.calls = 0
        self.prev = 0.0
        self._start = None

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *args):
        self.prev = time.perf_counter() - self._start
        self.elapsed += self.prev
        self.calls += 1
        self._start = None
        return False


def profile(fn):
    """Decorator accumulating a Profiler per function in
    first_argument._timers."""
    name = fn.__name__

    def wrapper(self, *args, **kwargs):
        if not hasattr(self, '_timers'):
            self._timers = {}
        if name not in self._timers:
            self._timers[name] = Profiler()
        with self._timers[name]:
            return fn(self, *args, **kwargs)

    wrapper.__name__ = name
    return wrapper


def make_losses():
    return namespace(
        policy_loss=0.0,
        value_loss=0.0,
        entropy=0.0,
        old_approx_kl=0.0,
        approx_kl=0.0,
        clipfrac=0.0,
        explained_variance=0.0,
        grad_norm=0.0,
        adv_var=0.0,
    )


class Profile:
    SPS = 0
    uptime = 0
    remaining = 0
    eval_time = 0
    env_time = 0
    eval_forward_time = 0
    eval_misc_time = 0
    train_time = 0
    train_forward_time = 0
    learn_time = 0
    train_misc_time = 0

    def __init__(self):
        self.start = time.time()
        # minimum seconds between metric refreshes; callers may lower
        # it (tests set 0.0 to materialize metrics every step)
        self.interval = 1.0
        self.env = Profiler()
        self.eval_forward = Profiler()
        self.eval_misc = Profiler()
        self.train_forward = Profiler()
        self.learn = Profiler()
        self.train_misc = Profiler()
        self.prev_steps = 0

    def __iter__(self):
        yield 'SPS', self.SPS
        yield 'uptime', self.uptime
        yield 'remaining', self.remaining
        yield 'eval_time', self.eval_time
        yield 'env_time', self.env_time
        yield 'eval_forward_time', self.eval_forward_time
        yield 'eval_misc_time', self.eval_misc_time
        yield 'train_time', self.train_time
        yield 'train_forward_time', self.train_forward_time
        yield 'learn_time', self.learn_time
        yield 'train_misc_time', self.train_misc_time

    @property
    def epoch_time(self):
        return self.train_time + self.eval_time

    def update(self, data, interval_s=None):
        global_step = data.global_step
        if global_step == 0:
            return True
        if interval_s is None:
            interval_s = self.interval

        uptime = time.time() - self.start
        if uptime - self.uptime < interval_s:
            return False

        self.SPS = (global_step - self.prev_steps) / (uptime - self.uptime)
        self.prev_steps = global_step
        self.uptime = uptime
        self.remaining = (
            data.config.total_timesteps - global_step) / max(self.SPS, 1e-9)

        timers = getattr(data, '_timers', {})
        if 'evaluate' in timers:
            self.eval_time = timers['evaluate'].elapsed
        if 'train' in timers:
            self.train_time = timers['train'].elapsed
        self.env_time = self.env.elapsed
        self.eval_forward_time = self.eval_forward.elapsed
        self.eval_misc_time = self.eval_misc.elapsed
        self.train_forward_time = self.train_forward.elapsed
        self.learn_time = self.learn.elapsed
        self.train_misc_time = self.train_misc.elapsed
        return True
