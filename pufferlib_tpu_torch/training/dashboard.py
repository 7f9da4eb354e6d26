"""Rich terminal dashboard + utilization sampling (counterpart of
pufferlib_tpu/training/dashboard.py, same panes and text).

Parity (behavioral, not code): the reference trainer renders an
in-place rich TUI (clean_pufferl.py:603-738) with a header carrying
host/device utilization sampled by a daemon thread
(clean_pufferl.py:484-507), a summary pane (env/steps/SPS/epoch/
uptime/remaining), a per-phase perf breakdown, the PPO losses, user
stats, and a message line. The device gauge (HBM) is the share of the
trainer's card in use, from torch.cuda.mem_get_info; a trainer on the
CPU reads 0.
"""
import time
from collections import deque
from threading import Thread

import numpy as np

# Markup theme. `accent` paints labels/borders, `dim` paints unit
# suffixes and secondary text, `value` paints numbers, `soft` paints
# the header gauges.
THEME = {
    'accent': '[bright_cyan]',
    'dim': '[white]',
    'soft': '[cyan]',
    'value': '[bright_white]',
}
_A, _D, _S, _V = (THEME[k] for k in ('accent', 'dim', 'soft', 'value'))

# (divisor, suffix) ladder for human-scale numbers, largest first.
_MAGNITUDES = ((1e12, 't'), (1e9, 'b'), (1e6, 'm'), (1e3, 'k'))

# (unit suffix, seconds per unit) ladder for durations, largest first.
_TIME_UNITS = (('h', 3600), ('m', 60), ('s', 1))


def abbreviate(num):
    """1234567 -> '1.2m' (with theme markup around digits/suffix)."""
    for divisor, suffix in _MAGNITUDES:
        if num >= divisor:
            return f'{_V}{num / divisor:.1f}{_D}{suffix}'
    return f'{_V}{num:.0f}'


def duration(seconds):
    """Seconds -> 'Xh Ym Zs', omitting leading zero units."""
    remaining = int(seconds)
    parts = []
    for suffix, size in _TIME_UNITS:
        qty, remaining = divmod(remaining, size)
        if parts or qty or suffix == 's':
            parts.append(f'{_V}{qty}{_D}{suffix}')
    return ' '.join(parts)


def _share(t, total):
    """Integer percent of total, rounded down (0 when total is 0)."""
    if total <= 0:
        return 0
    return min(int((t / total) * 100), 100)


def device_memory_fraction(device=None):
    """Share of the card's memory in use (0 for a CPU or no device). An
    error from the card propagates."""
    if device is None or device.type != 'cuda':
        return 0.0
    import torch
    free, total = torch.cuda.mem_get_info(device)
    return (total - free) / max(total, 1)


class Utilization(Thread):
    """Daemon sampler of host CPU/mem + the card's memory (of `device`,
    a torch.device; 0 where None or a CPU) into fixed-length deques, read
    by the dashboard header (reference behavior:
    clean_pufferl.py:484-507)."""

    def __init__(self, delay=1, maxlen=20, device=None):
        super().__init__(daemon=True)
        self.device = device
        self.cpu_mem = deque(maxlen=maxlen)
        self.cpu_util = deque(maxlen=maxlen)
        self.device_mem = deque(maxlen=maxlen)
        self.delay = delay
        self.stopped = False
        try:
            import psutil
            self._psutil = psutil
        except ImportError:
            self._psutil = None
        self.start()

    def run(self):
        while not self.stopped:
            if self._psutil is not None:
                self.cpu_util.append(self._psutil.cpu_percent())
                mem = self._psutil.virtual_memory()
                self.cpu_mem.append(100 * mem.active / mem.total)
            self.device_mem.append(100 * device_memory_fraction(self.device))
            time.sleep(self.delay)

    def stop(self):
        self.stopped = True


def _mean(dq):
    return float(np.mean(dq)) if len(dq) else 0.0


_BOX_CACHE = {}


def _rounded_box():
    """A rich Box with rounded corners and no interior rules, built
    from its corner/edge glyphs rather than a pasted template."""
    if 'round_open' not in _BOX_CACHE:
        import rich.box
        top = '╭──╮'    # rounded top corners
        side = '│  │'             # vertical edges, open middle
        bottom = '╰──╯'  # rounded bottom corners
        rows = [top] + [side] * 6 + [bottom]
        _BOX_CACHE['round_open'] = rich.box.Box('\n'.join(rows) + '\n')
    return _BOX_CACHE['round_open']


def _header_pane(Table, env_name, utilization):
    header = Table(box=None, expand=True, show_header=False)
    header.add_column(justify='left', width=30)
    header.add_column(justify='center', width=12)
    header.add_column(justify='center', width=12)
    header.add_column(justify='right', width=13)
    gauges = (
        ('CPU', _mean(utilization.cpu_util)),
        ('DRAM', _mean(utilization.cpu_mem)),
        ('HBM', _mean(utilization.device_mem)),
    )
    header.add_row(
        f':blowfish: {_A}PufferLib-TPU {_V}0.1',
        *(f'{_A}{name}: {_S}{pct:.1f}%' for name, pct in gauges),
    )
    return header


def _summary_pane(Table, env_name, global_step, epoch, profile):
    pane = Table(box=None, expand=True)
    pane.add_column(f'{_A}Summary', justify='left', vertical='top',
        width=16)
    pane.add_column(f'{_A}Value', justify='right', vertical='top',
        width=8)
    rows = (
        ('Environment', f'{_V}{env_name}'),
        ('Agent Steps', abbreviate(global_step)),
        ('SPS', abbreviate(profile.SPS)),
        ('Epoch', abbreviate(epoch)),
        ('Uptime', duration(profile.uptime)),
        ('Remaining', duration(profile.remaining)),
    )
    for label, value in rows:
        pane.add_row(f'{_D}{label}', value)
    return pane


# Perf pane layout: (label, profile attribute). Indented labels are
# sub-phases of the preceding top-level phase.
_PERF_ROWS = (
    ('Evaluate', 'eval_time'),
    ('  Forward', 'eval_forward_time'),
    ('  Env', 'env_time'),
    ('  Misc', 'eval_misc_time'),
    ('Train', 'train_time'),
    ('  Forward', 'train_forward_time'),
    ('  Learn', 'learn_time'),
    ('  Misc', 'train_misc_time'),
)


def _perf_pane(Table, profile):
    pane = Table(box=None, expand=True, show_header=False)
    pane.add_column(f'{_A}Performance', justify='left', width=10)
    pane.add_column(f'{_A}Time', justify='right', width=8)
    pane.add_column(f'{_A}%', justify='right', width=4)
    for label, attr in _PERF_ROWS:
        t = getattr(profile, attr)
        pane.add_row(f'{_A}{label}', duration(t),
            f'{_V}{_share(t, profile.uptime):2d}%')
    return pane


def _losses_pane(Table, losses):
    pane = Table(box=None, expand=True)
    pane.add_column(f'{_A}Losses', justify='left', width=16)
    pane.add_column(f'{_A}Value', justify='right', width=8)
    for metric, value in losses.items():
        pane.add_row(f'{_D}{metric}', f'{_V}{value:.3f}')
    return pane


def _stats_panes(Table, stats, max_stats):
    """Two side-by-side User Stats columns; non-numeric values (media
    objects etc.) are skipped. Pads to the tallest height seen so the
    in-place redraw never leaves stale rows behind."""
    columns = [Table(box=None, expand=True) for _ in range(2)]
    for col in columns:
        col.add_column(f'{_A}User Stats', justify='left', width=20)
        col.add_column(f'{_A}Value', justify='right', width=10)
    n = 0
    for metric, value in stats.items():
        try:
            value = float(value)
        except (TypeError, ValueError):
            continue
        columns[n % 2].add_row(f'{_D}{metric}', f'{_V}{value:.3f}')
        n += 1
    for pad in range(max_stats[0] - n):
        columns[pad % 2].add_row('', '')
    max_stats[0] = max(max_stats[0], n)
    return columns


def print_dashboard(env_name, utilization, global_step, epoch, profile,
        losses, stats, msg, clear=False, max_stats=[0]):
    from rich.console import Console
    from rich.table import Table

    console = Console()
    if clear:
        console.clear()

    frame = Table(box=_rounded_box(), expand=True, show_header=False,
        border_style='bright_cyan')
    frame.add_row(_header_pane(Table, env_name, utilization))

    monitor = Table(box=None, expand=True, pad_edge=False)
    monitor.add_row(
        _summary_pane(Table, env_name, global_step, epoch, profile),
        _perf_pane(Table, profile),
        _losses_pane(Table, losses),
    )
    frame.add_row(monitor)

    user = Table(box=None, expand=True, pad_edge=False)
    user.add_row(*_stats_panes(Table, stats, max_stats))
    frame.add_row(user)

    footer = Table(box=None, expand=True, pad_edge=False)
    footer.add_row(f' {_A}Message: {_D}{msg}')
    frame.add_row(footer)

    with console.capture() as capture:
        console.print(frame)
    # Repaint in place: jump the cursor home, then draw the new frame.
    print('\033[0;0H' + capture.get())


def make_dashboard_hook(clear_first=True):
    """Returns a data->None hook pluggable into training.ppo data.dashboard."""
    state = {'first': clear_first}

    def hook(data):
        print_dashboard(data.config.env, data.utilization,
            data.global_step, data.epoch, data.profile, data.losses,
            data.stats, data.msg, clear=state.pop('first', False))

    return hook
