"""Builds of the resident tensor-core LSTM kernels timed in turns on one
NVIDIA GPU.

    python3 tools/compare_lstm_tc_torch.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository (`.` for this
one). The trees run in turns, first to last and back again (for two:
A, B, B, A), on one card: two builds are compared only within one run
(two runs may land on two cards with other power limits). Each turn runs,
as a child process in the tree, that tree's own chip_smoke.check_lstm
(timed: CUDA events, cold L2, mean of 20) on the bf16 kernel pairs of
lstm_scan (row 6), lstm_scan_fused (7), lstm_scan_cat (5) and enc5 (3 fwd
/ 4) at T 16, B 8192, D = H = 128 (enc5: F 49), and its own
chip_smoke.time_tc_phases for the kinds it has phases of: the last
backward phase of fused, cat and enc5 is their weight gradients (the
split-K and db's ordered sum), scan's is dW_hh alone. Each tree builds
its kernels from its own sources at its first turn. Prints a line per
reading and, last, one JSON object with every reading and the card's name
and power limit.
"""
import argparse
import json
import os
import subprocess
import sys

KINDS = ('scan', 'fused', 'cat', 'enc5')

# run inside a tree: its own chip_smoke, its own kernels
CHILD = r'''
import json, sys
import numpy as np
import torch
sys.path.insert(0, '.')
import chip_smoke
flush = chip_smoke.l2_flush_buffer()
out = {}
for kind in KINDS:
    r = chip_smoke.check_lstm(torch, flush, np.random.RandomState(0), kind,
        8192, 'bfloat16', timed=True)
    out[kind] = {'forward': r['fwd_ms'], 'backward': r['bwd_ms']}
    try:
        phases = chip_smoke.time_tc_phases(torch, flush,
            np.random.RandomState(0), kind)
    except (KeyError, TypeError):
        # an older tree whose kind has no phases
        phases = None
    out[kind]['phases'] = phases
print(json.dumps(out))
'''


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('trees', nargs='+')
    args = parser.parse_args()
    trees = [os.path.abspath(t) for t in args.trees]
    order = trees + trees[::-1]
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
        '--format=csv,noheader'], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip().splitlines()[0]
    code = f'KINDS = {KINDS!r}\n' + CHILD
    readings = []
    for turn, tree in enumerate(order):
        out = subprocess.run([sys.executable, '-c', code], cwd=tree,
            check=True, stdout=subprocess.PIPE, text=True).stdout
        result = json.loads(out.strip().splitlines()[-1])
        for kind, r in result.items():
            for part in ('forward', 'backward'):
                readings.append(dict(turn=turn, tree=tree, kind=kind,
                    part=part, ms=r[part]))
            for name, ms in (r['phases'] or {}).items():
                readings.append(dict(turn=turn, tree=tree, kind=kind,
                    part=name, ms=ms))
            print(f'turn {turn} {tree}: {kind} forward {r["forward"]:.4f} '
                f'ms, backward {r["backward"]:.4f} ms; phases '
                + json.dumps(r['phases']), flush=True)
    print(json.dumps(dict(card=card, shape='T=16 B=8192 D=H=128 (enc5 F=49) '
        'bf16', readings=readings)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
