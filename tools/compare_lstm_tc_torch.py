"""Builds of the resident tensor-core LSTM kernels timed in turns on one
NVIDIA GPU.

    python3 tools/compare_lstm_tc_torch.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository (`.` for this
one). The trees run in turns, first to last and back again (for two:
A, B, B, A), on one card: two builds are compared only within one run
(two runs may land on two cards with other power limits). Each turn runs,
as a child process in the tree, that tree's own chip_smoke.check_lstm
(timed: CUDA events, cold L2, mean of 20) on the bf16 kernel pairs of
lstm_scan (row 6), lstm_scan_fused (7), lstm_scan_cat (5), enc5 (3 fwd /
4) and the archived enc2 (8), enc3 (3 fwd / 9), enc4 (3 fwd / 10) and
enc6 (3 fwd / 11) at T 16, B 8192, D = H = 128 (the encoder kinds: F
49), and its own chip_smoke.time_tc_phases for the kinds it has phases
of: the last backward phase of fused, cat, enc5 and the archived kinds
is their weight gradients (the split-K and db's ordered sum), scan's is
dW_hh alone. An older tree whose archived backwards run on FMA has no
phases of them: its whole backward is timed alone. Each turn also prints, for each kind, the SHA-256 of every output
and gradient of one forward and backward call on inputs from a fixed
seed: two trees whose digests of a kind agree compute it bit for bit
alike. Each tree builds
its kernels from its own sources at its first turn. Prints a line per
reading and, last, one JSON object with every reading and the card's name
and power limit.
"""
import argparse
import json
import os
import subprocess
import sys

KINDS = ('scan', 'fused', 'cat', 'enc5', 'enc2', 'enc3', 'enc4', 'enc6')

# run inside a tree: its own chip_smoke, its own kernels
CHILD = r'''
import hashlib, json, sys
import numpy as np
import torch
sys.path.insert(0, '.')
import chip_smoke


def digest(kind):
    fwd, bwd = chip_smoke.lstm_kinds()[kind][:2]
    args, grads, cdt = chip_smoke.lstm_case(torch, np.random.RandomState(1),
        kind, 16, 8192, 'bfloat16')
    with torch.no_grad():
        outs = fwd(*args, cdt)
        outs = tuple(outs) + tuple(bwd(*args, outs[0], outs[3], *grads, cdt))
    h = hashlib.sha256()
    for t in outs:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


flush = chip_smoke.l2_flush_buffer()
out = {}
for kind in KINDS:
    r = chip_smoke.check_lstm(torch, flush, np.random.RandomState(0), kind,
        8192, 'bfloat16', timed=True)
    out[kind] = {'forward': r['fwd_ms'], 'backward': r['bwd_ms'],
        'digest': digest(kind)}
    try:
        phases = chip_smoke.time_tc_phases(torch, flush,
            np.random.RandomState(0), kind)
    except (KeyError, TypeError, IndexError):
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
            readings.append(dict(turn=turn, tree=tree, kind=kind,
                part='digest', digest=r['digest']))
            for name, ms in (r['phases'] or {}).items():
                readings.append(dict(turn=turn, tree=tree, kind=kind,
                    part=name, ms=ms))
            print(f'turn {turn} {tree}: {kind} forward {r["forward"]:.4f} '
                f'ms, backward {r["backward"]:.4f} ms; digest {r["digest"]}; '
                'phases ' + json.dumps(r['phases']), flush=True)
    print(json.dumps(dict(card=card, shape='T=16 B=8192 D=H=128 (encoder '
        'kinds F=49) bf16', readings=readings)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
