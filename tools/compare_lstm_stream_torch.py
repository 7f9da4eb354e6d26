"""Builds of the streamed LSTM design timed in turns on one NVIDIA GPU.

    python3 tools/compare_lstm_stream_torch.py TREE [TREE ...] [--trainer]

Each TREE is the root of a checkout of this repository (`.` for this
one). The trees run in turns, first to last and back again (for two:
A, B, B, A), on one card: two builds are compared only within one run
(two runs may land on two cards with other power limits). Each
turn runs the tree's own tools/profile_lstm_stream_torch.py as a child
process at each of CASES: enc5's streamed pair at the default route's
hidden 256 (T 16, B 8192, F 49, D = H = 256) and cat's at the Atari
update's shape (T 16, B 256, D = H = 512), in f32 and bf16, and keeps
each call's time by CUDA events with a cold L2 and its kernels per call.
With --trainer a turn also runs the tree's tools/profile_torch_trainer.py
--lstm --hidden 256 (which must take --hidden) and keeps the update's
kernel time and wall time. Prints a line per reading and, last, one JSON
object with every reading and the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys

# (kind, T,B,D,H[,F], dtype)
CASES = (('enc5', '16,8192,256,256,49', 'float32'),
    ('enc5', '16,8192,256,256,49', 'bfloat16'),
    ('cat', '16,256,512,512', 'float32'),
    ('cat', '16,256,512,512', 'bfloat16'))


def last_json(tree, args):
    """The last line of a tree's tool run as a child process, parsed."""
    out = subprocess.run([sys.executable, *args], cwd=tree, check=True,
        stdout=subprocess.PIPE, text=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('trees', nargs='+')
    parser.add_argument('--trainer', action='store_true')
    args = parser.parse_args()
    trees = [os.path.abspath(t) for t in args.trees]
    order = trees + trees[::-1]
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
        '--format=csv,noheader'], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip().splitlines()[0]
    readings = []
    for turn, tree in enumerate(order):
        for kind, shape, dtype in CASES:
            r = last_json(tree, ['tools/profile_lstm_stream_torch.py',
                '--kind', kind, '--shape', shape, '--dtype', dtype])
            for part in ('forward', 'backward'):
                readings.append(dict(turn=turn, tree=tree, kind=kind,
                    shape=shape, dtype=dtype, part=part,
                    ms=r[part]['event_ms'],
                    kernels=r[part]['kernels_counted']))
                print(f'turn {turn} {tree}: {kind} {shape} {dtype} {part} '
                    f'{r[part]["event_ms"]:.4f} ms, '
                    f'{r[part]["kernels_counted"]} kernels', flush=True)
        if args.trainer:
            r = last_json(tree, ['tools/profile_torch_trainer.py', '--lstm',
                '--hidden', '256'])
            readings.append(dict(turn=turn, tree=tree, kind='trainer',
                shape='hidden 256', dtype='bfloat16', part='update',
                ms=r['update']['device_ms'], wall_ms=r['update']['wall_ms']))
            print(f'turn {turn} {tree}: trainer hidden 256 update kernels '
                f'{r["update"]["device_ms"]:.2f} ms, wall '
                f'{r["update"]["wall_ms"]:.2f} ms', flush=True)
    print(json.dumps(dict(card=card, readings=readings)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
