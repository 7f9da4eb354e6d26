"""Builds of the resident LSTM kernels timed in turns on one NVIDIA GPU.

    python3 tools/compare_lstm_tc_torch.py [--dtype bfloat16|float32]...
        [--kind KIND]... TREE [TREE ...]

Each TREE is the root of a checkout of this repository (`.` for this
one). The trees run in turns, first to last and back again (for two:
A, B, B, A), on one card: two builds are compared only within one run
(two runs may land on two cards with other power limits). Each turn runs,
as a child process in the tree, that tree's own chip_smoke.check_lstm
(timed: CUDA events, cold L2, mean of 20) on the kernel pairs of
lstm_scan (row 6), lstm_scan_fused (7), lstm_scan_cat (5), enc5 (3 fwd /
4), lstm_scan_enc (3 fwd / 3 bwd), the archived enc2 (8), enc3 (3 fwd
/ 9), enc4 (3 fwd / 10) and enc6 (3 fwd / 11) and the archived tm (12:
one call, T launches each way) at T 16, B 8192, D = H = 128 (the encoder
kinds: F 49), once for each dtype given (bfloat16 by default); --kind
keeps only the kinds named (and their extra readings). In
bfloat16 it also runs the tree's own chip_smoke.time_tc_phases for the
kinds it has phases of (in float32 enc5's, cat's, fused's, enc's, the
archived enc2's, enc3's, enc4's and enc6's, and scan's and tm's backward,
where the tree's f32 kernels run phases):
the last backward phase of fused, cat, enc5, enc
and the archived encoder kinds is their weight gradients (the split-K and
db's ordered sum), scan's and tm's dW_hh alone. An older tree whose kind
runs on FMA (the archived backwards before their redesign, enc's step
backward and enc2's forward before theirs, tm before its) has no phases
of it: its whole call is timed alone. In float32 it also times enc5 at
memory's shape (config.yaml's memory section: T 8, B 512, F 1) and at
T 16, B 1000, enc5's streamed pair (lstm_enc_stream_*, called directly)
at T 16 with B 8192 and 1000, and cat, fused, enc, scan and the archived
enc2, enc3, enc4, enc6 and tm at T 16, B 1000; cat's
and fused's readings carry cuDNN's f32 nn.LSTM beside them; and cat at
D = H = 256 (T 16; B 512, 1000 and 1024: config.yaml's nethack, minihack
and nmmo updates, a ragged batch, nmmo3's) through lstm_scan_cat's
autograd, as a trainer's update calls it, so that each tree runs the
design its own route takes there (the reading's shape names it: a tree
before the resident pair took hidden 256 runs the streamed one), beside
cuDNN's f32 nn.LSTM and with the device memory through autograd. Each
turn also prints, for each
kind and dtype, the SHA-256 of every output and gradient of one forward
and backward call on inputs from a fixed seed, that of the forward's
outputs alone, and that of the backward's gradients alone, the backward
fed the plain forward's outputs (and the device memory through autograd
of cat, fused, enc5, enc, scan and the archived enc2, enc3, enc4, enc6
and tm, at each of their
shapes: the bytes held from the forward to the backward and the peak
over both): two trees whose digests of a kind agree
compute it bit for bit alike, and two whose forward (backward) digests
agree compute its forward (backward) so, whatever the other part does. Each
tree builds its kernels from its own sources at its first turn, each
source alone on first use, and that turn prints nvcc's seconds for each.
Prints a line per reading and, last, one JSON object with every reading
and the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys

KINDS = ('scan', 'fused', 'cat', 'enc5', 'enc', 'enc2', 'enc3', 'enc4',
    'enc6', 'tm')
# float32 only: (label, kind, T, B, F) of the enc5 pair's other shapes
F32_EXTRA = (('enc5 memory', 'enc5', 8, 512, 1),
    ('enc5 B=1000', 'enc5', 16, 1000, 49),
    ('enc5_stream', 'enc5_stream', 16, 8192, 49),
    ('enc5_stream B=1000', 'enc5_stream', 16, 1000, 49),
    ('cat B=1000', 'cat', 16, 1000, 49),
    ('fused B=1000', 'fused', 16, 1000, 49),
    ('enc B=1000', 'enc', 16, 1000, 49),
    ('enc2 B=1000', 'enc2', 16, 1000, 49),
    ('enc3 B=1000', 'enc3', 16, 1000, 49),
    ('enc4 B=1000', 'enc4', 16, 1000, 49),
    ('enc6 B=1000', 'enc6', 16, 1000, 49),
    ('scan B=1000', 'scan', 16, 1000, 49),
    ('tm B=1000', 'tm', 16, 1000, 49))
# float32 only: (label, T, B, H) of cat at D = H through lstm_scan_cat's
# autograd
ROUTE_F32 = (('cat route H=256 B=512', 16, 512, 256),
    ('cat route H=256 B=1000', 16, 1000, 256),
    ('cat route H=256 B=1024', 16, 1024, 256))

# run inside a tree: its own chip_smoke, its own kernels
CHILD = r'''
import hashlib, json, sys
import numpy as np
import torch
sys.path.insert(0, '.')
import chip_smoke
from pufferlib_tpu_torch.ops.cuda.archive.lstm_enc2 import lstm_scan_enc2
from pufferlib_tpu_torch.ops.cuda.archive.lstm_enc3 import lstm_scan_enc3
from pufferlib_tpu_torch.ops.cuda.archive.lstm_enc4 import lstm_scan_enc4
from pufferlib_tpu_torch.ops.cuda.archive.lstm_enc6 import lstm_scan_enc6
from pufferlib_tpu_torch.ops.cuda.archive.lstm_tm import lstm_scan_tm
from pufferlib_tpu_torch.ops.cuda.lstm_cat import lstm_scan_cat
from pufferlib_tpu_torch.ops.cuda.lstm_enc import (
    lstm_scan_enc, lstm_scan_enc5)
from pufferlib_tpu_torch.ops.cuda.lstm_scan import lstm_scan, lstm_scan_fused

# the kinds whose device memory through autograd a turn reads; those that
# take features behind the fused encoder; those that take x_proj
SCANS = {'cat': lstm_scan_cat, 'fused': lstm_scan_fused,
    'enc5': lstm_scan_enc5, 'enc': lstm_scan_enc, 'enc2': lstm_scan_enc2,
    'enc3': lstm_scan_enc3, 'enc4': lstm_scan_enc4, 'enc6': lstm_scan_enc6,
    'scan': lstm_scan, 'tm': lstm_scan_tm}
ENCODED = ('enc5', 'enc', 'enc2', 'enc3', 'enc4', 'enc6')
PROJECTED = ('scan', 'tm')


def sha(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def digests(kind):
    fwd, bwd, fwd_plain = chip_smoke.lstm_kinds()[kind][:3]
    args, grads, cdt = chip_smoke.lstm_case(torch, np.random.RandomState(1),
        kind, 16, 8192, DTYPE)
    with torch.no_grad():
        outs = fwd(*args, cdt)
        both = tuple(outs) + tuple(bwd(*args, outs[0], outs[3], *grads, cdt))
        plain = fwd_plain(*args, cdt)
        alone = bwd(*args, plain[0], plain[3], *grads, cdt)
    return sha(both), sha(outs), sha(alone)


def memory(kind, B, T=16, H=128, F=49):
    """Device bytes of one call of kind's scan (SCANS) through autograd at
    T, B, D = H (and F features for the encoder kinds, whose features
    need no gradient): held from the end of its forward to its backward
    (what autograd keeps: outs, cseq, hT, cT and whatever slab the tree's
    design keeps) and the peak over the forward and backward, both above
    the inputs."""
    g = torch.Generator(device='cuda').manual_seed(0)
    cdt = getattr(torch, DTYPE)

    def leaf(*shape, dtype=torch.float32):
        return (torch.randn(*shape, device='cuda', generator=g)
            * 0.3).to(dtype).requires_grad_()
    if kind in ENCODED:
        args = (leaf(T, B, F, dtype=cdt).detach(), leaf(B, H), leaf(B, H),
            leaf(F, H), leaf(H), leaf(H, 4 * H), leaf(H, 4 * H), leaf(4 * H))
    elif kind in PROJECTED:
        args = (leaf(T, B, 4 * H, dtype=cdt), leaf(B, H), leaf(B, H),
            leaf(H, 4 * H))
    else:
        args = (leaf(T, B, H, dtype=cdt), leaf(B, H), leaf(B, H),
            leaf(H, 4 * H), leaf(H, 4 * H), leaf(4 * H))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    outs, hT, cT = SCANS[kind](*args, cdt)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    ((outs.float() ** 2).sum() + (hT * cT).sum()).backward()
    torch.cuda.synchronize()
    return {'held bytes': held,
        'peak bytes': torch.cuda.max_memory_allocated() - base}


def route(T, B, H):
    """lstm_scan_cat at T, B, D = H through autograd, the call of a
    trainer's update: the forward (its inputs requiring gradients, so that
    it keeps what its backward takes) and the backward
    (torch.autograd.grad over the kept graph) by CUDA events, cold L2,
    mean of 20; the plain versions (mean of 5), the bound of the design
    this tree's route takes, cuDNN's f32 nn.LSTM and the device memory
    through autograd beside them."""
    from pufferlib_tpu_torch.ops.cuda.lstm_cat import (
        lstm_cat_backward_reference, lstm_cat_reference)
    from pufferlib_tpu_torch.ops.cuda.lstm_common import cat_design
    args, grads, cdt = chip_smoke.lstm_case(torch, np.random.RandomState(0),
        'cat', T, B, DTYPE, H=H)
    design = cat_design(H, H, cdt)
    leaves = [t.detach().requires_grad_() for t in args]
    fwd = chip_smoke.timed_ms(lambda: lstm_scan_cat(*leaves, cdt), flush)
    outs = lstm_scan_cat(*leaves, cdt)
    bwd = chip_smoke.timed_ms(lambda: torch.autograd.grad(outs, leaves,
        grads, retain_graph=True), flush)
    with torch.no_grad():
        want = lstm_cat_reference(*args, cdt)
        bargs = (*args, want[0], want[3], *grads, cdt)
        fwd_plain = chip_smoke.timed_ms(lambda: lstm_cat_reference(*args,
            cdt), flush, reps=5)
        bwd_plain = chip_smoke.timed_ms(lambda: lstm_cat_backward_reference(
            *bargs), flush, reps=5)
    (fwd_bound, _), (bwd_bound, _) = chip_smoke.lstm_bounds(
        'cat' if design == 'resident' else 'cat_stream', args, T, B, H,
        DTYPE)
    fwd_lib, bwd_lib = chip_smoke.cudnn_lstm_ms(torch, flush, args, grads[0])
    return {'forward': fwd, 'backward': bwd, 'forward plain': fwd_plain,
        'backward plain': bwd_plain, 'forward bound': fwd_bound,
        'backward bound': bwd_bound, 'forward library': fwd_lib,
        'backward library': bwd_lib, 'phases': None,
        'shape': f'T={T} B={B} D=H={H} {DTYPE}, lstm_scan_cat through '
            f'autograd: the {design} design',
        'memory': memory('cat', B, T, H=H)}


def reading(r):
    return {'forward': r['fwd_ms'], 'backward': r['bwd_ms'],
        'forward plain': r['fwd_plain_ms'], 'backward plain':
        r['bwd_plain_ms'], 'forward bound': r['fwd_bound'],
        'backward bound': r['bwd_bound'], 'forward library': r['fwd_lib'],
        'backward library': r['bwd_lib'], 'shape': r['shape']}


torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
flush = chip_smoke.l2_flush_buffer()
out = {}
for kind in KINDS:
    r = chip_smoke.check_lstm(torch, flush, np.random.RandomState(0), kind,
        8192, DTYPE, timed=True)
    digest, forward_digest, backward_digest = digests(kind)
    out[kind] = {**reading(r), 'digest': digest,
        'forward digest': forward_digest, 'backward digest': backward_digest}
    phases = None
    if DTYPE == 'bfloat16' or kind in ('enc5', 'cat', 'fused', 'enc',
            'enc2', 'enc3', 'enc4', 'enc6', 'scan', 'tm'):
        try:
            phases = chip_smoke.time_tc_phases(torch, flush,
                np.random.RandomState(0), kind, dtype_name=DTYPE)
        except (KeyError, TypeError, IndexError, RuntimeError):
            # an older tree whose kind has no phases (in f32: whose C
            # function runs only whole calls)
            pass
    out[kind]['phases'] = phases
    if kind in SCANS:
        out[kind]['memory'] = memory(kind, 8192)
if DTYPE == 'float32':
    for label, kind, T, B, F in F32_EXTRA:
        r = chip_smoke.check_lstm(torch, flush, np.random.RandomState(0),
            kind, B, DTYPE, T=T, F=F, timed=True)
        out[label] = {**reading(r), 'phases': None}
        if kind in SCANS:
            out[label]['memory'] = memory(kind, B, T, F=F)
    for label, T, B, H in ROUTE_F32:
        out[label] = route(T, B, H)
# nvcc's seconds for each source this turn built (a tree's first turn
# builds each source alone, on first use)
from pufferlib_tpu_torch.ops.cuda import KERNELS
print(json.dumps({'results': out, 'build seconds': {k.source:
    k.build_seconds for k in KERNELS if k.build_seconds is not None}}))
'''


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--dtype', action='append',
        choices=('bfloat16', 'float32'),
        help='a compute dtype to run (repeat for both; bfloat16 if none)')
    parser.add_argument('--kind', action='append', choices=KINDS,
        help='a kind to run (repeat for more; every kind if none)')
    parser.add_argument('trees', nargs='+')
    args = parser.parse_args()
    trees = [os.path.abspath(t) for t in args.trees]
    order = trees + trees[::-1]
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
        '--format=csv,noheader'], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip().splitlines()[0]
    dtypes = args.dtype or ['bfloat16']
    readings = []
    for dtype in dtypes:
        kinds = tuple(k for k in KINDS if not args.kind or k in args.kind)
        extra = tuple(e for e in F32_EXTRA
            if not args.kind or e[1] in args.kind)
        routes = ROUTE_F32 if not args.kind or 'cat' in args.kind else ()
        code = (f'KINDS = {kinds!r}\nF32_EXTRA = {extra!r}\n'
            f'ROUTE_F32 = {routes!r}\nDTYPE = {dtype!r}\n' + CHILD)
        for turn, tree in enumerate(order):
            out = subprocess.run([sys.executable, '-c', code], cwd=tree,
                check=True, stdout=subprocess.PIPE, text=True).stdout
            result = json.loads(out.strip().splitlines()[-1])
            built = result['build seconds']
            readings.append(dict(turn=turn, tree=tree, dtype=dtype,
                part='build seconds', seconds=built))
            print(f'turn {turn} {tree} {dtype}: nvcc seconds of the sources '
                f'it built {json.dumps(built)}', flush=True)
            for kind, r in result['results'].items():
                for part in ('forward', 'backward'):
                    readings.append(dict(turn=turn, tree=tree, dtype=dtype,
                        kind=kind, part=part, ms=r[part],
                        plain_ms=r[f'{part} plain'],
                        bound_ms=r[f'{part} bound'],
                        library_ms=r[f'{part} library'], shape=r['shape']))
                for part in ('digest', 'forward digest', 'backward digest'):
                    if part in r:
                        readings.append(dict(turn=turn, tree=tree,
                            dtype=dtype, kind=kind, part=part,
                            digest=r[part]))
                if 'memory' in r:
                    readings.append(dict(turn=turn, tree=tree, dtype=dtype,
                        kind=kind, part='memory', **r['memory']))
                for name, ms in (r['phases'] or {}).items():
                    readings.append(dict(turn=turn, tree=tree, dtype=dtype,
                        kind=kind, part=name, ms=ms))
                print(f'turn {turn} {tree} {dtype}: {kind} ({r["shape"]}) '
                    f'forward {r["forward"]:.4f} ms (plain '
                    f'{r["forward plain"]:.4f}, bound '
                    f'{r["forward bound"]:.4f}, library '
                    f'{r["forward library"]}), backward '
                    f'{r["backward"]:.4f} ms (plain '
                    f'{r["backward plain"]:.4f}, bound '
                    f'{r["backward bound"]:.4f}, library '
                    f'{r["backward library"]}); digest '
                    f'{r.get("digest")}, forward digest '
                    f'{r.get("forward digest")}, backward digest '
                    f'{r.get("backward digest")}; phases '
                    + json.dumps(r['phases']) + (f'; memory '
                    f'{json.dumps(r["memory"])}' if 'memory' in r else ''),
                    flush=True)
    print(json.dumps(dict(card=card, shape='T=16 B=8192 D=H=128 (encoder '
        'kinds F=49) unless a reading names its own', dtypes=dtypes,
        readings=readings)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
