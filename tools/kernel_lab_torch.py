"""Microbenchmark the PyTorch port's LSTM kernel variants on one NVIDIA
GPU, at the LSTM trainer's minibatch shape (a time slab: T=16, B=8192,
D=H=128, F=49, bf16). The counterpart of tools/kernel_lab.py.

    python3 tools/kernel_lab_torch.py [variant ...]

Variants: fused, fused-fwd (lstm_scan_fused), xp (lstm_scan), cat
(lstm_scan_cat), enc (lstm_scan_enc, the step-by-step backward), enc5
(lstm_scan_enc5), and the archived schedules of ops/cuda/archive: enc2,
enc3, enc4, enc6 (lstm_scan_enc2 ... lstm_scan_enc6) and tm
(lstm_scan_tm, one launch per timestep; the JAX lab has no such line).
Default: fused fused-fwd. Each line is the mean device time of one call
(CUDA events, the L2 flushed before every call) of the forward alone (no
gradient needed: no cell sequence is written, except by tm) or of
forward + backward, with gradients in every input (the encoder-fused
ones: in the state and the weights; observations are constants).
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ENC_VARIANTS = ('enc', 'enc5', 'enc2', 'enc3', 'enc4', 'enc6')
VARIANTS = ('fused', 'fused-fwd', 'xp', 'cat', 'tm') + ENC_VARIANTS


def bench(name, fn, args, flush, card, grad=True, reps=20):
    """Time fn(*args) -> (outs, hT, cT); with grad its backward too, under
    the loss sum(outs) + sum(hT) + sum(cT). Prints and returns the ms."""
    import torch
    from pufferlib_tpu_torch.ops.cuda.timing import timed_ms
    if grad:
        inputs = [a for a in args if torch.is_tensor(a) and a.requires_grad]

        def run():
            outs, hT, cT = fn(*args)
            loss = outs.float().sum() + hT.sum() + cT.sum()
            return torch.autograd.grad(loss, inputs)
    else:
        def run():
            with torch.no_grad():
                return fn(*args)
    ms = timed_ms(run, flush, reps=reps)
    tag = 'fwd+bwd' if grad else 'fwd    '
    print(f'{name:32s} {tag} {ms:8.3f} ms  ({card})', flush=True)
    return ms


def main(variants=('fused', 'fused-fwd'), device='cuda', T=16, B=8192,
        H=128, F=49, seed=0):
    """Run the named variants; returns {(variant, 'fwd+bwd' | 'fwd'): ms}.
    Needs a CUDA device."""
    import importlib
    import torch
    from pufferlib_tpu_torch import resolve_device
    from pufferlib_tpu_torch.ops.cuda import lstm_enc
    from pufferlib_tpu_torch.ops.cuda.archive.lstm_tm import lstm_scan_tm
    from pufferlib_tpu_torch.ops.cuda.lstm_cat import lstm_scan_cat
    from pufferlib_tpu_torch.ops.cuda.lstm_scan import (
        lstm_scan, lstm_scan_fused)
    from pufferlib_tpu_torch.ops.cuda.timing import (
        card_line, l2_flush_buffer)
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        sys.exit(f'unknown variant(s) {unknown}; choose from '
            f'{sorted(VARIANTS)}')
    device = resolve_device(device)
    if device.type != 'cuda':
        raise RuntimeError('kernel_lab_torch times kernels on a CUDA '
            f'device, got {device}')
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    flush = l2_flush_buffer(device)
    gen = torch.Generator().manual_seed(seed)
    bf16 = torch.bfloat16

    def normal(*shape, scale=1.0, dtype=torch.float32, grad=True):
        t = (torch.randn(*shape, generator=gen) * scale).to(dtype).to(device)
        return t.requires_grad_(grad)
    x = normal(T, B, H, dtype=bf16)
    h0, c0 = normal(B, H), normal(B, H)
    w_ih = normal(H, 4 * H, scale=0.05)
    w_hh = normal(H, 4 * H, scale=0.05)
    b = normal(4 * H, scale=0.05)
    cell = (x, h0, c0, w_ih, w_hh, b, bf16)
    results = {}

    def both(variant, name, fn, args):
        results[variant, 'fwd+bwd'] = bench(name, fn, args, flush, card)
        results[variant, 'fwd'] = bench(name, fn, args, flush, card,
            grad=False)

    if 'fused' in variants:
        results['fused', 'fwd+bwd'] = bench('lstm_scan_fused',
            lstm_scan_fused, cell, flush, card)
    if 'fused-fwd' in variants:
        results['fused', 'fwd'] = bench('lstm_scan_fused', lstm_scan_fused,
            cell, flush, card, grad=False)
    if 'xp' in variants or 'tm' in variants:
        xp = normal(T, B, 4 * H, dtype=bf16)
        if 'xp' in variants:
            both('xp', 'lstm_scan', lstm_scan, (xp, h0, c0, w_hh, bf16))
        if 'tm' in variants:
            both('tm', 'lstm_scan_tm', lstm_scan_tm, (xp, h0, c0, w_hh, bf16))
    if 'cat' in variants:
        both('cat', 'lstm_scan_cat', lstm_scan_cat, cell)
    enc_variants = [v for v in ENC_VARIANTS if v in variants]
    if enc_variants:
        feats = normal(T, B, F, dtype=bf16, grad=False)
        w_enc = normal(F, H, scale=0.1)
        b_enc = torch.zeros(H, device=device, requires_grad=True)
        eargs = (feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, bf16)
        for v in enc_variants:
            # enc and enc5 are production kernels, the rest archived
            mod = lstm_enc if v in ('enc', 'enc5') else importlib.import_module(
                f'pufferlib_tpu_torch.ops.cuda.archive.lstm_{v}')
            both(v, f'lstm_scan_{v}', getattr(mod, f'lstm_scan_{v}'), eargs)
    return results


if __name__ == '__main__':
    main(tuple(sys.argv[1:]) or ('fused', 'fused-fwd'))
