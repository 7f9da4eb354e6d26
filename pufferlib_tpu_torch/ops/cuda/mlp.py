"""Fused Default-MLP forward through the CUDA kernel csrc/mlp_head.cu.

Replaces pufferlib_tpu/ops/pallas/mlp.py (mlp_head_fwd):

    out = relu(x @ w1 + b1) @ w2 + b2        # (B, O) float32

with w1 (F, H) and w2 (H, O) in the JAX (in, out) layout. x and the
weights round to the compute dtype cdt, products accumulate in f32, the
hidden layer rounds to cdt after the relu, the biases stay f32.

The gradient is an autograd.Function whose backward is the plain matmuls
of the JAX `_bwd` (mlp.py:101-116): the JAX backward is not a kernel
either. The x-gradient is zero by contract: observations are constants in
RL training.

The compute dtype picks the kernel: bf16 runs on the tensor cores, f32
(config.yaml's dtype and the exact test mode) on FMA, register-tiled as
csrc/lstm_f32.cuh's SGEMMs. The bf16 kernel has configurations tried in
order by shared memory (tc_config, a copy of the C side's
mlp_head_tc_config); mlp_shape_error copies the C side's limits, so that
a shape the kernel refuses raises before any launch. The f32 kernel
refuses none: where its weights and x tiles do not fit in shared memory
it reads them from device memory (the C side's mlp_head_f32_config says
which configuration a shape takes).

mlp_head_reference is the plain version. The wrapper runs it for tensors
on the CPU, and chip_smoke.py holds the kernel against it on the card.
For CUDA tensors the wrapper launches the kernel or raises.
"""
import torch

from pufferlib_tpu_torch.ops.cuda._build import (
    CudaKernel, I, P, ptr, stream_handle)

__all__ = ['mlp_head', 'mlp_head_reference', 'mlp_shape_error',
    'tc_config', 'KERNEL']

KERNEL = CudaKernel('mlp_head.cu', {
    'mlp_head_forward': [P, I, P, P, P, P, P, I, I, I, I, I, P],
    'mlp_head_tc_config': [I, I, I, I],
    'mlp_head_f32_config': [I, I, I, I],
})

_CDTS = (torch.float32, torch.bfloat16)
# shared memory a block may use (mlp_head.cu MAX_SMEM)
MAX_SMEM = 227 * 1024
# the bf16 kernel's configurations, tried in order (mlp_head.cu
# tc::CONFIGS): (warps a block, m-tiles of 16 rows a warp, x ring stages,
# weights resident in shared memory)
TC_CONFIGS = ((4, 1, 3, True), (4, 1, 1, True), (4, 1, 1, False),
    (1, 1, 1, False))


def _up16(n):
    return -(-n // 16) * 16


def tc_smem(F, H, O, x_size, warps, mt, stages, resident):
    """Shared memory of a block of the bf16 kernel (mlp_head.cu
    tc::smem_bytes): the padded bf16 x tile, the ring of x spans and,
    where resident, the padded bf16 weights, the f32 biases and the f32
    output rows."""
    Fp, Hp, Op = _up16(F), _up16(H), _up16(O)
    rows = 16 * mt * warps
    size = rows * (Fp + 8) * 2 + stages * (rows * F * x_size + 32)
    if resident:
        size += (Fp * (Hp + 8) * 2 + Hp * (Op + 8) * 2 + 4 * (Hp + Op)
            + rows * O * 4)
    return size


def tc_config(F, H, O, x_dtype=torch.bfloat16):
    """Index into TC_CONFIGS of the configuration the bf16 kernel takes
    for x of x_dtype, or None where none fits (mlp_head_tc_config)."""
    for i, config in enumerate(TC_CONFIGS):
        if tc_smem(F, H, O, x_dtype.itemsize, *config) <= MAX_SMEM:
            return i
    return None


def fma_smem(F, H, O):
    """Shared memory of a block of the first f32 kernel, which held the
    f32 weights and biases, a 32-row x tile and its hidden tile: its reach
    was the (F, H, O) with fma_smem <= MAX_SMEM. The yardstick of every
    later design's reach."""
    return 4 * (F * H + H * O + H + O + 32 * F + 32 * H)


def mlp_shape_error(F, H, O, cdt, x_dtype=None):
    """Why the kernel of compute dtype cdt refuses (F, H, O) for x of
    x_dtype (cdt when None), or None."""
    x_dtype = cdt if x_dtype is None else x_dtype
    if min(F, H, O) < 1:
        return f'the MLP head kernel needs F, H, O >= 1, got {(F, H, O)}'
    if cdt == torch.bfloat16:
        if tc_config(F, H, O, x_dtype) is None:
            need = tc_smem(F, H, O, x_dtype.itemsize, *TC_CONFIGS[-1])
            return (f'the bf16 MLP head kernel takes at most {MAX_SMEM} bytes '
                f'of shared memory a block; (F, H, O) = {(F, H, O)} with '
                f'{x_dtype} x needs {need}')
        return None
    # f32: every shape (its streamed configuration holds only the hidden
    # tile in shared memory)
    return None


def _round(t, cdt):
    """t rounded to cdt, carried in float32 (f32 products of cdt values
    are exact, so an f32 matmul of them accumulates in f32 as the JAX
    preferred_element_type=f32 does)."""
    return t.to(cdt).float()


def mlp_head_reference(x, w1, b1, w2, b2, cdt=torch.bfloat16):
    """Plain PyTorch version of the kernel's function."""
    pre = _round(x, cdt) @ _round(w1, cdt) + b1.float()
    h = _round(torch.relu(pre), cdt)
    return h @ _round(w2, cdt) + b2.float()


def _check(x, w1, b1, w2, b2, cdt):
    if cdt not in _CDTS:
        raise ValueError(f'compute dtype must be one of {_CDTS}, got {cdt}')
    if x.dim() != 2 or x.dtype not in _CDTS:
        raise ValueError(
            f'x must be (B, F) float32 or bfloat16, got {x.dtype} '
            f'{tuple(x.shape)}')
    B, F = x.shape
    if w1.dim() != 2 or w1.shape[0] != F:
        raise ValueError(f'w1 must be ({F}, H), got {tuple(w1.shape)}')
    H = w1.shape[1]
    if w2.dim() != 2 or w2.shape[0] != H:
        raise ValueError(f'w2 must be ({H}, O), got {tuple(w2.shape)}')
    O = w2.shape[1]
    for name, t, shape in (('w1', w1, (F, H)), ('b1', b1, (H,)),
            ('w2', w2, (H, O)), ('b2', b2, (O,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(
                f'{name} must be float32 {shape}, got {t.dtype} '
                f'{tuple(t.shape)}')
    for name, t in (('x', x), ('w1', w1), ('b1', b1), ('w2', w2),
            ('b2', b2)):
        if t.device != x.device:
            raise ValueError(f'{name} is on {t.device}, x on {x.device}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')


def _launch(x, w1, b1, w2, b2, cdt):
    if x.device.type != 'cuda':
        raise ValueError(f'no MLP head kernel for device {x.device}')
    (B, F), (H, O) = x.shape, w2.shape
    err = mlp_shape_error(F, H, O, cdt, x.dtype)
    if err is not None:
        raise ValueError(err)
    out = torch.empty((B, O), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    KERNEL.launch('mlp_head_forward', ptr(x), int(x.dtype == torch.bfloat16),
        ptr(w1), ptr(b1), ptr(w2), ptr(b2), ptr(out), B, F, H, O,
        int(cdt == torch.bfloat16), stream_handle(x))
    return out


class _MLPHead(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, cdt):
        _check(x, w1, b1, w2, b2, cdt)
        if x.device.type == 'cpu':
            out = mlp_head_reference(x, w1, b1, w2, b2, cdt)
        else:
            out = _launch(x, w1, b1, w2, b2, cdt)
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.cdt = cdt
        return out

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2 = ctx.saved_tensors
        cdt = ctx.cdt
        xc = _round(x, cdt)
        pre = xc @ _round(w1, cdt) + b1.float()
        h = _round(torch.relu(pre), cdt)
        gc = _round(g, cdt)
        dw2 = h.t() @ gc
        db2 = g.sum(dim=0)
        dh = gc @ _round(w2, cdt).t()
        dpre = _round(torch.where(pre > 0, dh, 0.0), cdt)
        dw1 = xc.t() @ dpre
        db1 = dpre.sum(dim=0)
        dx = torch.zeros_like(x) if ctx.needs_input_grad[0] else None
        return dx, dw1, db1, dw2, db2, None


def mlp_head(x, w1, b1, w2, b2, cdt=torch.bfloat16):
    """out = relu(x @ w1 + b1) @ w2 + b2, fused; (B, O) float32.

    Differentiable with respect to the weights and biases; the
    x-gradient is zero by contract."""
    return _MLPHead.apply(x, w1, b1, w2, b2, cdt)
