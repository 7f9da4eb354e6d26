"""What the LSTM kernel wrappers lstm_cat.py, lstm_enc.py, lstm_scan.py and
archive/ share: the encoder, the cell loop and the reverse step of their
plain versions, in the TPU kernels' order of operations, the input
checks, and the launch geometry of csrc/lstm_common.cuh.
"""
import math

import torch

CDTS = (torch.float32, torch.bfloat16)
# What the CUDA kernels serve (csrc/lstm_common.cuh): hidden sizes whose
# units tile the 256-thread block, and an input width equal to the hidden
# size (layer 0 with input_size == hidden_size, and every later layer)
KERNEL_HIDDEN = (32, 64, 128)
# batch rows per block of the recurrent kernels (lstm_common.cuh BT)
ROWS_PER_BLOCK = 32
# feature widths whose W_enc the encoder-fused kernels hold in shared
# memory (lstm_common.cuh forward_smem / backward_smem)
KERNEL_MAX_FEATURES = 128


def round_to(t, cdt):
    """t rounded to cdt, carried in float32: an f32 matmul of such values
    accumulates in f32, as the JAX preferred_element_type=f32 does."""
    return t.to(cdt).float()


def encode(feats, w_enc, b_enc, cdt):
    """relu(feats @ W_enc + b_enc) in f32 (not yet rounded), feats and
    W_enc rounded to cdt: lstm_enc._encode_block."""
    pre = round_to(feats, cdt) @ round_to(w_enc, cdt) + b_enc.float()
    return torch.relu(pre)


def h_prev_rows(h0, outs, cdt):
    """The recurrent operand of every step, (T * B, H): h0 rounded to
    cdt, then the stored outs of steps 0 .. T-2."""
    T, B, H = outs.shape
    return torch.cat([round_to(h0, cdt),
        round_to(outs[:T - 1].reshape((T - 1) * B, H), cdt)], dim=0)


def gate_activations(gates, H):
    """i, f, g, o from (B, 4H) gate pre-activations."""
    return (torch.sigmoid(gates[:, :H]), torch.sigmoid(gates[:, H:2 * H]),
        torch.tanh(gates[:, 2 * H:3 * H]), torch.sigmoid(gates[:, 3 * H:]))


def scan_cells(gates_at, T, h0, c0, cdt, save_cseq=True):
    """The cell loop over T. gates_at(t, h) gives the (B, 4H) float32 gate
    pre-activations of step t from h rounded to cdt. Returns (outs, hT,
    cT, cseq): outs and cseq (T, B, H) in cdt, hT and cT (B, H) in
    float32; without save_cseq the cell sequence is not kept and cseq is
    None (the forward of a call that needs no gradient)."""
    B, H = h0.shape
    h, c = h0.float(), c0.float()
    outs = torch.empty((T, B, H), dtype=cdt, device=h0.device)
    cseq = torch.empty_like(outs) if save_cseq else None
    for t in range(T):
        i, f, g, o = gate_activations(gates_at(t, round_to(h, cdt)), H)
        c = f * c + i * g
        h = o * torch.tanh(c)
        outs[t] = h.to(cdt)
        if save_cseq:
            cseq[t] = c.to(cdt)
    return outs, h, c, cseq


def scan_forward(x, h0, c0, w, b, cdt, save_cseq=True):
    """The combined-operand cell over x (T, B, D), float32 values already
    rounded to cdt, with w = [W_ih; W_hh] (D+H, 4H): gates = [x_t | h] @ w
    + b as one f32 sum. Returns scan_cells' tuple."""
    w = round_to(w, cdt)
    bias = b.float()
    return scan_cells(lambda t, h: torch.cat([x[t], h], dim=-1) @ w + bias,
        x.shape[0], h0, c0, cdt, save_cseq)


def cell_backward_step(acts, dh, dc, c_t, c_prev):
    """dgates (f32, (B, 4H)) and dc_prev of one reverse step, in the
    order of operations of the TPU kernels' _bwd_kernel."""
    i, f, g, o = acts
    tc = torch.tanh(c_t)
    do = dh * tc
    dc = dc + dh * o * (1.0 - tc * tc)
    di, dg = dc * g, dc * i
    df = dc * c_prev
    dgates = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
        dg * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
    return dgates, dc * f


def check_state_and_weights(B, D, h0, c0, w_ih, w_hh, b, device):
    """Shapes, dtypes, device and contiguity of the LSTM state and
    weights (all float32); returns H."""
    if h0.dim() != 2 or h0.shape[0] != B:
        raise ValueError(f'h0 must be ({B}, H), got {tuple(h0.shape)}')
    H = h0.shape[1]
    for name, t, shape in (('h0', h0, (B, H)), ('c0', c0, (B, H)),
            ('w_ih', w_ih, (D, 4 * H)), ('w_hh', w_hh, (H, 4 * H)),
            ('b', b, (4 * H,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f'{name} must be float32 {shape}, got '
                f'{t.dtype} {tuple(t.shape)}')
        check_placement(name, t, device)
    return H


def check_cdt(cdt):
    if cdt not in CDTS:
        raise ValueError(f'compute dtype must be one of {CDTS}, got {cdt}')


def check_scan_inputs(x_proj, h0, c0, w_hh, cdt):
    """Shapes, dtypes, device and contiguity of a scan over projected
    inputs: x_proj (T, B, 4H) in either dtype, the rest float32; returns
    H."""
    check_cdt(cdt)
    if x_proj.dim() != 3 or x_proj.dtype not in CDTS:
        raise ValueError(f'x_proj must be (T, B, 4H) in one of {CDTS}, got '
            f'{x_proj.dtype} {tuple(x_proj.shape)}')
    T, B, G = x_proj.shape
    if T < 1:
        raise ValueError('x_proj needs at least one timestep')
    dev = x_proj.device
    check_placement('x_proj', x_proj, dev)
    if h0.dim() != 2 or h0.shape[0] != B or 4 * h0.shape[1] != G:
        raise ValueError(f'h0 must be ({B}, {G // 4}) for x_proj '
            f'{tuple(x_proj.shape)}, got {tuple(h0.shape)}')
    H = h0.shape[1]
    for name, t, shape in (('h0', h0, (B, H)), ('c0', c0, (B, H)),
            ('w_hh', w_hh, (H, G))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f'{name} must be float32 {shape}, got '
                f'{t.dtype} {tuple(t.shape)}')
        check_placement(name, t, dev)
    return H


def check_encoder_inputs(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, cdt):
    """Shapes, dtypes, device and contiguity of an encoder-fused scan's
    inputs: feats (T, B, F) in cdt, the rest float32; returns H."""
    check_cdt(cdt)
    if feats.dim() != 3 or feats.dtype != cdt:
        raise ValueError(f'feats must be (T, B, F) in {cdt}, got '
            f'{feats.dtype} {tuple(feats.shape)}')
    T, B, F = feats.shape
    if T < 1:
        raise ValueError('feats needs at least one timestep')
    dev = feats.device
    check_placement('feats', feats, dev)
    if w_enc.dim() != 2 or w_enc.shape[0] != F:
        raise ValueError(f'w_enc must be ({F}, D), got {tuple(w_enc.shape)}')
    D = w_enc.shape[1]
    for name, t, shape in (('w_enc', w_enc, (F, D)), ('b_enc', b_enc, (D,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f'{name} must be float32 {shape}, got '
                f'{t.dtype} {tuple(t.shape)}')
        check_placement(name, t, dev)
    return check_state_and_weights(B, D, h0, c0, w_ih, w_hh, b, dev)


def check_placement(name, t, device):
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def check_kernel_shape(D, H, device):
    """Raise for a CUDA launch the kernels do not serve."""
    if device.type != 'cuda':
        raise ValueError(f'no LSTM kernel for device {device}')
    if H not in KERNEL_HIDDEN or D != H:
        raise ValueError(f'the CUDA LSTM kernels take hidden sizes '
            f'{KERNEL_HIDDEN} with input width equal to the hidden size; '
            f'got input {D}, hidden {H}')


def check_encoder_kernel_shape(feats, w_enc, H):
    """check_kernel_shape for an encoder-fused launch, and its feature
    width."""
    check_kernel_shape(w_enc.shape[1], H, feats.device)
    if feats.shape[2] > KERNEL_MAX_FEATURES:
        raise ValueError(f'the CUDA encoder-fused LSTM kernels take at most '
            f'{KERNEL_MAX_FEATURES} features, got {feats.shape[2]}')


def splitk_splits(M, N, K, device):
    """K-splits of a post-loop (M, N) weight-gradient contraction over
    K = T*B rows: about four blocks per SM, at least 1024 rows each. The
    partial sums are added in split order by a second pass, so the result
    does not depend on the schedule."""
    # output tiles of 64 x 64 (lstm_common.cuh gemm_tn_splitk)
    tiles = math.ceil(M / 64) * math.ceil(N / 64)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(math.ceil(4 * sms / tiles), math.ceil(K / 1024)))


def blocks(B):
    return math.ceil(B / ROWS_PER_BLOCK)


def backward_inputs(outs, g_outs, g_hT, g_cT):
    """The incoming gradients, contiguous and in the saved dtypes."""
    return (g_outs.to(outs.dtype).contiguous(), g_hT.float().contiguous(),
        g_cT.float().contiguous())


def needs_cseq(*tensors):
    """Whether a forward over these inputs must keep the cell sequence
    for a backward: autograd is recording and some input requires a
    gradient. Read before autograd.Function.apply, which turns recording
    off inside forward."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
