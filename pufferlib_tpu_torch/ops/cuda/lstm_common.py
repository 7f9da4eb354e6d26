"""What the LSTM kernel wrappers lstm_cat.py, lstm_enc.py, lstm_scan.py and
archive/ share: the encoder, the cell loop and the reverse step of their
plain versions, in the TPU kernels' order of operations, the input and
shape checks, the launch geometry of csrc/lstm_common.cuh and
csrc/lstm_tc.cuh, and the launches of the two cells without an encoder
whose bf16 kernels run on the tensor cores (cat's and lstm_scan_fused's).
"""
import math

import torch

from pufferlib_tpu_torch.ops.cuda._build import (
    ptr, ptr_or_null, stream_handle)

CDTS = (torch.float32, torch.bfloat16)
# Hidden sizes of every CUDA LSTM kernel: the FMA kernels' units tile the
# 256-thread block (csrc/lstm_common.cuh), the tensor-core loops' groups
# of 8 units the 16-warp block (csrc/lstm_tc.cuh Geo). The FMA kernels
# also take only an input width equal to the hidden size (layer 0 with
# input_size == hidden_size, and every later layer).
KERNEL_HIDDEN = (32, 64, 128)
# batch rows per block of the recurrent kernels (lstm_common.cuh BT)
ROWS_PER_BLOCK = 32
# feature widths whose W_enc the encoder-fused FMA kernels hold in shared
# memory (lstm_common.cuh forward_smem / backward_smem); enc5's bf16
# kernels take up to tc_max_features()
KERNEL_MAX_FEATURES = 128
# batch rows per block of the tensor-core loops (lstm_tc.cuh BR)
TC_ROWS_PER_BLOCK = 64
# phases of the tensor-core forward (pre-pass, loop) and backward
# (pre-pass, loop, dx, dW + db); a launch runs the first `phases` of them:
# all, except to time a phase
FORWARD_PHASES = 2
BACKWARD_PHASES = 4
# shared memory a block may use (lstm_common.cuh MAX_SMEM)
MAX_SMEM = 227 * 1024


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


def _tc_weight_chunks():
    """Chunks of 64 weight rows that a tensor-core GEMM block holds in
    shared memory: each 64 x (128 + 8) bf16, beside a ring of two
    64 x (64 + 8) bf16 tiles, in MAX_SMEM (lstm_tc.cuh gemm_smem)."""
    return (MAX_SMEM - 2 * 2 * 64 * (64 + 8)) // (2 * 64 * (128 + 8))


def tc_max_input(H):
    """The widest input the tensor-core kernels take at hidden size H: the
    backward pre-pass holds its block's column of [W_ih; W_hh], D + H rows
    (lstm_tc.cuh serves). The checks made before a launch need it without
    the library, so this copies the constants; chip_smoke.py and
    tests/test_torch_cuda.py hold it to the C function lstm_tc_max_input
    (csrc/lstm_cat.cu) on the card."""
    return 64 * (_tc_weight_chunks() - math.ceil(H / 64))


def tc_max_features():
    """The widest feature width enc5's bf16 encoder takes: its GEMM holds
    the block's column of W_enc, F rows (lstm_tc.cuh serves_features).
    A copy of the constants, as tc_max_input; held to the C function
    lstm_enc_tc_max_features (csrc/lstm_enc.cu) on the card."""
    return 64 * _tc_weight_chunks()


def fma_shape_error(D, H):
    """Why the FMA kernels (lstm_common.cuh; every LSTM kernel but the
    bf16 cat and fused ones) refuse input width D and hidden size H, or
    None."""
    if H not in KERNEL_HIDDEN or D != H:
        return (f'the CUDA LSTM kernels on FMA take hidden sizes '
            f'{KERNEL_HIDDEN} with input width equal to the hidden size; '
            f'got input {D}, hidden {H}')
    return None


def tc_shape_error(D, H):
    """Why the bf16 tensor-core kernels (lstm_tc.cuh) refuse input width D
    and hidden size H, or None: rows of x move as 16-byte copies, so D is a
    multiple of 8, up to tc_max_input(H)."""
    if H not in KERNEL_HIDDEN:
        return (f'the bf16 tensor-core CUDA LSTM kernels take hidden sizes '
            f'{KERNEL_HIDDEN}; got hidden {H}')
    if D < 8 or D % 8 or D > tc_max_input(H):
        return (f'the bf16 tensor-core CUDA LSTM kernels take input widths '
            f'that are multiples of 8 up to {tc_max_input(H)} at hidden '
            f'size {H}; got input {D}')
    return None


def cell_shape_error(D, H, cdt):
    """Why the cat and fused kernels refuse (D, H) in cdt, or None: their
    bf16 kernels run on the tensor cores, their f32 ones on FMA."""
    return tc_shape_error(D, H) if cdt == torch.bfloat16 \
        else fma_shape_error(D, H)


# The streamed design (csrc/lstm_cat_stream.cu) for the shapes the
# resident-weight kernels refuse. Its loops take hidden sizes that are
# multiples of STREAM_UNITS; the launchers pad any other hidden size H to
# stream_hidden(H) with zero units (pad_cell), which changes no real
# output. STREAM_MAX_HIDDEN bounds the padded size: up to it the units
# schedule's slice of W_hh and its two operand stages still fit a block's
# shared memory. Both schedules walk tiles of STREAM_ROWS batch rows, by
# which the launchers size the barrier counters and db's partial sums. The
# checks and allocations before a launch need these without the library:
# the C function lstm_stream_limits gives them, and tests/test_torch_cuda.py
# and chip_smoke.py hold the two equal on the card.
STREAM_UNITS = 32
STREAM_MAX_HIDDEN = {torch.float32: 800, torch.bfloat16: 1472}
STREAM_ROWS = 64


def stream_hidden(H):
    """The hidden size the streamed kernels run for H: the next multiple
    of STREAM_UNITS."""
    return STREAM_UNITS * math.ceil(H / STREAM_UNITS)


def stream_shape_error(D, H, cdt):
    """Why the streamed design (csrc/lstm_cat_stream.cu, both dtypes)
    refuses input width D and hidden size H in cdt, or None: any D >= 1,
    any H >= 1 whose padded size stream_hidden(H) is at most
    STREAM_MAX_HIDDEN[cdt]."""
    top = STREAM_MAX_HIDDEN[cdt]
    if H < 1 or stream_hidden(H) > top or D < 1:
        return (f'the streamed CUDA LSTM kernels take hidden sizes up to '
            f'{top} in {str(cdt).replace("torch.", "")} (padded to a '
            f'multiple of {STREAM_UNITS}) and any input width; got input '
            f'{D}, hidden {H}')
    return None


def pad_units(t, H, Hp, blocks=1):
    """t whose last axis is `blocks` blocks of H (the gates [i | f | g | o]
    with blocks=4, else one block of units), each block padded with zeros
    to Hp. t itself where Hp == H."""
    if Hp == H:
        return t
    lead = t.shape[:-1]
    t = t.reshape(*lead, blocks, H)
    return torch.nn.functional.pad(t, (0, Hp - H)).reshape(*lead, blocks * Hp)


def unpad_units(t, H, blocks=1):
    """pad_units undone: the first H of each of the last axis' blocks, a
    contiguous tensor. t itself where nothing was padded."""
    Hp = t.shape[-1] // blocks
    if Hp == H:
        return t
    lead = t.shape[:-1]
    return t.reshape(*lead, blocks, Hp)[..., :H].reshape(*lead, blocks * H)


def pad_cell(w_ih, w_hh, b, H, Hp):
    """The cell's weights with Hp - H zero units appended inside each gate
    block: W_ih (D, 4Hp), W_hh (Hp, 4Hp) (its padded rows zero too), b
    (4Hp,). A padded unit's gate pre-activations are exactly 0, so its c
    stays 0 and its h is 0 at every step; its zero rows of W_hh add exact
    zeros to the real units' sums, and its dgates are 0, so no real output
    or gradient changes. Only the split of the units schedule's K in two
    halves moves (by (Hp - H) / 2 rows)."""
    w_hh = pad_units(w_hh, H, Hp, 4)
    if Hp != H:
        w_hh = torch.nn.functional.pad(w_hh, (0, 0, 0, Hp - H))
    return pad_units(w_ih, H, Hp, 4), w_hh, pad_units(b, H, Hp, 4)


def unpad_cell_grads(dw_ih, dw_hh, db, H):
    """pad_cell's gradients back at hidden size H."""
    return (unpad_units(dw_ih, H, 4), unpad_units(dw_hh[:H], H, 4),
        unpad_units(db, H, 4))


def stream_splits(M, N, K, device):
    """K-splits of the streamed design's (M, N) weight-gradient GEMM over
    K = T*B rows: about eight blocks of 128 x 128 outputs per SM (so that
    the last of the waves, at one or two resident blocks an SM, is not left
    mostly empty), at least 1024 rows each. The partial sums are added in
    split order by a second pass, so the result does not depend on the
    schedule."""
    tiles = math.ceil(M / 128) * math.ceil(N / 128)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(math.ceil(8 * sms / tiles), K // 1024))


def cat_shape_error(D, H, cdt):
    """Why neither design of the cat pair serves (D, H) in cdt, or None:
    the resident-weight kernels (cell_shape_error) where they serve, else
    the streamed ones (stream_shape_error)."""
    resident = cell_shape_error(D, H, cdt)
    if resident is None:
        return None
    stream = stream_shape_error(D, H, cdt)
    return None if stream is None else f'{resident}; {stream}'


def cat_design(D, H, cdt):
    """'resident' where lstm_cat.cu's kernels serve (D, H) in cdt, else
    'stream' (csrc/lstm_cat_stream.cu); call after cat_shape_error."""
    return 'resident' if cell_shape_error(D, H, cdt) is None else 'stream'


def fma_encoder_shape_error(F, D, H):
    """Why the encoder-fused FMA kernels (enc5 in f32; lstm_scan_enc and
    the archived variants in both dtypes) refuse F features, encoder width
    D and hidden size H, or None."""
    err = fma_shape_error(D, H)
    if err is None and F > KERNEL_MAX_FEATURES:
        err = (f'the CUDA encoder-fused LSTM kernels on FMA take at most '
            f'{KERNEL_MAX_FEATURES} features, got {F}')
    return err


def tc_encoder_shape_error(F, D, H):
    """Why enc5's bf16 tensor-core kernels refuse F features, encoder width
    D and hidden size H, or None: the cell's reach (tc_shape_error), and
    F up to tc_max_features()."""
    err = tc_shape_error(D, H)
    if err is None and not 1 <= F <= tc_max_features():
        err = (f'the bf16 tensor-core enc5 kernels take at most '
            f'{tc_max_features()} features, got {F}')
    return err


def encoder_shape_error(F, D, H, cdt):
    """Why the enc5 kernels refuse (F, D, H) in cdt, or None: their bf16
    kernels run on the tensor cores, their f32 ones on FMA."""
    return tc_encoder_shape_error(F, D, H) if cdt == torch.bfloat16 \
        else fma_encoder_shape_error(F, D, H)


def enc5_shape_error(F, D, H, cdt):
    """Why neither design of the enc5 pair serves F features, encoder
    width D and hidden size H in cdt, or None: the resident kernels
    (encoder_shape_error) where they serve, else the streamed ones (any F
    and D, stream_shape_error's H)."""
    resident = encoder_shape_error(F, D, H, cdt)
    if resident is None:
        return None
    stream = stream_shape_error(D, H, cdt) if F >= 1 else \
        f'the streamed CUDA LSTM kernels take at least one feature, got {F}'
    return None if stream is None else f'{resident}; {stream}'


def enc5_design(F, D, H, cdt):
    """'resident' where lstm_enc.cu's enc5 kernels serve (F, D, H) in cdt,
    else 'stream' (csrc/lstm_cat_stream.cu); call after
    enc5_shape_error."""
    return 'resident' if encoder_shape_error(F, D, H, cdt) is None \
        else 'stream'


def _refuse(device, err):
    if device.type != 'cuda':
        raise ValueError(f'no LSTM kernel for device {device}')
    if err is not None:
        raise ValueError(err)


def check_kernel_shape(D, H, device):
    """Raise for a CUDA launch the FMA kernels do not serve."""
    _refuse(device, fma_shape_error(D, H))


def check_cell_kernel_shape(D, H, cdt, device):
    """Raise for a launch of the cat or fused kernels that they do not
    serve in cdt."""
    _refuse(device, cell_shape_error(D, H, cdt))


def check_encoder_kernel_shape(feats, w_enc, H, cdt):
    """Raise for a launch of the enc5 kernels that they do not serve in
    cdt."""
    _refuse(feats.device, encoder_shape_error(feats.shape[2],
        w_enc.shape[1], H, cdt))


def check_fma_encoder_kernel_shape(feats, w_enc, H):
    """Raise for a launch of an encoder-fused kernel pair whose backward
    runs on FMA (lstm_scan_enc, the archived variants) that it does not
    serve."""
    _refuse(feats.device, fma_encoder_shape_error(feats.shape[2],
        w_enc.shape[1], H))


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


def check_cell_inputs(x, h0, c0, w_ih, w_hh, b, cdt):
    """Shapes, dtypes, device and contiguity of a cell scan's inputs (cat
    and fused): x (T, B, D) in cdt, the rest float32; returns H."""
    check_cdt(cdt)
    if x.dim() != 3 or x.dtype != cdt:
        raise ValueError(f'x must be (T, B, D) in {cdt}, got {x.dtype} '
            f'{tuple(x.shape)}')
    T, B, D = x.shape
    if T < 1:
        raise ValueError('x needs at least one timestep')
    check_placement('x', x, x.device)
    return check_state_and_weights(B, D, h0, c0, w_ih, w_hh, b, x.device)


def forward_outputs(T, h0, c0, cdt, save_cseq):
    """Uninitialised (outs, hT, cT, cseq) of a forward launch; cseq None
    without save_cseq."""
    outs = torch.empty((T, *h0.shape), dtype=cdt, device=h0.device)
    cseq = torch.empty_like(outs) if save_cseq else None
    return outs, torch.empty_like(h0), torch.empty_like(c0), cseq


def tc_slab(T, B, H, device):
    """The f32 slab of the tensor-core kernels (the forward's XW or S, the
    backward's P): the 4H gate columns of T steps of B rows padded to
    whole blocks, in the loops' order (lstm_tc.cuh slab_index)."""
    rows = math.ceil(B / TC_ROWS_PER_BLOCK) * TC_ROWS_PER_BLOCK
    return torch.empty((T * rows * 4 * H,), dtype=torch.float32,
        device=device)


def launch_cell_forward(kernel, fn, x, h0, c0, w_ih, w_hh, b, cdt,
        save_cseq=True, phases=FORWARD_PHASES):
    """The forward C function `fn` of a cell pair (lstm_cat_forward,
    lstm_fused_forward): (outs, hT, cT, cseq). In bf16 its scratch is the
    slab and the bf16 [W_ih; W_hh]; in f32 none."""
    T, B, D = x.shape
    H = h0.shape[1]
    check_cell_kernel_shape(D, H, cdt, x.device)
    outs, hT, cT, cseq = forward_outputs(T, h0, c0, cdt, save_cseq)
    if B > 0:
        tc = cdt == torch.bfloat16
        xw = tc_slab(T, B, H, x.device) if tc else None
        w16 = torch.empty(((D + H) * 4 * H,), dtype=torch.bfloat16,
            device=x.device) if tc else None
        kernel.launch(fn, ptr(x), ptr(h0), ptr(c0), ptr(w_ih), ptr(w_hh),
            ptr(b), ptr(outs), ptr_or_null(cseq), ptr(hT), ptr(cT),
            ptr_or_null(xw), ptr_or_null(w16), T, B, D, H, int(tc), phases,
            stream_handle(x))
    return outs, hT, cT, cseq


def launch_cell_backward(kernel, fn, x, h0, c0, w_ih, w_hh, b, outs, cseq,
        g_outs, g_hT, g_cT, cdt, phases=BACKWARD_PHASES):
    """The backward C function `fn` of a cell pair (lstm_cat_backward,
    lstm_fused_backward): (dx, dh0, dc0, dW_ih, dW_hh, db)."""
    T, B, D = x.shape
    H = h0.shape[1]
    G = 4 * H
    check_cell_kernel_shape(D, H, cdt, x.device)
    dev = x.device
    dx = torch.empty_like(x)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    dw = torch.empty((D + H, G), dtype=torch.float32, device=dev)
    db = torch.empty((G,), dtype=torch.float32, device=dev)
    if B == 0:
        return dx, dh0, dc0, dw[:D].zero_(), dw[D:].zero_(), db.zero_()
    tc = cdt == torch.bfloat16
    splits = splitk_splits(D + H, G, T * B, dev)
    dg = torch.empty((T, B, G), dtype=cdt, device=dev)
    dw_part = torch.empty((splits, D + H, G), dtype=torch.float32,
        device=dev)
    # db partials, a row per block: of 64 batch rows in bf16, 32 in f32
    part_rows = math.ceil(B / TC_ROWS_PER_BLOCK) if tc else blocks(B)
    db_part = torch.empty((part_rows, G), dtype=torch.float32, device=dev)
    # bf16 scratch: the P slab, and [W_ih; W_hh], W_ih^T and h0 in bf16
    pre = tc_slab(T, B, H, dev) if tc else None
    w16 = torch.empty(((D + H) * G + G * D + B * H,), dtype=torch.bfloat16,
        device=dev) if tc else None
    kernel.launch(fn, ptr(x), ptr(h0), ptr(c0), ptr(w_ih), ptr(w_hh), ptr(b),
        ptr(outs), ptr(cseq), ptr(g_outs), ptr(g_hT), ptr(g_cT), ptr(dx),
        ptr(dh0), ptr(dc0), ptr(dw), ptr(db), ptr(dg), ptr(dw_part),
        ptr(db_part), ptr_or_null(pre), ptr_or_null(w16), T, B, D, H, int(tc),
        splits, part_rows, phases, stream_handle(x))
    return dx, dh0, dc0, dw[:D], dw[D:], db
