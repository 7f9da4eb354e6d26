"""Model zoo in torch.nn, counterpart of pufferlib_tpu/models/__init__.py.

This port has `Default` (models/__init__.py:118-233), `LSTMWrapper`
(:236-445), the conv family, `Convolutional` and `ProcgenResnet`
(:448-563), and the attention family, `TransformerWrapper` and
`TransformerPolicy` (models/transformer.py). `Default` takes structured
observations through `emulated`, as the JAX module does. Params are
float32; `dtype` is the compute dtype, as flax `Dense(dtype=cdt,
param_dtype=f32)`: each layer casts its input, weight and bias to
`dtype`.

The convolutions run in torch's NCHW layout (F.conv2d) and flatten their
features in the JAX modules' NHWC order, so that a weight carried by
convert.py reads the same features. They are not TPU kernels (the JAX
package leaves them to XLA): on the card they go to cuDNN, which runs a
float32 convolution in TF32 unless torch.backends.cudnn.allow_tf32 is
False. This package sets no global flag; a caller who wants full float32
convolutions turns TF32 off (chip_smoke.py does).
"""
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pufferlib_tpu_torch import emulation, spaces
from pufferlib_tpu_torch.environment import tree_leaves
from pufferlib_tpu_torch.models._layers import (
    _conv_relu, _linear, _orthogonal_conv, _orthogonal_dense)
from pufferlib_tpu_torch.models.distributions import sample_logits
from pufferlib_tpu_torch.models.policy import (
    Policy, RecurrentPolicy, count_params)
from pufferlib_tpu_torch.models.transformer import (
    TransformerPolicy, TransformerWrapper)
from pufferlib_tpu_torch.ops.cuda.lstm_cat import lstm_scan_cat
from pufferlib_tpu_torch.ops.cuda.lstm_common import (
    cat_shape_error, enc5_shape_error, gate_activations, round_to)
from pufferlib_tpu_torch.ops.cuda.lstm_enc import lstm_scan_enc5
from pufferlib_tpu_torch.ops.cuda.mlp import mlp_head

__all__ = ['Default', 'LSTMWrapper', 'Convolutional', 'ProcgenResnet',
    'TransformerWrapper', 'TransformerPolicy', 'lstm_route', 'sample_logits',
    'Policy', 'RecurrentPolicy', 'count_params']

LSTM_KERNELS = ('enc5', 'cat', 'off')


def lstm_route(kernel, use_kernel, device, T, D, H, F, num_layers, cdt):
    """Which LSTM scan LSTMWrapper runs: 'enc5', 'cat' or 'off', decided
    from shapes before any launch.

    kernel: the selected kernel ('enc5', 'cat' or 'off'); use_kernel: None,
    True or False; device: where x lies; T: timesteps; D: input_size; H:
    hidden_size; F: the encoder's feature width when the policy has the
    encoder_features / encoder_params contract, else None; cdt: the
    compute dtype. enc5 needs to fuse the encoder: one layer and the
    contract; otherwise its place goes to cat. Where enc5 can fuse it
    runs, as the JAX package runs enc5 at any D, H and F: its reach on
    the card is its two designs' (lstm_common.enc5_shape_error), the
    resident kernels (lstm_common.encoder_shape_error) else the streamed
    ones; cat's likewise (lstm_common.cat_shape_error). The streamed
    design takes any D and F and any hidden size that, padded with zero
    units to a multiple of 32 (lstm_common.stream_hidden), is at most
    lstm_common.STREAM_MAX_HIDDEN (800 in f32, 1472 in bf16), so only
    larger hidden sizes raise: hidden 100 and 200, for example, run enc5's
    (or cat's) streamed design.
    - T == 1, use_kernel False, or kernel 'off': 'off' (at T == 1 the
      plain combined-operand step). These are the only ways to the plain
      scan on the card: the caller asks for it.
    - use_kernel True: the selected kernel, or cat where enc5 cannot fuse.
      On the card a shape that kernel refuses raises ValueError; on the
      CPU its plain version runs.
    - use_kernel None: 'off' off the card. On the card enc5 where it can
      fuse, else cat; a shape that kernel refuses raises ValueError,
      which names use_kernel=False, the way to the plain scan."""
    if T == 1 or use_kernel is False or kernel == 'off':
        return 'off'
    fuse = kernel == 'enc5' and num_layers == 1 and F is not None
    route = 'enc5' if fuse else 'cat'
    if torch.device(device).type != 'cuda':
        return route if use_kernel else 'off'
    err = enc5_shape_error(F, D, H, cdt) if fuse \
        else cat_shape_error(D, H, cdt)
    if err is not None:
        if use_kernel:
            raise ValueError(err)
        raise ValueError(f'{err}; no CUDA LSTM kernel serves this shape: '
            f'pass use_kernel=False (or kernel=\'off\') to run the plain '
            f'scan on the card')
    return route


def _action_info(action_space):
    """(is_multidiscrete, nvec list) for a flat (emulated) action space."""
    if isinstance(action_space, spaces.MultiDiscrete):
        return True, [int(n) for n in action_space.nvec]
    if isinstance(action_space, spaces.Discrete):
        return False, [int(action_space.n)]
    raise ValueError(f'Policies take flat action spaces, got {action_space}')


def _uniform_(t, bound, generator):
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


class Default(nn.Module):
    """Flatten-obs MLP with (multi)discrete decoders and a value head, as
    one fused head `[decoder_0 | ... | decoder_k | value]`.

    init_style: 'orthogonal' (CleanRL layer_init everywhere) or 'torch'
    (torch-default kaiming-uniform encoder and value column, orthogonal
    0.01 decoders), as the JAX module's two schemes.
    emulated: vecenv.emulated; where the observation is structured (a
    byte-packed Dict or Tuple), the encoder reads its nativized leaves,
    so its width is the leaves' total, not the bytes'.
    use_kernel: run encoder + relu + head as one CUDA kernel
    (ops/cuda/mlp.py), the counterpart of the JAX `use_pallas=True`.
    generator: torch.Generator for the init (CPU); None uses torch's
    global one. decoder_input_size: the width decode_actions takes, which
    the JAX head's Dense infers from its input: the hidden size of an
    LSTMWrapper around this policy where it differs from the encoder's
    hidden_size (its input_size); None is hidden_size."""

    def __init__(self, obs_shape, action_space, hidden_size=128,
            dtype=torch.float32, emulated=None, use_kernel=False,
            init_style='orthogonal', generator=None,
            decoder_input_size=None):
        super().__init__()
        if init_style not in ('orthogonal', 'torch'):
            raise ValueError(f'unknown init_style {init_style!r}')
        self.obs_shape = tuple(obs_shape)
        self.hidden_size = hidden_size
        self.dtype = dtype
        self.use_kernel = use_kernel
        self.init_style = init_style
        self.is_multidiscrete, self.nvec = _action_info(action_space)
        # structured (byte-packed) observations are nativized on entry:
        # the encoder reads the typed leaves, not the bytes
        self.native_spec = None
        in_features = int(np.prod(self.obs_shape))
        if emulated is not None and np.dtype(
                emulated.emulated_observation_dtype).names is not None:
            self.native_spec = emulation.nativize_dtype(emulated)
            in_features = sum(int(np.prod(shape)) for _, shape, _, _ in
                tree_leaves(self.native_spec, sort_keys=True,
                    is_leaf=emulation.is_spec))
        self.encoder = nn.Linear(in_features, hidden_size)
        self.head = nn.Linear(decoder_input_size or hidden_size,
            sum(self.nvec) + 1)
        self._init_params(generator)

    def _init_params(self, generator):
        enc, head = self.encoder, self.head
        with torch.no_grad():
            if self.init_style == 'torch':
                # the JAX init's bounds: the kernel's fan-in, and the
                # flat observation's width for the bias
                _uniform_(enc.weight, 1.0 / math.sqrt(enc.in_features),
                    generator)
                _uniform_(enc.bias, 1.0 / math.sqrt(
                    np.prod(self.obs_shape)), generator)
            else:
                nn.init.orthogonal_(enc.weight, math.sqrt(2),
                    generator=generator)
                enc.bias.zero_()
            # fused head, block by block: orthogonal std 0.01 for each
            # decoder, then the value row
            head.bias.zero_()
            off = 0
            for n in self.nvec:
                nn.init.orthogonal_(head.weight[off:off + n], 0.01,
                    generator=generator)
                off += n
            if self.init_style == 'torch':
                # the JAX init's bounds: the weight's fan-in, and the
                # encoder's width for the bias
                _uniform_(head.weight[off:], 1.0 / math.sqrt(
                    head.in_features), generator)
                _uniform_(head.bias[off:], 1.0 / math.sqrt(self.hidden_size),
                    generator)
            else:
                nn.init.orthogonal_(head.weight[off:], 1.0,
                    generator=generator)

    def encoder_features(self, observations):
        """Pre-encoder features: flatten, nativize a structured
        observation (its leaves, in the JAX package's tree order, each
        cast to the compute dtype and concatenated), cast to the compute
        dtype. Fused-kernel contract: encode_observations(x) ==
        relu(encoder_features(x) @ k + b) with (k, b) = encoder_params()."""
        batch = observations.shape[0]
        x = observations.reshape(batch, -1)
        if self.native_spec is None:
            return x.to(self.dtype)
        leaves = tree_leaves(emulation.nativize_tensor(x, self.native_spec),
            sort_keys=True)
        return torch.cat([leaf.reshape(batch, -1).to(self.dtype)
            for leaf in leaves], dim=1)

    def encoder_params(self):
        """(kernel, bias) of the encoder, kernel in the JAX (in, out)
        layout."""
        return self.encoder.weight.t(), self.encoder.bias

    def _dense(self, layer, x):
        # flax Dense(dtype=cdt) casts its input too: the LSTM hands the
        # head f32 hidden states
        return _linear(layer, x, self.dtype)

    def encode_observations(self, observations):
        x = self.encoder_features(observations)
        return torch.relu(self._dense(self.encoder, x)), None

    def _split_head_out(self, out):
        """(B, sum(nvec)+1) fused head output -> (logits, value)."""
        value = out[..., -1:]
        if self.is_multidiscrete:
            logits, off = [], 0
            for n in self.nvec:
                logits.append(out[..., off:off + n])
                off += n
            return logits, value
        return out[..., :-1], value

    def decode_actions(self, hidden, lookup=None):
        return self._split_head_out(self._dense(self.head, hidden).float())

    def forward(self, observations):
        if self.use_kernel:
            # observations are constants in RL training: the kernel's
            # zero x-gradient contract, made explicit by detach
            x = self.encoder_features(observations).detach()
            w1, b1 = self.encoder_params()
            out = mlp_head(x, w1.contiguous(), b1,
                self.head.weight.t().contiguous(), self.head.bias,
                self.dtype)
            return self._split_head_out(out)
        hidden, lookup = self.encode_observations(observations)
        return self.decode_actions(hidden, lookup)


class LSTMWrapper(nn.Module):
    """LSTM between the policy's encode_observations and decode_actions
    (pufferlib_tpu/models/__init__.py:236-445).

    Input x: (B, *obs_shape) [one step, T = 1], (B, T, *obs_shape), or
    with time_major=True (T, B, *obs_shape); logits and value come back
    flattened in the input's row order. State (h, c): each
    (num_layers, B, hidden_size) float32. Gate order i, f, g, o; weights
    w_ih_l{k} (in, 4H) and w_hh_l{k} (H, 4H) in the JAX (in, out) layout,
    orthogonal init with gain 1, zero bias b_l{k} (4H,).

    kernel: 'enc5' (the default), 'cat' or 'off', the counterpart of the
    JAX PUFFER_LSTM_KERNEL. use_kernel (None, True or False), the
    counterpart of use_pallas. lstm_route decides, from shapes: None runs
    a kernel where the input lies on CUDA and T > 1 ('enc5' where it can
    fuse, else 'cat') and raises on the card for a shape that kernel
    does not serve; True runs the selected kernel and raises
    on the card for a shape it refuses; False runs the 'off' scan, on the
    card too. 'enc5' fuses the policy's encoder into the LSTM
    kernel (one layer, a policy with the encoder_features /
    encoder_params contract); otherwise every layer runs the 'cat' kernel
    with the encoder outside. On the CPU the kernels' plain versions run.
    'off' is the plain scan with the JAX package's own rounding points.
    T == 1 is always the plain combined-operand step."""

    def __init__(self, policy, obs_shape, input_size=128, hidden_size=128,
            num_layers=1, dtype=torch.float32, kernel='enc5', use_kernel=None,
            generator=None):
        super().__init__()
        if kernel not in LSTM_KERNELS:
            raise ValueError(
                f'kernel must be one of {LSTM_KERNELS}, got {kernel!r}')
        head = getattr(policy, 'head', None)
        if isinstance(head, nn.Linear) and head.in_features != hidden_size:
            raise ValueError(f'the policy head reads {head.in_features} '
                f'features but the LSTM emits hidden_size={hidden_size}: '
                f'build the policy with decoder_input_size={hidden_size}')
        self.policy = policy
        self.obs_shape = tuple(obs_shape)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dtype = dtype
        self.kernel = kernel
        self.use_kernel = use_kernel
        H = hidden_size
        for layer in range(num_layers):
            in_size = input_size if layer == 0 else H
            w_ih = nn.Parameter(torch.empty(in_size, 4 * H))
            w_hh = nn.Parameter(torch.empty(H, 4 * H))
            with torch.no_grad():
                nn.init.orthogonal_(w_ih, 1.0, generator=generator)
                nn.init.orthogonal_(w_hh, 1.0, generator=generator)
            setattr(self, f'w_ih_l{layer}', w_ih)
            setattr(self, f'w_hh_l{layer}', w_hh)
            setattr(self, f'b_l{layer}', nn.Parameter(torch.zeros(4 * H)))

    def route(self, T, device):
        """lstm_route for an input of T steps on `device`: 'enc5', 'cat'
        or 'off'."""
        F = None
        if (hasattr(self.policy, 'encoder_features')
                and hasattr(self.policy, 'encoder_params')):
            F = self.policy.encoder_params()[0].shape[0]
        return lstm_route(self.kernel, self.use_kernel, device, T,
            self.input_size, self.hidden_size, F, self.num_layers,
            self.dtype)

    def layer_params(self, layer):
        return (getattr(self, f'w_ih_l{layer}'),
            getattr(self, f'w_hh_l{layer}'), getattr(self, f'b_l{layer}'))

    def initial_state(self, batch_size, dtype=torch.float32, device=None):
        shape = (self.num_layers, batch_size, self.hidden_size)
        return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))

    def forward(self, x, state=None, time_major=False):
        space_n = len(self.obs_shape)
        x_shape = tuple(x.shape)
        if x_shape[-space_n:] != self.obs_shape:
            raise ValueError(f'Invalid input tensor shape {x_shape}')
        if len(x_shape) == space_n + 1:
            B, T = x_shape[0], 1
            time_major = False
        elif len(x_shape) == space_n + 2:
            T, B = x_shape[:2] if time_major else x_shape[1::-1]
        else:
            raise ValueError(f'Invalid input tensor shape {x_shape}')

        route = self.route(T, x.device)
        fuse_enc = route == 'enc5'

        lead = (T, B) if time_major else (B, T)
        x = x.reshape((B * T,) + self.obs_shape)
        if fuse_enc:
            # observations are constants in RL training: detach makes the
            # kernel's zero feats-gradient contract explicit
            feats = self.policy.encoder_features(x).detach()
            lookup = None
            hidden = feats.reshape(lead + (feats.shape[-1],))
        else:
            hidden, lookup = self.policy.encode_observations(x)
            if tuple(hidden.shape) != (B * T, self.input_size):
                raise ValueError(f'policy encoder emits {tuple(hidden.shape)}'
                    f', expected ({B * T}, {self.input_size})')
            hidden = hidden.reshape(lead + (self.input_size,))

        H, cdt = self.hidden_size, self.dtype
        if state is None:
            h0, c0 = self.initial_state(B, device=x.device)
        else:
            h0, c0 = state

        def to_tm(v):
            return v if time_major else v.transpose(0, 1)

        hs, cs = [], []
        layer_in = hidden
        for layer in range(self.num_layers):
            w_ih, w_hh, b = self.layer_params(layer)
            h_l, c_l = h0[layer].float(), c0[layer].float()
            if T == 1:
                h_fin, c_fin = self._step(
                    layer_in[0] if time_major else layer_in[:, 0],
                    h_l, c_l, w_ih, w_hh, b)
                layer_in = h_fin[None] if time_major else h_fin[:, None]
            elif fuse_enc:
                w_enc, b_enc = self.policy.encoder_params()
                if w_enc.shape[-1] != self.input_size:
                    raise ValueError(f'policy encoder emits {w_enc.shape[-1]}'
                        f' features but input_size={self.input_size}')
                outs, h_fin, c_fin = lstm_scan_enc5(
                    to_tm(layer_in).to(cdt).contiguous(), h_l.contiguous(),
                    c_l.contiguous(), w_enc.contiguous(), b_enc, w_ih, w_hh,
                    b, cdt)
                layer_in = to_tm(outs)
            elif route == 'cat':
                outs, h_fin, c_fin = lstm_scan_cat(
                    to_tm(layer_in).to(cdt).contiguous(), h_l.contiguous(),
                    c_l.contiguous(), w_ih, w_hh, b, cdt)
                layer_in = to_tm(outs)
            else:
                outs, h_fin, c_fin = self._scan_off(to_tm(layer_in), h_l,
                    c_l, w_ih, w_hh, b)
                layer_in = to_tm(outs)
            hs.append(h_fin)
            cs.append(c_fin)

        new_state = (torch.stack(hs), torch.stack(cs))
        flat = layer_in.reshape(B * T, H)
        logits, value = self.policy.decode_actions(flat, lookup)
        return logits, value, new_state

    def _step(self, x, h, c, w_ih, w_hh, b):
        """One cell step, [x | h] @ [W_ih; W_hh] on cdt-rounded operands
        with f32 accumulation and f32 gates (models/__init__.py:354-379)."""
        cdt = self.dtype
        xh = torch.cat([round_to(x, cdt), round_to(h, cdt)], dim=-1)
        w_cat = round_to(torch.cat([w_ih, w_hh], dim=0), cdt)
        i, f, g, o = gate_activations(xh @ w_cat + b.float(),
            self.hidden_size)
        c = f * c + i * g
        return o * torch.tanh(c), c

    def _scan_off(self, x, h, c, w_ih, w_hh, b):
        """The plain scan over x (T, B, in) with the JAX 'off' rounding
        points (models/__init__.py:416-433): the input projection plus
        bias, and h @ W_hh, each rounded to cdt before the f32 add."""
        cdt, H = self.dtype, self.hidden_size
        xp = (round_to(x, cdt) @ round_to(w_ih, cdt)).to(cdt) + b.to(cdt)
        w_hh_c = round_to(w_hh, cdt)
        outs = []
        for t in range(x.shape[0]):
            gates = xp[t].float() + (round_to(h, cdt) @ w_hh_c).to(cdt).float()
            i, f, g, o = gate_activations(gates, H)
            c = f * c + i * g
            h = o * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs), h, c


def _nhwc_flat(x):
    """(B, C, H, W) -> (B, H * W * C): the JAX modules' NHWC flatten."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class _Heads(nn.Module):
    """The conv policies' decoders, one per action component, and their
    value head (JAX `actor_{i}`, std 0.01, and the value, std 1)."""

    def __init__(self, action_space, hidden, generator):
        super().__init__()
        self.is_multidiscrete, self.nvec = _action_info(action_space)
        self.actors = nn.ModuleList(_orthogonal_dense(hidden, n, 0.01,
            generator) for n in self.nvec)
        self.value = _orthogonal_dense(hidden, 1, 1.0, generator)

    def forward(self, hidden, dense):
        value = dense(self.value, hidden).float()
        logits = [dense(actor, hidden).float() for actor in self.actors]
        return (logits if self.is_multidiscrete else logits[0]), value


class Convolutional(nn.Module):
    """NatureCNN for Atari (pufferlib_tpu/models/__init__.py:448-498):
    uint8 frames (B, framestack, H, W), or (B, H, W, framestack) with
    channels_last, divided by 255; conv 8x8/4, 4x4/2, 3x3/1 (32, 64, 64
    channels, VALID, relu), the features flattened in NHWC order, fc to
    hidden_size (relu), decoders and a value head. downsample keeps every
    downsample-th row and column first. flat_size is fc's input width (the
    JAX module infers it). dtype is the compute dtype of every layer. It
    has no encoder_features / encoder_params contract, so LSTMWrapper runs
    it through cat."""

    def __init__(self, action_space, framestack, flat_size, obs_shape=None,
            hidden_size=512, channels_last=False, downsample=1,
            dtype=torch.float32, generator=None):
        super().__init__()
        self.obs_shape = None if obs_shape is None else tuple(obs_shape)
        self.hidden_size = hidden_size
        self.channels_last = channels_last
        self.downsample = downsample
        self.dtype = dtype
        self.convs = nn.ModuleList()
        for cin, cout, k, stride in ((framestack, 32, 8, 4), (32, 64, 4, 2),
                (64, 64, 3, 1)):
            self.convs.append(_orthogonal_conv(cin, cout, k, stride,
                generator))
        self.fc = _orthogonal_dense(flat_size, hidden_size, math.sqrt(2),
            generator)
        self.heads = _Heads(action_space, hidden_size, generator)

    def _dense(self, layer, x):
        return _linear(layer, x, self.dtype)

    def encode_observations(self, observations):
        cdt = self.dtype
        x = observations.to(cdt) / torch.tensor(255.0, dtype=cdt)
        if self.channels_last:
            x = x.permute(0, 3, 1, 2)
        if self.downsample > 1:
            x = x[:, :, ::self.downsample, ::self.downsample]
        for conv in self.convs:
            x = _conv_relu(conv, x, cdt)
        return torch.relu(self._dense(self.fc, _nhwc_flat(x))), None

    def decode_actions(self, hidden, lookup=None):
        return self.heads(hidden, self._dense)

    def forward(self, observations):
        hidden, lookup = self.encode_observations(observations)
        return self.decode_actions(hidden, lookup)


def _max_pool_same(x):
    """flax nn.max_pool(x, (3, 3), strides=(2, 2), padding='SAME') on
    NCHW: output ceil(n / 2) per side, padded with -inf, the odd pad at
    the end (64 pads (0, 1), 63 pads (1, 1))."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=-math.inf), 3, 2)


class _ResidualBlock(nn.Module):
    """relu, conv 3x3 SAME, relu, conv 3x3 SAME, plus the input."""

    def __init__(self, channels):
        super().__init__()
        self.conv0 = nn.Conv2d(channels, channels, 3, padding=1)
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        y = self.conv0(torch.relu(x))
        return x + self.conv1(torch.relu(y))


class _ConvSequence(nn.Module):
    """conv 3x3 SAME, max pool 3x3/2 SAME, two residual blocks."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.res = nn.ModuleList(_ResidualBlock(out_channels)
            for _ in range(2))

    def forward(self, x):
        x = _max_pool_same(self.conv(x))
        for block in self.res:
            x = block(x)
        return x


class ProcgenResnet(nn.Module):
    """IMPALA resnet (pufferlib_tpu/models/__init__.py:527-563): uint8
    frames (B, H, W, C), NHWC with no transpose, divided by 255; three
    conv sequences of cnn_width, 2 cnn_width, 2 cnn_width channels, the
    features flattened in NHWC order, relu, fc to mlp_width (relu),
    decoders and a value head. float32. obs_shape (H, W, C) sizes the
    first convolution and fc, which the JAX module infers."""

    def __init__(self, action_space, cnn_width=16, mlp_width=256,
            obs_shape=None, generator=None):
        super().__init__()
        if obs_shape is None:
            raise ValueError('ProcgenResnet needs obs_shape (H, W, C)')
        self.obs_shape = tuple(obs_shape)
        self.hidden_size = mlp_width
        height, width, channels = self.obs_shape
        widths = [cnn_width, 2 * cnn_width, 2 * cnn_width]
        self.sequences = nn.ModuleList(_ConvSequence(cin, cout)
            for cin, cout in zip([channels] + widths[:-1], widths))
        for _ in widths:
            height, width = -(-height // 2), -(-width // 2)
        self.fc = nn.Linear(widths[-1] * height * width, mlp_width)
        self.heads = _Heads(action_space, mlp_width, generator)

    @staticmethod
    def _dense(layer, x):
        return layer(x.float())

    def encode_observations(self, observations):
        x = (observations.float() / 255.0).permute(0, 3, 1, 2)
        for seq in self.sequences:
            x = seq(x)
        x = torch.relu(_nhwc_flat(x))
        return torch.relu(self.fc(x)), None

    def decode_actions(self, hidden, lookup=None):
        return self.heads(hidden, self._dense)

    def forward(self, observations):
        hidden, lookup = self.encode_observations(observations)
        return self.decode_actions(hidden, lookup)
