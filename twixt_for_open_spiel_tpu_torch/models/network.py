"""AlphaZero policy/value net for TwixT observations
(``twixt_for_open_spiel_tpu/models/network.py``).

The JAX net, module for module: a 3x3 stem, ``blocks`` residual blocks of
two 3x3 convolutions, a policy head emitting ``board_size**2`` logits and a
value head ending in ``tanh``.  Parameters stay float32 and the compute
dtype (bfloat16 by default) is applied in ``forward`` by casting weights and
activations, as flax's ``dtype=`` does; the value head's last LayerNorm,
Dense and ``tanh`` run in float32 and its output kernel starts at zero.

Activations run NHWC, the flax layout: LayerNorm normalises the channel
axis with flax's formula (eps 1e-6) and carries the ReLU and the residual
add that follow it (``ops/layer_norm.py``: S2's kernels on the card), and
both heads flatten NHWC before their Dense layer.  Each convolution sees
its NHWC input as a channels-last NCHW view, and hands LayerNorm contiguous
NHWC rows.  Weights are stored in torch's layouts (OIHW convolutions,
``[out, in]`` Dense); ``models/convert.py`` carries flax parameters across.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from twixt_for_open_spiel_tpu_torch.ops import geometry as geo
from twixt_for_open_spiel_tpu_torch.ops.layer_norm import layer_norm

HEAD_CHANNELS = 32
VALUE_HIDDEN = 256


class Conv(nn.Module):
    """flax ``nn.Conv`` with SAME padding over NHWC activations."""

    def __init__(self, cin: int, cout: int, kernel: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        w = self.weight.to(self.dtype).contiguous(memory_format=torch.channels_last)
        y = F.conv2d(x.permute(0, 3, 1, 2).to(self.dtype), w,
                     self.bias.to(self.dtype), padding=self.weight.shape[-1] // 2)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last (channel) axis: statistics and
    the affine map in float32, the result in ``dtype``, then ``epilogue``:
    None, ``"relu"``, or ``"residual"`` (``relu(residual + y)``, the
    residual passed to ``forward``)."""

    def __init__(self, channels: int, dtype, epilogue=None):
        super().__init__()
        self.dtype = dtype
        self.epilogue = epilogue
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, residual=None):
        return layer_norm(x.to(self.dtype).contiguous(), self.weight, self.bias, self.epilogue,
                          residual)


class Dense(nn.Module):
    """flax ``nn.Dense``; the weight is torch's ``[out, in]``."""

    def __init__(self, cin: int, cout: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class ResBlock(nn.Module):
    def __init__(self, channels: int, dtype):
        super().__init__()
        self.conv0 = Conv(channels, channels, 3, dtype)
        self.norm0 = LayerNorm(channels, dtype, "relu")
        self.conv1 = Conv(channels, channels, 3, dtype)
        self.norm1 = LayerNorm(channels, dtype, "residual")

    def forward(self, x):
        y = self.norm0(self.conv0(x))
        return self.norm1(self.conv1(y), residual=x)


class AZNet(nn.Module):
    """Policy/value net over the ``[B, 12, N, N-2]`` observation tensor.

    Returns (logits float32 ``[B, N*N]``, value float32 ``[B]``); the caller
    masks illegal logits (``masked_policy``)."""

    def __init__(self, board_size: int, channels: int = 128, blocks: int = 6,
                 dtype=torch.bfloat16):
        super().__init__()
        self.board_size = board_size
        self.channels = channels
        self.dtype = dtype
        cells = board_size * (board_size - 2)
        self.stem = Conv(geo.NUM_PLANES, channels, 3, dtype)
        self.stem_norm = LayerNorm(channels, dtype, "relu")
        self.blocks = nn.ModuleList(ResBlock(channels, dtype) for _ in range(blocks))
        self.policy_conv = Conv(channels, HEAD_CHANNELS, 1, dtype)
        self.policy_norm = LayerNorm(HEAD_CHANNELS, dtype, "relu")
        self.policy_out = Dense(HEAD_CHANNELS * cells, board_size * board_size, dtype)
        self.value_conv = Conv(channels, HEAD_CHANNELS, 1, dtype)
        self.value_norm = LayerNorm(HEAD_CHANNELS, dtype, "relu")
        self.value_hidden = Dense(HEAD_CHANNELS * cells, VALUE_HIDDEN, dtype)
        self.value_hidden_norm = LayerNorm(VALUE_HIDDEN, torch.float32)
        self.value_out = Dense(VALUE_HIDDEN, 1, torch.float32)

    def forward(self, obs):
        x = obs.permute(0, 2, 3, 1).to(self.dtype)  # NCHW -> NHWC
        x = self.stem_norm(self.stem(x))
        for block in self.blocks:
            x = block(x)

        p = self.policy_norm(self.policy_conv(x))
        logits = self.policy_out(p.reshape(p.shape[0], -1))

        v = self.value_norm(self.value_conv(x))
        v = F.relu(self.value_hidden(v.reshape(v.shape[0], -1)))
        v = self.value_hidden_norm(v.float())
        value = torch.tanh(self.value_out(v))[:, 0]
        return logits.float(), value.float()


@torch.no_grad()
def init_params(net: AZNet, seed: int = 0) -> AZNet:
    """flax's default initialisers, drawn on the CPU from ``seed`` (so one
    seed gives the same weights on every device): kernels LeCun-normal
    (truncated at 2 sigma), biases 0, LayerNorm scales 1, and the value
    head's output kernel 0 (``network.py:79-88``)."""
    g = torch.Generator().manual_seed(seed)
    for module in net.modules():
        if isinstance(module, (Conv, Dense)):
            w = module.weight
            std = math.sqrt(1.0 / (w[0].numel())) / 0.87962566103423978
            cpu = torch.empty(w.shape, dtype=torch.float32)
            nn.init.trunc_normal_(cpu, 0.0, std, -2 * std, 2 * std, generator=g)
            w.copy_(cpu)
            module.bias.zero_()
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    net.value_out.weight.zero_()
    return net


def create_net(board_size: int, channels: int = 128, blocks: int = 6,
               dtype=torch.bfloat16, device="cuda") -> AZNet:
    """The net with float32 parameters on ``device``, initialised by
    :func:`init_params` from seed 0.  ``dtype`` is the compute dtype:
    bfloat16 in play, float32 for pins that need it."""
    return init_params(AZNet(board_size, channels, blocks, dtype)).to(device)


def call_net(net: AZNet, obs):
    """``net_apply`` for a torch net: the search's evaluators call
    ``net_apply(params, obs)`` as the JAX ones call ``AZNet.apply``, and
    here the params are the module itself."""
    return net(obs)


def masked_policy(logits, legal_mask):
    """Softmax over legal actions only (illegal logits become -1e9), in
    ``jax.nn.softmax``'s order of operations: ``exp(x - max) / sum``."""
    x = torch.where(legal_mask, logits, torch.full_like(logits, -1e9))
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)
