"""The AlphaZero policy/value net in plain float32 PyTorch, and its control
in fp8.

The layer equations of the net the ``az-*`` configurations name: a 3x3
stem, ``blocks`` residual blocks of two 3x3 convolutions, a 1x1 policy head
with a dense layer to ``n*n`` logits and a 1x1 value head with a dense
hidden layer and ``tanh``; LayerNorm over the channels (eps 1e-6) after
every convolution and after the value head's hidden layer, ReLU after it
except on the hidden norm, the residual add before the second block norm's
ReLU.  Both heads flatten their activations in (row, column, channel)
order before the dense layer.  Parameters are a dict of float32 tensors
named as :func:`param_shapes` gives them.

``precision`` rounds the input, the weight and the output of every
convolution and dense layer before and after a float32 product, and their
gradients coming back: ``"bfloat16"``, the precision the configuration
states, both ways, or ``"fp8"``, the control, the precision below it as FP8
training has it: float8 e4m3 going forward and e5m2 coming back, one scale
a tensor (its largest magnitude at 448 and 57344).  ``"float32"`` rounds
nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
HEAD_CHANNELS = 32
VALUE_HIDDEN = 256
OBS_PLANES = 12
FP8_MAX = 448.0
FP8_E5M2_MAX = 57344.0


def param_shapes(board_size: int, channels: int, blocks: int) -> dict:
    """Every parameter's name and shape, in a fixed order (convolutions
    [out, in, k, k], dense [out, in])."""
    cells = board_size * (board_size - 2)
    c = channels
    shapes = {"stem.weight": (c, OBS_PLANES, 3, 3), "stem.bias": (c,),
              "stem_norm.weight": (c,), "stem_norm.bias": (c,)}
    for i in range(blocks):
        for k in (0, 1):
            shapes[f"blocks.{i}.conv{k}.weight"] = (c, c, 3, 3)
            shapes[f"blocks.{i}.conv{k}.bias"] = (c,)
            shapes[f"blocks.{i}.norm{k}.weight"] = (c,)
            shapes[f"blocks.{i}.norm{k}.bias"] = (c,)
    h = HEAD_CHANNELS
    for head in ("policy", "value"):
        shapes[f"{head}_conv.weight"] = (h, c, 1, 1)
        shapes[f"{head}_conv.bias"] = (h,)
        shapes[f"{head}_norm.weight"] = (h,)
        shapes[f"{head}_norm.bias"] = (h,)
    shapes["policy_out.weight"] = (board_size * board_size, h * cells)
    shapes["policy_out.bias"] = (board_size * board_size,)
    shapes["value_hidden.weight"] = (VALUE_HIDDEN, h * cells)
    shapes["value_hidden.bias"] = (VALUE_HIDDEN,)
    shapes["value_hidden_norm.weight"] = (VALUE_HIDDEN,)
    shapes["value_hidden_norm.bias"] = (VALUE_HIDDEN,)
    shapes["value_out.weight"] = (1, VALUE_HIDDEN)
    shapes["value_out.bias"] = (1,)
    return shapes


def _scaled(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` with one scale for the tensor
    (its largest magnitude at ``top``), back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


class _Round(torch.autograd.Function):
    """A rounding of the values going forward and of their gradients
    coming back."""

    @staticmethod
    def forward(ctx, x, forward, backward):
        ctx.backward_round = backward
        return forward(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.backward_round(grad), None, None


def fp8(x: torch.Tensor) -> torch.Tensor:
    """FP8 training's rounding: e4m3 going forward, e5m2 for the gradients
    coming back, one scale a tensor."""
    return _Round.apply(x, lambda t: _scaled(t, torch.float8_e4m3fn, FP8_MAX),
                        lambda g: _scaled(g, torch.float8_e5m2, FP8_E5M2_MAX))


def bf16(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 both ways."""
    return _Round.apply(x, _bf16, _bf16)


ROUND = {"float32": lambda t: t, "bfloat16": bf16, "fp8": fp8}


def forward(params: dict, obs: torch.Tensor, *, precision: str = "float32"):
    """(logits float32 [B, n*n], value float32 [B]) of the observation
    ``obs`` float32 [B, 12, n, n-2]."""
    q = ROUND[precision]

    def conv(x, name):
        w = params[name + ".weight"]
        return q(F.conv2d(q(x), q(w), params[name + ".bias"], padding=w.shape[-1] // 2))

    def norm(x, name):  # x NCHW or [B, C]: normalise the channel axis
        w, b = params[name + ".weight"], params[name + ".bias"]
        if x.ndim == 4:
            return F.layer_norm(x.permute(0, 2, 3, 1), w.shape, w, b, LN_EPS).permute(0, 3, 1, 2)
        return F.layer_norm(x, w.shape, w, b, LN_EPS)

    def dense(x, name):
        return q(F.linear(q(x), q(params[name + ".weight"]), params[name + ".bias"]))

    def flat(x):  # NCHW -> [B, H*W*C] in (row, column, channel) order
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    x = F.relu(norm(conv(obs, "stem"), "stem_norm"))
    i = 0
    while f"blocks.{i}.conv0.weight" in params:
        y = F.relu(norm(conv(x, f"blocks.{i}.conv0"), f"blocks.{i}.norm0"))
        x = F.relu(x + norm(conv(y, f"blocks.{i}.conv1"), f"blocks.{i}.norm1"))
        i += 1
    p = F.relu(norm(conv(x, "policy_conv"), "policy_norm"))
    logits = dense(flat(p), "policy_out")
    v = F.relu(norm(conv(x, "value_conv"), "value_norm"))
    v = F.relu(dense(flat(v), "value_hidden"))
    v = norm(v, "value_hidden_norm")
    value = torch.tanh(dense(v, "value_out"))[:, 0]
    return logits, value


def forward_flops(board_size: int, channels: int, blocks: int) -> int:
    """Floating-point operations of one position's forward pass: two a
    multiply-add of every convolution and dense layer (the norms, ReLUs and
    adds are left out)."""
    cells = board_size * (board_size - 2)
    total = 0
    for name, shape in param_shapes(board_size, channels, blocks).items():
        if not name.endswith(".weight") or len(shape) == 1:
            continue
        if len(shape) == 4:  # a convolution at every cell
            out, cin, k, _ = shape
            total += 2 * cells * out * cin * k * k
        else:
            out, cin = shape
            total += 2 * out * cin
    return total
