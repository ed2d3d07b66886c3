"""The net's LayerNorm (S2) in CUDA kernels, and its plain version.

flax's ``nn.LayerNorm`` over the last axis (``flax/linen/normalization.py``
``_compute_stats`` with ``use_fast_variance``, then ``_normalize``; eps
1e-6): statistics in float32 (at least) in one pass, the mean and the mean
of squares, var = max(0, E[x^2] - E[x]^2); the affine map
``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in float32; the result
rounded to the input's dtype; then the epilogue the net puts after it
(``twixt_for_open_spiel_tpu/models/network.py:32-37, 54-55, 62, 80, 83``):

  ``None``        y
  ``"relu"``      relu(y)
  ``"residual"``  relu(residual + y), y rounded first, as ``ResBlock``
                  adds two tensors of the net's dtype

:func:`layer_norm` is the differentiable entry point; its backward gives the
input's gradient, the residual's under ``"residual"``, and the weight's
and bias's, from the forward's inputs alone: it computes the statistics
and the epilogue's ReLU mask again rather than keep them.  The kernels
(``csrc/layer_norm.cu``): S2a, the forward with its epilogue, and S2b, the
backward with the epilogue's mask and the parameters' gradients summed
deterministically (no float atomics).

Dispatch by the input's device, with no fallback: CPU tensors run the plain
version (:func:`layer_norm_reference`, :func:`layer_norm_backward_reference`);
CUDA tensors launch the kernel, or raise.  The kernels take rows of 8-256
channels (a power of two), bfloat16 or float32 activations, float32
parameters, every tensor contiguous and 16-byte aligned.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from twixt_for_open_spiel_tpu_torch.ops import _cuda

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon
EPILOGUES = {None: 0, "relu": 1, "residual": 2}
CHANNELS = (8, 16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# S2b's grid is at most this many blocks, each writing a float32 partial of
# dgamma and dbeta: the partials' count, and with it the sums' order, depends
# on the rows and channels only
PARTIAL_BLOCKS = 1024


def _acc_dtype(x: torch.Tensor):
    """flax's statistics dtype: the input's, promoted to at least float32."""
    return torch.promote_types(x.dtype, torch.float32)


def layer_norm_stats(x):
    """The plain version's statistics over the last axis, in
    :func:`_acc_dtype`: ``(mean, rstd)``."""
    xf = x.to(_acc_dtype(x))
    mean = xf.mean(-1)
    var = ((xf * xf).mean(-1) - mean * mean).clamp_min(0.0)
    return mean, torch.rsqrt(var + LN_EPS)


def layer_norm_reference(x, weight, bias, epilogue=None, residual=None):
    """The plain torch version of the forward."""
    acc = _acc_dtype(x)
    mean, rstd = layer_norm_stats(x)
    y = (x.to(acc) - mean[..., None]) * (rstd[..., None] * weight.to(acc)) + bias.to(acc)
    y = y.to(x.dtype)
    if epilogue == "residual":
        y = residual + y
    if epilogue is not None:
        y = torch.relu(y)
    return y


def layer_norm_backward_reference(dout, x, weight, bias, epilogue=None, residual=None,
                                  out=None):
    """The plain torch version of the backward: ``(dx, dweight, dbias,
    dresidual)`` (``dresidual`` None but under ``"residual"``).  The
    epilogue's ReLU mask is ``out > 0``, ``out`` the forward's output,
    computed again by the plain forward when not given."""
    acc = _acc_dtype(x)
    if epilogue is None:
        grad = dout
    else:
        if out is None:
            out = layer_norm_reference(x, weight, bias, epilogue, residual)
        grad = torch.where(out > 0, dout, torch.zeros_like(dout))
    dy = grad.to(acc)
    c = x.shape[-1]
    mean, rstd = layer_norm_stats(x)
    xhat = (x.to(acc) - mean[..., None]) * rstd[..., None]
    g = dy * weight.to(acc)
    a = g.sum(-1, keepdim=True) / c
    b = (g * xhat).sum(-1, keepdim=True) / c
    dx = (rstd[..., None] * (g - a - xhat * b)).to(x.dtype)
    dweight = (dy * xhat).reshape(-1, c).sum(0).to(weight.dtype)
    dbias = dy.reshape(-1, c).sum(0).to(weight.dtype)
    return dx, dweight, dbias, grad if epilogue == "residual" else None


def layer_norm_forward(x, weight, bias, epilogue=None, residual=None):
    """The forward on ``x``'s device."""
    device = x.device
    if device.type == "cpu":
        return layer_norm_reference(x, weight, bias, epilogue, residual)
    if device.type != "cuda":
        raise ValueError(f"layer_norm: no kernel for device {device}")
    return _launch_forward(x, weight, bias, epilogue, residual)


layer_norm_forward.launches = 0  # kernel launches, counted by _launch_forward


def layer_norm_backward(dout, x, weight, bias, epilogue=None, residual=None):
    """The backward on ``x``'s device: ``(dx, dweight, dbias, dresidual)``."""
    device = x.device
    if device.type == "cpu":
        return layer_norm_backward_reference(dout, x, weight, bias, epilogue, residual)
    if device.type != "cuda":
        raise ValueError(f"layer_norm: no kernel for device {device}")
    return _launch_backward(dout, x, weight, bias, epilogue, residual)


layer_norm_backward.launches = 0  # kernel launches, counted by _launch_backward


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, residual, epilogue):
        ctx.epilogue = epilogue
        ctx.save_for_backward(x, weight, bias, residual)
        return layer_norm_forward(x, weight, bias, epilogue, residual)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        x, weight, bias, residual = ctx.saved_tensors
        dx, dweight, dbias, dres = layer_norm_backward(dout.contiguous(), x, weight, bias,
                                                       ctx.epilogue, residual)
        return dx, dweight, dbias, dres, None


def layer_norm(x, weight, bias, epilogue=None, residual=None):
    """LayerNorm over the last axis of ``x`` with ``epilogue`` (module
    docstring), differentiable in ``x``, ``weight``, ``bias`` and
    ``residual``.  Without a gradient to record, only the forward runs."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"layer_norm: epilogue {epilogue!r} is none of {list(EPILOGUES)}")
    if (epilogue == "residual") != (residual is not None):
        raise ValueError("layer_norm: a residual goes with the 'residual' epilogue only")
    inputs = (x, weight, bias, residual)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        return _LayerNorm.apply(x, weight, bias, residual, epilogue)
    return layer_norm_forward(x, weight, bias, epilogue, residual)


def _check_rows(x) -> tuple:
    """(rows, channels, dtype code) of an activation the kernels take."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"layer_norm: no kernel for dtype {x.dtype}")
    channels = x.shape[-1] if x.dim() else 0
    if channels not in CHANNELS:
        raise ValueError(f"layer_norm: no kernel for {channels} channels (takes {CHANNELS})")
    return x.numel() // channels, channels, _DTYPES[x.dtype]


def _pointers(x, activations, params) -> list:
    """The data pointers of ``activations`` (each like ``x``, or None) then
    of ``params`` (float32 [channels]), after checking what the kernels
    take: device, dtype, shape, contiguity and 16-byte alignment."""
    device, shape = x.device, x.shape
    wants = ((x.dtype, shape),) * len(activations) + ((torch.float32, shape[-1:]),) * len(params)
    ptrs = []
    for t, (dtype, want) in zip(activations + params, wants):
        if t is None:
            ptrs.append(None)
            continue
        if t.dtype != dtype or t.shape != want or t.device != device:
            raise ValueError(f"layer_norm: a tensor must be {dtype} {tuple(want)} on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        ptr = t.data_ptr()
        if ptr % 16 or not t.is_contiguous():
            raise ValueError("layer_norm: each tensor must be contiguous and 16-byte aligned")
        ptrs.append(ptr)
    return ptrs


_FORWARD = _BACKWARD = None  # the ctypes entry points, bound at the first launch


def _bind():
    global _FORWARD, _BACKWARD
    lib = _cuda.load("layer_norm")
    forward = lib.twixt_layer_norm_forward
    forward.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    forward.restype = ctypes.c_int
    backward = lib.twixt_layer_norm_backward
    backward.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_longlong] + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    backward.restype = ctypes.c_int
    _FORWARD, _BACKWARD = forward, backward


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: " + _cuda.error_string("layer_norm", rc))


def _launch_forward(x, weight, bias, epilogue, residual):
    index = x.get_device()
    if index != torch.cuda.current_device():  # a stream takes its own device's launches
        with torch.cuda.device(index):
            return _launch_forward(x, weight, bias, epilogue, residual)
    rows, c, code = _check_rows(x)
    out = torch.empty_like(x)
    ptrs = _pointers(x, (x, residual, out), (weight, bias))
    if _FORWARD is None:
        _bind()
    rc = _FORWARD(ptrs[0], ptrs[3], ptrs[4], ptrs[1], ptrs[2], rows, c, code,
                  EPILOGUES[epilogue], torch._C._cuda_getCurrentRawStream(index))
    _check_rc(rc, "layer_norm forward")
    layer_norm_forward.launches += 1
    return out


def _launch_backward(dout, x, weight, bias, epilogue, residual):
    index = x.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch_backward(dout, x, weight, bias, epilogue, residual)
    rows, c, code = _check_rows(x)
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if epilogue == "residual" else None
    part = torch.empty((2, PARTIAL_BLOCKS, c), dtype=torch.float32, device=x.device)
    grads = torch.empty((2, c), dtype=torch.float32, device=x.device)
    ptrs = _pointers(x, (dout, x, residual, dx, dres), (weight, bias, grads[0], grads[1]))
    if _BACKWARD is None:
        _bind()
    rc = _BACKWARD(*ptrs[:3], ptrs[5], ptrs[6], ptrs[3], ptrs[4], part.data_ptr(), ptrs[7],
                   ptrs[8], PARTIAL_BLOCKS, rows, c, code, EPILOGUES[epilogue],
                   torch._C._cuda_getCurrentRawStream(index))
    _check_rc(rc, "layer_norm backward")
    layer_norm_backward.launches += 1
    return dx, grads[0], grads[1], dres
