"""The AlphaZero learner step in plain float32 PyTorch: the loss on a chunk
of wire frames, the global-norm clip and AdamW.

The loss: the policy cross-entropy against the visit target over the legal
set (illegal logits shifted by -1e9) averaged over every frame, plus the
value's squared error weighted by each frame's weight and divided by the
weights' sum over the whole batch (at least 1).  The clip scales the
gradients by ``clip / norm`` where their global norm reaches ``clip``.
AdamW: decoupled decay ``p -= lr * wd * p``, then Adam's bias-corrected
update with betas (0.9, 0.999) and eps 1e-8.

A batch larger than fits is taken in blocks of frames whose gradients add
up to the whole batch's (:func:`grads`).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import engine, net

BETAS = (0.9, 0.999)
EPS = 1e-8


def decode(obs_words: torch.Tensor, board_size: int):
    """Wire words int32 [F, 12*P] -> (observation float32 [F, 12, n, n-2],
    legal bool [F, n*n])."""
    f = obs_words.shape[0]
    pk = obs_words.reshape(f, 12, -1)
    legal = engine.unpack_legal_words_flat(engine.legal_words_from_obs(pk), board_size)
    return engine.unpack_observation_nchw(pk, board_size), legal


def block_loss(params: dict, frames: dict, lo: int, hi: int, *, total_frames: int,
               val_denom: float, board_size: int, precision: str = "float32"):
    """The share of the batch's loss of frames ``lo:hi``: their policy
    cross-entropy summed over ``total_frames`` and their weighted squared
    value error summed over ``val_denom``."""
    obs, legal = decode(frames["obs"][lo:hi], board_size)
    logits, value = net.forward(params, obs, precision=precision)
    logp = torch.log_softmax(torch.where(legal, logits, logits - 1e9), dim=-1)
    pol = -(frames["policy"][lo:hi] * logp).sum(-1)
    val = (value - frames["value"][lo:hi]) ** 2 * frames["weight"][lo:hi]
    return pol.sum() / total_frames + val.sum() / val_denom


def grads(params: dict, frames: dict, board_size: int, block: int, precision: str = "float32"):
    """(loss, gradients) of the whole batch ``frames`` (flat over frames),
    in blocks of ``block`` frames."""
    total = frames["obs"].shape[0]
    val_denom = max(float(frames["weight"].sum()), 1.0)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    loss = 0.0
    for lo in range(0, total, block):
        part = block_loss(leaves, frames, lo, min(lo + block, total), total_frames=total,
                          val_denom=val_denom, board_size=board_size, precision=precision)
        part.backward()
        loss += float(part.detach())
    return loss, {k: v.grad for k, v in leaves.items()}


class AdamW:
    """Clip by the global norm, then AdamW, on a dict of float32 tensors."""

    def __init__(self, params: dict, lr: float, weight_decay: float, clip_norm: float):
        self.params = {k: v.detach().clone() for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.lr, self.wd, self.clip = lr, weight_decay, clip_norm
        self.t = 0

    def clipped(self, g: dict) -> dict:
        norm = math.sqrt(sum(float(x.double().square().sum()) for x in g.values()))
        scale = 1.0 if norm < self.clip else self.clip / norm
        return {k: x * scale for k, x in g.items()}

    def step(self, g: dict) -> dict:
        """Apply one update; returns the clipped gradients it took."""
        g = self.clipped(g)
        self.t += 1
        b1, b2 = BETAS
        for k, p in self.params.items():
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(b1).add_(g[k], alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
            denom = (self.v[k] / (1 - b2 ** self.t)).sqrt() + EPS
            p.addcdiv_(self.m[k], denom, value=-self.lr / (1 - b1 ** self.t))
        return g
