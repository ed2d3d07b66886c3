"""What the benchmark makes from ``--seed`` and hands to the program and to
the reference alike: launch seeds, the net's weights and the learner's
frames, all drawn on the device by a ``torch.Generator`` in a few large
calls."""

from __future__ import annotations

import math

import torch

from benchmark.reference import engine, net

MASK64 = (1 << 63) - 1


def device_of(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def peak_bytes(device) -> int:
    device = torch.device(device)
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed for stream ``stream`` of run seed ``seed`` (any
    whole number)."""
    return (seed * 1_000_003 + stream * 7_919) & MASK64


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def launch_seed(seed: int, i: int) -> int:
    """The u32 seed of launch ``i`` of a chain."""
    return (seed * 2_654_435_761 + i * 40_503 + 1) & 0xFFFFFFFF


def weights(config: dict, seed: int, device) -> dict:
    """The net's parameters (``reference/net.py``'s names and shapes),
    float32, from one normal draw: kernels scaled by 1/sqrt(fan-in), biases
    by 0.1, LayerNorm scales 1 + 0.1 z and offsets 0.1 z."""
    shapes = net.param_shapes(config["board_size"], config["channels"], config["blocks"])
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=generator(seed, 1, device), device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        size = math.prod(shape)
        z = flat[at:at + size].view(shape)
        at += size
        if len(shape) > 1:
            out[name] = z / math.sqrt(math.prod(shape[1:]))
        elif "norm" in name and name.endswith(".weight"):
            out[name] = 1.0 + 0.1 * z
        else:
            out[name] = 0.1 * z
    return out


def frames(config: dict, steps: int, envs: int, seed: int, stream: int, device) -> dict:
    """A learner's chunk of ``steps`` x ``envs`` frames, time-major:
    random wire words (the observation planes and, in their low bits, the
    legal set), visit targets over each frame's legal set, outcomes in
    {-1, 0, 1} and weights in {0, 1} (three in four frames finished)."""
    n = config["board_size"]
    g = generator(seed, 100 + stream, device)
    p = n + 2 * engine.PAD
    words = torch.randint(0, 1 << 30, (steps, envs, 12 * p), generator=g, device=device,
                          dtype=torch.int32)
    legal = engine.unpack_legal_words_flat(
        engine.legal_words_from_obs(words.reshape(steps, envs, 12, p)), n)
    z = torch.randn((steps, envs, n * n), generator=g, device=device)
    policy = torch.where(legal, z.exp(), 0.0)
    policy = policy / policy.sum(-1, keepdim=True).clamp_min(1e-30)
    value = torch.randint(-1, 2, (steps, envs), generator=g, device=device).float()
    weight = (torch.rand((steps, envs), generator=g, device=device) < 0.75).float()
    return {"obs": words, "policy": policy, "value": value, "weight": weight}
